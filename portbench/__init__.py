"""The benchmark of ``spectralmc_tpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100. ``run.py`` runs one cell once; ``control.py`` reads the
program's and the control's numbers that the limits were set from."""
