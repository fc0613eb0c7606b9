"""The plain reference that decides ``correct``: PyTorch and NumPy only.

It imports nothing of the program under test (``spectralmc_tpu_torch``), of
the JAX package or of JAX, and takes nothing the program has made: the
benchmark hands it the same seed, inputs and weights that it hands the
program, and it works out again whatever the program derives from them.
"""
