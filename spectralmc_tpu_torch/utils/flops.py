"""Analytic FLOP accounting for the fused train step (MFU).

The conventions are the JAX package's ``utils/flops.py``, so a count is the
same number in both packages for the same ``CVNNConfig``:

* A real ``[B, in] @ [in, out]`` matmul is ``2*B*in*out`` FLOPs.
* A ``ComplexLinear`` computes 4 real dots (``models/cvnn.py``), each of its
  two weights in 2 of them: ``8*B*in*out`` forward FLOPs a layer. The count
  walks the model's ``ComplexLinear`` modules (the head, every residual body
  and projection), not its parameter list, so the weights' layout does not
  enter.
* Backward reuses each weight twice (the input-grad and weight-grad dots of
  the same shape): fwd+bwd = 3x forward. Adam and the activations are
  elementwise work and are not counted.
* An N-point complex FFT is ``5*N*log2(N)`` FLOPs, one per contract (the
  batch-mean spectrum is one FFT of the row mean, ``ops/spectrum.py``).

The port multiplies float32 with TF32 off (``runtime/torch_runtime.py``), so
MFU's denominator is the card's float32 rate outside the tensor cores.
"""

from __future__ import annotations

import math

import torch

from spectralmc_tpu_torch.models.cvnn import ComplexLinear

#: Peak float32 (non-tensor-core) rate of one NVIDIA H100 SXM5 in FLOP/s:
#: 67 teraFLOPS, NVIDIA H100 Tensor Core GPU datasheet ("FP32").
H100_SXM_PEAK_FP32_FLOPS: float = 67e12


def matmul_forward_flops(model: torch.nn.Module, batch_size: int) -> int:
    """Forward matmul FLOPs of one CVNN call at ``batch_size`` rows."""
    return sum(
        8 * batch_size * m.in_dim * m.out_dim
        for m in model.modules()
        if isinstance(m, ComplexLinear)
    )


def train_step_matmul_flops(model: torch.nn.Module, batch_size: int) -> int:
    """Fwd+bwd matmul FLOPs of one fused train step (3x forward)."""
    return 3 * matmul_forward_flops(model, batch_size)


def fft_flops(batch_size: int, network_size: int) -> int:
    """FLOPs of the per-contract spectrum FFTs in one train step."""
    return batch_size * int(5 * network_size * math.log2(network_size))


def sim_path_steps(batch_size: int, rows: int, cols: int, timesteps: int) -> int:
    """MC path-steps simulated per train step: the simulation's currency,
    held against the path kernels' own bounds, not a FLOP count."""
    return batch_size * rows * cols * timesteps


def mfu(
    matmul_flops_per_step: float,
    steps_per_sec: float,
    *,
    peak_flops: float = H100_SXM_PEAK_FP32_FLOPS,
) -> tuple[float, float]:
    """(achieved TFLOP/s, fraction of peak) for a measured step rate."""
    achieved = matmul_flops_per_step * steps_per_sec
    return achieved / 1e12, achieved / peak_flops
