"""Deterministic runtime configuration as data.

The JAX package's ``runtime/jax_runtime.py`` pins ``highest`` matmul
precision so no float32 product silently runs in a reduced format. The
PyTorch counterpart pins the same numerics on the card, exactly once:

* TF32 off for matmuls and for cuDNN (a float32 convolution runs in TF32 by
  default under PyTorch; TF32 keeps about three decimal digits);
* ``torch.set_float32_matmul_precision("highest")``;
* deterministic algorithms, with ``CUBLAS_WORKSPACE_CONFIG`` set before the
  first cuBLAS handle exists (cuBLAS refuses deterministic mode without it).

``decide_torch_runtime`` probes without side effects; ``apply_torch_runtime``
applies once and caches.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch

_LOCK = threading.Lock()
_APPLIED: "TorchRuntime | None" = None

CUBLAS_WORKSPACE = ":4096:8"


@dataclass(frozen=True, slots=True)
class TorchRuntime:
    """Probe result (pure data); the policy applied is fixed."""

    cuda_available: bool
    device_name: str
    device_count: int
    torch_version: str
    cuda_version: str | None


def decide_torch_runtime() -> TorchRuntime:
    """Probe the installation; no side effects."""
    available = torch.cuda.is_available()
    return TorchRuntime(
        cuda_available=available,
        device_name=torch.cuda.get_device_name(0) if available else "cpu",
        device_count=torch.cuda.device_count() if available else 0,
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
    )


def apply_torch_runtime(runtime: TorchRuntime) -> TorchRuntime:
    """Apply the numerics policy exactly once (idempotent, thread-guarded)."""
    global _APPLIED
    with _LOCK:
        if _APPLIED is not None:
            return _APPLIED
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.set_float32_matmul_precision("highest")
        torch.use_deterministic_algorithms(True)
        _APPLIED = runtime
        return runtime


def get_torch_handle() -> TorchRuntime:
    """Probe + apply + return the cached runtime."""
    with _LOCK:
        cached = _APPLIED
    if cached is not None:
        return cached
    return apply_torch_runtime(decide_torch_runtime())
