"""Runtime facade: the deterministic numerics policy for PyTorch on the card."""

from spectralmc_tpu_torch.runtime.torch_runtime import (
    TorchRuntime,
    apply_torch_runtime,
    decide_torch_runtime,
    get_torch_handle,
)

__all__ = [
    "TorchRuntime",
    "apply_torch_runtime",
    "decide_torch_runtime",
    "get_torch_handle",
]
