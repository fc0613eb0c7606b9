"""Runtime facade: the deterministic numerics policy for PyTorch on the card,
and host<->device moves of tensor trees."""

from spectralmc_tpu_torch.runtime.torch_runtime import (
    TorchRuntime,
    apply_torch_runtime,
    decide_torch_runtime,
    get_torch_handle,
)
from spectralmc_tpu_torch.runtime.transfer import (
    DEFAULT_HOST_TRANSFER_CAP_BYTES,
    DevicePlacement,
    DirectTransfer,
    HostPlacement,
    RejectTransfer,
    StayOnPlacement,
    get_tree_placement,
    move_tensor_tree,
    plan_tensor_transfer,
)

__all__ = [
    "DEFAULT_HOST_TRANSFER_CAP_BYTES",
    "DevicePlacement",
    "DirectTransfer",
    "HostPlacement",
    "RejectTransfer",
    "StayOnPlacement",
    "TorchRuntime",
    "apply_torch_runtime",
    "decide_torch_runtime",
    "get_torch_handle",
    "get_tree_placement",
    "move_tensor_tree",
    "plan_tensor_transfer",
]
