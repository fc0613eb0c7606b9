"""Host<->device tensor-tree transfer: a pure plan, then its execution.

The port of the JAX package's ``runtime/transfer.py``: placement types, a
decision type (stay, move, reject), a host-transfer size cap, and moves
over nested lists, tuples and dicts of tensors, plus the placement and dtype
inspector that checks a state dict is uniform.

A host→card move is one ``DirectTransfer``: each leaf is copied to the
device with ``Tensor.to``. A target kind with no device here is rejected,
never left on the host quietly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Union

import numpy as np
import torch

from spectralmc_tpu_torch.core.result import Failure, Result, Success

# 64 MiB host-transfer cap, as the JAX package's
DEFAULT_HOST_TRANSFER_CAP_BYTES = 64 * 1024 * 1024

DeviceTree = Any  # nested lists/tuples/dicts of tensors


@dataclass(frozen=True, slots=True)
class HostPlacement:
    pass


@dataclass(frozen=True, slots=True)
class DevicePlacement:
    device_kind: str
    device_index: int = 0


Placement = Union[HostPlacement, DevicePlacement]


@dataclass(frozen=True, slots=True)
class StayOnPlacement:
    reason: str


@dataclass(frozen=True, slots=True)
class DirectTransfer:
    total_bytes: int


@dataclass(frozen=True, slots=True)
class RejectTransfer:
    reason: str
    total_bytes: int = 0


TransferDecision = Union[StayOnPlacement, DirectTransfer, RejectTransfer]


def _leaves(tree: DeviceTree) -> list[object]:
    """The leaves in the JAX package's order (a dict by sorted key; None is
    an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _map(fn: Callable[[object], object], tree: DeviceTree) -> DeviceTree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, item) for item in tree)
    return fn(tree)


def _dtype_name(leaf: object) -> str:
    """numpy's dtype name (``float32``), for tensors and host values alike."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaf_bytes(leaf: object) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    arr = np.asarray(leaf)
    return int(arr.size) * arr.dtype.itemsize


def _leaf_placement(leaf: object) -> Placement:
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return DevicePlacement(device_kind=leaf.device.type, device_index=leaf.device.index or 0)
    return HostPlacement()


def get_tree_placement(tree: DeviceTree) -> Result[tuple[Placement, str], str]:
    """(placement, dtype) of a tree, failing on mixed placement or dtype —
    used to check that a state dict is uniform before training starts."""
    leaves = _leaves(tree)
    if not leaves:
        return Failure("empty tree")
    placements = {repr(_leaf_placement(leaf)) for leaf in leaves}
    dtypes = {_dtype_name(leaf) for leaf in leaves}
    if len(placements) > 1:
        return Failure(f"mixed placements: {sorted(placements)}")
    if len(dtypes) > 1:
        return Failure(f"mixed dtypes: {sorted(dtypes)}")
    return Success((_leaf_placement(leaves[0]), next(iter(dtypes))))


def plan_tensor_transfer(
    tree: DeviceTree,
    target: Placement,
    *,
    host_cap_bytes: int = DEFAULT_HOST_TRANSFER_CAP_BYTES,
) -> TransferDecision:
    """Pure planning: no data moves here."""
    leaves = _leaves(tree)
    if not leaves:
        return RejectTransfer(reason="empty tree")
    total = sum(_leaf_bytes(leaf) for leaf in leaves)
    if repr(_leaf_placement(leaves[0])) == repr(target):
        return StayOnPlacement(reason="already on target placement")
    if isinstance(target, HostPlacement) and total > host_cap_bytes:
        return RejectTransfer(
            reason=f"host transfer {total} bytes exceeds cap {host_cap_bytes}",
            total_bytes=total,
        )
    return DirectTransfer(total_bytes=total)


def _device_count(kind: str) -> int:
    if kind == "cpu":
        return 1
    if kind == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 0


def move_tensor_tree(
    tree: DeviceTree,
    target: Placement,
    *,
    host_cap_bytes: int = DEFAULT_HOST_TRANSFER_CAP_BYTES,
) -> Result[DeviceTree, RejectTransfer]:
    """Plan, then execute the move. To the host: one synchronised copy of
    each leaf. To a device: each leaf copied with ``Tensor.to``; a device
    index past the last device of its kind clamps to the last. A kind with no
    device here is a ``RejectTransfer``."""
    decision = plan_tensor_transfer(tree, target, host_cap_bytes=host_cap_bytes)
    if isinstance(decision, RejectTransfer):
        return Failure(decision)
    if isinstance(decision, StayOnPlacement):
        return Success(tree)
    if isinstance(target, HostPlacement):
        return Success(_map(lambda leaf: torch.as_tensor(leaf).cpu(), tree))
    count = _device_count(target.device_kind)
    if count == 0:
        return Failure(RejectTransfer(
            reason=f"no {target.device_kind} devices available",
            total_bytes=decision.total_bytes,
        ))
    device = torch.device(target.device_kind, min(target.device_index, count - 1))
    if device.type == "cpu":
        return Success(_map(torch.as_tensor, tree))

    return Success(_map(lambda leaf: torch.as_tensor(leaf).to(device), tree))


__all__ = [
    "DEFAULT_HOST_TRANSFER_CAP_BYTES",
    "DevicePlacement",
    "DirectTransfer",
    "HostPlacement",
    "Placement",
    "RejectTransfer",
    "StayOnPlacement",
    "TransferDecision",
    "get_tree_placement",
    "move_tensor_tree",
    "plan_tensor_transfer",
]
