"""``runtime/transfer.py`` in the port against the JAX package's (tier 1: exact).

The same numpy-built trees go to both packages, as numpy arrays to the JAX
package and as CPU tensors to the port: ``get_tree_placement`` and
``plan_tensor_transfer`` return the same decisions (type, reason and byte
count). Moves: a host tree stays; a tree bound for a device kind with no
device here is rejected, never left on the host; a device index past the
last device clamps to it (``tests/test_runtime.py``'s cases).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spectralmc_tpu.core.result import Failure as JaxFailure
from spectralmc_tpu.runtime import transfer as jt
from spectralmc_tpu_torch import runtime
from spectralmc_tpu_torch.core.result import Failure
from spectralmc_tpu_torch.runtime import transfer as tt

TREES = {
    "uniform": lambda: {"a": np.ones(2, np.float32), "b": np.zeros((3, 4), np.float32)},
    "nested": lambda: {"w": [np.arange(6, dtype=np.float64).reshape(2, 3),
                             (np.ones(5), {"z": np.zeros(7)})], "n": None},
    "mixed_dtype": lambda: {"a": np.ones(3, np.float32), "b": np.ones(3, np.float64)},
    "scalar": lambda: {"s": np.float64(3.0)},
    "ints": lambda: [np.arange(10, dtype=np.int32), np.arange(3, dtype=np.int64)],
    "empty": lambda: {},
    "large": lambda: {"big": np.zeros(1 << 16, np.float32)},
}


def _to_torch(tree: object) -> object:
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def _fields(decision: object) -> tuple[str, dict]:
    return type(decision).__name__, dataclasses.asdict(decision)


def _targets(mod: object) -> list[object]:
    return [mod.HostPlacement(), mod.DevicePlacement(device_kind="cuda"),
            mod.DevicePlacement(device_kind="tpu", device_index=3)]


def test_runtime_exports_the_transfer_names() -> None:
    for name in ("HostPlacement", "DevicePlacement", "StayOnPlacement", "DirectTransfer",
                 "RejectTransfer", "DEFAULT_HOST_TRANSFER_CAP_BYTES", "get_tree_placement",
                 "plan_tensor_transfer", "move_tensor_tree"):
        assert getattr(runtime, name) is getattr(tt, name)
    assert tt.DEFAULT_HOST_TRANSFER_CAP_BYTES == jt.DEFAULT_HOST_TRANSFER_CAP_BYTES


@pytest.mark.parametrize("name", list(TREES))
def test_tree_placement_matches_jax(name: str) -> None:
    want = jt.get_tree_placement(TREES[name]())
    got = tt.get_tree_placement(_to_torch(TREES[name]()))
    assert isinstance(got, Failure) == isinstance(want, JaxFailure)
    if isinstance(want, JaxFailure):
        assert got.error == want.error
    else:
        assert type(got.value[0]).__name__ == type(want.value[0]).__name__
        assert got.value[1] == want.value[1]


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("cap", [jt.DEFAULT_HOST_TRANSFER_CAP_BYTES, 64])
def test_plan_matches_jax(name: str, cap: int) -> None:
    for want_target, got_target in zip(_targets(jt), _targets(tt)):
        want = jt.plan_tensor_transfer(TREES[name](), want_target, host_cap_bytes=cap)
        got = tt.plan_tensor_transfer(_to_torch(TREES[name]()), got_target, host_cap_bytes=cap)
        assert _fields(got) == _fields(want), (name, want_target)


def test_a_card_tree_plans_as_a_device_tree() -> None:
    """A tensor's own device decides its placement (a meta tensor stands in
    for one on a card here)."""
    tree = {"w": torch.empty((4, 4), device="meta")}
    placement, dtype = tt.get_tree_placement(tree).expect("placement")
    assert placement == tt.DevicePlacement(device_kind="meta") and dtype == "float32"
    assert isinstance(tt.plan_tensor_transfer(tree, placement), tt.StayOnPlacement)
    to_host = tt.plan_tensor_transfer(tree, tt.HostPlacement(), host_cap_bytes=8)
    assert to_host == tt.RejectTransfer(reason="host transfer 64 bytes exceeds cap 8",
                                        total_bytes=64)


def test_moves(monkeypatch) -> None:
    host = {"w": torch.arange(6).reshape(2, 3)}
    stayed = tt.move_tensor_tree(host, tt.HostPlacement())
    assert stayed.value is host
    numpy_tree = {"w": np.arange(4, dtype=np.float32), "v": [np.ones(2)]}
    assert tt.move_tensor_tree(numpy_tree, tt.HostPlacement()).value is numpy_tree
    clamped = tt.move_tensor_tree(numpy_tree, tt.DevicePlacement(device_kind="cpu",
                                                                 device_index=999))
    moved = clamped.expect("clamped")
    assert isinstance(moved["w"], torch.Tensor) and isinstance(moved["v"], list)
    np.testing.assert_array_equal(moved["w"].numpy(), numpy_tree["w"])
    assert isinstance(tt.move_tensor_tree(numpy_tree, tt.DevicePlacement(device_kind="tpu")),
                      Failure)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rejected = tt.move_tensor_tree(numpy_tree, tt.DevicePlacement(device_kind="cuda"))
    assert isinstance(rejected, Failure) and isinstance(rejected.error, tt.RejectTransfer)
    assert rejected.error.reason == "no cuda devices available"
    assert isinstance(tt.move_tensor_tree({}, tt.HostPlacement()).error, tt.RejectTransfer)
