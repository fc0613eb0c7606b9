"""Multi-process and multi-node training: ``torch.distributed`` and the global mesh.

The port of the JAX package's ``parallel/distributed.py``. There one JAX
program per host drives that host's devices; here one process (a rank) drives
one device, so a host holds several ranks.

* ``initialize_distributed`` joins the ranks into one world
  (``torch.distributed.init_process_group``) with an explicit backend:
  ``nccl`` for CUDA devices, ``gloo`` for the CPU. ``gloo`` also reduces CUDA
  tensors, so several ranks may share one card over it (NCCL refuses two
  ranks on one device); that is asked for by name, and nothing falls back
  from ``nccl`` to ``gloo``.
* The **global mesh** adds a leading ``slice`` axis to the ``(batch,
  paths)`` layout, node-major: slice ``i`` holds node ``i``'s ranks.
  Contract data parallelism spans ``("slice", "batch")`` as one composed
  axis, so the sharded trainer (``parallel/trainer.py``) runs unchanged; the
  spectrum's all-reduce stays on the ``paths`` group inside a node and only
  the gradients' all-reduce crosses nodes.
* Host side effects (checkpoint commits, TensorBoard, logs) run on rank 0
  alone through ``coordinator_only``, so N ranks do not race N commits at
  the chain head.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Callable, TypeVar

import torch
import torch.distributed as dist

from spectralmc_tpu_torch.core.errors.trainer import InvalidTrainingConfig, TrainerError
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.parallel.mesh import BATCH_AXIS, PATHS_AXIS, MeshSpec, build_mesh

SLICE_AXIS = "slice"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

T = TypeVar("T")


@dataclass(frozen=True)
class DistributedRuntime:
    """The facts a process needs about the world it joined. One rank drives
    one device, so ``local_device_count`` is 1 and ``global_device_count``
    the world size once joined (0 in a query before it)."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


# the arguments the world was joined with: a later explicit call must match
# them or fail loudly (returning the current world would hide a topology
# misconfiguration)
_init_args: tuple | None = None


def _invalid(value: object, reason: str) -> Failure[TrainerError]:
    return Failure(InvalidTrainingConfig(field="distributed", value=value, reason=reason))


def _init_method(coordinator_address: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``tcp://``, ``file://``) as
    it is."""
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize_distributed(
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str | None = None,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> Result[DistributedRuntime, TrainerError]:
    """Join the world of ranks. Idempotent for MATCHING arguments.

    An explicit join names ``coordinator_address`` (``host:port`` or a
    rendezvous URL: ``tcp://``, ``file://``), ``num_processes`` and
    ``process_id``. A call with none of them is a pure query: it returns the
    current world without joining or latching anything, so a later explicit
    call still works; before any join it reports one process with device
    counts 0.

    An explicit join also names ``device_type``, the kind of device the
    ranks train on; there is no default, so a world meant for the cards
    cannot quietly join over ``gloo``. The backend is ``nccl`` for
    ``device_type="cuda"`` and ``gloo`` for ``"cpu"``, unless ``backend``
    names one (``"gloo"`` for several ranks on one card). ``nccl`` without a
    CUDA device fails: it never turns into ``gloo``. ``timeout_s`` bounds the rendezvous and every collective, so a
    rank that died fails its peers instead of hanging them. A repeated
    explicit call with the same arguments returns the current world; with
    different ones it fails loudly.
    """
    global _init_args
    explicit = (
        coordinator_address is not None
        or process_id is not None
        or num_processes not in (None, 1)
    )
    if not explicit:
        if dist.is_initialized():
            return Success(current_runtime())
        return Success(DistributedRuntime(
            process_index=0, process_count=1, local_device_count=0, global_device_count=0))
    if device_type not in BACKENDS:
        return _invalid(device_type, (
            f"an explicit join needs device_type, one of {sorted(BACKENDS)}"))
    chosen = backend if backend is not None else BACKENDS[device_type]
    requested = (coordinator_address, num_processes, process_id, device_type, chosen)
    if _init_args is not None:
        if requested != _init_args:
            return _invalid(requested, (
                f"torch.distributed already initialized with different arguments "
                f"{_init_args}; a process cannot re-join a different topology"))
        return Success(current_runtime())
    if chosen == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        return _invalid(chosen, (
            "the nccl backend needs a CUDA device and a torch built with NCCL; pass "
            "device_type='cpu' for gloo on the CPU"))
    if coordinator_address is None or num_processes is None or process_id is None:
        return _invalid(requested, (
            "an explicit join needs coordinator_address, num_processes and process_id"))
    try:
        dist.init_process_group(
            backend=chosen, init_method=_init_method(coordinator_address),
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError) as exc:
        return _invalid(coordinator_address, f"init_process_group failed: {exc}")
    _init_args = requested
    return Success(current_runtime())


def joined_device_type() -> str | None:
    """The ``device_type`` the world was joined for: the one named to
    ``initialize_distributed``, else the one its backend implies (a world
    joined by ``init_process_group`` directly); None before a join."""
    if _init_args is not None:
        return _init_args[3]
    if not dist.is_initialized():
        return None
    return {"nccl": "cuda", "gloo": "cpu"}.get(str(dist.get_backend()))


def shutdown_distributed() -> None:
    """Leave the world (``destroy_process_group``); a later
    ``initialize_distributed`` may join another."""
    global _init_args
    if dist.is_initialized():
        dist.destroy_process_group()
    _init_args = None


def current_runtime() -> DistributedRuntime:
    if not dist.is_initialized():
        return DistributedRuntime(
            process_index=0, process_count=1, local_device_count=1, global_device_count=1)
    world = dist.get_world_size()
    return DistributedRuntime(
        process_index=dist.get_rank(), process_count=world,
        local_device_count=1, global_device_count=world)


def is_coordinator() -> bool:
    """True on the rank that owns host side effects (commits, TensorBoard, logs)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def coordinator_only(fn: Callable[..., T], *, name: str | None = None) -> Callable[..., T | None]:
    """Wrap a host side effect so only rank 0 executes it; the other ranks
    get None back. The gate is read at CALL time, so wrapping is legal
    before ``initialize_distributed``."""

    def gated(*args: object, **kwargs: object) -> T | None:
        if is_coordinator():
            return fn(*args, **kwargs)
        return None

    gated.__name__ = f"coordinator_only_{name or getattr(fn, '__name__', 'fn')}"
    return gated


def build_global_mesh_spec(
    *,
    batch_shards_per_slice: int,
    paths_shards: int,
    num_slices: int | None = None,
) -> Result[MeshSpec, TrainerError]:
    """The global ``(slice, batch, paths)`` mesh (collective); contract DP
    spans ``("slice", "batch")``. Ranks are laid out node-major, as a
    launcher numbers them, so slice ``i`` is node ``i``'s ranks and the
    ``paths`` all-reduce stays inside a node. ``num_slices`` defaults to the
    slices the world holds: its size over ``batch_shards_per_slice *
    paths_shards``."""
    per_slice = batch_shards_per_slice * paths_shards
    if num_slices is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        num_slices = max(world // per_slice, 1) if per_slice > 0 else 1
    return build_mesh(
        (SLICE_AXIS, BATCH_AXIS, PATHS_AXIS), (num_slices, batch_shards_per_slice, paths_shards),
        batch_axis=(SLICE_AXIS, BATCH_AXIS), paths_axis=PATHS_AXIS,
    )


__all__ = [
    "SLICE_AXIS",
    "DistributedRuntime",
    "build_global_mesh_spec",
    "coordinator_only",
    "current_runtime",
    "initialize_distributed",
    "is_coordinator",
    "joined_device_type",
    "shutdown_distributed",
]
