"""Meshes of ranks for sharded training: the port of the JAX package's ``parallel/mesh.py``.

Two mesh axes map the workload's natural parallelism, as there:

* ``batch`` — data parallel over contracts: each shard samples and simulates
  its own contract slice; the loss, the gradients and the batch-norm running
  statistics are averaged over the axis (one all-reduce a step).
* ``paths`` — Monte-Carlo parallel within a contract: each shard simulates a
  slice of the MC rows (the same bits, keyed by global row at
  ``row_offset``) and the per-contract spectra are summed over the axis.

A JAX mesh is an array of devices with named axes, and a collective rides
one axis. Here one ``torch.distributed`` rank drives one shard: the mesh is
the world's ranks laid out row-major over the axes, and an axis (or a tuple
of axes, composed as JAX composes them) is the process group of the ranks
that differ only in those coordinates. ``build_mesh_spec`` is collective:
every rank calls it with the same shape, in the same order as every other
group it makes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from spectralmc_tpu_torch.core.errors.trainer import InvalidTrainingConfig, TrainerError
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops.collectives import ProcessGroup

BATCH_AXIS = "batch"
PATHS_AXIS = "paths"


def _names(axis: "str | tuple[str, ...]") -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


@dataclass(frozen=True, eq=False)
class MeshSpec:
    """This rank's place in a mesh, and the groups of its two training axes.

    ``axis_names``/``axis_sizes`` lay the world's ranks out row-major;
    ``coords`` are this rank's coordinates. Axis names may be tuples — the
    multi-node global mesh composes ``("slice", "batch")`` into the
    contract-DP axis (``parallel/distributed.py::build_global_mesh_spec``),
    and the sharded trainer runs unchanged over it.
    """

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    coords: tuple[int, ...]
    batch_group: ProcessGroup
    paths_group: ProcessGroup
    batch_axis: "str | tuple[str, ...]" = BATCH_AXIS
    paths_axis: "str | tuple[str, ...]" = PATHS_AXIS

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _size(self, axis: "str | tuple[str, ...]") -> int:
        return math.prod(self.shape[name] for name in _names(axis))

    def _index(self, axis: "str | tuple[str, ...]") -> int:
        """This rank's index along ``axis``, row-major over a composed one."""
        at = dict(zip(self.axis_names, self.coords))
        index = 0
        for name in _names(axis):
            index = index * self.shape[name] + at[name]
        return index

    @property
    def batch_size_divisor(self) -> int:
        return self._size(self.batch_axis)

    @property
    def paths_divisor(self) -> int:
        return self._size(self.paths_axis)

    @property
    def batch_index(self) -> int:
        """This rank's contract shard (JAX's ``axis_index(batch_axis)``)."""
        return self._index(self.batch_axis)

    @property
    def paths_index(self) -> int:
        """This rank's row shard (JAX's ``axis_index(paths_axis)``)."""
        return self._index(self.paths_axis)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.batch_group))


def _mesh_failure(value: object, reason: str) -> Failure[TrainerError]:
    return Failure(InvalidTrainingConfig(field="mesh", value=value, reason=reason))


def _axis_group(sizes: tuple[int, ...], axes: list[int], rank: int) -> ProcessGroup:
    """Make the process group of every line of ranks along ``axes`` (each
    rank makes all of them, in one order) and return this rank's."""
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    lines = np.moveaxis(grid, axes, list(range(-len(axes), 0))).reshape(
        -1, math.prod(sizes[a] for a in axes))
    mine: list[ProcessGroup] = []
    for line in lines:
        group = dist.new_group(line.tolist())
        if rank in line:
            mine.append(group)
    (group,) = mine  # every rank lies on exactly one line of each axis
    return group


def build_mesh(
    axis_names: tuple[str, ...],
    axis_sizes: tuple[int, ...],
    *,
    batch_axis: "str | tuple[str, ...]",
    paths_axis: "str | tuple[str, ...]",
) -> Result[MeshSpec, TrainerError]:
    """A mesh over the whole world, one rank a shard (collective).

    Fails on a non-positive axis, on a world smaller than the mesh (``needs
    N devices, have M``, as JAX's does) or larger (a rank has no shard: JAX
    leaves a spare device idle, a rank cannot be), and before
    ``torch.distributed`` is initialized.
    """
    if any(n <= 0 for n in axis_sizes):
        return _mesh_failure(axis_sizes, "shards must be > 0")
    need = math.prod(axis_sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need > world:
        return _mesh_failure(need, f"needs {need} devices, have {world}")
    if need < world:
        return _mesh_failure(
            need, f"the world has {world} ranks and the mesh {need} shards: one rank "
            "drives one shard, so a mesh must take the whole world")
    if not dist.is_initialized():
        return _mesh_failure(
            need, "torch.distributed is not initialized: call "
            "parallel.distributed.initialize_distributed on every rank first")
    rank = dist.get_rank()
    index = {name: i for i, name in enumerate(axis_names)}
    return Success(MeshSpec(
        axis_names=axis_names,
        axis_sizes=axis_sizes,
        coords=tuple(int(c) for c in np.unravel_index(rank, axis_sizes)),
        batch_group=_axis_group(axis_sizes, [index[n] for n in _names(batch_axis)], rank),
        paths_group=_axis_group(axis_sizes, [index[n] for n in _names(paths_axis)], rank),
        batch_axis=batch_axis,
        paths_axis=paths_axis,
    ))


def build_mesh_spec(*, batch_shards: int, paths_shards: int) -> Result[MeshSpec, TrainerError]:
    """The 2-axis training mesh over ``batch_shards * paths_shards`` ranks."""
    return build_mesh(
        (BATCH_AXIS, PATHS_AXIS), (batch_shards, paths_shards),
        batch_axis=BATCH_AXIS, paths_axis=PATHS_AXIS,
    )


__all__ = ["BATCH_AXIS", "PATHS_AXIS", "MeshSpec", "build_mesh", "build_mesh_spec"]
