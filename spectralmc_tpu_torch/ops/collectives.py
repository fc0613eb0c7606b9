"""The all-reduces of sharded training, JAX's ``psum`` and ``pmean`` over a mesh axis.

A mesh axis of the JAX package is a ``torch.distributed`` process group here
(``parallel/mesh.py``): one rank a shard. ``psum`` sums a tensor over the
group's ranks; ``pmean`` is that sum divided by the group's size, as JAX's
``pmean`` is a ``psum`` and a divide (``ReduceOp.AVG`` exists only under
NCCL). Complex tensors reduce as their real view (``torch.view_as_real``),
which every backend takes. Every rank of a ring all-reduce ends with the same
bytes, so replicas fed by these stay bit-equal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from spectralmc_tpu_torch.utils.profiling import span

ProcessGroup = dist.ProcessGroup


def psum(tensor: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """``tensor`` summed over ``group``'s ranks, as a new tensor (one
    ``spectralmc.collective`` span: every all-reduce of this module is one)."""
    with span("spectralmc.collective"):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(torch.view_as_real(out) if out.is_complex() else out,
                        op=dist.ReduceOp.SUM, group=group)
        return out


def pmean(tensor: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """``tensor`` averaged over ``group``'s ranks: the sum, then a divide."""
    return psum(tensor, group) / dist.get_world_size(group)


def pmean_many(tensors: list[torch.Tensor], group: ProcessGroup) -> list[torch.Tensor]:
    """Each of ``tensors`` (one dtype) averaged over ``group`` in one
    all-reduce: the tensors are flattened into one buffer, reduced and split
    back. Elementwise it is ``pmean`` of each."""
    flat = pmean(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [part.reshape(t.shape)
            for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors]))]


__all__ = ["ProcessGroup", "pmean", "pmean_many", "psum"]
