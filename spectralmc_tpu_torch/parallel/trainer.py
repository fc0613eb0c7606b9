"""The sharded train step: one batch over a (batch, paths) mesh of ranks.

The port of the JAX package's ``parallel/trainer.py``. The step is the
single-device one of ``training/step.py`` given the mesh: every rank runs the
same eager program on its shard and the collectives of
``ops/collectives.py`` join them.
Numerics contract against the single-device step:

* **Contracts** are identical: Sobol points are a pure function of the
  global index, and batch shard ``i`` samples ``[skip + i·local_B, skip +
  (i+1)·local_B)`` and draws ``mc_skip + i·local_B + j``.
* **MC paths** are identical bit for bit: every engine keys rows by global
  index, and paths shard ``j`` simulates rows ``[j·local_rows, (j+1)·
  local_rows)`` at ``row_offset = j·local_rows`` (antithetic pairs by the
  global half).
* **MEAN normalization** rescales by the row mean over every paths shard
  (an all-reduce before the rescale). Discounting is the single-device
  ``discounted_put``'s, under a curve at its effective rate. (The JAX
  package's sharded step discounts at the flat ``exp(-rate·T)``, so under a
  curved rate it drifts from its own single-device step; this one does not.)
* **Spectra** equal the single-device values up to summation order: each
  rank FFTs the sum of its rows and the sums are all-reduced over ``paths``.
* **Loss, gradients and batch-norm running statistics** are averaged over
  ``batch`` in one all-reduce. Batch-norm batch statistics are per batch
  shard (standard data-parallel batch norm, as the JAX package's).
* **Adam** runs the same arithmetic on every rank from the same reduced
  gradients, so the replicas stay bit-equal.
* **American kinds** all-reduce their LSMC regression moments over
  ``paths`` inside the simulator (``ops/american.py``); on the ``"cuda"``
  engine the backward is the torch estimator (version 0), since one
  cooperative launch cannot wait on a collective per date.

The network is replicated along ``paths`` (it is tiny next to the MC), so
a step's collectives are the spectrum's sum (and, under MEAN, the row mean)
per contract chunk on ``paths``, and one average on ``batch``.
"""

from __future__ import annotations

from typing import Callable

import torch

from spectralmc_tpu_torch.models.factory import CVNN
from spectralmc_tpu_torch.ops.gbm import SimulationParams
from spectralmc_tpu_torch.parallel.mesh import MeshSpec
from spectralmc_tpu_torch.training.step import (
    BatchFn,
    LRScheduleConfig,
    SobolTable,
    StepState,
    make_fused_batch,
)


def make_sharded_batch(
    model: CVNN,
    sim: SimulationParams,
    table: SobolTable,
    *,
    batch_size: int,
    learning_rate: float,
    spec: MeshSpec,
    normalize_inputs: bool = False,
    contract_chunk: int | None = None,
    lr_schedule: LRScheduleConfig | None = None,
) -> BatchFn:
    """This rank's batch function on ``spec``: ``one_batch(state)`` trains
    ``model`` (in place) on one global batch, advances ``state`` by
    ``batch_size`` and returns the batch-averaged ``(loss, grad_inf_norm)``
    as 0-d float32 device tensors, equal on every rank.

    ``contract_chunk`` bounds the shard's MC working set as on one device:
    the shard's contracts stream ``chunk`` at a time. Bit-transparent."""
    return make_fused_batch(
        model, sim, table, batch_size=batch_size, learning_rate=learning_rate,
        contract_chunk=contract_chunk, normalize_inputs=normalize_inputs,
        lr_schedule=lr_schedule, spec=spec,
    )


def make_sharded_segment(
    model: CVNN,
    sim: SimulationParams,
    table: SobolTable,
    *,
    batch_size: int,
    learning_rate: float,
    spec: MeshSpec,
    length: int,
    normalize_inputs: bool = False,
    contract_chunk: int | None = None,
    lr_schedule: LRScheduleConfig | None = None,
) -> Callable[[StepState], tuple[torch.Tensor, torch.Tensor]]:
    """``length`` sharded batches: ``segment(state) -> (losses [length],
    grad norms [length])`` as float32 device tensors (the JAX package's
    ``shard_map``-wrapped scan; here the batches run in a loop)."""
    one_batch = make_sharded_batch(
        model, sim, table, batch_size=batch_size, learning_rate=learning_rate, spec=spec,
        normalize_inputs=normalize_inputs, contract_chunk=contract_chunk, lr_schedule=lr_schedule,
    )

    def segment(state: StepState) -> tuple[torch.Tensor, torch.Tensor]:
        losses, gnorms = zip(*(one_batch(state) for _ in range(length)))
        return torch.stack(losses), torch.stack(gnorms)

    return segment


__all__ = ["make_sharded_batch", "make_sharded_segment"]
