"""The fused train step: Sobol → MC → FFT → CVNN forward/backward → Adam.

The port of the JAX package's ``training/step.py``. There the step is one
traced program; here it is eager PyTorch on one device with the same
numerics, and the MC working set streams ``contract_chunk`` contracts at a
time through ONE simulator call each (one kernel launch per chunk on the
``"cuda"`` engine). Chunking is bit-transparent: each contract's stream and
arithmetic are the same at any chunk size. Given a mesh (``parallel/``)
the same step is one rank's share of a sharded batch: its contracts and
rows at their global offsets, joined by the all-reduces of
``ops/collectives.py`` (``parallel/trainer.py`` states the contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.models.factory import CVNN, param_key
from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops.collectives import pmean, pmean_many
from spectralmc_tpu_torch.ops.dispatch import (  # noqa: F401 — re-exported seam
    contract_class,
    contract_dim,
    make_mean_target,
    make_underlier_simulator,
)
from spectralmc_tpu_torch.ops.gbm import ForwardNormalization, SimulationParams, discounted_put
from spectralmc_tpu_torch.ops.sobol import scale_to_bounds, sobol_unit
from spectralmc_tpu_torch.ops.spectrum import mean_spectrum_psum, payoff_spectrum
from spectralmc_tpu_torch.training.adam_state import AdamState, adam_update_, warmup_cosine_rate

if TYPE_CHECKING:  # parallel/ builds on this module
    from spectralmc_tpu_torch.parallel.mesh import MeshSpec


class LRScheduleConfig(BaseModel):
    """Warmup + cosine-decay learning-rate schedule (checkpoint-transparent:
    its position is the Adam step count)."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    peak: float
    decay_steps: int
    warmup_steps: int = 0
    end_value: float = 0.0


def make_optimizer(
    learning_rate: float, lr_schedule: LRScheduleConfig | None = None
) -> Callable[[int], float]:
    """The learning rate as a function of the Adam count (the JAX package's
    ``make_optimizer`` chooses the same constant rate or schedule)."""
    if lr_schedule is None:
        return lambda count: learning_rate
    s = lr_schedule
    return lambda count: warmup_cosine_rate(
        count, peak=s.peak, warmup_steps=s.warmup_steps, decay_steps=s.decay_steps,
        end_value=s.end_value,
    )


def schedule_rates(lr_schedule: LRScheduleConfig, start_count: int, length: int) -> np.ndarray:
    """The per-step learning rates for metrics: ``make_optimizer``'s own rate
    at Adam counts ``start_count .. start_count+length-1`` (the count equals
    the trainer's global step), as the float32 that ``adam_update_`` applies."""
    rate = make_optimizer(lr_schedule.peak, lr_schedule)
    return np.asarray([rate(c) for c in range(start_count, start_count + length)],
                      dtype=np.float32)


@dataclass(frozen=True)
class SobolTable:
    """Device-resident Sobol constants (directions/shift/bounds columns)."""

    directions: torch.Tensor
    shift: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


def make_mc_spectrum(
    sim: SimulationParams, *, device: torch.device, spec: MeshSpec | None = None
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(draw indices [C], contracts [C, D]) -> [C, network]`` complex targets.

    Contract ``i``'s stream key is ``fold_in(prng_key(mc_seed), draw[i])``;
    its payoff underliers are MEAN-normalized to the payoff's own analytic
    mean (if configured), turned into discounted put payoffs and reduced to
    the batch-mean spectrum. With ``spec`` this rank simulates its shard of
    the rows at ``row_offset = paths_index·local_rows``; the MEAN row mean
    and the spectrum's sum are all-reduced over the paths group.
    """
    dtype = sim.precision.to_torch()
    base_key = rng.prng_key(sim.mc_seed, device)
    normalize = sim.normalization == ForwardNormalization.MEAN
    paths = None if spec is None else spec.paths_group
    rows = sim.batches_per_mc_run if spec is None else sim.batches_per_mc_run // spec.paths_divisor
    row_offset = 0 if spec is None else spec.paths_index * rows
    simulate = make_underlier_simulator(sim, rows=rows, paths_group=paths)
    mean_target = make_mean_target(sim)

    def mc_spectrum(draws: torch.Tensor, contracts: torch.Tensor) -> torch.Tensor:
        key_words = rng.fold_in(base_key, draws)
        terminal = simulate(key_words, contracts, row_offset=row_offset)
        flat = terminal.reshape(terminal.shape[0], -1)
        row_mean = None
        if normalize and paths is not None:
            row_mean = pmean(torch.mean(flat, dim=1, keepdim=True), paths)
        put = discounted_put(
            flat,
            contracts,
            normalize=normalize,
            dtype=dtype,
            mean_target=mean_target(contracts),
            term=sim.term,
            row_mean=row_mean,
        )
        if paths is None:
            return payoff_spectrum(put, batches=rows, network_size=sim.network_size)
        return mean_spectrum_psum(put, batches=rows, network_size=sim.network_size,
                                  group=paths, total_batches=sim.batches_per_mc_run)

    return mc_spectrum


def make_input_normalizer(
    table: SobolTable, *, enabled: bool, dtype: torch.dtype
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Affine map of contract features onto [0, 1] from the Sobol bounds
    (degenerate bounds pass through at 0)."""
    if not enabled:
        return lambda x: x
    lower = table.lower.to(dtype)
    span = table.upper.to(dtype) - lower
    safe_span = torch.where(span == 0, torch.ones_like(span), span)
    return lambda x: (x - lower) / safe_span


def model_params(model: CVNN) -> dict[str, torch.Tensor]:
    """Parameters keyed by the JAX parameter path (``layer_0/w_re``)."""
    return {param_key(n): p for n, p in model.named_parameters()}


@dataclass
class StepState:
    """What one batch reads and advances besides the model: Adam + counters."""

    adam: AdamState
    sobol_skip: int
    mc_skip: int


BatchFn = Callable[[StepState], tuple[torch.Tensor, torch.Tensor]]


def shard_shape_error(
    spec: MeshSpec | None, *, batch_size: int, rows: int, contract_chunk: int | None
) -> tuple[str, int, str] | None:
    """``(field, value, reason)`` of the first way a batch does not split
    over ``spec`` (None: one device), else None. A partial
    ``contract_chunk`` must divide the per-shard batch; a chunk at least as
    large is one chunk."""
    dp, mc = (1, 1) if spec is None else (spec.batch_size_divisor, spec.paths_divisor)
    if batch_size % dp:
        return "batch_size", batch_size, f"not divisible by batch axis {dp}"
    if rows % mc:
        return "batches_per_mc_run", rows, f"not divisible by paths axis {mc}"
    local_b = batch_size // dp
    if contract_chunk is not None and contract_chunk < local_b and local_b % contract_chunk:
        return "contract_chunk", contract_chunk, f"must divide the per-shard batch {local_b}"
    return None


def make_fused_batch(
    model: CVNN,
    sim: SimulationParams,
    table: SobolTable,
    *,
    batch_size: int,
    learning_rate: float,
    contract_chunk: int | None = None,
    normalize_inputs: bool = False,
    lr_schedule: LRScheduleConfig | None = None,
    spec: MeshSpec | None = None,
) -> BatchFn:
    """Build the batch function: one device's, or with ``spec`` this rank's.

    ``one_batch(state)`` trains ``model`` (in place) on one batch, advances
    ``state`` by ``batch_size`` and returns ``(loss, grad_inf_norm)`` as 0-d
    float32 device tensors — nothing is fetched to the host. On a mesh the
    rank samples its ``batch_size / batch_shards`` contracts at their global
    Sobol index and draw, and one average over the batch group gives every
    rank the same loss, gradients and batch-norm running statistics.
    """
    error = shard_shape_error(spec, batch_size=batch_size, rows=sim.batches_per_mc_run,
                              contract_chunk=contract_chunk)
    if error is not None:
        field, value, reason = error
        raise ValueError(f"{field} {value}: {reason}")
    device = table.lower.device
    dtype = sim.precision.to_torch()
    mc_spectrum = make_mc_spectrum(sim, device=device, spec=spec)
    rate = make_optimizer(learning_rate, lr_schedule)
    lower = table.lower.to(dtype)
    upper = table.upper.to(dtype)
    normalize_fn = make_input_normalizer(table, enabled=normalize_inputs, dtype=dtype)
    local_b = batch_size if spec is None else batch_size // spec.batch_size_divisor
    offset = 0 if spec is None else spec.batch_index * local_b
    chunk = local_b if contract_chunk is None else min(contract_chunk, local_b)
    params = model_params(model)
    buffers = [b for _, b in model.named_buffers()]

    def one_batch(state: StepState) -> tuple[torch.Tensor, torch.Tensor]:
        start = (state.sobol_skip + offset) & rng.MASK32
        unit = sobol_unit(table.directions, table.shift, start, local_b, dtype)
        contracts = scale_to_bounds(unit, lower, upper)  # [B, D]
        draws = (state.mc_skip + offset + torch.arange(local_b, device=device)) & rng.MASK32
        with torch.no_grad():
            specs = torch.cat([
                mc_spectrum(draws[i:i + chunk], contracts[i:i + chunk])
                for i in range(0, local_b, chunk)
            ])
        inputs = normalize_fn(contracts)  # the MC keeps raw market units
        model.train()
        out_re, out_im = model(inputs, torch.zeros_like(inputs))
        loss = torch.mean(torch.square(out_re - specs.real.to(dtype))) + torch.mean(
            torch.square(out_im - specs.imag.to(dtype))
        )
        grad_list = list(torch.autograd.grad(loss, list(params.values())))
        loss = loss.detach()
        if spec is not None:
            # one average over the batch group: the loss, the gradients and
            # the running statistics (kept replicated across contract shards)
            with torch.no_grad():
                loss, *reduced = pmean_many([loss, *grad_list, *buffers], spec.batch_group)
                grad_list = reduced[:len(params)]
                for live, mean in zip(buffers, reduced[len(params):]):
                    live.copy_(mean)
        grads = dict(zip(params, grad_list))
        grad_norm = torch.stack([g.abs().max() for g in grads.values()]).max()
        adam_update_(params, grads, state.adam, rate(state.adam.count))
        state.sobol_skip = (state.sobol_skip + batch_size) & rng.MASK32
        state.mc_skip = (state.mc_skip + batch_size) & rng.MASK32
        return loss.to(torch.float32), grad_norm.to(torch.float32)

    return one_batch
