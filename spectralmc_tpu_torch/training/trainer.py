"""GbmCVNNPricer — the training orchestrator on PyTorch.

The port of the JAX package's ``training/trainer.py``: ``TrainingConfig``,
the four commit plans, the checkpoint root ``GbmCVNNPricerConfig`` (same
fields, plus ``cuda_stream_version`` and ``provenance``), ``StepMetrics`` and
``SegmentMetrics`` with their callbacks, ``GreeksPrediction``, and
``GbmCVNNPricer.create/train/train_via_effects/snapshot/predict_price/predict_greeks``.

* ``create`` takes an explicit ``device``; nothing is picked by default.
  With a ``mesh_spec`` (``parallel/mesh.py``) the pricer is this rank's
  replica: its batches are the sharded step of ``parallel/trainer.py``, its
  LSMC backward is the torch estimator, and a partial ``contract_chunk``
  must divide the per-shard batch. Commits go through the caller's ``coordinator_only`` hook.
* The MC engine that will run is resolved and recorded: a fresh config
  whose engine cannot run is downgraded, a mid-stream one fails with
  ``EngineMismatch``, and a ``"pallas"`` config (the TPU hardware-PRNG
  stream, which no GPU reproduces) is refused outright. So is the LSMC
  backward of an American kind: a checkpoint recorded on another backward,
  or on one of the JAX package's TPU backwards, fails with
  ``EngineMismatch``.
* ``train`` runs segments cut at the commit boundaries. A segment is its
  batches, then one device→host copy of its losses and gradient norms, the
  divergence check, the metrics callbacks and the commit. Cutting adds host
  syncs and nothing else: the losses of ``IntervalCommit(k)`` equal
  ``NoCommit``'s bit for bit. A segment whose last loss is not finite is
  undone — weights, batch-norm buffers, Adam moments and counters go back to
  its start (a device-side copy taken there, ``SegmentStart``) — and
  ``train`` returns ``NonFiniteLoss``, so the pricer is left as the JAX
  package leaves its immutable state.
* A checkpoint carries weights, batch-norm statistics and Adam moments as
  numpy arrays under the JAX package's keys, so a JAX ``snapshot()`` resumes
  here and resume is bit-exact on one device.
* ``predict_price`` uploads the ``[N, D]`` contract matrix once and fetches
  one packed ``[put | E[u] | residue]`` vector once; calls follow by parity
  on the payoff's own underlier where ``has_closed_form_mean`` holds, and
  are NaN (with a warning) where it does not. An American kind serves its
  own side from the learned channel and NaN on the other.
* ``predict_greeks`` differentiates the same map: ``[N, D]`` Jacobians of
  put and call and their spot-gammas (a double backward), the prices equal
  to ``predict_price``'s, under the same one copy each way.
* The dynamics (GBM, Heston, Merton, baskets) and the sampling (pseudo or
  ``SOBOL_BB``) change nothing in kind: the contract class and its width
  (6, 10, 9, 6 — the CVNN's input width follows), the simulator and the mean
  target come from ``ops/dispatch.py``, the basket's spec and the sampling
  ride in the checkpointed ``SimulationParams``, and the stream version is
  recorded per (model, payoff, curved term).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import operator
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence, Union

import numpy as np
import torch

from spectralmc_tpu_torch.core.errors.trainer import (
    CheckpointMismatch,
    CommitPlanMismatch,
    EngineMismatch,
    InvalidTrainingConfig,
    NonFiniteLoss,
    TrainerError,
)
from spectralmc_tpu_torch.core.provenance import Provenance, torch_env_snapshot
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.effects.interpreter import SpectralMCInterpreter
from spectralmc_tpu_torch.effects.types import CommitVersion, TrainSegment
from spectralmc_tpu_torch.models.factory import (
    CVNN,
    CVNNConfig,
    build_model,
    get_state_dict,
    load_state_dict,
)
from spectralmc_tpu_torch.ops.american_cuda import LSMC_BACKWARD_VERSIONS, resolve_lsmc_backward
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    PayoffKind,
    SimImplementation,
    SimulationParams,
    curved,
    has_closed_form_mean,
    resolve_implementation,
)
from spectralmc_tpu_torch.ops.gbm_cuda import cuda_stream_version
from spectralmc_tpu_torch.ops.sobol import (
    BoundSpec,
    SobolConfig,
    SobolSampler,
    build_domain_bounds,
)
from spectralmc_tpu_torch.parallel.distributed import joined_device_type
from spectralmc_tpu_torch.parallel.mesh import MeshSpec
from spectralmc_tpu_torch.training.adam_state import (
    AdamState,
    AdamStateSnapshot,
    coerce_optimizer_state,
)
from spectralmc_tpu_torch.training.effects_builders import (
    build_training_run_effects,
    segment_lengths,
)
from spectralmc_tpu_torch.training.step import (
    BatchFn,
    LRScheduleConfig,
    SobolTable,
    StepState,
    contract_class,
    contract_dim,
    make_fused_batch,
    make_input_normalizer,
    make_mean_target,
    model_params,
    schedule_rates,
    shard_shape_error,
)
from spectralmc_tpu_torch.utils.profiling import profile_trace, span

IFFT_RESIDUE_WARN = 1e-6
_LOG = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Training config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainingConfig:
    num_batches: int
    batch_size: int
    learning_rate: float
    # Bound the MC working set: spectrum targets stream `contract_chunk`
    # contracts at a time (one simulator call each). Bit-transparent.
    contract_chunk: int | None = None
    lr_schedule: LRScheduleConfig | None = None


def build_training_config(
    *,
    num_batches: int,
    batch_size: int,
    learning_rate: float,
    contract_chunk: int | None = None,
    lr_schedule: LRScheduleConfig | None = None,
) -> Result[TrainingConfig, TrainerError]:
    if num_batches <= 0:
        return Failure(
            InvalidTrainingConfig(field="num_batches", value=num_batches, reason="must be > 0")
        )
    if batch_size <= 0:
        return Failure(
            InvalidTrainingConfig(field="batch_size", value=batch_size, reason="must be > 0")
        )
    if not (0.0 < learning_rate < 1.0):
        return Failure(
            InvalidTrainingConfig(
                field="learning_rate", value=learning_rate, reason="must be in (0, 1)"
            )
        )
    if contract_chunk is not None and (contract_chunk <= 0 or batch_size % contract_chunk):
        return Failure(
            InvalidTrainingConfig(
                field="contract_chunk",
                value=contract_chunk,
                reason="must be > 0 and divide batch_size",
            )
        )
    if lr_schedule is not None:
        if lr_schedule.peak <= 0.0:
            return Failure(
                InvalidTrainingConfig(
                    field="lr_schedule.peak", value=lr_schedule.peak, reason="must be > 0"
                )
            )
        if lr_schedule.end_value < 0.0:
            return Failure(
                InvalidTrainingConfig(
                    field="lr_schedule.end_value",
                    value=lr_schedule.end_value,
                    reason="must be >= 0",
                )
            )
        if not (0 <= lr_schedule.warmup_steps < lr_schedule.decay_steps):
            return Failure(
                InvalidTrainingConfig(
                    field="lr_schedule",
                    value=lr_schedule.warmup_steps,
                    reason="need 0 <= warmup_steps < decay_steps",
                )
            )
    return Success(
        TrainingConfig(
            num_batches=num_batches,
            batch_size=batch_size,
            learning_rate=learning_rate,
            contract_chunk=contract_chunk,
            lr_schedule=lr_schedule,
        )
    )


# --------------------------------------------------------------------------
# Commit plans
# --------------------------------------------------------------------------

DEFAULT_COMMIT_MESSAGE = "step={step} loss={loss:.6g} batch={batch}"


@dataclass(frozen=True, slots=True)
class NoCommit:
    pass


@dataclass(frozen=True, slots=True)
class FinalCommit:
    message_template: str = DEFAULT_COMMIT_MESSAGE


@dataclass(frozen=True, slots=True)
class IntervalCommit:
    interval: int
    message_template: str = DEFAULT_COMMIT_MESSAGE


@dataclass(frozen=True, slots=True)
class FinalAndIntervalCommit:
    interval: int
    message_template: str = DEFAULT_COMMIT_MESSAGE


CommitPlan = Union[NoCommit, FinalCommit, IntervalCommit, FinalAndIntervalCommit]
# A commit hook receives (snapshot, rendered message); storage adapts its
# async commit into this synchronous seam (storage/checkpoint.py).
CommitFn = Callable[["GbmCVNNPricerConfig", str], None]


def _commit_interval(plan: CommitPlan) -> int | None:
    if isinstance(plan, (IntervalCommit, FinalAndIntervalCommit)):
        return plan.interval
    return None


def _commits_final(plan: CommitPlan) -> bool:
    return isinstance(plan, (FinalCommit, FinalAndIntervalCommit))


def _plan_template(plan: CommitPlan) -> str:
    return getattr(plan, "message_template", DEFAULT_COMMIT_MESSAGE)


def _plan_error(plan: CommitPlan, commit_fn: CommitFn | None) -> TrainerError | None:
    if not isinstance(plan, NoCommit) and commit_fn is None:
        return CommitPlanMismatch(reason="commit plan requires a commit_fn/store")
    if isinstance(plan, NoCommit) and commit_fn is not None:
        return CommitPlanMismatch(reason="commit_fn provided but plan is NoCommit")
    interval = _commit_interval(plan)
    if interval is not None and interval <= 0:
        return CommitPlanMismatch(reason="commit interval must be > 0")
    return None


# --------------------------------------------------------------------------
# Checkpoint root and results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GbmCVNNPricerConfig:
    """The checkpoint root: everything a bit-exact resume needs.

    The JAX package's fields, plus ``cuda_stream_version``: the Philox
    stream a ``"cuda"`` checkpoint was trained on (``CUDA_STREAM_VERSIONS``;
    0 = not trained on it), so a kernel rebuild that changes the stream
    cannot continue a checkpoint silently. ``lsmc_backward_version`` records
    the LSMC backward that ran (``american_cuda.resolve_lsmc_backward``: 0
    the torch estimator, 3 the CUDA backward on the price alone, 4 on two
    states; the JAX package's 1 and 2 are refused). ``provenance`` holds the
    environment records the checkpoint's bytes carried (``JaxEnv``,
    ``TorchEnv`` or none), written back unchanged when it is encoded; a
    ``snapshot()`` carries this process's ``TorchEnv``.
    """

    sim: SimulationParams
    bounds: Mapping[str, BoundSpec]
    cvnn: CVNNConfig
    global_step: int = 0
    sobol_skip: int = 0
    normalize_inputs: bool = False
    pallas_stream_version: int = 0
    lsmc_backward_version: int = 0
    model_state: Mapping[str, np.ndarray] | None = None
    optimizer_state: AdamStateSnapshot | Mapping[str, np.ndarray] | None = None
    cuda_stream_version: int = 0
    provenance: Provenance = Provenance()


@dataclass(frozen=True, slots=True)
class StepMetrics:
    """Per-batch scalars for the step callback."""

    step: int
    loss: float
    grad_norm: float
    learning_rate: float


@dataclass(frozen=True, slots=True)
class SegmentMetrics:
    """One segment's metrics in bulk — one host hand-off per segment.

    ``losses[i]``/``grad_norms[i]`` belong to global step ``start_step + i``;
    ``learning_rate`` is the rate of the segment's last step.
    """

    start_step: int
    losses: np.ndarray
    grad_norms: np.ndarray
    learning_rate: float


@dataclass(frozen=True)
class TrainingResult:
    updated_config: GbmCVNNPricerConfig
    final_loss: float
    total_batches: int
    final_grad_norm: float
    losses: np.ndarray = field(repr=False, default_factory=lambda: np.zeros(0))
    grad_norms: np.ndarray = field(repr=False, default_factory=lambda: np.zeros(0))


@dataclass(frozen=True)
class PricePrediction:
    put: np.ndarray
    call: np.ndarray
    imag_residue: float


@dataclass(frozen=True)
class GreeksPrediction:
    """Sensitivities of the LEARNED pricer.

    The surrogate price is smooth in every contract field (IFFT∘CVNN of
    normalized inputs), so full Jacobians and spot-gamma are plain autograd.
    ``jacobian[:, i]`` is ∂price/∂fields[i]; call columns are NaN where the
    payoff has no closed-form E[underlier] (calls come by parity). An
    American kind trains ONE side: the learned channel lands on that side
    and the other is NaN (for AMERICAN_CALL the put columns). Conventions
    match ``ops.greeks.MCGreeks`` (market theta = −jacobian[:, maturity]).
    """

    put: np.ndarray  # [N]
    call: np.ndarray  # [N]
    put_jacobian: np.ndarray  # [N, D]
    call_jacobian: np.ndarray  # [N, D]
    put_gamma: np.ndarray  # [N] — ∂²put/∂spot²
    call_gamma: np.ndarray  # [N]
    fields: tuple[str, ...]


def _contracts_to_host(
    contracts: "Sequence[object] | np.ndarray", contract_cls: type, dtype: np.dtype
) -> np.ndarray:
    """``[N, D]`` host matrix in ``model_fields`` order: a columnar ndarray is
    taken as is (checked), model instances are marshalled by attrgetter."""
    fields = tuple(contract_cls.model_fields.keys())
    if isinstance(contracts, np.ndarray):
        if contracts.ndim != 2 or contracts.shape[1] != len(fields):
            raise ValueError(
                f"contract array must be [N, {len(fields)}] in "
                f"{contract_cls.__name__} field order {fields}; got shape {contracts.shape}"
            )
        return np.ascontiguousarray(contracts, dtype=dtype)
    get = operator.attrgetter(*fields)
    return np.asarray([get(c) for c in contracts], dtype=dtype)


def _pad_to_bucket(arr: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad ``[N, D]`` to the next power of two by repeating the last row."""
    n = arr.shape[0]
    if n == 0:
        return arr, n
    bucket = 1 << (n - 1).bit_length()
    if bucket > n:
        arr = torch.cat([arr, arr[-1:].expand(bucket - n, arr.shape[1])], dim=0)
    return arr, n


class SegmentStart:
    """The trainable state at a segment's start, kept on the device, so that
    a diverged segment can be undone.

    A batch updates the weights and batch-norm buffers in place, so they are
    cloned; ``adam_update_`` replaces each moment tensor rather than writing
    into it, so holding the start's moment tensors keeps them.
    """

    def __init__(self, weights: tuple[torch.Tensor, ...], adam: AdamState) -> None:
        self._weights = weights
        self._mu, self._nu, self._count = dict(adam.mu), dict(adam.nu), adam.count

    @classmethod
    @torch.no_grad()
    def take(cls, model: CVNN, adam: AdamState) -> "SegmentStart":
        return cls(tuple(t.clone() for t in model.state_dict().values()), adam)

    @torch.no_grad()
    def restore(self, model: CVNN, adam: AdamState) -> None:
        for live, saved in zip(model.state_dict().values(), self._weights):
            live.copy_(saved)
        adam.mu, adam.nu, adam.count = dict(self._mu), dict(self._nu), self._count


# --------------------------------------------------------------------------
# The pricer
# --------------------------------------------------------------------------


class GbmCVNNPricer:
    """Online CVNN-on-MC-spectra trainer and server on one torch device (on
    a mesh, one rank's replica)."""

    def __init__(
        self,
        config: GbmCVNNPricerConfig,
        model: CVNN,
        opt_snapshot: AdamStateSnapshot | None,
        sampler: SobolSampler[object],
        device: torch.device,
        mesh_spec: MeshSpec | None = None,
    ) -> None:
        self._sim = config.sim
        self._bounds = dict(config.bounds)
        self._cvnn_cfg = config.cvnn
        self._model = model
        self._opt_snapshot = opt_snapshot
        self._sampler = sampler
        self._device = device
        self._mesh_spec = mesh_spec
        self._global_step = config.global_step
        self._sobol_skip = config.sobol_skip
        self._normalize_inputs = config.normalize_inputs
        self._cuda_stream_version = config.cuda_stream_version
        self._lsmc_backward_version = config.lsmc_backward_version
        self._torch_env = torch_env_snapshot(device)
        self._table = self._sobol_table()
        self._adam: AdamState | None = None  # the live moments, from the first train call
        self._step_callback: Callable[[StepMetrics], None] | None = None
        self._segment_callback: Callable[[SegmentMetrics], None] | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        config: GbmCVNNPricerConfig,
        *,
        device: torch.device | str,
        mesh_spec: MeshSpec | None = None,
    ) -> Result["GbmCVNNPricer", TrainerError]:
        """The pricer for ``config`` on ``device``; with ``mesh_spec`` (built
        on every rank, ``parallel/mesh.py``) this rank's replica of a sharded
        pricer (on a mesh the LSMC backward is the torch estimator)."""
        device = torch.device(device)
        if mesh_spec is not None and not isinstance(mesh_spec, MeshSpec):
            raise TypeError(
                f"mesh_spec must be a parallel.mesh.MeshSpec, got {type(mesh_spec).__name__}")
        if mesh_spec is not None:
            joined = joined_device_type()
            if joined != device.type:
                return Failure(InvalidTrainingConfig(
                    field="mesh", value=str(device),
                    reason=f"the world was joined for {joined} devices "
                    f"({mesh_spec.backend}); join with device_type={device.type!r}"))
        sim = config.sim
        if sim.implementation == SimImplementation.PALLAS:
            return Failure(
                EngineMismatch(
                    requested="pallas",
                    effective="none",
                    reason="the 'pallas' stream is the TPU hardware PRNG, which this "
                    "package cannot draw; train on 'cuda' or 'xla' instead",
                )
            )
        mid_stream = config.global_step > 0 or config.sobol_skip > 0 or sim.skip > 0
        effective = resolve_implementation(sim)
        if effective != sim.implementation:
            if mid_stream:
                return Failure(
                    EngineMismatch(
                        requested=sim.implementation.value,
                        effective=effective.value,
                        reason="checkpoint was trained on an engine that cannot run "
                        "this config; its bit stream cannot continue",
                    )
                )
            _LOG.warning(
                "MC engine %s cannot run this config; running %s",
                sim.implementation.value,
                effective.value,
            )
            sim = sim.model_copy(update={"implementation": effective})
        stream_version = 0
        if effective == SimImplementation.CUDA:
            stream_version = cuda_stream_version(
                sim.model, sim.payoff, term=curved(sim.term) is not None
            )
            if mid_stream and config.cuda_stream_version != stream_version:
                return Failure(
                    EngineMismatch(
                        requested=f"cuda stream v{config.cuda_stream_version}",
                        effective=f"cuda stream v{stream_version}",
                        reason="the CUDA kernel's stream changed since this checkpoint "
                        "was written; its bit stream cannot continue",
                    )
                )
        backward_version = resolve_lsmc_backward(sim, rows=sim.batches_per_mc_run,
                                                 sharded=mesh_spec is not None)
        recorded_backward = config.lsmc_backward_version
        if recorded_backward not in (0, *LSMC_BACKWARD_VERSIONS.values()) or (
            mid_stream and recorded_backward != backward_version
        ):
            return Failure(
                EngineMismatch(
                    requested=f"lsmc backward v{recorded_backward}",
                    effective=f"lsmc backward v{backward_version}",
                    reason="the LSMC backward this checkpoint was trained on cannot run "
                    "here (1 and 2 are the JAX package's TPU kernels); its exercise-policy "
                    "bit stream cannot continue",
                )
            )
        ccls = contract_class(sim)
        bounds_res = build_domain_bounds(ccls, config.bounds)
        if isinstance(bounds_res, Failure):
            return Failure(CheckpointMismatch(field="bounds", reason=repr(bounds_res.error)))
        model_res = build_model(
            config.cvnn, input_dim=contract_dim(sim), output_dim=sim.network_size
        )
        if isinstance(model_res, Failure):
            return Failure(CheckpointMismatch(field="cvnn", reason=repr(model_res.error)))
        model = model_res.value
        if config.model_state is not None:
            loaded = load_state_dict(model, config.model_state)
            if isinstance(loaded, Failure):
                return Failure(
                    CheckpointMismatch(field="model_state", reason=repr(loaded.error))
                )
        model.to(device)
        sampler_res = SobolSampler.create(
            ccls, bounds_res.value, SobolConfig(seed=sim.mc_seed, skip=config.sobol_skip)
        )
        if isinstance(sampler_res, Failure):
            return Failure(CheckpointMismatch(field="sobol", reason=repr(sampler_res.error)))
        try:
            opt = coerce_optimizer_state(config.optimizer_state)
        except (KeyError, ValueError) as exc:
            return Failure(CheckpointMismatch(field="optimizer_state", reason=str(exc)))
        recorded_config = GbmCVNNPricerConfig(
            sim=sim,
            bounds=config.bounds,
            cvnn=config.cvnn,
            global_step=config.global_step,
            sobol_skip=config.sobol_skip,
            normalize_inputs=config.normalize_inputs,
            lsmc_backward_version=backward_version,
            cuda_stream_version=stream_version,
        )
        return Success(cls(recorded_config, model, opt, sampler_res.value, device, mesh_spec))

    # -- accessors -----------------------------------------------------------

    @property
    def model(self) -> CVNN:
        return self._model

    @property
    def global_step(self) -> int:
        return self._global_step

    def set_step_callback(self, cb: Callable[[StepMetrics], None] | None) -> None:
        """Register a per-batch metrics hook (one Python call per batch; at
        high step rates prefer ``set_segment_callback``)."""
        self._step_callback = cb

    def set_segment_callback(self, cb: Callable[[SegmentMetrics], None] | None) -> None:
        """Register a per-segment bulk metrics hook (one call per segment)."""
        self._segment_callback = cb

    def _emit_metrics(
        self,
        base_step: int,
        seg_losses: np.ndarray,
        seg_gnorms: np.ndarray,
        lr: float,
        lr_schedule: LRScheduleConfig | None = None,
    ) -> None:
        # under a schedule, report the rates the optimizer applied (its count
        # equals the global step)
        if lr_schedule is not None:
            rates = schedule_rates(lr_schedule, base_step, len(seg_losses))
        else:
            rates = np.full(len(seg_losses), lr)
        if self._segment_callback is not None:
            self._segment_callback(
                SegmentMetrics(
                    start_step=base_step + 1,
                    losses=seg_losses,
                    grad_norms=seg_gnorms,
                    learning_rate=float(rates[-1]),
                )
            )
        if self._step_callback is not None:
            for i in range(len(seg_losses)):
                self._step_callback(
                    StepMetrics(
                        step=base_step + i + 1,
                        loss=float(seg_losses[i]),
                        grad_norm=float(seg_gnorms[i]),
                        learning_rate=float(rates[i]),
                    )
                )

    def _sobol_table(self) -> SobolTable:
        t = self._sampler.device_table(self._device)
        return SobolTable(
            directions=t["directions"], shift=t["shift"], lower=t["lower"], upper=t["upper"]
        )

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> GbmCVNNPricerConfig:
        return GbmCVNNPricerConfig(
            sim=self._sim,
            bounds=dict(self._bounds),
            cvnn=self._cvnn_cfg,
            global_step=self._global_step,
            sobol_skip=self._sobol_skip,
            normalize_inputs=self._normalize_inputs,
            model_state=get_state_dict(self._model),
            optimizer_state=(
                self._adam.snapshot() if self._adam is not None else self._opt_snapshot
            ),
            lsmc_backward_version=self._lsmc_backward_version,
            cuda_stream_version=self._cuda_stream_version,
            provenance=Provenance(torch_env=self._torch_env),
        )

    # -- train ---------------------------------------------------------------

    def _step_state(self) -> StepState:
        """Adam and the counters a batch advances; the live Adam moments are
        made from the checkpoint's on first use and kept on the device."""
        if self._adam is None:
            params = model_params(self._model)
            self._adam = (
                AdamState.zeros_like(params)
                if self._opt_snapshot is None
                else AdamState.restore(params, self._opt_snapshot)
            )
        return StepState(adam=self._adam, sobol_skip=self._sobol_skip, mc_skip=self._sim.skip)

    def _fused_batch(
        self,
        batch_size: int,
        learning_rate: float,
        contract_chunk: int | None,
        lr_schedule: LRScheduleConfig | None,
    ) -> BatchFn:
        """One batch on one device, or this rank's sharded batch on a mesh
        (its loss is the all-reduced one, so every rank takes the same
        divergence decision)."""
        return make_fused_batch(
            self._model,
            self._sim,
            self._table,
            batch_size=batch_size,
            learning_rate=learning_rate,
            contract_chunk=contract_chunk,
            normalize_inputs=self._normalize_inputs,
            lr_schedule=lr_schedule,
            spec=self._mesh_spec,
        )

    def _shard_mismatch(self, config: TrainingConfig) -> TrainerError | None:
        """The batch must split over the mesh: the batch over its batch
        axis, the rows over its paths axis, and a partial ``contract_chunk``
        must divide the PER-SHARD batch (``build_training_config`` cannot
        see the mesh)."""
        error = shard_shape_error(self._mesh_spec, batch_size=config.batch_size,
                                  rows=self._sim.batches_per_mc_run,
                                  contract_chunk=config.contract_chunk)
        if error is None:
            return None
        field, value, reason = error
        return InvalidTrainingConfig(field=field, value=value, reason=f"{reason} on this mesh")

    def _segment(
        self,
        state: StepState,
        one_batch: BatchFn,
        length: int,
        base_step: int,
        learning_rate: float,
        lr_schedule: LRScheduleConfig | None,
    ) -> Result[tuple[np.ndarray, np.ndarray], TrainerError]:
        """``length`` batches, then the segment's one device→host copy of its
        losses and gradient norms. A non-finite last loss undoes the segment
        (``SegmentStart``) and fails with the JAX package's step; otherwise
        the metrics go out and the pricer absorbs the new counters."""
        with span("train_segment"):
            with span("spectralmc.train.segment_start"):
                start = SegmentStart.take(self._model, state.adam)
            counters = (state.sobol_skip, state.mc_skip)
            losses, gnorms = [], []
            for _ in range(length):
                loss, gnorm = one_batch(state)
                losses.append(loss)
                gnorms.append(gnorm)
            with span("spectralmc.train.fetch"):
                packed = torch.stack([torch.stack(losses), torch.stack(gnorms)]).cpu().numpy()
            seg_losses, seg_gnorms = packed[0], packed[1]
            if not np.isfinite(seg_losses[-1]):
                start.restore(self._model, state.adam)
                state.sobol_skip, state.mc_skip = counters
                return Failure(
                    NonFiniteLoss(
                        step=base_step + length, loss=float(seg_losses[-1]),
                        reason="training diverged",
                    )
                )
            self._emit_metrics(base_step, seg_losses, seg_gnorms, learning_rate, lr_schedule)
            self._absorb(state, base_step + length)
            return Success((seg_losses, seg_gnorms))

    def train(
        self,
        config: TrainingConfig,
        *,
        commit_plan: CommitPlan | None = None,
        commit_fn: CommitFn | None = None,
        profile_dir: str | None = None,
    ) -> Result[TrainingResult, TrainerError]:
        """Run ``config.num_batches`` fused batches in segments cut at the
        plan's commit boundaries, committing at each full interval and at the
        end as the plan says (a final commit on an interval boundary is made
        once). ``profile_dir`` records the call with torch.profiler
        (``utils/profiling.py::profile_trace``), with the program's spans: one
        ``train_segment`` a segment, and the step's beneath it."""
        plan = commit_plan if commit_plan is not None else NoCommit()
        error = _plan_error(plan, commit_fn) or self._shard_mismatch(config)
        if error is not None:
            return Failure(error)
        interval = _commit_interval(plan)
        state = self._step_state()
        one_batch = self._fused_batch(
            config.batch_size, config.learning_rate, config.contract_chunk, config.lr_schedule
        )
        start_step = self._global_step
        losses: list[np.ndarray] = []
        gnorms: list[np.ndarray] = []
        batches_done = 0
        with (profile_trace(profile_dir, device=self._device) if profile_dir
              else contextlib.nullcontext()):
            for seg_len in segment_lengths(config.num_batches, interval):
                outcome = self._segment(
                    state,
                    one_batch,
                    seg_len,
                    start_step + batches_done,
                    config.learning_rate,
                    config.lr_schedule,
                )
                batches_done += seg_len
                if isinstance(outcome, Failure):
                    return outcome
                seg_losses, seg_gnorms = outcome.value
                losses.append(seg_losses)
                gnorms.append(seg_gnorms)
                at_boundary = interval is not None and seg_len == interval
                if at_boundary and (
                    batches_done < config.num_batches or not _commits_final(plan)
                ):
                    self._commit(plan, commit_fn, float(seg_losses[-1]), batches_done)
        all_losses = np.concatenate(losses)
        all_gnorms = np.concatenate(gnorms)
        if _commits_final(plan):
            self._commit(plan, commit_fn, float(all_losses[-1]), batches_done)
        return Success(self._result(config, all_losses, all_gnorms))

    def _result(
        self, config: TrainingConfig, losses: np.ndarray, gnorms: np.ndarray
    ) -> TrainingResult:
        return TrainingResult(
            updated_config=self.snapshot(),
            final_loss=float(losses[-1]),
            total_batches=int(config.num_batches),
            final_grad_norm=float(gnorms[-1]),
            losses=losses,
            grad_norms=gnorms,
        )

    def train_via_effects(
        self,
        config: TrainingConfig,
        *,
        commit_plan: CommitPlan | None = None,
        commit_fn: CommitFn | None = None,
    ) -> Result[TrainingResult, TrainerError]:
        """Effect-interpreted training: description → interpreter → result.

        The run is data from ``build_training_run_effects``, executed by
        ``SpectralMCInterpreter`` on the pricer's device: ``TrainSegment``
        resolves to ``train``'s segment on the pricer's engine, and
        ``CommitVersion`` to the commit hook. Losses, counters and commit
        boundaries equal ``train()``'s bit for bit. Called from inside a
        running event loop, the interpreter runs on a side thread (which
        uses the pricer's device explicitly), and ``make_commit_fn``'s
        commits reach the store from there too.
        """
        plan = commit_plan if commit_plan is not None else NoCommit()
        error = _plan_error(plan, commit_fn) or self._shard_mismatch(config)
        if error is not None:
            return Failure(error)
        sequence = build_training_run_effects(
            num_batches=config.num_batches,
            batch_size=config.batch_size,
            learning_rate=config.learning_rate,
            commit_interval=_commit_interval(plan),
            final_commit=_commits_final(plan),
        )
        state = self._step_state()
        start_step = self._global_step
        batches: dict[tuple[int, float], BatchFn] = {}
        losses: list[np.ndarray] = []
        gnorms: list[np.ndarray] = []
        failure: list[TrainerError] = []

        def run_train_segment(effect: TrainSegment) -> int:
            key = (effect.batch_size, effect.learning_rate)
            if key not in batches:
                batches[key] = self._fused_batch(
                    effect.batch_size, effect.learning_rate, config.contract_chunk,
                    config.lr_schedule,
                )
            done = sum(len(x) for x in losses)
            outcome = self._segment(state, batches[key], effect.length, start_step + done,
                                    effect.learning_rate, config.lr_schedule)
            if isinstance(outcome, Failure):
                failure.append(outcome.error)
                raise FloatingPointError("non-finite loss")  # surfaces as TrainingError
            losses.append(outcome.value[0])
            gnorms.append(outcome.value[1])
            return done + effect.length

        pricer = self

        class _CommitFnInterpreter(SpectralMCInterpreter):
            """CommitVersion → the commit hook; everything else → stock routing."""

            async def interpret(self, effect: object) -> Result[object, object]:
                if isinstance(effect, CommitVersion):
                    last = losses[-1][-1] if losses else float("nan")
                    done = sum(len(x) for x in losses)
                    pricer._commit(plan, commit_fn, float(last), done)
                    return Success(effect.message)
                return await super().interpret(effect)

        interpreter = _CommitFnInterpreter(device=self._device)
        interpreter.registry.put_function("train_segment", run_train_segment)
        interpreter.registry.update_metadata("sobol_skip", "set", self._sobol_skip)
        interpreter.registry.update_metadata("mc_skip", "set", self._sim.skip)

        def drive() -> Result[object, object]:
            with self._on_device():
                return asyncio.run(interpreter.interpret_sequence(sequence))

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            outcome = drive()
        else:
            # inside an event loop asyncio.run would raise: drive the
            # interpreter on a side thread
            with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
                outcome = pool.submit(drive).result()
        if isinstance(outcome, Failure):
            if failure:
                return Failure(failure[0])
            return Failure(CheckpointMismatch(field="effects", reason=repr(outcome.error)))
        return Success(self._result(config, np.concatenate(losses), np.concatenate(gnorms)))

    def _on_device(self) -> contextlib.AbstractContextManager[object]:
        """Make the pricer's card current (a side thread starts on card 0)."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _absorb(self, state: StepState, global_step: int) -> None:
        """Take a finished segment's counters into the pricer (the weights and
        Adam moments are the live ones already)."""
        self._sobol_skip = state.sobol_skip
        self._sim = self._sim.model_copy(update={"skip": state.mc_skip})
        self._sampler = self._sampler.with_skip(self._sobol_skip)
        self._global_step = global_step

    def _commit(
        self, plan: CommitPlan, commit_fn: CommitFn | None, loss: float, batch: int
    ) -> None:
        if commit_fn is None:
            return
        message = _plan_template(plan).format(step=self._global_step, loss=loss, batch=batch)
        try:
            commit_fn(self.snapshot(), message)
        except Exception:  # noqa: BLE001 — commits never kill training
            _LOG.exception("checkpoint commit failed")

    # -- inference -----------------------------------------------------------

    def _has_parity(self) -> bool:
        """Whether the payoff's E[underlier] has a closed form (the basket's
        combine decides for baskets): the call-via-parity gate."""
        basket = self._sim.basket
        return has_closed_form_mean(self._sim.model, self._sim.payoff,
                                    combine=basket.combine if basket is not None else None)

    @torch.no_grad()
    def _predict_packed(self, arr: torch.Tensor) -> torch.Tensor:
        """CVNN forward → IFFT → ``[put(m) | E[u](m) | residue]`` on device;
        ``E[u]`` is NaN where the payoff has no closed-form mean."""
        dtype = self._sim.precision.to_torch()
        normalize_fn = make_input_normalizer(
            self._table, enabled=self._normalize_inputs, dtype=dtype
        )
        inputs = normalize_fn(arr)
        self._model.eval()
        out_re, out_im = self._model(inputs, torch.zeros_like(inputs))
        recovered = torch.fft.ifft(torch.complex(out_re, out_im), dim=1)
        put = torch.mean(recovered.real, dim=1)
        residue = torch.max(torch.abs(torch.mean(recovered.imag, dim=1)))
        if self._has_parity():
            expected = make_mean_target(self._sim)(arr).to(put.dtype)
        else:
            expected = torch.full_like(put, float("nan"))
        return torch.cat([put, expected, residue.reshape(1)])

    def _greeks_packed(self, arr: torch.Tensor) -> torch.Tensor:
        """``[put | E[u] | put_gamma | call_gamma | put_jac | call_jac]`` on
        device for the ``[m, D]`` batch ``arr``.

        The put is ``_predict_packed``'s IFFT∘CVNN map, the call adds the
        parity term ``df·(E[u] − K)`` through the payoff's analytic mean, so
        its Jacobian and gamma are the put's plus the parity term's. In eval
        mode every row is its own function of its own contract, so the
        Jacobian rows are the gradient of the row sum and gamma the
        spot-derivative of the delta column's sum (a double backward).
        """
        dtype = self._sim.precision.to_torch()
        normalize_fn = make_input_normalizer(
            self._table, enabled=self._normalize_inputs, dtype=dtype
        )
        self._model.eval()

        def put_of(x: torch.Tensor) -> torch.Tensor:
            inputs = normalize_fn(x)
            out_re, out_im = self._model(inputs, torch.zeros_like(inputs))
            recovered = torch.fft.ifft(torch.complex(out_re, out_im), dim=1)
            return torch.mean(recovered.real, dim=1)

        def price_jac_gamma(
            fn: Callable[[torch.Tensor], torch.Tensor],
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
            x = arr.detach().clone().requires_grad_(True)
            prices = fn(x)
            (jac,) = torch.autograd.grad(prices.sum(), x, create_graph=True)
            (spot_row,) = torch.autograd.grad(jac[:, 0].sum(), x)
            return prices.detach(), jac.detach(), spot_row[:, 0]

        put, put_jac, put_gamma = price_jac_gamma(put_of)
        if self._has_parity():
            mean_target = make_mean_target(self._sim)
            term = self._sim.term
            rate_factor = 1.0 if term is None else term.effective_factors(self._sim.timesteps)[1]

            def parity_of(x: torch.Tensor) -> torch.Tensor:
                df = torch.exp(-x[:, 3] * rate_factor * x[:, 2])  # rate, maturity
                return df * (mean_target(x).to(dtype) - x[:, 1])

            # the call is put + parity: its derivatives add the parity term's to
            # the put's, with no second pass through the network
            _, parity_jac, parity_gamma = price_jac_gamma(parity_of)
            call_jac, call_gamma = put_jac + parity_jac, put_gamma + parity_gamma
            with torch.no_grad():
                expected = mean_target(arr).to(put.dtype)
        else:
            expected = torch.full_like(put, float("nan"))
            call_jac = torch.full_like(put_jac, float("nan"))
            call_gamma = torch.full_like(put, float("nan"))
        return torch.cat([put, expected, put_gamma, call_gamma,
                          put_jac.reshape(-1), call_jac.reshape(-1)])

    def predict_greeks(
        self,
        contracts: "Sequence[object] | np.ndarray",
        *,
        pad_to_bucket: bool = False,
    ) -> GreeksPrediction:
        """Greeks of the learned pricer for a batch of contracts: prices (the
        same values as ``predict_price``'s, calls by the same host parity),
        ``[N, D]`` Jacobians and spot-gammas of the put and the call.

        Where no closed-form E[underlier] exists the call outputs are NaN,
        with the same warning; an American kind serves its own side (for
        AMERICAN_CALL the channels are swapped). One host→device copy of the
        contracts and one device→host copy of the packed result. The batch
        is padded to the next power of two as ``predict_price`` pads it, so
        ``pad_to_bucket`` changes nothing.
        """
        del pad_to_bucket
        np_dtype = self._sim.precision.to_np()
        cls = contract_class(self._sim)
        host = _contracts_to_host(contracts, cls, np_dtype)
        arr, n = _pad_to_bucket(torch.from_numpy(host).to(self._device))
        m, d = int(arr.shape[0]), int(arr.shape[1])
        parity = self._has_parity()
        if not parity and self._sim.payoff not in AMERICAN_PAYOFFS:
            _LOG.warning(
                "no closed-form E[underlier] for %s/%s: call greeks unavailable",
                self._sim.model.value,
                self._sim.payoff.value,
            )
        packed = self._greeks_packed(arr).cpu().numpy()  # the one device->host copy
        put, expected = packed[:m][:n], packed[m:2 * m][:n]
        put_gamma, call_gamma = packed[2 * m:3 * m][:n], packed[3 * m:4 * m][:n]
        jac = packed[4 * m:]
        put_jac = jac[:m * d].reshape(m, d)[:n]
        call_jac = jac[m * d:].reshape(m, d)[:n]
        if parity:
            # the call price by predict_price's host parity, so the two agree bit for bit
            strike, maturity, rate = host[:, 1], host[:, 2], host[:, 3]
            term = self._sim.term
            mean_rate = 1.0 if term is None else term.effective_factors(self._sim.timesteps)[1]
            call = put + np.exp(-rate * mean_rate * maturity) * (expected - strike)
        else:
            call = np.full_like(put, np.nan)
        if self._sim.payoff == PayoffKind.AMERICAN_CALL:
            # the learned channel carries the CALL side
            put, call = call, put
            put_jac, call_jac = call_jac, put_jac
            put_gamma, call_gamma = call_gamma, put_gamma
        return GreeksPrediction(
            put=put, call=call, put_jacobian=put_jac, call_jacobian=call_jac,
            put_gamma=put_gamma, call_gamma=call_gamma, fields=tuple(cls.model_fields.keys()),
        )

    def predict_price(
        self,
        contracts: "Sequence[object] | np.ndarray",
        *,
        pad_to_bucket: bool = False,
    ) -> PricePrediction:
        """Learned put prices, and calls by put-call parity on the payoff's
        own underlier (``call − put = df·(E[u] − K)``), for a batch. Where
        ``has_closed_form_mean`` is false (barrier, lookback; under Heston
        also the geometric Asian, digital, variance swap and cliquet; for an
        arithmetic basket everything but TERMINAL and the arithmetic Asian)
        the call has no parity route and is NaN, with a warning.

        One host→device copy of the ``[N, D]`` contract matrix and one
        device→host copy of the packed result per call. The forward always
        runs on the batch padded to the next power of two (repeating the last
        row) and slices back: on the card, cuBLAS and the row-mean reduction
        pick their kernels by the row count, so a row's last bits would
        otherwise depend on the size of the batch it is served in.
        ``pad_to_bucket`` (the JAX package's argument, which pads there) is
        accepted and changes nothing.
        """
        del pad_to_bucket
        with span("spectralmc.serve"):
            with span("spectralmc.serve.prepare"):
                np_dtype = self._sim.precision.to_np()
                host = _contracts_to_host(contracts, contract_class(self._sim), np_dtype)
                arr, n = _pad_to_bucket(torch.from_numpy(host).to(self._device))
            with span("spectralmc.serve.forward"):
                out = self._predict_packed(arr)
            with span("spectralmc.serve.fetch"):
                packed = out.cpu().numpy()  # the one device->host copy
            with span("spectralmc.serve.parity"):
                return self._prices(packed, int(arr.shape[0]), n, host)

    def _prices(self, packed: np.ndarray, m: int, n: int, host: np.ndarray) -> PricePrediction:
        """The first ``n`` of ``m`` served rows' prices from the packed copy
        (puts, expected underliers, the residue) and the host contracts."""
        put = packed[:m][:n]
        expected = packed[m:2 * m][:n]
        residue = float(packed[2 * m])
        if residue > IFFT_RESIDUE_WARN:
            _LOG.warning("IFFT imaginary residue %.3g exceeds %.1g", residue, IFFT_RESIDUE_WARN)
        # an American kind trains ONE side's Bermudan cashflow through the
        # put-payoff channel: the learned value IS that side's price, and the
        # other side is NaN (early exercise breaks parity)
        nan = np.full_like(put, np.nan)
        if self._sim.payoff == PayoffKind.AMERICAN_CALL:
            return PricePrediction(put=nan, call=put, imag_residue=residue)
        if self._sim.payoff == PayoffKind.AMERICAN_PUT:
            return PricePrediction(put=put, call=nan, imag_residue=residue)
        if not self._has_parity():
            _LOG.warning(
                "no closed-form E[underlier] for %s/%s: call-via-parity unavailable",
                self._sim.model.value,
                self._sim.payoff.value,
            )
            return PricePrediction(put=put, call=nan, imag_residue=residue)
        # put-call parity on the host copy: call − put = df·(E[u] − K), with
        # a term structure discounting at the curve-effective rate r·mean(rs)
        strike, maturity, rate = host[:, 1], host[:, 2], host[:, 3]
        term = self._sim.term
        mean_rate = 1.0 if term is None else term.effective_factors(self._sim.timesteps)[1]
        df = np.exp(-rate * mean_rate * maturity)
        return PricePrediction(put=put, call=put + df * (expected - strike), imag_residue=residue)
