"""GbmCVNNPricer — the training orchestrator on PyTorch.

The port of the JAX package's ``training/trainer.py`` for the main path:
``TrainingConfig``, the ``NoCommit``/``FinalCommit`` plans, the checkpoint
root ``GbmCVNNPricerConfig`` (same fields, plus ``cuda_stream_version`` and
``provenance``), and ``GbmCVNNPricer.create/train/snapshot/predict_price``.

* ``create`` takes an explicit ``device``; nothing is picked by default.
* The MC engine that will run is resolved and recorded: a fresh config
  whose engine cannot run is downgraded, a mid-stream one fails with
  ``EngineMismatch``, and a ``"pallas"`` config (the TPU hardware-PRNG
  stream, which no GPU reproduces) is refused outright. So is the LSMC
  backward of an American kind: a checkpoint recorded on another backward,
  or on one of the JAX package's TPU backwards, fails with
  ``EngineMismatch``.
* A checkpoint carries weights, batch-norm statistics and Adam moments as
  numpy arrays under the JAX package's keys, so a JAX ``snapshot()`` resumes
  here and resume is bit-exact on one device.
* ``predict_price`` uploads the ``[N, D]`` contract matrix once and fetches
  one packed ``[put | E[u] | residue]`` vector once; calls follow by parity
  on the payoff's own underlier where ``has_closed_form_mean`` holds, and
  are NaN (with a warning) where it does not. An American kind serves its
  own side from the learned channel and NaN on the other.
* The dynamics (GBM, Heston, Merton, baskets) and the sampling (pseudo or
  ``SOBOL_BB``) change nothing in kind: the contract class and its width
  (6, 10, 9, 6 — the CVNN's input width follows), the simulator and the mean
  target come from ``ops/dispatch.py``, the basket's spec and the sampling
  ride in the checkpointed ``SimulationParams``, and the stream version is
  recorded per (model, payoff, curved term).
"""

from __future__ import annotations

import logging
import operator
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence, Union

import numpy as np
import torch

from spectralmc_tpu_torch.core.errors import not_ported
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
from spectralmc_tpu_torch.models.factory import (
    CVNN,
    CVNNConfig,
    build_model,
    get_state_dict,
    load_state_dict,
)
from spectralmc_tpu_torch.ops.american_cuda import LSMC_BACKWARD_VERSIONS, resolve_lsmc_backward
from spectralmc_tpu_torch.ops.gbm import (
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
from spectralmc_tpu_torch.training.adam_state import (
    AdamState,
    AdamStateSnapshot,
    coerce_optimizer_state,
)
from spectralmc_tpu_torch.training.step import (
    LRScheduleConfig,
    SobolTable,
    StepState,
    contract_class,
    contract_dim,
    make_fused_batch,
    make_input_normalizer,
    make_mean_target,
    model_params,
)

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
# Commit plans (the interval plans are not ported yet)
# --------------------------------------------------------------------------

DEFAULT_COMMIT_MESSAGE = "step={step} loss={loss:.6g} batch={batch}"


@dataclass(frozen=True, slots=True)
class NoCommit:
    pass


@dataclass(frozen=True, slots=True)
class FinalCommit:
    message_template: str = DEFAULT_COMMIT_MESSAGE


CommitPlan = Union[NoCommit, FinalCommit]
CommitFn = Callable[["GbmCVNNPricerConfig", str], None]


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


# --------------------------------------------------------------------------
# The pricer
# --------------------------------------------------------------------------


class GbmCVNNPricer:
    """Online CVNN-on-MC-spectra trainer and server on one torch device."""

    def __init__(
        self,
        config: GbmCVNNPricerConfig,
        model: CVNN,
        opt_snapshot: AdamStateSnapshot | None,
        sampler: SobolSampler[object],
        device: torch.device,
    ) -> None:
        self._sim = config.sim
        self._bounds = dict(config.bounds)
        self._cvnn_cfg = config.cvnn
        self._model = model
        self._opt_snapshot = opt_snapshot
        self._sampler = sampler
        self._device = device
        self._global_step = config.global_step
        self._sobol_skip = config.sobol_skip
        self._normalize_inputs = config.normalize_inputs
        self._cuda_stream_version = config.cuda_stream_version
        self._lsmc_backward_version = config.lsmc_backward_version
        self._torch_env = torch_env_snapshot(device)
        self._table = self._sobol_table()

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        config: GbmCVNNPricerConfig,
        *,
        device: torch.device | str,
        mesh_spec: object | None = None,
    ) -> Result["GbmCVNNPricer", TrainerError]:
        device = torch.device(device)
        if mesh_spec is not None:
            raise not_ported("sharded training (mesh_spec)", "queue 1 item 19 (parallel)")
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
        backward_version = resolve_lsmc_backward(sim, rows=sim.batches_per_mc_run)
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
        return Success(cls(recorded_config, model, opt, sampler_res.value, device))

    # -- accessors -----------------------------------------------------------

    @property
    def model(self) -> CVNN:
        return self._model

    @property
    def global_step(self) -> int:
        return self._global_step

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
            optimizer_state=self._opt_snapshot,
            lsmc_backward_version=self._lsmc_backward_version,
            cuda_stream_version=self._cuda_stream_version,
            provenance=Provenance(torch_env=self._torch_env),
        )

    # -- train ---------------------------------------------------------------

    def train(
        self,
        config: TrainingConfig,
        *,
        commit_plan: CommitPlan | None = None,
        commit_fn: CommitFn | None = None,
    ) -> Result[TrainingResult, TrainerError]:
        """Run ``config.num_batches`` fused batches; losses are fetched once
        at the end. ``FinalCommit`` hands the final snapshot to ``commit_fn``."""
        plan = commit_plan if commit_plan is not None else NoCommit()
        if not isinstance(plan, (NoCommit, FinalCommit)):
            raise not_ported(f"commit plan {type(plan).__name__}", "queue 1 item 10 (trainer)")
        if isinstance(plan, FinalCommit) and commit_fn is None:
            return Failure(CommitPlanMismatch(reason="commit plan requires a commit_fn/store"))
        if isinstance(plan, NoCommit) and commit_fn is not None:
            return Failure(CommitPlanMismatch(reason="commit_fn provided but plan is NoCommit"))

        params = model_params(self._model)
        adam = (
            AdamState.zeros_like(params)
            if self._opt_snapshot is None
            else AdamState.restore(params, self._opt_snapshot)
        )
        state = StepState(adam=adam, sobol_skip=self._sobol_skip, mc_skip=self._sim.skip)
        one_batch = make_fused_batch(
            self._model,
            self._sim,
            self._table,
            batch_size=config.batch_size,
            learning_rate=config.learning_rate,
            contract_chunk=config.contract_chunk,
            normalize_inputs=self._normalize_inputs,
            lr_schedule=config.lr_schedule,
        )
        losses, gnorms = [], []
        for _ in range(config.num_batches):
            loss, gnorm = one_batch(state)
            losses.append(loss)
            gnorms.append(gnorm)
        packed = torch.stack([torch.stack(losses), torch.stack(gnorms)]).cpu().numpy()
        all_losses, all_gnorms = packed[0], packed[1]
        # the weights were updated in place, so the counters and Adam state
        # advance with them even when the loss diverged (the JAX trainer,
        # whose state is immutable, keeps its pre-segment state then)
        self._opt_snapshot = state.adam.snapshot()
        self._sobol_skip = state.sobol_skip
        self._sim = self._sim.model_copy(update={"skip": state.mc_skip})
        self._sampler = self._sampler.with_skip(self._sobol_skip)
        self._global_step += config.num_batches
        if not np.isfinite(all_losses[-1]):
            return Failure(
                NonFiniteLoss(
                    step=self._global_step, loss=float(all_losses[-1]), reason="training diverged"
                )
            )
        if isinstance(plan, FinalCommit):
            message = plan.message_template.format(
                step=self._global_step, loss=float(all_losses[-1]), batch=config.num_batches
            )
            try:
                commit_fn(self.snapshot(), message)
            except Exception:  # noqa: BLE001 — commits never kill training
                _LOG.exception("checkpoint commit failed")
        return Success(
            TrainingResult(
                updated_config=self.snapshot(),
                final_loss=float(all_losses[-1]),
                total_batches=int(config.num_batches),
                final_grad_norm=float(all_gnorms[-1]),
                losses=all_losses,
                grad_norms=all_gnorms,
            )
        )

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
        np_dtype = self._sim.precision.to_np()
        host = _contracts_to_host(contracts, contract_class(self._sim), np_dtype)
        arr, n = _pad_to_bucket(torch.from_numpy(host).to(self._device))
        m = int(arr.shape[0])
        packed = self._predict_packed(arr).cpu().numpy()  # the one device->host copy
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
