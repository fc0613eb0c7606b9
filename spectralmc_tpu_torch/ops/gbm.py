"""GBM Monte-Carlo engine, main-path subset, on torch tensors.

The port of the JAX package's ``ops/gbm.py`` for what the online pricer's
main path runs: European (TERMINAL) payoffs on GBM dynamics with
pseudo-random paths, log-Euler or reflection-Euler, optional antithetic
mirroring, and MEAN forward normalization.

Two engines, recorded in ``SimulationParams.implementation`` because they
draw different bit streams:

* ``"xla"`` — the JAX package's canonical threefry stream: row ``r``'s
  normals at step ``t`` are ``normal(fold_in(fold_in(key, r), t), (cols,))``
  (``ops/rng.py`` reproduces the words of ``jax.random``). Plain tensor code.
* ``"cuda"`` — the hand-written Hopper kernel with its own Philox-4x32-10
  stream (``ops/gbm_cuda.py``, ``csrc/gbm_terminal.cu``).

``"pallas"`` (the TPU hardware-PRNG stream) is a value the port parses but
cannot run; the trainer refuses it.

Every simulator takes a BATCH of contracts — ``[C, 6]`` contracts with
``[C, 2]`` key words give ``[C, rows, cols]`` — so the trainer launches one
kernel per contract chunk, not one per contract.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors import not_ported
from spectralmc_tpu_torch.core.errors.gbm import (
    GBMError,
    InvalidSimulationParams,
    MemoryLimitExceeded,
)
from spectralmc_tpu_torch.core.precision import Precision
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops import rng

# Same config-time guardrails as the JAX package.
MAX_TOTAL_PATHS_F32 = 1_000_000_000
MAX_TOTAL_PATHS_F64 = 500_000_000

# ROADMAP.md queue items that port what this module refuses
PAYOFF_QUEUE = "queue 1 item 15 (GBM payoff matrix and term structures)"
DYNAMICS_QUEUE = "queue 1 item 16 (dynamics)"
QMC_QUEUE = "queue 1 item 17 (QMC)"


class PathScheme(enum.Enum):
    LOG_EULER = "log_euler"
    EULER = "euler"  # simple Euler with reflection |X|


class ForwardNormalization(enum.Enum):
    NONE = "none"
    MEAN = "mean"  # rescale so the path mean matches the analytic forward


class PayoffKind(enum.Enum):
    """All payoff kinds of the JAX package, so its configs parse; the port
    simulates TERMINAL and refuses the rest (``PAYOFF_QUEUE``)."""

    TERMINAL = "terminal"
    ASIAN_ARITHMETIC = "asian_arithmetic"
    ASIAN_GEOMETRIC = "asian_geometric"
    BARRIER_UP_OUT = "barrier_up_out"
    BARRIER_DOWN_OUT = "barrier_down_out"
    DIGITAL = "digital"
    LOOKBACK_FIXED_CALL = "lookback_fixed_call"
    LOOKBACK_FIXED_PUT = "lookback_fixed_put"
    LOOKBACK_FLOAT_CALL = "lookback_float_call"
    LOOKBACK_FLOAT_PUT = "lookback_float_put"
    AMERICAN_PUT = "american_put"
    AMERICAN_CALL = "american_call"
    VARIANCE_SWAP = "variance_swap"
    FORWARD_START = "forward_start"
    CLIQUET = "cliquet"


class ModelKind(enum.Enum):
    GBM = "gbm"
    HESTON = "heston"
    BASKET_GBM = "basket_gbm"
    MERTON_JUMP = "merton_jump"


class SimImplementation(enum.Enum):
    XLA = "xla"  # threefry stream, plain tensor code (the JAX canonical stream)
    CUDA = "cuda"  # Philox stream, hand-written Hopper kernel (ops/gbm_cuda.py)
    PALLAS = "pallas"  # TPU hardware-PRNG stream; parsed, never run by the port


class SamplingKind(enum.Enum):
    PSEUDO = "pseudo"
    SOBOL_BB = "sobol_bb"


class BlackScholesContract(BaseModel):
    """One European-option market scenario."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    spot: float
    strike: float
    maturity: float
    rate: float
    div_yield: float
    vol: float


CONTRACT_DIM = len(BlackScholesContract.model_fields)


class SimulationParams(BaseModel):
    """Workload shape + determinism state, field for field the JAX package's.

    ``total_paths = network_size * batches_per_mc_run``; the FFT length is
    ``network_size``; ``skip`` counts contract-simulations already drawn (the
    resume offset). The fields of features outside the slice (``basket``,
    ``term``, the LSMC, cliquet and barrier knobs) are kept so a JAX config
    maps 1:1; ``build_simulation_params`` refuses them.
    """

    model_config = ConfigDict(frozen=True, extra="forbid")

    timesteps: int
    network_size: int
    batches_per_mc_run: int
    mc_seed: int
    skip: int = 0
    precision: Precision = Precision.float32
    scheme: PathScheme = PathScheme.LOG_EULER
    normalization: ForwardNormalization = ForwardNormalization.MEAN
    implementation: SimImplementation = SimImplementation.XLA
    payoff: PayoffKind = PayoffKind.TERMINAL
    model: ModelKind = ModelKind.GBM
    basket: Any = None
    barrier_rel: float | None = None
    antithetic: bool = False
    lsmc_basis_degree: int = 5
    lsmc_exercise_every: int = 1
    lsmc_cross_fit: bool = False
    lsmc_fused_backward: bool = False
    forward_start_step: int | None = None
    cliquet_reset_every: int | None = None
    cliquet_floor: float | None = None
    cliquet_cap: float | None = None
    sampling: SamplingKind = SamplingKind.PSEUDO
    term: Any = None

    @property
    def total_paths(self) -> int:
        return self.network_size * self.batches_per_mc_run


def require_slice(params: SimulationParams) -> None:
    """Raise for a config outside the ported slice (GBM, TERMINAL, PSEUDO, flat)."""
    if params.model != ModelKind.GBM or params.basket is not None:
        raise not_ported(f"model={params.model.value!r}", DYNAMICS_QUEUE)
    if params.payoff != PayoffKind.TERMINAL:
        raise not_ported(f"payoff={params.payoff.value!r}", PAYOFF_QUEUE)
    if params.sampling != SamplingKind.PSEUDO:
        raise not_ported(f"sampling={params.sampling.value!r}", QMC_QUEUE)
    if params.term is not None:
        raise not_ported("a TermStructure", PAYOFF_QUEUE)


def build_simulation_params(**kwargs: Any) -> Result[SimulationParams, GBMError]:
    """Validated constructor; raises ``NotImplementedError`` outside the slice."""
    try:
        params = SimulationParams(**kwargs)
    except Exception as exc:  # pydantic ValidationError
        return Failure(InvalidSimulationParams(field="<model>", value=kwargs, reason=str(exc)))
    require_slice(params)
    for field in ("timesteps", "network_size", "batches_per_mc_run"):
        if getattr(params, field) <= 0:
            return Failure(
                InvalidSimulationParams(
                    field=field, value=getattr(params, field), reason="must be positive"
                )
            )
    if params.mc_seed < 0:
        return Failure(
            InvalidSimulationParams(field="mc_seed", value=params.mc_seed, reason="must be >= 0")
        )
    if params.skip < 0:
        return Failure(
            InvalidSimulationParams(field="skip", value=params.skip, reason="must be >= 0")
        )
    if params.precision.is_complex():
        return Failure(
            InvalidSimulationParams(
                field="precision", value=params.precision.value, reason="MC dtype must be real"
            )
        )
    limit = MAX_TOTAL_PATHS_F64 if params.precision == Precision.float64 else MAX_TOTAL_PATHS_F32
    if params.total_paths > limit:
        return Failure(
            MemoryLimitExceeded(
                total_paths=params.total_paths,
                limit=limit,
                dtype=params.precision.value,
                reason="config-time path guardrail",
            )
        )
    stray = {
        "barrier_rel": params.barrier_rel,
        "forward_start_step": params.forward_start_step,
        "cliquet_reset_every": params.cliquet_reset_every,
        "cliquet_floor": params.cliquet_floor,
        "cliquet_cap": params.cliquet_cap,
    }
    for field, value in stray.items():
        if value is not None:
            return Failure(
                InvalidSimulationParams(
                    field=field, value=value, reason="payoff='terminal' takes no such knob"
                )
            )
    if params.lsmc_cross_fit or params.lsmc_fused_backward:
        return Failure(
            InvalidSimulationParams(
                field="lsmc_cross_fit" if params.lsmc_cross_fit else "lsmc_fused_backward",
                value=True,
                reason="payoff='terminal' has no LSMC regression",
            )
        )
    if params.antithetic and params.batches_per_mc_run % 2:
        return Failure(
            InvalidSimulationParams(
                field="antithetic",
                value=params.batches_per_mc_run,
                reason="antithetic pairing needs an even batches_per_mc_run",
            )
        )
    return Success(params)


def has_closed_form_mean(model: ModelKind, payoff: PayoffKind) -> bool:
    """Whether analytic E[underlier] exists (gates MEAN normalization and
    call-via-parity). GBM TERMINAL has the forward; the rest is not ported."""
    if model != ModelKind.GBM:
        raise not_ported(f"model={model.value!r}", DYNAMICS_QUEUE)
    if payoff != PayoffKind.TERMINAL:
        raise not_ported(f"payoff={payoff.value!r}", PAYOFF_QUEUE)
    return True


def resolve_implementation(params: SimulationParams) -> SimImplementation:
    """The engine that will ACTUALLY execute for these params.

    ``"cuda"`` runs wherever ``gbm_cuda.cuda_supported`` says the kernel
    honors the request (the single source of truth), else the threefry
    engine; the kernel takes any row count. ``"pallas"`` resolves to itself:
    only the trainer's refusal stands between it and a run.
    """
    if params.implementation != SimImplementation.CUDA:
        return params.implementation
    from spectralmc_tpu_torch.ops.gbm_cuda import cuda_supported

    if cuda_supported(
        dtype=params.precision.to_torch(),
        model=params.model,
        payoff=params.payoff,
        sampling=params.sampling,
        term=params.term,
    ):
        return SimImplementation.CUDA
    return SimImplementation.XLA


# --------------------------------------------------------------------------
# The threefry ("xla") engine
# --------------------------------------------------------------------------


def row_keys(
    contract_keys: torch.Tensor,
    *,
    rows: int,
    row_offset: int,
    antithetic_half: int | None,
    dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-row stream keys ``[C, rows, 2]`` + optional sign column ``[rows, 1]``.

    With ``antithetic_half=H``, global row r >= H reuses row (r−H)'s key with
    sign −1 — a pure function of the GLOBAL row, so a shard owning rows
    ``[k, k + rows)`` reproduces exactly those rows.
    """
    row_idx = row_offset + torch.arange(rows, dtype=torch.int64, device=contract_keys.device)
    sign = None
    if antithetic_half is not None:
        upper = row_idx >= antithetic_half
        sign = torch.where(upper, -1.0, 1.0).to(dtype)[:, None]
        row_idx = torch.where(upper, row_idx - antithetic_half, row_idx)
    keys = rng.fold_in(contract_keys[:, None, :], row_idx[None, :])
    return keys, sign


def simulate_terminal_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    scheme: PathScheme,
    row_offset: int = 0,
    antithetic_half: int | None = None,
) -> torch.Tensor:
    """Terminal GBM values ``[C, rows, cols]`` on the threefry stream.

    ``contracts`` is ``[C, 6]`` = [spot, strike, maturity, rate, div_yield,
    vol] and ``contract_keys`` ``[C, 2]`` threefry words. Row ``r``'s normals
    at step ``t`` are ``normal(fold_in(fold_in(key, row_offset + r), t),
    (cols,))``, as in the JAX package, so the two agree to the normals'
    ulps. Only the ``[C, rows, cols]`` state is live; each step's normals
    are drawn and consumed inside the loop.
    """
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / timesteps
    sqrt_dt = torch.sqrt(dt)
    keys, sign = row_keys(
        contract_keys, rows=rows, row_offset=row_offset, antithetic_half=antithetic_half,
        dtype=dtype,
    )

    def normals(t: int) -> torch.Tensor:
        z = rng.normal(rng.fold_in(keys, t), (cols,)).to(dtype)
        return z if sign is None else sign * z

    vol_step = vol * sqrt_dt
    if scheme == PathScheme.LOG_EULER:
        log_drift = (rate - div_yield - 0.5 * vol * vol) * dt
        logx = torch.zeros((c.shape[0], rows, cols), dtype=dtype, device=c.device) + torch.log(spot)
        for t in range(timesteps):
            logx = logx + log_drift + vol_step * normals(t)
        return torch.exp(logx)
    lin_drift = (rate - div_yield) * dt
    x = torch.ones((c.shape[0], rows, cols), dtype=dtype, device=c.device) * spot
    for t in range(timesteps):
        x = torch.abs(x * (1.0 + lin_drift + vol_step * normals(t)))  # reflection
    return x


# --------------------------------------------------------------------------
# Payoffs
# --------------------------------------------------------------------------


def expected_underlier_mean(
    contracts: torch.Tensor, *, timesteps: int, payoff: PayoffKind, dtype: torch.dtype
) -> torch.Tensor:
    """Analytic E[S_T] = spot·e^{(r−q)T} per contract ``[..., 6] -> [...]``.

    Exact for log-Euler; the continuous-limit value for reflection-Euler.
    """
    del timesteps
    if payoff != PayoffKind.TERMINAL:
        raise not_ported(f"E[underlier] for payoff={payoff.value!r}", PAYOFF_QUEUE)
    c = contracts.to(dtype)
    return c[..., 0] * torch.exp((c[..., 3] - c[..., 4]) * c[..., 2])


@dataclass(frozen=True)
class SimPrices:
    """Discounted payoff vectors + scalars, per contract."""

    put_payoffs: torch.Tensor  # [C, total_paths] discounted
    call_payoffs: torch.Tensor  # [C, total_paths] discounted
    forward: torch.Tensor  # [C]
    discount_factor: torch.Tensor  # [C]


def normalized_terminal(
    terminal: torch.Tensor,
    contracts: torch.Tensor,
    *,
    normalize: bool,
    dtype: torch.dtype,
    mean_target: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(terminal', strike, forward, df)``, each batch-shaped ``[C, 1]``
    except ``terminal'`` ``[C, P]``: with ``normalize`` the sample mean of
    each contract's row is rescaled to ``mean_target`` (default: the
    forward)."""
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield = (c[:, i, None] for i in range(5))
    forward = spot * torch.exp((rate - div_yield) * maturity)
    df = torch.exp(-rate * maturity)
    if normalize:
        target = forward if mean_target is None else mean_target.reshape(-1, 1)
        terminal = terminal * (target / torch.mean(terminal, dim=1, keepdim=True))
    return terminal, strike, forward, df


def discounted_put(
    terminal: torch.Tensor,
    contracts: torch.Tensor,
    *,
    normalize: bool,
    dtype: torch.dtype,
    mean_target: torch.Tensor | None = None,
) -> torch.Tensor:
    """The put payoff vector ``[C, P]`` alone — what the training target
    needs, without materializing the call vector."""
    terminal, strike, _, df = normalized_terminal(
        terminal, contracts, normalize=normalize, dtype=dtype, mean_target=mean_target
    )
    return df * torch.clamp(strike - terminal, min=0.0)


def terminal_to_prices(
    terminal: torch.Tensor,
    contracts: torch.Tensor,
    *,
    normalize: bool,
    dtype: torch.dtype,
    mean_target: torch.Tensor | None = None,
) -> SimPrices:
    """Payoff vectors from underlier values ``[C, P]``, with optional MEAN
    normalization of each contract's row to ``mean_target``."""
    terminal, strike, forward, df = normalized_terminal(
        terminal, contracts, normalize=normalize, dtype=dtype, mean_target=mean_target
    )
    put = df * torch.clamp(strike - terminal, min=0.0)
    call = df * torch.clamp(terminal - strike, min=0.0)
    return SimPrices(
        put_payoffs=put,
        call_payoffs=call,
        forward=forward[:, 0],
        discount_factor=df[:, 0],
    )
