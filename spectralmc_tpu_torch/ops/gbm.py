"""GBM Monte-Carlo engine on torch tensors: the pseudo-random payoff matrix.

The port of the JAX package's ``ops/gbm.py``: the config model shared by
every dynamics (GBM here, Heston in ``ops/heston.py``, Merton in
``ops/merton.py``, baskets in ``ops/basket.py``), piecewise-constant
``TermStructure`` curves, and the GBM simulators for every payoff kind but
the American ones (TERMINAL, Asian, barrier, lookback, digital, variance
swap, forward start, cliquet), log-Euler or reflection-Euler, pseudo-random
or Sobol/Brownian-bridge paths (``ops/qmc.py``), optional antithetic
mirroring, and MEAN normalization where E[underlier] has a closed form.

Two engines, recorded in ``SimulationParams.implementation`` because they
draw different bit streams:

* ``"xla"`` — the JAX package's canonical threefry stream: row ``r``'s
  normals at step ``t`` are ``normal(fold_in(fold_in(key, r), t), (cols,))``
  (``ops/rng.py`` reproduces the words of ``jax.random``). Plain tensor code.
* ``"cuda"`` — the hand-written Hopper kernels with their own Philox-4x32-10
  stream (``ops/gbm_cuda.py`` and ``ops/dynamics_cuda.py``, ``csrc/``).

``"pallas"`` (the TPU hardware-PRNG stream) is a value the port parses but
cannot run; the trainer refuses it.

Every simulator takes a BATCH of contracts — ``[C, 6]`` contracts with
``[C, 2]`` key words give ``[C, rows, cols]`` — so the trainer launches one
kernel per contract chunk, not one per contract.

The one-contract facade is ``BlackScholes`` (``price`` consumes one draw and
returns the advanced engine; ``price_to_host`` gives ``HostPrices``), with
``simulate_terminal``, ``validate_contract`` and the contracts' ``as_array``.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors.gbm import (
    GBMError,
    InvalidContract,
    InvalidSimulationParams,
    MemoryLimitExceeded,
)
from spectralmc_tpu_torch.core.precision import Precision
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops.basket import BasketCombine, BasketSpec

# Same config-time guardrails as the JAX package.
MAX_TOTAL_PATHS_F32 = 1_000_000_000
MAX_TOTAL_PATHS_F64 = 500_000_000


class PathScheme(enum.Enum):
    LOG_EULER = "log_euler"
    EULER = "euler"  # simple Euler with reflection |X|


class ForwardNormalization(enum.Enum):
    NONE = "none"
    MEAN = "mean"  # rescale so the path mean matches the analytic forward


class PayoffKind(enum.Enum):
    """All payoff kinds of the JAX package (its ``PayoffKind`` docstring
    defines each underlier); the port simulates every kind under every
    dynamics (the American ones under curves for GBM only, as the JAX
    package refuses the rest). An American kind trains ONE
    side's Bermudan cashflow through the put-payoff channel: its underlier
    is ``u = K − cf/df`` (``ops/american.py``)."""

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


BARRIER_PAYOFFS = frozenset({PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT})
AMERICAN_PAYOFFS = frozenset({PayoffKind.AMERICAN_PUT, PayoffKind.AMERICAN_CALL})
LOOKBACK_PAYOFFS = frozenset(
    {
        PayoffKind.LOOKBACK_FIXED_CALL,
        PayoffKind.LOOKBACK_FIXED_PUT,
        PayoffKind.LOOKBACK_FLOAT_CALL,
        PayoffKind.LOOKBACK_FLOAT_PUT,
    }
)
# kinds whose extreme is the running MAX (the others track the running MIN)
LOOKBACK_MAX_PAYOFFS = frozenset({PayoffKind.LOOKBACK_FIXED_CALL, PayoffKind.LOOKBACK_FLOAT_PUT})


def lookback_underlier(
    payoff: PayoffKind, strike: torch.Tensor, extreme: torch.Tensor, terminal: torch.Tensor
) -> torch.Tensor:
    """The lookback kinds' synthetic underlier, encoded so that
    ``df·max(K − u, 0)`` is the product: fixed call ``2K − M``, fixed put
    ``m``, floating put ``K − (M − S_T)``, floating call ``K − (S_T − m)``.
    ``extreme``/``terminal`` in linear price space; shared by both engines."""
    if payoff == PayoffKind.LOOKBACK_FIXED_CALL:
        return 2.0 * strike - extreme
    if payoff == PayoffKind.LOOKBACK_FIXED_PUT:
        return extreme
    if payoff == PayoffKind.LOOKBACK_FLOAT_PUT:
        return strike - (extreme - terminal)
    assert payoff == PayoffKind.LOOKBACK_FLOAT_CALL
    return strike - (terminal - extreme)


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
    """The path-increment source: the pseudo-random stream of the engine, or
    a scrambled Sobol net in Brownian-bridge order (``ops/qmc.py``), a bit
    stream of its own that always runs the threefry engine's scans."""

    PSEUDO = "pseudo"
    SOBOL_BB = "sobol_bb"


class TermStructure(BaseModel):
    """Piecewise-constant relative curves over the simulation grid.

    Each shape is a per-step multiplier on the corresponding contract field:
    during step ``t`` the instantaneous parameters are ``vol·vol_shape[t]``,
    ``rate·rate_shape[t]`` and ``div_yield·div_shape[t]``. An empty tuple
    means flat (all ones). The contract scalars stay the Sobol-sampled
    training features; the curves are desk configuration, checkpointed with
    ``SimulationParams`` (they change the trained distribution, not the
    threefry bit stream: the normals' keying is untouched).

    The terminal law stays exactly lognormal, so the Black oracle holds at
    the effective parameters ``vol·sqrt(mean(vs²))``, ``rate·mean(rs)``,
    ``div·mean(qs)`` (``ops/analytic.py::term_effective_black``).
    """

    model_config = ConfigDict(frozen=True, extra="forbid")

    vol_shape: tuple[float, ...] = ()
    rate_shape: tuple[float, ...] = ()
    div_shape: tuple[float, ...] = ()

    def is_flat(self) -> bool:
        return all(
            all(v == 1.0 for v in shape)
            for shape in (self.vol_shape, self.rate_shape, self.div_shape)
        )

    def n_steps(self) -> int | None:
        """The grid length implied by the non-empty shapes (None = all flat)."""
        for s in (self.vol_shape, self.rate_shape, self.div_shape):
            if s:
                return len(s)
        return None

    def shapes(self, timesteps: int) -> tuple[tuple[float, ...], ...]:
        """(vol, rate, div) shapes with empties expanded to flat ones."""
        flat = (1.0,) * timesteps
        return (self.vol_shape or flat, self.rate_shape or flat, self.div_shape or flat)

    def effective_factors(self, timesteps: int) -> tuple[float, float, float]:
        """(RMS vol factor, mean rate factor, mean div factor): the exact
        flat-equivalent multipliers for the terminal lognormal law."""
        vs, rs, qs = self.shapes(timesteps)
        n = float(timesteps)
        return (math.sqrt(sum(v * v for v in vs) / n), sum(rs) / n, sum(qs) / n)


def curved(term: "TermStructure | None") -> "TermStructure | None":
    """``term`` if it bends anything, else None: an exactly-flat term is the
    same program as no term, bit for bit, on every engine."""
    return None if term is None or term.is_flat() else term


def validate_term_structure(
    term: TermStructure, *, timesteps: int
) -> Result[TermStructure, GBMError]:
    """Shape-length and positivity checks."""
    for name, shape in (
        ("vol_shape", term.vol_shape),
        ("rate_shape", term.rate_shape),
        ("div_shape", term.div_shape),
    ):
        if shape and len(shape) != timesteps:
            return _invalid(f"term.{name}", len(shape),
                            f"length must equal timesteps ({timesteps})")
        if not all(math.isfinite(v) for v in shape):
            return _invalid(f"term.{name}", shape, "entries must be finite")
    if any(v < 0.0 for v in term.vol_shape):
        return _invalid("term.vol_shape", term.vol_shape, "vol multipliers must be >= 0")
    if term.vol_shape and not any(v > 0.0 for v in term.vol_shape):
        return _invalid("term.vol_shape", term.vol_shape,
                        "at least one step must have positive vol")
    return Success(term)


def bootstrap_vol_shape(
    quotes: tuple[tuple[int, float], ...],
    *,
    timesteps: int,
    reference_vol: float,
) -> Result[tuple[float, ...], GBMError]:
    """Strip a term structure of implied vols into a ``vol_shape``.

    ``quotes`` are ``(grid step k, implied vol at t_k)`` pairs. Piecewise-flat
    forward variance: steps in ``(k_{i-1}, k_i]`` get
    ``v² = (k_i σ_i² − k_{i-1} σ_{i-1}²) / (k_i − k_{i-1})``, the unique
    piecewise-constant curve that reproduces every quote exactly; beyond the
    last quote the curve extends flat. A calendar-arbitrage strip (negative
    forward variance) fails instead of emitting an imaginary vol.
    """
    if reference_vol <= 0.0 or not math.isfinite(reference_vol):
        return _invalid("reference_vol", reference_vol, "must be > 0")
    if not quotes:
        return _invalid("quotes", (), "need >= 1 quote")
    prev_k = 0
    prev_total_var = 0.0
    shape: list[float] = []
    for k, sigma in quotes:
        if not 0 < k <= timesteps:
            return _invalid("quotes", k, f"expiry step must be in [1, {timesteps}]")
        if k <= prev_k:
            return _invalid("quotes", k, "expiry steps must be increasing")
        if sigma <= 0.0 or not math.isfinite(sigma):
            return _invalid("quotes", sigma, "implied vols must be > 0")
        total_var = k * sigma * sigma  # in units of one grid step
        fwd_var = (total_var - prev_total_var) / (k - prev_k)
        if fwd_var < 0.0:
            return _invalid("quotes", (k, sigma),
                            "calendar arbitrage: total implied variance "
                            f"decreases at step {k} "
                            f"({total_var:.6g} < {prev_total_var:.6g})")
        shape.extend([math.sqrt(fwd_var) / reference_vol] * (k - prev_k))
        prev_k, prev_total_var = k, total_var
    if prev_k < timesteps:
        shape.extend([shape[-1]] * (timesteps - prev_k))
    return Success(tuple(shape))


class BlackScholesContract(BaseModel):
    """One European-option market scenario."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    spot: float
    strike: float
    maturity: float
    rate: float
    div_yield: float
    vol: float

    def as_array(
        self, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"
    ) -> torch.Tensor:
        """The ``[6]`` vector in field order, on ``device``."""
        return torch.tensor(
            [self.spot, self.strike, self.maturity, self.rate, self.div_yield, self.vol],
            dtype=dtype, device=device,
        )


CONTRACT_FIELDS: tuple[str, ...] = tuple(BlackScholesContract.model_fields.keys())
CONTRACT_DIM = len(CONTRACT_FIELDS)


def validate_contract(c: BlackScholesContract) -> Result[BlackScholesContract, GBMError]:
    """Spot, strike, maturity and vol must be positive (the JAX package's check)."""
    for field in ("spot", "strike", "maturity", "vol"):
        value = getattr(c, field)
        if value <= 0.0:
            return Failure(InvalidContract(field=field, value=value, reason="must be positive"))
    return Success(c)


class SimulationParams(BaseModel):
    """Workload shape + determinism state, field for field the JAX package's.

    ``total_paths = network_size * batches_per_mc_run``; the FFT length is
    ``network_size``; ``skip`` counts contract-simulations already drawn (the
    resume offset). ``basket`` is the static ``BasketSpec`` of
    ``model="basket_gbm"``. The LSMC knobs are the American kinds':
    ``lsmc_basis_degree`` (1–8), ``lsmc_exercise_every`` (monitor dates every
    k steps), ``lsmc_cross_fit`` (the bracket-midpoint estimator) and
    ``lsmc_fused_backward`` (the JAX package's request for its TPU backward
    kernels, held to its rules; the ``"cuda"`` engine runs its own backward
    kernel wherever it applies, ``ops/american_cuda.py``).
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
    basket: BasketSpec | None = None
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
    term: TermStructure | None = None

    @property
    def total_paths(self) -> int:
        return self.network_size * self.batches_per_mc_run


def _invalid(field: str, value: object, reason: str) -> Failure:
    return Failure(InvalidSimulationParams(field=field, value=value, reason=reason))


def _payoff_knob_refusal(params: SimulationParams) -> Failure | None:
    """The JAX package's payoff-knob checks, in its order, fields and reasons."""
    payoff = params.payoff
    if payoff in BARRIER_PAYOFFS:
        if params.barrier_rel is None:
            return _invalid("barrier_rel", None, f"payoff={payoff.value!r} requires barrier_rel")
        if payoff == PayoffKind.BARRIER_UP_OUT and params.barrier_rel <= 1.0:
            return _invalid("barrier_rel", params.barrier_rel,
                            "up-and-out barrier must be > 1x spot")
        if payoff == PayoffKind.BARRIER_DOWN_OUT and not 0.0 < params.barrier_rel < 1.0:
            return _invalid("barrier_rel", params.barrier_rel,
                            "down-and-out barrier must be in (0, 1)x spot")
    elif params.barrier_rel is not None:
        return _invalid("barrier_rel", params.barrier_rel,
                        f"payoff={payoff.value!r} takes no barrier")
    if payoff == PayoffKind.FORWARD_START:
        if params.forward_start_step is None:
            return _invalid("forward_start_step", None,
                            "payoff='forward_start' requires forward_start_step")
        if not 1 <= params.forward_start_step < params.timesteps:
            return _invalid("forward_start_step", params.forward_start_step,
                            "strike-setting date must be an interior grid index "
                            "(1 <= m < timesteps)")
    elif params.forward_start_step is not None:
        return _invalid("forward_start_step", params.forward_start_step,
                        f"payoff={payoff.value!r} takes no strike-setting date")
    knobs = (params.cliquet_reset_every, params.cliquet_floor, params.cliquet_cap)
    if payoff == PayoffKind.CLIQUET:
        if any(k is None for k in knobs):
            return _invalid("cliquet_reset_every", None,
                            "payoff='cliquet' requires cliquet_reset_every, cliquet_floor "
                            "and cliquet_cap")
        every = params.cliquet_reset_every
        if every < 1 or params.timesteps % every:
            return _invalid("cliquet_reset_every", every,
                            "must be >= 1 and divide timesteps (maturity is always a "
                            "reset date)")
        if params.timesteps // every < 2:
            return _invalid("cliquet_reset_every", every,
                            "a cliquet needs >= 2 reset periods (one period is a clipped "
                            "forward — use payoff='terminal')")
        if not -1.0 < params.cliquet_floor < params.cliquet_cap:
            return _invalid("cliquet_floor", params.cliquet_floor,
                            "need -1 < floor < cap (a period return cannot fall below "
                            "-100%)")
    elif any(k is not None for k in knobs):
        return _invalid("cliquet_reset_every", params.cliquet_reset_every,
                        f"payoff={payoff.value!r} takes no cliquet reset grid or clip levels")
    if payoff in AMERICAN_PAYOFFS:
        return _american_refusal(params)
    if params.lsmc_cross_fit:
        return _invalid("lsmc_cross_fit", True,
                        f"payoff={payoff.value!r} has no LSMC regression to cross-fit")
    if params.lsmc_fused_backward:
        return _invalid("lsmc_fused_backward", True,
                        f"payoff={payoff.value!r} has no LSMC backward induction")
    return None


def _american_refusal(params: SimulationParams) -> Failure | None:
    """The LSMC knobs' checks, in the JAX package's order, fields and
    reasons. ``lsmc_fused_backward`` asks for the JAX package's backward
    kernels, which run the classic single-recursion estimator on one state
    variable with flat discounting."""
    if params.scheme != PathScheme.LOG_EULER:
        return _invalid("scheme", params.scheme.value, "LSMC early exercise is log-Euler only")
    if not 1 <= params.lsmc_basis_degree <= 8:
        return _invalid("lsmc_basis_degree", params.lsmc_basis_degree, "must be in [1, 8]")
    every = params.lsmc_exercise_every
    if every < 1 or params.timesteps % every:
        return _invalid("lsmc_exercise_every", every,
                        "must be >= 1 and divide timesteps (maturity is always a monitor date)")
    if params.timesteps // every < 2:
        return _invalid("timesteps", params.timesteps, "early exercise needs >= 2 monitor dates")
    if params.lsmc_cross_fit and params.network_size < 2:
        return _invalid("lsmc_cross_fit", True,
                        "cross-fitting splits the path columns in half; network_size must be "
                        ">= 2")
    if params.lsmc_fused_backward:
        if params.lsmc_cross_fit:
            return _invalid("lsmc_fused_backward", True,
                            "the fused backward implements the classic single-recursion "
                            "estimator; the cross-fitted pair carries two cashflow vectors — "
                            "choose one")
        if params.model != ModelKind.GBM:
            return _invalid("lsmc_fused_backward", params.model.value,
                            "the fused backward is single-state moneyness-basis LSMC — GBM "
                            "dynamics only (Heston/basket augment the basis; Merton is future "
                            "scope)")
        if curved(params.term) is not None:
            return _invalid("lsmc_fused_backward", True,
                            "curved term structures need per-segment discounts; the fused "
                            "backward is flat-discount only")
    return None


def _normalization_refusal(params: SimulationParams) -> Failure | None:
    """MEAN normalization's three refusals, with the JAX package's reasons."""
    if params.normalization != ForwardNormalization.MEAN:
        return None
    if params.payoff == PayoffKind.DIGITAL:
        return _invalid("normalization", params.normalization.value,
                        "the digital ±1 underlier encoding is not scale-equivariant: "
                        "multiplicative mean rescaling would corrupt the indicator; use "
                        "normalization='none'")
    if params.payoff == PayoffKind.CLIQUET:
        return _invalid("normalization", params.normalization.value,
                        "the cliquet sum of clipped returns is not scale-equivariant: "
                        "multiplicative mean rescaling would move returns through the clip "
                        "levels; use normalization='none'")
    if not has_closed_form_mean(params.model, params.payoff, combine=_combine(params)):
        return _invalid("normalization", params.normalization.value,
                        f"E[underlier] has no closed form for {params.model.value}/"
                        f"{params.payoff.value}; use normalization='none'")
    return None


def _combine(params: SimulationParams) -> BasketCombine | None:
    return params.basket.combine if params.basket is not None else None


def _basket_refusal(params: SimulationParams) -> Failure | None:
    """A basket model needs a spec and log-Euler; other models take none."""
    if params.model == ModelKind.BASKET_GBM:
        if params.basket is None:
            return _invalid("basket", None, "model='basket_gbm' requires a BasketSpec")
        if params.scheme != PathScheme.LOG_EULER:
            return _invalid("scheme", params.scheme.value, "basket dynamics are log-Euler only")
    elif params.basket is not None:
        return _invalid("basket", params.basket,
                        f"model={params.model.value!r} takes no BasketSpec")
    return None


def build_simulation_params(**kwargs: Any) -> Result[SimulationParams, GBMError]:
    """Validated constructor: the JAX package's checks, in its order, with
    its fields and reasons."""
    try:
        params = SimulationParams(**kwargs)
    except Exception as exc:  # pydantic ValidationError
        return Failure(InvalidSimulationParams(field="<model>", value=kwargs, reason=str(exc)))
    for field in ("timesteps", "network_size", "batches_per_mc_run"):
        if getattr(params, field) <= 0:
            return _invalid(field, getattr(params, field), "must be positive")
    if params.mc_seed < 0:
        return _invalid("mc_seed", params.mc_seed, "must be >= 0")
    if params.skip < 0:
        return _invalid("skip", params.skip, "must be >= 0")
    if params.precision.is_complex():
        return _invalid("precision", params.precision.value, "MC dtype must be real")
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
    refused = _basket_refusal(params)
    if refused is not None:
        return refused
    if params.model == ModelKind.MERTON_JUMP and params.scheme != PathScheme.LOG_EULER:
        return _invalid("scheme", params.scheme.value,
                        "Merton jump-diffusion samples the exact log-space transition; "
                        "only log-Euler is defined")
    refused = _payoff_knob_refusal(params)
    if refused is not None:
        return refused
    if params.term is not None:
        if params.model == ModelKind.HESTON and any(v != 1.0 for v in params.term.vol_shape):
            return _invalid("term", "vol_shape",
                            "Heston has no deterministic vol curve — its instantaneous vol "
                            "IS the variance process (v0/kappa/theta/xi contract fields); "
                            "rate_shape/div_shape curves are supported")
        if (params.model != ModelKind.GBM and params.payoff in AMERICAN_PAYOFFS
                and curved(params.term) is not None):
            return _invalid("term", params.model.value,
                            "LSMC early exercise under term structures is supported for GBM "
                            "dynamics only (the curved-coefficient lattice oracle and "
                            "per-segment discount backward exist for the single-factor "
                            "lognormal family)")
        checked_term = validate_term_structure(params.term, timesteps=params.timesteps)
        if isinstance(checked_term, Failure):
            return checked_term
    if params.antithetic and params.batches_per_mc_run % 2:
        return _invalid("antithetic", params.batches_per_mc_run,
                        "antithetic pairing needs an even batches_per_mc_run")
    if params.sampling == SamplingKind.SOBOL_BB and params.payoff in AMERICAN_PAYOFFS:
        return _invalid("sampling", params.sampling.value,
                        "LSMC early exercise draws its own pseudo stream; QMC applies to the "
                        "path-independent payoff kinds")
    if params.sampling == SamplingKind.SOBOL_BB and params.antithetic:
        return _invalid("antithetic", True,
                        "the scrambled Sobol net is already stratified; antithetic "
                        "mirroring would break its digital-shift randomization (choose one "
                        "variance-reduction scheme)")
    refused = _normalization_refusal(params)
    if refused is not None:
        return refused
    return Success(params)


def has_closed_form_mean(
    model: ModelKind, payoff: PayoffKind, *, combine: BasketCombine | None = None
) -> bool:
    """Whether analytic E[underlier] exists for this (dynamics, payoff) pair
    (gates MEAN normalization and call-via-parity).

    No dynamics has one for the barrier, lookback and American kinds. GBM
    has one for every other payoff, and so has the geometric basket (an
    effective GBM). Heston and Merton keep the discounted spot a martingale
    (TERMINAL, arithmetic Asian, forward start) and lose the geometric
    average; Merton's exact transitions also give the digital, variance-swap
    and cliquet means as series, which Heston's Euler scheme does not. The
    arithmetic basket (``combine``) keeps TERMINAL and the arithmetic Asian
    only.
    """
    arithmetic_basket = model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC
    if payoff in BARRIER_PAYOFFS or payoff in AMERICAN_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        return False
    if payoff in (PayoffKind.DIGITAL, PayoffKind.VARIANCE_SWAP, PayoffKind.CLIQUET):
        return model != ModelKind.HESTON and not arithmetic_basket
    if payoff == PayoffKind.FORWARD_START:
        return not arithmetic_basket
    if model in (ModelKind.HESTON, ModelKind.MERTON_JUMP) or arithmetic_basket:
        return payoff != PayoffKind.ASIAN_GEOMETRIC
    return True


def resolve_implementation(params: SimulationParams) -> SimImplementation:
    """The engine that will ACTUALLY execute for these params.

    ``"cuda"`` runs wherever ``gbm_cuda.cuda_supported`` says the kernels
    honor the request (the single source of truth), else the threefry
    engine; the kernels take any row count. An American kind on flat market
    data runs its dynamics' monitor-row kernel (GBM, Heston, Merton, baskets
    of 1–8 assets); a GBM one under a curved term its threefry forward (the
    kernels take no coefficient tables). ``SOBOL_BB`` always records the
    threefry engine: its normals come from the QMC generator, whose kernels
    are an internal route, not an engine. The decision is made here, once,
    before a run: no wrapper falls back on its own. ``"pallas"`` resolves to
    itself: only the trainer's refusal stands between it and a run.
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
        scheme=params.scheme,
        n_assets=params.basket.n_assets if params.basket is not None else 1,
        timesteps=params.timesteps,
        exercise_every=params.lsmc_exercise_every,
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


def term_tensors(
    term: TermStructure, timesteps: int, dtype: torch.dtype, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (vol, rate, div) shapes as ``[T]`` tensors, empties expanded."""
    return tuple(  # type: ignore[return-value]
        torch.tensor(shape, dtype=dtype, device=device) for shape in term.shapes(timesteps)
    )


StepCoeff = Callable[[int], torch.Tensor]


def _step_coeffs(
    term: TermStructure | None,
    *,
    timesteps: int,
    rate: torch.Tensor,
    div_yield: torch.Tensor,
    vol: torch.Tensor,
    dt: torch.Tensor,
    sqrt_dt: torch.Tensor,
) -> tuple[StepCoeff, StepCoeff, StepCoeff]:
    """t-indexed ``(log_drift, lin_drift, vol_step)`` accessors, each
    broadcastable against ``[C, rows, cols]``.

    ``log_drift(t) = (r_t − q_t − v_t²/2)·dt``, ``lin_drift(t) = (r_t − q_t)·dt``,
    ``vol_step(t) = v_t·√dt``. Without a term the values are the flat
    scalars, built with exactly the flat arithmetic, so the flat stream is
    unchanged.
    """
    if term is None:
        ld = (rate - div_yield - 0.5 * vol * vol) * dt
        lin = (rate - div_yield) * dt
        vstep = vol * sqrt_dt
        return (lambda t: ld), (lambda t: lin), (lambda t: vstep)
    vsa, rsa, qsa = term_tensors(term, timesteps, vol.dtype, vol.device)
    vol_t = vol[..., None] * vsa
    carry = rate[..., None] * rsa - div_yield[..., None] * qsa
    ld_arr = (carry - 0.5 * vol_t * vol_t) * dt[..., None]
    lin_arr = carry * dt[..., None]
    vstep_arr = vol_t * sqrt_dt[..., None]
    return (lambda t: ld_arr[..., t]), (lambda t: lin_arr[..., t]), (lambda t: vstep_arr[..., t])


def _normals_source(
    contract_keys: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    row_offset: int,
    antithetic_half: int | None,
    sampling: SamplingKind,
    mc_seed: int,
) -> Callable[[int], torch.Tensor]:
    """``t -> [C, rows, cols]`` per-step normals: the sampling seam.

    PSEUDO: the canonical (contract key, global row, timestep) threefry
    stream. SOBOL_BB: a step of the Brownian-bridge-ordered scrambled Sobol
    tensor generated once per call (``ops/qmc.py``), with the same shape, the
    same marginals and the same shard stability in ``row_offset``.
    """
    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu_torch.ops.qmc import qmc_effective_normals

        if antithetic_half is not None:
            raise ValueError("SOBOL_BB sampling takes no antithetic mirroring")
        zq = qmc_effective_normals(contract_keys, timesteps=timesteps, rows=rows, cols=cols,
                                   dtype=dtype, mc_seed=mc_seed, row_offset=row_offset)
        return lambda t: zq[:, t]
    keys, sign = row_keys(
        contract_keys, rows=rows, row_offset=row_offset, antithetic_half=antithetic_half,
        dtype=dtype,
    )

    def normals(t: int) -> torch.Tensor:
        z = rng.normal(rng.fold_in(keys, t), (cols,), dtype)
        return z if sign is None else sign * z

    return normals


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
    sampling: SamplingKind = SamplingKind.PSEUDO,
    mc_seed: int = 0,
    term: TermStructure | None = None,
) -> torch.Tensor:
    """Terminal GBM values ``[C, rows, cols]`` on the threefry stream.

    ``contracts`` is ``[C, 6]`` = [spot, strike, maturity, rate, div_yield,
    vol] and ``contract_keys`` ``[C, 2]`` threefry words. Row ``r``'s normals
    at step ``t`` are ``normal(fold_in(fold_in(key, row_offset + r), t),
    (cols,))``, as in the JAX package, so the two agree to the normals'
    ulps. Only the ``[C, rows, cols]`` state is live; each step's normals
    are drawn and consumed inside the loop. A curved ``term`` gives each step
    its own coefficients; a flat one is no term.

    ``sampling=SOBOL_BB`` (seed ``mc_seed``) takes the QMC normals; under
    flat log-Euler only the bridge's level 0 is live (``Σ_t increments =
    √T·z_0``), so the terminal value is one exact step on
    ``qmc_terminal_normals``, equal to the scan up to summation order.
    """
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / timesteps
    term = curved(term)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term, timesteps=timesteps, rate=rate, div_yield=div_yield, vol=vol, dt=dt,
        sqrt_dt=torch.sqrt(dt),
    )
    if sampling == SamplingKind.SOBOL_BB and scheme == PathScheme.LOG_EULER and term is None:
        from spectralmc_tpu_torch.ops.qmc import qmc_terminal_normals

        z0 = qmc_terminal_normals(contract_keys, timesteps=timesteps, rows=rows, cols=cols,
                                  dtype=dtype, mc_seed=mc_seed, row_offset=row_offset)[:, 0]
        t_steps = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
        return torch.exp(torch.log(spot) + t_steps * log_drift(0)
                         + vol_step(0) * torch.sqrt(t_steps) * z0)
    normals = _normals_source(
        contract_keys, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        row_offset=row_offset, antithetic_half=antithetic_half, sampling=sampling,
        mc_seed=mc_seed,
    )

    if scheme == PathScheme.LOG_EULER:
        logx = torch.zeros((c.shape[0], rows, cols), dtype=dtype, device=c.device) + torch.log(spot)
        for t in range(timesteps):
            logx = logx + log_drift(t) + vol_step(t) * normals(t)
        return torch.exp(logx)
    x = torch.ones((c.shape[0], rows, cols), dtype=dtype, device=c.device) * spot
    for t in range(timesteps):
        x = torch.abs(x * (1.0 + lin_drift(t) + vol_step(t) * normals(t)))  # reflection
    return x


def simulate_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    scheme: PathScheme,
    payoff: PayoffKind,
    row_offset: int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    sampling: SamplingKind = SamplingKind.PSEUDO,
    mc_seed: int = 0,
    term: TermStructure | None = None,
) -> torch.Tensor:
    """Payoff underliers ``[C, rows, cols]`` on the threefry stream, for a
    batch of contracts: the terminal value, the path average, the
    knockout-masked terminal (strike on knocked paths), the lookback
    encoding, the digital ``K ± 1``, the realized variance, the
    forward-start ratio ``spot·S_T/S_m`` or the cliquet sum of clipped
    period returns (``PayoffKind``; the American kinds' simulator is
    ``ops/american.py::simulate_american_underlier_rows``).

    The normals are ``simulate_terminal_rows``'s, keyed by (contract key,
    global row, timestep), and every branch follows the JAX package's scan
    op for op, so TERMINAL is identical to ``simulate_terminal_rows`` and the
    two packages agree to the normals' ulps. Forward start walks the
    t-keyed tail ``t = m..N−1``; a cliquet period closes when ``(t+1) % k
    == 0``. A curved ``term`` gives each step its own coefficients in every
    branch; a flat one is no term. ``sampling=SOBOL_BB`` takes the QMC
    normals (``normals_source``); the flat log-Euler geometric Asian then
    runs the fused walk (``qmc.qmc_asian_geo_underliers``), which equals the
    scan over those normals bit for bit.
    """
    if payoff in AMERICAN_PAYOFFS:
        raise ValueError(f"payoff={payoff.value!r} runs "
                         "ops/american.py::simulate_american_underlier_rows")
    if payoff in (PayoffKind.TERMINAL, PayoffKind.DIGITAL):
        terminal = simulate_terminal_rows(
            contract_keys, contracts, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
            scheme=scheme, row_offset=row_offset, antithetic_half=antithetic_half,
            sampling=sampling, mc_seed=mc_seed, term=term,
        )
        if payoff == PayoffKind.DIGITAL:
            strike = contracts.to(dtype)[:, 1, None, None]
            return strike + torch.sign(terminal - strike)
        return terminal
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / timesteps
    term = curved(term)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term, timesteps=timesteps, rate=rate, div_yield=div_yield, vol=vol, dt=dt,
        sqrt_dt=torch.sqrt(dt),
    )
    shape = (c.shape[0], rows, cols)
    if (payoff == PayoffKind.ASIAN_GEOMETRIC and sampling == SamplingKind.SOBOL_BB
            and scheme == PathScheme.LOG_EULER and term is None):
        from spectralmc_tpu_torch.ops.qmc import qmc_asian_geo_underliers, qmc_walk_supported

        if qmc_walk_supported(timesteps=timesteps, dtype=dtype):
            if antithetic_half is not None:
                raise ValueError("SOBOL_BB sampling takes no antithetic mirroring")
            return qmc_asian_geo_underliers(
                contract_keys, timesteps=timesteps, rows=rows, cols=cols, mc_seed=mc_seed,
                row_offset=row_offset, log_spot=torch.log(spot), drift=log_drift(0),
                vol_sdt=vol_step(0),
            )
    normals = _normals_source(
        contract_keys, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        row_offset=row_offset, antithetic_half=antithetic_half, sampling=sampling,
        mc_seed=mc_seed,
    )

    def log_inc(t: int) -> torch.Tensor:
        """The step's log-increment, state-free under both schemes."""
        if scheme == PathScheme.LOG_EULER:
            return log_drift(t) + vol_step(t) * normals(t)
        return torch.log(torch.abs(1.0 + lin_drift(t) + vol_step(t) * normals(t)))

    def add_inc(t: int, acc: torch.Tensor) -> torch.Tensor:
        """``acc`` plus the step's log-increment, summed in the JAX scan's order."""
        if scheme == PathScheme.LOG_EULER:
            return acc + log_drift(t) + vol_step(t) * normals(t)
        return acc + log_inc(t)

    def walk(t: int, x: torch.Tensor) -> torch.Tensor:
        """One step of the state: log S under log-Euler, S under Euler."""
        if scheme == PathScheme.LOG_EULER:
            return x + log_drift(t) + vol_step(t) * normals(t)
        return torch.abs(x * (1.0 + lin_drift(t) + vol_step(t) * normals(t)))

    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None:
            raise ValueError("payoff='forward_start' requires forward_start_step")
        acc = torch.zeros(shape, dtype=dtype, device=c.device)
        for t in range(forward_start_step, timesteps):
            acc = add_inc(t, acc)
        return spot * torch.exp(acc)
    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=c.device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=c.device)
        per = torch.zeros(shape, dtype=dtype, device=c.device)
        acc = torch.zeros(shape, dtype=dtype, device=c.device)
        for t in range(timesteps):
            per = add_inc(t, per)
            if (t + 1) % cliquet_reset_every == 0:
                acc = acc + torch.clamp(torch.exp(per) - 1.0, floor_c, cap_c)
                per = torch.zeros_like(per)
        return acc
    if payoff == PayoffKind.VARIANCE_SWAP:
        acc = torch.zeros(shape, dtype=dtype, device=c.device)
        for t in range(timesteps):
            inc = log_inc(t)
            acc = acc + inc * inc
        return acc / maturity
    if scheme == PathScheme.LOG_EULER:
        x0 = torch.zeros(shape, dtype=dtype, device=c.device) + torch.log(spot)
    else:
        x0 = torch.ones(shape, dtype=dtype, device=c.device) * spot
    if payoff in BARRIER_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
        x, ext = x0, x0
        for t in range(timesteps):
            x = walk(t, x)
            ext = torch.maximum(ext, x) if up else torch.minimum(ext, x)
        if scheme == PathScheme.LOG_EULER:
            terminal, extreme = torch.exp(x), torch.exp(ext)
        else:
            terminal, extreme = x, ext
        if payoff in LOOKBACK_PAYOFFS:
            return lookback_underlier(payoff, strike, extreme, terminal)
        if barrier_rel is None:
            raise ValueError(f"payoff={payoff.value!r} requires barrier_rel")
        level = spot * torch.tensor(barrier_rel, dtype=dtype, device=c.device)
        if scheme == PathScheme.LOG_EULER:
            level = torch.log(level)
        knocked = ext >= level if up else ext <= level
        return torch.where(knocked, strike, terminal)
    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    x, acc = x0, torch.zeros(shape, dtype=dtype, device=c.device)
    for t in range(timesteps):
        x = walk(t, x)
        if scheme == PathScheme.LOG_EULER:
            acc = acc + (x if geometric else torch.exp(x))
        else:
            acc = acc + (torch.log(x) if geometric else x)
    mean = acc / timesteps
    return torch.exp(mean) if geometric else mean


def simulate_paths(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    paths: int,
    dtype: torch.dtype,
    scheme: PathScheme,
    normalize: bool,
    term: TermStructure | None = None,
) -> torch.Tensor:
    """The full path matrix ``[C, timesteps, paths]``: row ``t`` is the state
    after step ``t + 1``. Step ``t``'s normals are ``normal(fold_in(key, t),
    (paths,))`` of the contract's key itself (no row fold), as in the JAX
    package. With ``normalize`` each row is rescaled so its mean is the
    analytic forward at its date."""
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol = (c[:, i, None] for i in range(6))
    dt = maturity / timesteps
    term = curved(term)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term, timesteps=timesteps, rate=rate, div_yield=div_yield, vol=vol, dt=dt,
        sqrt_dt=torch.sqrt(dt),
    )
    x = torch.ones((c.shape[0], paths), dtype=dtype, device=c.device) * spot
    out = []
    for t in range(timesteps):
        z = rng.normal(rng.fold_in(contract_keys, t), (paths,), dtype)
        if scheme == PathScheme.LOG_EULER:
            x = x * torch.exp(log_drift(t) + vol_step(t) * z)
        else:
            x = torch.abs(x * (1.0 + lin_drift(t) + vol_step(t) * z))
        out.append(x)
    rows = torch.stack(out, dim=1)
    if normalize:
        if term is None:
            times = torch.arange(1, timesteps + 1, dtype=dtype, device=c.device) * dt
            forwards = spot * torch.exp((rate - div_yield) * times)
        else:
            _, rs, qs = term_tensors(term, timesteps, dtype, c.device)
            forwards = spot * torch.exp(torch.cumsum((rate * rs - div_yield * qs) * dt, dim=1))
        rows = rows * (forwards / torch.mean(rows, dim=2))[:, :, None]
    return rows


# --------------------------------------------------------------------------
# Payoffs
# --------------------------------------------------------------------------


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def expected_clipped_lognormal_return(
    mu: torch.Tensor, s: torch.Tensor, floor: torch.Tensor, cap: torch.Tensor
) -> torch.Tensor:
    """E[clip(e^X − 1, floor, cap)] for X ~ N(mu, s²), closed form:
    floor·Φ(z_f) + e^{μ+s²/2}(Φ(z_c−s) − Φ(z_f−s)) − (Φ(z_c) − Φ(z_f))
    + cap·(1 − Φ(z_c)) with z = (ln(1+level) − μ)/s. Broadcasts."""
    zf = (torch.log1p(floor) - mu) / s
    zc = (torch.log1p(cap) - mu) / s
    body = torch.exp(mu + 0.5 * s * s) * (_norm_cdf(zc - s) - _norm_cdf(zf - s)) - (
        _norm_cdf(zc) - _norm_cdf(zf)
    )
    return floor * _norm_cdf(zf) + body + cap * (1.0 - _norm_cdf(zc))


def expected_underlier_mean(
    contracts: torch.Tensor,
    *,
    timesteps: int,
    payoff: PayoffKind,
    dtype: torch.dtype,
    term: TermStructure | None = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
) -> torch.Tensor | None:
    """Analytic E[underlier] per contract ``[..., 6] -> [...]`` under
    log-Euler GBM; None where no closed form exists (barrier, lookback,
    American).

    The MEAN-normalization target and the parity mean: the forward for
    TERMINAL, the mean of the average for the Asian kinds, ``K + 2·N(d2) − 1``
    for the digital, ``E[RV]`` for the variance swap, the tail forward for
    forward start and ``Σ E[clip(R_j)]`` for the cliquet. Exact for log-Euler;
    the continuous-limit value for reflection-Euler. With a curved ``term``
    the means follow the per-step curves exactly (cumulative drift sums
    replace the flat geometric series); a flat term takes the flat formulas
    bit for bit.
    """
    if payoff in BARRIER_PAYOFFS or payoff in AMERICAN_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        return None
    term = curved(term)
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol = (c[..., i] for i in range(6))
    n = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    dt = maturity / n
    if term is not None:
        vsa, rsa, qsa = term_tensors(term, timesteps, dtype, c.device)
        vol_t = vol[..., None] * vsa  # [..., T]
        lin = (rate[..., None] * rsa - div_yield[..., None] * qsa) * dt[..., None]
        var_t = vol_t * vol_t * dt[..., None]
        a_t = lin - 0.5 * var_t  # per-step log-drift
    if payoff == PayoffKind.DIGITAL:
        if term is not None:
            var = torch.sum(var_t, dim=-1)
            drift = torch.sum(lin, dim=-1)
        else:
            var = vol * vol * maturity
            drift = (rate - div_yield) * maturity
        d2 = (torch.log(spot / strike) + drift - 0.5 * var) / torch.sqrt(var)
        return strike + 2.0 * _norm_cdf(d2) - 1.0
    if payoff == PayoffKind.VARIANCE_SWAP:
        if term is not None:
            return torch.sum(a_t * a_t + var_t, dim=-1) / maturity
        a = (rate - div_yield - 0.5 * vol * vol) * dt
        return n * (a * a + vol * vol * dt) / maturity
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None:
            raise ValueError("payoff='forward_start' requires forward_start_step")
        if term is not None:
            return spot * torch.exp(torch.sum(lin[..., forward_start_step:], dim=-1))
        n_tail = torch.tensor(float(timesteps - forward_start_step), dtype=dtype, device=c.device)
        return spot * torch.exp((rate - div_yield) * dt * n_tail)
    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        k = cliquet_reset_every
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=c.device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=c.device)
        if term is not None:
            lead = a_t.shape[:-1]
            mu_j = torch.sum(a_t.reshape(*lead, timesteps // k, k), dim=-1)
            s_j = torch.sqrt(torch.sum(var_t.reshape(*lead, timesteps // k, k), dim=-1))
            return torch.sum(expected_clipped_lognormal_return(mu_j, s_j, floor_c, cap_c), dim=-1)
        mu_p = (rate - div_yield - 0.5 * vol * vol) * dt * k
        s_p = vol * torch.sqrt(dt * torch.tensor(float(k), dtype=dtype, device=c.device))
        periods = torch.tensor(float(timesteps // k), dtype=dtype, device=c.device)
        return periods * expected_clipped_lognormal_return(mu_p, s_p, floor_c, cap_c)
    if term is not None:
        cum_lin = torch.cumsum(lin, dim=-1)  # drift integral up to each t_k
        if payoff == PayoffKind.TERMINAL:
            return spot * torch.exp(cum_lin[..., -1])
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            return spot * torch.mean(torch.exp(cum_lin), dim=-1)
        # ASIAN_GEOMETRIC: mu = ln S0 + Σ a_j (N−j)/N, s² = Σ b_j² ((N−j)/N)²
        w = (n - torch.arange(timesteps, dtype=dtype, device=c.device)) / n
        mu = torch.log(spot) + torch.sum(a_t * w, dim=-1)
        s2 = torch.sum(var_t * w * w, dim=-1)
        return torch.exp(mu + 0.5 * s2)
    if payoff == PayoffKind.TERMINAL:
        return spot * torch.exp((rate - div_yield) * maturity)
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        # (1/N) Σ_{i=1..N} S0·e^{(r−q)·i·dt}, a finite geometric series
        g = torch.exp((rate - div_yield) * dt)
        series = torch.where(torch.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
        return spot * series / n
    # ASIAN_GEOMETRIC: ln G ~ N(mu, s²) exactly under log-Euler
    mu = torch.log(spot) + (rate - div_yield - 0.5 * vol * vol) * dt * (n + 1.0) / 2.0
    s2 = vol * vol * dt * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n)
    return torch.exp(mu + 0.5 * s2)


@dataclass(frozen=True)
class SimPrices:
    """Discounted payoff vectors + scalars, per contract (``BlackScholes.price``
    gives one contract's: ``[total_paths]`` vectors and 0-d scalars)."""

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
    term: TermStructure | None = None,
    row_mean: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(terminal', strike, forward, df)``, each batch-shaped ``[C, 1]``
    except ``terminal'`` ``[C, P]``: with ``normalize`` the sample mean of
    each contract's row is rescaled to ``mean_target`` (default: the
    forward). ``row_mean`` ``[C, 1]`` replaces the row's own mean: a shard of
    the paths passes the mean over every shard. ``contracts`` is ``[C, D]``
    of any dynamics: the five market fields lead. With a ``term``,
    discounting and the forward use the curve-effective rates
    ``rate·mean(rs)`` and ``div·mean(qs)``."""
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield = (c[:, i, None] for i in range(5))
    if term is not None and term.n_steps() is not None:
        _, mean_rate, mean_div = term.effective_factors(term.n_steps() or 1)
        rate, div_yield = rate * mean_rate, div_yield * mean_div
    forward = spot * torch.exp((rate - div_yield) * maturity)
    df = torch.exp(-rate * maturity)
    if normalize:
        target = forward if mean_target is None else mean_target.reshape(-1, 1)
        mean = torch.mean(terminal, dim=1, keepdim=True) if row_mean is None else row_mean
        terminal = terminal * (target / mean)
    return terminal, strike, forward, df


def discounted_put(
    terminal: torch.Tensor,
    contracts: torch.Tensor,
    *,
    normalize: bool,
    dtype: torch.dtype,
    mean_target: torch.Tensor | None = None,
    term: TermStructure | None = None,
    row_mean: torch.Tensor | None = None,
) -> torch.Tensor:
    """The put payoff vector ``[C, P]`` alone — what the training target
    needs, without materializing the call vector (``row_mean``:
    ``normalized_terminal``'s)."""
    terminal, strike, _, df = normalized_terminal(
        terminal, contracts, normalize=normalize, dtype=dtype, mean_target=mean_target, term=term,
        row_mean=row_mean,
    )
    return df * torch.clamp(strike - terminal, min=0.0)


def terminal_to_prices(
    terminal: torch.Tensor,
    contracts: torch.Tensor,
    *,
    normalize: bool,
    dtype: torch.dtype,
    mean_target: torch.Tensor | None = None,
    term: TermStructure | None = None,
) -> SimPrices:
    """Payoff vectors from underlier values ``[C, P]``, with optional MEAN
    normalization of each contract's row to ``mean_target``."""
    terminal, strike, forward, df = normalized_terminal(
        terminal, contracts, normalize=normalize, dtype=dtype, mean_target=mean_target, term=term
    )
    put = df * torch.clamp(strike - terminal, min=0.0)
    call = df * torch.clamp(terminal - strike, min=0.0)
    return SimPrices(
        put_payoffs=put,
        call_payoffs=call,
        forward=forward[:, 0],
        discount_factor=df[:, 0],
    )


def simulate_terminal(
    contract_key: torch.Tensor,
    contract: torch.Tensor,
    *,
    timesteps: int,
    batches: int,
    network_size: int,
    dtype: torch.dtype,
    scheme: PathScheme,
) -> torch.Tensor:
    """Flat terminal values ``[batches * network_size]`` of one contract
    (``[6]``, key ``[2]``) on the threefry stream."""
    return simulate_terminal_rows(
        contract_key[None], contract[None], timesteps=timesteps, rows=batches,
        cols=network_size, dtype=dtype, scheme=scheme,
    ).reshape(batches * network_size)


@dataclass(frozen=True)
class HostPrices:
    """Host scalars incl. intrinsics and convexities (time value)."""

    put: float
    call: float
    put_intrinsic: float
    call_intrinsic: float
    put_convexity: float
    call_convexity: float
    forward: float
    discount_factor: float


# --------------------------------------------------------------------------
# Engine facade
# --------------------------------------------------------------------------


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without a
    card raises rather than carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs an NVIDIA GPU and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class BlackScholes:
    """Stateless pricing engine over ``SimulationParams`` on one torch device.

    Holds only the frozen params and the device. ``price`` consumes one draw
    per call (key ``fold_in(prng_key(mc_seed), skip)``) and returns the
    engine advanced by one ``skip`` beside the prices, so resume state stays
    explicit. The simulator is the one ``dispatch.make_underlier_simulator``
    picks: on ``"cuda"`` the kernel of the sim's payoff, on ``"xla"`` the
    threefry scan.
    """

    def __init__(self, params: SimulationParams, *, device: torch.device | str = "cuda") -> None:
        if params.model != ModelKind.GBM:
            raise ValueError(
                f"BlackScholes simulates GBM only; params.model={params.model.value!r}. "
                "Heston/basket pricing goes through ops/heston.py / ops/basket.py "
                "simulators or the trainer (ops/dispatch.py selects on ModelKind)."
            )
        self._params = params
        self._device = resolve_device(device)
        self._key = rng.prng_key(params.mc_seed, self._device)

    @property
    def params(self) -> SimulationParams:
        return self._params

    @property
    def device(self) -> torch.device:
        return self._device

    def snapshot(self) -> SimulationParams:
        """Checkpointable state: the params already carry the skip."""
        return self._params

    def contract_key(self, draw_index: int | torch.Tensor) -> torch.Tensor:
        return rng.fold_in(self._key, draw_index)

    def simulate_terminal(
        self, contract: torch.Tensor, draw_index: int | torch.Tensor
    ) -> torch.Tensor:
        """Flat underliers ``[batches_per_mc_run * network_size]`` of one
        contract vector on draw ``draw_index``."""
        from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator

        p = self._params
        simulate = make_underlier_simulator(p, rows=p.batches_per_mc_run)
        key = self.contract_key(draw_index).reshape(1, 2)
        return simulate(key, contract[None]).reshape(p.batches_per_mc_run * p.network_size)

    def price(self, contract: BlackScholesContract) -> tuple[SimPrices, "BlackScholes"]:
        """One contract's discounted payoff vectors ``[total_paths]`` (forward
        and discount factor 0-d) on draw ``skip``, and the advanced engine."""
        from spectralmc_tpu_torch.ops.dispatch import make_mean_target

        p = self._params
        dtype = p.precision.to_torch()
        arr = contract.as_array(dtype, self._device)
        terminal = self.simulate_terminal(arr, p.skip)
        target = make_mean_target(p)(arr[None])
        prices = terminal_to_prices(
            terminal[None].to(dtype), arr[None],
            normalize=p.normalization == ForwardNormalization.MEAN, dtype=dtype,
            mean_target=target, term=p.term,
        )
        one = SimPrices(put_payoffs=prices.put_payoffs[0], call_payoffs=prices.call_payoffs[0],
                        forward=prices.forward[0], discount_factor=prices.discount_factor[0])
        advanced = BlackScholes(p.model_copy(update={"skip": p.skip + 1}), device=self._device)
        return one, advanced

    def price_to_host(self, contract: BlackScholesContract) -> tuple[HostPrices, "BlackScholes"]:
        prices, advanced = self.price(contract)
        put, call, fwd, df = torch.stack([
            torch.mean(prices.put_payoffs), torch.mean(prices.call_payoffs),
            prices.forward.to(prices.put_payoffs.dtype),
            prices.discount_factor.to(prices.put_payoffs.dtype),
        ]).tolist()  # the one device->host copy
        put_intr = df * max(contract.strike - fwd, 0.0)
        call_intr = df * max(fwd - contract.strike, 0.0)
        return (
            HostPrices(
                put=put, call=call, put_intrinsic=put_intr, call_intrinsic=call_intr,
                put_convexity=put - put_intr, call_convexity=call - call_intr,
                forward=fwd, discount_factor=df,
            ),
            advanced,
        )
