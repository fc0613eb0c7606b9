"""Option Greeks: pathwise (IPA) Monte-Carlo sensitivities by autograd.

The port of the JAX package's ``ops/greeks.py``. The contract's key words
(``fold_in(prng_key(mc_seed), draw_index)``) depend only on integers, never
on the contract, so differentiating the mean discounted payoff holds the
noise fixed (common random numbers) and

    greeks = ∂(mean discounted payoff)/∂(contract vector)

is the pathwise estimator, valid for the a.e.-differentiable payoffs. Three
estimator families:

* ``mc_greeks`` — first-order Greeks of the MC price for any (ModelKind,
  PayoffKind) the engines support but the indicator payoffs, and gamma as
  the central difference of the pathwise delta on the same key.
* ``bump_greeks`` — central finite differences under common random numbers,
  valid for every payoff (the barrier and digital ones included): the 2D+1
  bumped contracts run as ONE simulator call on a ``[2D+1, D]`` batch with
  the key words repeated, so the ``"cuda"`` engine prices them in one launch.
* ``analytic_greeks`` — exact Greeks by autograd of the float64 closed forms
  (``ops/analytic.py``), gamma a second derivative.
  ``GbmCVNNPricer.predict_greeks`` (``training/trainer.py``) differentiates
  the learned pricer.

Engine (``greeks_engine``): where ``resolve_implementation`` runs the
``"cuda"`` engine for GBM, TERMINAL, log-Euler and the pseudo stream (flat
or curved), the forward is kernel #1 (or #2 under a curve) and the backward
the analytic pathwise rule over the kernel's own samples
(``gbm_cuda.simulate_terminal_rows_cuda_diff``). Every other combination
runs the threefry (``"xla"``) engine, whose torch scans autograd
differentiates; a ``SOBOL_BB`` geometric Asian there walks kernel #14 on the
card, with its own backward (``qmc_cuda.WalkAcc``). ``MCGreeks.engine``
records which ran. A ``"pallas"`` sim is refused.

Every entry point takes ``device``, ``"cuda"`` by default; on a machine
without a card that raises (``gbm.resolve_device``) instead of running on
the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Protocol

import torch

from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops.american import OptionSide
from spectralmc_tpu_torch.ops.analytic import black_scholes_price, geometric_asian_price
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    BARRIER_PAYOFFS,
    LOOKBACK_PAYOFFS,
    ForwardNormalization,
    ModelKind,
    PathScheme,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    SimulationParams,
    _normals_source,
    resolve_device,
    resolve_implementation,
    terminal_to_prices,
)

PriceFn = Callable[[int, torch.Tensor], torch.Tensor]
GreeksFn = Callable[[int, torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class SupportsAsArray(Protocol):
    """Any contract model (BlackScholes/Heston/Merton): a frozen pydantic
    record exposing ``as_array(dtype, device)`` in its field order."""

    def as_array(self, dtype: torch.dtype = ..., device: torch.device | str = ...
                 ) -> torch.Tensor: ...


@dataclass(frozen=True)
class MCGreeks:
    """One contract's price + full first-order sensitivity vector.

    ``by_field`` maps every contract field (the model family's own fields —
    6 for GBM, 10 for Heston) to ∂price/∂field. Named accessors cover the
    classic Greeks; ``theta`` follows the market convention −∂price/∂T.
    """

    price: float
    by_field: Mapping[str, float]
    gamma: float
    engine: SimImplementation

    @property
    def delta(self) -> float:
        return self.by_field["spot"]

    @property
    def dual_delta(self) -> float:
        return self.by_field["strike"]

    @property
    def theta(self) -> float:
        return -self.by_field["maturity"]

    @property
    def rho(self) -> float:
        return self.by_field["rate"]

    @property
    def div_rho(self) -> float:
        return self.by_field["div_yield"]

    @property
    def vega(self) -> float:
        """∂price/∂vol — GBM only (Heston exposes v0/xi/… sensitivities)."""
        return self.by_field["vol"]


def _check_american_side(sim: SimulationParams, option: OptionSide) -> OptionSide:
    """Validate + remap the option side for the AMERICAN payoff kinds.

    The synthetic underlier encodes ONE side's LSMC cashflow through the put
    channel; the opposite channel is identically zero, so its "Greeks" would
    be silently zero. Every estimator factory calls this.
    """
    if sim.payoff not in AMERICAN_PAYOFFS:
        return option
    configured = OptionSide.PUT if sim.payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL
    if option != configured:
        raise ValueError(
            f"sim.payoff={sim.payoff.value!r} prices the {configured.value} "
            "side only; early exercise has no parity route to the other "
            "side — configure the other AMERICAN kind"
        )
    return OptionSide.PUT  # the put channel carries the configured side


def _refuse_pallas(sim: SimulationParams) -> None:
    if sim.implementation == SimImplementation.PALLAS:
        raise ValueError(
            "the 'pallas' stream is the TPU hardware PRNG, which this package cannot "
            "draw; use 'cuda' or 'xla' instead"
        )


def make_mc_price_fn(
    sim: SimulationParams, *, option: OptionSide, device: torch.device | str = "cuda"
) -> PriceFn:
    """(draw_index, contract vector ``[D]`` or batch ``[C, D]``) → the MC
    price (0-d or ``[C]``), differentiable in the contract.

    The pricer's own simulate→normalize→discount pipeline, reduced to the
    mean discounted payoff. Engine per ``greeks_engine``. Indicator payoffs
    (the knockouts and the digital) are refused: their pathwise derivative is
    zero almost everywhere, so the estimator would drop the discontinuity.
    For the American kinds the gradient runs through the LSMC program with
    the exercise indicator held locally constant (the fixed-policy pathwise
    estimator; first-order Greeks consistent by the envelope argument).
    """
    if sim.payoff in BARRIER_PAYOFFS or sim.payoff == PayoffKind.DIGITAL:
        raise ValueError(
            "pathwise (IPA) Greeks are invalid for indicator payoffs "
            f"({sim.payoff.value}); use bump_greeks (bump-and-reprice under "
            "common random numbers) or differentiate the learned pricer "
            "(predict_greeks) instead"
        )
    option = _check_american_side(sim, option)
    return _make_raw_price_fn(sim, option=option, device=device)


def greeks_engine(sim: SimulationParams) -> SimImplementation:
    """The engine the Greeks estimators will ACTUALLY differentiate or bump:
    ``"cuda"`` where ``resolve_implementation`` runs it for (GBM, PSEUDO,
    TERMINAL, log-Euler), flat or curved (kernel #1 or #2 forward, the
    pathwise rule backward); ``"xla"`` otherwise. A ``"pallas"`` sim raises."""
    _refuse_pallas(sim)
    if (
        resolve_implementation(sim) == SimImplementation.CUDA
        and sim.sampling == SamplingKind.PSEUDO
        and sim.model == ModelKind.GBM
        and sim.payoff == PayoffKind.TERMINAL
        and sim.scheme == PathScheme.LOG_EULER
    ):
        return SimImplementation.CUDA
    return SimImplementation.XLA


def _make_raw_price_fn(
    sim: SimulationParams, *, option: OptionSide, device: torch.device | str = "cuda"
) -> PriceFn:
    """The simulate→normalize→discount mean-payoff program with no estimator
    gating, shared by the pathwise path (``make_mc_price_fn``) and the bump
    path (``bump_greeks``, ``knock_in_price``). A batch of contracts shares
    draw ``draw_index``'s key words (common random numbers) and runs in one
    simulator call. Engine per ``greeks_engine``."""
    from spectralmc_tpu_torch.ops.dispatch import make_mean_target, make_underlier_simulator
    from spectralmc_tpu_torch.ops.gbm_cuda import simulate_terminal_rows_cuda_diff

    device = resolve_device(device)
    dtype = sim.precision.to_torch()
    base_key = rng.prng_key(sim.mc_seed, device)
    normalize = sim.normalization == ForwardNormalization.MEAN
    rows = sim.batches_per_mc_run
    if greeks_engine(sim) == SimImplementation.CUDA:
        anti = rows // 2 if sim.antithetic else None

        def simulate(key_words: torch.Tensor, contracts: torch.Tensor) -> torch.Tensor:
            return simulate_terminal_rows_cuda_diff(
                contracts, key_words, timesteps=sim.timesteps, rows=rows,
                cols=sim.network_size, antithetic_half=anti, term=sim.term,
            )
    else:
        xla_sim = sim.model_copy(update={"implementation": SimImplementation.XLA})
        simulate = make_underlier_simulator(xla_sim, rows=rows)
    mean_target = make_mean_target(sim)

    def price(draw_index: int, contract: torch.Tensor) -> torch.Tensor:
        batch = contract if contract.ndim == 2 else contract[None]
        key = rng.fold_in(base_key, draw_index)
        rows_out = simulate(key.expand(batch.shape[0], 2), batch)
        prices = terminal_to_prices(
            rows_out.reshape(batch.shape[0], -1).to(dtype), batch, normalize=normalize,
            dtype=dtype, mean_target=mean_target(batch), term=sim.term,
        )
        payoffs = prices.put_payoffs if option == OptionSide.PUT else prices.call_payoffs
        means = torch.mean(payoffs, dim=1)
        return means if contract.ndim == 2 else means[0]

    return price


def _value_and_grad(price_fn: PriceFn, draw_index: int,
                    contract: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = contract.detach().clone().requires_grad_(True)
    value = price_fn(draw_index, x)
    (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


def make_mc_greeks_fn(
    sim: SimulationParams,
    *,
    option: OptionSide,
    gamma_rel_bump: float = 1e-2,
    device: torch.device | str = "cuda",
) -> GreeksFn:
    """(draw_index, contract ``[D]``) → (price, grad ``[D]``, gamma).

    gamma = (Δ(S₀(1+h)) − Δ(S₀(1−h))) / (2·h·S₀) with the SAME key — the
    central difference of the pathwise delta under common random numbers.
    Three differentiated simulator calls (base, up, down): three launches on
    the ``"cuda"`` engine. Bias is O(h²) plus a kink-crossing term that
    vanishes with the path count; ``gamma_rel_bump`` trades them.
    """
    price_fn = make_mc_price_fn(sim, option=option, device=device)

    def run(draw_index: int, contract: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        price, grad = _value_and_grad(price_fn, draw_index, contract)
        h = gamma_rel_bump * contract[0]
        bump = torch.zeros_like(contract)
        bump[0] = h
        delta_up = _value_and_grad(price_fn, draw_index, contract + bump)[1][0]
        delta_dn = _value_and_grad(price_fn, draw_index, contract - bump)[1][0]
        gamma = (delta_up - delta_dn) / (2.0 * h)
        return price, grad, gamma

    return run


def _fields(sim: SimulationParams) -> tuple[str, ...]:
    from spectralmc_tpu_torch.ops.dispatch import contract_class

    return tuple(contract_class(sim).model_fields.keys())


def _to_greeks(sim: SimulationParams, price: torch.Tensor, grad: torch.Tensor,
               gamma: torch.Tensor) -> MCGreeks:
    """One device→host copy of ``[price, grad…, gamma]``."""
    host = torch.cat([price.reshape(1), grad.to(price.dtype), gamma.reshape(1).to(price.dtype)]
                     ).tolist()
    return MCGreeks(price=host[0], by_field=dict(zip(_fields(sim), host[1:-1])),
                    gamma=host[-1], engine=greeks_engine(sim))


def mc_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    gamma_rel_bump: float = 1e-2,
    device: torch.device | str = "cuda",
) -> MCGreeks:
    """Pathwise MC Greeks for one contract (any ModelKind; any non-indicator
    payoff kind — knockouts and the digital are refused, ``make_mc_price_fn``).

    ``contract`` is a ``BlackScholesContract`` / ``HestonContract`` /
    ``MertonContract``. ``draw_index`` defaults to the sim's ``skip``: the
    draw the pricer would consume next.

    MERTON_JUMP caveat: the Poisson counts are sampled with their rate
    detached (``ops/merton.py``), so ``by_field["lam"]`` is the fixed-count
    envelope derivative (the compensator channel, not the count channel);
    under MEAN normalization it is ≈ 0. ``bump_greeks`` gives the full lam
    sensitivity; every other Merton field is exact pathwise.
    """
    device = resolve_device(device)
    arr = contract.as_array(sim.precision.to_torch(), device)
    idx = sim.skip if draw_index is None else draw_index
    run = make_mc_greeks_fn(sim, option=option, gamma_rel_bump=gamma_rel_bump, device=device)
    return _to_greeks(sim, *run(idx, arr))


# --------------------------------------------------------------------------
# Bucketed curve Greeks — sensitivity ladders along a TermStructure
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TermBucketGreeks:
    """Per-step sensitivity ladders of one contract's MC price to the curve.

    ``vega_buckets[t] = ∂price/∂vol_shape[t]`` etc. The price depends on
    ``vol`` only through the products ``vol·vol_shape[t]``, so by Euler
    homogeneity ``Σ_t vega_buckets[t]·vol_shape[t] = vol·∂price/∂vol`` (and
    likewise rate/div) — tested against ``mc_greeks`` on the same draw.
    """

    price: float
    vega_buckets: tuple[float, ...]
    rho_buckets: tuple[float, ...]
    div_buckets: tuple[float, ...]
    engine: SimImplementation


def term_bucket_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    device: torch.device | str = "cuda",
) -> TermBucketGreeks:
    """Pathwise ladders ∂price/∂{vol,rate,div}_shape[t] for a curved-market
    GBM sim — ONE reverse pass with the curve shapes as inputs, on the
    threefry engine's normals.

    Supported payoffs: TERMINAL, the Asian kinds, VARIANCE_SWAP,
    FORWARD_START and CLIQUET (knockouts and the digital have no valid
    pathwise derivative — ``bump_greeks`` covers them; the LSMC payoffs'
    regression consumes static curves; the lookbacks carry no running
    extreme here — ``mc_greeks`` gives their scalar Greeks).
    """
    if sim.model != ModelKind.GBM:
        raise ValueError("term_bucket_greeks: curves exist for the GBM model only")
    if sim.term is None:
        raise ValueError(
            "term_bucket_greeks needs sim.term (flat markets: mc_greeks gives "
            "the scalar vega/rho)"
        )
    if sim.payoff in BARRIER_PAYOFFS or sim.payoff == PayoffKind.DIGITAL:
        raise ValueError(
            "pathwise ladders are invalid for indicator payoffs "
            f"({sim.payoff.value}); use bump_greeks on the scalar fields"
        )
    if sim.payoff in AMERICAN_PAYOFFS:
        raise ValueError(
            "curve ladders for the LSMC payoffs are unsupported (the exercise "
            "policy consumes static curves); bump the scalar fields instead"
        )
    if sim.payoff in LOOKBACK_PAYOFFS:
        raise ValueError(
            "curve ladders for the lookback kinds are not implemented (the "
            "ladder program rebuilds the payoff and carries no running "
            "extreme); mc_greeks gives the scalar greeks — IPA is valid for "
            "lookbacks — and bump_greeks covers the scalar fields"
        )
    device = resolve_device(device)
    dtype = sim.precision.to_torch()
    timesteps = sim.timesteps
    rows, cols = sim.batches_per_mc_run, sim.network_size
    arr = contract.as_array(dtype, device)
    idx = sim.skip if draw_index is None else draw_index
    key = rng.fold_in(rng.prng_key(sim.mc_seed, device), idx).reshape(1, 2)
    payoff = sim.payoff
    variance = payoff == PayoffKind.VARIANCE_SWAP
    fstart = payoff == PayoffKind.FORWARD_START
    cliquet = payoff == PayoffKind.CLIQUET
    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    m_fs = sim.forward_start_step if fstart else None
    k_cq = sim.cliquet_reset_every
    log_euler = sim.scheme == PathScheme.LOG_EULER
    normals = _normals_source(
        key, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype, row_offset=0,
        antithetic_half=rows // 2 if sim.antithetic else None, sampling=sim.sampling,
        mc_seed=sim.mc_seed,
    )
    zs = [normals(t)[0] for t in range(timesteps)]  # the contract-free normals
    spot, strike, maturity, rate, div_yield, vol = (arr[i] for i in range(6))
    n = torch.tensor(float(timesteps), dtype=dtype, device=device)
    dt = maturity / n
    sqrt_dt = torch.sqrt(dt)
    if cliquet:
        f_cq = torch.tensor(sim.cliquet_floor, dtype=dtype, device=device)
        c_cq = torch.tensor(sim.cliquet_cap, dtype=dtype, device=device)
    zeros = torch.zeros((rows, cols), dtype=dtype, device=device)

    def price(vsa: torch.Tensor, rsa: torch.Tensor, qsa: torch.Tensor) -> torch.Tensor:
        vol_t = vol * vsa
        lin = (rate * rsa - div_yield * qsa) * dt  # [T]
        acc = zeros
        if log_euler:
            drift = lin - 0.5 * vol_t * vol_t * dt
            vstep = vol_t * sqrt_dt
            x = zeros if cliquet else zeros + torch.log(spot)
            for t in range(timesteps):
                inc = drift[t] + vstep[t] * zs[t]
                if variance:
                    x = x + inc
                    acc = acc + inc * inc
                elif fstart:
                    # tail-masked log-ratio: zeros before t_m keep the sum the tail scan's
                    x = x + inc
                    acc = acc + (inc if t >= m_fs else zeros)
                elif cliquet:
                    # x carries the RUNNING PERIOD log-return (reset at boundaries)
                    x = x + inc
                    if (t + 1) % k_cq == 0:
                        acc = acc + torch.clamp(torch.exp(x) - 1.0, f_cq, c_cq)
                        x = zeros
                else:
                    x = x + inc
                    acc = acc + (x if geometric else torch.exp(x))
            terminal = torch.exp(x)
        else:
            growth = 1.0 + lin
            vstep = vol_t * sqrt_dt
            x = zeros + 1.0 if cliquet else zeros + 1.0 * spot
            for t in range(timesteps):
                g = growth[t] + vstep[t] * zs[t]
                if variance:
                    x = torch.abs(x * g)
                    inc = torch.log(torch.abs(g))
                    acc = acc + inc * inc
                elif fstart:
                    x = torch.abs(x * g)
                    acc = acc + (torch.log(torch.abs(g)) if t >= m_fs else zeros)
                elif cliquet:
                    # x carries the RUNNING PERIOD growth ratio
                    x = torch.abs(x * g)
                    if (t + 1) % k_cq == 0:
                        acc = acc + torch.clamp(x - 1.0, f_cq, c_cq)
                        x = zeros + 1.0
                else:
                    x = torch.abs(x * g)
                    acc = acc + (torch.log(x) if geometric else x)
            terminal = x
        if payoff == PayoffKind.TERMINAL:
            u = terminal
        elif variance:
            u = acc / maturity  # annualized realized variance
        elif fstart:
            u = spot * torch.exp(acc)  # spot·S_T/S_m from the tail sum
        elif cliquet:
            u = acc  # the clipped-return sum IS the underlier
        else:
            mean_acc = acc / n
            u = torch.exp(mean_acc) if geometric else mean_acc
        # the curve-consistent mean target and discount, as inputs too
        cum = torch.cumsum(lin, dim=0)
        if sim.normalization == ForwardNormalization.MEAN:
            if variance:
                a_v = lin - 0.5 * vol_t * vol_t * dt
                target = torch.sum(a_v * a_v + vol_t * vol_t * dt) / maturity
            elif fstart:
                target = spot * torch.exp(torch.sum(lin[m_fs:]))
            elif payoff == PayoffKind.TERMINAL:
                target = spot * torch.exp(cum[-1])
            elif payoff == PayoffKind.ASIAN_ARITHMETIC:
                target = spot * torch.mean(torch.exp(cum))
            else:
                w = (n - torch.arange(timesteps, dtype=dtype, device=device)) / n
                a = lin - 0.5 * vol_t * vol_t * dt
                mu = torch.log(spot) + torch.sum(a * w)
                s2 = torch.sum(vol_t * vol_t * dt * w * w)
                target = torch.exp(mu + 0.5 * s2)
            u = u * (target / torch.mean(u))
        df = torch.exp(-rate * torch.mean(rsa) * maturity)
        if option == OptionSide.PUT:
            pay = torch.clamp(strike - u, min=0.0)
        else:
            pay = torch.clamp(u - strike, min=0.0)
        return df * torch.mean(pay)

    shapes = [torch.tensor(s, dtype=dtype, device=device).requires_grad_(True)
              for s in sim.term.shapes(timesteps)]
    p = price(*shapes)
    g_v, g_r, g_q = torch.autograd.grad(p, shapes)
    host = torch.cat([p.detach().reshape(1), g_v, g_r, g_q]).tolist()
    t = timesteps
    return TermBucketGreeks(
        price=host[0], vega_buckets=tuple(host[1:1 + t]),
        rho_buckets=tuple(host[1 + t:1 + 2 * t]), div_buckets=tuple(host[1 + 2 * t:]),
        engine=SimImplementation.XLA,
    )


# --------------------------------------------------------------------------
# Bump-and-reprice Greeks — the estimator for kinked/indicator payoffs
# --------------------------------------------------------------------------


def make_bump_greeks_fn(
    sim: SimulationParams,
    *,
    option: OptionSide,
    rel_bump: float = 1e-2,
    device: torch.device | str = "cuda",
) -> GreeksFn:
    """(draw_index, contract ``[D]``) → (price, grad ``[D]``, gamma) by
    central finite differences under COMMON RANDOM NUMBERS: the 2D+1
    contracts ``[base, base + h_i e_i, base − h_i e_i]`` share draw
    ``draw_index``'s key words and run as ONE simulator call on the ``[2D+1,
    D]`` batch (one launch on the ``"cuda"`` engine), so the noise cancels to
    first order and only the payoff's own response remains.

    The estimator for payoffs whose pathwise derivative is invalid; it works
    for every (ModelKind, PayoffKind) the engines support. Bumps: ``h_i =
    rel_bump · max(|x_i|, 1e-3)``. For barriers the bias near the level is
    O(h) in the crossing probability; shrink ``rel_bump`` with the path count.
    """
    option = _check_american_side(sim, option)
    price_fn = _make_raw_price_fn(sim, option=option, device=device)
    floor = 1e-3

    @torch.no_grad()
    def run(draw_index: int, contract: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = contract.shape[0]
        h = rel_bump * torch.clamp(torch.abs(contract), min=floor)  # [D]
        bumps = torch.eye(d, dtype=contract.dtype, device=contract.device) * h[:, None]
        grid = torch.cat([contract[None, :], contract[None, :] + bumps,
                          contract[None, :] - bumps], dim=0)  # [2D+1, D]
        prices = price_fn(draw_index, grid)
        base = prices[0]
        up, dn = prices[1:d + 1], prices[d + 1:]
        grad = (up - dn) / (2.0 * h)
        gamma = (up[0] - 2.0 * base + dn[0]) / (h[0] * h[0])
        return base, grad, gamma

    return run


def bump_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    rel_bump: float = 1e-2,
    device: torch.device | str = "cuda",
) -> MCGreeks:
    """Bump-and-reprice MC Greeks for one contract — valid for EVERY payoff
    kind, the knockouts the pathwise estimator refuses included. Same
    conventions as ``mc_greeks``."""
    device = resolve_device(device)
    arr = contract.as_array(sim.precision.to_torch(), device)
    idx = sim.skip if draw_index is None else draw_index
    run = make_bump_greeks_fn(sim, option=option, rel_bump=rel_bump, device=device)
    return _to_greeks(sim, *run(idx, arr))


def knock_in_price(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    device: torch.device | str = "cuda",
) -> float:
    """Knock-IN price by in = vanilla − out on one draw.

    Every path either knocks or it doesn't, so in + out = vanilla payoff by
    payoff. ``sim.payoff`` must be a BARRIER kind; the vanilla leg prices
    TERMINAL with normalization off. Each leg's engine is its own
    ``greeks_engine``, as in the JAX package: on ``"xla"`` both legs walk the
    same threefry (contract key, row, timestep) stream, so the difference
    carries only the knocked paths' payoffs; on ``"cuda"`` the vanilla leg
    runs kernel #1's Philox stream and the knock-out leg the threefry scan,
    two independent estimates.
    """
    if sim.payoff not in BARRIER_PAYOFFS:
        raise ValueError(f"knock_in_price needs a barrier payoff; got {sim.payoff.value!r}")
    device = resolve_device(device)
    vanilla_sim = sim.model_copy(update={
        "payoff": PayoffKind.TERMINAL,
        "barrier_rel": None,
        "normalization": ForwardNormalization.NONE,
    })
    out_fn = _make_raw_price_fn(sim, option=option, device=device)
    vanilla_fn = _make_raw_price_fn(vanilla_sim, option=option, device=device)
    arr = contract.as_array(sim.precision.to_torch(), device)
    idx = sim.skip if draw_index is None else draw_index
    with torch.no_grad():
        return float(vanilla_fn(idx, arr) - out_fn(idx, arr))


# --------------------------------------------------------------------------
# Analytic oracle Greeks — autograd of the closed forms
# --------------------------------------------------------------------------

_BS_FIELDS = ("spot", "strike", "maturity", "rate", "div_yield", "vol")


def make_analytic_price_fn(
    *, option: OptionSide, payoff: PayoffKind = PayoffKind.TERMINAL, timesteps: int = 1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """contract 6-vector → exact float64 price (TERMINAL Black or geometric Asian)."""
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        raise ValueError("arithmetic Asian has no closed form; use mc_greeks")

    def price(contract: torch.Tensor) -> torch.Tensor:
        args = tuple(contract[i] for i in range(6))
        if payoff == PayoffKind.TERMINAL:
            prices = black_scholes_price(*args)
        else:
            prices = geometric_asian_price(*args, timesteps=timesteps)
        return prices.put if option == OptionSide.PUT else prices.call

    return price


def analytic_greeks(
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    payoff: PayoffKind = PayoffKind.TERMINAL,
    timesteps: int = 1,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> MCGreeks:
    """Exact Greeks of the closed-form price by autograd (+ gamma = ∂²/∂S₀²).

    Shares ``MCGreeks``' field conventions with the MC estimators because
    both differentiate the same 6-vector. The closed forms compute in
    float64 whatever ``dtype`` the contract vector is built in.
    """
    device = resolve_device(device)
    price_fn = make_analytic_price_fn(option=option, payoff=payoff, timesteps=timesteps)
    x = contract.as_array(dtype, device).requires_grad_(True)
    price = price_fn(x)
    (grad,) = torch.autograd.grad(price, x, create_graph=True)
    (second,) = torch.autograd.grad(grad[0], x)
    host = torch.cat([price.detach().reshape(1), grad.detach().to(price.dtype),
                      second[0].reshape(1).to(price.dtype)]).tolist()
    return MCGreeks(price=host[0], by_field=dict(zip(_BS_FIELDS, host[1:7])), gamma=host[7],
                    engine=SimImplementation.XLA)


__all__ = [
    "MCGreeks",
    "TermBucketGreeks",
    "term_bucket_greeks",
    "greeks_engine",
    "knock_in_price",
    "OptionSide",
    "analytic_greeks",
    "bump_greeks",
    "make_analytic_price_fn",
    "make_bump_greeks_fn",
    "make_mc_greeks_fn",
    "make_mc_price_fn",
    "mc_greeks",
]
