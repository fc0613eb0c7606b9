"""Heston stochastic-volatility dynamics on torch tensors (the JAX package's
``ops/heston.py``).

    dS = (r − q) S dt + sqrt(v) S dW_s
    dv = kappa (theta − v) dt + xi sqrt(v) dW_v,   d<W_s, W_v> = rho dt.

Discretization: full-truncation Euler (Lord et al. 2010) — v is floored at
zero inside drift and diffusion only, the RAW v stays the base of the
recursion, which keeps the scheme robust when the Feller condition
2·kappa·theta >= xi² fails.

This module holds the contract model, the threefry (``"xla"``) simulator for
a batch of contracts, the analytic means and the semi-analytic European
oracle (``heston_call_price``, the "little Heston trap" characteristic
function of Albrecher et al. 2007). The ``"cuda"`` engine's kernel and twin
live in ``ops/dynamics_cuda.py``.

Determinism: normals are addressed by (contract key, global row, timestep,
component) — component 0 drives the variance, 1 the orthogonal part of the
spot — so resume is a counter and a row shard reproduces exactly its rows.
With ``sampling=SOBOL_BB`` the two components are the two factors of the
Brownian-bridge Sobol net (``ops/qmc.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors.gbm import GBMError, InvalidContract
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops.gbm import (
    BARRIER_PAYOFFS,
    LOOKBACK_MAX_PAYOFFS,
    LOOKBACK_PAYOFFS,
    PayoffKind,
    SamplingKind,
    TermStructure,
    curved,
    lookback_underlier,
    row_keys,
    term_tensors,
)


class HestonContract(BaseModel):
    """One Heston market scenario: the 5 shared market fields (same order as
    ``BlackScholesContract``) + 5 variance-dynamics fields."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    spot: float
    strike: float
    maturity: float
    rate: float
    div_yield: float
    v0: float  # initial variance
    kappa: float  # mean-reversion speed
    theta: float  # long-run variance
    xi: float  # vol of vol
    rho: float  # spot-variance correlation

    def as_array(
        self, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"
    ) -> torch.Tensor:
        """The vector in field order, on ``device``."""
        return torch.tensor([getattr(self, f) for f in type(self).model_fields],
                            dtype=dtype, device=device)


HESTON_CONTRACT_FIELDS: tuple[str, ...] = tuple(HestonContract.model_fields.keys())
HESTON_CONTRACT_DIM = len(HESTON_CONTRACT_FIELDS)


def validate_heston_contract(c: HestonContract) -> Result[HestonContract, GBMError]:
    for field in ("spot", "strike", "maturity", "v0", "kappa", "theta", "xi"):
        if getattr(c, field) <= 0:
            return Failure(
                InvalidContract(field=field, value=getattr(c, field), reason="must be > 0")
            )
    if not -1.0 < c.rho < 1.0:
        return Failure(InvalidContract(field="rho", value=c.rho, reason="must be in (-1, 1)"))
    return Success(c)


def heston_component_normals(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    t: int,
    comp: int,
    cols: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One component's normals ``[..., cols]`` for row keys ``[..., 2]``,
    keyed (row key, timestep, component): THE Heston stream definition.
    Antithetic flips BOTH components (negating a 2D Gaussian is a valid pair
    and preserves the spot-variance correlation)."""
    z = rng.normal(rng.fold_in(rng.fold_in(keys, t), comp), (cols,), dtype)
    return z if sign is None else sign * z


def heston_euler_step(
    logx: torch.Tensor,
    v: torch.Tensor,
    z_v: torch.Tensor,
    z_orth: torch.Tensor,
    *,
    rate: torch.Tensor,
    div_yield: torch.Tensor,
    dt: torch.Tensor,
    sqrt_dt: torch.Tensor,
    rho: torch.Tensor,
    rho_bar: torch.Tensor,
    kappa: torch.Tensor,
    theta: torch.Tensor,
    xi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE full-truncation Euler step — the single source of the recursion."""
    v_plus = torch.clamp(v, min=0.0)
    sqrt_v = torch.sqrt(v_plus)
    z_s = rho * z_v + rho_bar * z_orth
    logx = logx + (rate - div_yield - 0.5 * v_plus) * dt + sqrt_v * sqrt_dt * z_s
    v = v + kappa * (theta - v_plus) * dt + xi * sqrt_v * sqrt_dt * z_v
    return logx, v


def simulate_heston_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
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
    """Payoff underliers ``[C, rows, cols]`` under full-truncation Euler
    Heston on the threefry stream (or, with ``sampling=SOBOL_BB``, on two
    factors of the QMC generator seeded by ``mc_seed``), for a batch of
    contracts.

    ``contracts`` is ``[C, 10]`` in ``HestonContract`` field order and
    ``contract_keys`` ``[C, 2]`` threefry words. Barrier kinds knock on the
    discrete spot grid and emit the strike on knocked paths; the forward
    start walks the full path and captures ``ln S_m`` (the variance state
    couples ``S_m`` to the tail); the cliquet tracks the period-start
    ``ln S``. ``term`` carries rate and dividend curves (vol curves are
    refused at config time: the instantaneous vol IS the variance process);
    a flat term is no term. Follows the JAX package's scan op for op.
    """
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, v0, kappa, theta, xi, rho = (
        c[:, i, None, None] for i in range(10)
    )
    term = curved(term)
    n = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    dt = maturity / n
    sqrt_dt = torch.sqrt(dt)
    rho_bar = torch.sqrt(1.0 - rho * rho)
    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu_torch.ops.qmc import qmc_effective_normals_multi

        if antithetic_half is not None:
            raise ValueError("SOBOL_BB sampling takes no antithetic mirroring")
        zq = qmc_effective_normals_multi(
            contract_keys, timesteps=timesteps, factors=2, rows=rows, cols=cols, dtype=dtype,
            mc_seed=mc_seed, row_offset=row_offset,
        )
        component = lambda t, comp: zq[:, t, comp]  # noqa: E731
    else:
        keys, sign = row_keys(
            contract_keys, rows=rows, row_offset=row_offset, antithetic_half=antithetic_half,
            dtype=dtype,
        )
        component = lambda t, comp: heston_component_normals(  # noqa: E731
            keys, sign, t, comp, cols, dtype)
    consts = dict(dt=dt, sqrt_dt=sqrt_dt, rho=rho, rho_bar=rho_bar, kappa=kappa, theta=theta,
                  xi=xi)
    if term is None:
        rate_at = lambda t: rate  # noqa: E731
        div_at = lambda t: div_yield  # noqa: E731
    else:
        _, rsa, qsa = term_tensors(term, timesteps, dtype, c.device)
        rate_arr, div_arr = rate[..., None] * rsa, div_yield[..., None] * qsa
        rate_at = lambda t: rate_arr[..., t]  # noqa: E731
        div_at = lambda t: div_arr[..., t]  # noqa: E731

    def step(t: int, logx: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return heston_euler_step(logx, v, component(t, 0), component(t, 1), rate=rate_at(t),
                                 div_yield=div_at(t),
                                 **consts)

    shape = (c.shape[0], rows, cols)
    log0 = torch.zeros(shape, dtype=dtype, device=c.device) + torch.log(spot)
    v = torch.ones(shape, dtype=dtype, device=c.device) * v0
    zeros = torch.zeros(shape, dtype=dtype, device=c.device)
    logx = log0

    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=c.device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=c.device)
        start, acc = log0, zeros
        for t in range(timesteps):
            logx, v = step(t, logx, v)
            if (t + 1) % cliquet_reset_every == 0:
                acc = acc + torch.clamp(torch.exp(logx - start) - 1.0, floor_c, cap_c)
                start = logx
        return acc

    barrier = payoff in BARRIER_PAYOFFS
    lookback = payoff in LOOKBACK_PAYOFFS
    track_extreme = barrier or lookback
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    variance = payoff == PayoffKind.VARIANCE_SWAP
    forward_start = payoff == PayoffKind.FORWARD_START
    if forward_start and forward_start_step is None:
        raise ValueError("payoff='forward_start' requires forward_start_step")
    acc = log0 if track_extreme else zeros
    for t in range(timesteps):
        prev = logx
        logx, v = step(t, logx, v)
        if track_extreme:
            acc = torch.maximum(acc, logx) if up else torch.minimum(acc, logx)
        elif variance:
            inc = logx - prev
            acc = acc + inc * inc
        elif forward_start:
            if t == forward_start_step - 1:
                acc = logx  # ln S_m: the state after step m−1
        elif payoff not in (PayoffKind.TERMINAL, PayoffKind.DIGITAL):
            acc = acc + (logx if geometric else torch.exp(logx))
    if barrier:
        if barrier_rel is None:
            raise ValueError(f"payoff={payoff.value!r} requires barrier_rel")
        level = torch.log(spot * torch.tensor(barrier_rel, dtype=dtype, device=c.device))
        knocked = acc >= level if up else acc <= level
        return torch.where(knocked, strike, torch.exp(logx))
    if lookback:
        return lookback_underlier(payoff, strike, torch.exp(acc), torch.exp(logx))
    if payoff == PayoffKind.DIGITAL:
        return strike + torch.sign(torch.exp(logx) - strike)
    if payoff == PayoffKind.TERMINAL:
        return torch.exp(logx)
    if variance:
        return acc / maturity
    if forward_start:
        return spot * torch.exp(logx - acc)
    mean = acc / n
    return torch.exp(mean) if geometric else mean


def martingale_underlier_mean(
    contracts: torch.Tensor,
    *,
    timesteps: int,
    payoff: PayoffKind,
    dtype: torch.dtype,
    forward_start_step: int | None = None,
    term: TermStructure | None = None,
) -> torch.Tensor | None:
    """E[underlier] ``[..., D] -> [...]`` for the payoffs whose mean follows
    from the discounted spot being a per-step martingale alone — TERMINAL,
    the arithmetic Asian and forward start — under any dynamics that keeps
    it one (Heston's full-truncation step, Merton's compensator); None for
    every other payoff. With rate/div curves the drift integral is the
    per-step cumulative sum; a flat term takes the flat formulas bit for bit.
    """
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield = (c[..., i] for i in range(5))
    term = curved(term)
    n = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    dt = maturity / n
    if payoff == PayoffKind.FORWARD_START and forward_start_step is None:
        raise ValueError("payoff='forward_start' requires forward_start_step")
    if term is not None:
        _, rsa, qsa = term_tensors(term, timesteps, dtype, c.device)
        lin = (rate[..., None] * rsa - div_yield[..., None] * qsa) * dt[..., None]
        cum_lin = torch.cumsum(lin, dim=-1)
        if payoff == PayoffKind.TERMINAL:
            return spot * torch.exp(cum_lin[..., -1])
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            return spot * torch.mean(torch.exp(cum_lin), dim=-1)
        if payoff == PayoffKind.FORWARD_START:
            return spot * torch.exp(torch.sum(lin[..., forward_start_step:], dim=-1))
        return None
    if payoff == PayoffKind.TERMINAL:
        return spot * torch.exp((rate - div_yield) * maturity)
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        g = torch.exp((rate - div_yield) * dt)
        series = torch.where(torch.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
        return spot * series / n
    if payoff == PayoffKind.FORWARD_START:
        n_tail = torch.tensor(float(timesteps - forward_start_step), dtype=dtype, device=c.device)
        return spot * torch.exp((rate - div_yield) * dt * n_tail)
    return None


def heston_expected_underlier_mean(
    contracts: torch.Tensor,
    *,
    timesteps: int,
    payoff: PayoffKind,
    dtype: torch.dtype,
    forward_start_step: int | None = None,
    term: TermStructure | None = None,
) -> torch.Tensor | None:
    """Analytic E[underlier] ``[..., 10] -> [...]``, or None when no closed
    form exists: E[S_t] = S·e^{(r−q)t} holds under Heston (and the
    full-truncation step keeps E[e^{Δln S}|F] = e^{(r_t−q_t)dt}), so
    TERMINAL, the arithmetic Asian and forward start have one; the geometric
    average, the digital, the variance swap and the cliquet do not."""
    return martingale_underlier_mean(
        contracts, timesteps=timesteps, payoff=payoff, dtype=dtype,
        forward_start_step=forward_start_step, term=term,
    )


# --------------------------------------------------------------------------
# Semi-analytic oracle (host-side, float64 numpy — test/validation path)
# --------------------------------------------------------------------------


def heston_char_fn(
    u: np.ndarray,
    *,
    spot: float,
    maturity: float,
    rate: float,
    div_yield: float,
    v0: float,
    kappa: float,
    theta: float,
    xi: float,
    rho: float,
) -> np.ndarray:
    """phi(u) = E[exp(i·u·ln S_T)], the 'little Heston trap' branch."""
    u = np.asarray(u, dtype=np.complex128)
    iu = 1j * u
    alpha = kappa - rho * xi * iu
    d = np.sqrt(alpha * alpha + xi * xi * (iu + u * u))
    g = (alpha - d) / (alpha + d)
    exp_dt = np.exp(-d * maturity)
    log_s_fwd = np.log(spot) + (rate - div_yield) * maturity
    c_term = (kappa * theta / (xi * xi)) * (
        (alpha - d) * maturity - 2.0 * np.log((1.0 - g * exp_dt) / (1.0 - g))
    )
    d_term = ((alpha - d) / (xi * xi)) * (1.0 - exp_dt) / (1.0 - g * exp_dt)
    return np.exp(iu * log_s_fwd + c_term + v0 * d_term)


def heston_call_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    v0: float,
    kappa: float,
    theta: float,
    xi: float,
    rho: float,
    integration_points: int = 2048,
    u_max: float = 200.0,
) -> tuple[float, float]:
    """(call, put) by Fourier inversion of the characteristic function.

    P_j = 1/2 + (1/pi) ∫₀^∞ Re[e^{−iu·lnK} φ_j(u) / (iu)] du with
    φ₂ = φ and φ₁(u) = φ(u − i)/φ(−i); Gauss-Legendre on (0, u_max].
    """
    params = dict(
        spot=spot, maturity=maturity, rate=rate, div_yield=div_yield,
        v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho,
    )
    nodes, weights = np.polynomial.legendre.leggauss(integration_points)
    u = 0.5 * u_max * (nodes + 1.0)
    w = 0.5 * u_max * weights
    ln_k = np.log(strike)

    phi = heston_char_fn(u, **params)
    phi_shift = heston_char_fn(u - 1j, **params)
    phi_minus_i = heston_char_fn(np.array([-1j]), **params)[0]

    integrand_2 = np.real(np.exp(-1j * u * ln_k) * phi / (1j * u))
    integrand_1 = np.real(np.exp(-1j * u * ln_k) * phi_shift / (1j * u * phi_minus_i))
    p1 = 0.5 + (w @ integrand_1) / np.pi
    p2 = 0.5 + (w @ integrand_2) / np.pi

    df_r = np.exp(-rate * maturity)
    df_q = np.exp(-div_yield * maturity)
    call = float(spot * df_q * p1 - strike * df_r * p2)
    put = float(call - df_q * spot + df_r * strike)  # parity
    return call, put
