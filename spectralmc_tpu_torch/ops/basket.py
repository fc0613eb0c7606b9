"""Multi-asset correlated-GBM baskets on torch tensors (the JAX package's
``ops/basket.py``).

``A`` correlated GBMs driven by Cholesky-mixed normals; the option is
written on the weighted arithmetic basket ``Σ wᵢ Sᵢ`` (the traded
instrument) or the geometric basket ``Π Sᵢ^wᵢ``, whose European price has an
exact closed form under log-Euler (``ops/analytic.py::geometric_basket_price``),
which makes it the sharp oracle.

The contract keeps the six Black–Scholes fields; the basket structure
(weights, per-asset spot and vol multipliers, correlation, combine) is a
static ``BasketSpec`` on ``SimulationParams``: asset ``a`` starts at
``spot·spot_multipliers[a]`` with vol ``vol·vol_multipliers[a]``.

This module holds the spec, the threefry (``"xla"``) simulator for a batch of
contracts and the analytic means; the ``"cuda"`` engine's kernel and twin
live in ``ops/basket_cuda.py``. The asset axis leads every state tensor
(``[A, C, rows, cols]``), as the JAX package's ``[A, rows, cols]`` does.

Determinism: normals are addressed by (contract key, global row, timestep,
asset), so resume is a counter and a row shard reproduces exactly its rows.
"""

from __future__ import annotations

import enum
import math
from functools import lru_cache

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors.gbm import GBMError, InvalidSimulationParams
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops import rng


class BasketCombine(enum.Enum):
    ARITHMETIC = "arithmetic"  # Σ wᵢ Sᵢ, the traded basket
    GEOMETRIC = "geometric"  # Π Sᵢ^wᵢ, lognormal, exact closed form


class BasketSpec(BaseModel):
    """Static basket structure (part of the checkpoint via SimulationParams)."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    weights: tuple[float, ...]
    spot_multipliers: tuple[float, ...]
    vol_multipliers: tuple[float, ...]
    correlation: tuple[tuple[float, ...], ...]
    combine: BasketCombine = BasketCombine.ARITHMETIC

    @property
    def n_assets(self) -> int:
        return len(self.weights)


def _refuse(field: str, value: object, reason: str) -> Failure:
    return Failure(InvalidSimulationParams(field=field, value=value, reason=reason))


def build_basket_spec(
    *,
    weights: tuple[float, ...] | list[float],
    correlation: tuple[tuple[float, ...], ...] | list[list[float]],
    spot_multipliers: tuple[float, ...] | list[float] | None = None,
    vol_multipliers: tuple[float, ...] | list[float] | None = None,
    combine: BasketCombine | str = BasketCombine.ARITHMETIC,
) -> Result[BasketSpec, GBMError]:
    """Validated constructor: weights positive and summing to 1, correlation
    symmetric positive definite with a unit diagonal, multipliers positive of
    the right length (default 1.0). Refusals carry the JAX package's fields
    and reasons."""
    w = tuple(float(x) for x in weights)
    n = len(w)
    if n < 1:
        return _refuse("weights", w, "need >= 1 asset")
    if any(x <= 0 for x in w):
        return _refuse("weights", w, "must be positive")
    if abs(sum(w) - 1.0) > 1e-9:
        return _refuse("weights", w, "must sum to 1")
    sm = tuple(float(x) for x in (spot_multipliers or (1.0,) * n))
    vm = tuple(float(x) for x in (vol_multipliers or (1.0,) * n))
    for name, t in (("spot_multipliers", sm), ("vol_multipliers", vm)):
        if len(t) != n:
            return _refuse(name, t, f"length must be {n}")
        if any(x <= 0 for x in t):
            return _refuse(name, t, "must be positive")
    corr = tuple(tuple(float(x) for x in row) for row in correlation)
    if len(corr) != n or any(len(r) != n for r in corr):
        return _refuse("correlation", corr, f"must be {n}x{n}")
    c = np.asarray(corr, dtype=np.float64)
    if not np.allclose(c, c.T, atol=1e-12):
        return _refuse("correlation", corr, "must be symmetric")
    if not np.allclose(np.diag(c), 1.0, atol=1e-12):
        return _refuse("correlation", corr, "diagonal must be 1")
    try:
        np.linalg.cholesky(c)
    except np.linalg.LinAlgError:
        return _refuse("correlation", corr, "must be positive definite")
    if isinstance(combine, str):
        try:
            combine = BasketCombine(combine)
        except ValueError:
            return _refuse("combine", combine, "arithmetic|geometric")
    return Success(BasketSpec(weights=w, spot_multipliers=sm, vol_multipliers=vm,
                              correlation=corr, combine=combine))


@lru_cache(maxsize=64)
def basket_cholesky(spec: BasketSpec) -> np.ndarray:
    """Lower Cholesky factor of the correlation (float64 on the host, computed once)."""
    return np.linalg.cholesky(np.asarray(spec.correlation, dtype=np.float64))


def basket_component_normals(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    t: int,
    a_n: int,
    cols: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """``[A, ..., cols]`` iid draws for row keys ``[..., 2]``, keyed (row
    key, timestep, asset): THE basket stream definition. Antithetic flips the
    whole A-dimensional Gaussian (a valid pair, the correlation intact)."""
    kt = rng.fold_in(keys, t)
    z = torch.stack([rng.normal(rng.fold_in(kt, a), (cols,), dtype) for a in range(a_n)])
    return z if sign is None else sign * z


def basket_euler_step(
    logx: torch.Tensor,
    z: torch.Tensor,
    *,
    drift: torch.Tensor,
    sig_sqdt: torch.Tensor,
    chol: torch.Tensor,
) -> torch.Tensor:
    """ONE log-Euler step for all assets, the single source of the recursion.
    ``z`` is the pre-mix ``[A, ...]`` Gaussian, ``drift`` and ``sig_sqdt``
    broadcast against it, ``chol`` is ``[A, A]``."""
    mixed = torch.tensordot(chol, z, dims=([1], [0]))
    return logx + drift + sig_sqdt * mixed


def _spec_tensor(values: tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``[A, 1, 1, 1]``: a per-asset vector broadcastable against ``[A, C, rows, cols]``."""
    return torch.tensor(values, dtype=dtype, device=device)[:, None, None, None]


def simulate_basket_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    payoff: object,
    row_offset: int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    sampling: object | None = None,
    mc_seed: int = 0,
    term: object | None = None,
) -> torch.Tensor:
    """Basket-payoff underliers ``[C, rows, cols]`` under log-Euler dynamics
    on the threefry stream, for a batch of contracts.

    ``contracts`` is ``[C, 6]`` and ``contract_keys`` ``[C, 2]`` threefry
    words. Normals keyed by (contract key, global row, timestep, asset) are
    Cholesky-mixed along the asset axis each step; with
    ``sampling=SamplingKind.SOBOL_BB`` the pre-mix normals come from the
    ``A``-factor Brownian-bridge Sobol net (``ops/qmc.py``). Extremes,
    averages, the variance, the forward-start ratio and the cliquet's period
    returns all follow the BASKET value (the combine). A curved ``term``
    scales every asset's vol by the same per-step factor; a flat term is no
    term. Follows the JAX package's scan op for op.
    """
    from spectralmc_tpu_torch.ops.gbm import (
        BARRIER_PAYOFFS,
        LOOKBACK_MAX_PAYOFFS,
        LOOKBACK_PAYOFFS,
        PayoffKind,
        SamplingKind,
        curved,
        lookback_underlier,
        row_keys,
        term_tensors,
    )

    a_n = spec.n_assets
    device = contracts.device
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    n = torch.tensor(float(timesteps), dtype=dtype, device=device)
    dt = maturity / n
    sqrt_dt = torch.sqrt(dt)
    weights = _spec_tensor(spec.weights, dtype, device)
    sigmas = vol * _spec_tensor(spec.vol_multipliers, dtype, device)  # [A, C, 1, 1]
    spots = spot * _spec_tensor(spec.spot_multipliers, dtype, device)
    chol = torch.as_tensor(basket_cholesky(spec), dtype=dtype, device=device)
    term = curved(term)
    if term is None:
        drift = (rate - div_yield - 0.5 * sigmas * sigmas) * dt
        sig_sqdt = sigmas * sqrt_dt
        drift_at = lambda t: drift  # noqa: E731
        sig_sqdt_at = lambda t: sig_sqdt  # noqa: E731
    else:
        vsa, rsa, qsa = term_tensors(term, timesteps, dtype, device)
        sig_t = sigmas[..., None] * vsa  # [A, C, 1, 1, T]
        drift_arr = (rate[..., None] * rsa - div_yield[..., None] * qsa
                     - 0.5 * sig_t * sig_t) * dt[..., None]
        sig_sqdt_arr = sig_t * sqrt_dt[..., None]
        drift_at = lambda t: drift_arr[..., t]  # noqa: E731
        sig_sqdt_at = lambda t: sig_sqdt_arr[..., t]  # noqa: E731

    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu_torch.ops.qmc import qmc_effective_normals_multi

        if antithetic_half is not None:
            raise ValueError("SOBOL_BB sampling takes no antithetic mirroring")
        zq = qmc_effective_normals_multi(
            contract_keys, timesteps=timesteps, factors=a_n, rows=rows, cols=cols, dtype=dtype,
            mc_seed=mc_seed, row_offset=row_offset,
        )  # [C, T, A, rows, cols]
        normals = lambda t: zq[:, t].movedim(1, 0)  # noqa: E731
    else:
        keys, sign = row_keys(contract_keys, rows=rows, row_offset=row_offset,
                              antithetic_half=antithetic_half, dtype=dtype)
        normals = lambda t: basket_component_normals(keys, sign, t, a_n, cols, dtype)  # noqa: E731

    def step(t: int, logx: torch.Tensor) -> torch.Tensor:
        return basket_euler_step(logx, normals(t), drift=drift_at(t), sig_sqdt=sig_sqdt_at(t),
                                 chol=chol)

    def basket_value(logx: torch.Tensor) -> torch.Tensor:
        if spec.combine == BasketCombine.GEOMETRIC:
            return torch.exp(torch.sum(weights * logx, dim=0))
        return torch.sum(weights * torch.exp(logx), dim=0)

    def log_basket(logx: torch.Tensor) -> torch.Tensor:
        if spec.combine == BasketCombine.GEOMETRIC:
            return torch.sum(weights * logx, dim=0)
        return torch.log(torch.sum(weights * torch.exp(logx), dim=0))

    shape = (c.shape[0], rows, cols)
    log0 = torch.zeros((a_n, *shape), dtype=dtype, device=device) + torch.log(spots)
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    logx = log0

    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=device)
        start, acc = log_basket(log0), zeros
        for t in range(timesteps):
            logx = step(t, logx)
            if (t + 1) % cliquet_reset_every == 0:
                lb = log_basket(logx)
                acc = acc + torch.clamp(torch.exp(lb - start) - 1.0, floor_c, cap_c)
                start = lb
        return acc
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None:
            raise ValueError("payoff='forward_start' requires forward_start_step")
        b0 = log_basket(log0)
        cap = b0
        for t in range(timesteps):
            logx = step(t, logx)
            if t == forward_start_step - 1:
                cap = log_basket(logx)
        return torch.exp(b0 + log_basket(logx) - cap)  # u = B₀·B_T/B_m
    if payoff == PayoffKind.VARIANCE_SWAP:
        prev, acc = log_basket(log0), zeros
        for t in range(timesteps):
            logx = step(t, logx)
            lb = log_basket(logx)
            inc = lb - prev
            prev, acc = lb, acc + inc * inc
        return acc / maturity

    barrier = payoff in BARRIER_PAYOFFS
    lookback = payoff in LOOKBACK_PAYOFFS
    track_extreme = barrier or lookback
    terminal = payoff in (PayoffKind.TERMINAL, PayoffKind.DIGITAL)
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    geometric_time = payoff == PayoffKind.ASIAN_GEOMETRIC
    acc = basket_value(log0) if track_extreme else zeros
    for t in range(timesteps):
        logx = step(t, logx)
        if track_extreme:
            acc = torch.maximum(acc, basket_value(logx)) if up else torch.minimum(
                acc, basket_value(logx))
        elif not terminal:
            value = basket_value(logx)
            acc = acc + (torch.log(value) if geometric_time else value)
    if barrier:
        if barrier_rel is None:
            raise ValueError(f"payoff={payoff.value!r} requires barrier_rel")
        level = basket_value(log0)[:, :1, :1] * torch.tensor(barrier_rel, dtype=dtype,
                                                              device=device)
        knocked = acc >= level if up else acc <= level
        return torch.where(knocked, strike, basket_value(logx))
    if lookback:
        return lookback_underlier(payoff, strike, acc, basket_value(logx))
    if payoff == PayoffKind.DIGITAL:
        return strike + torch.sign(basket_value(logx) - strike)
    if terminal:
        return basket_value(logx)
    mean = acc / n
    return torch.exp(mean) if geometric_time else mean


# --------------------------------------------------------------------------
# Analytic moments and means
# --------------------------------------------------------------------------


def basket_log_moments(
    contracts: torch.Tensor, spec: BasketSpec, *, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """(μ̄, s̄²) ``[...]`` per contract ``[..., 6]``: the per-unit-time drift and
    variance of ln(geometric basket). ln B_t = Σ wᵢ ln Sᵢ(t) is Gaussian with
    mean ln G₀ + μ̄·t and variance s̄²·t, where μ̄ = (r−q) − Σwᵢσᵢ²/2 and
    s̄² = wᵀΣw (Σᵢⱼ = σᵢσⱼρᵢⱼ), exactly under log-Euler on the grid."""
    c = contracts.to(dtype)
    rate, div_yield, vol = c[..., 3], c[..., 4], c[..., 5]
    w = torch.tensor(spec.weights, dtype=dtype, device=c.device)
    sig = vol[..., None] * torch.tensor(spec.vol_multipliers, dtype=dtype, device=c.device)
    corr = torch.tensor(spec.correlation, dtype=dtype, device=c.device)
    mu_bar = (rate - div_yield) - 0.5 * torch.sum(w * sig * sig, dim=-1)
    cov = corr * sig[..., :, None] * sig[..., None, :]
    s2_bar = torch.einsum("a,...ab,b->...", w, cov, w)
    return mu_bar, s2_bar


def basket_g0(contracts: torch.Tensor, spec: BasketSpec, *, dtype: torch.dtype) -> torch.Tensor:
    """Π (S0ᵢ)^{wᵢ} ``[...]``: the geometric basket's initial level."""
    spot = contracts.to(dtype)[..., 0]
    w = torch.tensor(spec.weights, dtype=dtype, device=contracts.device)
    spots = spot[..., None] * torch.tensor(spec.spot_multipliers, dtype=dtype,
                                           device=contracts.device)
    return torch.exp(torch.sum(w * torch.log(spots), dim=-1))


def geometric_basket_effective_gbm(
    contract: torch.Tensor, spec: BasketSpec, *, dtype: torch.dtype = torch.float64
) -> tuple[float, float, float]:
    """(G₀, σ_eff, δ_eff) of one contract ``[6]``: the single-asset GBM the
    geometric basket IS (vol s̄, dividend yield r − μ̄ − s̄²/2), so any
    single-asset oracle prices its claims exactly."""
    rate = float(contract[3])
    mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
    g0 = basket_g0(contract, spec, dtype=dtype)
    vol_eff = float(torch.sqrt(s2_bar))
    div_eff = rate - float(mu_bar) - 0.5 * float(s2_bar)
    return float(g0), vol_eff, div_eff


def expected_basket_underlier_mean(
    contracts: torch.Tensor,
    spec: BasketSpec,
    *,
    timesteps: int,
    payoff: object,
    dtype: torch.dtype,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    term: object | None = None,
) -> torch.Tensor | None:
    """Analytic E[underlier] ``[..., 6] -> [...]``, or None without a closed form.

    Arithmetic combine: E[Σ wᵢ Sᵢ(t)] = (Σ wᵢ S0ᵢ)·e^{(r−q)t}, the GBM
    formulas scaled by the weighted spot, for TERMINAL and the arithmetic
    Asian; None for every other kind. Geometric combine: B_t is lognormal (an
    effective GBM), so every non-extreme kind has one. Under curves the
    per-step sums replace the flat products (the shared vol curve scales
    every asset's vol, so the geometric combine's log moments scale simply).
    """
    from spectralmc_tpu_torch.ops.gbm import (
        AMERICAN_PAYOFFS,
        BARRIER_PAYOFFS,
        LOOKBACK_PAYOFFS,
        PayoffKind,
        curved,
        expected_clipped_lognormal_return,
        term_tensors,
    )

    if payoff in BARRIER_PAYOFFS or payoff in AMERICAN_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        return None
    c = contracts.to(dtype)
    device = c.device
    spot, strike, maturity, rate, div_yield = (c[..., i] for i in range(5))
    n = torch.tensor(float(timesteps), dtype=dtype, device=device)
    dt = maturity / n
    term = curved(term)
    arithmetic = spec.combine == BasketCombine.ARITHMETIC
    w = torch.tensor(spec.weights, dtype=dtype, device=device)
    cliquet_args = (cliquet_reset_every, cliquet_floor, cliquet_cap)
    if payoff == PayoffKind.CLIQUET and any(x is None for x in cliquet_args):
        raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
    if payoff == PayoffKind.FORWARD_START and forward_start_step is None:
        raise ValueError("payoff='forward_start' requires forward_start_step")
    if arithmetic:
        s0 = torch.sum(w * spot[..., None] * torch.tensor(spec.spot_multipliers, dtype=dtype,
                                                           device=device), dim=-1)
        if term is not None:
            _, rsa, qsa = term_tensors(term, timesteps, dtype, device)
            cum_lin = torch.cumsum((rate[..., None] * rsa - div_yield[..., None] * qsa)
                                   * dt[..., None], dim=-1)
            if payoff == PayoffKind.TERMINAL:
                return s0 * torch.exp(cum_lin[..., -1])
            if payoff == PayoffKind.ASIAN_ARITHMETIC:
                return s0 * torch.mean(torch.exp(cum_lin), dim=-1)
            return None
        if payoff == PayoffKind.TERMINAL:
            return s0 * torch.exp((rate - div_yield) * maturity)
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            g = torch.exp((rate - div_yield) * dt)
            series = torch.where(torch.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
            return s0 * series / n
        return None
    mu_bar, s2_bar = basket_log_moments(c, spec, dtype=dtype)
    g0 = basket_g0(c, spec, dtype=dtype)
    floor_c = cap_c = None
    if payoff == PayoffKind.CLIQUET:
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=device)
    if term is not None:
        vsa, rsa, qsa = term_tensors(term, timesteps, dtype, device)
        lin = (rate[..., None] * rsa - div_yield[..., None] * qsa) * dt[..., None]
        sig = c[..., 5, None] * torch.tensor(spec.vol_multipliers, dtype=dtype, device=device)
        wss = torch.sum(w * sig * sig, dim=-1)  # Σ wᵢσᵢ² (flat)
        mu_dt = lin - 0.5 * wss[..., None] * vsa * vsa * dt[..., None]  # [..., T]
        s2_dt = s2_bar[..., None] * vsa * vsa * dt[..., None]
        if payoff == PayoffKind.TERMINAL:
            return g0 * torch.exp(torch.sum(mu_dt + 0.5 * s2_dt, dim=-1))
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            return g0 * torch.mean(torch.exp(torch.cumsum(mu_dt + 0.5 * s2_dt, dim=-1)), dim=-1)
        if payoff == PayoffKind.ASIAN_GEOMETRIC:
            w_t = (n - torch.arange(timesteps, dtype=dtype, device=device)) / n
            mu_g = torch.log(g0) + torch.sum(mu_dt * w_t, dim=-1)
            return torch.exp(mu_g + 0.5 * torch.sum(s2_dt * w_t * w_t, dim=-1))
        if payoff == PayoffKind.DIGITAL:
            d2 = (torch.log(g0 / strike) + torch.sum(mu_dt, dim=-1)) / torch.sqrt(
                torch.sum(s2_dt, dim=-1))
            return strike + torch.erf(d2 / math.sqrt(2.0))
        if payoff == PayoffKind.VARIANCE_SWAP:
            return torch.sum(mu_dt * mu_dt + s2_dt, dim=-1) / maturity
        if payoff == PayoffKind.FORWARD_START:
            tail = torch.arange(timesteps, device=device) >= forward_start_step
            return g0 * torch.exp(torch.sum(torch.where(tail, mu_dt + 0.5 * s2_dt,
                                                        torch.zeros_like(mu_dt)), dim=-1))
        # CLIQUET
        periods = timesteps // cliquet_reset_every
        lead = mu_dt.shape[:-1]
        mu_p = torch.sum(mu_dt.reshape(*lead, periods, cliquet_reset_every), dim=-1)
        s_p = torch.sqrt(torch.sum(s2_dt.reshape(*lead, periods, cliquet_reset_every), dim=-1))
        return torch.sum(expected_clipped_lognormal_return(mu_p, s_p, floor_c, cap_c), dim=-1)
    if payoff == PayoffKind.VARIANCE_SWAP:
        # Δln B ~ N(μ̄·dt, s̄²·dt) exactly per step
        return n * ((mu_bar * dt) ** 2 + s2_bar * dt) / maturity
    if payoff == PayoffKind.FORWARD_START:
        n_tail = torch.tensor(float(timesteps - forward_start_step), dtype=dtype, device=device)
        return g0 * torch.exp((mu_bar + 0.5 * s2_bar) * dt * n_tail)
    if payoff == PayoffKind.CLIQUET:
        k_c = torch.tensor(float(cliquet_reset_every), dtype=dtype, device=device)
        periods = torch.tensor(float(timesteps // cliquet_reset_every), dtype=dtype,
                               device=device)
        mu_p = mu_bar * dt * k_c
        s_p = torch.sqrt(s2_bar * dt * k_c)
        return periods * expected_clipped_lognormal_return(mu_p, s_p, floor_c, cap_c)
    if payoff == PayoffKind.DIGITAL:
        d2 = (torch.log(g0 / strike) + mu_bar * maturity) / torch.sqrt(s2_bar * maturity)
        return strike + torch.erf(d2 / math.sqrt(2.0))
    if payoff == PayoffKind.TERMINAL:
        return g0 * torch.exp((mu_bar + 0.5 * s2_bar) * maturity)
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        g = torch.exp((mu_bar + 0.5 * s2_bar) * dt)
        series = torch.where(torch.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
        return g0 * series / n
    # the geometric time-average of the geometric basket: exactly lognormal
    mu = torch.log(g0) + mu_bar * dt * (n + 1.0) / 2.0
    s2 = s2_bar * dt * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n)
    return torch.exp(mu + 0.5 * s2)


__all__ = [
    "BasketCombine",
    "BasketSpec",
    "basket_cholesky",
    "basket_component_normals",
    "basket_euler_step",
    "basket_g0",
    "basket_log_moments",
    "build_basket_spec",
    "expected_basket_underlier_mean",
    "geometric_basket_effective_gbm",
    "simulate_basket_underlier_rows",
]
