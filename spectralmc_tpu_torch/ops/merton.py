"""Merton jump-diffusion dynamics on torch tensors (the JAX package's
``ops/merton.py``).

    dS/S = (r − q − lam·m) dt + vol dW + (e^Y − 1) dN,
    N ~ Poisson(lam t),  Y ~ Normal(jump_mean, jump_std²),
    m  = E[e^Y] − 1 = exp(jump_mean + jump_std²/2) − 1,

with the −lam·m compensator keeping the discounted spot a martingale.

Discretization: exact in distribution per step. Over one step the log
increment is (r − q − lam·m − vol²/2) dt + vol sqrt(dt) z_d + J where,
conditional on the Poisson count N ~ Poisson(lam dt), the jump sum J is
N·jump_mean + jump_std·sqrt(N)·z_j.

This module holds the contract model, the threefry (``"xla"``) simulator for
a batch of contracts, the analytic means and Merton's exact series oracle
(``merton_call_price``). The ``"cuda"`` engine's kernel and twin live in
``ops/dynamics_cuda.py``.

Determinism: draws are addressed by (contract key, global row, timestep,
component): 0 the diffusion normal, 1 the jump-size normal, 2 the Poisson
count. Antithetic pairs mirror BOTH normals and share the partner row's
counts. The counts reproduce ``jax.random.poisson`` draw for draw: Knuth's
loop for ``lam·dt < 10`` and Hörmann's transformed rejection above it. A
count can differ from the JAX package's only where a float32 ``log`` or
``lgamma`` lands within ulps of an acceptance edge (torch's and XLA's differ
by ulps). The count's rate is detached from autograd: pathwise derivatives
see fixed counts. With ``sampling=SOBOL_BB`` the diffusion normals come from
the QMC generator (``ops/qmc.py``); the jumps keep their threefry stream.
"""

from __future__ import annotations

import math

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
    _norm_cdf,
    curved,
    expected_clipped_lognormal_return,
    lookback_underlier,
    row_keys,
    term_tensors,
)
from spectralmc_tpu_torch.ops.heston import martingale_underlier_mean

# jax.random.poisson switches from Knuth's loop to transformed rejection here
KNUTH_LIMIT = 10.0
SERIES_TERMS = 64  # Poisson-mixture terms of the digital and cliquet means


class MertonContract(BaseModel):
    """One Merton market scenario: the 6 Black–Scholes fields (same order as
    ``BlackScholesContract``) + 3 jump fields."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    spot: float
    strike: float
    maturity: float
    rate: float
    div_yield: float
    vol: float  # diffusion volatility (between jumps)
    lam: float  # jump intensity (expected jumps per year)
    jump_mean: float  # mean of the log jump size Y
    jump_std: float  # std of the log jump size Y

    def as_array(
        self, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"
    ) -> torch.Tensor:
        """The vector in field order, on ``device``."""
        return torch.tensor([getattr(self, f) for f in type(self).model_fields],
                            dtype=dtype, device=device)


MERTON_CONTRACT_FIELDS: tuple[str, ...] = tuple(MertonContract.model_fields.keys())
MERTON_CONTRACT_DIM = len(MERTON_CONTRACT_FIELDS)


def validate_merton_contract(c: MertonContract) -> Result[MertonContract, GBMError]:
    for field in ("spot", "strike", "maturity", "vol", "jump_std"):
        if getattr(c, field) <= 0:
            return Failure(
                InvalidContract(field=field, value=getattr(c, field), reason="must be > 0")
            )
    if c.lam < 0:
        return Failure(InvalidContract(field="lam", value=c.lam, reason="must be >= 0"))
    return Success(c)


def merton_component_normals(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    t: int,
    comp: int,
    cols: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One Gaussian component's draws ``[..., cols]`` for row keys
    ``[..., 2]``, keyed (row key, timestep, component): 0 = diffusion, 1 =
    jump size. Antithetic flips both components."""
    z = rng.normal(rng.fold_in(rng.fold_in(keys, t), comp), (cols,), dtype)
    return z if sign is None else sign * z


def _count_shape(keys: torch.Tensor, lam: torch.Tensor, cols: int) -> tuple[int, ...]:
    return (*torch.broadcast_shapes(keys.shape[:-1], lam.shape[:-1]), cols)


def poisson_knuth(keys: torch.Tensor, lam: torch.Tensor, cols: int) -> torch.Tensor:
    """``jax.random.poisson``'s Knuth branch (jax 0.9 ``_poisson_knuth``), per key.

    ``keys`` is ``[..., 2]`` and ``lam`` float32, broadcastable to ``[...,
    1]``; the result is int64 ``[..., cols]``. Each iteration splits the
    running key (word pair 0 carries on, pair 1 draws), counts the lanes
    whose running sum of ``log(uniform)`` is still above ``−lam``, then adds
    the new ``log``. A lane's count does not depend on how long the loop runs
    for the others, so one loop serves every key. A lane with ``lam == 0``
    gives −1 here (``poisson`` maps it to 0).
    """
    lam = torch.as_tensor(lam, dtype=torch.float32, device=keys.device)
    shape = _count_shape(keys, lam, cols)
    neg_lam = torch.broadcast_to(-lam, shape)
    k = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=keys.device)
    running = keys
    while True:
        alive = log_prod > neg_lam
        if not bool(alive.any()):
            break
        pair = rng.fold_in(running[..., None, :], torch.arange(2, device=keys.device))
        running, subkey = pair[..., 0, :], pair[..., 1, :]
        k = k + alive
        log_prod = log_prod + torch.log(rng.uniform(subkey, (cols,)))
    return k - 1


def poisson_rejection(keys: torch.Tensor, lam: torch.Tensor, cols: int) -> torch.Tensor:
    """``jax.random.poisson``'s branch for ``lam >= 10``: Hörmann's transformed
    rejection (jax 0.9 ``_poisson_rejection``), per key; arguments and result
    as ``poisson_knuth``.

    Each iteration splits the running key three ways (0 carries on, 1 draws
    ``u − 0.5``, 2 draws ``v``) and proposes ``k`` in every lane; a lane
    takes ``k`` where ``accept1 | (~reject & accept2)``. JAX runs one loop
    per key (``vmap`` batches its ``while_loop``) until all of that key's
    lanes have accepted, and a lane that accepted earlier takes every later
    accepted proposal of that loop: so a key's lanes update only while one of
    them is still pending, and the last accepted proposal stands. The
    products ``a·b + c`` are rounded once, as XLA's CPU backend contracts
    them (``rng.fma32``).
    """
    lam = torch.as_tensor(lam, dtype=torch.float32, device=keys.device)
    shape = _count_shape(keys, lam, cols)
    log_lam = torch.log(lam)
    b = rng.fma32(torch.sqrt(lam), 2.53, 0.931)
    a = rng.fma32(b, 0.02483, -0.059)
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=keys.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=keys.device)
    running = keys
    while True:
        pending = (~accepted).any(dim=-1, keepdim=True)
        if not bool(pending.any()):
            break
        trio = rng.fold_in(running[..., None, :], torch.arange(3, device=keys.device))
        running = trio[..., 0, :]
        u = rng.uniform(trio[..., 1, :], (cols,)) - 0.5
        v = rng.uniform(trio[..., 2, :], (cols,))
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor(rng.fma32(2.0 * a / u_shifted + b, u, lam) + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = rng.fma32(k, log_lam, -lam) - torch.lgamma(k + 1.0)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = (accept1 | (~reject & (s <= t))) & pending
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int64)


def poisson(keys: torch.Tensor, lam: torch.Tensor, cols: int) -> torch.Tensor:
    """``jax.random.poisson(key, lam, (cols,))`` per key (jax 0.9 ``_poisson``):
    Knuth's loop where ``lam < 10`` or NaN, transformed rejection elsewhere,
    0 where ``lam == 0``. Both branches draw from the same key, so a Knuth
    lane's count does not depend on whether any lane takes the other branch.
    Arguments and result as ``poisson_knuth``."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=keys.device)
    shape = _count_shape(keys, lam, cols)
    knuth = torch.isnan(lam) | (lam < KNUTH_LIMIT)
    use_knuth = torch.broadcast_to(knuth, shape)
    result = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    if bool(use_knuth.any()):
        result = poisson_knuth(keys, torch.where(knuth, lam, torch.zeros_like(lam)), cols)
    if not bool(use_knuth.all()):
        lam_rejection = torch.where(knuth, torch.full_like(lam, 1e5), lam)
        result = torch.where(use_knuth, result, poisson_rejection(keys, lam_rejection, cols))
    return torch.where(torch.broadcast_to(lam == 0, shape), torch.zeros_like(result), result)


def merton_jump_counts(
    keys: torch.Tensor,
    t: int,
    rate_dt: torch.Tensor,
    cols: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Poisson jump counts ``[..., cols]`` for one step, keyed (row key,
    timestep, component 2). ``rate_dt`` broadcasts against the keys' leading
    dims plus one; it is detached, so counts are common random numbers for
    pathwise differentiation. Antithetic partners share counts: partner rows
    reuse the first half's keys and no sign applies to a count."""
    lam_dt = rate_dt.detach().to(torch.float32)
    return poisson(rng.fold_in(rng.fold_in(keys, t), 2), lam_dt, cols).to(dtype)


def simulate_merton_underlier_rows(
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
    """Payoff underliers ``[C, rows, cols]`` under exact-transition Merton on
    the threefry stream, for a batch of contracts (with
    ``sampling=SOBOL_BB`` the diffusion normals come from the QMC generator
    seeded by ``mc_seed``; the jumps keep their threefry stream).

    ``contracts`` is ``[C, 9]`` in ``MertonContract`` field order and
    ``contract_keys`` ``[C, 2]`` threefry words. Barrier kinds knock on the
    discrete spot grid (a jump through the barrier knocks). Exact
    transitions make the increments independent of the state, so forward
    start integrates steps ``m..N−1`` only and the cliquet carries just the
    running period log-return. A curved ``term`` scales rate, dividend and
    the DIFFUSION vol per step (jumps keep their contract law); a flat term
    is no term. Follows the JAX package's scan op for op.
    """
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol, lam, jump_mean, jump_std = (
        c[:, i, None, None] for i in range(9)
    )
    n = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    dt = maturity / n
    sqrt_dt = torch.sqrt(dt)
    m = torch.exp(jump_mean + 0.5 * jump_std * jump_std) - 1.0
    lam_dt = lam * dt
    term = curved(term)
    if term is None:
        drift = (rate - div_yield - lam * m - 0.5 * vol * vol) * dt
        drift_at = lambda t: drift  # noqa: E731
        vol_at = lambda t: vol  # noqa: E731
    else:
        vsa, rsa, qsa = term_tensors(term, timesteps, dtype, c.device)
        vol_arr = vol[..., None] * vsa
        drift_arr = (
            rate[..., None] * rsa - div_yield[..., None] * qsa - (lam * m)[..., None]
            - 0.5 * vol_arr * vol_arr
        ) * dt[..., None]
        drift_at = lambda t: drift_arr[..., t]  # noqa: E731
        vol_at = lambda t: vol_arr[..., t]  # noqa: E731
    keys, sign = row_keys(
        contract_keys, rows=rows, row_offset=row_offset, antithetic_half=antithetic_half,
        dtype=dtype,
    )

    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu_torch.ops.qmc import qmc_effective_normals

        if antithetic_half is not None:
            raise ValueError("SOBOL_BB sampling takes no antithetic mirroring")
        zq = qmc_effective_normals(contract_keys, timesteps=timesteps, rows=rows, cols=cols,
                                   dtype=dtype, mc_seed=mc_seed, row_offset=row_offset)
        diffusion = lambda t: zq[:, t]  # noqa: E731
    else:
        diffusion = lambda t: merton_component_normals(keys, sign, t, 0, cols, dtype)  # noqa: E731

    def draws(t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's diffusion normal and its jump sum."""
        z_d = diffusion(t)
        z_j = merton_component_normals(keys, sign, t, 1, cols, dtype)
        counts = merton_jump_counts(keys, t, lam_dt, cols, dtype)
        return z_d, counts * jump_mean + jump_std * torch.sqrt(counts) * z_j

    shape = (c.shape[0], rows, cols)
    zeros = torch.zeros(shape, dtype=dtype, device=c.device)
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None:
            raise ValueError("payoff='forward_start' requires forward_start_step")
        acc = zeros
        for t in range(forward_start_step, timesteps):
            z_d, jump = draws(t)
            acc = acc + (drift_at(t) + vol_at(t) * sqrt_dt * z_d + jump)
        return spot * torch.exp(acc)
    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=c.device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=c.device)
        per, acc = zeros, zeros
        for t in range(timesteps):
            z_d, jump = draws(t)
            per = per + drift_at(t) + vol_at(t) * sqrt_dt * z_d + jump
            if (t + 1) % cliquet_reset_every == 0:
                acc = acc + torch.clamp(torch.exp(per) - 1.0, floor_c, cap_c)
                per = zeros
        return acc

    barrier = payoff in BARRIER_PAYOFFS
    lookback = payoff in LOOKBACK_PAYOFFS
    track_extreme = barrier or lookback
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    variance = payoff == PayoffKind.VARIANCE_SWAP
    logx = zeros + torch.log(spot)
    acc = logx if track_extreme else zeros
    for t in range(timesteps):
        z_d, jump = draws(t)
        if variance:
            # summed first so the increment is available; the other branches
            # keep the other association, as the JAX scan does
            inc = drift_at(t) + vol_at(t) * sqrt_dt * z_d + jump
            logx = logx + inc
            acc = acc + inc * inc
            continue
        logx = logx + drift_at(t) + vol_at(t) * sqrt_dt * z_d + jump
        if track_extreme:
            acc = torch.maximum(acc, logx) if up else torch.minimum(acc, logx)
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
    mean = acc / n
    return torch.exp(mean) if geometric else mean


def _poisson_weights(lam: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``(k [64], w [..., 64])``: the Poisson(lam) pmf on 0..63 from log
    weights, with ``lam = 0`` giving the point mass at 0."""
    k = torch.arange(SERIES_TERMS, dtype=dtype, device=lam.device)
    lam = lam[..., None]
    log_lam = torch.log(torch.clamp(lam, min=torch.finfo(dtype).tiny))
    w = torch.exp(-lam + k * log_lam - torch.lgamma(k + 1.0))
    return k, torch.where(lam > 0.0, w, (k == 0.0).to(dtype))


def merton_expected_underlier_mean(
    contracts: torch.Tensor,
    *,
    timesteps: int,
    payoff: PayoffKind,
    dtype: torch.dtype,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    term: TermStructure | None = None,
) -> torch.Tensor | None:
    """Analytic E[underlier] ``[..., 9] -> [...]``, or None when no closed
    form exists (geometric Asian, barrier, lookback).

    The compensator makes the discounted spot a martingale, so TERMINAL, the
    arithmetic Asian and forward start follow GBM's formulas. The exact
    transitions also give E[RV] (law of total variance per step), and the
    digital and cliquet means as 64-term Poisson mixtures of the GBM closed
    forms (the tail beyond is < 1e-15 for lam·T <= 20). Under curves the
    per-step sums replace the products of identical factors.
    """
    martingale = martingale_underlier_mean(
        contracts, timesteps=timesteps, payoff=payoff, dtype=dtype,
        forward_start_step=forward_start_step, term=term,
    )
    if martingale is not None:
        return martingale
    if payoff not in (PayoffKind.VARIANCE_SWAP, PayoffKind.CLIQUET, PayoffKind.DIGITAL):
        return None
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol, lam, mu_j, sd_j = (c[..., i] for i in range(9))
    n = torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    dt = maturity / n
    m = torch.exp(mu_j + 0.5 * sd_j * sd_j) - 1.0
    term = curved(term)
    # per-step linear drift, diffusion variance and log-drift, each [..., T]
    # under curves and [..., 1] flat (one step standing for all N)
    if term is not None:
        vsa, rsa, qsa = term_tensors(term, timesteps, dtype, c.device)
        lin = (rate[..., None] * rsa - div_yield[..., None] * qsa) * dt[..., None]
        vol_sq_dt = (vol[..., None] * vsa) ** 2 * dt[..., None]
        a_dt = lin - (lam * m * dt)[..., None] - 0.5 * vol_sq_dt
    if payoff == PayoffKind.VARIANCE_SWAP:
        jump_mean_inc = lam * dt * mu_j
        jump_var_inc = lam * dt * (sd_j * sd_j + mu_j * mu_j)
        if term is not None:
            mean_inc = a_dt + jump_mean_inc[..., None]
            var_inc = vol_sq_dt + jump_var_inc[..., None]
            return torch.sum(var_inc + mean_inc * mean_inc, dim=-1) / maturity
        a_flat = (rate - div_yield - lam * m - 0.5 * vol * vol) * dt
        mean_inc = a_flat + jump_mean_inc
        var_inc = vol * vol * dt + jump_var_inc
        return n * (var_inc + mean_inc * mean_inc) / maturity
    if payoff == PayoffKind.CLIQUET:
        if cliquet_reset_every is None or cliquet_floor is None or cliquet_cap is None:
            raise ValueError("payoff='cliquet' requires its reset grid and clip levels")
        k_steps = cliquet_reset_every
        periods = timesteps // k_steps
        floor_c = torch.tensor(cliquet_floor, dtype=dtype, device=c.device)
        cap_c = torch.tensor(cliquet_cap, dtype=dtype, device=c.device)
        t_p = dt * torch.tensor(float(k_steps), dtype=dtype, device=c.device)
        p, w = _poisson_weights(lam * t_p, dtype)  # [64], [..., 64]
        if term is not None:
            lead = a_dt.shape[:-1]
            mu_p = torch.sum(a_dt.reshape(*lead, periods, k_steps), dim=-1)  # [..., P]
            s2_p = torch.sum(vol_sq_dt.reshape(*lead, periods, k_steps), dim=-1)
            mu_k = mu_p[..., None] + p * mu_j[..., None, None]
            s_k = torch.sqrt(s2_p[..., None] + p * (sd_j * sd_j)[..., None, None])
            e_clip = expected_clipped_lognormal_return(mu_k, s_k, floor_c, cap_c)
            return torch.sum(w[..., None, :] * e_clip, dim=(-2, -1))
        mu_p = (rate - div_yield - lam * m - 0.5 * vol * vol) * t_p
        mu_k = mu_p[..., None] + p * mu_j[..., None]
        s_k = torch.sqrt((vol * vol * t_p)[..., None] + p * (sd_j * sd_j)[..., None])
        e_clip = expected_clipped_lognormal_return(mu_k, s_k, floor_c, cap_c)
        return torch.tensor(float(periods), dtype=dtype, device=c.device) * torch.sum(
            w * e_clip, dim=-1
        )
    # DIGITAL: E[u] = K + 2·P(S_T > K) − 1 with P a Poisson(lam·T) mixture of
    # Gaussian tail probabilities (the plain intensity: the lam(1+m) tilt
    # belongs to the S·N(d1) term of the price series, not to the probability)
    k, w = _poisson_weights(lam * maturity, dtype)
    if term is not None:
        drift_tot = torch.sum(a_dt, dim=-1)
        var_diff = torch.sum(vol_sq_dt, dim=-1)
    else:
        drift_tot = (rate - div_yield - lam * m - 0.5 * vol * vol) * maturity
        var_diff = vol * vol * maturity
    var_k = var_diff[..., None] + k * (sd_j * sd_j)[..., None]
    d_k = (torch.log(spot / strike)[..., None] + drift_tot[..., None] + k * mu_j[..., None]) \
        / torch.sqrt(var_k)
    prob_up = torch.sum(w * _norm_cdf(d_k), dim=-1)
    return strike + 2.0 * prob_up - 1.0


# --------------------------------------------------------------------------
# Exact series oracle (host-side, float64 — test/validation path)
# --------------------------------------------------------------------------


def merton_call_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    lam: float,
    jump_mean: float,
    jump_std: float,
    max_terms: int | None = None,
) -> tuple[float, float]:
    """(call, put) by Merton's (1976) exact series.

    Conditional on N = n jumps, ln S_T is Gaussian, so the price is a
    Poisson mixture of Black prices:

        price = sum_n e^{-lam' T} (lam' T)^n / n! · Black(S, K, T, r_n, q, s_n)

    with lam' = lam (1 + m), m = exp(jump_mean + jump_std²/2) − 1,
    s_n² = vol² + n jump_std² / T and r_n = r − lam m + n ln(1 + m) / T. The
    series is truncated where the Poisson tail is negligible
    (lam'T + 12 sqrt(lam'T) + 24 terms); at lam = 0 the single surviving term
    is the plain Black price.
    """
    m = math.exp(jump_mean + 0.5 * jump_std * jump_std) - 1.0
    mean_terms = lam * (1.0 + m) * maturity
    if mean_terms <= 0.0:
        n_terms = 1  # lam = 0: the n = 0 term IS the Black price
    elif max_terms is not None:
        n_terms = max_terms
    else:
        n_terms = int(np.ceil(mean_terms + 12.0 * np.sqrt(max(mean_terms, 1.0)))) + 24

    def ncdf(x: float) -> float:
        return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

    def black_call(s: float, k: float, t: float, r: float, q: float, v: float) -> float:
        fwd = s * math.exp((r - q) * t)
        tv = v * math.sqrt(t)
        d1 = (math.log(fwd / k) + 0.5 * tv * tv) / tv
        return math.exp(-r * t) * (fwd * ncdf(d1) - k * ncdf(d1 - tv))

    log_weight = -mean_terms  # ln of e^{-lam'T} (lam'T)^n / n!, built iteratively
    call = 0.0
    ln1m = math.log1p(m)
    for n_jumps in range(n_terms):
        if n_jumps > 0:
            log_weight += math.log(mean_terms) - math.log(n_jumps)
        s_n = math.sqrt(vol * vol + n_jumps * jump_std * jump_std / maturity)
        r_n = rate - lam * m + n_jumps * ln1m / maturity
        call += math.exp(log_weight) * black_call(spot, strike, maturity, r_n, div_yield, s_n)
    put = call - math.exp(-div_yield * maturity) * spot + math.exp(-rate * maturity) * strike
    return call, put
