"""Closed-form and lattice oracles under GBM, flat or under piecewise-constant
curves (the JAX package's ``ops/analytic.py``).

The Black–Scholes, digital, geometric-Asian and forward-start prices are
pure and broadcastable over float64 tensors. The discrete-grid barrier,
lookback, variance and cliquet oracles run on the host in numpy/scipy
float64, as the JAX package's do. Each shares the simulator's exact
discrete monitoring grid, so it gates the MC estimator with no
discretization slop. Curve arguments follow ``ops/gbm.py::TermStructure``:
per-step multipliers on vol, rate and dividend yield, empty meaning flat.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, slots=True)
class AnalyticPrices:
    """Discounted put/call prices with intrinsics and convexities (time value)."""

    put: torch.Tensor
    call: torch.Tensor
    put_intrinsic: torch.Tensor
    call_intrinsic: torch.Tensor
    put_convexity: torch.Tensor
    call_convexity: torch.Tensor


@dataclass(frozen=True, slots=True)
class LookbackPrices:
    """Discrete-monitoring lookback prices (grid t_0..t_N, t_0 included):
    fixed_call pays (M−K)+, fixed_put (K−m)+, float_put M−S_T, float_call
    S_T−m; ``e_max``/``e_min`` are the undiscounted E[M], E[m]."""

    fixed_call: float
    fixed_put: float
    float_call: float
    float_put: float
    e_max: float
    e_min: float
    forward: float
    discount_factor: float


def _f64(*xs: torch.Tensor | float) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(x, dtype=torch.float64) for x in xs)


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


Shape = tuple[float, ...]


def _shapes(n: int, vol_shape: Shape, rate_shape: Shape, div_shape: Shape) -> tuple[Shape, ...]:
    """The three shapes with empties expanded to ``n`` flat ones."""
    flat = (1.0,) * n
    return vol_shape or flat, rate_shape or flat, div_shape or flat


def _effective(
    vol_shape: Shape, rate_shape: Shape, div_shape: Shape
) -> tuple[float, float, float]:
    """(RMS vol, mean rate, mean div) factors of the curves (1 when empty)."""
    n = max(len(vol_shape), len(rate_shape), len(div_shape), 1)
    vs, rs, qs = _shapes(n, vol_shape, rate_shape, div_shape)
    return math.sqrt(sum(v * v for v in vs) / n), sum(rs) / n, sum(qs) / n


def _step_moments(
    maturity: float, rate: float, div_yield: float, vol: float, n: int,
    vol_shape: Shape, rate_shape: Shape, div_shape: Shape,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-step log-drift ``a_t`` and standard deviation ``b_t`` ``[n]``."""
    vs, rs, qs = (np.asarray(x, dtype=np.float64)
                  for x in _shapes(n, vol_shape, rate_shape, div_shape))
    dt = maturity / n
    vol_t = vol * vs
    return (rate * rs - div_yield * qs - 0.5 * vol_t * vol_t) * dt, vol_t * np.sqrt(dt)


def _prices(put, call, mean, strike, df) -> AnalyticPrices:  # noqa: ANN001
    """The record from prices, the underlier's mean and the discount factor
    (intrinsics are the discounted forward intrinsics)."""
    if isinstance(mean, torch.Tensor):
        call_intr = df * torch.clamp(mean - strike, min=0.0)
        put_intr = df * torch.clamp(strike - mean, min=0.0)
    else:
        call_intr = df * max(mean - strike, 0.0)
        put_intr = df * max(strike - mean, 0.0)
    return AnalyticPrices(
        put=put, call=call, put_intrinsic=put_intr, call_intrinsic=call_intr,
        put_convexity=put - put_intr, call_convexity=call - call_intr,
    )


def black_scholes_price(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
) -> AnalyticPrices:
    """European put/call under GBM: Black formula on the forward.

    F = S·e^{(r−q)T}, df = e^{−rT}; call = df·(F·N(d1) − K·N(d2)), put via
    parity. Intrinsic is the discounted forward-intrinsic df·max(±(F−K), 0).
    """
    s, k, t, r, q, v = _f64(spot, strike, maturity, rate, div_yield, vol)
    forward = s * torch.exp((r - q) * t)
    df = torch.exp(-r * t)
    total_vol = v * torch.sqrt(t)
    d1 = (torch.log(forward / k) + 0.5 * total_vol**2) / total_vol
    d2 = d1 - total_vol
    call = df * (forward * _norm_cdf(d1) - k * _norm_cdf(d2))
    put = call - df * (forward - k)  # put-call parity
    return _prices(put, call, forward, k, df)


def term_effective_black(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
    *,
    vol_shape: Shape,
    rate_shape: Shape,
    div_shape: Shape,
) -> AnalyticPrices:
    """European put/call under piecewise-constant curves, exact for the
    log-Euler simulator: ln S_T is Gaussian with total variance
    ``vol²·dt·Σ vs_j²`` and drift integral ``Σ(r·rs_j − q·qs_j)dt``, so the
    flat Black formula applies at ``vol·sqrt(mean(vs²))``, ``r·mean(rs)``,
    ``q·mean(qs)``."""
    v_f, r_f, q_f = _effective(vol_shape, rate_shape, div_shape)
    s, k, t, r, q, v = _f64(spot, strike, maturity, rate, div_yield, vol)
    return black_scholes_price(s, k, t, r * r_f, q * q_f, v * v_f)


def lognormal_black_price(
    mu: torch.Tensor | float,
    s2: torch.Tensor | float,
    strike: torch.Tensor | float,
    rate: torch.Tensor | float,
    maturity: torch.Tensor | float,
) -> AnalyticPrices:
    """Black-type put/call on a lognormal underlier ln U ~ N(mu, s2):
    call = df·(E[U]·N(d1) − K·N(d2)) with d1 = (mu − ln K + s2)/s."""
    mu, s2, k, r, t = _f64(mu, s2, strike, rate, maturity)
    df = torch.exp(-r * t)
    s = torch.sqrt(s2)
    mean_u = torch.exp(mu + 0.5 * s2)
    d1 = (mu - torch.log(k) + s2) / s
    d2 = d1 - s
    call = df * (mean_u * _norm_cdf(d1) - k * _norm_cdf(d2))
    put = call - df * (mean_u - k)  # parity on the lognormal mean
    return _prices(put, call, mean_u, k, df)


def geometric_basket_price(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
    *,
    spec: object,
) -> AnalyticPrices:
    """European put/call on the geometric basket Π Sᵢ^wᵢ, closed form.

    ln B_T ~ N(ln G₀ + μ̄T, s̄²T) with (μ̄, s̄²) from
    ``ops/basket.py::basket_log_moments``, exact under the log-Euler
    discretization: the multi-asset analogue of the geometric-Asian oracle.
    A 1-asset basket prices as ``black_scholes_price``.
    """
    from spectralmc_tpu_torch.ops.basket import basket_g0, basket_log_moments

    s, k, t, r, q, v = _f64(spot, strike, maturity, rate, div_yield, vol)
    contract = torch.stack(torch.broadcast_tensors(s, k, t, r, q, v), dim=-1)
    mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=torch.float64)
    mu = torch.log(basket_g0(contract, spec, dtype=torch.float64)) + mu_bar * t
    return lognormal_black_price(mu, s2_bar * t, k, r, t)


def digital_price(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
    *,
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """(put, call) cash-or-nothing digital prices, one unit of cash:
    put = df·N(−d2), call = df·N(d2). Exact for the log-Euler simulator
    (ln S_T is exactly Gaussian under the discrete scheme, flat or curved:
    d2 at the effective parameters of ``term_effective_black``)."""
    s, k, t, r, q, v = _f64(spot, strike, maturity, rate, div_yield, vol)
    if vol_shape or rate_shape or div_shape:
        v_f, r_f, q_f = _effective(vol_shape, rate_shape, div_shape)
        r, q, v = r * r_f, q * q_f, v * v_f
    df = torch.exp(-r * t)
    total_vol = v * torch.sqrt(t)
    d2 = (torch.log(s / k) + (r - q) * t - 0.5 * total_vol**2) / total_vol
    return df * _norm_cdf(-d2), df * _norm_cdf(d2)


def geometric_asian_price(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
    *,
    timesteps: int,
) -> AnalyticPrices:
    """Discrete geometric-Asian put/call over the grid t_i = i·T/N, closed
    form: ln G ~ N(mu, s²) with mu = ln S + (r − q − σ²/2)·dt·(N+1)/2 and
    s² = σ²·dt·(N+1)(2N+1)/(6N), exact under log-Euler."""
    s, k, t, r, q, v = _f64(spot, strike, maturity, rate, div_yield, vol)
    n = float(timesteps)
    dt = t / n
    mu = torch.log(s) + (r - q - 0.5 * v * v) * dt * (n + 1.0) / 2.0
    s2 = v * v * dt * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n)
    return lognormal_black_price(mu, s2, k, r, t)


def term_geometric_asian_price(
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
    vol_shape: Shape = (),
    rate_shape: Shape = (),
    div_shape: Shape = (),
) -> AnalyticPrices:
    """Discrete geometric-Asian put/call under piecewise-constant curves:
    the grid average of ln S is Gaussian with ``mu = ln S + Σ_j a_j·(N−j)/N``
    and ``s² = Σ_j b_j²·((N−j)/N)²`` (``geometric_asian_price``'s closed sums
    for flat shapes); discounting uses the curve rate integral."""
    n = int(timesteps)
    a, b = _step_moments(maturity, rate, div_yield, vol, n, vol_shape, rate_shape, div_shape)
    w = (n - np.arange(n, dtype=np.float64)) / n
    mu = math.log(spot) + float((a * w).sum())
    s2 = float((b * b * w * w).sum())
    r_eff = rate * _effective(vol_shape, rate_shape, div_shape)[1]
    return lognormal_black_price(mu, s2, strike, r_eff, maturity)


def forward_start_price(
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
    start_step: int,
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
) -> AnalyticPrices:
    """Exact discrete-grid forward-start put/call under log-Euler GBM, flat
    or curved: the underlier u = spot·S_T/S_m is lognormal in the tail
    increments alone, ln u ~ N(ln spot + Σ_{t≥m} a_t, Σ_{t≥m} v_t²·dt),
    discounted over the full curve. ``strike`` is absolute."""
    n, m = int(timesteps), int(start_step)
    dt = maturity / n
    vs, rs, qs = _shapes(n, vol_shape, rate_shape, div_shape)
    mu = math.log(spot) + sum(
        (rate * rs[t] - div_yield * qs[t] - 0.5 * (vol * vs[t]) ** 2) * dt for t in range(m, n)
    )
    s2 = sum((vol * vs[t]) ** 2 * dt for t in range(m, n))
    return lognormal_black_price(mu, s2, strike, rate * (sum(rs) / n), maturity)


def _log_grid_gauss(x: np.ndarray):  # noqa: ANN202
    def gauss(centers: np.ndarray, sd: float) -> np.ndarray:
        z = (x[:, None] - centers[None, :]) / sd
        return np.exp(-0.5 * z * z) / (sd * np.sqrt(2.0 * np.pi))

    return gauss


def _transitions(gauss, x, dx, drift_t, sd_t):  # noqa: ANN001, ANN202
    """The ``[to, from]`` transition matrices of steps 1..N−1, one shared
    matrix when every step has the same law."""
    shared = None
    if (drift_t == drift_t[0]).all() and (sd_t == sd_t[0]).all():
        shared = gauss(x + drift_t[0], float(sd_t[0])) * dx
    for j in range(1, len(drift_t)):
        yield shared if shared is not None else gauss(x + drift_t[j], float(sd_t[j])) * dx


def discrete_barrier_price(
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
    barrier_rel: float,
    up: bool,
    grid_points: int = 2049,
    width_std: float = 8.0,
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
) -> AnalyticPrices:
    """Knock-out put/call monitored on the DISCRETE grid t_1..t_N, by density
    propagation on a uniform log grid (host numpy, float64): each log-Euler
    step's transition is exactly Gaussian (with its own drift and σ under
    curves), and the knockout mask applies at every monitor date. Knocked
    paths pay nothing."""
    n = int(timesteps)
    drift_t, sd_t = _step_moments(maturity, rate, div_yield, vol, n,
                                  vol_shape, rate_shape, div_shape)
    if (sd_t <= 0.0).any():
        raise ValueError("discrete_barrier_price needs positive per-step vol")
    total_sd = float(np.sqrt((sd_t * sd_t).sum()))
    ln_s0 = math.log(spot)
    ln_b = math.log(spot * barrier_rel)
    lo = min(ln_s0 + drift_t.sum() - width_std * total_sd, ln_b - 4 * sd_t.max())
    hi = max(ln_s0 + drift_t.sum() + width_std * total_sd, ln_b + 4 * sd_t.max())
    x = np.linspace(lo, hi, grid_points)
    dx = x[1] - x[0]
    survive = x < ln_b if up else x > ln_b
    gauss = _log_grid_gauss(x)
    q = gauss(np.array([ln_s0 + drift_t[0]]), float(sd_t[0]))[:, 0] * dx
    q = np.where(survive, q, 0.0)
    for step_t in _transitions(gauss, x, dx, drift_t, sd_t):
        q = np.where(survive, step_t @ q, 0.0)
    s_t = np.exp(x)
    _, r_f, q_f = _effective(vol_shape, rate_shape, div_shape)
    df = math.exp(-rate * r_f * maturity)
    call = df * float((q * np.maximum(s_t - strike, 0.0)).sum())
    put = df * float((q * np.maximum(strike - s_t, 0.0)).sum())
    forward = spot * math.exp((rate * r_f - div_yield * q_f) * maturity)
    return _prices(put, call, forward, strike, df)


def lookback_price(
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
    grid_points: int = 1537,
    levels: int = 1025,
    width_std: float = 8.0,
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
) -> LookbackPrices:
    """Lookback prices monitored on the DISCRETE grid t_0..t_N, by
    barrier-survival integration (host numpy, float64): P(M ≤ b) is the
    surviving mass of the up-and-out propagation at level b, so
    E[(M−K)+] = max(S0−K, 0) + ∫_{max(K,S0)}^∞ (1 − survival(b)) db, over a
    ladder of levels in one batched propagation; symmetrically for the
    running min."""
    n = int(timesteps)
    drift_t, sd_t = _step_moments(maturity, rate, div_yield, vol, n,
                                  vol_shape, rate_shape, div_shape)
    if (sd_t <= 0.0).any():
        raise ValueError("lookback_price needs positive per-step vol")
    total_sd = float(np.sqrt((sd_t * sd_t).sum()))
    drift_sum = float(drift_t.sum())
    ln_s0 = math.log(spot)
    lo = ln_s0 + min(drift_sum, 0.0) - width_std * total_sd
    hi = ln_s0 + max(drift_sum, 0.0) + width_std * total_sd
    x = np.linspace(lo, hi, grid_points)
    dx = x[1] - x[0]
    gauss = _log_grid_gauss(x)
    transitions = list(_transitions(gauss, x, dx, drift_t, sd_t))

    def exceed_prob(ln_levels: np.ndarray, up: bool) -> np.ndarray:
        """P(extreme beyond level) per ladder level, one batched propagation."""
        survive = (x[:, None] < ln_levels[None, :]) if up else (x[:, None] > ln_levels[None, :])
        first = gauss(np.array([ln_s0 + drift_t[0]]), float(sd_t[0])) * dx
        q = np.where(survive, first, 0.0)  # [G, L]
        for step_t in transitions:
            q = np.where(survive, step_t @ q, 0.0)
        return 1.0 - q.sum(axis=0)

    def tail_integral(grid: np.ndarray, p: np.ndarray, c: float) -> float:
        """∫_c^∞ p(b) db over the ladder (p → 0 at the far end)."""
        if c >= grid[-1]:
            return 0.0
        c = max(c, grid[0])
        cum = np.concatenate([np.cumsum(((p[1:] + p[:-1]) * 0.5 * np.diff(grid))[::-1])[::-1],
                              [0.0]])
        return float(np.interp(c, grid, cum))

    def head_integral(grid: np.ndarray, p: np.ndarray, c: float) -> float:
        """∫_0^c p(b) db over the ladder (p → 0 at the near end)."""
        if c <= grid[0]:
            return 0.0
        c = min(c, grid[-1])
        cum = np.concatenate([[0.0], np.cumsum((p[1:] + p[:-1]) * 0.5 * np.diff(grid))])
        return float(np.interp(c, grid, cum))

    # running MAX: levels from S0 up; b <= S0 has P(M > b) = 1 (t_0 counts)
    b_max = np.exp(np.linspace(ln_s0, hi, levels))
    p_above = exceed_prob(np.log(b_max), up=True)
    e_max = spot + tail_integral(b_max, p_above, spot)
    fixed_call = max(spot - strike, 0.0) + tail_integral(b_max, p_above, max(strike, spot))
    # running MIN: levels from S0 down; b >= S0 has P(m < b) = 1
    b_min = np.exp(np.linspace(lo, ln_s0, levels))
    p_below = exceed_prob(np.log(b_min), up=False)
    e_min = spot - head_integral(b_min, p_below, spot)
    fixed_put = max(strike - spot, 0.0) + head_integral(b_min, p_below, min(strike, spot))
    _, r_f, q_f = _effective(vol_shape, rate_shape, div_shape)
    df = math.exp(-rate * r_f * maturity)
    forward = spot * math.exp((rate * r_f - div_yield * q_f) * maturity)
    return LookbackPrices(
        fixed_call=df * fixed_call,
        fixed_put=df * fixed_put,
        float_call=df * (forward - e_min),
        float_put=df * (e_max - forward),
        e_max=e_max,
        e_min=e_min,
        forward=forward,
        discount_factor=df,
    )


def variance_option_price(
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
) -> AnalyticPrices:
    """Exact discrete-grid variance cap (call) and floor (put) under flat
    log-Euler GBM (host scipy, float64): RV = (1/T)·Σ(Δln S)² with
    Δln S ~ iid N(a, b²) is (b²/T)·χ'²(N, λ = N·a²/b²), and the tail-mean
    identity gives E[X·1{X>y}] = N·Q_{N+2,λ}(y) + λ·Q_{N+4,λ}(y). ``strike``
    is in vol² units."""
    from scipy.stats import ncx2

    n = int(timesteps)
    dt = maturity / n
    a = (rate - div_yield - 0.5 * vol * vol) * dt
    b2 = vol * vol * dt
    lam = n * a * a / b2
    scale = b2 / maturity
    y = strike / scale
    df = math.exp(-rate * maturity)
    q_y = float(ncx2.sf(y, n, lam))
    e_tail = n * float(ncx2.sf(y, n + 2, lam)) + lam * float(ncx2.sf(y, n + 4, lam))
    call = df * scale * (e_tail - y * q_y)
    e_rv = scale * (n + lam)
    put = call - df * (e_rv - strike)  # parity on the exact mean
    return _prices(put, call, e_rv, strike, df)


def cliquet_price(
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    *,
    timesteps: int,
    reset_every: int,
    local_floor: float,
    local_cap: float,
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
    grid: int = 1 << 16,
) -> AnalyticPrices:
    """Exact discrete-grid cliquet put/call under log-Euler GBM, flat or
    curved (host numpy/scipy lattice, float64): u = Σ_j clip(R_j, floor, cap) sums
    independent clipped period returns, each with a known mixed law (atoms
    at floor and cap plus a lognormal body) laid on a shared lattice
    anchored at ``local_floor``; the product of their FFTs is the sum's pmf.
    ``strike`` is in return units; ``spot`` cancels out of every ratio."""
    from scipy.stats import norm

    del spot
    n = int(timesteps)
    k = int(reset_every)
    periods = n // k
    dt = maturity / n
    vs, rs, qs = _shapes(n, vol_shape, rate_shape, div_shape)
    mus, sds = [], []
    for j in range(periods):
        steps = range(j * k, (j + 1) * k)
        mus.append(sum((rate * rs[t] - div_yield * qs[t] - 0.5 * (vol * vs[t]) ** 2) * dt
                       for t in steps))
        sds.append(math.sqrt(sum((vol * vs[t]) ** 2 * dt for t in steps)))
    # shared lattice: anchored at the floor, step h small enough that the
    # P-fold index sum stays inside the FFT grid (no circular wrap)
    h = (local_cap - local_floor) * periods / (grid - 8)
    m_cells = int(math.ceil((local_cap - local_floor) / h)) + 1
    x = local_floor + h * np.arange(m_cells)
    edges = np.concatenate([x - h / 2, [x[-1] + h / 2]])
    ce = np.clip(edges, local_floor, local_cap)
    ft = np.ones(grid // 2 + 1, dtype=np.complex128)
    for mu, s in zip(mus, sds):
        pmf = np.zeros(grid)
        pmf[:m_cells] = np.diff(norm.cdf((np.log1p(ce) - mu) / s))
        pmf[0] += norm.cdf((math.log1p(local_floor) - mu) / s)
        p_cap = 1.0 - norm.cdf((math.log1p(local_cap) - mu) / s)
        j_f = (local_cap - local_floor) / h
        j0 = min(int(math.floor(j_f)), m_cells - 1)
        w1 = j_f - j0
        pmf[j0] += p_cap * (1.0 - w1)
        pmf[min(j0 + 1, m_cells - 1)] += p_cap * w1
        pmf /= pmf.sum()
        ft *= np.fft.rfft(pmf)
    conv = np.maximum(np.fft.irfft(ft, grid), 0.0)
    conv /= conv.sum()
    xs = local_floor * periods + h * np.arange(grid)
    df = math.exp(-rate * (sum(rs) / n) * maturity)
    put = df * float(np.sum(np.maximum(strike - xs, 0.0) * conv))
    call = df * float(np.sum(np.maximum(xs - strike, 0.0) * conv))
    return _prices(put, call, float(np.sum(xs * conv)), strike, df)


def variance_fair_strike(
    maturity: float, rate: float, div_yield: float, vol: float, *, timesteps: int
) -> float:
    """E[RV] on the discrete grid — the strike that zeroes the variance-swap
    leg (exact under flat log-Euler GBM; equals
    ``ops/gbm.py::expected_underlier_mean(VARIANCE_SWAP)``)."""
    dt = maturity / timesteps
    a = (rate - div_yield - 0.5 * vol * vol) * dt
    return timesteps * (a * a + vol * vol * dt) / maturity


def implied_vol(
    price: torch.Tensor | float,
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    *,
    option: str = "call",
    iterations: int = 64,
    lo: float = 1e-4,
    hi: float = 5.0,
) -> torch.Tensor:
    """Black implied volatility by bisection, NaN outside no-arbitrage bounds.

    ``iterations`` halvings of ``[lo, hi]`` on the Black value (branch-free,
    unconditionally convergent where Newton's vega division blows up deep in
    or out of the money). Broadcasts over any batch of inputs and works in
    their dtype: the promotion of the tensors' dtypes, float64 when every
    input is a Python number (the JAX package's weak typing under x64), so
    float32 inputs resolve to ~3e-7 and the tail iterations change nothing.

    NaN, never a pinned bracket end, where the price is not attainable:
    outside the envelope (call ``df·max(F−K, 0) ≤ price < df·F``, put
    ``df·max(K−F, 0) ≤ price < df·K``) or outside ``[value(lo), value(hi)]``.
    """
    raw = (price, spot, strike, maturity, rate, div_yield)
    tensors = [torch.as_tensor(x) for x in raw if not isinstance(x, (int, float))]
    dtype = torch.float64
    if tensors:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    device = tensors[0].device if tensors else torch.device("cpu")
    p, s, k, t, r, q = (torch.as_tensor(x, dtype=dtype, device=device) for x in raw)
    is_call = option == "call"
    forward = s * torch.exp((r - q) * t)
    df = torch.exp(-r * t)
    if is_call:
        intrinsic = df * torch.clamp(forward - k, min=0.0)
        upper = df * forward
    else:
        intrinsic = df * torch.clamp(k - forward, min=0.0)
        upper = df * k

    def value(vol: torch.Tensor) -> torch.Tensor:
        total_vol = vol * torch.sqrt(t)
        d1 = (torch.log(forward / k) + 0.5 * total_vol**2) / total_vol
        d2 = d1 - total_vol
        call = df * (forward * _norm_cdf(d1) - k * _norm_cdf(d2))
        return call if is_call else call - df * (forward - k)

    shape = torch.broadcast_shapes(p.shape, s.shape, k.shape, t.shape, r.shape, q.shape)
    lo_v = torch.full(shape, lo, dtype=dtype, device=device)
    hi_v = torch.full(shape, hi, dtype=dtype, device=device)
    for _ in range(iterations):
        mid = 0.5 * (lo_v + hi_v)
        too_low = value(mid) < p
        lo_v, hi_v = torch.where(too_low, mid, lo_v), torch.where(too_low, hi_v, mid)
    vol = 0.5 * (lo_v + hi_v)
    in_bounds = ((p >= intrinsic) & (p < upper)
                 & (p >= value(torch.tensor(lo, dtype=dtype, device=device)))
                 & (p <= value(torch.tensor(hi, dtype=dtype, device=device))))
    return torch.where(in_bounds, vol, torch.full_like(vol, math.nan))
