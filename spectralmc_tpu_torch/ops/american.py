"""American/Bermudan pricing by Longstaff–Schwartz regression Monte Carlo.

The port of the JAX package's ``ops/american.py``. Early exercise on the
monitor grid, the classic regression estimator of Longstaff & Schwartz
(2001):

* ``lsmc_backward`` — the backward induction over ``[C, n_monitor, ...]``
  monitor-date price rows: per date the in-the-money regression's normal
  equations as moment sums ``Σ w·x^a·v^b`` over the paths (no basis matrix),
  the ridge solve ``_ridge_chol_solve``, the exercise decision and the
  cashflow update. Every option of the JAX estimator is kept: the split-
  sample ``fit_mask``, the cross-fitted pair ``cross_fit_mask``, a second
  state row set ``extra_rows``, per-segment discounts ``disc_to_prev`` and
  rows in log space.
* ``encode_monitor_prices`` — the induction plus the synthetic-underlier
  encode ``u = K − cf/df``, so the put-payoff pipeline ``df·max(K − u, 0)``
  reproduces the Bermudan cashflow for both option sides.
* ``simulate_american_underlier_rows`` — the threefry (``"xla"``) engine
  under GBM: the canonical (contract key, global row, timestep) normals,
  flat or under a curved ``TermStructure``, antithetic and cross-fit.
* ``simulate_{heston,merton,basket}_american_underlier_rows`` — the same
  engine under the other dynamics, on flat market data. Their forwards,
  ``{heston,merton,basket}_state_rows``, draw through each dynamics' own
  stream and step helpers, so the last state row is the European
  simulator's TERMINAL value bit for bit. Heston regresses on the variance
  too and the arithmetic basket on its log dispersion ``ln(B_arith/B_geom)``
  (``lsmc_backward``'s ``extra_rows``); Merton and the geometric basket are
  single-state.
* Sharded training hands the threefry simulators and ``lsmc_backward`` a
  ``paths_group``: each rank holds a shard of the paths and the regression's
  moment sums are all-reduced over the group (JAX's ``axis_name`` psum).
* ``lsmc_cashflows``/``lsmc_price`` — host-facing pricing with a standard
  error, the same-path European leg and its control variate; on the
  ``"cuda"`` engine through the monitor-row and backward kernels
  (``ops/american_cuda.py``).
* ``bermudan_tree_price``/``bermudan_grid_price`` — host float64 oracles.

Every function takes a BATCH of contracts: strikes, discounts and the like
are ``[C]`` tensors and reductions run per contract over the path dims.
The moment sums use ``torch.sum``, whose order differs from XLA's: β differs
in its last ulps and near-boundary exercise decisions may flip, so the tests
hold the port to the JAX package statistically (mean cashflow, share of
flipped paths).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from spectralmc_tpu_torch.ops.basket import (
    BasketCombine,
    BasketSpec,
    basket_cholesky,
    basket_component_normals,
    basket_euler_step,
)
from spectralmc_tpu_torch.ops.collectives import ProcessGroup, psum
from spectralmc_tpu_torch.ops.gbm import (
    BlackScholesContract,
    PathScheme,
    SamplingKind,
    SimImplementation,
    TermStructure,
    _normals_source,
    _step_coeffs,
    curved,
    row_keys,
    simulate_paths,
)
from spectralmc_tpu_torch.ops.heston import heston_component_normals, heston_euler_step
from spectralmc_tpu_torch.ops.merton import merton_component_normals, merton_jump_counts


class OptionSide(enum.Enum):
    PUT = "put"
    CALL = "call"


def _ridge_chol_solve(
    gram: list[list[torch.Tensor]], rhs: list[torch.Tensor], *, dtype: torch.dtype
) -> list[torch.Tensor]:
    """Solve ``(G + λ diag) β = rhs`` for a tiny k×k SPD system, one per
    contract (every entry a ``[C]`` tensor), by an unrolled Cholesky in the
    JAX package's order of operations: the RELATIVE ridge ``1e-6·max(G_jj,
    1e-30)`` on the diagonal; a pivot ``d < 8·eps·a_jj`` drops its column
    (β_j = 0: on an exactly singular Gram the pivot beyond the first column
    is summation noise at the ridge's scale, and solving with it would blow β
    up); the pivot's root is clamped at ``max(eps·a_jj, 1e-30)`` so an empty
    in-the-money set (an all-zero Gram) gives β = 0. Each entry is one
    float32 rounding per operation, the CUDA backward's solve op for op."""
    k = len(rhs)
    eps = torch.tensor(1e-6, dtype=dtype, device=rhs[0].device)
    tiny = torch.tensor(1e-30, dtype=dtype, device=rhs[0].device)
    a = [[gram[i][j] for j in range(k)] for i in range(k)]
    for i in range(k):
        a[i][i] = a[i][i] + eps * torch.maximum(a[i][i], tiny)
    low: list[list[torch.Tensor]] = [[a[0][0]] * k for _ in range(k)]  # overwritten
    keep: list[torch.Tensor] = [torch.ones_like(rhs[0])] * k
    for j in range(k):
        d = a[j][j] - sum(low[j][m] * low[j][m] for m in range(j))
        keep[j] = (d >= 8.0 * eps * a[j][j]).to(dtype)
        low[j][j] = torch.sqrt(torch.maximum(torch.maximum(d, eps * a[j][j]), tiny))
        for i in range(j + 1, k):
            s = a[i][j] - sum(low[i][m] * low[j][m] for m in range(j))
            low[i][j] = keep[j] * (s / low[j][j])
    z: list[torch.Tensor] = list(rhs)
    for i in range(k):
        z[i] = keep[i] * ((rhs[i] - sum(low[i][m] * z[m] for m in range(i))) / low[i][i])
    beta: list[torch.Tensor] = list(z)
    for i in reversed(range(k)):
        beta[i] = keep[i] * (
            (z[i] - sum(low[m][i] * beta[m] for m in range(i + 1, k))) / low[i][i]
        )
    return beta


def _per_contract(v: torch.Tensor | float, like: torch.Tensor) -> torch.Tensor:
    """A ``[C]`` (or scalar) value shaped to broadcast over ``like``'s
    ``[C, *path dims]``."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.reshape(t.shape + (1,) * (like.ndim - t.ndim)) if t.ndim else t


def lsmc_backward(
    price_rows: torch.Tensor,  # [C, monitor dates, *path dims]
    *,
    strike: torch.Tensor,  # [C]
    disc: torch.Tensor | float,  # [C] one-monitor-step discount
    dtype: torch.dtype,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,  # [C, monitor dates, *path dims]
    disc_to_prev: torch.Tensor | None = None,  # [C, monitor dates] per-segment dfs
    rows_in_log_space: bool = False,
    fit_mask: torch.Tensor | None = None,  # [*path dims] 1.0 = regression half
    cross_fit_mask: torch.Tensor | None = None,  # [*path dims] 1.0 = half A
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """Longstaff–Schwartz backward induction → cashflows discounted to t=0,
    ``[C, *path dims]`` (the JAX package's ``_lsmc_backward``).

    Basis: powers of x = 5·(S/K − 1) (centered moneyness rescaled to O(1), so
    the degree-5 Gram is well conditioned in float32), with ``extra_rows`` v
    (rescaled ×20) adding the columns [v, v·x, v²]. Moments are normalized by
    1/N. ``fit_mask`` fits β on the mask's paths and applies the policy to
    all; ``cross_fit_mask`` carries the in-sample and the 2-fold
    out-of-sample recursion and returns their per-path midpoint.
    ``disc_to_prev[:, i]`` is the discount over the segment ending at date i
    (it replaces the flat ``disc``). ``rows_in_log_space``: the rows hold log
    prices, exponentiated per date. ``paths_group`` (JAX's ``axis_name``):
    the rows are this rank's shard of the paths; the path count behind
    ``1/N`` and each date's moment sums are all-reduced over the group, so
    every shard solves the same system and applies the same policy.
    """
    if fit_mask is not None and cross_fit_mask is not None:
        raise ValueError("fit_mask and cross_fit_mask are mutually exclusive")
    base_k = basis_degree + 1
    has_extra = extra_rows is not None
    k = base_k + (3 if has_extra else 0)
    n = price_rows.shape[1]
    path_dims = tuple(range(1, price_rows.ndim - 1))

    col_exp: list[tuple[int, int]] = [(j, 0) for j in range(base_k)]
    if has_extra:
        col_exp += [(0, 1), (1, 1), (0, 2)]
    prod_exp = sorted(
        {
            (col_exp[i][0] + col_exp[j][0], col_exp[i][1] + col_exp[j][1])
            for i in range(k)
            for j in range(i, k)
        }
    )
    prod_idx = {p: i for i, p in enumerate(prod_exp)}
    max_a = max(a for a, _ in prod_exp)
    max_b = max(b for _, b in prod_exp)

    like = price_rows[:, 0]
    strike_b = _per_contract(strike.to(dtype), like)

    def immediate(s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(strike_b - s, min=0.0) if put else torch.clamp(s - strike_b, min=0.0)

    def to_price(row: torch.Tensor) -> torch.Tensor:
        return torch.exp(row) if rows_in_log_space else row

    def powers(z: torch.Tensor, top: int) -> list[torch.Tensor]:
        out = [torch.ones_like(z)]
        for _ in range(top):
            out.append(out[-1] * z)
        return out

    n_local = 1
    for d in price_rows.shape[2:]:
        n_local *= d
    inv_n = torch.tensor(1.0 / n_local, dtype=dtype, device=price_rows.device)
    if paths_group is not None:  # the global count folds in the group's size
        inv_n = inv_n / dist.get_world_size(paths_group)

    def reduced(moments: list[torch.Tensor]) -> list[torch.Tensor]:
        """The moment sums of every shard: one all-reduce of them all."""
        if paths_group is None:
            return moments
        return list(torch.unbind(psum(torch.stack(moments), paths_group)))

    def date_basis(
        row_t: torch.Tensor, extra: torch.Tensor | None
    ) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
        s_t = to_price(row_t)
        exercise_now = immediate(s_t)
        x = (s_t / strike_b - 1.0) * 5.0
        xp = powers(x, max_a)
        vp = powers(extra * 20.0, max_b) if extra is not None else [torch.ones_like(x)]
        return exercise_now, xp, vp

    def moment(w: torch.Tensor, xp: list[torch.Tensor], vp: list[torch.Tensor],
               a: int, b: int) -> torch.Tensor:
        return torch.sum(w * xp[a] * vp[b], dim=path_dims)

    def gram_from(moments: list[torch.Tensor], base: int) -> list[list[torch.Tensor]]:
        return [
            [
                moments[base + prod_idx[(col_exp[i][0] + col_exp[j][0],
                                         col_exp[i][1] + col_exp[j][1])]]
                for j in range(k)
            ]
            for i in range(k)
        ]

    def continuation(beta: list[torch.Tensor], xp: list[torch.Tensor],
                     vp: list[torch.Tensor]) -> torch.Tensor:
        return sum(_per_contract(beta[j], like) * xp[a] * vp[b]
                   for j, (a, b) in enumerate(col_exp))

    def backward(cf_next: torch.Tensor, row_t: torch.Tensor, extra: torch.Tensor | None,
                 disc_step: torch.Tensor) -> torch.Tensor:
        exercise_now, xp, vp = date_basis(row_t, extra)
        itm = (exercise_now > 0.0).to(dtype)
        y = disc_step * cf_next
        w = itm if fit_mask is None else itm * fit_mask
        wy = w * y
        moments = reduced([moment(w, xp, vp, a, b) * inv_n for a, b in prod_exp]
                          + [moment(wy, xp, vp, a, b) * inv_n for a, b in col_exp])
        rhs = moments[len(prod_exp):]
        beta = _ridge_chol_solve(gram_from(moments, 0), rhs, dtype=dtype)
        take = (itm > 0.0) & (exercise_now > continuation(beta, xp, vp))
        return torch.where(take, exercise_now, y)

    def backward_xfit(cf_next: tuple[torch.Tensor, torch.Tensor], row_t: torch.Tensor,
                      extra: torch.Tensor | None,
                      disc_step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cf_ins_next, cf_oos_next = cf_next
        exercise_now, xp, vp = date_basis(row_t, extra)
        itm = (exercise_now > 0.0).to(dtype)
        y_ins = disc_step * cf_ins_next
        y_oos = disc_step * cf_oos_next
        w_a = itm * cross_fit_mask
        w_b = itm - w_a
        wy_a = w_a * y_oos
        wy_b = w_b * y_oos
        wy_full = itm * y_ins
        p_len = len(prod_exp)
        moments = reduced(
            [moment(w_a, xp, vp, a, b) * inv_n for a, b in prod_exp]
            + [moment(w_b, xp, vp, a, b) * inv_n for a, b in prod_exp]
            + [moment(wy_a, xp, vp, a, b) * inv_n for a, b in col_exp]
            + [moment(wy_b, xp, vp, a, b) * inv_n for a, b in col_exp]
            + [moment(wy_full, xp, vp, a, b) * inv_n for a, b in col_exp]
        )
        gram_a = gram_from(moments, 0)
        gram_b = gram_from(moments, p_len)
        gram_full = [[gram_a[i][j] + gram_b[i][j] for j in range(k)] for i in range(k)]
        rhs_a = [moments[2 * p_len + j] for j in range(k)]
        rhs_b = [moments[2 * p_len + k + j] for j in range(k)]
        rhs_full = [moments[2 * p_len + 2 * k + j] for j in range(k)]
        beta_a = _ridge_chol_solve(gram_a, rhs_a, dtype=dtype)
        beta_b = _ridge_chol_solve(gram_b, rhs_b, dtype=dtype)
        beta_full = _ridge_chol_solve(gram_full, rhs_full, dtype=dtype)
        in_a = cross_fit_mask > 0.0
        cont_ins = continuation(beta_full, xp, vp)
        cont_oos = sum(
            torch.where(in_a, _per_contract(beta_b[j], like), _per_contract(beta_a[j], like))
            * xp[a] * vp[b]
            for j, (a, b) in enumerate(col_exp)
        )
        cf_ins = torch.where((itm > 0.0) & (exercise_now > cont_ins), exercise_now, y_ins)
        cf_oos = torch.where((itm > 0.0) & (exercise_now > cont_oos), exercise_now, y_oos)
        return cf_ins, cf_oos

    # walk t_{N-1} .. t_1 (rows n-2 .. 0); the date at row i discounts over
    # the segment ENDING at row i+1
    if disc_to_prev is None:
        disc_b = _per_contract(torch.as_tensor(disc, dtype=dtype, device=like.device), like)
        disc_at = [disc_b] * n
        disc_final = disc_b
    else:
        disc_at = [_per_contract(disc_to_prev[:, i].to(dtype), like) for i in range(n)]
        disc_final = disc_at[0]
    cf_terminal = immediate(to_price(price_rows[:, n - 1]))
    carry: torch.Tensor | tuple[torch.Tensor, torch.Tensor] = (
        cf_terminal if cross_fit_mask is None else (cf_terminal, cf_terminal)
    )
    for i in range(n - 2, -1, -1):
        extra = None if extra_rows is None else extra_rows[:, i]
        if cross_fit_mask is None:
            carry = backward(carry, price_rows[:, i], extra, disc_at[i + 1])
        else:
            carry = backward_xfit(carry, price_rows[:, i], extra, disc_at[i + 1])
    cf_1 = carry if cross_fit_mask is None else 0.5 * (carry[0] + carry[1])
    return disc_final * cf_1  # discounted to t = 0


def check_monitor_grid(timesteps: int, exercise_every: int) -> None:
    """``exercise_every`` must divide ``timesteps`` (maturity is a monitor
    date) and leave >= 2 monitor dates (one date is the European option)."""
    if exercise_every < 1 or timesteps % exercise_every:
        raise ValueError(
            f"exercise_every={exercise_every} must divide timesteps={timesteps}"
        )
    if timesteps // exercise_every < 2:
        raise ValueError(
            f"early exercise needs >= 2 monitor dates; timesteps={timesteps} "
            f"with exercise_every={exercise_every} leaves "
            f"{timesteps // exercise_every}"
        )


def encode_monitor_prices(
    price_rows: torch.Tensor,  # [C, monitor dates, *path dims] (price space unless log)
    *,
    strike: torch.Tensor,  # [C]
    maturity: torch.Tensor,  # [C]
    rate: torch.Tensor,  # [C]
    disc_monitor: torch.Tensor,  # [C] one-MONITOR-step discount e^{-r·dt·every}
    dtype: torch.dtype,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
    disc_to_prev: torch.Tensor | None = None,  # [C, monitor dates] under curves
    df_total: torch.Tensor | None = None,  # [C] the curve's df(0, T)
    rows_in_log_space: bool = False,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """Backward induction + synthetic-underlier encode ``u = K − cf/df``,
    ``[C, *path dims]``. ``cross_fit`` splits the 2-fold out-of-sample
    policy on the parity of the last (column) index; ``paths_group`` is
    ``lsmc_backward``'s."""
    cf = lsmc_backward(
        price_rows,
        strike=strike,
        disc=disc_monitor,
        dtype=dtype,
        put=put,
        basis_degree=basis_degree,
        extra_rows=extra_rows,
        disc_to_prev=disc_to_prev,
        rows_in_log_space=rows_in_log_space,
        cross_fit_mask=(
            cross_fit_col_mask(price_rows.shape[-1], dtype=dtype, device=price_rows.device)
            if cross_fit else None
        ),
        paths_group=paths_group,
    )
    like = cf
    df = torch.exp(-rate * maturity) if df_total is None else df_total
    return _per_contract(strike, like) - cf / _per_contract(df, like)


def _american_encode(
    log_rows: torch.Tensor,  # [C, monitor dates, rows, cols] log prices at the monitor dates
    *,
    timesteps: int,
    exercise_every: int,
    strike: torch.Tensor,
    maturity: torch.Tensor,
    rate: torch.Tensor,
    dt: torch.Tensor,
    dtype: torch.dtype,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
    term: TermStructure | None = None,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """The Bermudan tail of the threefry engine over its monitor-date log
    rows (the JAX package's ``_american_encode`` after its monitor slice):
    flat one-monitor-step discounts, or under a curved ``term`` the
    per-segment discounts of the rate curve and the curve-effective encode
    df ``exp(−r·mean(rs)·T)``. ``extra_rows``, the second state at the same
    monitor dates, augments the regression basis."""
    disc_to_prev = None
    df_total = None
    if term is not None:
        _, rs, _ = term.shapes(timesteps)
        rsa = torch.tensor(rs, dtype=dtype, device=log_rows.device)
        rate_dt = rate[:, None] * rsa * dt[:, None]  # [C, T] per-step r_t dt
        seg = rate_dt.reshape(-1, timesteps // exercise_every, exercise_every).sum(dim=2)
        disc_to_prev = torch.exp(-seg)
        mr = sum(rs) / timesteps
        df_total = torch.exp(-rate * torch.tensor(mr, dtype=dtype) * maturity)
    return encode_monitor_prices(
        log_rows,
        strike=strike,
        maturity=maturity,
        rate=rate,
        disc_monitor=torch.exp(-rate * dt * exercise_every),
        dtype=dtype,
        put=put,
        basis_degree=basis_degree,
        extra_rows=extra_rows,
        disc_to_prev=disc_to_prev,
        df_total=df_total,
        rows_in_log_space=True,
        cross_fit=cross_fit,
        paths_group=paths_group,
    )


def simulate_american_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: int = 0,
    antithetic_half: int | None = None,
    term: TermStructure | None = None,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic underliers of the American payoff kinds
    on the threefry stream (the JAX package's function, batched).

    The log-Euler walk draws the canonical (contract key, global row,
    timestep) normals of ``gbm.simulate_terminal_rows``; only the monitor
    dates' log rows are kept. The Bermudan cashflow cf (discounted to t=0)
    is encoded as ``u = K − cf/df``. With ``paths_group`` the rows are one
    shard of the paths (at ``row_offset``) and the regression spans them all.
    """
    check_monitor_grid(timesteps, exercise_every)
    term = curved(term)
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / timesteps
    log_drift, _, vol_step = _step_coeffs(
        term, timesteps=timesteps, rate=rate, div_yield=div_yield, vol=vol, dt=dt,
        sqrt_dt=torch.sqrt(dt),
    )
    normals = _normals_source(
        contract_keys, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        row_offset=row_offset, antithetic_half=antithetic_half,
        sampling=SamplingKind.PSEUDO, mc_seed=0,
    )
    logx = torch.zeros((c.shape[0], rows, cols), dtype=dtype, device=c.device) + torch.log(spot)
    monitor = []
    for t in range(timesteps):
        logx = logx + log_drift(t) + vol_step(t) * normals(t)
        if (t + 1) % exercise_every == 0:
            monitor.append(logx)
    return _american_encode(
        torch.stack(monitor, dim=1),
        timesteps=timesteps,
        exercise_every=exercise_every,
        strike=c[:, 1],
        maturity=c[:, 2],
        rate=c[:, 3],
        dt=dt[:, 0, 0],
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        term=term,
        cross_fit=cross_fit,
        paths_group=paths_group,
    )


def _monitor(rows: torch.Tensor, exercise_every: int) -> torch.Tensor:
    """The monitor dates of ``[C, timesteps, ...]`` state rows."""
    return rows[:, exercise_every - 1::exercise_every]


def heston_state_rows(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    *,
    spot: torch.Tensor,
    v0: torch.Tensor,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    **step_consts: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(log_rows, v_rows)``, each ``[C, timesteps, rows, cols]``: the Heston
    state after every step for row keys ``[C, rows, 2]``, drawn through the
    European simulator's own helpers (``ops/heston.py::
    heston_component_normals`` and ``heston_euler_step``), so the last log
    row is its TERMINAL value bit for bit. ``spot`` and ``v0`` are ``[C, 1,
    1]``; ``step_consts`` are ``heston_euler_step``'s coefficients."""
    shape = (keys.shape[0], rows, cols)
    logx = torch.zeros(shape, dtype=dtype, device=keys.device) + torch.log(spot)
    v = torch.ones(shape, dtype=dtype, device=keys.device) * v0
    log_rows, v_rows = [], []
    for t in range(timesteps):
        z_v = heston_component_normals(keys, sign, t, 0, cols, dtype)
        z_orth = heston_component_normals(keys, sign, t, 1, cols, dtype)
        logx, v = heston_euler_step(logx, v, z_v, z_orth, **step_consts)
        log_rows.append(logx)
        v_rows.append(v)
    return torch.stack(log_rows, dim=1), torch.stack(v_rows, dim=1)


def simulate_heston_american_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: int = 0,
    antithetic_half: int | None = None,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers under Heston
    dynamics on the threefry stream (the JAX package's function, batched).
    ``contracts`` is ``[C, 10]`` in ``HestonContract`` order. The basis adds
    ``[v, v·x, v²]`` of ``max(v, 0)``: under stochastic vol the continuation
    value depends on the variance too."""
    check_monitor_grid(timesteps, exercise_every)
    c = contracts.to(dtype)
    spot, strike, maturity, rate, div_yield, v0, kappa, theta, xi, rho = (
        c[:, i, None, None] for i in range(10)
    )
    dt = maturity / torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    keys, sign = row_keys(contract_keys, rows=rows, row_offset=row_offset,
                          antithetic_half=antithetic_half, dtype=dtype)
    log_rows, v_rows = heston_state_rows(
        keys, sign, spot=spot, v0=v0, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        rate=rate, div_yield=div_yield, dt=dt, sqrt_dt=torch.sqrt(dt), rho=rho,
        rho_bar=torch.sqrt(1.0 - rho * rho), kappa=kappa, theta=theta, xi=xi,
    )
    return _american_encode(
        _monitor(log_rows, exercise_every), timesteps=timesteps, exercise_every=exercise_every,
        strike=c[:, 1], maturity=c[:, 2], rate=c[:, 3], dt=dt[:, 0, 0], dtype=dtype,
        put=option == OptionSide.PUT, basis_degree=basis_degree,
        extra_rows=torch.clamp(_monitor(v_rows, exercise_every), min=0.0), cross_fit=cross_fit,
        paths_group=paths_group,
    )


def merton_state_rows(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    *,
    spot: torch.Tensor,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    drift: torch.Tensor,
    vol_sqdt: torch.Tensor,
    lam_dt: torch.Tensor,
    jump_mean: torch.Tensor,
    jump_std: torch.Tensor,
) -> torch.Tensor:
    """``[C, timesteps, rows, cols]`` log-spot after every step under Merton
    dynamics, drawn through the European simulator's helpers
    (``ops/merton.py::merton_component_normals``, ``merton_jump_counts``):
    the last row is its TERMINAL value bit for bit."""
    logx = torch.zeros((keys.shape[0], rows, cols), dtype=dtype, device=keys.device)
    logx = logx + torch.log(spot)
    log_rows = []
    for t in range(timesteps):
        z_d = merton_component_normals(keys, sign, t, 0, cols, dtype)
        z_j = merton_component_normals(keys, sign, t, 1, cols, dtype)
        counts = merton_jump_counts(keys, t, lam_dt, cols, dtype)
        jump = counts * jump_mean + jump_std * torch.sqrt(counts) * z_j
        logx = logx + drift + vol_sqdt * z_d + jump
        log_rows.append(logx)
    return torch.stack(log_rows, dim=1)


def simulate_merton_american_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: int = 0,
    antithetic_half: int | None = None,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers under Merton
    dynamics on the threefry stream (the JAX package's function, batched).
    ``contracts`` is ``[C, 9]`` in ``MertonContract`` order. The spot alone
    is Markov (jumps are memoryless): the plain moneyness basis."""
    check_monitor_grid(timesteps, exercise_every)
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol, lam, jump_mean, jump_std = (
        c[:, i, None, None] for i in range(9)
    )
    dt = maturity / torch.tensor(float(timesteps), dtype=dtype, device=c.device)
    m = torch.exp(jump_mean + 0.5 * jump_std * jump_std) - 1.0
    keys, sign = row_keys(contract_keys, rows=rows, row_offset=row_offset,
                          antithetic_half=antithetic_half, dtype=dtype)
    log_rows = merton_state_rows(
        keys, sign, spot=spot, timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        drift=(rate - div_yield - lam * m - 0.5 * vol * vol) * dt,
        vol_sqdt=vol * torch.sqrt(dt), lam_dt=lam * dt, jump_mean=jump_mean, jump_std=jump_std,
    )
    return _american_encode(
        _monitor(log_rows, exercise_every), timesteps=timesteps, exercise_every=exercise_every,
        strike=c[:, 1], maturity=c[:, 2], rate=c[:, 3], dt=dt[:, 0, 0], dtype=dtype,
        put=option == OptionSide.PUT, basis_degree=basis_degree, cross_fit=cross_fit,
        paths_group=paths_group,
    )


def basket_state_rows(
    keys: torch.Tensor,
    sign: torch.Tensor | None,
    *,
    log_spots: torch.Tensor,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    drift: torch.Tensor,
    sig_sqdt: torch.Tensor,
    chol: torch.Tensor,
    weights: torch.Tensor,
    geometric: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lb_rows, disp_rows)``, each ``[C, timesteps, rows, cols]``: the log
    basket value after every step and, for the arithmetic combine, the log
    dispersion ``ln(B_arith/B_geom)`` (zeros for the geometric one, whose
    ``ln B`` is Markov), drawn through the European simulator's helpers
    (``ops/basket.py::basket_component_normals``, ``basket_euler_step``).
    ``log_spots``, ``drift`` and ``sig_sqdt`` are ``[A, C, 1, 1]``,
    ``weights`` ``[A, 1, 1, 1]``, ``chol`` ``[A, A]``."""
    a_n = chol.shape[0]
    logx = torch.zeros((a_n, keys.shape[0], rows, cols), dtype=dtype, device=keys.device)
    logx = logx + log_spots
    lb_rows, disp_rows = [], []
    for t in range(timesteps):
        z = basket_component_normals(keys, sign, t, a_n, cols, dtype)
        logx = basket_euler_step(logx, z, drift=drift, sig_sqdt=sig_sqdt, chol=chol)
        lg = torch.sum(weights * logx, dim=0)  # the log geometric basket
        if geometric:
            lb_rows.append(lg)
            disp_rows.append(torch.zeros_like(lg))
        else:
            lb = torch.log(torch.sum(weights * torch.exp(logx), dim=0))
            lb_rows.append(lb)
            disp_rows.append(lb - lg)  # ln(B_arith/B_geom) >= 0 (Jensen)
    return torch.stack(lb_rows, dim=1), torch.stack(disp_rows, dim=1)


def simulate_basket_american_underlier_rows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: int = 0,
    antithetic_half: int | None = None,
    cross_fit: bool = False,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers under basket
    dynamics on the threefry stream (the JAX package's function, batched):
    exercise compares the strike with the combined basket value. The
    geometric combine's ``ln B`` is Markov (the plain basis is the exact
    state); the arithmetic combine regresses on the log dispersion too."""
    check_monitor_grid(timesteps, exercise_every)
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / torch.tensor(float(timesteps), dtype=dtype, device=c.device)

    def per_asset(values: tuple[float, ...]) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=c.device)[:, None, None, None]

    sigmas = vol * per_asset(spec.vol_multipliers)
    geometric = spec.combine == BasketCombine.GEOMETRIC
    keys, sign = row_keys(contract_keys, rows=rows, row_offset=row_offset,
                          antithetic_half=antithetic_half, dtype=dtype)
    lb_rows, disp_rows = basket_state_rows(
        keys, sign, log_spots=torch.log(spot * per_asset(spec.spot_multipliers)),
        timesteps=timesteps, rows=rows, cols=cols, dtype=dtype,
        drift=(rate - div_yield - 0.5 * sigmas * sigmas) * dt, sig_sqdt=sigmas * torch.sqrt(dt),
        chol=torch.as_tensor(basket_cholesky(spec), dtype=dtype, device=c.device),
        weights=per_asset(spec.weights), geometric=geometric,
    )
    return _american_encode(
        _monitor(lb_rows, exercise_every), timesteps=timesteps, exercise_every=exercise_every,
        strike=c[:, 1], maturity=c[:, 2], rate=c[:, 3], dt=dt[:, 0, 0], dtype=dtype,
        put=option == OptionSide.PUT, basis_degree=basis_degree,
        extra_rows=None if geometric else _monitor(disp_rows, exercise_every),
        cross_fit=cross_fit, paths_group=paths_group,
    )


def split_fit_mask(paths: int, *, dtype: torch.dtype,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The split-sample estimator's fit half: 1.0 on even path indices."""
    return (torch.arange(paths, device=device) % 2 == 0).to(dtype)


def cross_fit_col_mask(cols: int, *, dtype: torch.dtype,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """The cross-fitted estimator's half A: 1.0 on even COLUMN indices (it
    broadcasts over rows). Column parity keeps an antithetic pair, which
    mirrors whole rows, inside one half."""
    return (torch.arange(cols, device=device) % 2 == 0).to(dtype)


def lsmc_cashflows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    paths: int,
    dtype: torch.dtype,
    option: OptionSide = OptionSide.PUT,
    basis_degree: int = 5,
    split_sample: bool = False,
    cross_fit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cashflows discounted to t=0, terminal values)``, each ``[C, paths]``,
    on the threefry path matrix of ``gbm.simulate_paths`` with exercise at
    every timestep. ``split_sample`` fits β on the even paths only (the odd
    half's mean is an out-of-sample lower bound); ``cross_fit`` returns the
    bracket midpoint of the in-sample and the 2-fold out-of-sample recursion
    split on path parity."""
    c = contracts.to(dtype)
    strike, maturity, rate = c[:, 1], c[:, 2], c[:, 3]
    disc = torch.exp(-rate * (maturity / timesteps))
    s = simulate_paths(contract_keys, c, timesteps=timesteps, paths=paths, dtype=dtype,
                       scheme=PathScheme.LOG_EULER, normalize=False)
    cf = lsmc_backward(
        s,
        strike=strike,
        disc=disc,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        fit_mask=split_fit_mask(paths, dtype=dtype, device=c.device) if split_sample else None,
        cross_fit_mask=(cross_fit_col_mask(paths, dtype=dtype, device=c.device)
                        if cross_fit else None),
    )
    return cf, s[:, timesteps - 1]


def _cuda_cashflows(
    contract_keys: torch.Tensor,
    contracts: torch.Tensor,
    *,
    timesteps: int,
    paths: int,
    option: OptionSide,
    basis_degree: int,
    split_sample: bool,
    cross_fit: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``lsmc_cashflows`` on the ``"cuda"`` engine, float32: the monitor-row
    kernel's ``[C, T, rows, cols]`` rows (512 columns where they divide the
    paths), then the engine's backward (``american_cuda.monitor_underliers``)
    — or, for the split-sample fit, the torch estimator with its mask."""
    from spectralmc_tpu_torch.ops import american_cuda

    c = contracts.to(torch.float32)
    cols = 512 if paths % 512 == 0 else paths
    rows = american_cuda.simulate_american_rows_cuda(
        c, contract_keys, timesteps=timesteps, rows=paths // cols, cols=cols, exercise_every=1)
    flat = rows.reshape(c.shape[0], timesteps, paths)
    if split_sample:
        disc, _ = american_cuda.monitor_discounts(c, timesteps=timesteps, exercise_every=1)
        cf = lsmc_backward(
            flat, strike=c[:, 1], disc=disc, dtype=torch.float32,
            put=option == OptionSide.PUT, basis_degree=basis_degree,
            fit_mask=split_fit_mask(paths, dtype=torch.float32, device=c.device),
        )
        return cf, flat[:, timesteps - 1]
    backward = american_cuda.cuda_backward_version(
        dtype=torch.float32, n_monitor=timesteps, cross_fit=cross_fit)
    u = american_cuda.monitor_underliers(
        rows, c, timesteps=timesteps, exercise_every=1, option=option,
        basis_degree=basis_degree, cross_fit=cross_fit, backward=backward)
    _, df = american_cuda.monitor_discounts(c, timesteps=timesteps, exercise_every=1)
    cf = (c[:, 1, None] - u.reshape(c.shape[0], paths)) * df[:, None]  # u = K − cf/df
    return cf, flat[:, timesteps - 1]


@dataclass(frozen=True)
class AmericanPrice:
    price: float
    std_error: float
    european: float  # same-path European price (control / lower bound)
    # control-variate estimate price − β·(european_mc − european_black)
    cv_price: float = float("nan")
    cv_std_error: float = float("nan")
    # split_sample: price/std_error/cv_* are the out-of-sample half's and
    # in_sample_price the fit half's (high-biased) mean
    in_sample_price: float = float("nan")


def lsmc_price(
    sim_key: torch.Tensor,
    contract: BlackScholesContract,
    *,
    timesteps: int,
    paths: int,
    option: OptionSide = OptionSide.PUT,
    basis_degree: int = 5,
    dtype: torch.dtype = torch.float32,
    split_sample: bool = False,
    cross_fit: bool = False,
    implementation: SimImplementation = SimImplementation.XLA,
    device: torch.device | str,
) -> AmericanPrice:
    """Host-facing Bermudan price (exercise at every timestep) with a
    standard error, the same-path European leg and its control variate.

    ``sim_key`` is the threefry key ``[2]`` of the paths. ``implementation``
    picks the engine: ``"xla"`` draws the JAX package's threefry path matrix
    (``lsmc_cashflows``), ``"cuda"`` the monitor-row kernel's Philox paths
    with the CUDA backward (float32; on a CPU ``device``, their plain twins).
    ``device`` is where the paths are drawn, and the caller names it: a key
    on the CPU moves there, a key on another device is refused, never
    copied back. ``split_sample`` prices out of sample on the odd paths and
    records the even half's in-sample mean; ``cross_fit`` prices the bracket
    midpoint.
    """
    device = torch.device(device)
    if sim_key.device.type not in ("cpu", device.type):
        raise ValueError(f"sim_key lies on {sim_key.device}; lsmc_price was asked to run on "
                         f"{device}")
    fields = (contract.spot, contract.strike, contract.maturity, contract.rate,
              contract.div_yield, contract.vol)
    arr = torch.tensor([fields], dtype=dtype, device=device)
    keys = sim_key.reshape(1, 2).to(device)
    kw = dict(timesteps=timesteps, paths=paths, option=option, basis_degree=basis_degree,
              split_sample=split_sample, cross_fit=cross_fit)
    if implementation == SimImplementation.CUDA:
        cf, terminal = _cuda_cashflows(keys, arr, **kw)
    elif implementation == SimImplementation.XLA:
        cf, terminal = lsmc_cashflows(keys, arr, dtype=dtype, **kw)
    else:
        raise ValueError(f"lsmc_price runs the 'xla' or 'cuda' engine, not {implementation}")
    cf, terminal = cf[0], terminal[0]
    in_sample = float("nan")
    if split_sample:
        in_sample = float(torch.mean(cf[0::2]))
        cf, terminal = cf[1::2], terminal[1::2]
    strike, maturity, rate = arr[0, 1], arr[0, 2], arr[0, 3]
    df = torch.exp(-rate * maturity)
    if option == OptionSide.PUT:
        euro = df * torch.clamp(strike - terminal, min=0.0)
    else:
        euro = df * torch.clamp(terminal - strike, min=0.0)
    from spectralmc_tpu_torch.ops.analytic import black_scholes_price

    prices = black_scholes_price(*fields)
    euro_exact = (prices.put if option == OptionSide.PUT else prices.call).to(cf.dtype)
    euro_centered = euro - torch.mean(euro)
    var_euro = torch.mean(euro_centered * euro_centered)
    beta = torch.where(
        var_euro > 0.0,
        torch.mean((cf - torch.mean(cf)) * euro_centered) / torch.clamp(var_euro, min=1e-30),
        torch.zeros_like(var_euro),
    )
    cv = cf - beta * (euro - euro_exact.to(cf.device))
    sqrt_n = float(np.sqrt(cf.numel()))
    return AmericanPrice(
        price=float(torch.mean(cf)),
        std_error=float(torch.std(cf, unbiased=False)) / sqrt_n,
        european=float(torch.mean(euro)),
        cv_price=float(torch.mean(cv)),
        cv_std_error=float(torch.std(cv, unbiased=False)) / sqrt_n,
        in_sample_price=in_sample,
    )


def bermudan_tree_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    exercise_dates: int,
    tree_steps: int = 4000,
    option: str = "put",
) -> float:
    """CRR binomial Bermudan oracle (host numpy float64), exercise only at the
    ``exercise_dates`` layers t_i = i·T/exercise_dates (plus maturity), the
    LSMC monitor grid. ``tree_steps`` rounds up to a multiple of
    ``exercise_dates``."""
    per = -(-tree_steps // exercise_dates)
    n = per * exercise_dates
    dt = maturity / n
    u = float(np.exp(vol * np.sqrt(dt)))
    d = 1.0 / u
    growth = float(np.exp((rate - div_yield) * dt))
    p = (growth - d) / (u - d)
    if not 0.0 < p < 1.0:
        raise ValueError(f"CRR probability out of range: {p}")
    disc = float(np.exp(-rate * dt))

    j = np.arange(n + 1, dtype=np.float64)
    s_t = spot * u ** (n - j) * d**j

    def payoff(x: np.ndarray) -> np.ndarray:
        return np.maximum(strike - x, 0.0) if option == "put" else np.maximum(x - strike, 0.0)

    value = payoff(s_t)
    for step in range(n - 1, -1, -1):
        value = disc * (p * value[:-1] + (1.0 - p) * value[1:])
        if step % per == 0 and step > 0:  # a monitor date layer
            j = np.arange(step + 1, dtype=np.float64)
            s_t = spot * u ** (step - j) * d**j
            value = np.maximum(value, payoff(s_t))
    return float(value[0])


def bermudan_grid_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    timesteps: int,
    exercise_every: int = 1,
    option: str = "put",
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
    grid_points: int = 2049,
    width_std: float = 8.0,
) -> float:
    """Bermudan put/call by Gaussian-transition backward induction on a log
    grid (host numpy float64): the lattice oracle under term structures.
    Exercise only on the monitor dates k·every·dt; each step's continuation
    through the exact one-step Gaussian transition of the log-Euler walk,
    discounted at the step's own curve rate."""
    check_monitor_grid(timesteps, exercise_every)
    n = int(timesteps)
    dt = maturity / n
    vs = np.asarray(vol_shape or (1.0,) * n, dtype=np.float64)
    rs = np.asarray(rate_shape or (1.0,) * n, dtype=np.float64)
    qs = np.asarray(div_shape or (1.0,) * n, dtype=np.float64)
    vol_t = vol * vs
    drift_t = (rate * rs - div_yield * qs - 0.5 * vol_t * vol_t) * dt
    sd_t = vol_t * np.sqrt(dt)
    if (sd_t <= 0.0).any():
        raise ValueError("bermudan_grid_price needs positive per-step vol")
    disc_t = np.exp(-rate * rs * dt)
    total_sd = float(np.sqrt((sd_t * sd_t).sum()))
    ln_s0 = float(np.log(spot))
    center = ln_s0 + float(drift_t.sum())
    lo = center - width_std * total_sd
    hi = center + width_std * total_sd
    x = np.linspace(lo, hi, grid_points)
    s_x = np.exp(x)

    def payoff(s: np.ndarray) -> np.ndarray:
        return np.maximum(strike - s, 0.0) if option == "put" else np.maximum(s - strike, 0.0)

    def transition(j: int) -> np.ndarray:
        # [to, from]: density of x_to given x_from under step j
        z = (x[:, None] - (x[None, :] + drift_t[j])) / sd_t[j]
        dx = x[1] - x[0]
        return np.exp(-0.5 * z * z) / (sd_t[j] * np.sqrt(2.0 * np.pi)) * dx

    value = payoff(s_x)
    for j in range(n - 1, -1, -1):
        value = disc_t[j] * (transition(j).T @ value)
        if j > 0 and j % exercise_every == 0:
            value = np.maximum(value, payoff(s_x))
    return float(np.interp(ln_s0, x, value))


__all__ = [
    "AmericanPrice",
    "OptionSide",
    "basket_state_rows",
    "bermudan_grid_price",
    "bermudan_tree_price",
    "check_monitor_grid",
    "cross_fit_col_mask",
    "encode_monitor_prices",
    "heston_state_rows",
    "lsmc_backward",
    "lsmc_cashflows",
    "lsmc_price",
    "merton_state_rows",
    "simulate_american_underlier_rows",
    "simulate_basket_american_underlier_rows",
    "simulate_heston_american_underlier_rows",
    "simulate_merton_american_underlier_rows",
    "split_fit_mask",
]
