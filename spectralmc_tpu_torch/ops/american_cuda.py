"""The ``"cuda"`` engine's American (LSMC) kernels: the monitor-row forwards and the backward.

``csrc/american_paths.cu`` replaces ``ops/gbm_pallas.py::
_gbm_monitor_block_kernel`` (the GBM monitor-row forward);
``csrc/american_dynamics.cu`` replaces ``_heston_monitor_block_kernel``,
``_merton_monitor_block_kernel`` and ``_basket_monitor_block_kernel``;
``csrc/lsmc_backward.cuh`` (built as ``csrc/lsmc_backward.cu``, single
state, and ``csrc/lsmc_two_state.cu``) replaces ``ops/lsmc_pallas.py::
_fused_backward_kernel`` and ``_streamed_backward_kernel`` by one persistent
kernel with two routes: the carrier resident on chip, or in HBM
(``lsmc_route``). Each header states what it keeps, what it drops and what
bounds it. This module holds

* the public wrappers ``simulate_american_rows_cuda`` (``[C, n_monitor,
  rows, cols]`` GBM price rows), ``simulate_heston_american_rows_cuda``
  (price and ``max(v, 0)`` rows), ``simulate_merton_american_rows_cuda``
  (price rows), ``simulate_basket_american_rows_cuda`` (basket-value rows
  and, for the arithmetic combine, log-dispersion rows) and
  ``lsmc_backward_cuda`` (``[C, rows, cols]`` synthetic underliers ``u = K −
  cf/df``, from price rows and optionally a second state's rows): a CPU
  tensor goes to the plain twin, a CUDA tensor launches the kernel or raises.
  There is no fallback.
* the plain twins ``…_cuda_plain`` of the forwards (the same Philox words
  and float32 arithmetic in torch ops; ``words=0`` replays the TPU
  interpreter's zero bits) and ``lsmc_backward_cuda_plain`` (the same
  lagged order of dates and the same reduction order: per thread 16 paths
  in order, a tile's 256 threads folded — one state: a halving tree over
  all 256; two states: over each warp's 32 lanes, then the 8 warps in
  order — the tiles' partials summed per thread in order and folded the
  same way, and the solve of ``ops/american.py::_ridge_chol_solve``), so
  its β and every exercise decision equal the kernel's bit for bit, on
  either route.
* ``simulate_american_underlier_rows_cuda`` — the engine's American
  simulator: the forward kernel of the sim's dynamics, then
  ``monitor_underliers``: the CUDA backward or the torch estimator
  (``ops/american.py::encode_monitor_prices``), as ``cuda_backward_version``
  decides. The engine runs the CUDA backward wherever it computes the
  estimator asked for: the classic one on the price alone (GBM, Merton, the
  geometric basket) and the two-state one (Heston's variance, the
  arithmetic basket's dispersion). Cross-fit and curved terms take the
  torch one.
* ``LSMC_BACKWARD_VERSIONS``, ``cuda_backward_version`` and
  ``resolve_lsmc_backward`` — which backward ran is checkpoint state: its
  reduction order decides near-boundary exercise bits. 0 is the torch
  estimator; the CUDA backward's values (3 single-state, 4 two-state)
  collide with neither of the JAX package's kernels (1 fused, 2 streamed),
  which the port cannot run.

Launch counts go to ``gbm_cuda.LAUNCHES`` and ``LAUNCHES_BY_BRANCH``:
``american_gbm``, ``american_heston``, ``american_merton`` and
``american_basket`` per forward launch, and one per backward, by route and
mode: ``lsmc_backward`` (resident) and ``lsmc_backward_streamed``,
``lsmc_two_state`` and ``lsmc_two_state_streamed``. ``LAUNCHES_BY_BRANCH``
also counts ``monitor_underliers``' runs of the torch estimator under
``torch_estimator`` (no kernel, so not in ``LAUNCHES``), which shows that a
path never left the CUDA backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectralmc_tpu_torch.ops.american import OptionSide, _ridge_chol_solve, check_monitor_grid
from spectralmc_tpu_torch.ops.basket import BasketCombine, BasketSpec, basket_cholesky
from spectralmc_tpu_torch.ops.collectives import ProcessGroup
from spectralmc_tpu_torch.ops.dynamics_cuda import (
    heston_coeffs_plain,
    heston_step_plain,
    merton_calls,
    merton_step_plain,
    merton_table,
    merton_words,
)
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    ModelKind,
    SimImplementation,
    SimulationParams,
    curved,
    resolve_implementation,
)
from spectralmc_tpu_torch.ops.gbm_cuda import (
    LAUNCHES_BY_BRANCH,
    MAX_BASKET_ASSETS,
    MAX_MONITOR_DATES,
    _check,
    _count,
    _cospi,
    _device_args,
    _pair_draws,
    _sinpi,
    _stream,
)

LSMC_BACKWARD_VERSIONS: dict[str, int] = {"cuda": 3, "cuda_two_state": 4}
THREADS = 256  # csrc/lsmc_backward.cuh's kThreads
PER_THREAD = 16  # its kPerThread
BLOCK_PATHS = THREADS * PER_THREAD

_SQRT2 = math.sqrt(2.0)


def cuda_backward_version(
    *, dtype: torch.dtype, n_monitor: int, cross_fit: bool = False, term: bool = False,
    two_state: bool = False,
) -> int:
    """The backward the ``"cuda"`` engine runs on its monitor rows: the CUDA
    backward where it computes the estimator asked for — the classic
    recursion with flat discounting (no cross-fitted pair, no curved term),
    float32, at least 2 monitor dates; any path count, basis degree 1–8, put
    or call — ``LSMC_BACKWARD_VERSIONS["cuda"]`` on the price alone,
    ``["cuda_two_state"]`` with a second state row set (``two_state``);
    else 0, the torch estimator."""
    if dtype == torch.float32 and n_monitor >= 2 and not cross_fit and not term:
        return LSMC_BACKWARD_VERSIONS["cuda_two_state" if two_state else "cuda"]
    return 0


def two_state(sim: SimulationParams) -> bool:
    """Whether the sim's LSMC regression takes a second state row set:
    Heston's variance and the arithmetic basket's log dispersion; GBM,
    Merton and the geometric basket are Markov in the price alone."""
    if sim.model == ModelKind.HESTON:
        return True
    return (sim.model == ModelKind.BASKET_GBM and sim.basket is not None
            and sim.basket.combine == BasketCombine.ARITHMETIC)


def resolve_lsmc_backward(sim: SimulationParams, *, rows: int, sharded: bool = False) -> int:
    """The LSMC backward version that will ACTUALLY run for this sim — 0 =
    the torch estimator, 3 and 4 the CUDA backward on one and two states —
    for the engine's simulator (``ops/dispatch.py``) and the trainer's
    recorded ``lsmc_backward_version``: ``cuda_backward_version`` wherever
    the ``"cuda"`` engine runs an American forward
    (``resolve_implementation``). So GBM, Merton and geometric baskets take
    version 3, Heston and arithmetic baskets 4, cross-fit 0.
    ``lsmc_fused_backward`` is the JAX package's request for its TPU
    kernels; the config gates hold it to the JAX package's rules, and it
    routes nothing here. On a mesh (``sharded``) it is 0, as the JAX
    package's is: the regression all-reduces its moment sums over the paths
    group at every date, and one cooperative launch cannot wait on a
    collective per date."""
    if sim.payoff not in AMERICAN_PAYOFFS or rows <= 0 or sharded:
        return 0
    if resolve_implementation(sim) != SimImplementation.CUDA:
        return 0
    return cuda_backward_version(
        dtype=sim.precision.to_torch(),
        n_monitor=sim.timesteps // sim.lsmc_exercise_every,
        cross_fit=sim.lsmc_cross_fit,
        term=curved(sim.term) is not None,
        two_state=two_state(sim),
    )


# --------------------------------------------------------------------------
# The plain twins
# --------------------------------------------------------------------------


def simulate_american_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The monitor-row kernel's plain twin: ``[C, timesteps // every, rows,
    cols]`` float32 prices at the monitor dates. Per segment ``every // 2``
    pair steps, then one single step when ``every`` is odd, the draws
    numbered on across segments. The Box–Muller is torch's float64 sine and
    cosine and float32 ``log`` and ``sqrt``: the kernel's pair steps (the
    flat kernel's, ``csrc/gbm_step.cuh``) and its single step (on the SFU;
    stream ``american_gbm`` v3) agree with it to rtol 2e-5. ``words`` (tests
    only) replaces the generator: a tensor broadcastable to ``[C, rows,
    cols, calls, 4]``."""
    _check(params, key_words)
    check_monitor_grid(timesteps, exercise_every)
    monitors = timesteps // exercise_every
    pairs = exercise_every // 2
    draws = monitors * (pairs + exercise_every % 2)
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=-(-draws // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, _, maturity, rate, div, vol = (params[:, i, None, None] for i in range(6))
    dt = maturity / float(timesteps)
    vol_sdt = vol * torch.sqrt(dt)
    drift = (rate - div - 0.5 * vol * vol) * dt
    two_drift = 2.0 * drift
    logx = torch.log(spot).expand(params.shape[0], rows, cols)
    out = torch.empty((params.shape[0], monitors, rows, cols), dtype=torch.float32,
                      device=params.device)
    j = 0
    for d in range(monitors):
        for _ in range(pairs):
            u1, u2 = uniforms(j)
            j += 1
            z = sign * (torch.sqrt(-2.0 * torch.log(u1)) * _SQRT2 * _sinpi(2.0 * u2 + 0.25))
            logx = (logx + two_drift) + vol_sdt * z
        if exercise_every % 2:
            u1, u2 = uniforms(j)
            j += 1
            z = sign * (torch.sqrt(-2.0 * torch.log(u1)) * _cospi(2.0 * u2))
            logx = (logx + drift) + vol_sdt * z
        out[:, d] = torch.exp(logx)
    return out


def _monitor_out(params: torch.Tensor, monitors: int, rows: int, cols: int) -> torch.Tensor:
    return torch.empty((params.shape[0], monitors, rows, cols), dtype=torch.float32,
                       device=params.device)


def simulate_heston_american_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Heston monitor kernel's plain twin: ``(price, var)``, each ``[C,
    timesteps // every, rows, cols]`` float32, ``exp(log S)`` and ``max(v,
    0)`` at the monitor dates. ``params`` is ``[C, 10]``; the step is
    ``dynamics_cuda.heston_step_plain``, one draw a step, on the kernel's
    roundings: the variance rows are the kernel's bit for bit, the price
    rows ``exp`` of its log-price. ``words`` (tests only) replaces the
    generator: a tensor broadcastable to ``[C, rows, cols, calls, 4]``."""
    _check(params, key_words, 10)
    check_monitor_grid(timesteps, exercise_every)
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=-(-timesteps // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, v0 = params[:, 0, None, None], params[:, 5, None, None]
    coeffs = heston_coeffs_plain(params, timesteps)
    shape = (params.shape[0], rows, cols)
    logx = torch.log(spot).expand(shape)
    v = v0.expand(shape)
    monitors = timesteps // exercise_every
    price = _monitor_out(params, monitors, rows, cols)
    var = _monitor_out(params, monitors, rows, cols)
    for j in range(timesteps):
        logx, v, _ = heston_step_plain(coeffs, sign, *uniforms(j), logx, v, sum_first=False)
        if (j + 1) % exercise_every == 0:
            price[:, j // exercise_every] = torch.exp(logx)
            var[:, j // exercise_every] = torch.clamp(v, min=0.0)
    return price, var


def simulate_merton_american_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The Merton monitor kernel's plain twin: ``[C, timesteps // every,
    rows, cols]`` float32 prices at the monitor dates. ``params`` is ``[C,
    9]``; the step is ``dynamics_cuda.merton_step_plain`` on the
    ``american_merton_jump`` v2 words (the European ``merton_jump`` v2
    layout: three words a step, ``dynamics_cuda.merton_words``), so the
    log-price is the kernel's bit for bit and the rows ``exp`` of it.
    ``words`` (tests only) replaces the generator: a tensor broadcastable to
    ``[C, rows, cols, dynamics_cuda.merton_calls(timesteps), 4]``."""
    _check(params, key_words, 9)
    check_monitor_grid(timesteps, exercise_every)
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=merton_calls(timesteps),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    step_words = merton_words(call)
    table = merton_table(params, timesteps)[:, None, None, :]
    logx = torch.log(params[:, 0, None, None]).expand(params.shape[0], rows, cols)
    price = _monitor_out(params, timesteps // exercise_every, rows, cols)
    for t in range(timesteps):
        logx, _ = merton_step_plain(table, sign, step_words(t), logx, sum_first=False)
        if (t + 1) % exercise_every == 0:
            price[:, t // exercise_every] = torch.exp(logx)
    return price


def simulate_basket_american_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The basket monitor kernel's plain twin: ``(price, disp)``, each ``[C,
    timesteps // every, rows, cols]`` float32: the basket value at the
    monitor dates and, for the arithmetic combine, ``ln B − Σ wᵢ·log xᵢ``
    (None for the geometric one). ``params`` is ``[C, 6]``; the step is
    ``basket_cuda.simulate_basket_rows_cuda_plain``'s (``⌈A/2⌉`` draws a
    step, the Cholesky mix as a chain over the lower row)."""
    _check(params, key_words)
    check_monitor_grid(timesteps, exercise_every)
    if not 1 <= spec.n_assets <= MAX_BASKET_ASSETS:
        raise ValueError(
            f"the basket kernel takes 1..{MAX_BASKET_ASSETS} assets, got {spec.n_assets}")
    a_n = spec.n_assets
    per_step = (a_n + 1) // 2
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=-(-timesteps * per_step // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, _, maturity, rate, div, vol = (params[:, i, None, None] for i in range(6))
    dt = maturity / float(timesteps)
    sqrt_dt = torch.sqrt(dt)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    sig_sdt = [vol * f32(m) * sqrt_dt for m in spec.vol_multipliers]
    drift = [(rate - div - 0.5 * (vol * f32(m)) ** 2) * dt for m in spec.vol_multipliers]
    chol = basket_cholesky(spec)
    weights = [f32(w) for w in spec.weights]
    geometric = spec.combine == BasketCombine.GEOMETRIC
    shape = (params.shape[0], rows, cols)
    logx = [torch.log(spot * f32(m)).expand(shape) for m in spec.spot_multipliers]
    monitors = timesteps // exercise_every
    price = _monitor_out(params, monitors, rows, cols)
    disp = None if geometric else _monitor_out(params, monitors, rows, cols)
    j = 0
    for t in range(timesteps):
        z: list[torch.Tensor] = []
        for _ in range(per_step):
            u1, u2 = uniforms(j)
            j += 1
            rad = torch.sqrt(-2.0 * torch.log(u1))
            z.append(sign * (rad * _cospi(2.0 * u2)))
            z.append(sign * (rad * _sinpi(2.0 * u2)))
        for a in range(a_n):
            zm = f32(chol[a][0]) * z[0]
            for b in range(1, a + 1):
                zm = zm + f32(chol[a][b]) * z[b]
            logx[a] = (logx[a] + drift[a]) + sig_sdt[a] * zm
        if (t + 1) % exercise_every == 0:
            lg = weights[0] * logx[0]
            for a in range(1, a_n):
                lg = lg + weights[a] * logx[a]
            if geometric:
                price[:, t // exercise_every] = torch.exp(lg)
                continue
            value = weights[0] * torch.exp(logx[0])
            for a in range(1, a_n):
                value = value + weights[a] * torch.exp(logx[a])
            price[:, t // exercise_every] = value
            disp[:, t // exercise_every] = torch.log(value) - lg
    return price, disp


def _blocked(t: torch.Tensor, blocks: int, fill: torch.Tensor | float) -> torch.Tensor:
    """``[C, N]`` → ``[C, blocks, PER_THREAD, THREADS]`` in the kernel's path
    order (tile b, step k, thread t holds path b·4096 + k·256 + t), the
    ragged tail filled with ``fill`` (``[C, 1]`` or a number)."""
    c, n = t.shape
    pad = blocks * BLOCK_PATHS - n
    if pad:
        tail = torch.as_tensor(fill, dtype=t.dtype, device=t.device).expand(c, pad)
        t = torch.cat([t, tail], dim=1)
    return t.reshape(c, blocks, PER_THREAD, THREADS)


def _tree_fold(v: torch.Tensor) -> torch.Tensor:
    """The kernels' halving tree over the last dim (256 → 1): at each stride
    s, element t < s becomes ``v[t] + v[t + s]``."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _warp_fold(v: torch.Tensor) -> torch.Tensor:
    """Version 4's fold over the last dim (256 threads → 1): a halving tree
    over each warp's 32 lanes, then the 8 warps' sums in warp order."""
    w = _tree_fold(v.reshape(*v.shape[:-1], 8, 32))
    total = w[..., 0]
    for i in range(1, 8):
        total = total + w[..., i]
    return total


def basis_columns(basis_degree: int, two_state: bool) -> list[tuple[int, int]]:
    """The regression's columns as exponents ``(a, b)`` of ``x^a·v^b``:
    ``(j, 0)`` for j ≤ d, then with a second state ``(0, 1), (1, 1), (0,
    2)`` (``ops/american.py::lsmc_backward``'s ``col_exp``)."""
    cols = [(j, 0) for j in range(basis_degree + 1)]
    return cols + [(0, 1), (1, 1), (0, 2)] if two_state else cols


def moment_layout(basis_degree: int, two_state: bool) -> list[tuple[int, int]]:
    """The CUDA backward's Gram moments ``(a, b)`` in its partials' order,
    grouped by b: ``(a, 0)`` a ≤ 2d, and with a second state ``(a, 1)`` a ≤
    d + 1, ``(a, 2)`` a ≤ max(d, 2), ``(a, 3)`` a ≤ 1, ``(0, 4)`` — every
    product of two columns once (``csrc/lsmc_backward.cuh::Basis``)."""
    d = basis_degree
    out = [(a, 0) for a in range(2 * d + 1)]
    if two_state:
        out += [(a, 1) for a in range(d + 2)] + [(a, 2) for a in range(max(d, 2) + 1)]
        out += [(0, 3), (1, 3), (0, 4)]
    return out


def lsmc_backward_cuda_plain(
    price_rows: torch.Tensor,
    *,
    strike: torch.Tensor,
    disc: torch.Tensor,
    df: torch.Tensor,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """The CUDA backward's plain twin: ``[C, rows, cols]`` underliers
    ``u = K − disc·cf/df`` from ``[C, n_monitor, rows, cols]`` float32 price
    rows (and, for the two-state estimator, ``extra_rows`` of the same shape:
    the columns ``[v, v·x, v²]`` of ``v = 20·extra``), with ``strike``,
    ``disc`` (one monitor step) and ``df`` (to t = 0) ``[C]`` float32. Same
    order of dates and reductions as the kernel (module docstring; the
    two-state mode folds a tile's and the solve's 256 thread sums warp by
    warp, ``_warp_fold``); each product ``itm·(x^a·v^b)``, the continuation
    ``Horner_x(β) + β_v·v + β_vx·(x·v) + β_vv·(v·v)``, one float32 rounding
    an operation."""
    _check_backward(price_rows, strike, disc, df, basis_degree, extra_rows)
    n_contracts, monitors, rows, cols = price_rows.shape
    n = rows * cols
    blocks = -(-n // BLOCK_PATHS)
    two = extra_rows is not None
    fold = _warp_fold if two else _tree_fold
    columns = basis_columns(basis_degree, two)
    layout = moment_layout(basis_degree, two)
    where = {ab: i for i, ab in enumerate(layout)}
    k = len(columns)
    n_x = 2 * basis_degree + 1
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=price_rows.device)
    strike_c = strike[:, None]
    kb = strike[:, None, None, None]
    disc_b = disc[:, None, None, None]
    flat = price_rows.reshape(n_contracts, monitors, n)
    flat_extra = None if extra_rows is None else extra_rows.reshape(n_contracts, monitors, n)

    def row(m: int) -> torch.Tensor:
        return _blocked(flat[:, m], blocks, strike_c)  # a strike-valued path is out of the money

    def state(m: int) -> torch.Tensor | None:
        return None if flat_extra is None else _blocked(flat_extra[:, m], blocks, 0.0)

    def immediate(s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(kb - s, min=0.0) if put else torch.clamp(s - kb, min=0.0)

    def moneyness(s: torch.Tensor) -> torch.Tensor:
        return (s / kb - 1.0) * 5.0

    def moments(s1: torch.Tensor, e1: torch.Tensor | None,
                cf: torch.Tensor) -> list[torch.Tensor]:
        """Per-contract moments of a date from its rows and the carrier: each
        thread's 16 paths in order, the tile tree, then the solve's sums."""
        itm = (immediate(s1) > 0.0).to(torch.float32)
        wy = itm * (disc_b * cf)
        x1 = moneyness(s1)
        xp = [torch.ones_like(x1)]  # the kernel's running product 1, x, x·x, …
        for _ in range(n_x - 1):
            xp.append(xp[-1] * x1)
        vp = [None]
        if e1 is not None:
            vp.append(e1 * 20.0)
            for _ in range(3):
                vp.append(vp[-1] * vp[1])

        def term(a: int, b: int) -> torch.Tensor:
            return xp[a] if b == 0 else xp[a] * vp[b]

        def block_sum(v: torch.Tensor) -> torch.Tensor:  # [C, blocks]
            acc = torch.zeros_like(v[:, :, 0])
            for step in range(PER_THREAD):
                acc = acc + v[:, :, step]
            return fold(acc)

        part = torch.stack([block_sum(itm * term(a, b)) for a, b in layout]
                           + [block_sum(wy * term(a, b)) for a, b in columns], dim=-1)
        spare = -blocks % THREADS
        if spare:
            part = torch.cat([part, part.new_zeros(n_contracts, spare, part.shape[-1])], dim=1)
        part = part.reshape(n_contracts, -1, THREADS, part.shape[-1])
        acc = torch.zeros_like(part[:, 0])
        for i in range(part.shape[1]):
            acc = acc + part[:, i]
        total = fold(acc.transpose(1, 2))  # [C, M]
        return [total[:, m] * inv_n for m in range(total.shape[1])]

    def solve(m: list[torch.Tensor]) -> list[torch.Tensor]:
        gram = [[m[where[(ci[0] + cj[0], ci[1] + cj[1])]] for cj in columns] for ci in columns]
        return _ridge_chol_solve(gram, m[len(layout):], dtype=torch.float32)

    cf = immediate(row(monitors - 1))
    mom = moments(row(monitors - 2), state(monitors - 2), cf)
    for policy in range(monitors - 2, -1, -1):
        beta = [b[:, None, None, None] for b in solve(mom)]
        s = row(policy)
        ex = immediate(s)
        y = disc_b * cf
        x = moneyness(s)
        cont = beta[basis_degree]
        for j in range(basis_degree - 1, -1, -1):
            cont = cont * x + beta[j]
        if two:
            v = state(policy) * 20.0
            base = basis_degree + 1
            cont = cont + beta[base] * v
            cont = cont + beta[base + 1] * (x * v)
            cont = cont + beta[base + 2] * (v * v)
        cf = torch.where((ex > 0.0) & (ex > cont), ex, y)
        if policy:
            mom = moments(row(policy - 1), state(policy - 1), cf)
    u = kb - (disc_b * cf) / df[:, None, None, None]
    return u.reshape(n_contracts, -1)[:, :n].reshape(n_contracts, rows, cols)


def _check_backward(price_rows: torch.Tensor, strike: torch.Tensor, disc: torch.Tensor,
                    df: torch.Tensor, basis_degree: int,
                    extra_rows: torch.Tensor | None = None) -> None:
    if price_rows.dtype != torch.float32 or price_rows.ndim != 4:
        raise ValueError(f"price_rows must be float32 [C, n_monitor, rows, cols], got "
                         f"{price_rows.dtype} {tuple(price_rows.shape)}")
    if price_rows.shape[1] < 2:
        raise ValueError(f"the backward needs >= 2 monitor dates, got {price_rows.shape[1]}")
    if not 1 <= basis_degree <= 8:
        raise ValueError(f"basis_degree must be in [1, 8], got {basis_degree}")
    for name, v in (("strike", strike), ("disc", disc), ("df", df)):
        if v.dtype != torch.float32 or tuple(v.shape) != (price_rows.shape[0],):
            raise ValueError(f"{name} must be float32 [C], got {v.dtype} {tuple(v.shape)}")
        if v.device != price_rows.device:
            raise ValueError(f"{name} on {v.device}, price_rows on {price_rows.device}")
    if extra_rows is not None and (extra_rows.dtype != torch.float32
                                   or extra_rows.shape != price_rows.shape
                                   or extra_rows.device != price_rows.device):
        raise ValueError(f"extra_rows must be float32 {tuple(price_rows.shape)} on "
                         f"{price_rows.device}, got {extra_rows.dtype} "
                         f"{tuple(extra_rows.shape)} on {extra_rows.device}")


# --------------------------------------------------------------------------
# The kernels and their wrappers
# --------------------------------------------------------------------------


# ops/_build.py::load_library's arguments for this module's kernels
LIBRARY = ("american_paths", ("american_paths.cu",))
DYNAMICS_LIBRARY = ("american_dynamics", ("american_dynamics.cu",))
BACKWARD_LIBRARY = ("lsmc_backward", ("lsmc_backward.cu",))
TWO_STATE_LIBRARY = ("lsmc_two_state", ("lsmc_two_state.cu",))


def _written_in_full(*shape: int, device: torch.device) -> torch.Tensor:
    """``torch.empty`` float32 without the NaN fill that deterministic mode
    (``runtime/torch_runtime.py``) gives every new tensor, for a buffer the
    kernel writes in every element before anything reads it: the monitor
    rows of a training chunk alone are 17.2 GB of fill."""
    before = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return torch.empty(shape, dtype=torch.float32, device=device)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = before


def _kernel() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*LIBRARY).lib
    ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.american_gbm_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, ll, ll, vp]
    lib.american_gbm_launch.restype = ctypes.c_int
    return lib


def _dynamics_kernel() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*DYNAMICS_LIBRARY).lib
    ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.american_heston_launch.argtypes = [vp, vp, vp, vp, i, ll, ll, i, i, ll, ll, vp]
    lib.american_merton_launch.argtypes = [vp, vp, vp, vp, i, ll, ll, i, i, ll, ll, vp]
    lib.american_basket_launch.argtypes = [vp, vp, vp, vp, vp, i, ll, ll, i, i, i, i, ll, ll,
                                           vp]
    for fn in (lib.american_heston_launch, lib.american_merton_launch,
               lib.american_basket_launch):
        fn.restype = ctypes.c_int
    return lib


def _monitor_args(
    params: torch.Tensor, key_words: torch.Tensor, *, timesteps: int, rows: int, cols: int,
    exercise_every: int,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Checked ``(params, int32 key words, monitor count)`` for a monitor
    kernel's launch on the card."""
    check_monitor_grid(timesteps, exercise_every)
    monitors = timesteps // exercise_every
    if monitors > MAX_MONITOR_DATES:
        raise ValueError(f"at most {MAX_MONITOR_DATES} monitor dates, got {monitors}")
    if rows <= 0 or cols <= 0:
        raise ValueError(f"need positive rows/cols, got {rows}/{cols}")
    p, words, _ = _device_args(params, key_words, timesteps, 1, 1)  # checked inputs
    return p, words, monitors


def _launched(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}_launch failed: cudaError {status}")
    _count(name)


def simulate_american_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Monitor-date prices ``[C, timesteps // every, rows, cols]`` float32 on
    the Philox stream (``american_gbm`` v3): CPU tensors run the plain twin,
    CUDA tensors launch the monitor-row kernel (one launch per contract
    batch) or raise."""
    _check(params, key_words)
    kwargs = dict(timesteps=timesteps, rows=rows, cols=cols, exercise_every=exercise_every,
                  antithetic_half=antithetic_half, row_offset=row_offset)
    if params.device.type == "cpu":
        return simulate_american_rows_cuda_plain(params, key_words, **kwargs)
    p, words, monitors = _monitor_args(params, key_words, timesteps=timesteps, rows=rows,
                                       cols=cols, exercise_every=exercise_every)
    out = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    _launched("american_gbm", _kernel().american_gbm_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, timesteps,
        exercise_every, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    ))
    return out


def simulate_heston_american_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Heston monitor-date ``(price, max(v, 0))`` rows, each ``[C, timesteps
    // every, rows, cols]`` float32, on the Philox stream
    (``american_heston`` v2): CPU tensors run the plain twin, CUDA tensors
    launch the Heston monitor kernel (one launch per contract batch) or
    raise."""
    _check(params, key_words, 10)
    kwargs = dict(timesteps=timesteps, rows=rows, cols=cols, exercise_every=exercise_every,
                  antithetic_half=antithetic_half, row_offset=row_offset)
    if params.device.type == "cpu":
        return simulate_heston_american_rows_cuda_plain(params, key_words, **kwargs)
    p, words, monitors = _monitor_args(params, key_words, timesteps=timesteps, rows=rows,
                                       cols=cols, exercise_every=exercise_every)
    price = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    var = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    _launched("american_heston", _dynamics_kernel().american_heston_launch(
        p.data_ptr(), words.data_ptr(), price.data_ptr(), var.data_ptr(), p.shape[0], rows,
        cols, timesteps, exercise_every, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    ))
    return price, var


def simulate_merton_american_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Merton monitor-date prices ``[C, timesteps // every, rows, cols]``
    float32 on the Philox stream (``american_merton_jump`` v2): CPU tensors
    run the plain twin, CUDA tensors launch the Merton monitor kernel (one
    launch per contract batch, after the ``[C, 20]`` table of
    ``dynamics_cuda.merton_table``) or raise."""
    _check(params, key_words, 9)
    kwargs = dict(timesteps=timesteps, rows=rows, cols=cols, exercise_every=exercise_every,
                  antithetic_half=antithetic_half, row_offset=row_offset)
    if params.device.type == "cpu":
        return simulate_merton_american_rows_cuda_plain(params, key_words, **kwargs)
    p, words, monitors = _monitor_args(params, key_words, timesteps=timesteps, rows=rows,
                                       cols=cols, exercise_every=exercise_every)
    table = merton_table(p, timesteps)
    price = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    _launched("american_merton", _dynamics_kernel().american_merton_launch(
        p.data_ptr(), words.data_ptr(), table.data_ptr(), price.data_ptr(), p.shape[0], rows,
        cols, timesteps, exercise_every, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    ))
    return price


def simulate_basket_american_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    exercise_every: int,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Basket monitor-date ``(value, dispersion)`` rows, each ``[C, timesteps
    // every, rows, cols]`` float32 (the dispersion None for the geometric
    combine), on the Philox stream (``american_basket_gbm`` v2): CPU tensors
    run the plain twin, CUDA tensors launch the basket monitor kernel (one
    launch per contract batch) or raise."""
    from spectralmc_tpu_torch.ops.basket_cuda import spec_table

    _check(params, key_words)
    kwargs = dict(spec=spec, timesteps=timesteps, rows=rows, cols=cols,
                  exercise_every=exercise_every, antithetic_half=antithetic_half,
                  row_offset=row_offset)
    if params.device.type == "cpu":
        return simulate_basket_american_rows_cuda_plain(params, key_words, **kwargs)
    if not 1 <= spec.n_assets <= MAX_BASKET_ASSETS:
        raise ValueError(
            f"the basket kernel takes 1..{MAX_BASKET_ASSETS} assets, got {spec.n_assets}")
    p, words, monitors = _monitor_args(params, key_words, timesteps=timesteps, rows=rows,
                                       cols=cols, exercise_every=exercise_every)
    geometric = spec.combine == BasketCombine.GEOMETRIC
    price = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    disp = None if geometric else _written_in_full(p.shape[0], monitors, rows, cols,
                                                   device=p.device)
    table = spec_table(spec)  # host memory: the kernel takes it by value
    _launched("american_basket", _dynamics_kernel().american_basket_launch(
        p.data_ptr(), words.data_ptr(), table.ctypes.data, price.data_ptr(),
        None if disp is None else disp.data_ptr(), p.shape[0], rows, cols, timesteps,
        exercise_every, spec.n_assets, int(geometric), antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    ))
    return price, disp


def american_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    model: ModelKind,
    spec: BasketSpec | None = None,
    **kwargs: object,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(price_rows, extra_rows)`` of the monitor kernel of ``model``:
    ``extra_rows`` is the regression's second state (Heston's ``max(v, 0)``,
    the arithmetic basket's log dispersion) or None."""
    if model == ModelKind.GBM:
        return simulate_american_rows_cuda(params, key_words, **kwargs), None
    if model == ModelKind.HESTON:
        return simulate_heston_american_rows_cuda(params, key_words, **kwargs)
    if model == ModelKind.MERTON_JUMP:
        return simulate_merton_american_rows_cuda(params, key_words, **kwargs), None
    if model == ModelKind.BASKET_GBM:
        return simulate_basket_american_rows_cuda(params, key_words, spec=spec, **kwargs)
    raise ValueError(f"no monitor kernel for model={model.value!r}")


def _backward_kernel(two_state: bool) -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*(TWO_STATE_LIBRARY if two_state else BACKWARD_LIBRARY)).lib
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lsmc_plan.argtypes = [i, i, ip, ip]
    lib.lsmc_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, ll, i, i, i, i, i, f, vp]
    lib.lsmc_plan.restype = ctypes.c_int
    lib.lsmc_launch.restype = ctypes.c_int
    return lib


def lsmc_plan(basis_degree: int, two_state: bool, resident: bool,
              device: int) -> tuple[int, int]:
    """``(grid, slots)`` of the backward kernel on ``device``: its co-resident
    CTA count from the occupancy calculator and, for the resident route, the
    4096-path tiles a CTA keeps on chip (the slot count that holds the
    most; 0 for the streamed route). The library computes it once a device
    and kernel."""
    grid, slots = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        status = _backward_kernel(two_state).lsmc_plan(basis_degree, int(resident),
                                                       ctypes.byref(grid), ctypes.byref(slots))
    if status != 0:
        raise RuntimeError(f"lsmc_plan failed: cudaError {status}")
    return grid.value, slots.value


def lsmc_route(n_paths: int, resident_tiles: int) -> str:
    """The backward's route for contracts of ``n_paths`` paths, when the
    resident grid holds ``resident_tiles`` 4096-path tiles on chip (``grid ·
    slots`` of ``lsmc_plan``): ``"resident"`` where one contract's tiles fit,
    so its carrier and rows stay on chip across the dates, else
    ``"streamed"`` (the carrier in HBM)."""
    return "resident" if -(-n_paths // BLOCK_PATHS) <= resident_tiles else "streamed"


def lsmc_backward_cuda(
    price_rows: torch.Tensor,
    *,
    strike: torch.Tensor,
    disc: torch.Tensor,
    df: torch.Tensor,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Synthetic American underliers ``[C, rows, cols]`` (``u = K −
    disc·cf/df``) from ``[C, n_monitor, rows, cols]`` float32 price rows (and
    a second state's ``extra_rows``) by the Longstaff–Schwartz estimator:
    CPU tensors run the plain twin, CUDA tensors one launch of the backward
    kernel on the route ``lsmc_route`` picks, or raise."""
    _check_backward(price_rows, strike, disc, df, basis_degree, extra_rows)
    if price_rows.device.type == "cpu":
        return lsmc_backward_cuda_plain(price_rows, strike=strike, disc=disc, df=df, put=put,
                                        basis_degree=basis_degree, extra_rows=extra_rows)
    if price_rows.device.type != "cuda":
        raise ValueError(f"the cuda engine runs on cpu (plain twin) or cuda, not "
                         f"{price_rows.device}")
    grid, slots = lsmc_plan(basis_degree, extra_rows is not None, True,
                            _device_index(price_rows))
    resident = lsmc_route(price_rows.shape[2] * price_rows.shape[3], grid * slots) == "resident"
    return _lsmc_launch(price_rows, strike=strike, disc=disc, df=df, put=put,
                        basis_degree=basis_degree, extra_rows=extra_rows, resident=resident)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _lsmc_launch(
    price_rows: torch.Tensor,
    *,
    strike: torch.Tensor,
    disc: torch.Tensor,
    df: torch.Tensor,
    put: bool,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
    resident: bool,
) -> torch.Tensor:
    """One launch of the backward kernel on CUDA tensors, on the resident
    route or the streamed one as ``resident`` says (the checks that hold
    both routes at one shape call this directly)."""
    two = extra_rows is not None
    n_contracts, monitors, rows, cols = price_rows.shape
    n = rows * cols
    grid, slots = lsmc_plan(basis_degree, two, True, _device_index(price_rows))
    tiles = -(-n // BLOCK_PATHS)
    if resident and tiles > grid * slots:
        raise ValueError(f"{tiles} tiles a contract do not fit the resident grid's "
                         f"{grid * slots}")
    # a wave's contracts split the grid, each group's slots holding its tiles
    wave = min(n_contracts, grid // -(-tiles // slots)) if resident else n_contracts
    k = len(basis_columns(basis_degree, two))
    n_moments = len(moment_layout(basis_degree, two)) + k
    rows_c = price_rows.contiguous()
    extra_c = None if extra_rows is None else extra_rows.contiguous()
    scal = torch.stack([strike, disc, df], dim=1).contiguous()
    out = _written_in_full(n_contracts, rows, cols, device=rows_c.device)
    beta = _written_in_full(n_contracts, k, device=rows_c.device)
    partials = _written_in_full(n_contracts, tiles, n_moments, device=rows_c.device)
    sync = torch.zeros(2 * n_contracts, dtype=torch.int32, device=rows_c.device)
    status = _backward_kernel(two).lsmc_launch(
        rows_c.data_ptr(), None if extra_c is None else extra_c.data_ptr(), out.data_ptr(),
        scal.data_ptr(), partials.data_ptr(), beta.data_ptr(), sync.data_ptr(), n_contracts, n,
        monitors, basis_degree, int(put), int(resident), wave, float(1.0 / n),
        torch.cuda.current_stream(rows_c.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"lsmc_launch failed: cudaError {status}")
    _count(("lsmc_two_state" if two else "lsmc_backward") + ("" if resident else "_streamed"))
    return out


def monitor_discounts(
    params: torch.Tensor, *, timesteps: int, exercise_every: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(disc, df)``, each ``[C]`` float32: the one-monitor-step discount
    ``exp(−r·dt·every)`` and ``exp(−r·T)``, as the JAX package's Pallas
    American path computes them."""
    maturity, rate = params[:, 2], params[:, 3]
    dt = maturity / float(timesteps)
    return torch.exp(-rate * dt * float(exercise_every)), torch.exp(-rate * maturity)


def monitor_underliers(
    price_rows: torch.Tensor,
    params: torch.Tensor,
    *,
    timesteps: int,
    exercise_every: int,
    option: OptionSide,
    basis_degree: int,
    extra_rows: torch.Tensor | None = None,
    cross_fit: bool = False,
    backward: int = 0,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers ``u = K − cf/df``
    from a monitor kernel's ``[C, n_monitor, rows, cols]`` price rows (and
    its second state ``extra_rows``, if any) by ``backward``:
    ``LSMC_BACKWARD_VERSIONS["cuda"]`` (price rows alone) and
    ``["cuda_two_state"]`` (with ``extra_rows``) run the CUDA backward, 0 the
    torch estimator (which also takes ``cross_fit`` and, for rows that are
    one shard of the paths, ``paths_group``). Callers pass
    ``resolve_lsmc_backward``'s value; nothing here re-routes. Every
    contract layout has strike, maturity and rate at slots 1–3."""
    from spectralmc_tpu_torch.ops.american import encode_monitor_prices

    disc, df = monitor_discounts(params, timesteps=timesteps, exercise_every=exercise_every)
    put = option == OptionSide.PUT
    if backward in LSMC_BACKWARD_VERSIONS.values():
        if paths_group is not None:
            raise ValueError(
                f"the CUDA backward v{backward} regresses on one launch's paths; rows "
                "sharded over a paths group run the torch estimator (backward 0)")
        two = backward == LSMC_BACKWARD_VERSIONS["cuda_two_state"]
        if cross_fit or (extra_rows is not None) != two:
            raise ValueError(
                f"the CUDA backward v{backward} is the {'two' if two else 'single'}-state "
                f"estimator and was handed {'a' if extra_rows is not None else 'no'} second "
                f"state row set{' and cross-fit' if cross_fit else ''}; cross-fit runs the "
                f"torch estimator (backward 0)")
        return lsmc_backward_cuda(price_rows, strike=params[:, 1].contiguous(), disc=disc,
                                  df=df, put=put, basis_degree=basis_degree,
                                  extra_rows=extra_rows)
    if backward != 0:
        raise ValueError(f"unknown LSMC backward version {backward}")
    LAUNCHES_BY_BRANCH["torch_estimator"] += 1
    return encode_monitor_prices(
        price_rows, strike=params[:, 1], maturity=params[:, 2], rate=params[:, 3],
        disc_monitor=disc, dtype=torch.float32, put=put, basis_degree=basis_degree,
        extra_rows=extra_rows, cross_fit=cross_fit, paths_group=paths_group,
    )


def simulate_american_underlier_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    option: OptionSide,
    model: ModelKind = ModelKind.GBM,
    spec: BasketSpec | None = None,
    basis_degree: int = 5,
    exercise_every: int = 1,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    cross_fit: bool = False,
    backward: int = 0,
    paths_group: ProcessGroup | None = None,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers on the ``"cuda"``
    engine: the monitor kernel of ``model`` (``spec``: a basket's), then
    ``monitor_underliers`` on its rows (``paths_group``: rows that are one
    shard of the paths, at ``row_offset``)."""
    price_rows, extra_rows = american_rows_cuda(
        params, key_words, model=model, spec=spec, timesteps=timesteps, rows=rows, cols=cols,
        exercise_every=exercise_every, antithetic_half=antithetic_half, row_offset=row_offset,
    )
    return monitor_underliers(
        price_rows, params, timesteps=timesteps, exercise_every=exercise_every, option=option,
        basis_degree=basis_degree, extra_rows=extra_rows, cross_fit=cross_fit,
        backward=backward, paths_group=paths_group,
    )


__all__ = [
    "LSMC_BACKWARD_VERSIONS",
    "american_rows_cuda",
    "basis_columns",
    "cuda_backward_version",
    "lsmc_backward_cuda",
    "lsmc_backward_cuda_plain",
    "lsmc_plan",
    "lsmc_route",
    "moment_layout",
    "monitor_discounts",
    "monitor_underliers",
    "resolve_lsmc_backward",
    "simulate_american_rows_cuda",
    "simulate_american_rows_cuda_plain",
    "simulate_american_underlier_rows_cuda",
    "simulate_basket_american_rows_cuda",
    "simulate_basket_american_rows_cuda_plain",
    "simulate_heston_american_rows_cuda",
    "simulate_heston_american_rows_cuda_plain",
    "simulate_merton_american_rows_cuda",
    "simulate_merton_american_rows_cuda_plain",
    "two_state",
]
