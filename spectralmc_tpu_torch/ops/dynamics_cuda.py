"""The ``"cuda"`` MC engine beyond flat GBM: curved-term GBM, Heston and Merton.

``csrc/dynamics_paths.cu`` replaces three kernels of the JAX package's
``ops/gbm_pallas.py``: ``_gbm_term_block_kernel`` (log-Euler GBM under
piecewise-constant curves), ``_heston_block_kernel`` (full-truncation Euler
Heston) and ``_merton_block_kernel`` (the exact compensated Merton step);
its header states what each keeps and drops. This module holds, for each,

* the public wrapper (``simulate_term_rows_cuda``,
  ``simulate_heston_rows_cuda``, ``simulate_merton_rows_cuda``): a CPU tensor
  goes to the plain twin; a CUDA tensor launches the kernel or raises. There
  is no fallback between the two, nor to the threefry engine:
  ``ops/gbm.py::resolve_implementation`` decides the engine before a run.
* the plain twin (``…_cuda_plain``): the same Philox words and the same
  float32 arithmetic in torch ops, with the ``words=`` hook of
  ``ops/gbm_cuda.py``'s twins. The CPU tests hold the twins against the JAX
  kernels; the card holds the kernels against the twins.
* what is computed outside the kernels, once per contract, in torch on the
  contracts' device: ``term_coeff_tables`` (per-step ``(drift·dt, vol·√dt)``)
  and ``merton_table`` (``(drift·dt, vol·√dt, μ_J, σ_J)`` and
  ``poisson_levels``, the 16 running-cdf levels of ``lam·dt``). Kernel and
  twin read the same tables.
* the fixed-rounding Box–Muller transform (``ln_pinned``,
  ``sincos_2pi_pinned``, ``box_muller_pinned``), re-exported from
  ``ops/rng.py``, which ``ops/gbm_cuda.py``'s cliquet twin shares.

The streams (``gbm_cuda.CUDA_STREAM_VERSIONS``): Philox-4x32-10 keyed by the
contract's two threefry words, counter ``(path lo, path hi, call, 0)``.

* ``gbm_term`` v2 — the flat kernel's draw order per branch: TERMINAL and
  the variance swap take ``T // 2`` pair draws and one single draw when ``T``
  is odd, every other branch one draw per step; draw ``j`` is words
  ``2(j%2), 2(j%2)+1`` of call ``j // 2``, walked in whole calls
  (``csrc/gbm_step.cuh::walk_pairs``, ``csrc/path_stream.cuh::walk_draws``).
  The draw is ``box_muller_pinned`` and every step runs on fixed roundings
  that the twin repeats bit for bit: the TERMINAL pair step is
  ``logx + (a.x + b.x) + sign·r·(a.y·cos θ + b.y·sin θ)``, the variance
  pair's increments ``a.x + a.y·(sign·r·cos θ)`` and ``b.x + b.y·(sign·r·sin
  θ)``, a single step ``logx + a.x + a.y·(sign·r·cos θ)`` (``a``, ``b`` the
  two steps' table rows). Digital transforms the TERMINAL draw; forward
  start runs TERMINAL on the table sliced to the tail. (v1 drew one by one
  with libm's transform, and its pair step read a second table, ``(R, φ)``,
  for ``r·R·sin(θ + 2πφ)``.)
* ``heston`` v2 — one draw per step, same word layout: ``z_v = r·cos θ``,
  ``z_s = ρ z_v + ρ̄ r·sin θ``, the draw and the step on fixed roundings
  that the twin repeats bit for bit (``box_muller_pinned``,
  ``heston_step_plain``). Digital transforms TERMINAL; forward start is a
  branch of its own (it captures ``ln S_m``).
* ``merton_jump`` v2 — three words a step: step ``t`` reads words ``3t``,
  ``3t+1`` and ``3t+2`` of the stream, word ``i`` being word ``i % 4`` of
  call ``i // 4``, so four steps take three whole calls and a tail of ``T %
  4`` steps the calls it reaches (``csrc/path_stream.cuh::walk_triples``).
  The first two are the Box–Muller pair (``z_d = r·cos θ``, ``z_j = r·sin
  θ``), the third the count's uniform. The draw, the count and the step run
  on fixed roundings that the twin repeats bit for bit
  (``csrc/merton_step.cuh``; ``box_muller_pinned``, ``merton_count``,
  ``merton_step_plain``). Antithetic rows flip the pair and share the counts.
  Digital transforms TERMINAL; forward start runs TERMINAL at the tail
  length. (v1 took one whole call a step, words 0–2, word 3 unused, with
  libm's transform and 16 compares.)

Launch counts go to ``gbm_cuda.LAUNCHES`` and ``LAUNCHES_BY_BRANCH`` under
``term_<branch>``, ``heston_<branch>`` and ``merton_<branch>``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from spectralmc_tpu_torch.ops.gbm import (
    BARRIER_PAYOFFS,
    LOOKBACK_MAX_PAYOFFS,
    PayoffKind,
    TermStructure,
    lookback_underlier,
)
from spectralmc_tpu_torch.ops.gbm_cuda import (
    _FAMILY_CODE,
    _LOOKBACK_VARIANT,
    Words,
    _check,
    _count,
    _device_args,
    _pair_draws,
    _route_in,
    _route_out,
    _stream,
    branch_of,
    uniform_closed,
    uniform_open,
)
from spectralmc_tpu_torch.ops.rng import (  # noqa: F401 (the pinned transform, re-exported)
    COS_C,
    HALF_PI_HI,
    HALF_PI_LO,
    LN2_HI,
    LN2_LO,
    LN_Q,
    SIN_S,
    box_muller_pinned,
    fma32_exact,
    ln_pinned,
    sincos_2pi_pinned,
)

POISSON_TERMS = 16  # csrc/merton_step.cuh's kPoissonTerms
MERTON_COUNT_FIRST = 3  # csrc/merton_step.cuh's kCountFirst
_HESTON_FORWARD = 5  # csrc/dynamics_paths.cu's kForward


def _variant(branch: str, payoff: PayoffKind) -> int:
    """The kernels' ``variant`` argument for a branch."""
    if branch == "barrier":
        return int(payoff == PayoffKind.BARRIER_UP_OUT)
    if branch == "lookback":
        return _LOOKBACK_VARIANT[payoff]
    return int(payoff == PayoffKind.ASIAN_GEOMETRIC)


def _branch(payoff: PayoffKind, barrier_rel: float | None) -> str:
    branch = branch_of(payoff)
    if branch == "cliquet":
        raise ValueError("cliquets of these dynamics run the threefry engine's scan")
    if branch == "barrier" and barrier_rel is None:
        raise ValueError(f"payoff={payoff.value!r} needs barrier_rel")
    return branch


def _finish(
    branch: str,
    payoff: PayoffKind,
    logx: torch.Tensor,
    acc: torch.Tensor,
    *,
    spot: torch.Tensor,
    strike: torch.Tensor,
    maturity: torch.Tensor,
    steps: int,
    barrier_rel: float | None,
) -> torch.Tensor:
    """The kernels' shared epilogue: ``logx`` the terminal log-price, ``acc``
    the running log-extreme, the running sum or the captured ``ln S_m``."""
    if branch == "terminal":
        return torch.exp(logx)
    if branch == "variance":
        return acc / maturity
    if branch == "forward":
        return spot * torch.exp(logx - acc)
    if branch == "asian":
        mean = acc * float(1.0 / steps)
        return torch.exp(mean) if payoff == PayoffKind.ASIAN_GEOMETRIC else mean
    if branch == "barrier":
        level = torch.log(spot * torch.tensor(barrier_rel, dtype=torch.float32))
        up = payoff == PayoffKind.BARRIER_UP_OUT
        knocked = acc >= level if up else acc <= level
        return torch.where(knocked, strike, torch.exp(logx))
    return lookback_underlier(payoff, strike, torch.exp(acc), torch.exp(logx))


def _observe(branch: str, payoff: PayoffKind, acc: torch.Tensor, logx: torch.Tensor):  # noqa: ANN202
    """Fold the new log-price into the branch's accumulator."""
    if branch == "asian":
        return acc + (logx if payoff == PayoffKind.ASIAN_GEOMETRIC else torch.exp(logx))
    if branch in ("barrier", "lookback"):
        up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
        return torch.maximum(acc, logx) if up else torch.minimum(acc, logx)
    return acc


# ops/_build.py::load_library's arguments for this module's kernels
LIBRARY = ("dynamics_paths", ("dynamics_paths.cu",))


def _library() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*LIBRARY).lib
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gbm_term_launch.argtypes = [vp, vp, vp, vp, i, ll, ll, i, i, i, f, ll, ll, vp]
    lib.heston_paths_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, i, f, i, ll, ll, vp]
    lib.merton_paths_launch.argtypes = [vp, vp, vp, vp, vp, i, ll, ll, i, i, i, f, ll, ll, vp]
    for fn in (lib.gbm_term_launch, lib.heston_paths_launch, lib.merton_paths_launch):
        fn.restype = ctypes.c_int
    return lib


def _stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# Curved-term GBM (gbm_pallas.py::_gbm_term_block_kernel)
# --------------------------------------------------------------------------


def term_coeff_tables(
    params: torch.Tensor, shapes: tuple[tuple[float, ...], ...], timesteps: int
) -> torch.Tensor:
    """``step [C, T, 2]``, the term kernel's float32 table
    (``gbm_pallas.py::_term_coeff_tables``' step table, per contract):
    ``step[t] = (log-drift_t·dt, vol_t·√dt)``. The three curve shapes reach
    the contracts' device in one copy."""
    vsa, rsa, qsa = torch.tensor(shapes, dtype=torch.float32, device=params.device)
    maturity, rate, div, vol = (params[:, i, None] for i in (2, 3, 4, 5))
    dt = maturity / float(timesteps)
    vol_t = vol * vsa
    drift = (rate * rsa - div * qsa - 0.5 * vol_t * vol_t) * dt
    return torch.stack([drift, vol_t * torch.sqrt(dt)], dim=2).contiguous()


def _term_route(
    payoff: PayoffKind, params: torch.Tensor, term: TermStructure, timesteps: int,
    forward_start_step: int | None,
) -> tuple[torch.Tensor, int, tuple[tuple[float, ...], ...]]:
    """The ``(params, timesteps, shapes)`` the term kernel runs for
    ``payoff``: forward start is TERMINAL on the curves sliced to the tail."""
    shapes = term.shapes(timesteps)
    p, steps = _route_in(payoff, params, timesteps, forward_start_step)
    if payoff == PayoffKind.FORWARD_START:
        shapes = tuple(s[forward_start_step:] for s in shapes)
    return p, steps, shapes


def simulate_term_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    term: TermStructure,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The term kernel's plain twin: ``[C, rows, cols]`` float32 underliers of
    any non-American, non-cliquet payoff under log-Euler GBM with curves.
    ``params`` is ``[C, 6]`` float32; ``words`` (tests only) replaces the
    generator as in ``gbm_cuda.simulate_terminal_rows_cuda_plain``. The draw
    (``box_muller_pinned``) and the steps take the kernel's roundings, each
    FMA rounded once exactly (``rng.fma32_exact``), so on the card the
    log-price and the value are the kernel's bit for bit."""
    _check(params, key_words)
    branch = _branch(payoff, barrier_rel)
    p, steps, shapes = _term_route(payoff, params, term, timesteps, forward_start_step)
    step = term_coeff_tables(p, shapes, steps)
    paired = branch in ("terminal", "variance")
    pairs = steps // 2
    draws = pairs + steps % 2 if paired else steps
    sign, call = _stream(
        p, key_words, rows=rows, cols=cols, calls=-(-draws // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, strike, maturity = (p[:, i, None, None] for i in range(3))
    drift = lambda t: step[:, t, 0, None, None]  # noqa: E731
    vol_sdt = lambda t: step[:, t, 1, None, None]  # noqa: E731
    shape = (p.shape[0], rows, cols)
    logx = torch.log(spot).expand(shape)
    acc = logx if branch in ("barrier", "lookback") else torch.zeros(shape, device=p.device)

    def draw(j: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draw ``j``'s radius with the antithetic sign (exact) and its
        ``(cos 2πu2, sin 2πu2)``: ``term_draw``."""
        rad, cs, sn = box_muller_pinned(*uniforms(j))
        return sign * rad, cs, sn

    def single(j: int, t: int, logx: torch.Tensor) -> torch.Tensor:
        """``term_single_step``: step ``t`` on draw ``j``."""
        srad, cs, _ = draw(j)
        return fma32_exact(vol_sdt(t), srad * cs, logx + drift(t))

    if branch == "terminal":
        for j in range(pairs):
            srad, cs, sn = draw(j)
            mix = fma32_exact(vol_sdt(2 * j), cs, vol_sdt(2 * j + 1) * sn)
            logx = fma32_exact(srad, mix, logx + (drift(2 * j) + drift(2 * j + 1)))
        if steps % 2:
            logx = single(pairs, steps - 1, logx)
    elif branch == "variance":
        for j in range(pairs):
            srad, cs, sn = draw(j)
            inc_a = fma32_exact(vol_sdt(2 * j), srad * cs, drift(2 * j))
            inc_b = fma32_exact(vol_sdt(2 * j + 1), srad * sn, drift(2 * j + 1))
            acc = fma32_exact(inc_b, inc_b, fma32_exact(inc_a, inc_a, acc))
        if steps % 2:
            srad, cs, _ = draw(pairs)
            inc = fma32_exact(vol_sdt(steps - 1), srad * cs, drift(steps - 1))
            acc = fma32_exact(inc, inc, acc)
    else:
        for j in range(steps):
            logx = single(j, j, logx)
            acc = _observe(branch, payoff, acc, logx)
    out = _finish(branch, payoff, logx, acc, spot=spot, strike=strike, maturity=maturity,
                  steps=steps, barrier_rel=barrier_rel)
    return _route_out(payoff, out, p)


def simulate_term_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    term: TermStructure,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Payoff underliers ``[C, rows, cols]`` float32 under log-Euler GBM with
    piecewise-constant curves, on the Philox stream ``gbm_term``: CPU tensors
    run the plain twin, CUDA tensors launch the term kernel (one launch for
    the whole contract batch, after the step table's few torch ops) or
    raise."""
    _check(params, key_words)
    if params.device.type == "cpu":
        return simulate_term_rows_cuda_plain(
            params, key_words, term=term, timesteps=timesteps, rows=rows, cols=cols,
            payoff=payoff, barrier_rel=barrier_rel, forward_start_step=forward_start_step,
            antithetic_half=antithetic_half, row_offset=row_offset,
        )
    branch = _branch(payoff, barrier_rel)
    p, steps, shapes = _term_route(payoff, params, term, timesteps, forward_start_step)
    p, words, out = _device_args(p, key_words, steps, rows, cols)
    step = term_coeff_tables(p, shapes, steps)
    status = _library().gbm_term_launch(
        p.data_ptr(), words.data_ptr(), step.data_ptr(), out.data_ptr(),
        p.shape[0], rows, cols, steps, _FAMILY_CODE[branch], _variant(branch, payoff),
        1.0 if barrier_rel is None else barrier_rel, antithetic_half or 0, row_offset,
        _stream_of(p.device),
    )
    if status != 0:
        raise RuntimeError(f"gbm_term_launch failed: cudaError {status}")
    _count(f"term_{branch}")
    return _route_out(payoff, out, p)


# --------------------------------------------------------------------------
# Heston (gbm_pallas.py::_heston_block_kernel)
# --------------------------------------------------------------------------


def _heston_branch(payoff: PayoffKind, barrier_rel: float | None, timesteps: int,
                   forward_start_step: int | None) -> str:
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None or not 1 <= forward_start_step < timesteps:
            raise ValueError(f"forward start needs 1 <= forward_start_step < {timesteps}")
        return "forward"
    return _branch(payoff, barrier_rel)


def heston_coeffs_plain(params: torch.Tensor, timesteps: int) -> tuple[torch.Tensor, ...]:
    """``csrc/heston_step.cuh::heston_coeffs``: ``(dt, ρ, ρ̄, (r − q)·dt, κ·dt,
    κθ·dt, ξ)``, each ``[C, 1, 1]`` float32, rounded op by op. ``dt`` is
    divided by a tensor: on the card torch divides by a Python number as a
    product with its reciprocal, an ulp off the kernel's quotient for a
    step count that is not a power of two."""
    maturity, rate, div, kappa, theta, xi, rho = (
        params[:, i, None, None] for i in (2, 3, 4, 6, 7, 8, 9))
    dt = maturity / torch.full_like(maturity, float(timesteps))
    return (dt, rho, torch.sqrt(1.0 - rho * rho), (rate - div) * dt, kappa * dt,
            kappa * theta * dt, xi)


def heston_step_plain(
    coeffs: tuple[torch.Tensor, ...], sign: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
    logx: torch.Tensor, v: torch.Tensor, *, sum_first: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``csrc/heston_step.cuh::heston_step`` op for op: ``(logx, v, inc)``
    after one full-truncation Euler step from the draw ``(u1, u2)`` (``inc``
    the summed log-price increment where ``sum_first``, the variance swap's
    order, else None). Each FMA of the kernel is rounded once and exactly
    (``rng.fma32_exact``), every other operation alone, and the draw is
    ``box_muller_pinned``, so from the same state the twin's ``v`` and
    ``logx`` are the kernel's bit for bit."""
    dt, rho, rho_bar, rq_dt, kdt, ktheta_dt, xi = coeffs
    rad, cs, sn = box_muller_pinned(u1, u2)
    z_v = sign * (rad * cs)
    z_s = fma32_exact(rho_bar, sign * (rad * sn), rho * z_v)
    v_plus = torch.clamp(v, min=0.0)
    sv = torch.sqrt(v_plus * dt)
    drift_v = -0.5 * v_plus
    inc = None
    if sum_first:
        inc = fma32_exact(sv, z_s, fma32_exact(drift_v, dt, rq_dt))
        logx = logx + inc
    else:
        logx = fma32_exact(sv, z_s, fma32_exact(drift_v, dt, logx + rq_dt))
    v = fma32_exact(xi * sv, z_v, fma32_exact(-kdt, v_plus, v + ktheta_dt))
    return logx, v, inc


def simulate_heston_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
    trace: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The Heston kernel's plain twin: ``[C, rows, cols]`` float32 underliers
    of any non-American, non-cliquet payoff under full-truncation Euler.
    ``params`` is ``[C, 10]`` float32 in ``HestonContract`` order; ``words``
    (tests only) replaces the generator. The variance-swap branch sums its
    increment first and the others add term by term, as the kernel does.
    The draw, the step (``heston_step_plain``) and the variance swap's sum
    of squares take the kernel's roundings, each FMA rounded once exactly,
    so the variance and the variance swap are the kernel's bit for bit (the
    root of a low variance would amplify any ulp between them,
    ``csrc/heston_step.cuh``), and so is the log-price where torch's ``log``
    of the spot is the kernel's ``logf`` (on the card). The epilogues'
    ``exp`` and means are torch's, within rtol 2e-5 of the kernel's.
    ``trace``, when given, receives ``"min_variance"``: each path's least raw
    variance over the steps it took a root of (the start included)."""
    _check(params, key_words, 10)
    branch = _heston_branch(payoff, barrier_rel, timesteps, forward_start_step)
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=-(-timesteps // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, strike, maturity, v0 = (params[:, i, None, None] for i in (0, 1, 2, 5))
    coeffs = heston_coeffs_plain(params, timesteps)
    shape = (params.shape[0], rows, cols)
    logx = torch.log(spot).expand(shape)
    v = v0.expand(shape)
    acc = logx if branch in ("barrier", "lookback", "forward") else torch.zeros(
        shape, device=params.device)
    for j in range(timesteps):
        if trace is not None:
            trace["min_variance"] = torch.minimum(trace.get("min_variance", v), v)
        logx, v, inc = heston_step_plain(coeffs, sign, *uniforms(j), logx, v,
                                         sum_first=branch == "variance")
        if branch == "variance":
            acc = fma32_exact(inc, inc, acc)
        elif branch == "forward":
            if j == forward_start_step - 1:
                acc = logx
        else:
            acc = _observe(branch, payoff, acc, logx)
    out = _finish(branch, payoff, logx, acc, spot=spot, strike=strike, maturity=maturity,
                  steps=timesteps, barrier_rel=barrier_rel)
    return _route_out(payoff, out, params)


def simulate_heston_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Payoff underliers ``[C, rows, cols]`` float32 under full-truncation
    Euler Heston on the Philox stream ``heston``: CPU tensors run the plain
    twin, CUDA tensors launch the Heston kernel (one launch for the whole
    contract batch) or raise."""
    _check(params, key_words, 10)
    if params.device.type == "cpu":
        return simulate_heston_rows_cuda_plain(
            params, key_words, timesteps=timesteps, rows=rows, cols=cols, payoff=payoff,
            barrier_rel=barrier_rel, forward_start_step=forward_start_step,
            antithetic_half=antithetic_half, row_offset=row_offset,
        )
    branch = _heston_branch(payoff, barrier_rel, timesteps, forward_start_step)
    p, words, out = _device_args(params, key_words, timesteps, rows, cols)
    family = _HESTON_FORWARD if branch == "forward" else _FAMILY_CODE[branch]
    status = _library().heston_paths_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, timesteps,
        family, _variant(branch, payoff), 1.0 if barrier_rel is None else barrier_rel,
        forward_start_step or 0, antithetic_half or 0, row_offset, _stream_of(p.device),
    )
    if status != 0:
        raise RuntimeError(f"heston_paths_launch failed: cudaError {status}")
    _count(f"heston_{branch}")
    return _route_out(payoff, out, p)


# --------------------------------------------------------------------------
# Merton (gbm_pallas.py::_merton_block_kernel)
# --------------------------------------------------------------------------


def poisson_levels(mu: torch.Tensor) -> torch.Tensor:
    """The 16 running Poisson(mu) cdf levels ``[..., 16]`` in float32:
    ``p ← p·mu/k; cdf ← cdf + p`` from ``p = cdf = e^{−mu}``, in exactly that
    order (``gbm_pallas.py::_poisson_counts``'s scalars). For ``mu <= 3.2``
    the mass past the last level is below ``2^-24``, which no 24-bit uniform
    reaches, so 16 levels lose no count."""
    mu = mu.to(torch.float32)
    p = torch.exp(-mu)
    cdf = p
    levels = []
    for k in range(1, POISSON_TERMS + 1):
        levels.append(cdf)
        p = p * mu / float(k)
        cdf = cdf + p
    return torch.stack(levels, dim=-1).contiguous()


def poisson_counts(u: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Inverse-cdf Poisson counts (float32): the number of ``levels``
    (``[..., 16]``, broadcast against ``u``'s shape) at or below ``u``."""
    cnt = torch.zeros(u.shape, dtype=torch.uint8, device=u.device)
    for k in range(POISSON_TERMS):
        cnt += u >= levels[..., k]
    return cnt.to(torch.float32)


def merton_count(u: torch.Tensor, levels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/merton_step.cuh::merton_count`` op for op: ``(n, √n)`` float32,
    ``n`` the index past the last of ``levels`` (``[..., 16]``, never
    decreasing) at or below ``u``. With ``K = MERTON_COUNT_FIRST`` the first
    ``K − 1`` levels decide ``n`` below level ``K − 1``; at or past it the
    rest do. With levels that never decrease this is ``poisson_counts`` on
    every ``u``. ``√n`` is the IEEE root (the kernel's constants below ``K``
    are its values)."""
    first = MERTON_COUNT_FIRST
    n = torch.zeros(u.shape, dtype=torch.uint8, device=u.device)
    for i in range(first - 1):
        n.masked_fill_(u >= levels[..., i], i + 1)
    rest = torch.full(u.shape, first, dtype=torch.uint8, device=u.device)
    for i in range(first, POISSON_TERMS):
        rest.masked_fill_(u >= levels[..., i], i + 1)
    n = torch.where(u >= levels[..., first - 1], rest, n).to(torch.float32)
    return n, torch.sqrt(n)


def merton_table(params: torch.Tensor, timesteps: int) -> torch.Tensor:
    """``[C, 20]`` float32, ``csrc/merton_step.cuh``'s per-contract table:
    ``(drift·dt, vol·√dt, μ_J, σ_J)`` with the compensated drift ``r − q −
    λ·(e^{μ_J + σ_J²/2} − 1) − σ²/2``, then ``poisson_levels(λ·dt)``. ``dt``
    is divided by a tensor: on the card torch divides by a Python number as
    a product with its reciprocal, an ulp off the quotient for a step count
    that is not a power of two."""
    maturity, rate, div, vol, lam, jump_mean, jump_std = (
        params[:, i] for i in (2, 3, 4, 5, 6, 7, 8))
    dt = maturity / torch.full_like(maturity, float(timesteps))
    m = torch.exp(jump_mean + 0.5 * jump_std * jump_std) - 1.0
    drift = (rate - div - lam * m - 0.5 * vol * vol) * dt
    head = torch.stack([drift, vol * torch.sqrt(dt), jump_mean, jump_std], dim=1)
    return torch.cat([head, poisson_levels(lam * dt)], dim=1).contiguous()


def merton_words(call: Words) -> Callable[[int], tuple[torch.Tensor, ...]]:
    """``words(t)``: step ``t``'s words ``3t``, ``3t+1``, ``3t+2`` of the
    stream (word ``i`` is word ``i % 4`` of call ``i // 4``), called in order
    ``t = 0, 1, …``: the ``merton_jump`` v2 layout."""
    calls: dict[int, tuple[torch.Tensor, ...]] = {}

    def words(t: int) -> tuple[torch.Tensor, ...]:
        for q in [q for q in calls if q < 3 * t // 4]:
            del calls[q]
        out = []
        for i in range(3 * t, 3 * t + 3):
            if i // 4 not in calls:
                calls[i // 4] = call(i // 4)
            out.append(calls[i // 4][i % 4])
        return tuple(out)

    return words


def merton_calls(timesteps: int) -> int:
    """Philox calls a path of ``timesteps`` Merton steps reads."""
    return -(-3 * timesteps // 4)


def merton_step_plain(
    table: torch.Tensor, sign: torch.Tensor, words: tuple[torch.Tensor, ...],
    logx: torch.Tensor, *, sum_first: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``csrc/merton_step.cuh::merton_step`` op for op: ``(logx, inc)`` after
    one step from the step's three words (``inc`` the summed increment where
    ``sum_first``, the variance swap's order, else None). ``table`` is
    ``merton_table`` broadcast as ``[C, 1, 1, 20]``. The draw is
    ``box_muller_pinned``, the count ``merton_count``, each FMA of the kernel
    rounded once and exactly (``rng.fma32_exact``), every other operation
    alone, so from the same state the twin's ``logx`` is the kernel's bit
    for bit."""
    drift, vol_sdt, jump_mean, jump_std = (table[..., i] for i in range(4))
    rad, cs, sn = box_muller_pinned(uniform_open(words[0]), uniform_closed(words[1]))
    z_d = sign * (rad * cs)
    z_j = sign * (rad * sn)
    n, root = merton_count(uniform_closed(words[2]), table[..., 4:])
    jump = fma32_exact(jump_std * root, z_j, n * jump_mean)
    inc = None
    if sum_first:
        inc = fma32_exact(vol_sdt, z_d, drift) + jump
        logx = logx + inc
    else:
        logx = fma32_exact(vol_sdt, z_d, logx + drift) + jump
    return logx, inc


def simulate_merton_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
    trace: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The Merton kernel's plain twin: ``[C, rows, cols]`` float32 underliers
    of any non-American, non-cliquet payoff under the exact compensated
    step. ``params`` is ``[C, 9]`` float32 in ``MertonContract`` order;
    ``words`` (tests only) replaces the generator (``[C, rows, cols,
    merton_calls(T), 4]``). The step is ``merton_step_plain`` on the
    ``merton_jump`` v2 words, the variance swap's sum of squares the
    kernel's FMA: the log-price is the kernel's bit for bit on the card
    (where torch's ``log`` of the spot is the kernel's ``logf``), the
    epilogues' ``exp``, ``log`` and means torch's, within rtol 2e-5 of the
    kernel's. ``trace``, when given, receives ``"log_price"``: each path's
    final log-price."""
    _check(params, key_words, 9)
    branch = _branch(payoff, barrier_rel)
    p, steps = _route_in(payoff, params, timesteps, forward_start_step)
    sign, call = _stream(
        p, key_words, rows=rows, cols=cols, calls=merton_calls(steps),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    step_words = merton_words(call)
    spot, strike, maturity = (p[:, i, None, None] for i in range(3))
    table = merton_table(p, steps)[:, None, None, :]
    shape = (p.shape[0], rows, cols)
    logx = torch.log(spot).expand(shape)
    acc = logx if branch in ("barrier", "lookback") else torch.zeros(shape, device=p.device)
    for t in range(steps):
        logx, inc = merton_step_plain(table, sign, step_words(t), logx,
                                      sum_first=branch == "variance")
        if branch == "variance":
            acc = fma32_exact(inc, inc, acc)
        else:
            acc = _observe(branch, payoff, acc, logx)
    if trace is not None:
        trace["log_price"] = logx
    out = _finish(branch, payoff, logx, acc, spot=spot, strike=strike, maturity=maturity,
                  steps=steps, barrier_rel=barrier_rel)
    return _route_out(payoff, out, p)


def simulate_merton_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    trace: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Payoff underliers ``[C, rows, cols]`` float32 under the exact Merton
    step on the Philox stream ``merton_jump`` (v2): CPU tensors run the plain
    twin, CUDA tensors launch the Merton kernel (one launch for the whole
    contract batch, after the ``[C, 20]`` table) or raise. ``trace``, when
    given, receives ``"log_price"``, each path's final log-price (the
    kernel writes it beside the value)."""
    _check(params, key_words, 9)
    if params.device.type == "cpu":
        return simulate_merton_rows_cuda_plain(
            params, key_words, timesteps=timesteps, rows=rows, cols=cols, payoff=payoff,
            barrier_rel=barrier_rel, forward_start_step=forward_start_step,
            antithetic_half=antithetic_half, row_offset=row_offset, trace=trace,
        )
    branch = _branch(payoff, barrier_rel)
    p, steps = _route_in(payoff, params, timesteps, forward_start_step)
    p, words, out = _device_args(p, key_words, steps, rows, cols)
    table = merton_table(p, steps)
    log_price = None if trace is None else torch.empty_like(out)
    status = _library().merton_paths_launch(
        p.data_ptr(), words.data_ptr(), table.data_ptr(), out.data_ptr(),
        None if log_price is None else log_price.data_ptr(), p.shape[0], rows, cols, steps,
        _FAMILY_CODE[branch], _variant(branch, payoff),
        1.0 if barrier_rel is None else barrier_rel, antithetic_half or 0, row_offset,
        _stream_of(p.device),
    )
    if status != 0:
        raise RuntimeError(f"merton_paths_launch failed: cudaError {status}")
    _count(f"merton_{branch}")
    if trace is not None:
        trace["log_price"] = log_price
    return _route_out(payoff, out, p)
