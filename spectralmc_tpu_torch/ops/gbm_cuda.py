"""The ``"cuda"`` MC engine: flat GBM payoff underliers from hand-written Hopper kernels.

``csrc/gbm_paths.cu`` replaces the JAX package's
``ops/gbm_pallas.py::_gbm_block_kernel`` (every payoff branch, both path
schemes) and ``_gbm_cliquet_block_kernel`` (log-Euler cliquets); its header
states what it keeps, what it drops and what bounds it. This module holds

* the public wrappers ``simulate_underlier_rows_cuda`` and
  ``simulate_cliquet_rows_cuda``. A CPU tensor goes to the plain twin; a
  CUDA tensor launches the kernel or raises. There is no fallback between
  the two.
* the plain twins ``simulate_terminal_rows_cuda_plain``,
  ``simulate_underlier_rows_cuda_plain`` and
  ``simulate_cliquet_rows_cuda_plain``: the same Philox words and the same
  float32 arithmetic in torch ops. The CPU tests hold them against the JAX
  kernels; the card holds the kernels against them.
* ``cuda_supported`` — the single source of truth for when the engine runs,
  for every dynamics (``ops/gbm.py::resolve_implementation`` asks it).
* ``CUDA_STREAM_VERSIONS`` — the streams' versions, recorded by the trainer:
  any change to the draw order or arithmetic is a new stream. ``gbm`` covers
  the flat kernel's branches and the routes through its TERMINAL branch
  (digital, and forward start at its tail length); the cliquet kernel is a
  different program with its own key, and so are the curved-term, Heston
  and Merton kernels of ``ops/dynamics_cuda.py``, the basket kernel of
  ``ops/basket_cuda.py`` and the American monitor-row kernels of
  ``ops/american_cuda.py`` (``american_gbm``, ``american_heston``,
  ``american_merton_jump``, ``american_basket_gbm``). At 2: ``gbm`` (every
  branch walks whole Philox calls; its Box–Muller takes ln u1 and the sine
  and cosine on fixed roundings and the root on the SFU,
  ``csrc/gbm_step.cuh``), ``basket_gbm`` and ``american_basket_gbm`` (their
  Box–Muller on the SFU, ``csrc/path_stream.cuh``), ``heston`` and
  ``american_heston`` (the draw and the step on fixed roundings that the
  twins repeat bit for bit, ``csrc/heston_step.cuh``), ``merton_jump`` and
  ``american_merton_jump`` (three words a step, four steps on three whole
  Philox calls, and the draw, the count and the step on fixed roundings,
  ``csrc/merton_step.cuh``), ``gbm_term`` (the curved-term kernel: whole
  Philox calls, the fixed-rounding draw and steps, no ``(R, φ)`` table,
  ``ops/dynamics_cuda.py``) and ``gbm_cliquet`` (the cliquet kernel walks
  whole calls, four periods a call, ``csrc/gbm_step.cuh::walk_pairs``, on
  the fixed-rounding draw, ``box_muller_pinned``, and a pinned period
  return ``fminf(fmaxf(expf(fma(vol_k, z, drift_k)) − 1, floor), cap)``,
  which its twin repeats bit for bit); at 3 ``american_gbm`` (v2: the odd
  single step's Box–Muller on the SFU; v3: its pair steps are ``gbm``'s v2
  pair step, so an even grid's last row is the TERMINAL branch's value bit
  for bit). The flat kernel's plain twins keep the v1 arithmetic (libm's
  transform, evaluated in torch): the kernel is held to them within the
  gates, not bit for bit.
* ``LAUNCHES`` (every launch of any entry point) and ``LAUNCHES_BY_BRANCH``
  (per kernel and branch group, the QMC generator's two kernels of
  ``ops/qmc_cuda.py`` and the American kernels of ``ops/american_cuda.py``
  included, and ``torch_estimator``, the torch LSMC estimator's runs) —
  plain counts.

The stream: Philox-4x32-10 keyed by the contract's two threefry key words
(``fold_in(prng_key(mc_seed), draw)``), counter ``(path lo, path hi, call,
0)`` with ``path = base_row·cols + col``. Draw ``j`` (two words) is words
``2(j%2), 2(j%2)+1`` of call ``j // 2``. TERMINAL and the variance swap
under log-Euler take ``T // 2`` pair-step draws and one single-step draw
when ``T`` is odd; the cliquet the same over its periods (a pair draw's
``r·cos θ`` and ``r·sin θ`` drive two periods, the odd last period
``r·cos θ``); every other branch one draw per step.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    BARRIER_PAYOFFS,
    LOOKBACK_MAX_PAYOFFS,
    LOOKBACK_PAYOFFS,
    ModelKind,
    PathScheme,
    PayoffKind,
    SamplingKind,
    TermStructure,
    curved,
    lookback_underlier,
)
from spectralmc_tpu_torch.ops.rng import (
    MASK32,
    box_muller_pinned,
    fma32_exact,
    philox4x32,
    sqrt_rn,
)

CUDA_STREAM_VERSIONS: dict[str, int] = {
    "gbm": 2, "gbm_cliquet": 2, "gbm_term": 2, "heston": 2, "merton_jump": 2, "basket_gbm": 2,
    "american_gbm": 3, "american_heston": 2, "american_merton_jump": 2,
    "american_basket_gbm": 2,
}

# branch groups, each a kernel instantiation of its own: the flat kernel's and
# the cliquet, ops/dynamics_cuda.py's three kernels, the basket kernel, the
# QMC generator's two kernels, then ops/american_cuda.py's monitor-row
# forwards (one per dynamics) and its LSMC backward, counted by route
# (resident on chip or streamed through HBM) and by mode (one or two states);
# last, the torch LSMC estimator's runs, which launch no kernel of these
FLAT_BRANCHES = ("terminal", "barrier", "lookback", "variance", "asian")
BRANCHES = (
    *FLAT_BRANCHES, "cliquet",
    *(f"term_{b}" for b in FLAT_BRANCHES),
    *(f"heston_{b}" for b in (*FLAT_BRANCHES, "forward")),
    *(f"merton_{b}" for b in FLAT_BRANCHES),
    *(f"basket_{b}" for b in (*FLAT_BRANCHES, "forward")),
    "qmc_bridge", "qmc_walk",
    "american_gbm", "american_heston", "american_merton", "american_basket",
    "lsmc_backward", "lsmc_backward_streamed", "lsmc_two_state", "lsmc_two_state_streamed",
    "torch_estimator",
)
MAX_BASKET_ASSETS = 8  # csrc/basket_paths.cu's kMaxAssets
MAX_MONITOR_DATES = 128  # the monitor kernels' cap (the JAX kernels' _MONITOR_MAX_DATES)
LAUNCHES = 0
LAUNCHES_BY_BRANCH: dict[str, int] = dict.fromkeys(BRANCHES, 0)

_SQRT2 = math.sqrt(2.0)
_SCHEME_CODE = {PathScheme.LOG_EULER: 0, PathScheme.EULER: 1}
# csrc/gbm_paths.cu's kFamily codes
_FAMILY_CODE = {"terminal": 0, "barrier": 1, "lookback": 2, "variance": 3, "asian": 4}
_LOOKBACK_VARIANT = {
    PayoffKind.LOOKBACK_FIXED_CALL: 0,
    PayoffKind.LOOKBACK_FIXED_PUT: 1,
    PayoffKind.LOOKBACK_FLOAT_CALL: 2,
    PayoffKind.LOOKBACK_FLOAT_PUT: 3,
}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for name in BRANCHES:
        LAUNCHES_BY_BRANCH[name] = 0


def branch_of(payoff: PayoffKind) -> str:
    """The kernel branch a payoff runs: digital and forward start are routes
    through TERMINAL."""
    if payoff in (PayoffKind.TERMINAL, PayoffKind.DIGITAL, PayoffKind.FORWARD_START):
        return "terminal"
    if payoff in BARRIER_PAYOFFS:
        return "barrier"
    if payoff in LOOKBACK_PAYOFFS:
        return "lookback"
    if payoff == PayoffKind.VARIANCE_SWAP:
        return "variance"
    if payoff in (PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC):
        return "asian"
    if payoff == PayoffKind.CLIQUET:
        return "cliquet"
    raise ValueError(f"the cuda engine has no kernel for payoff={payoff.value!r}")


def cuda_supported(
    *,
    dtype: torch.dtype,
    model: ModelKind,
    payoff: PayoffKind,
    sampling: SamplingKind,
    term: TermStructure | None = None,
    scheme: PathScheme = PathScheme.LOG_EULER,
    n_assets: int = 1,
    timesteps: int | None = None,
    exercise_every: int = 1,
) -> bool:
    """Whether a kernel honors the request: float32 paths on the
    pseudo-random stream, any dynamics, any payoff, any row/column count, and

    * the American kinds only on flat market data under log-Euler (the
      monitor-row kernels of GBM, Heston, Merton and baskets), with
      ``exercise_every`` dividing ``timesteps`` into 2 to
      ``MAX_MONITOR_DATES`` (128) monitor dates;

    * cliquets only for flat GBM under log-Euler (the per-period kernel; the
      other dynamics carry period-start state or per-step jumps, curves
      break the period's Gaussian sum, and under Euler it is none);
    * a curved term only for GBM under log-Euler (the term kernel); curved
      Heston, Merton and baskets run their threefry scans;
    * Heston, Merton and baskets under log-Euler only (Merton and baskets are
      refused otherwise at config time; Heston's step is its own scheme);
    * baskets of 1 to ``MAX_BASKET_ASSETS`` (8) assets.

    A flat term is no term. ``SOBOL_BB`` runs the threefry engine's scans on
    the QMC generator's normals.
    """
    if dtype != torch.float32 or sampling != SamplingKind.PSEUDO:
        return False
    if model == ModelKind.BASKET_GBM and not 1 <= n_assets <= MAX_BASKET_ASSETS:
        return False
    is_curved = curved(term) is not None
    if payoff in AMERICAN_PAYOFFS:
        grid_ok = (timesteps is not None and exercise_every >= 1
                   and timesteps % exercise_every == 0
                   and 2 <= timesteps // exercise_every <= MAX_MONITOR_DATES)
        return grid_ok and scheme == PathScheme.LOG_EULER and not is_curved
    if payoff == PayoffKind.CLIQUET:
        return model == ModelKind.GBM and scheme == PathScheme.LOG_EULER and not is_curved
    if is_curved:
        return model == ModelKind.GBM and scheme == PathScheme.LOG_EULER
    return True


def cuda_stream_version(
    model: ModelKind, payoff: PayoffKind | None = None, *, term: bool = False
) -> int:
    """The stream version a checkpoint records (``pallas_stream_version``'s
    rule): the American kinds under ``american_{family}`` (the monitor-row
    kernel is its own program), the cliquet kernel under its own key, a
    genuinely curved term on GBM (``term=True``) under the term kernel's,
    everything else under the model family's (``basket_gbm`` for the basket
    kernel)."""
    if payoff in AMERICAN_PAYOFFS:
        return CUDA_STREAM_VERSIONS[f"american_{model.value}"]
    if payoff == PayoffKind.CLIQUET and model == ModelKind.GBM and not term:
        return CUDA_STREAM_VERSIONS["gbm_cliquet"]
    if term and model == ModelKind.GBM:
        return CUDA_STREAM_VERSIONS["gbm_term"]
    return CUDA_STREAM_VERSIONS[model.value]


def draw_count(timesteps: int, scheme: PathScheme, payoff: PayoffKind = PayoffKind.TERMINAL) -> int:
    """Two-word draws one path of a flat-kernel branch consumes (at the
    branch's own step count: a forward start's is its tail)."""
    if scheme == PathScheme.LOG_EULER and branch_of(payoff) in ("terminal", "variance"):
        return timesteps // 2 + timesteps % 2
    return timesteps


def _check(params: torch.Tensor, key_words: torch.Tensor, dim: int = 6) -> None:
    if params.dtype != torch.float32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    if params.ndim != 2 or params.shape[1] != dim:
        raise ValueError(f"params must be [C, {dim}], got {tuple(params.shape)}")
    if key_words.ndim != 2 or key_words.shape != (params.shape[0], 2):
        raise ValueError(f"key_words must be [C, 2], got {tuple(key_words.shape)}")
    if key_words.device != params.device:
        raise ValueError(f"params on {params.device}, key_words on {key_words.device}")


# --------------------------------------------------------------------------
# The plain twins
# --------------------------------------------------------------------------


def _sinpi(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(math.pi * x.to(torch.float64)).to(torch.float32)


def _cospi(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(math.pi * x.to(torch.float64)).to(torch.float32)


Uniforms = Callable[[int], tuple[torch.Tensor, torch.Tensor]]
Words = Callable[[int], tuple[torch.Tensor, ...]]


def _stream(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    rows: int,
    cols: int,
    calls: int,
    antithetic_half: int | None,
    row_offset: int,
    words: torch.Tensor | None,
) -> tuple[torch.Tensor, Words]:
    """``(sign [rows, 1], call)``: ``call(i)`` gives Philox call ``i``'s four
    words, each ``[C, rows, cols]`` (from ``words`` when given: a tensor
    broadcastable to ``[C, rows, cols, calls, 4]``)."""
    device = params.device
    n_contracts = params.shape[0]
    kw = key_words.to(torch.int64) & MASK32
    k0 = kw[:, 0, None, None]
    k1 = kw[:, 1, None, None]
    row = row_offset + torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    sign = torch.ones((rows, 1), dtype=torch.float32, device=device)
    if antithetic_half is not None:
        upper = row >= antithetic_half
        sign = torch.where(upper, -1.0, 1.0).to(torch.float32)
        row = torch.where(upper, row - antithetic_half, row)
    path = row * cols + torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    c0 = (path & MASK32)[None]
    c1 = (path >> 32)[None]
    zero = torch.zeros_like(c0)
    if words is not None:
        words = torch.broadcast_to(
            words.to(torch.int64).to(device), (n_contracts, rows, cols, calls, 4)
        )

    def call(i: int) -> tuple[torch.Tensor, ...]:
        if words is not None:
            return tuple(words[..., i, k] for k in range(4))
        return philox4x32((c0, c1, zero + i, zero), (k0, k1))

    return sign, call


def uniform_open(word: torch.Tensor) -> torch.Tensor:
    """``(0, 1)`` float32 from a word's top 24 bits: ``b·2^-24 + 2^-25``."""
    return (word >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def uniform_closed(word: torch.Tensor) -> torch.Tensor:
    """``[0, 1)`` float32 from a word's top 24 bits: ``b·2^-24``."""
    return (word >> 8).to(torch.float32) * 2.0**-24


def _pair_draws(call: Words) -> Uniforms:
    """``uniforms(j)``: draw ``j``'s ``(u1, u2)`` from words ``2(j%2),
    2(j%2)+1`` of call ``j // 2``, called in order ``j = 0, 1, …`` (each even
    ``j`` computes the Philox call the odd one reuses)."""
    current: list[tuple[torch.Tensor, ...]] = []

    def uniforms(j: int) -> tuple[torch.Tensor, torch.Tensor]:
        if j % 2 == 0:
            current[:] = [call(j // 2)]
        w = current[0]
        a, b = (w[0], w[1]) if j % 2 == 0 else (w[2], w[3])
        return uniform_open(a), uniform_closed(b)

    return uniforms


def simulate_terminal_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    scheme: PathScheme,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The TERMINAL branch's plain twin: ``[C, rows, cols]`` float32 values.

    ``params`` is ``[C, 6]`` float32, ``key_words`` ``[C, 2]`` uint32 words
    (any integer dtype). ``words`` (tests only) replaces the generator: a
    tensor broadcastable to ``[C, rows, cols, calls, 4]`` of uint32 words.
    Transcendentals run as torch ops; ``sin(π·x)`` is evaluated in float64
    (of the same float32 argument) and rounded, standing in for the kernel's
    ``sinpif``/``cospif``.
    """
    return simulate_underlier_rows_cuda_plain(
        params, key_words, timesteps=timesteps, rows=rows, cols=cols, scheme=scheme,
        payoff=PayoffKind.TERMINAL, antithetic_half=antithetic_half, row_offset=row_offset,
        words=words,
    )


def _tail_params(params: torch.Tensor, timesteps: int, forward_start_step: int) -> torch.Tensor:
    """Forward start's TERMINAL route: maturity scaled by ``(N − m)/N`` (in
    float32, as the JAX kernel route does), so ``dt`` is unchanged."""
    scale = torch.tensor((timesteps - forward_start_step) / timesteps, dtype=torch.float32)
    out = params.clone()
    out[:, 2] = out[:, 2] * scale.to(params.device)
    return out


def _route_in(
    payoff: PayoffKind, params: torch.Tensor, timesteps: int, forward_start_step: int | None
) -> tuple[torch.Tensor, int]:
    """The ``(params, timesteps)`` the kernel runs for ``payoff``."""
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None or not 1 <= forward_start_step < timesteps:
            raise ValueError(f"forward start needs 1 <= forward_start_step < {timesteps}")
        return _tail_params(params, timesteps, forward_start_step), timesteps - forward_start_step
    return params, timesteps


def _route_out(payoff: PayoffKind, values: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Digital's transform of the TERMINAL draw: ``K + sign(S_T − K)``."""
    if payoff == PayoffKind.DIGITAL:
        strike = params[:, 1, None, None]
        return strike + torch.sign(values - strike)
    return values


def simulate_underlier_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    scheme: PathScheme,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The flat kernel's plain twin: ``[C, rows, cols]`` float32 underliers of
    any non-American, non-cliquet payoff (the cliquet's twin is
    ``simulate_cliquet_rows_cuda_plain``). Same arguments as
    ``simulate_terminal_rows_cuda_plain`` plus the payoff's knobs."""
    _check(params, key_words)
    branch = branch_of(payoff)
    if branch == "cliquet":
        raise ValueError("cliquets run simulate_cliquet_rows_cuda_plain")
    if branch == "barrier" and barrier_rel is None:
        raise ValueError(f"payoff={payoff.value!r} needs barrier_rel")
    p, steps = _route_in(payoff, params, timesteps, forward_start_step)
    sign, call = _stream(
        p, key_words, rows=rows, cols=cols, calls=-(-draw_count(steps, scheme, payoff) // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    n_contracts = p.shape[0]
    spot, strike, maturity, rate, div, vol = (p[:, i, None, None] for i in range(6))
    dt = maturity / float(steps)
    vol_sdt = vol * torch.sqrt(dt)
    carry = rate - div

    def normal(j: int) -> torch.Tensor:
        u1, u2 = uniforms(j)
        return sign * (torch.sqrt(-2.0 * torch.log(u1)) * _cospi(2.0 * u2))

    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS

    if scheme == PathScheme.LOG_EULER:
        drift = (carry - 0.5 * vol * vol) * dt
        if branch == "terminal":
            two_drift = 2.0 * drift
            pairs = steps // 2
            logx = torch.log(spot).expand(n_contracts, rows, cols)
            for j in range(draw_count(steps, scheme, payoff)):
                u1, u2 = uniforms(j)
                rad = torch.sqrt(-2.0 * torch.log(u1))
                if j < pairs:
                    z = sign * (rad * _SQRT2 * _sinpi(2.0 * u2 + 0.25))
                    logx = (logx + two_drift) + vol_sdt * z
                else:
                    z = sign * (rad * _cospi(2.0 * u2))
                    logx = (logx + drift) + vol_sdt * z
            return _route_out(payoff, torch.exp(logx), p)
        if branch == "variance":
            base_c = 2.0 * drift * drift
            b_sq = vol_sdt * vol_sdt
            cross_c = 2.0 * _SQRT2 * drift * vol_sdt
            pairs = steps // 2
            acc = torch.zeros((n_contracts, rows, cols), dtype=torch.float32, device=p.device)
            for j in range(draw_count(steps, scheme, payoff)):
                u1, u2 = uniforms(j)
                x = -2.0 * torch.log(u1)
                if j < pairs:
                    s = torch.sqrt(x) * _sinpi(2.0 * u2 + 0.25)
                    acc = acc + ((base_c + b_sq * x) + sign * (cross_c * s))
                else:
                    z = sign * (torch.sqrt(x) * _cospi(2.0 * u2))
                    inc = drift + vol_sdt * z
                    acc = acc + inc * inc
            return acc / maturity
        log0 = torch.log(spot).expand(n_contracts, rows, cols)
        logx, acc = log0, (torch.zeros_like(log0) if branch == "asian" else log0)
        for j in range(steps):
            logx = (logx + drift) + vol_sdt * normal(j)
            if branch == "asian":
                acc = acc + (logx if geometric else torch.exp(logx))
            else:
                acc = torch.maximum(acc, logx) if up else torch.minimum(acc, logx)
        if branch == "asian":
            mean = acc * float(1.0 / steps)
            return torch.exp(mean) if geometric else mean
        if branch == "barrier":
            level = torch.log(spot * torch.tensor(barrier_rel, dtype=torch.float32))
            knocked = acc >= level if up else acc <= level
            return torch.where(knocked, strike, torch.exp(logx))
        return lookback_underlier(payoff, strike, torch.exp(acc), torch.exp(logx))
    growth = 1.0 + carry * dt
    if branch == "variance":
        acc = torch.zeros((n_contracts, rows, cols), dtype=torch.float32, device=p.device)
        for j in range(steps):
            inc = torch.log(torch.abs(growth + vol_sdt * normal(j)))
            acc = acc + inc * inc
        return acc / maturity
    x = spot.expand(n_contracts, rows, cols)
    acc = torch.zeros_like(x) if branch == "asian" else x
    for j in range(steps):
        x = torch.abs(x * (growth + vol_sdt * normal(j)))
        if branch == "asian":
            acc = acc + (torch.log(x) if geometric else x)
        elif branch != "terminal":
            acc = torch.maximum(acc, x) if up else torch.minimum(acc, x)
    if branch == "terminal":
        return _route_out(payoff, x, p)
    if branch == "asian":
        mean = acc * float(1.0 / steps)
        return torch.exp(mean) if geometric else mean
    if branch == "barrier":
        level = spot * torch.tensor(barrier_rel, dtype=torch.float32)
        knocked = acc >= level if up else acc <= level
        return torch.where(knocked, strike, x)
    return lookback_underlier(payoff, strike, acc, x)


def _check_cliquet(timesteps: int, reset_every: int, floor: float, cap: float) -> None:
    if reset_every < 1 or timesteps % reset_every or timesteps // reset_every < 2:
        raise ValueError(
            f"reset_every={reset_every} must divide timesteps={timesteps} into >= 2 periods"
        )
    if not -1.0 < floor < cap:
        raise ValueError(f"need -1 < floor < cap, got floor={floor}, cap={cap}")


def simulate_cliquet_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    reset_every: int,
    floor: float,
    cap: float,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """The cliquet kernel's plain twin: ``[C, rows, cols]`` float32 sums
    ``Σ_j clip(e^{L_j} − 1, floor, cap)`` with one Gaussian per reset period;
    ``words`` as in ``simulate_terminal_rows_cuda_plain``. The draw
    (``rng.box_muller_pinned``), the period's FMA (rounded once exactly,
    ``rng.fma32_exact``) and every other operation take the kernel's
    roundings, and ``dt`` is divided by a tensor (torch on the card divides
    by a Python number as a product with its reciprocal), so on the card the
    sums are the kernel's bit for bit."""
    _check(params, key_words)
    _check_cliquet(timesteps, reset_every, floor, cap)
    periods = timesteps // reset_every
    pairs = periods // 2
    draws = pairs + periods % 2
    sign, call = _stream(
        params, key_words, rows=rows, cols=cols, calls=-(-draws // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    _, _, maturity, rate, div, vol = (params[:, i, None, None] for i in range(6))
    dt = maturity / torch.full_like(maturity, float(timesteps))
    k = float(reset_every)
    period_drift = (rate - div - 0.5 * vol * vol) * dt * k
    period_vol = vol * sqrt_rn(dt * k)
    floor_c = torch.tensor(floor, dtype=torch.float32, device=params.device)
    cap_c = torch.tensor(cap, dtype=torch.float32, device=params.device)

    def clipped(z: torch.Tensor) -> torch.Tensor:
        ret = torch.exp(fma32_exact(period_vol, z, period_drift)) - 1.0
        return torch.minimum(torch.maximum(ret, floor_c), cap_c)

    acc = torch.zeros((params.shape[0], rows, cols), dtype=torch.float32, device=params.device)
    for j in range(draws):
        rad, cs, sn = box_muller_pinned(*uniforms(j))
        srad = sign * rad  # the antithetic sign, exact
        acc = acc + clipped(srad * cs)
        if j < pairs:
            acc = acc + clipped(srad * sn)
    return acc


# --------------------------------------------------------------------------
# The kernels and their wrappers
# --------------------------------------------------------------------------


# ops/_build.py::load_library's arguments for this module's kernels
LIBRARY = ("gbm_paths", ("gbm_paths.cu",))


def _kernel() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*LIBRARY).lib
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gbm_paths_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, i, i, f, ll, ll, vp]
    lib.gbm_cliquet_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, f, f, ll, ll, vp]
    lib.gbm_paths_launch.restype = ctypes.c_int
    lib.gbm_cliquet_launch.restype = ctypes.c_int
    return lib


def _device_args(
    params: torch.Tensor, key_words: torch.Tensor, timesteps: int, rows: int, cols: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Checked ``(params, int32 key words, out)`` for a launch on the card."""
    if params.device.type != "cuda":
        raise ValueError(f"the cuda engine runs on cpu (plain twin) or cuda, not {params.device}")
    if timesteps <= 0 or rows <= 0 or cols <= 0:
        raise ValueError(f"need positive timesteps/rows/cols, got {timesteps}/{rows}/{cols}")
    if params.shape[0] > 65535:
        raise ValueError(f"at most 65535 contracts per launch, got {params.shape[0]}")
    words = key_words.to(torch.int64) & MASK32
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32).contiguous()
    out = torch.empty((params.shape[0], rows, cols), dtype=torch.float32, device=params.device)
    return params.contiguous(), words, out


def _count(branch: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_BRANCH[branch] += 1


def simulate_underlier_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    scheme: PathScheme,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Payoff underliers ``[C, rows, cols]`` float32 on the Philox stream, for
    any non-American, non-cliquet payoff.

    CPU tensors run the plain twin; CUDA tensors launch the flat kernel on
    the current stream (one launch for the whole contract batch; digital and
    forward start run its TERMINAL branch and transform the result). Any
    other device, dtype or shape raises.
    """
    _check(params, key_words)
    kwargs = dict(
        timesteps=timesteps, rows=rows, cols=cols, scheme=scheme, payoff=payoff,
        barrier_rel=barrier_rel, forward_start_step=forward_start_step,
        antithetic_half=antithetic_half, row_offset=row_offset,
    )
    if params.device.type == "cpu":
        return simulate_underlier_rows_cuda_plain(params, key_words, **kwargs)
    branch = branch_of(payoff)
    if branch == "cliquet":
        raise ValueError("cliquets run simulate_cliquet_rows_cuda")
    if branch == "barrier" and barrier_rel is None:
        raise ValueError(f"payoff={payoff.value!r} needs barrier_rel")
    p, steps = _route_in(payoff, params, timesteps, forward_start_step)
    p, words, out = _device_args(p, key_words, steps, rows, cols)
    if branch == "barrier":
        variant = int(payoff == PayoffKind.BARRIER_UP_OUT)
    elif branch == "lookback":
        variant = _LOOKBACK_VARIANT[payoff]
    else:
        variant = int(payoff == PayoffKind.ASIAN_GEOMETRIC)
    status = _kernel().gbm_paths_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, steps,
        _SCHEME_CODE[scheme], _FAMILY_CODE[branch], variant,
        1.0 if barrier_rel is None else barrier_rel, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"gbm_paths_launch failed: cudaError {status}")
    _count(branch)
    return _route_out(payoff, out, p)


def simulate_cliquet_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    reset_every: int,
    floor: float,
    cap: float,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Cliquet underliers ``[C, rows, cols]`` float32 (log-Euler) on the
    Philox stream: CPU tensors run the plain twin, CUDA tensors launch the
    cliquet kernel or raise."""
    _check(params, key_words)
    kwargs = dict(
        timesteps=timesteps, rows=rows, cols=cols, reset_every=reset_every, floor=floor,
        cap=cap, antithetic_half=antithetic_half, row_offset=row_offset,
    )
    if params.device.type == "cpu":
        return simulate_cliquet_rows_cuda_plain(params, key_words, **kwargs)
    _check_cliquet(timesteps, reset_every, floor, cap)
    p, words, out = _device_args(params, key_words, timesteps, rows, cols)
    status = _kernel().gbm_cliquet_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, timesteps,
        reset_every, floor, cap, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"gbm_cliquet_launch failed: cudaError {status}")
    _count("cliquet")
    return out


# --------------------------------------------------------------------------
# The differentiable TERMINAL forward: kernel #1 or #2, the pathwise rule back
# --------------------------------------------------------------------------


def term_pathwise_factors(term: TermStructure, timesteps: int) -> tuple[float, float, float]:
    """``(mean vs², mean rs, mean qs)`` of a curve's shapes, in float64: the
    effective factors of ``terminal_pathwise_vjp``."""
    vs, rs, qs = term.shapes(timesteps)
    n = float(timesteps)
    return sum(v * v for v in vs) / n, sum(rs) / n, sum(qs) / n


def terminal_pathwise_vjp(
    g: torch.Tensor,
    s_t: torch.Tensor,
    contracts: torch.Tensor,
    term_factors: tuple[float, float, float] | None = None,
) -> torch.Tensor:
    """Cotangent ``[C, 6]`` on the contracts from cotangent ``g`` on log-Euler
    terminal values ``s_t`` (both ``[C, ...]``), without re-running the walk.

    ``log S_T = log S0 + μT + W`` with ``μ = r − q − v²/2`` and ``W = v·√dt·Σ
    z_t`` a function of the contract-free normals alone, so ``W`` is read off
    the output: ``W = log(S_T/S0) − μT``. Then, elementwise,

        ∂logS_T/∂S0 = 1/S0            ∂logS_T/∂K = 0
        ∂logS_T/∂T  = μ + W/(2T)
        ∂logS_T/∂r  = T               ∂logS_T/∂q = −T
        ∂logS_T/∂v  = −v·T + W/v

    and five reductions over the paths. ``term_factors = (mean vs², mean
    rs, mean qs)`` (``term_pathwise_factors``) generalizes the rule to a
    curve, whose shapes multiply every step's coefficients: ``μ = r·mr −
    q·mq − ½v²·mv2``, ``∂/∂r = mr·T``, ``∂/∂v = −v·mv2·T + W/v``, … In the
    output's dtype: float32 rounding in the ``W`` recovery, far below the
    Monte-Carlo noise.
    """
    dtype = s_t.dtype
    n = s_t.shape[0]
    c = contracts.to(dtype)
    spot, _, maturity, rate, div_yield, vol = (c[:, i] for i in range(6))
    mv2, mr, mq = term_factors if term_factors is not None else (1.0, 1.0, 1.0)
    mu = rate * mr - div_yield * mq - 0.5 * vol * vol * mv2
    s = s_t.reshape(n, -1)
    w = torch.log(s / spot[:, None]) - (mu * maturity)[:, None]
    gs = g.reshape(n, -1) * s  # the cotangent on log S_T
    total = torch.sum(gs, dim=1)
    d_spot = total / spot
    d_mat = torch.sum(gs * (mu[:, None] + w / (2.0 * maturity[:, None])), dim=1)
    d_rate = mr * maturity * total
    d_div = -mq * maturity * total
    d_vol = torch.sum(gs * ((-vol * mv2 * maturity)[:, None] + w / vol[:, None]), dim=1)
    zero = torch.zeros_like(total)
    return torch.stack([d_spot, zero, d_mat, d_rate, d_div, d_vol], dim=1).to(contracts.dtype)


class TerminalPathwise(torch.autograd.Function):
    """Forward: a TERMINAL log-Euler launch (``launch(params, key_words)``:
    kernel #1 or #2 on a CUDA tensor, their plain twin on a CPU one).
    Backward: ``terminal_pathwise_vjp`` over the forward's own samples, so no
    second launch and no second bit stream; the key words get no gradient."""

    @staticmethod
    def forward(  # type: ignore[override]
        ctx: torch.autograd.function.FunctionCtx,
        params: torch.Tensor,
        key_words: torch.Tensor,
        launch: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        factors: tuple[float, float, float] | None,
    ) -> torch.Tensor:
        out = launch(params.detach(), key_words)
        ctx.save_for_backward(out, params)
        ctx.factors = factors
        return out

    @staticmethod
    def backward(  # type: ignore[override]
        ctx: torch.autograd.function.FunctionCtx, g: torch.Tensor
    ) -> tuple[torch.Tensor, None, None, None]:
        out, params = ctx.saved_tensors
        return terminal_pathwise_vjp(g, out, params, ctx.factors), None, None, None


def simulate_terminal_rows_cuda_diff(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    antithetic_half: int | None = None,
    term: TermStructure | None = None,
) -> torch.Tensor:
    """Differentiable TERMINAL log-Euler values ``[C, rows, cols]`` float32
    on the Philox stream: the forward is kernel #1's TERMINAL branch
    (``simulate_underlier_rows_cuda``), or kernel #2
    (``dynamics_cuda.simulate_term_rows_cuda``) under a curved ``term``, one
    launch for the ``[C, 6]`` batch; the backward is the pathwise rule
    (``TerminalPathwise``) with the curve's effective factors. A CPU tensor
    runs the plain twin forward, a CUDA one the kernel or raises."""
    term = curved(term)
    shape = dict(timesteps=timesteps, rows=rows, cols=cols, antithetic_half=antithetic_half)
    if term is None:
        def launch(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
            return simulate_underlier_rows_cuda(p, k, scheme=PathScheme.LOG_EULER,
                                                payoff=PayoffKind.TERMINAL, **shape)

        factors = None
    else:
        from spectralmc_tpu_torch.ops.dynamics_cuda import simulate_term_rows_cuda

        def launch(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
            return simulate_term_rows_cuda(p, k, term=term, payoff=PayoffKind.TERMINAL, **shape)

        factors = term_pathwise_factors(term, timesteps)
    return TerminalPathwise.apply(params, key_words, launch, factors)
