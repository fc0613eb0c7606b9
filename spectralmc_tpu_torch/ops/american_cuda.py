"""The ``"cuda"`` engine's American (LSMC) kernels: monitor-row GBM and the backward.

``csrc/american_paths.cu`` replaces three kernels of the JAX package:
``ops/gbm_pallas.py::_gbm_monitor_block_kernel`` (the monitor-row forward)
and ``ops/lsmc_pallas.py::_fused_backward_kernel`` and
``_streamed_backward_kernel`` (one CUDA backward serves both); its header
states what it keeps, what it drops and what bounds it. This module holds

* the public wrappers ``simulate_american_rows_cuda`` (``[C, n_monitor,
  rows, cols]`` price rows) and ``lsmc_backward_cuda`` (``[C, rows, cols]``
  synthetic underliers ``u = K − cf/df``): a CPU tensor goes to the plain
  twin, a CUDA tensor launches the kernel or raises. There is no fallback.
* the plain twins ``simulate_american_rows_cuda_plain`` (the same Philox
  words and float32 arithmetic in torch ops; ``words=0`` replays the TPU
  interpreter's zero bits) and ``lsmc_backward_cuda_plain`` (the same lagged
  schedule and the same reduction order: per thread 16 paths in order, a
  halving tree over the 256 threads of a block, the blocks' partials summed
  per thread in order and folded by the same tree, and the solve of
  ``ops/american.py::_ridge_chol_solve``), so its β and every exercise
  decision equal the kernel's bit for bit.
* ``simulate_american_underlier_rows_cuda`` — the engine's American
  simulator: the forward kernel, then ``monitor_underliers``: the CUDA
  backward or the torch estimator
  (``ops/american.py::encode_monitor_prices``), as ``cuda_backward_version``
  decides. The engine runs the CUDA backward wherever it computes the
  estimator asked for; cross-fit and curved terms take the torch one.
* ``LSMC_BACKWARD_VERSIONS``, ``cuda_backward_version`` and
  ``resolve_lsmc_backward`` — which backward ran is checkpoint state: its
  reduction order decides near-boundary exercise bits. 0 is the torch
  estimator; the CUDA backward's value collides with neither of the JAX
  package's kernels (1 fused, 2 streamed), which the port cannot run.

Launch counts go to ``gbm_cuda.LAUNCHES`` and ``LAUNCHES_BY_BRANCH``:
``american_gbm`` per forward launch, and per backward (its ``n_monitor``
sweeps and ``n_monitor − 1`` solves) ``lsmc_backward`` at up to 2^20 paths a
contract, ``lsmc_backward_streamed`` past that: the shapes of the JAX
package's two kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectralmc_tpu_torch.ops.american import OptionSide, _ridge_chol_solve, check_monitor_grid
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    ModelKind,
    SimImplementation,
    SimulationParams,
    curved,
    resolve_implementation,
)
from spectralmc_tpu_torch.ops.gbm_cuda import (
    MAX_MONITOR_DATES,
    _check,
    _count,
    _cospi,
    _device_args,
    _pair_draws,
    _sinpi,
    _stream,
)

LSMC_BACKWARD_VERSIONS: dict[str, int] = {"cuda": 3}
FUSED_MAX_PATHS = 1 << 20  # the JAX fused kernel's VMEM cap: the launch-count split
THREADS = 256  # csrc/american_paths.cu's kThreads
PER_THREAD = 16  # its kPerThread
BLOCK_PATHS = THREADS * PER_THREAD

_SQRT2 = math.sqrt(2.0)


def cuda_backward_version(
    *, dtype: torch.dtype, n_monitor: int, cross_fit: bool = False, term: bool = False
) -> int:
    """The backward the ``"cuda"`` engine runs on its monitor rows:
    ``LSMC_BACKWARD_VERSIONS["cuda"]`` where the CUDA backward computes the
    estimator asked for — the classic single recursion on one state
    variable with flat discounting (no cross-fitted pair, no curved term),
    float32, at least 2 monitor dates; any path count, basis degree 1–8, put
    or call — else 0, the torch estimator."""
    if dtype == torch.float32 and n_monitor >= 2 and not cross_fit and not term:
        return LSMC_BACKWARD_VERSIONS["cuda"]
    return 0


def resolve_lsmc_backward(sim: SimulationParams, *, rows: int) -> int:
    """The LSMC backward version that will ACTUALLY run for this sim — 0 =
    the torch estimator, ``LSMC_BACKWARD_VERSIONS["cuda"]`` = the CUDA
    backward — for the engine's simulator (``ops/dispatch.py``) and the
    trainer's recorded ``lsmc_backward_version``: ``cuda_backward_version``
    wherever the ``"cuda"`` engine runs a GBM American forward
    (``resolve_implementation``). ``lsmc_fused_backward`` is the JAX
    package's request for its TPU kernels; the config gates hold it to the
    JAX package's rules, and it routes nothing here."""
    if sim.payoff not in AMERICAN_PAYOFFS or sim.model != ModelKind.GBM or rows <= 0:
        return 0
    if resolve_implementation(sim) != SimImplementation.CUDA:
        return 0
    return cuda_backward_version(
        dtype=sim.precision.to_torch(),
        n_monitor=sim.timesteps // sim.lsmc_exercise_every,
        cross_fit=sim.lsmc_cross_fit,
        term=curved(sim.term) is not None,
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
    numbered on across segments. ``words`` (tests only) replaces the
    generator: a tensor broadcastable to ``[C, rows, cols, calls, 4]``."""
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


def _blocked(t: torch.Tensor, blocks: int, fill: torch.Tensor) -> torch.Tensor:
    """``[C, N]`` → ``[C, blocks, PER_THREAD, THREADS]`` in the kernel's path
    order (block b, step k, thread t holds path b·4096 + k·256 + t), the
    ragged tail filled with ``fill`` (``[C, 1]``), whose moments are zero."""
    c, n = t.shape
    pad = blocks * BLOCK_PATHS - n
    if pad:
        t = torch.cat([t, fill.expand(c, pad)], dim=1)
    return t.reshape(c, blocks, PER_THREAD, THREADS)


def _tree_fold(v: torch.Tensor) -> torch.Tensor:
    """The kernels' halving tree over the last dim (256 → 1): at each stride
    s, element t < s becomes ``v[t] + v[t + s]``."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def lsmc_backward_cuda_plain(
    price_rows: torch.Tensor,
    *,
    strike: torch.Tensor,
    disc: torch.Tensor,
    df: torch.Tensor,
    put: bool,
    basis_degree: int,
) -> torch.Tensor:
    """The CUDA backward's plain twin: ``[C, rows, cols]`` underliers
    ``u = K − disc·cf/df`` from ``[C, n_monitor, rows, cols]`` float32 price
    rows, with ``strike``, ``disc`` (one monitor step) and ``df`` (to t = 0)
    ``[C]`` float32. Same lagged schedule and reduction order as the kernel
    (module docstring)."""
    _check_backward(price_rows, strike, disc, df, basis_degree)
    n_contracts, monitors, rows, cols = price_rows.shape
    n = rows * cols
    blocks = -(-n // BLOCK_PATHS)
    k = basis_degree + 1
    n_prod = 2 * basis_degree + 1
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=price_rows.device)
    strike_c = strike[:, None]
    kb = strike[:, None, None, None]
    disc_b = disc[:, None, None, None]
    flat = price_rows.reshape(n_contracts, monitors, n)

    def row(m: int) -> torch.Tensor:
        return _blocked(flat[:, m], blocks, strike_c)  # a strike-valued path is out of the money

    def immediate(s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(kb - s, min=0.0) if put else torch.clamp(s - kb, min=0.0)

    def moneyness(s: torch.Tensor) -> torch.Tensor:
        return (s / kb - 1.0) * 5.0

    def moments(s1: torch.Tensor, cf: torch.Tensor) -> list[torch.Tensor]:
        """Per-contract moments of a date from its row and the carrier: each
        thread's 16 paths in order, the block tree, then the solve's sums."""
        itm = (immediate(s1) > 0.0).to(torch.float32)
        wy = itm * (disc_b * cf)
        x1 = moneyness(s1)

        def block_sum(v: torch.Tensor) -> torch.Tensor:  # [C, blocks]
            acc = torch.zeros_like(v[:, :, 0])
            for step in range(PER_THREAD):
                acc = acc + v[:, :, step]
            return _tree_fold(acc)

        gram, rhs = [], []
        pw = torch.ones_like(x1)  # the kernel's running product 1, x, x·x, …
        for a in range(n_prod):
            gram.append(block_sum(itm * pw))
            if a < k:
                rhs.append(block_sum(wy * pw))
            if a + 1 < n_prod:
                pw = pw * x1
        part = torch.stack(gram + rhs, dim=-1)  # [C, blocks, M]
        spare = -blocks % THREADS
        if spare:
            part = torch.cat([part, part.new_zeros(n_contracts, spare, part.shape[-1])], dim=1)
        part = part.reshape(n_contracts, -1, THREADS, part.shape[-1])
        acc = torch.zeros_like(part[:, 0])
        for i in range(part.shape[1]):
            acc = acc + part[:, i]
        total = _tree_fold(acc.transpose(1, 2))  # [C, M]
        return [total[:, a] * inv_n for a in range(n_prod + k)]

    def solve(m: list[torch.Tensor]) -> list[torch.Tensor]:
        gram = [[m[i + j] for j in range(k)] for i in range(k)]
        return _ridge_chol_solve(gram, m[n_prod:], dtype=torch.float32)

    cf = immediate(row(monitors - 1))
    mom = moments(row(monitors - 2), cf)
    for policy in range(monitors - 2, -1, -1):
        beta = [b[:, None, None, None] for b in solve(mom)]
        s = row(policy)
        ex = immediate(s)
        y = disc_b * cf
        x = moneyness(s)
        cont = beta[basis_degree]
        for j in range(basis_degree - 1, -1, -1):
            cont = cont * x + beta[j]
        cf = torch.where((ex > 0.0) & (ex > cont), ex, y)
        if policy:
            mom = moments(row(policy - 1), cf)
    u = kb - (disc_b * cf) / df[:, None, None, None]
    return u.reshape(n_contracts, -1)[:, :n].reshape(n_contracts, rows, cols)


def _check_backward(price_rows: torch.Tensor, strike: torch.Tensor, disc: torch.Tensor,
                    df: torch.Tensor, basis_degree: int) -> None:
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


# --------------------------------------------------------------------------
# The kernels and their wrappers
# --------------------------------------------------------------------------


# ops/_build.py::load_library's arguments for this module's kernels
LIBRARY = ("american_paths", ("american_paths.cu",), ("path_stream.cuh",))


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
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.american_gbm_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, ll, ll, vp]
    lib.lsmc_backward_launch.argtypes = [vp, vp, vp, vp, vp, i, ll, i, i, i, f, vp]
    lib.american_gbm_launch.restype = ctypes.c_int
    lib.lsmc_backward_launch.restype = ctypes.c_int
    return lib


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
    the Philox stream (``american_gbm`` v1): CPU tensors run the plain twin,
    CUDA tensors launch the monitor-row kernel (one launch per contract
    batch) or raise."""
    _check(params, key_words)
    kwargs = dict(timesteps=timesteps, rows=rows, cols=cols, exercise_every=exercise_every,
                  antithetic_half=antithetic_half, row_offset=row_offset)
    if params.device.type == "cpu":
        return simulate_american_rows_cuda_plain(params, key_words, **kwargs)
    check_monitor_grid(timesteps, exercise_every)
    monitors = timesteps // exercise_every
    if monitors > MAX_MONITOR_DATES:
        raise ValueError(f"at most {MAX_MONITOR_DATES} monitor dates, got {monitors}")
    if rows <= 0 or cols <= 0:
        raise ValueError(f"need positive rows/cols, got {rows}/{cols}")
    p, words, _ = _device_args(params, key_words, timesteps, 1, 1)  # checked inputs
    out = _written_in_full(p.shape[0], monitors, rows, cols, device=p.device)
    status = _kernel().american_gbm_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, timesteps,
        exercise_every, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"american_gbm_launch failed: cudaError {status}")
    _count("american_gbm")
    return out


def lsmc_backward_cuda(
    price_rows: torch.Tensor,
    *,
    strike: torch.Tensor,
    disc: torch.Tensor,
    df: torch.Tensor,
    put: bool,
    basis_degree: int,
) -> torch.Tensor:
    """Synthetic American underliers ``[C, rows, cols]`` (``u = K −
    disc·cf/df``) from ``[C, n_monitor, rows, cols]`` float32 price rows by
    the classic Longstaff–Schwartz estimator: CPU tensors run the plain
    twin, CUDA tensors the CUDA backward (one sweep launch per monitor date
    and one solve launch between two) or raise."""
    _check_backward(price_rows, strike, disc, df, basis_degree)
    kwargs = dict(strike=strike, disc=disc, df=df, put=put, basis_degree=basis_degree)
    if price_rows.device.type == "cpu":
        return lsmc_backward_cuda_plain(price_rows, **kwargs)
    if price_rows.device.type != "cuda":
        raise ValueError(f"the cuda engine runs on cpu (plain twin) or cuda, not "
                         f"{price_rows.device}")
    n_contracts, monitors, rows, cols = price_rows.shape
    if n_contracts > 65535:
        raise ValueError(f"at most 65535 contracts per launch, got {n_contracts}")
    n = rows * cols
    blocks = -(-n // BLOCK_PATHS)
    rows_c = price_rows.contiguous()
    scal = torch.stack([strike, disc, df], dim=1).contiguous()
    out = _written_in_full(n_contracts, rows, cols, device=rows_c.device)
    beta = _written_in_full(n_contracts, basis_degree + 1, device=rows_c.device)
    partials = _written_in_full(n_contracts, blocks, 3 * basis_degree + 2, device=rows_c.device)
    status = _kernel().lsmc_backward_launch(
        rows_c.data_ptr(), out.data_ptr(), beta.data_ptr(), scal.data_ptr(), partials.data_ptr(),
        n_contracts, n, monitors, basis_degree, int(put), float(1.0 / n),
        torch.cuda.current_stream(rows_c.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"lsmc_backward_launch failed: cudaError {status}")
    _count("lsmc_backward" if n <= FUSED_MAX_PATHS else "lsmc_backward_streamed")
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
    cross_fit: bool = False,
    backward: int = 0,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers ``u = K − cf/df``
    from the monitor-row kernel's ``[C, n_monitor, rows, cols]`` rows by
    ``backward``: ``LSMC_BACKWARD_VERSIONS["cuda"]`` runs the CUDA backward,
    0 the torch estimator (which also takes ``cross_fit``). Callers pass
    ``cuda_backward_version``'s value; nothing here re-routes."""
    from spectralmc_tpu_torch.ops.american import encode_monitor_prices

    disc, df = monitor_discounts(params, timesteps=timesteps, exercise_every=exercise_every)
    put = option == OptionSide.PUT
    if backward == LSMC_BACKWARD_VERSIONS["cuda"]:
        if cross_fit:
            raise ValueError("the CUDA backward runs the classic estimator; cross-fit runs "
                             "the torch estimator (backward 0)")
        return lsmc_backward_cuda(price_rows, strike=params[:, 1].contiguous(), disc=disc,
                                  df=df, put=put, basis_degree=basis_degree)
    if backward != 0:
        raise ValueError(f"unknown LSMC backward version {backward}")
    return encode_monitor_prices(
        price_rows, strike=params[:, 1], maturity=params[:, 2], rate=params[:, 3],
        disc_monitor=disc, dtype=torch.float32, put=put, basis_degree=basis_degree,
        cross_fit=cross_fit,
    )


def simulate_american_underlier_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    antithetic_half: int | None = None,
    row_offset: int = 0,
    cross_fit: bool = False,
    backward: int = 0,
) -> torch.Tensor:
    """``[C, rows, cols]`` synthetic American underliers on the ``"cuda"``
    engine: the monitor-row kernel's rows, then ``monitor_underliers``."""
    price_rows = simulate_american_rows_cuda(
        params, key_words, timesteps=timesteps, rows=rows, cols=cols,
        exercise_every=exercise_every, antithetic_half=antithetic_half, row_offset=row_offset,
    )
    return monitor_underliers(
        price_rows, params, timesteps=timesteps, exercise_every=exercise_every, option=option,
        basis_degree=basis_degree, cross_fit=cross_fit, backward=backward,
    )


__all__ = [
    "LSMC_BACKWARD_VERSIONS",
    "cuda_backward_version",
    "lsmc_backward_cuda",
    "lsmc_backward_cuda_plain",
    "monitor_discounts",
    "monitor_underliers",
    "resolve_lsmc_backward",
    "simulate_american_rows_cuda",
    "simulate_american_rows_cuda_plain",
    "simulate_american_underlier_rows_cuda",
]
