"""The ``"cuda"`` MC engine for baskets: ``A`` correlated log-Euler assets in one kernel.

``csrc/basket_paths.cu`` replaces the JAX package's
``ops/gbm_pallas.py::_basket_block_kernel``; its header states what it keeps
and drops. This module holds

* the public wrapper ``simulate_basket_rows_cuda``: a CPU tensor goes to the
  plain twin; a CUDA tensor launches the kernel or raises. There is no
  fallback between the two, nor to the threefry engine:
  ``ops/gbm.py::resolve_implementation`` decides the engine before a run.
* the plain twin ``simulate_basket_rows_cuda_plain``: the same Philox words
  and the same float32 arithmetic in torch ops, with the ``words=`` hook of
  ``ops/gbm_cuda.py``'s twins.
* ``barrier_factor``: the knock level's host factor, computed in float64
  exactly as the TPU kernel does and rounded once to float32.

The stream ``basket_gbm`` v2 (``gbm_cuda.CUDA_STREAM_VERSIONS``; v1 took the
same words through libm's Box–Muller, v2 through the SFU's: its normals
differ by a few ulps, within the twin's rtol 2e-5): Philox-4x32-10
keyed by the contract's two threefry words, counter ``(path lo, path hi,
call, 0)``. Each step takes ``P = ⌈A/2⌉`` draws, draw ``j = t·P + p`` being
words ``2(j%2), 2(j%2)+1`` of call ``j // 2``: assets ``2p`` and ``2p + 1``
take ``r·cos θ`` and ``r·sin θ`` of draw ``p`` (a 3-asset step is one
Philox call). Antithetic rows flip every asset's normal. The digital
transforms the TERMINAL draw; the geometric forward start runs TERMINAL at
the tail length with maturity scaled by ``(N − m)/N``; the arithmetic forward
start captures ``B_m`` in a branch of its own. The variance swap forms each
step's ``ln B_t − ln B_{t−1}`` as ``Σ wᵢ·Δlog xᵢ`` (geometric) or
``ln(B_t / B_{t−1})`` (arithmetic), not as a difference of two values near
``ln S``. Cliquets and curved baskets run the threefry engine.

Launch counts go to ``gbm_cuda.LAUNCHES`` and ``LAUNCHES_BY_BRANCH`` under
``basket_<branch>``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from spectralmc_tpu_torch.ops.basket import BasketCombine, BasketSpec, basket_cholesky
from spectralmc_tpu_torch.ops.gbm import (
    LOOKBACK_MAX_PAYOFFS,
    PayoffKind,
    lookback_underlier,
)
from spectralmc_tpu_torch.ops.gbm_cuda import (
    MAX_BASKET_ASSETS,
    _FAMILY_CODE,
    _LOOKBACK_VARIANT,
    _check,
    _cospi,
    _count,
    _device_args,
    _pair_draws,
    _route_out,
    _sinpi,
    _stream,
    _tail_params,
    branch_of,
    uniform_closed,
    uniform_open,
)
from spectralmc_tpu_torch.ops.rng import MASK32

_FORWARD = 5  # csrc/basket_paths.cu's kForward: the arithmetic forward start's capture


def basket_branch(payoff: PayoffKind, spec: BasketSpec) -> str:
    """The kernel branch a payoff runs on a basket: the digital and the
    geometric forward start route through TERMINAL, the arithmetic forward
    start captures ``B_m`` in ``forward``."""
    if payoff == PayoffKind.FORWARD_START and spec.combine == BasketCombine.ARITHMETIC:
        return "forward"
    branch = branch_of(payoff)
    if branch == "cliquet":
        raise ValueError("basket cliquets run the threefry engine's scan")
    return branch


def barrier_factor(spec: BasketSpec, barrier_rel: float) -> float:
    """The knock level over spot, in float64 as ``_basket_block_kernel`` does
    (the initial basket value per unit spot, times ``barrier_rel``), rounded
    once to float32; the level is ``spot·factor`` in float32."""
    if spec.combine == BasketCombine.GEOMETRIC:
        g0 = sum(w * math.log(m) for w, m in zip(spec.weights, spec.spot_multipliers))
        return float(np.float32(math.exp(g0) * barrier_rel))
    g0 = sum(w * m for w, m in zip(spec.weights, spec.spot_multipliers))
    return float(np.float32(g0 * barrier_rel))


def _route(
    payoff: PayoffKind, spec: BasketSpec, params: torch.Tensor, timesteps: int,
    forward_start_step: int | None, barrier_rel: float | None,
) -> tuple[str, torch.Tensor, int]:
    """``(branch, params, timesteps)`` the kernel runs for ``payoff``."""
    branch = basket_branch(payoff, spec)
    if branch == "barrier" and barrier_rel is None:
        raise ValueError(f"payoff={payoff.value!r} needs barrier_rel")
    if payoff == PayoffKind.FORWARD_START:
        if forward_start_step is None or not 1 <= forward_start_step < timesteps:
            raise ValueError(f"forward start needs 1 <= forward_start_step < {timesteps}")
        if branch == "terminal":  # the geometric combine: the tail ratio is an effective GBM
            return branch, _tail_params(params, timesteps, forward_start_step), (
                timesteps - forward_start_step)
    return branch, params, timesteps


def _variant(branch: str, payoff: PayoffKind) -> int:
    if branch == "barrier":
        return int(payoff == PayoffKind.BARRIER_UP_OUT)
    if branch == "lookback":
        return _LOOKBACK_VARIANT[payoff]
    return int(payoff == PayoffKind.ASIAN_GEOMETRIC)


def _check_spec(spec: BasketSpec) -> None:
    if not 1 <= spec.n_assets <= MAX_BASKET_ASSETS:
        raise ValueError(
            f"the basket kernel takes 1..{MAX_BASKET_ASSETS} assets, got {spec.n_assets}")


def simulate_basket_rows_cuda_plain(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    spec: BasketSpec,
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
    """The basket kernel's plain twin: ``[C, rows, cols]`` float32 underliers
    of any non-American, non-cliquet payoff on the flat log-Euler basket.
    ``params`` is ``[C, 6]`` float32; ``words`` (tests only) replaces the
    generator as in ``gbm_cuda.simulate_terminal_rows_cuda_plain``."""
    _check(params, key_words)
    _check_spec(spec)
    branch, p, steps = _route(payoff, spec, params, timesteps, forward_start_step, barrier_rel)
    a_n = spec.n_assets
    per_step = (a_n + 1) // 2
    sign, call = _stream(
        p, key_words, rows=rows, cols=cols, calls=-(-steps * per_step // 2),
        antithetic_half=antithetic_half, row_offset=row_offset, words=words,
    )
    uniforms = _pair_draws(call)
    spot, strike, maturity, rate, div, vol = (p[:, i, None, None] for i in range(6))
    dt = maturity / float(steps)
    sqrt_dt = torch.sqrt(dt)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    sig_sdt = [vol * f32(m) * sqrt_dt for m in spec.vol_multipliers]
    drift = [(rate - div - 0.5 * (vol * f32(m)) ** 2) * dt for m in spec.vol_multipliers]
    chol = basket_cholesky(spec)
    weights = [f32(w) for w in spec.weights]
    geometric = spec.combine == BasketCombine.GEOMETRIC

    def value(logx: list[torch.Tensor]) -> torch.Tensor:
        if geometric:
            acc = weights[0] * logx[0]
            for a in range(1, a_n):
                acc = acc + weights[a] * logx[a]
            return torch.exp(acc)
        acc = weights[0] * torch.exp(logx[0])
        for a in range(1, a_n):
            acc = acc + weights[a] * torch.exp(logx[a])
        return acc

    j = 0
    step_inc: list[torch.Tensor] = []  # the last step's per-asset log-increments

    def advance(logx: list[torch.Tensor]) -> list[torch.Tensor]:
        nonlocal j
        z: list[torch.Tensor] = []
        for _ in range(per_step):
            u1, u2 = uniforms(j)
            j += 1
            rad = torch.sqrt(-2.0 * torch.log(u1))
            z.append(sign * (rad * _cospi(2.0 * u2)))
            if len(z) < a_n:
                z.append(sign * (rad * _sinpi(2.0 * u2)))
        out = []
        step_inc.clear()
        for a in range(a_n):
            zm = f32(chol[a][0]) * z[0]
            for b in range(1, a + 1):
                zm = zm + f32(chol[a][b]) * z[b]
            step_inc.append(drift[a] + sig_sdt[a] * zm)
            out.append((logx[a] + drift[a]) + sig_sdt[a] * zm)
        return out

    shape = (p.shape[0], rows, cols)
    logx = [torch.log(spot * f32(m)).expand(shape) for m in spec.spot_multipliers]
    if branch == "forward":
        b0 = value(logx)
        cap = b0
        for t in range(steps):
            logx = advance(logx)
            if t == forward_start_step - 1:
                cap = value(logx)
        return b0 * value(logx) / cap
    if branch == "variance":
        # each step's ln B_t − ln B_{t−1} as the kernel forms it: Σ wᵢ·Δlog xᵢ
        # (geometric) or ln(B_t / B_{t−1}) (arithmetic)
        prev = value(logx)
        acc = torch.zeros(shape, dtype=torch.float32, device=p.device)
        for _ in range(steps):
            logx = advance(logx)
            if geometric:
                inc = weights[0] * step_inc[0]
                for a in range(1, a_n):
                    inc = inc + weights[a] * step_inc[a]
            else:
                v = value(logx)
                inc, prev = torch.log(v / prev), v
            acc = acc + inc * inc
        return acc / maturity
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    extreme = branch in ("barrier", "lookback")
    acc = value(logx) if extreme else torch.zeros(shape, dtype=torch.float32, device=p.device)
    for _ in range(steps):
        logx = advance(logx)
        if extreme:
            acc = torch.maximum(acc, value(logx)) if up else torch.minimum(acc, value(logx))
        elif branch == "asian":
            v = value(logx)
            acc = acc + (torch.log(v) if payoff == PayoffKind.ASIAN_GEOMETRIC else v)
    if branch == "terminal":
        return _route_out(payoff, value(logx), p)
    if branch == "asian":
        mean = acc * float(1.0 / steps)
        return torch.exp(mean) if payoff == PayoffKind.ASIAN_GEOMETRIC else mean
    if branch == "barrier":
        level = spot * f32(barrier_factor(spec, barrier_rel))
        knocked = acc >= level if up else acc <= level
        return torch.where(knocked, strike, value(logx))
    return lookback_underlier(payoff, strike, acc, value(logx))


# ops/_build.py::load_library's arguments for this module's kernel
LIBRARY = ("basket_paths", ("basket_paths.cu",))


def _library() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*LIBRARY).lib
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.basket_paths_launch.argtypes = [vp, vp, vp, vp, i, ll, ll, i, i, i, i, i, f, i, ll, ll,
                                        vp]
    lib.basket_paths_launch.restype = ctypes.c_int
    lib.box_muller_sfu_launch.argtypes = [vp, vp, ll, vp]
    lib.box_muller_sfu_launch.restype = ctypes.c_int
    return lib


def box_muller_normals(words: torch.Tensor) -> torch.Tensor:
    """The basket kernels' Box–Muller on its own (the card tests hold it to
    the twins' arithmetic): words ``[n, 2]`` (u1's, u2's; int32 or int64)
    to float32 normals ``[n, 2]``, ``(r·cos 2πu2, r·sin 2πu2)``. A CPU tensor
    takes the twins' torch math, a CUDA tensor the SFU transform of
    ``csrc/path_stream.cuh`` (not a path kernel: no launch count)."""
    if words.dim() != 2 or words.shape[1] != 2:
        raise ValueError(f"words must be [n, 2], got {tuple(words.shape)}")
    if words.device.type == "cpu":
        w = words.to(torch.int64) & MASK32
        u1, u2 = uniform_open(w[:, 0]), uniform_closed(w[:, 1])
        rad = torch.sqrt(-2.0 * torch.log(u1))
        return torch.stack([rad * _cospi(2.0 * u2), rad * _sinpi(2.0 * u2)], dim=1)
    w = words.to(torch.int64) & MASK32
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()
    out = torch.empty((w.shape[0], 2), dtype=torch.float32, device=w.device)
    status = _library().box_muller_sfu_launch(
        w.data_ptr(), out.data_ptr(), w.shape[0], torch.cuda.current_stream(w.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"box_muller_sfu_launch failed: cudaError {status}")
    return out


def spec_table(spec: BasketSpec) -> np.ndarray:
    """The kernel's static spec as host float32 ``[3·8 + 8·8]``, the layout
    of ``csrc/basket_paths.cu``'s by-value ``BasketArgs``: weights, spot
    multipliers, vol multipliers (each padded to 8), then the lower Cholesky
    rows (``[8, 8]``, zero above the diagonal and past the asset count)."""
    a_n = spec.n_assets
    n = MAX_BASKET_ASSETS
    table = np.zeros(3 * n + n * n, dtype=np.float32)
    for k, values in enumerate((spec.weights, spec.spot_multipliers, spec.vol_multipliers)):
        table[k * n:k * n + a_n] = values
    chol = np.zeros((n, n), dtype=np.float64)
    chol[:a_n, :a_n] = basket_cholesky(spec)
    table[3 * n:] = chol.astype(np.float32).reshape(-1)
    return table


def simulate_basket_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    forward_start_step: int | None = None,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Basket underliers ``[C, rows, cols]`` float32 on the Philox stream
    ``basket_gbm``: CPU tensors run the plain twin, CUDA tensors launch the
    basket kernel (one launch for the whole contract batch) or raise."""
    _check(params, key_words)
    if params.device.type == "cpu":
        return simulate_basket_rows_cuda_plain(
            params, key_words, spec=spec, timesteps=timesteps, rows=rows, cols=cols,
            payoff=payoff, barrier_rel=barrier_rel, forward_start_step=forward_start_step,
            antithetic_half=antithetic_half, row_offset=row_offset,
        )
    _check_spec(spec)
    branch, p, steps = _route(payoff, spec, params, timesteps, forward_start_step, barrier_rel)
    p, words, out = _device_args(p, key_words, steps, rows, cols)
    table = spec_table(spec)  # host memory: the kernel takes it by value
    family = _FORWARD if branch == "forward" else _FAMILY_CODE[branch]
    status = _library().basket_paths_launch(
        p.data_ptr(), words.data_ptr(), table.ctypes.data, out.data_ptr(), p.shape[0], rows,
        cols, steps, spec.n_assets, family, _variant(branch, payoff),
        int(spec.combine == BasketCombine.GEOMETRIC),
        barrier_factor(spec, barrier_rel) if branch == "barrier" else 1.0,
        forward_start_step or 0, antithetic_half or 0, row_offset,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"basket_paths_launch failed: cudaError {status}")
    _count(f"basket_{branch}")
    return _route_out(payoff, out, p)


__all__ = [
    "barrier_factor",
    "basket_branch",
    "box_muller_normals",
    "simulate_basket_rows_cuda",
    "simulate_basket_rows_cuda_plain",
    "spec_table",
]
