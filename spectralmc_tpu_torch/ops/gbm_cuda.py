"""The ``"cuda"`` MC engine: terminal GBM rows from a hand-written Hopper kernel.

``csrc/gbm_terminal.cu`` replaces the TERMINAL branch of the JAX package's
``ops/gbm_pallas.py::_gbm_block_kernel`` (both path schemes); its header
states what it keeps, what it drops and what bounds it. This module holds

* ``simulate_terminal_rows_cuda`` — the public wrapper. A CPU tensor goes to
  the plain twin; a CUDA tensor launches the kernel or raises. There is no
  fallback between the two.
* ``simulate_terminal_rows_cuda_plain`` — the twin: the same Philox words
  and the same float32 arithmetic in torch ops. The CPU tests hold it
  against the JAX kernel; the card holds the kernel against it.
* ``cuda_supported`` — the single source of truth for when the engine runs
  (``ops/gbm.py::resolve_implementation`` asks it).
* ``CUDA_STREAM_VERSIONS`` — the stream's version, recorded by the trainer:
  any change to the draw order or arithmetic is a new stream.
* ``LAUNCHES`` — a plain count of kernel launches.

The stream: Philox-4x32-10 keyed by the contract's two threefry key words
(``fold_in(prng_key(mc_seed), draw)``), counter ``(path lo, path hi, call,
0)`` with ``path = base_row·cols + col``. Draw ``j`` (two words) is words
``2(j%2), 2(j%2)+1`` of call ``j // 2``. Log-Euler takes ``T // 2``
pair-step draws and one single-step draw when ``T`` is odd; Euler one draw
per step.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectralmc_tpu_torch.ops.gbm import ModelKind, PathScheme, PayoffKind, SamplingKind
from spectralmc_tpu_torch.ops.rng import MASK32, philox4x32

CUDA_STREAM_VERSIONS: dict[str, int] = {"gbm": 1}

LAUNCHES = 0

_SQRT2 = math.sqrt(2.0)
_SCHEME_CODE = {PathScheme.LOG_EULER: 0, PathScheme.EULER: 1}


def cuda_supported(
    *,
    dtype: torch.dtype,
    model: ModelKind,
    payoff: PayoffKind,
    sampling: SamplingKind,
    term: object = None,
) -> bool:
    """Whether the kernel honors the request: float32 GBM TERMINAL paths on
    the pseudo-random stream with flat market data. Any row/column count."""
    return (
        dtype == torch.float32
        and model == ModelKind.GBM
        and payoff == PayoffKind.TERMINAL
        and sampling == SamplingKind.PSEUDO
        and term is None
    )


def cuda_stream_version(model: ModelKind) -> int:
    return CUDA_STREAM_VERSIONS[model.value]


def draw_count(timesteps: int, scheme: PathScheme) -> int:
    """Two-word draws one path consumes."""
    if scheme == PathScheme.LOG_EULER:
        return timesteps // 2 + timesteps % 2
    return timesteps


def _check(params: torch.Tensor, key_words: torch.Tensor) -> None:
    if params.dtype != torch.float32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    if params.ndim != 2 or params.shape[1] != 6:
        raise ValueError(f"params must be [C, 6], got {tuple(params.shape)}")
    if key_words.ndim != 2 or key_words.shape != (params.shape[0], 2):
        raise ValueError(f"key_words must be [C, 2], got {tuple(key_words.shape)}")
    if key_words.device != params.device:
        raise ValueError(f"params on {params.device}, key_words on {key_words.device}")


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
    """The kernel's plain twin: ``[C, rows, cols]`` float32 terminal values.

    ``params`` is ``[C, 6]`` float32, ``key_words`` ``[C, 2]`` uint32 words
    (any integer dtype). ``words`` (tests only) replaces the generator: a
    tensor broadcastable to ``[C, rows, cols, calls, 4]`` of uint32 words.
    Transcendentals run as torch ops; ``sin(π·x)`` is evaluated in float64
    (of the same float32 argument) and rounded, standing in for the kernel's
    ``sinpif``/``cospif``.
    """
    _check(params, key_words)
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
    calls = -(-draw_count(timesteps, scheme) // 2)
    if words is not None:
        words = torch.broadcast_to(
            words.to(torch.int64).to(device), (n_contracts, rows, cols, calls, 4)
        )

    def call_words(i: int) -> tuple[torch.Tensor, ...]:
        if words is not None:
            return tuple(words[..., i, k] for k in range(4))
        return philox4x32((c0, c1, zero + i, zero), (k0, k1))

    p = params
    spot, maturity, rate, div, vol = (p[:, i, None, None] for i in (0, 2, 3, 4, 5))
    dt = maturity / float(timesteps)
    vol_sdt = vol * torch.sqrt(dt)
    carry = rate - div

    def draw(j: int, w: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = (w[0], w[1]) if j % 2 == 0 else (w[2], w[3])
        u1 = (a >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25
        u2 = (b >> 8).to(torch.float32) * 2.0**-24
        return torch.sqrt(-2.0 * torch.log(u1)), u2

    def sinpi(x: torch.Tensor) -> torch.Tensor:
        return torch.sin(math.pi * x.to(torch.float64)).to(torch.float32)

    def cospi(x: torch.Tensor) -> torch.Tensor:
        return torch.cos(math.pi * x.to(torch.float64)).to(torch.float32)

    w: tuple[torch.Tensor, ...] = ()
    if scheme == PathScheme.LOG_EULER:
        drift = (carry - 0.5 * vol * vol) * dt
        two_drift = 2.0 * drift
        pairs = timesteps // 2
        logx = torch.log(spot).expand(n_contracts, rows, cols)
        for j in range(draw_count(timesteps, scheme)):
            if j % 2 == 0:
                w = call_words(j // 2)
            rad, u2 = draw(j, w)
            if j < pairs:
                z = sign * (rad * _SQRT2 * sinpi(2.0 * u2 + 0.25))
                logx = (logx + two_drift) + vol_sdt * z
            else:
                z = sign * (rad * cospi(2.0 * u2))
                logx = (logx + drift) + vol_sdt * z
        return torch.exp(logx)
    growth = 1.0 + carry * dt
    x = spot.expand(n_contracts, rows, cols)
    for j in range(timesteps):
        if j % 2 == 0:
            w = call_words(j // 2)
        rad, u2 = draw(j, w)
        z = sign * (rad * cospi(2.0 * u2))
        x = torch.abs(x * (growth + vol_sdt * z))
    return x


def _kernel() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library("gbm_terminal", ("gbm_terminal.cu",)).lib
    fn = lib.gbm_terminal_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def simulate_terminal_rows_cuda(
    params: torch.Tensor,
    key_words: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    scheme: PathScheme,
    antithetic_half: int | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Terminal values ``[C, rows, cols]`` float32 on the Philox stream.

    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream (one launch for the whole contract batch). Any other
    device, dtype or shape raises.
    """
    global LAUNCHES
    _check(params, key_words)
    kwargs = dict(
        timesteps=timesteps, rows=rows, cols=cols, scheme=scheme,
        antithetic_half=antithetic_half, row_offset=row_offset,
    )
    if params.device.type == "cpu":
        return simulate_terminal_rows_cuda_plain(params, key_words, **kwargs)
    if params.device.type != "cuda":
        raise ValueError(f"the cuda engine runs on cpu (plain twin) or cuda, not {params.device}")
    if timesteps <= 0 or rows <= 0 or cols <= 0:
        raise ValueError(f"need positive timesteps/rows/cols, got {timesteps}/{rows}/{cols}")
    if params.shape[0] > 65535:
        raise ValueError(f"at most 65535 contracts per launch, got {params.shape[0]}")
    params = params.contiguous()
    words = (key_words.to(torch.int64) & MASK32)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32).contiguous()
    out = torch.empty((params.shape[0], rows, cols), dtype=torch.float32, device=params.device)
    status = _kernel().gbm_terminal_launch(
        params.data_ptr(), words.data_ptr(), out.data_ptr(), params.shape[0], rows, cols,
        timesteps, _SCHEME_CODE[scheme], antithetic_half or 0, row_offset,
        torch.cuda.current_stream(params.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"gbm_terminal_launch failed: cudaError {status}")
    LAUNCHES += 1
    return out
