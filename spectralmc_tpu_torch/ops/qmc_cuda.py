"""The QMC generator's kernels: Sobol → normals → Brownian bridge, and the fused walk.

``csrc/qmc_paths.cu`` replaces two kernels of the JAX package's
``ops/qmc_pallas.py``: ``_bridge_block_kernel`` (#13: scrambled Sobol words
→ ``√2·erf⁻¹(2u−1)`` with the top-bucket guard → the ``[T, T]`` bridge
product per factor, written ``[C, T, F, count]``) and ``_walk_block_kernel``
(#14: the same generation for one factor, then the flat log-Euler walk and
``Σ_t log S_t``, one float per path). Its header states what each keeps,
drops and is bound by. This module holds, for each,

* the public wrapper (``bridge_normals``, ``walk_acc``): a CPU tensor goes to
  the plain twin; a CUDA tensor launches the kernel, for any step count,
  factor count and padding, or raises. There is no fallback. Each launches
  its kernel's sparse instantiation where ``sparse_walk`` holds (T = 8, 16,
  32 or 64 and the float32 bridge's zeros exactly the pattern the kernel
  compiles, ``bridge_pattern``), its dense one elsewhere; both are the
  twin's values bit for bit. ``walk_acc`` is differentiable in its three
  per-contract scalars (``WalkAcc``: the walk sum's affine rule, its ``B``
  from a second launch at ``(0, 0, 1)``); ``walk_acc_launch`` is the bare
  launch. The bridge's normals need no gradient: they are free of the
  contract.
* the plain twin (``bridge_normals_plain``, ``walk_acc_plain``): the same
  words (the defining XOR over ``gray(n)``), the same float32 inverse CDF
  (``qmc._inv_cdf``) and the bridge product accumulated level by level with
  one rounding per multiply-add (``rng.fma32_exact``), as the kernel does.
  The walk's twin is the bridge twin plus the torch scan of ``ops/gbm.py``.

Launch counts go to ``gbm_cuda.LAUNCHES`` and ``LAUNCHES_BY_BRANCH`` under
``qmc_bridge`` and ``qmc_walk``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops._sobol_directions import MAX_DIMENSION
from spectralmc_tpu_torch.ops.gbm_cuda import _count
from spectralmc_tpu_torch.ops.qmc import _inv_cdf
from spectralmc_tpu_torch.ops.sobol import sobol_uint32

# the step counts of csrc/qmc_paths.cu's qmc_walk_sparse_kernel instantiations
SPARSE_WALK_STEPS = (8, 16, 32, 64)


def _check(directions: torch.Tensor, shift: torch.Tensor, bridge: torch.Tensor,
           timesteps: int, factors: int, count: int, pad: torch.Tensor | None) -> int:
    """The Sobol dimension count, after checking the arguments' shapes."""
    sdims = directions.shape[0]
    if directions.ndim != 2 or directions.shape[1] != 32:
        raise ValueError(f"directions must be [d, 32], got {tuple(directions.shape)}")
    if shift.ndim != 2 or shift.shape[1] != sdims:
        raise ValueError(f"shift must be [C, {sdims}], got {tuple(shift.shape)}")
    if bridge.shape != (timesteps, timesteps) or bridge.dtype != torch.float32:
        raise ValueError(f"bridge must be float32 [{timesteps}, {timesteps}]")
    flat = timesteps * factors
    if sdims > flat or count <= 0:
        raise ValueError(f"{sdims} Sobol dimensions for {flat} flat ones, count {count}")
    want_pad = (shift.shape[0], flat - sdims, count)
    if (pad is None) != (sdims == flat) or (pad is not None and tuple(pad.shape) != want_pad):
        raise ValueError(f"pad must be float32 {want_pad} exactly when dimensions are padded")
    return sdims


def sobol_words(
    directions: torch.Tensor, shift: torch.Tensor, start: int, count: int
) -> torch.Tensor:
    """``[C, d, count]`` scrambled Sobol words (uint32 in int64) of points
    ``start … start + count − 1``, each contract XOR-ing its own shift."""
    base = sobol_uint32(directions, torch.zeros_like(shift[0]), start, count)  # [count, d]
    return base.T[None] ^ shift[:, :, None]


def bridge_normals_plain(
    directions: torch.Tensor,
    shift: torch.Tensor,
    bridge: torch.Tensor,
    start: int,
    *,
    timesteps: int,
    factors: int,
    count: int,
    pad: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel #13's plain twin: ``[C, T, F, count]`` float32 bridged normals.

    ``directions`` is the scrambled table ``[d, 32]`` and ``shift`` the
    per-contract shift ``[C, d]`` (uint32 words in int64), ``bridge`` the
    float32 ``[T, T]`` map, ``start`` the first point index, ``pad`` the
    ``[C, T·F − d, count]`` normals of the padded flat dimensions (None when
    ``d = T·F``). Output ``[t, f]`` is ``Σ_l bridge[t, l]·z[l·F + f]``
    accumulated over ``l`` in order, each multiply-add rounded once."""
    _check(directions, shift, bridge, timesteps, factors, count, pad)
    z = _inv_cdf(sobol_words(directions, shift, start, count))  # [C, d, count]
    if pad is not None:
        z = torch.cat([z, pad.to(torch.float32)], dim=1)
    z = z.reshape(shift.shape[0], timesteps, factors, count)
    acc = torch.zeros_like(z)
    for level in range(timesteps):
        acc = rng.fma32_exact(bridge[None, :, level, None, None], z[:, level:level + 1].double(),
                              acc)
    return acc


def walk_acc_plain(
    directions: torch.Tensor,
    shift: torch.Tensor,
    bridge: torch.Tensor,
    start: int,
    log_spot: torch.Tensor,
    drift: torch.Tensor,
    vol_sdt: torch.Tensor,
    *,
    timesteps: int,
    count: int,
) -> torch.Tensor:
    """Kernel #14's plain twin: ``[C, count]`` float32 sums ``Σ_t log S_t``
    of the flat log-Euler walk ``logx ← (logx + drift) + vol_sdt·eff[t]``
    over kernel #13's twin's single-factor normals; ``log_spot``, ``drift``
    and ``vol_sdt`` are ``[C]`` float32."""
    eff = bridge_normals_plain(directions, shift, bridge, start, timesteps=timesteps,
                               factors=1, count=count)[:, :, 0]
    logx = torch.zeros_like(eff[:, 0]) + log_spot[:, None]
    acc = torch.zeros_like(logx)
    for t in range(timesteps):
        logx = (logx + drift[:, None]) + vol_sdt[:, None] * eff[:, t]
        acc = acc + logx
    return acc


@functools.lru_cache(maxsize=8)
def _pattern(timesteps: int) -> torch.Tensor:
    """``bridge_pattern``'s mask, made once per ``T`` (read, never written)."""
    log = timesteps.bit_length() - 1
    if timesteps < 2 or timesteps != 1 << log:
        raise ValueError(f"the sparse pattern is for T = 2^m, got {timesteps}")
    t = torch.arange(timesteps)[:, None]
    d = torch.arange(log + 1)[None, :]
    cols = torch.where(d == 0, 0, (1 << (d - 1).clamp(min=0)) + (t >> (log - d + 1)))
    mask = torch.zeros((timesteps, timesteps), dtype=torch.bool)
    mask[t, cols] = True
    return mask


def bridge_pattern(timesteps: int) -> torch.Tensor:
    """``[T, T]`` bool: the non-zeros of ``brownian_bridge_matrix(T)`` that
    ``qmc_walk_sparse_kernel`` compiles for ``T = 2^m`` (its ``bridge_col``):
    column 0 of every row, and at level ``d = 1..m`` the column ``2^(d-1) +
    (t >> (m − d + 1))`` of row ``t``, the ``d``-th bisection's interval
    holding ``t``."""
    return _pattern(timesteps).clone()


def sparse_walk(bridge: torch.Tensor, timesteps: int) -> bool:
    """Whether the sparse instantiations of #13 and #14 serve ``bridge``:
    ``T`` is one of ``SPARSE_WALK_STEPS`` and the float32 matrix's non-zeros
    are exactly ``bridge_pattern(T)``. Read on the host: a bridge on the card
    is copied back (a synchronisation), so the main path hands ``walk_acc``
    and ``bridge_normals`` its bridge on the CPU."""
    return timesteps in SPARSE_WALK_STEPS and torch.equal(
        bridge.detach().to("cpu") != 0, _pattern(timesteps))


# ops/_build.py::load_library's arguments for this module's kernels
LIBRARY = ("qmc_paths", ("qmc_paths.cu",))


def _library() -> ctypes.CDLL:
    from spectralmc_tpu_torch.ops._build import load_library

    lib = load_library(*LIBRARY).lib
    ll, i, vp, u = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint
    lib.qmc_bridge_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, ll, u, i, vp]
    lib.qmc_walk_launch.argtypes = [vp, vp, vp, vp, vp, i, i, ll, u, i, vp]
    lib.qmc_bridge_launch.restype = ctypes.c_int
    lib.qmc_walk_launch.restype = ctypes.c_int
    return lib


def _words32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) as the int32 bit patterns the kernel reads."""
    w = words.to(torch.int64) & rng.MASK32
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()


def _on_card(shift: torch.Tensor) -> None:
    if shift.device.type != "cuda":
        raise ValueError(f"the QMC kernels run on cpu (plain twin) or cuda, not {shift.device}")
    if shift.shape[0] > 65535:
        raise ValueError(f"at most 65535 contracts per launch, got {shift.shape[0]}")


@functools.lru_cache(maxsize=16)
def _host_bridge(data: bytes, timesteps: int, device: str) -> tuple[torch.Tensor, bool]:
    """``_bridge_on`` for a bridge on the CPU, once per matrix and card (the
    copy is read, never written)."""
    bridge = torch.frombuffer(bytearray(data), dtype=torch.float32).reshape(timesteps, timesteps)
    return bridge.to(device), sparse_walk(bridge, timesteps)


def _bridge_on(bridge: torch.Tensor, timesteps: int,
               device: torch.device) -> tuple[torch.Tensor, bool]:
    """``(the bridge on the card, sparse_walk(bridge, T))``. A bridge on the
    CPU (the main path's) is read and copied once per matrix and card, so a
    launch adds no copy and no synchronisation; one on the card is read back
    (a synchronisation)."""
    if bridge.device.type == "cpu":
        data = bridge.detach().contiguous().numpy().tobytes()
        return _host_bridge(data, timesteps, str(device))
    return bridge.to(device).contiguous(), sparse_walk(bridge, timesteps)


def bridge_normals(
    directions: torch.Tensor,
    shift: torch.Tensor,
    bridge: torch.Tensor,
    start: int,
    *,
    timesteps: int,
    factors: int,
    count: int,
    pad: torch.Tensor | None = None,
    words_out: torch.Tensor | None = None,
    dense: bool = False,
) -> torch.Tensor:
    """``[C, T, F, count]`` float32 bridged normals (arguments as
    ``bridge_normals_plain``): CPU tensors run the plain twin, CUDA tensors
    launch kernel #13 (one launch for the whole contract batch; its sparse
    instantiation where ``sparse_walk`` holds) or raise. ``bridge`` may lie on
    the CPU while the rest lies on the card (the main path's way), as for
    ``walk_acc``. Checks only, CUDA: ``words_out``, an int32 ``[C, d,
    count]`` tensor that receives the raw Sobol words; ``dense``, launch the
    dense instantiation whatever the matrix."""
    sdims = _check(directions, shift, bridge, timesteps, factors, count, pad)
    if shift.device.type == "cpu":
        return bridge_normals_plain(directions, shift, bridge, start, timesteps=timesteps,
                                    factors=factors, count=count, pad=pad)
    _on_card(shift)
    n = shift.shape[0]
    out = torch.empty((n, timesteps, factors, count), dtype=torch.float32, device=shift.device)
    pad_c = None if pad is None else pad.to(torch.float32).contiguous()
    if words_out is not None and (words_out.shape != (n, sdims, count)
                                  or words_out.dtype != torch.int32):
        raise ValueError(f"words_out must be int32 {(n, sdims, count)}")
    bb, sparse = _bridge_on(bridge, timesteps, shift.device)
    # held in locals until the launch is enqueued: a freed temporary's memory
    # could be handed to the next one before the kernel reads it
    table, shifts = _words32(directions), _words32(shift)
    status = _library().qmc_bridge_launch(
        table.data_ptr(), shifts.data_ptr(), bb.data_ptr(),
        0 if pad_c is None else pad_c.data_ptr(), out.data_ptr(),
        0 if words_out is None else words_out.data_ptr(), n, timesteps, factors, sdims, count,
        start & rng.MASK32, int(sparse and not dense),
        torch.cuda.current_stream(shift.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"qmc_bridge_launch failed: cudaError {status}")
    _count("qmc_bridge")
    return out


def walk_acc_launch(
    directions: torch.Tensor,
    shift: torch.Tensor,
    bridge: torch.Tensor,
    start: int,
    log_spot: torch.Tensor,
    drift: torch.Tensor,
    vol_sdt: torch.Tensor,
    *,
    timesteps: int,
    count: int,
) -> torch.Tensor:
    """``[C, count]`` float32 walk sums (arguments as ``walk_acc_plain``),
    carrying no gradient: CPU tensors run the plain twin, CUDA tensors launch
    kernel #14 or raise (``walk_acc`` is its differentiable form). One
    factor of at most 64 unpadded steps (``qmc.qmc_walk_supported``).
    ``bridge`` may lie on the CPU while the rest lies on the card (the main
    path's way): its zeros are read there (``sparse_walk``) and its copy on
    the card is made once per matrix (``_bridge_on``)."""
    _check(directions, shift, bridge, timesteps, 1, count, None)
    if timesteps > MAX_DIMENSION:
        raise ValueError(f"the fused walk takes at most {MAX_DIMENSION} unpadded steps")
    if shift.device.type == "cpu":
        return walk_acc_plain(directions, shift, bridge, start, log_spot, drift, vol_sdt,
                              timesteps=timesteps, count=count)
    _on_card(shift)
    n = shift.shape[0]
    scalars = torch.stack([log_spot, drift, vol_sdt], dim=1).to(torch.float32).contiguous()
    out = torch.empty((n, count), dtype=torch.float32, device=shift.device)
    bb, sparse = _bridge_on(bridge, timesteps, shift.device)
    table, shifts = _words32(directions), _words32(shift)
    status = _library().qmc_walk_launch(
        table.data_ptr(), shifts.data_ptr(), bb.data_ptr(), scalars.data_ptr(), out.data_ptr(),
        n, timesteps, count, start & rng.MASK32, int(sparse),
        torch.cuda.current_stream(shift.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"qmc_walk_launch failed: cudaError {status}")
    _count("qmc_walk")
    return out


class WalkAcc(torch.autograd.Function):
    """Kernel #14 with its backward. The walk sum is affine in the contract's
    three scalars: ``acc = T·log_spot + T(T+1)/2·drift + vol_sdt·B`` with
    ``B = Σ_t Σ_{s≤t} eff[s]`` free of the contract, so ``∂acc/∂log_spot =
    T``, ``∂acc/∂drift = T(T+1)/2`` and ``∂acc/∂vol_sdt = B``.

    ``B`` comes from a second launch of the same walk at ``(log_spot, drift,
    vol_sdt) = (0, 0, 1)``, whose sums are ``B`` in the forward's own float32
    roundings. Reading it off the forward's output instead, ``(acc −
    T·log_spot − T(T+1)/2·drift)/vol_sdt``, divides the float32 rounding of
    ``acc`` by ``vol_sdt``: on a short, low-vol contract (spot 80, vol 0.15,
    T = 0.25, 16 steps) that put the gradient's ``∂/∂vol_sdt`` 1.4e-4 from
    autograd through ``walk_acc_plain``, past the rtol 1e-4 it is held to
    (``tests/test_torch_greeks.py::test_walk_function_matches_autograd_through_twin``).
    The backward's reductions run in float64."""

    @staticmethod
    def forward(  # type: ignore[override]
        ctx: torch.autograd.function.FunctionCtx,
        log_spot: torch.Tensor,
        drift: torch.Tensor,
        vol_sdt: torch.Tensor,
        launch: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
        timesteps: int,
    ) -> torch.Tensor:
        ctx.launch, ctx.timesteps = launch, timesteps
        ctx.dtypes = (log_spot.dtype, drift.dtype, vol_sdt.dtype)
        return launch(log_spot.detach(), drift.detach(), vol_sdt.detach())

    @staticmethod
    def backward(  # type: ignore[override]
        ctx: torch.autograd.function.FunctionCtx, g: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, None, None]:
        zero = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
        b = ctx.launch(zero, zero, torch.ones_like(zero))
        t = float(ctx.timesteps)
        gd = g.double()
        total = torch.sum(gd, dim=1)
        ls_t, d_t, v_t = ctx.dtypes
        return ((t * total).to(ls_t), (t * (t + 1.0) / 2.0 * total).to(d_t),
                torch.sum(gd * b.double(), dim=1).to(v_t), None, None)


def walk_acc(
    directions: torch.Tensor,
    shift: torch.Tensor,
    bridge: torch.Tensor,
    start: int,
    log_spot: torch.Tensor,
    drift: torch.Tensor,
    vol_sdt: torch.Tensor,
    *,
    timesteps: int,
    count: int,
) -> torch.Tensor:
    """``walk_acc_launch`` as a ``torch.autograd.Function`` (``WalkAcc``):
    the same launch and the same bits forward, the affine rule backward (one
    more launch, at ``(0, 0, 1)``), so a gradient reaches ``log_spot``,
    ``drift`` and ``vol_sdt`` on the card as it does through the plain twin
    on the CPU."""
    def launch(ls: torch.Tensor, d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return walk_acc_launch(directions, shift, bridge, start, ls, d, v,
                               timesteps=timesteps, count=count)

    return WalkAcc.apply(log_spot, drift, vol_sdt, launch, timesteps)


__all__ = [
    "SPARSE_WALK_STEPS",
    "bridge_normals",
    "bridge_normals_plain",
    "bridge_pattern",
    "sobol_words",
    "sparse_walk",
    "WalkAcc",
    "walk_acc",
    "walk_acc_launch",
    "walk_acc_plain",
]
