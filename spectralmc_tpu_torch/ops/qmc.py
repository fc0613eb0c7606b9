"""Randomized quasi-Monte-Carlo path sampling: scrambled Sobol + Brownian bridge
(the JAX package's ``ops/qmc.py``).

``sampling=SamplingKind.SOBOL_BB`` replaces the pseudo-random per-step
normals by the Brownian-bridge-ordered points of a scrambled Sobol net:

* **The bridge as one linear map.** ``brownian_bridge_matrix(T)`` (float64,
  on the host, cached) takes the variance-ordered variates z (z_0 sets the
  terminal value, later ones the midpoints of ever finer intervals) to the
  path's unit-step Brownian increments. It is exactly orthogonal, so its
  output has the identity covariance and feeds the unchanged scan bodies.
* **Sobol point = path.** The point index is the GLOBAL path index
  ``(row_offset + row)·cols + col``, so a row shard generates bit for bit the
  points a single-device run gives its rows.
* **Randomization = LMS + a per-draw digital shift.** The direction numbers
  are linear-matrix-scrambled once per (dimensions, mc_seed) on the host
  (``_qmc_tables``, the numpy draw order of the JAX package); each contract
  XORs in a digital shift drawn from its threefry key
  (``bits(split(key)[0], (sdims,))``).
* **Padded beyond 64 dimensions.** The Joe-Kuo table covers 64 dimensions;
  flat dimensions (``level·F + factor``) past them take threefry normals
  keyed by (``split(key)[1]``, global row, flat dimension).

The generator itself (Sobol words → ``√2·erf⁻¹(2u−1)`` → the ``[T, T]``
bridge product per factor) is kernel #13 of ``ops/qmc_cuda.py`` on a CUDA
tensor and its plain twin on the CPU. It computes in float32, as the JAX
package's fused kernel does; a float64 simulation takes its output widened.
Every simulator takes a batch of contracts: the normals are ``[C, T, F,
rows, cols]``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.ops._sobol_directions import MAX_DIMENSION
from spectralmc_tpu_torch.ops.sobol import direction_numbers, lms_scramble, sobol_uint32

_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
_TOP_BUCKET = 0xFFFFFF


@lru_cache(maxsize=64)
def brownian_bridge_matrix(timesteps: int) -> np.ndarray:
    """``[T, T]`` float64 map from the variance-ordered variates to the
    unit-step increments: row ``t`` gives the increment over ``(t, t+1]``.
    z_0 sets ``W_T = √T·z_0``; z_k (breadth-first bisection order) sets the
    midpoint of the k-th largest remaining interval given its endpoints."""
    if timesteps < 1:
        raise ValueError(f"timesteps must be >= 1, got {timesteps}")
    a = np.zeros((timesteps + 1, timesteps), dtype=np.float64)
    a[timesteps, 0] = np.sqrt(float(timesteps))
    queue: list[tuple[int, int]] = [(0, timesteps)]
    k = 1
    while queue:
        nxt: list[tuple[int, int]] = []
        for left, right in queue:
            if right - left < 2:
                continue
            mid = (left + right) // 2
            span = float(right - left)
            a[mid] = (float(right - mid) / span) * a[left] + (float(mid - left) / span) * a[right]
            a[mid, k] += np.sqrt(float(mid - left) * float(right - mid) / span)
            k += 1
            nxt.extend(((left, mid), (mid, right)))
        queue = nxt
    return a[1:] - a[:-1]


@lru_cache(maxsize=64)
def _qmc_tables(dim: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """LMS-scrambled direction numbers ``[dim, 32]`` and the host digital
    shift ``[dim]`` for (dim, seed), uint32."""
    gen = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x51B07C0FFEE))
    return lms_scramble(direction_numbers(dim), gen)


def qmc_sobol_dims(timesteps: int, factors: int = 1) -> int:
    """The flat (level, factor) dimensions the Sobol net covers; the rest are padded."""
    return min(timesteps * factors, MAX_DIMENSION)


def _inv_cdf(bits: torch.Tensor) -> torch.Tensor:
    """uint32 Sobol words (in int64) -> float32 standard normals.

    Centered uniforms from the top 24 bits, ``u = (b + 0.5)·2⁻²⁴``, then
    ``√2·erf⁻¹(2u − 1)`` with XLA's float32 polynomial (``rng.erf_inv``).
    Top-bucket guard: for ``b = 2²⁴ − 1`` the sum ``b + 0.5`` rounds up to
    2²⁴ in float32, so ``u`` would be 1 and the normal infinite; that bucket
    alone takes its intended argument ``1 − 2⁻²⁴``."""
    top24 = bits >> 8
    u = (top24.to(torch.float32) + 0.5) * 2.0**-24
    x = 2.0 * u - 1.0
    x = torch.where(top24 == _TOP_BUCKET, torch.full_like(x, 1.0 - 2.0**-24), x)
    return _SQRT2.to(bits.device) * rng.erf_inv(x)


def _draw_tables(
    contract_keys: torch.Tensor, timesteps: int, factors: int, mc_seed: int
) -> tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sdims, directions [sdims, 32], shift [C, sdims], pad_keys [C, 2])``:
    the scrambled table, each contract's shift (host shift XOR the digital
    shift of ``split(key)[0]``) and its pad key ``split(key)[1]``."""
    device = contract_keys.device
    sdims = qmc_sobol_dims(timesteps, factors)
    directions_np, host_shift_np = _qmc_tables(sdims, mc_seed)
    directions = torch.as_tensor(directions_np.astype(np.int64), device=device)
    host_shift = torch.as_tensor(host_shift_np.astype(np.int64), device=device)
    halves = rng.fold_in(contract_keys[:, None, :], torch.arange(2, device=device))  # split
    shift = host_shift ^ rng.bits(halves[:, 0], (sdims,))
    return sdims, directions, shift, halves[:, 1]


def _start(row_offset: int, cols: int) -> int:
    """The first point's index, ``row_offset·cols`` as a uint32 (it wraps as JAX's does)."""
    return (int(row_offset) * cols) & rng.MASK32


def qmc_pad_normals(
    pad_keys: torch.Tensor,
    dims: range,
    *,
    rows: int,
    cols: int,
    row_offset: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``[C, len(dims), rows·cols]`` threefry normals of the padded flat
    dimensions in ``dtype`` (float32 or float64, each as ``jax.random.normal``
    draws it), keyed (pad key, GLOBAL row, flat dimension)."""
    row_idx = row_offset + torch.arange(rows, dtype=torch.int64, device=pad_keys.device)
    row_keys = rng.fold_in(pad_keys[:, None, :], row_idx[None, :])  # [C, rows, 2]
    pads = [rng.normal(rng.fold_in(row_keys, j), (cols,), dtype) for j in dims]
    return torch.stack(pads, dim=1).reshape(pad_keys.shape[0], len(dims), rows * cols)


def qmc_effective_normals_multi(
    contract_keys: torch.Tensor,
    *,
    timesteps: int,
    factors: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    mc_seed: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """``[C, T, F, rows, cols]`` unit-variance effective normals.

    Each factor gets its own Brownian bridge; a Sobol point's flat dimensions
    interleave factors within each bridge level (``flat = level·F + factor``)
    so every factor's coarse levels land on well-distributed dimensions.
    Deterministic in (contract key, mc_seed, global row range).
    ``contract_keys`` is ``[C, 2]`` threefry words.
    """
    from spectralmc_tpu_torch.ops.qmc_cuda import bridge_normals

    sdims, directions, shift, pad_keys = _draw_tables(contract_keys, timesteps, factors, mc_seed)
    flat_total = timesteps * factors
    pad = None
    if sdims < flat_total:
        pad = qmc_pad_normals(pad_keys, range(sdims, flat_total), rows=rows, cols=cols,
                              row_offset=row_offset, dtype=dtype)
    # on the host: bridge_normals reads its zeros there and copies it to the card itself
    bridge = torch.as_tensor(brownian_bridge_matrix(timesteps), dtype=torch.float32)
    out = bridge_normals(directions, shift, bridge, _start(row_offset, cols),
                         timesteps=timesteps, factors=factors, count=rows * cols, pad=pad)
    return out.reshape(contract_keys.shape[0], timesteps, factors, rows, cols).to(dtype)


def qmc_terminal_normals(
    contract_keys: torch.Tensor,
    *,
    timesteps: int,
    factors: int = 1,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    mc_seed: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """``[C, F, rows, cols]`` TERMINAL bridge variates: flat dimension ``f``
    (level 0) of each factor only, from the same scrambled table and shifts
    as ``qmc_effective_normals_multi`` (derived over the full dimension
    count, then sliced), so the shortcut and the full walk price with the
    same terminal variates. Plain torch: the JAX package has no kernel here."""
    _, directions, shift, _ = _draw_tables(contract_keys, timesteps, factors, mc_seed)
    count = rows * cols
    base = sobol_uint32(directions[:factors], torch.zeros_like(shift[0, :factors]),
                        _start(row_offset, cols), count)  # [count, F]
    bits = base.T[None] ^ shift[:, :factors, None]
    return _inv_cdf(bits).to(dtype).reshape(contract_keys.shape[0], factors, rows, cols)


def qmc_effective_normals(
    contract_keys: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: torch.dtype,
    mc_seed: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """``[C, T, rows, cols]`` single-factor effective normals: the drop-in
    for the pseudo engine's per-step draws (the factors=1 slice of
    ``qmc_effective_normals_multi``)."""
    return qmc_effective_normals_multi(
        contract_keys, timesteps=timesteps, factors=1, rows=rows, cols=cols, dtype=dtype,
        mc_seed=mc_seed, row_offset=row_offset,
    )[:, :, 0]


def qmc_walk_supported(*, timesteps: int, dtype: torch.dtype) -> bool:
    """Whether the fused QMC walk (kernel #14) serves a flat log-Euler
    geometric Asian: one factor with no padded dimension, float32. Like the
    JAX package's, an internal route, not an engine: its underliers equal
    the scan over ``qmc_effective_normals`` bit for bit."""
    return timesteps <= MAX_DIMENSION and dtype == torch.float32


def qmc_asian_geo_underliers(
    contract_keys: torch.Tensor,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    mc_seed: int,
    row_offset: int,
    log_spot: torch.Tensor,
    drift: torch.Tensor,
    vol_sdt: torch.Tensor,
) -> torch.Tensor:
    """``[C, rows, cols]`` SOBOL_BB geometric-Asian underliers through the
    fused walk: the same tables and shifts as ``qmc_effective_normals``, the
    walk ``logx ← (logx + drift) + vol√dt·eff[t]``, ``acc ← acc + logx`` in
    the kernel, and ``exp(acc / T)`` here in torch. ``log_spot``, ``drift``
    and ``vol_sdt`` are float32 per contract (any shape of ``C`` elements).
    The caller checks ``qmc_walk_supported``."""
    from spectralmc_tpu_torch.ops.qmc_cuda import walk_acc

    _, directions, shift, _ = _draw_tables(contract_keys, timesteps, 1, mc_seed)
    # on the host: walk_acc reads its zeros there and copies it to the card itself
    bridge = torch.as_tensor(brownian_bridge_matrix(timesteps), dtype=torch.float32)
    n = contract_keys.shape[0]
    acc = walk_acc(directions, shift, bridge, _start(row_offset, cols),
                   log_spot.reshape(n), drift.reshape(n), vol_sdt.reshape(n),
                   timesteps=timesteps, count=rows * cols)
    return torch.exp(acc.reshape(n, rows, cols) / timesteps)


__all__ = [
    "brownian_bridge_matrix",
    "qmc_asian_geo_underliers",
    "qmc_effective_normals",
    "qmc_effective_normals_multi",
    "qmc_pad_normals",
    "qmc_sobol_dims",
    "qmc_terminal_normals",
    "qmc_walk_supported",
]
