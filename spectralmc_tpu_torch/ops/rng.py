"""Threefry-2x32 key streams in torch integer ops, word-exact with ``jax.random``.

The JAX package's stateless streams (``ops/rng.py`` there) address every
random number by a key derived from ``(seed, counter, ...)``. This module
reproduces the words of ``jax.random`` with ``jax_threefry_partitionable``
on (the JAX default), so that

* the canonical ``"xla"`` MC engine (``ops/gbm.py::simulate_terminal_rows``)
  draws the same normals as the JAX package, up to the ``erf_inv`` lowering;
* the ``"cuda"`` engine keys its Philox stream with the same per-contract
  key words the JAX kernel engine used (``fold_in(key(mc_seed), draw)``);
* ``create()`` reproduces the JAX CVNN initial weights bit for bit.

Representation: a key is an ``int64`` tensor ``[..., 2]`` of uint32 words
(uint32 has too few torch ops, so words ride in int64 and are masked to 32
bits after each add). All functions are plain tensor code and run on any
device. There is no hidden global generator: every draw names its key.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 (20 rounds) block function on broadcast uint32 words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & MASK32)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` words: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``.

    ``key`` is ``[..., 2]``; ``data`` broadcasts against ``key[..., 0]``, so
    one call folds a whole vector of counters into one key (or one counter
    into many keys).
    """
    data_t = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data_t), data_t)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for a single key ``[2]`` -> ``[num, 2]``.

    Under the partitionable layout the i-th subkey is threefry of ``(0, i)``,
    which is exactly ``fold_in(key, i)``.
    """
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` uint32 words (as int64).

    ``key`` may carry leading batch dims ``[*B, 2]``; the result is
    ``[*B, *shape]``. Word ``n`` (row-major flat index) is ``hi ^ lo`` of
    threefry over the 64-bit counter ``n`` split as ``(n >> 32, n & MASK)``.
    """
    count = math.prod(shape)
    n = torch.arange(count, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    a, b = threefry2x32(k1, k2, n >> 32, n & MASK32)
    return a ^ b


def _float32_from_words(words: torch.Tensor) -> torch.Tensor:
    """``[1, 2)`` float32 from the top 23 bits of uint32 words, minus one."""
    mant = ((words >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def fma32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as XLA's CPU backend contracts it.

    The product of two float32 values is exact in float64, so the float64
    sum rounded to float32 is the fused result (short of a double-rounding
    tie, which the tests have not met).
    """
    return (a.double() * b + c).float()


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit-exact."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = _float32_from_words(bits(key, shape))
    return torch.maximum(lo, fma32(floats, float(hi - lo), float(lo)))


# float32 nextafter(-1, 0): the lower end of jax.random.normal's uniform
_NORMAL_LO = -0.99999994


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial (Giles 2010).

    XLA lowers ``erf_inv`` for float32 to this two-branch polynomial; using
    the same coefficients keeps the port's normals within a few ulps of the
    JAX package's (the remaining difference is the ``log1p`` lowering).
    """
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws = w - 2.5
    wl = torch.sqrt(w) - 3.0
    ps = torch.full_like(x, 2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        ps = fma32(ps, ws.double(), float(torch.tensor(c, dtype=torch.float32)))
    pl = torch.full_like(x, -0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pl = fma32(pl, wl.double(), float(torch.tensor(c, dtype=torch.float32)))
    p = torch.where(small, ps, pl)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erf_inv(u)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=key.device) * erf_inv(u)


# --------------------------------------------------------------------------
# Philox-4x32-10: the counter-based stream of the "cuda" MC engine
# --------------------------------------------------------------------------

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m * x`` for uint32 ``x`` held in int64.

    The full product needs 64 unsigned bits, past int64, so the high word is
    assembled from two 16-bit halves of ``x`` (each partial product < 2^48).
    """
    lo = (x * m) & MASK32  # int64 wraps, the low 32 bits stay exact
    hi = ((x >> 16) * m + (((x & 0xFFFF) * m) >> 16)) >> 16
    return hi & MASK32, lo


def philox4x32(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[torch.Tensor, torch.Tensor],
    rounds: int = 10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox-4x32 (Salmon et al. 2011) on broadcast uint32 words (in int64).

    The same rounds and constants as ``csrc/gbm_paths.cu``; Random123's
    known-answer vectors pin both.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(rounds):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
