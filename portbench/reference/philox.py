"""Counter-based generators in plain PyTorch: Threefry-2x32 and Philox-4x32-10.

Unsigned 32-bit words ride in int64 tensors. Threefry-2x32 (20 rounds)
derives each contract's key as JAX does: ``PRNGKey(seed)`` is the word pair
``(seed >> 32, seed & 0xFFFFFFFF)`` and ``fold_in(key, n)`` is the block
function of the counter ``(0, n)``. Philox-4x32-10 (Salmon, Moraes, Dror and
Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC 2011) is the path
stream, with the constants of Random123.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: tuple[torch.Tensor, torch.Tensor],
                 x: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    k0, k1 = key
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & MASK32)
    a, b = (x[0] + ks[0]) & MASK32, (x[1] + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK32
    return a, b


def contract_keys(seed: int, draws: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(PRNGKey(seed), draw)`` for each draw index: two ``[C]`` words."""
    d = draws.to(torch.int64) & MASK32
    k0 = torch.full_like(d, (seed >> 32) & MASK32)
    k1 = torch.full_like(d, seed & MASK32)
    return threefry2x32((k0, k1), (torch.zeros_like(d), d))


def _mul_hi_lo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # m·x needs 64 unsigned bits: take it from the 16-bit halves of x
    x_hi, x_lo = x >> 16, x & 0xFFFF
    p_lo = x_lo * m
    p_hi = x_hi * m
    low = (p_lo + ((p_hi & 0xFFFF) << 16)) & MASK32
    high = (p_hi + (p_lo >> 16)) >> 16
    return high & MASK32, low


def philox4x32(counter: tuple[torch.Tensor, ...],
               key: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, ...]:
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mul_hi_lo(PHILOX_M[0], c0)
        hi1, lo1 = _mul_hi_lo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
