"""Scrambled Sobol points in NumPy: the contracts a training step samples.

Joe and Kuo's direction numbers ("new-joe-kuo-6.21201", S. Joe and F. Y. Kuo,
https://web.maths.unsw.edu.au/~fkuo/sobol/) for the first dimensions, an
Owen linear-matrix scramble and a digital shift drawn from
``numpy.random.default_rng(seed)`` (the lower-triangular bit matrices first,
then the shifts), point ``n`` the XOR of the columns that the bits of the
Gray code ``n ^ (n >> 1)`` select, and the unit value the top 24 bits of the
word times 2^-24. The benchmark also draws its served books from here.
"""

from __future__ import annotations

import numpy as np

BITS = 32
MASK32 = 0xFFFFFFFF
# primitive polynomials and initial direction values of dimensions 1..8
POLY = (1, 3, 7, 11, 13, 19, 25, 37)
M_INIT = ((1,), (1,), (1, 3), (1, 3, 1), (1, 1, 1), (1, 1, 3, 3), (1, 3, 5, 13), (1, 1, 5, 5, 17))


def directions(dimension: int) -> np.ndarray:
    """``[dimension, 32]`` uint64 direction numbers ``m_k << (31 − k)``."""
    v = np.zeros((dimension, BITS), dtype=np.uint64)
    for j in range(dimension):
        s = max(POLY[j].bit_length() - 1, 0)
        if s == 0:
            m = [1] * BITS
        else:
            m = list(M_INIT[j][:s])
            a = (POLY[j] - (1 << s) - 1) >> 1
            for k in range(s, BITS):
                new = m[k - s] ^ (m[k - s] << s)
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        new ^= m[k - i] << i
                m.append(new)
        for k in range(BITS):
            v[j, k] = (m[k] << (BITS - 1 - k)) & MASK32
    return v


def scrambled(dimension: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(directions [d, 32], shift [d])`` as uint64 words."""
    v = directions(dimension)
    rng = np.random.default_rng(seed)
    lower = np.tril(rng.integers(0, 2, size=(dimension, BITS, BITS), dtype=np.uint8), k=-1)
    lower |= np.eye(BITS, dtype=np.uint8)[None]
    out = np.zeros_like(v)
    for j in range(dimension):
        for k in range(BITS):
            word = 0
            column = int(v[j, k])
            for i in range(BITS):  # output bit i (MSB first) = <row i of L, bits of V>
                parity = 0
                for b in range(i + 1):
                    if lower[j, i, b] and (column >> (BITS - 1 - b)) & 1:
                        parity ^= 1
                word |= parity << (BITS - 1 - i)
            out[j, k] = word
    shift = rng.integers(0, 1 << 32, size=(dimension,), dtype=np.uint32).astype(np.uint64)
    return out, shift


def point_words(table: tuple[np.ndarray, np.ndarray], index: int) -> np.ndarray:
    """The ``[d]`` words of point ``index``, from the bits of its Gray code."""
    v, shift = table
    gray = (index & MASK32) ^ ((index & MASK32) >> 1)
    words = shift.copy()
    for k in range(BITS):
        if (gray >> k) & 1:
            words ^= v[:, k]
    return words


def unit_points(table: tuple[np.ndarray, np.ndarray], start: int, count: int) -> np.ndarray:
    """``[count, d]`` float32 points in [0, 1) from point index ``start``.

    Consecutive Gray codes differ in the bit of the trailing zeros of the
    index, so point ``n`` is point ``n − 1`` XOR that bit's column."""
    if start + count > 1 << BITS:
        raise ValueError("the range passes the 32-bit index")
    v, _ = table
    n = np.arange(start + 1, start + count, dtype=np.int64)
    trailing = np.log2((n & -n).astype(np.float64)).astype(np.int64)
    rows = np.concatenate([point_words(table, start)[None, :], v[:, trailing].T])
    words = np.bitwise_xor.accumulate(rows, axis=0)
    return (words >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)


def contracts(table: tuple[np.ndarray, np.ndarray], lower: np.ndarray, upper: np.ndarray,
              start: int, count: int) -> np.ndarray:
    """``[count, d]`` float32 contracts: ``lower + u·(upper − lower)``."""
    lo, hi = lower.astype(np.float32), upper.astype(np.float32)
    return lo[None, :] + unit_points(table, start, count) * (hi - lo)[None, :]
