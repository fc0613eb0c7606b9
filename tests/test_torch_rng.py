"""Port threefry/Philox streams against ``jax.random`` and Random123.

Tiers: key words, ``bits`` and ``uniform`` are tier 1 (bit-exact);
``normal`` is tier 2 within 4 ulps (the ``log1p`` inside ``erf_inv`` lowers
differently); Philox-4x32-10 is tier 1 against Random123's known-answer
vectors and an independent numpy implementation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import rng

SEEDS = [0, 1, 7, 123_456_789, 2**40 + 5]


def _words(key: jax.Array) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_runs_partitionable_threefry() -> None:
    """The port reproduces the partitionable layout, jax's default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bits_bit_exact(seed: int) -> None:
    key = jax.random.PRNGKey(seed)
    tkey = rng.prng_key(seed)
    np.testing.assert_array_equal(_words(key), tkey.numpy())
    for data in (0, 1, 77, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(
            _words(jax.random.fold_in(key, data)), rng.fold_in(tkey, data).numpy()
        )
    np.testing.assert_array_equal(_words(jax.random.split(key, 5)), rng.split(tkey, 5).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (3, 7), jnp.uint32)).astype(np.int64),
        rng.bits(tkey, (3, 7)).numpy(),
    )


def test_fold_in_broadcasts_over_keys_and_counters() -> None:
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 4)
    tkeys = rng.split(rng.prng_key(3), 4)
    want = np.stack([_words(jax.random.fold_in(k, 9)) for k in keys])
    np.testing.assert_array_equal(want, rng.fold_in(tkeys, 9).numpy())
    want = np.stack([_words(jax.random.fold_in(key, d)) for d in range(6)])
    np.testing.assert_array_equal(want, rng.fold_in(rng.prng_key(3), torch.arange(6)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_exact(seed: int) -> None:
    key = jax.random.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-0.99999994, 1.0)):
        want = np.asarray(jax.random.uniform(key, (4096,), jnp.float32, lo, hi))
        got = rng.uniform(rng.prng_key(seed), (4096,), lo, hi).numpy()
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_four_ulps(seed: int) -> None:
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (32768,), jnp.float32))
    got = rng.normal(rng.prng_key(seed), (32768,)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, ulps.max()


# Random123 kat_vectors, philox4x32 with 10 rounds: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("counter,key,expected", PHILOX_KAT)
def test_philox_known_answers(counter, key, expected) -> None:
    out = rng.philox4x32(
        tuple(torch.tensor(c) for c in counter), tuple(torch.tensor(k) for k in key)
    )
    assert tuple(int(x) for x in out) == expected


def _philox_numpy(ctr: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Independent reference: uint64 products split into hi/lo words."""
    c = [ctr[:, i].astype(np.uint64) for i in range(4)]
    k0, k1 = key[:, 0].astype(np.uint64), key[:, 1].astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    for i in range(10):
        if i:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m32, (p0 >> np.uint64(32)) ^ c[3] ^ k1,
             p0 & m32]
    return np.stack(c, axis=1).astype(np.int64)


def test_philox_matches_numpy_reference_on_random_inputs() -> None:
    gen = np.random.default_rng(5)
    ctr = gen.integers(0, 2**32, size=(2048, 4), dtype=np.uint64)
    key = gen.integers(0, 2**32, size=(2048, 2), dtype=np.uint64)
    t = torch.from_numpy(ctr.astype(np.int64))
    k = torch.from_numpy(key.astype(np.int64))
    got = torch.stack(rng.philox4x32(tuple(t[:, i] for i in range(4)), (k[:, 0], k[:, 1])), 1)
    np.testing.assert_array_equal(got.numpy(), _philox_numpy(ctr, key))
