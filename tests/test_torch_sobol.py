"""Port Sobol sampler against the JAX package's.

Tier 1 (bit-exact): direction numbers, the LMS scramble, ``sobol_uint32``
and ``sobol_unit`` at three skips (one unaligned and nonzero). Tier 2:
``scale_to_bounds`` within 1 ulp (XLA may fuse the affine map into an FMA).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.ops.gbm import BlackScholesContract as JContract
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.ops.gbm import BlackScholesContract as TContract

BOUNDS = {
    "spot": (50.0, 150.0),
    "strike": (50.0, 150.0),
    "maturity": (0.2, 2.0),
    "rate": (0.0, 0.10),
    "div_yield": (0.0, 0.05),
    "vol": (0.10, 0.50),
}


def _samplers(seed: int):
    jb = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    tb = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    js = jsobol.SobolSampler.create(JContract, jb, jsobol.SobolConfig(seed=seed)).expect("j")
    ts = tsobol.SobolSampler.create(TContract, tb, tsobol.SobolConfig(seed=seed)).expect("t")
    return js, ts


def test_direction_numbers_and_scramble_bit_exact() -> None:
    np.testing.assert_array_equal(jsobol.direction_numbers(12), tsobol.direction_numbers(12))
    js, ts = _samplers(123)
    np.testing.assert_array_equal(js._directions, ts._directions)
    np.testing.assert_array_equal(js._shift, ts._shift)


@pytest.mark.parametrize("start", [0, 1000, 1_048_579])
def test_points_bit_exact(start: int) -> None:
    js, ts = _samplers(7)
    jt, tt = js.device_table(), ts.device_table("cpu")
    want = np.asarray(jsobol.sobol_uint32(jt["directions"], jt["shift"], start, 300))
    got = tsobol.sobol_uint32(tt["directions"], tt["shift"], start, 300).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)
    want_u = np.asarray(
        jsobol.sobol_unit(jt["directions"], jt["shift"], jnp.uint32(start), 300, jnp.float32)
    )
    got_u = tsobol.sobol_unit(tt["directions"], tt["shift"], start, 300).numpy()
    np.testing.assert_array_equal(want_u, got_u)
    want_d = np.asarray(jsobol.sobol_unit(jt["directions"], jt["shift"], start, 300, jnp.float64))
    got_d = tsobol.sobol_unit(tt["directions"], tt["shift"], start, 300, torch.float64).numpy()
    np.testing.assert_array_equal(want_d, got_d)


def test_scale_to_bounds_within_one_ulp() -> None:
    js, ts = _samplers(11)
    want = np.asarray(js.sample_array(512, dtype=jnp.float32, start=4096))
    got = ts.sample_array(512, device="cpu", start=4096).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_sampler_refuses_bad_bounds_like_jax() -> None:
    bad = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    del bad["vol"]
    res = tsobol.SobolSampler.create(TContract, bad, tsobol.SobolConfig(seed=1))
    assert res.is_failure() and type(res.error).__name__ == "BoundsFieldMismatch"
