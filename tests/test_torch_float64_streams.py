"""The float64 threefry streams against ``jax.random`` and the JAX simulators.

With ``jax_enable_x64`` a float64 draw takes the 64-bit word ``hi << 32 |
lo`` of one threefry call, keeps its top 52 bits and applies XLA's float64
``erf_inv`` (and XLA's CPU ``log1p`` inside it). The port draws the same:

* ``rng.uniform`` float64 is bit-exact; ``rng.normal`` float64 within 1e-15
  relative (the fused multiply-adds are emulated, and a double rounding can
  leave a last bit off); float32 streams are unchanged (their own tests).
* every threefry simulator that draws in its sim's dtype — GBM (rows and the
  path matrix), Heston, Merton, baskets, the American GBM monitor rows with
  their backward, and the QMC generator's padded tail — matches the JAX
  package's float64 run at rtol 1e-12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.ops import american as jam
from spectralmc_tpu.ops import basket as jb
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import heston as jh
from spectralmc_tpu.ops import merton as jm
from spectralmc_tpu.ops import qmc as jq
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import basket as tb
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import heston as th
from spectralmc_tpu_torch.ops import merton as tm
from spectralmc_tpu_torch.ops import qmc as tq
from spectralmc_tpu_torch.ops import rng

SEEDS = [0, 7, 2**40 + 5]
RTOL = 1e-12
ROWS, COLS, STEPS = 4, 16, 6
LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
HESTON_LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.03, 1.0, 0.03, 0.2, -0.8])
HESTON_HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.08, 2.5, 0.08, 0.5, -0.3])
MERTON_LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15, 0.5, -0.15, 0.1])
MERTON_HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.25, 3.0, 0.0, 0.25])


def _contracts(lo: np.ndarray, hi: np.ndarray, n: int, seed: int) -> np.ndarray:
    return lo + (hi - lo) * np.random.default_rng(seed).random((n, len(lo)))


def _keys(n: int) -> tuple[list[jax.Array], torch.Tensor]:
    return ([jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(n)],
            rng.fold_in(rng.prng_key(5), torch.arange(n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_uniform_words_and_normals(seed: int) -> None:
    """The uniforms bit-exact (so the 64-bit words are), the normals within
    1e-15 relative, the tails included."""
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(-1.0, 0.0)
    want_u = np.asarray(jax.random.uniform(key, (20000,), jnp.float64, lo, 1.0))
    got_u = rng.uniform(rng.prng_key(seed), (20000,), lo, 1.0, dtype=torch.float64).numpy()
    np.testing.assert_array_equal(got_u, want_u)
    want = np.asarray(jax.random.normal(key, (20000,), jnp.float64))
    got = rng.normal(rng.prng_key(seed), (20000,), torch.float64).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0.0)
    x = np.concatenate([1.0 - np.logspace(-15, -1, 64), -np.logspace(-12, -0.01, 64)])
    np.testing.assert_allclose(rng.erf_inv64(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.lax.erf_inv(jnp.asarray(x))), rtol=1e-15, atol=0.0)


@pytest.mark.parametrize("scheme", ["log_euler", "euler"])
def test_gbm_rows_and_path_matrix_match_jax(scheme: str) -> None:
    contracts = _contracts(LO, HI, 2, seed=1)
    jkeys, tkeys = _keys(2)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, antithetic_half=ROWS // 2)
    want = np.stack([np.asarray(jgbm.simulate_terminal_rows(
        k, jnp.asarray(c), dtype=jnp.float64, scheme=jgbm.PathScheme(scheme), **kw))
        for k, c in zip(jkeys, contracts)])
    got = tgbm.simulate_terminal_rows(tkeys, torch.from_numpy(contracts), dtype=torch.float64,
                                      scheme=tgbm.PathScheme(scheme), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    want = np.stack([np.asarray(jgbm.simulate_paths(
        k, jnp.asarray(c), timesteps=STEPS, paths=64, dtype=jnp.float64,
        scheme=jgbm.PathScheme(scheme), normalize=False)) for k, c in zip(jkeys, contracts)])
    got = tgbm.simulate_paths(tkeys, torch.from_numpy(contracts), timesteps=STEPS, paths=64,
                              dtype=torch.float64, scheme=tgbm.PathScheme(scheme),
                              normalize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


def test_heston_and_merton_rows_match_jax() -> None:
    jkeys, tkeys = _keys(2)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, antithetic_half=ROWS // 2)
    for jmod, tmod, name, (lo, hi) in (
            (jh, th, "heston", (HESTON_LO, HESTON_HI)),
            (jm, tm, "merton", (MERTON_LO, MERTON_HI))):
        contracts = _contracts(lo, hi, 2, seed=2)
        jfn = getattr(jmod, f"simulate_{name}_underlier_rows")
        tfn = getattr(tmod, f"simulate_{name}_underlier_rows")
        want = np.stack([np.asarray(jfn(k, jnp.asarray(c), dtype=jnp.float64,
                                        payoff=jgbm.PayoffKind.TERMINAL, **kw))
                         for k, c in zip(jkeys, contracts)])
        got = tfn(tkeys, torch.from_numpy(contracts), dtype=torch.float64,
                  payoff=tgbm.PayoffKind.TERMINAL, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0, err_msg=name)


def test_basket_rows_match_jax() -> None:
    spec = dict(weights=(0.5, 0.3, 0.2),
                correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)))
    js = jb.build_basket_spec(**spec).expect("spec")
    ts = tb.build_basket_spec(**spec).expect("spec")
    contracts = _contracts(LO, HI, 2, seed=3)
    jkeys, tkeys = _keys(2)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, antithetic_half=ROWS // 2)
    want = np.stack([np.asarray(jb.simulate_basket_underlier_rows(
        k, jnp.asarray(c), spec=js, dtype=jnp.float64, payoff=jgbm.PayoffKind.TERMINAL, **kw))
        for k, c in zip(jkeys, contracts)])
    got = tb.simulate_basket_underlier_rows(tkeys, torch.from_numpy(contracts), spec=ts,
                                            dtype=torch.float64,
                                            payoff=tgbm.PayoffKind.TERMINAL, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


def test_american_gbm_rows_match_jax() -> None:
    """The threefry American simulator: the float64 monitor rows and the
    float64 backward over them, u at rtol 1e-12 (no exercise date moves)."""
    contracts = _contracts(LO, HI, 2, seed=4)
    jkeys, tkeys = _keys(2)
    kw = dict(timesteps=8, rows=ROWS, cols=COLS, basis_degree=3, exercise_every=2)
    want = np.stack([np.asarray(jam.simulate_american_underlier_rows(
        k, jnp.asarray(c), dtype=jnp.float64, option=jam.OptionSide.PUT, **kw))
        for k, c in zip(jkeys, contracts)])
    got = tam.simulate_american_underlier_rows(tkeys, torch.from_numpy(contracts),
                                               dtype=torch.float64, option=tam.OptionSide.PUT,
                                               **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


def test_qmc_padded_tail_matches_jax() -> None:
    """The pad normals of the flat dimensions past the Sobol table, keyed
    (pad key, GLOBAL row, flat dimension), drawn as the JAX generator draws
    them in float64 (``ops/qmc.py::qmc_effective_normals_multi``)."""
    steps, factors, row_offset = 64, 2, 3
    sdims = tq.qmc_sobol_dims(steps, factors)
    assert jq.qmc_sobol_dims(steps, factors) == sdims < steps * factors
    _, tkeys = _keys(2)
    jkeys, _ = _keys(2)
    pad_keys = tq._draw_tables(tkeys, steps, factors, 7)[3]
    got = tq.qmc_pad_normals(pad_keys, range(sdims, sdims + 3), rows=ROWS, cols=COLS,
                             row_offset=row_offset, dtype=torch.float64).numpy()
    for c, key in enumerate(jkeys):
        _, pad_key = jax.random.split(key)
        row_keys = [jax.random.fold_in(pad_key, row_offset + r) for r in range(ROWS)]
        want = np.stack([np.concatenate([np.asarray(jax.random.normal(
            jax.random.fold_in(k, j), (COLS,), jnp.float64)) for k in row_keys])
            for j in range(sdims, sdims + 3)])
        np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=0.0)
