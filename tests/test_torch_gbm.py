"""Port GBM engines against the JAX package, the oracle and each other.

(a) tier 2, rtol 1e-5: the threefry engine against the JAX package's
    ``simulate_terminal_rows`` on the same key (the normals differ by the
    ``erf_inv`` lowering's few ulps).
(b) tier 3, rtol 2e-5: the CUDA kernel's plain twin fed all-zero words
    against the JAX kernel in interpret mode, whose stubbed PRNG returns zero
    bits; the tolerance is the TPU polynomial sine's (< 4e-6) plus libm ulps.
    With antithetic on the two pairing conventions differ, so sorted values
    are compared.
(c) tier 4: the twin's discounted put mean at 65,536 paths within 4 SE of
    Black–Scholes.
(d) tier 2, rtol 1e-6: ``terminal_to_prices`` and ``payoff_spectrum``; the
    payoffs ``df·max(K − S, 0)`` cancel, so their absolute floor is 1e-6 of
    the strike (the MEAN rescale's sum order differs by an ulp).
(e) routing: a "cuda" request on CPU tensors runs the twin and launches
    nothing; configs outside the slice are refused (the trainer's refusal
    of "pallas" is in test_torch_slice.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops.gbm_pallas import simulate_terminal_rows_pallas
from spectralmc_tpu.ops.spectrum import payoff_spectrum as j_payoff_spectrum
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops.analytic import black_scholes_price
from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator
from spectralmc_tpu_torch.ops.spectrum import payoff_spectrum

CONTRACT = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=np.float32)
SCHEMES = [(jgbm.PathScheme.LOG_EULER, tgbm.PathScheme.LOG_EULER),
           (jgbm.PathScheme.EULER, tgbm.PathScheme.EULER)]


def _contracts(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


@pytest.mark.parametrize("schemes", SCHEMES, ids=["log_euler", "euler"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_threefry_engine_matches_jax(schemes, antithetic: bool) -> None:
    jscheme, tscheme = schemes
    contracts = _contracts(3, seed=1)
    rows, cols, steps = 8, 16, 7
    half = rows // 2 if antithetic else None
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(3)]
    want = np.stack([
        np.asarray(jgbm.simulate_terminal_rows(
            k, jnp.asarray(c), timesteps=steps, rows=rows, cols=cols, dtype=jnp.float32,
            scheme=jscheme, antithetic_half=half,
        ))
        for k, c in zip(keys, contracts)
    ])
    got = tgbm.simulate_terminal_rows(
        rng.fold_in(rng.prng_key(5), torch.arange(3)), torch.from_numpy(contracts),
        timesteps=steps, rows=rows, cols=cols, dtype=torch.float32, scheme=tscheme,
        antithetic_half=half,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_threefry_engine_row_offset_is_shard_stable() -> None:
    """Rows [4, 8) simulated alone equal rows 4..7 of the full run (exact)."""
    kw = dict(timesteps=5, cols=16, dtype=torch.float32, scheme=tgbm.PathScheme.LOG_EULER,
              antithetic_half=4)
    keys = rng.fold_in(rng.prng_key(2), torch.arange(2))
    c = torch.from_numpy(_contracts(2, seed=2))
    full = tgbm.simulate_terminal_rows(keys, c, rows=8, **kw)
    part = tgbm.simulate_terminal_rows(keys, c, rows=4, row_offset=4, **kw)
    assert torch.equal(full[:, 4:], part)


def _pallas_zero_bits(contract, scheme, steps: int, antithetic: bool) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        out = simulate_terminal_rows_pallas(
            jax.random.PRNGKey(1), jnp.asarray(contract), timesteps=steps, rows=8, cols=128,
            dtype=jnp.float32, scheme=scheme, antithetic_half=4 if antithetic else None,
            interpret=True,
        )
    return np.asarray(out)


# Zero words put every draw at z = ±5.887 (u1 = 2^-25). Under reflection-Euler
# the mirrored step multiplies by 1 − vol·√dt·5.887, which amplifies the TPU
# sine's error by a / (1 − a); the mirrored Euler case takes a vol of 0.10 so
# that factor stays near 0.4 and the comparison tests the kernel's math, not
# the conditioning of a path pushed toward the reflection.
LOW_VOL = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.10], dtype=np.float32)


@pytest.mark.parametrize(
    "jscheme,tscheme,steps,antithetic,contract",
    [
        (jgbm.PathScheme.LOG_EULER, tgbm.PathScheme.LOG_EULER, 8, False, CONTRACT),
        (jgbm.PathScheme.LOG_EULER, tgbm.PathScheme.LOG_EULER, 7, False, CONTRACT),
        (jgbm.PathScheme.EULER, tgbm.PathScheme.EULER, 6, False, CONTRACT),
        (jgbm.PathScheme.LOG_EULER, tgbm.PathScheme.LOG_EULER, 5, True, CONTRACT),
        (jgbm.PathScheme.EULER, tgbm.PathScheme.EULER, 4, True, LOW_VOL),
    ],
    ids=["log_euler_even", "log_euler_odd", "euler", "log_euler_anti", "euler_anti"],
)
def test_twin_zero_words_matches_pallas_interpret(
    jscheme, tscheme, steps, antithetic, contract
) -> None:
    want = _pallas_zero_bits(contract, jscheme, steps, antithetic)
    got = gbm_cuda.simulate_terminal_rows_cuda_plain(
        torch.from_numpy(contract[None]), torch.zeros((1, 2), dtype=torch.int64),
        timesteps=steps, rows=8, cols=128, scheme=tscheme,
        antithetic_half=4 if antithetic else None, words=torch.zeros((), dtype=torch.int64),
    )[0].numpy()
    if antithetic:
        want, got = np.sort(want, axis=None), np.sort(got, axis=None)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_twin_put_mean_within_four_se_of_black_scholes() -> None:
    contract = torch.tensor([[100.0, 105.0, 1.0, 0.03, 0.01, 0.25]])
    rows = gbm_cuda.simulate_terminal_rows_cuda_plain(
        contract, rng.fold_in(rng.prng_key(9), torch.arange(1)), timesteps=8, rows=256,
        cols=256, scheme=tgbm.PathScheme.LOG_EULER,
    )
    prices = tgbm.terminal_to_prices(rows.reshape(1, -1), contract, normalize=False,
                                     dtype=torch.float32)
    put = prices.put_payoffs[0].double()
    se = float(put.std()) / math.sqrt(put.numel())
    oracle = float(black_scholes_price(*contract[0].double()).put)
    assert abs(float(put.mean()) - oracle) < 4 * se


def test_twin_words_are_philox_of_path_and_call() -> None:
    """The twin's generator is Philox keyed by the contract words, counter
    (path lo, path hi, call, 0): feeding those words explicitly is identical."""
    key = rng.fold_in(rng.prng_key(4), torch.arange(2))
    c = torch.from_numpy(_contracts(2, seed=4))
    rows, cols, steps = 4, 8, 5
    path = torch.arange(rows * cols).reshape(1, rows, cols, 1)
    calls = torch.arange(2).reshape(1, 1, 1, 2)
    w = rng.philox4x32(
        (path & rng.MASK32, path >> 32, calls, torch.zeros_like(calls)),
        (key[:, 0].reshape(2, 1, 1, 1), key[:, 1].reshape(2, 1, 1, 1)),
    )
    words = torch.stack(torch.broadcast_tensors(*w), dim=-1)
    kw = dict(timesteps=steps, rows=rows, cols=cols, scheme=tgbm.PathScheme.LOG_EULER)
    assert torch.equal(
        gbm_cuda.simulate_terminal_rows_cuda_plain(c, key, **kw),
        gbm_cuda.simulate_terminal_rows_cuda_plain(c, key, words=words, **kw),
    )


def test_twin_row_offset_is_shard_stable() -> None:
    """Rows [6, 10) simulated alone equal rows 6..9 of the full run (exact):
    the Philox counter is the GLOBAL path index, antithetic pairs included."""
    keys = rng.fold_in(rng.prng_key(8), torch.arange(2))
    c = torch.from_numpy(_contracts(2, seed=8))
    kw = dict(timesteps=5, cols=16, scheme=tgbm.PathScheme.LOG_EULER, antithetic_half=6)
    full = gbm_cuda.simulate_terminal_rows_cuda_plain(c, keys, rows=12, **kw)
    part = gbm_cuda.simulate_terminal_rows_cuda_plain(c, keys, rows=4, row_offset=6, **kw)
    assert torch.equal(full[:, 6:10], part)


def test_twin_antithetic_mirrors_the_lower_half() -> None:
    """Global row r >= H reuses row r - H's words with z negated: under
    log-Euler the pair's log-returns sum to twice the drift (exact in a
    rounding-free world; here to float32 ulps)."""
    c = torch.tensor([[100.0, 100.0, 1.0, 0.03, 0.01, 0.25]])
    out = gbm_cuda.simulate_terminal_rows_cuda_plain(
        c, rng.fold_in(rng.prng_key(1), torch.arange(1)), timesteps=6, rows=8, cols=16,
        scheme=tgbm.PathScheme.LOG_EULER, antithetic_half=4,
    )[0].double()
    log_sum = torch.log(out[:4] / 100.0) + torch.log(out[4:] / 100.0)
    drift = (0.03 - 0.01 - 0.5 * 0.25**2) * 1.0
    np.testing.assert_allclose(log_sum.numpy(), 2 * drift, atol=2e-5)


def test_terminal_to_prices_and_spectrum_match_jax() -> None:
    contracts = _contracts(3, seed=3)
    gen = np.random.default_rng(0)
    terminal = (100.0 * np.exp(0.2 * gen.standard_normal((3, 8 * 16)))).astype(np.float32)
    tt = torch.from_numpy(terminal)
    tc = torch.from_numpy(contracts)
    target = tgbm.expected_underlier_mean(tc, timesteps=4, payoff=tgbm.PayoffKind.TERMINAL,
                                          dtype=torch.float32)
    got = tgbm.terminal_to_prices(tt, tc, normalize=True, dtype=torch.float32,
                                  mean_target=target)
    spec = payoff_spectrum(got.put_payoffs, batches=8, network_size=16).numpy()
    for i in range(3):
        jc = jnp.asarray(contracts[i])
        jtarget = jgbm.expected_underlier_mean(jc, timesteps=4, payoff=jgbm.PayoffKind.TERMINAL,
                                               dtype=jnp.float32)
        want = jgbm.terminal_to_prices(jnp.asarray(terminal[i]), jc, normalize=True,
                                       dtype=jnp.float32, mean_target=jtarget)
        np.testing.assert_allclose(target[i].numpy(), np.asarray(jtarget), rtol=1e-6)
        floor = 1e-6 * float(contracts[i, 1])
        np.testing.assert_allclose(got.put_payoffs[i].numpy(), np.asarray(want.put_payoffs),
                                   rtol=1e-6, atol=floor)
        np.testing.assert_allclose(got.call_payoffs[i].numpy(), np.asarray(want.call_payoffs),
                                   rtol=1e-6, atol=floor)
        np.testing.assert_allclose(got.forward[i].numpy(), np.asarray(want.forward), rtol=1e-6)
        np.testing.assert_allclose(got.discount_factor[i].numpy(),
                                   np.asarray(want.discount_factor), rtol=1e-6)
        jspec = np.asarray(j_payoff_spectrum(want.put_payoffs, batches=8, network_size=16))
        np.testing.assert_allclose(spec[i], jspec, rtol=1e-6, atol=floor)


def test_cuda_engine_on_cpu_runs_the_twin_and_launches_nothing() -> None:
    sim = tgbm.build_simulation_params(
        timesteps=5, network_size=16, batches_per_mc_run=8, mc_seed=3, implementation="cuda",
        antithetic=True,
    ).expect("sim")
    assert tgbm.resolve_implementation(sim) == tgbm.SimImplementation.CUDA
    before = gbm_cuda.LAUNCHES
    keys = rng.fold_in(rng.prng_key(3), torch.arange(2))
    c = torch.from_numpy(_contracts(2, seed=5))
    got = make_underlier_simulator(sim, rows=8)(keys, c)
    want = gbm_cuda.simulate_terminal_rows_cuda_plain(
        c, keys, timesteps=5, rows=8, cols=16, scheme=tgbm.PathScheme.LOG_EULER,
        antithetic_half=4,
    )
    assert torch.equal(got, want)
    assert gbm_cuda.LAUNCHES == before == 0


def test_cuda_wrapper_rejects_bad_inputs() -> None:
    keys = torch.zeros((2, 2), dtype=torch.int64)
    kw = dict(timesteps=2, rows=2, cols=2, scheme=tgbm.PathScheme.EULER,
              payoff=tgbm.PayoffKind.TERMINAL)
    with pytest.raises(TypeError):
        gbm_cuda.simulate_underlier_rows_cuda(torch.zeros((2, 6), dtype=torch.float64), keys,
                                              **kw)
    with pytest.raises(ValueError):
        gbm_cuda.simulate_underlier_rows_cuda(torch.zeros((2, 5)), keys, **kw)
    with pytest.raises(ValueError):
        gbm_cuda.simulate_underlier_rows_cuda(torch.zeros((3, 6)), keys, **kw)
    with pytest.raises(ValueError):
        gbm_cuda.simulate_underlier_rows_cuda(
            torch.zeros((2, 6), device="meta"), keys.to("meta"), **kw
        )


def test_engine_resolution_and_slice_refusals() -> None:
    base = dict(timesteps=2, network_size=4, batches_per_mc_run=2, mc_seed=0)
    f64 = tgbm.build_simulation_params(
        **base, implementation="cuda", precision="float64",
    ).expect("f64")
    assert tgbm.resolve_implementation(f64) == tgbm.SimImplementation.XLA
    assert tgbm.has_closed_form_mean(tgbm.ModelKind.GBM, tgbm.PayoffKind.TERMINAL)
    assert tgbm.has_closed_form_mean(tgbm.ModelKind.GBM, tgbm.PayoffKind.DIGITAL)
    for ported in (dict(payoff="asian_geometric"), dict(payoff="digital", normalization="none")):
        sim = tgbm.build_simulation_params(**base, implementation="cuda", **ported).expect("ok")
        assert tgbm.resolve_implementation(sim) == tgbm.SimImplementation.CUDA
    assert tgbm.has_closed_form_mean(tgbm.ModelKind.BASKET_GBM, tgbm.PayoffKind.TERMINAL)
    # American is ported under every dynamics (the monitor-row kernels on
    # "cuda"); under MEAN normalization it is refused as JAX refuses it
    american = tgbm.build_simulation_params(**base, implementation="cuda", payoff="american_put",
                                            normalization="none").expect("american")
    assert tgbm.resolve_implementation(american) == tgbm.SimImplementation.CUDA
    merton = tgbm.build_simulation_params(**base, implementation="cuda", model="merton_jump",
                                          payoff="american_put", normalization="none")
    assert tgbm.resolve_implementation(merton.expect("merton")) == tgbm.SimImplementation.CUDA
    got = tgbm.build_simulation_params(**base, model="merton_jump", payoff="american_put",
                                       normalization="mean")
    want = jgbm.build_simulation_params(**base, model="merton_jump", payoff="american_put",
                                        normalization="mean")
    assert got.is_failure() and want.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)
    # baskets and QMC are ported: a basket needs its spec, SOBOL_BB runs the
    # threefry engine's scans
    no_spec = tgbm.build_simulation_params(**base, model="basket_gbm")
    assert no_spec.is_failure() and no_spec.error.field == "basket"
    assert tgbm.build_simulation_params(**base, basket=object()).is_failure()
    qmc = tgbm.build_simulation_params(**base, sampling="sobol_bb",
                                       implementation="cuda").expect("qmc")
    assert tgbm.resolve_implementation(qmc) == tgbm.SimImplementation.XLA
    curve = tgbm.TermStructure(rate_shape=(0.5, 1.5))
    for admitted in (dict(model="heston"), dict(model="merton_jump"), dict(term=curve),
                     dict(model="heston", term=curve), dict(model="merton_jump", term=curve)):
        sim = tgbm.build_simulation_params(**base, implementation="cuda", **admitted).expect("ok")
        curved_family = "term" in admitted and "model" in admitted
        want = tgbm.SimImplementation.XLA if curved_family else tgbm.SimImplementation.CUDA
        assert tgbm.resolve_implementation(sim) == want
    stray = tgbm.build_simulation_params(**base, barrier_rel=1.2)
    assert stray.is_failure() and stray.error.field == "barrier_rel"


# The twin's TERMINAL values on real Philox words, recorded from the first
# release of the "cuda" engine (stream gbm v1): [scheme, steps, antithetic
# half, contract 0 values, contract 1 values] at rows 0, 3, 5, 7 and cols
# 0..3 of an 8 x 4 block at row offset 2.
TERMINAL_PIN = [
    ("log_euler", 16, None,
     ["0x1.07b05cp+7", "0x1.2c8fb2p+6", "0x1.e63efap+6", "0x1.daec0ep+6"],
     ["0x1.f3e1ecp+5", "0x1.bcdc56p+6", "0x1.a37b7cp+6", "0x1.4d7b84p+6"]),
    ("log_euler", 7, 4,
     ["0x1.8148a2p+6", "0x1.0147d2p+6", "0x1.08043ap+6", "0x1.15873ap+7"],
     ["0x1.d04344p+4", "0x1.950b6ep+6", "0x1.f1c0d4p+5", "0x1.69f966p+7"]),
    ("euler", 5, None,
     ["0x1.63a968p+6", "0x1.982052p+6", "0x1.4198bep+7", "0x1.39aad2p+6"],
     ["0x1.71de32p+3", "0x1.82538ap+7", "0x1.2dd69ep+7", "0x1.a2cb34p+6"]),
    ("euler", 6, 4,
     ["0x1.88c0a2p+6", "0x1.0a4f6cp+6", "0x1.5d5ad6p+6", "0x1.7fd07cp+6"],
     ["0x1.297512p+4", "0x1.0bc148p+7", "0x1.be1a94p+6", "0x1.3f975cp+6"]),
]


@pytest.mark.parametrize("scheme,steps,half,want0,want1", TERMINAL_PIN,
                         ids=["log_euler_16", "log_euler_7_anti", "euler_5", "euler_6_anti"])
def test_terminal_stream_is_pinned(scheme, steps, half, want0, want1) -> None:
    """Tier 1, exact: the gbm v1 TERMINAL stream does not move under a refactor."""
    c = torch.tensor([[100.0, 95.0, 1.0, 0.03, 0.01, 0.25], [80.0, 120.0, 2.0, 0.08, 0.0, 0.45]])
    keys = rng.fold_in(rng.prng_key(2024), torch.arange(2))
    out = gbm_cuda.simulate_terminal_rows_cuda_plain(
        c, keys, timesteps=steps, rows=8, cols=4, scheme=tgbm.PathScheme(scheme),
        antithetic_half=half, row_offset=2,
    )
    got = out[:, [0, 3, 5, 7], [0, 1, 2, 3]].double().numpy()
    want = np.array([[float.fromhex(v) for v in row] for row in (want0, want1)])
    np.testing.assert_array_equal(got, want)
