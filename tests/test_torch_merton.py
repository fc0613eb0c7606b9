"""The port's Merton jump-diffusion dynamics against the JAX package's.

(a) ``merton_jump_counts`` against ``jax.random.poisson`` (Knuth's loop for
    ``lam·dt < 10``, transformed rejection above): the same threefry key
    chain and bit-exact uniforms, so the integer counts are equal wherever a
    float32 ``log`` or ``lgamma`` does not land within ulps of an acceptance
    edge (torch's and XLA's differ by ulps): at most 1 draw in 2,000 may
    differ, and here none does; the sample mean and variance lie within 4
    standard errors of ``lam``.
(b) tier 2, rtol 2e-5: the threefry simulator against
    ``simulate_merton_underlier_rows`` for every payoff, with antithetic
    mirroring and curves on and off, on paths whose counts agree (all of
    them here); lookback encodings measured against the strike, the cliquet
    against its cap, digital and barrier flips counted.
(c) rtol 1e-6 (float64): ``merton_expected_underlier_mean`` with and
    without curves, incl. the digital, variance and cliquet series;
    ``merton_call_price`` (rtol 1e-12) and its ``lam = 0`` Black identity.
(d) the trainer: a 3-step slice on the threefry engine against the JAX
    ``GbmCVNNPricer`` from carried-over weights (9 inputs into 8 units),
    ``predict_price`` against JAX, and a bit-exact snapshot/resume on the
    cuda engine's twin per kernel branch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_payoffs import NO_MEAN, PAYOFF_KNOBS, _cvnn, _port_from_jax_snapshot, _train

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import merton as jm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import analytic as ta
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops import merton as tm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

PAYOFFS = list(PAYOFF_KNOBS)
LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15, 0.1, -0.15, 0.1])
HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.25, 0.8, 0.0, 0.25])
STEPS = 6
CURVES = dict(vol_shape=tuple(1.4 - 0.1 * i for i in range(STEPS)),
              rate_shape=tuple(0.5 + 0.2 * i for i in range(STEPS)),
              div_shape=tuple(1.3 - 0.1 * i for i in range(STEPS)))


def _contracts(n: int, seed: int) -> np.ndarray:
    return (LO + (HI - LO) * np.random.default_rng(seed).random((n, 9))).astype(np.float32)


def test_contract_model_matches_jax() -> None:
    assert jax.config.jax_threefry_partitionable
    assert tm.MERTON_CONTRACT_FIELDS == jm.MERTON_CONTRACT_FIELDS
    assert tm.MERTON_CONTRACT_DIM == jm.MERTON_CONTRACT_DIM == 9
    good = dict(zip(tm.MERTON_CONTRACT_FIELDS, map(float, _contracts(1, 0)[0])))
    assert tm.validate_merton_contract(tm.MertonContract(**good)).is_success()
    assert tm.validate_merton_contract(tm.MertonContract(**{**good, "lam": 0.0})).is_success()
    for field, value in (("spot", 0.0), ("vol", 0.0), ("jump_std", -0.1), ("lam", -0.5)):
        bad = {**good, field: value}
        got = tm.validate_merton_contract(tm.MertonContract(**bad))
        want = jm.validate_merton_contract(jm.MertonContract(**bad))
        assert got.is_failure() and want.is_failure()
        assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)


@pytest.mark.parametrize("lam_dt", [0.0, 0.02, 0.3, 1.0, 3.0, 9.5])
def test_jump_counts_match_jax_random_poisson(lam_dt: float) -> None:
    rows, cols = 6, 200
    base = jax.random.PRNGKey(11)
    row_keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.arange(rows, dtype=jnp.uint32))
    want = np.asarray(jm.merton_jump_counts(row_keys, jnp.int32(3), jnp.float32(lam_dt), cols,
                                            jnp.float32))
    keys = rng.fold_in(rng.prng_key(11), torch.arange(rows))
    got = tm.merton_jump_counts(keys, 3, torch.tensor([lam_dt]), cols, torch.float32).numpy()
    assert got.shape == want.shape == (rows, cols)
    assert np.array_equal(got, np.round(got)) and got.min() >= 0
    assert np.mean(got != want) <= 5e-4
    assert abs(got.mean() - lam_dt) < 4 * np.sqrt(max(lam_dt, 1e-9) / got.size) + 1e-9


def test_a_step_rate_of_ten_or_more_is_refused() -> None:
    """No longer refused: a rate of 10 or more takes the rejection branch
    and gives ``jax.random.poisson``'s counts."""
    base = jax.random.PRNGKey(1)
    row_keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.arange(2, dtype=jnp.uint32))
    want = np.asarray(jm.merton_jump_counts(row_keys, jnp.int32(0), jnp.float32(10.0), 4,
                                            jnp.float32))
    keys = rng.fold_in(rng.prng_key(1), torch.arange(2))
    got = tm.merton_jump_counts(keys, 0, torch.tensor([10.0]), 4, torch.float32).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lam", [10.0, 12.0, 30.0, 100.0, 1e3])
def test_rejection_counts_match_jax_random_poisson(lam: float) -> None:
    """Hörmann's transformed rejection, key for key: at most 1 count in 2,000
    may differ, and the sample mean and variance lie within 4 standard
    errors of ``lam`` (the variance's SE is ``lam·sqrt(2/n)`` to leading
    order)."""
    rows, cols = 8, 250
    keys_j = jax.vmap(lambda r: jax.random.fold_in(jax.random.PRNGKey(5), r))(
        jnp.arange(rows, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.poisson(k, jnp.float32(lam), (cols,)))(keys_j))
    keys = rng.fold_in(rng.prng_key(5), torch.arange(rows))
    got = tm.poisson(keys, torch.tensor([lam]), cols).numpy()
    assert got.shape == want.shape == (rows, cols)
    assert np.mean(got != want) <= 5e-4
    n = got.size
    assert abs(got.mean() - lam) < 4 * np.sqrt(lam / n)
    assert abs(got.var() - lam) < 4 * lam * np.sqrt(2.0 / n)


def test_poisson_mixes_branches_per_key_as_jax_does() -> None:
    """Rates on both sides of 10 (and 0) in one call: each key takes its own
    branch, and a Knuth key's counts are those of a call without the others."""
    lams = np.array([0.0, 3.0, 10.0, 40.0], dtype=np.float32)
    keys_j = jax.vmap(lambda r: jax.random.fold_in(jax.random.PRNGKey(9), r))(
        jnp.arange(4, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(lambda k, lam: jax.random.poisson(k, lam, (64,)))(
        keys_j, jnp.asarray(lams)))
    keys = rng.fold_in(rng.prng_key(9), torch.arange(4))
    got = tm.poisson(keys, torch.from_numpy(lams)[:, None], 64).numpy()
    assert np.array_equal(got, want)
    alone = tm.poisson(keys[1:2], torch.tensor([[3.0]]), 64).numpy()
    assert np.array_equal(alone, got[1:2])


@pytest.mark.parametrize("variant", ["anti_curved", "plain_flat"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_threefry_simulator_matches_jax(payoff: str, variant: str) -> None:
    contracts = _contracts(2, seed=11)
    contracts[:, 6] *= 4.0  # lam up to 3.2: jumps on most paths
    rows, cols = 8, 16
    half = rows // 2 if variant == "anti_curved" else None
    curves = CURVES if variant == "anti_curved" else None
    knobs = PAYOFF_KNOBS[payoff]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(2)]
    want = np.stack([
        np.asarray(jm.simulate_merton_underlier_rows(
            k, jnp.asarray(c), timesteps=STEPS, rows=rows, cols=cols, dtype=jnp.float32,
            payoff=jgbm.PayoffKind(payoff), antithetic_half=half,
            term=jgbm.TermStructure(**curves) if curves else None, **knobs))
        for k, c in zip(keys, contracts)
    ])
    got = tm.simulate_merton_underlier_rows(
        rng.fold_in(rng.prng_key(5), torch.arange(2)), torch.from_numpy(contracts),
        timesteps=STEPS, rows=rows, cols=cols, dtype=torch.float32,
        payoff=tgbm.PayoffKind(payoff), antithetic_half=half,
        term=tgbm.TermStructure(**curves) if curves else None, **knobs,
    ).numpy()
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, contracts[:, 1, None, None])
    if payoff == "cliquet":
        scale = np.maximum(scale, knobs["cliquet_cap"])
    far = int((np.abs(got - want) > 2e-5 * scale).sum())
    assert far <= (1 if payoff == "digital" or payoff.startswith("barrier") else 0)


def test_flat_term_is_the_same_program_and_antithetic_pairs_share_counts() -> None:
    c = torch.from_numpy(_contracts(2, seed=3))
    c[:, 6] = 3.0
    keys = rng.fold_in(rng.prng_key(1), torch.arange(2))
    kw = dict(timesteps=4, rows=4, cols=8, dtype=torch.float32, payoff=tgbm.PayoffKind.TERMINAL)
    flat = tgbm.TermStructure(vol_shape=(1.0,) * 4)
    assert torch.equal(tm.simulate_merton_underlier_rows(keys, c, term=flat, **kw),
                       tm.simulate_merton_underlier_rows(keys, c, **kw))
    quiet = c.clone()
    quiet[:, 5], quiet[:, 8] = 0.0, 0.0  # no Gaussian left: only the shared counts move S
    out = tm.simulate_merton_underlier_rows(keys, quiet, antithetic_half=2, **kw)
    assert torch.equal(out[:, :2], out[:, 2:]) and len(torch.unique(out)) > 2
    # an American kind runs here as in the JAX simulator (its own forward is
    # ops/american.py's): rtol 2e-5, as for every payoff above
    got = tm.simulate_merton_underlier_rows(
        keys, c, **{**kw, "payoff": tgbm.PayoffKind.AMERICAN_CALL}).numpy()
    want = np.stack([np.asarray(jm.simulate_merton_underlier_rows(
        jax.random.fold_in(jax.random.PRNGKey(1), d), jnp.asarray(c[d].numpy()), timesteps=4,
        rows=4, cols=8, dtype=jnp.float32, payoff=jgbm.PayoffKind.AMERICAN_CALL))
        for d in range(2)])
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_expected_underlier_mean_matches_jax(payoff: str, curved: bool) -> None:
    contracts = _contracts(3, seed=2).astype(np.float64)
    contracts[2, 6] = 0.0  # lam = 0: the series collapse to the point mass
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items() if k != "barrier_rel"}
    got = tm.merton_expected_underlier_mean(
        torch.from_numpy(contracts), timesteps=STEPS, payoff=tgbm.PayoffKind(payoff),
        dtype=torch.float64, term=tgbm.TermStructure(**CURVES) if curved else None, **knobs)
    want = [jm.merton_expected_underlier_mean(
        jnp.asarray(c), timesteps=STEPS, payoff=jgbm.PayoffKind(payoff), dtype=jnp.float64,
        term=jgbm.TermStructure(**CURVES) if curved else None, **knobs) for c in contracts]
    assert (got is None) == (want[0] is None)
    assert (got is not None) == tgbm.has_closed_form_mean(tgbm.ModelKind.MERTON_JUMP,
                                                          tgbm.PayoffKind(payoff))
    if got is not None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_call_price_matches_jax_and_black_at_zero_intensity(seed: int) -> None:
    c = dict(zip(tm.MERTON_CONTRACT_FIELDS, map(float, _contracts(1, seed)[0])))
    np.testing.assert_allclose(tm.merton_call_price(**c), jm.merton_call_price(**c), rtol=1e-12)
    np.testing.assert_allclose(tm.merton_call_price(**c, max_terms=5),
                               jm.merton_call_price(**c, max_terms=5), rtol=1e-12)
    call, put = tm.merton_call_price(**{**c, "lam": 0.0})
    black = ta.black_scholes_price(*(c[k] for k in tm.MERTON_CONTRACT_FIELDS[:6]))
    np.testing.assert_allclose([call, put], [float(black.call), float(black.put)], rtol=1e-10)


# --------------------------------------------------------------------------
# (d) the trainer
# --------------------------------------------------------------------------

SIM = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=7, antithetic=True,
           model="merton_jump")
TERM4 = dict(vol_shape=(1.3, 1.1, 0.9, 0.8), rate_shape=(0.6, 0.9, 1.1, 1.4))
NO_MEAN_MERTON = NO_MEAN | {"asian_geometric"}
STRIKE_UNITS = {"variance_swap": (0.02, 0.10), "cliquet": (0.01, 0.08)}


def _bounds(payoff: str) -> dict[str, tuple[float, float]]:
    out = {f: (float(lo), float(hi)) for f, lo, hi in zip(tm.MERTON_CONTRACT_FIELDS, LO, HI)}
    return {**out, "strike": STRIKE_UNITS.get(payoff, out["strike"])}


def _sim_kwargs(payoff: str, **over: object) -> dict[str, object]:
    return dict(SIM, payoff=payoff, normalization="none" if payoff in NO_MEAN_MERTON else "mean",
                **PAYOFF_KNOBS[payoff], **over)


def _jax_pricer(payoff: str, term: dict | None = None) -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(
        **_sim_kwargs(payoff), term=jgbm.TermStructure(**term) if term else None).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def test_merton_slice_three_steps_match_jax() -> None:
    """Tier 2 (``test_torch_slice.py``'s tolerances): losses rtol 1e-4, the
    weights and batch-norm state after 3 steps atol 1e-5, on the arithmetic
    Asian with MEAN normalization; the 9-wide first layer's weights cross
    through ``load_state_dict``."""
    jp = _jax_pricer("asian_arithmetic")
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    first = next(v for k, v in tp.snapshot().model_state.items() if k.endswith("w_re"))
    assert sorted(first.shape) == [8, 9]
    np.testing.assert_allclose(_train(tp, ttr, 3), _train(jp, jtr, 3), rtol=1e-4)
    port_snap, jax_snap = tp.snapshot(), jp.snapshot()
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sim.skip == jax_snap.sim.skip
    assert port_snap.optimizer_state.count == jax_snap.optimizer_state.count


@pytest.mark.parametrize("payoff", ["terminal", "asian_arithmetic", "barrier_down_out",
                                    "lookback_fixed_call", "variance_swap", "forward_start",
                                    "digital", "cliquet"])
def test_cuda_engine_resume_is_bit_exact_on_its_twin(payoff: str) -> None:
    """Tier 1, exact: snapshot → create → 2 more steps equals the continuous
    run on the Merton twin; the stream recorded is ``merton_jump`` v2, except
    for the cliquet, which the scan runs (engine ``xla``, version 0)."""
    sim = tgbm.build_simulation_params(**_sim_kwargs(payoff), implementation="cuda").expect("s")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf), normalize_inputs=True)
    a = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("a")
    before = gbm_cuda.LAUNCHES
    first = _train(a, ttr, 2)
    assert gbm_cuda.LAUNCHES == before and np.all(np.isfinite(first))
    snap = a.snapshot()
    if payoff == "cliquet":
        assert (snap.sim.implementation, snap.cuda_stream_version) == \
            (tgbm.SimImplementation.XLA, 0)
    else:
        assert snap.sim.implementation == tgbm.SimImplementation.CUDA
        assert snap.cuda_stream_version == gbm_cuda.CUDA_STREAM_VERSIONS["merton_jump"]
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_predict_price_nan_and_parity_match_jax(payoff: str) -> None:
    """Same weights in both packages: puts rtol 1e-5; calls NaN exactly where
    Merton has no closed-form mean (barrier, lookback, geometric Asian), else
    parity on it (rtol 1e-5, atol 1e-5 for the float32 series; 2e-4 of the
    strike for the arithmetic Asian), the TERMINAL pricer under curves."""
    term = TERM4 if payoff == "terminal" else None
    jp = _jax_pricer(payoff, term)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    b = _bounds(payoff)
    lo, hi = np.array([v[0] for v in b.values()]), np.array([v[1] for v in b.values()])
    contracts = (lo + (hi - lo) * np.random.default_rng(4).random((5, 9))).astype(np.float32)
    want, got = jp.predict_price(contracts), tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5, atol=1e-7)
    parity = tgbm.has_closed_form_mean(tgbm.ModelKind.MERTON_JUMP, tgbm.PayoffKind(payoff))
    assert np.all(np.isnan(got.call)) == (not parity) == bool(np.all(np.isnan(want.call)))
    if parity and payoff == "asian_arithmetic":
        assert np.all(np.abs(got.call - want.call) <= 2e-4 * contracts[:, 1])
    elif parity:
        np.testing.assert_allclose(got.call, want.call, rtol=1e-5, atol=1e-5)
