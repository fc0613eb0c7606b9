"""The port's Heston dynamics against the JAX package's.

(a) tier 2, rtol 2e-5: the threefry simulator against
    ``simulate_heston_underlier_rows`` for every payoff, with antithetic
    mirroring and rate/div curves on and off, on the same keys (the normals
    differ by the ``erf_inv`` lowering's ulps, which the √v feedback
    carries); lookback encodings measured against the strike, the cliquet
    against its cap, digital and barrier flips counted.
(b) rtol 1e-6 (float64): ``heston_expected_underlier_mean`` with and without
    curves; ``heston_char_fn`` and ``heston_call_price`` (rtol 1e-12: the
    same numpy); the contract model and its validation.
(c) the trainer: a 3-step slice on the threefry engine against the JAX
    ``GbmCVNNPricer`` from carried-over weights (10 inputs into 8 units;
    ``test_torch_slice.py``'s tolerances), ``predict_price`` against JAX
    including the NaN calls, and a bit-exact snapshot/resume on the cuda
    engine's twin per kernel branch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_payoffs import PAYOFF_KNOBS, _cvnn, _port_from_jax_snapshot, _train

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import heston as jh
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops import heston as th
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

PAYOFFS = list(PAYOFF_KNOBS)
LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.03, 1.0, 0.03, 0.2, -0.8])
HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.08, 2.5, 0.08, 0.5, -0.3])
STEPS = 6
CURVES = dict(rate_shape=tuple(0.5 + 0.2 * i for i in range(STEPS)),
              div_shape=tuple(1.3 - 0.1 * i for i in range(STEPS)))


def _contracts(n: int, seed: int) -> np.ndarray:
    return (LO + (HI - LO) * np.random.default_rng(seed).random((n, 10))).astype(np.float32)


def test_contract_model_matches_jax() -> None:
    assert jax.config.jax_threefry_partitionable
    assert th.HESTON_CONTRACT_FIELDS == jh.HESTON_CONTRACT_FIELDS
    assert th.HESTON_CONTRACT_DIM == jh.HESTON_CONTRACT_DIM == 10
    good = dict(zip(th.HESTON_CONTRACT_FIELDS, map(float, _contracts(1, 0)[0])))
    assert th.validate_heston_contract(th.HestonContract(**good)).is_success()
    for field, value in (("spot", 0.0), ("v0", -0.1), ("xi", 0.0), ("rho", 1.0), ("rho", -1.0)):
        bad = {**good, field: value}
        got = th.validate_heston_contract(th.HestonContract(**bad))
        want = jh.validate_heston_contract(jh.HestonContract(**bad))
        assert got.is_failure() and want.is_failure()
        assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)


@pytest.mark.parametrize("variant", ["anti_curved", "plain_flat"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_threefry_simulator_matches_jax(payoff: str, variant: str) -> None:
    contracts = _contracts(2, seed=11)
    rows, cols = 8, 16
    half = rows // 2 if variant == "anti_curved" else None
    curves = CURVES if variant == "anti_curved" else None
    knobs = PAYOFF_KNOBS[payoff]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(2)]
    want = np.stack([
        np.asarray(jh.simulate_heston_underlier_rows(
            k, jnp.asarray(c), timesteps=STEPS, rows=rows, cols=cols, dtype=jnp.float32,
            payoff=jgbm.PayoffKind(payoff), antithetic_half=half,
            term=jgbm.TermStructure(**curves) if curves else None, **knobs))
        for k, c in zip(keys, contracts)
    ])
    got = th.simulate_heston_underlier_rows(
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


def test_flat_term_is_the_same_program_bit_for_bit() -> None:
    c = torch.from_numpy(_contracts(2, seed=3))
    keys = rng.fold_in(rng.prng_key(1), torch.arange(2))
    kw = dict(timesteps=4, rows=4, cols=8, dtype=torch.float32,
              payoff=tgbm.PayoffKind.ASIAN_ARITHMETIC)
    flat = tgbm.TermStructure(rate_shape=(1.0,) * 4)
    assert torch.equal(th.simulate_heston_underlier_rows(keys, c, term=flat, **kw),
                       th.simulate_heston_underlier_rows(keys, c, **kw))
    # an American kind runs here as in the JAX simulator (its own forward is
    # ops/american.py's): rtol 2e-5, as for every payoff above
    got = th.simulate_heston_underlier_rows(
        keys, c, **{**kw, "payoff": tgbm.PayoffKind.AMERICAN_PUT}).numpy()
    want = np.stack([np.asarray(jh.simulate_heston_underlier_rows(
        jax.random.fold_in(jax.random.PRNGKey(1), d), jnp.asarray(c[d].numpy()), timesteps=4,
        rows=4, cols=8, dtype=jnp.float32, payoff=jgbm.PayoffKind.AMERICAN_PUT))
        for d in range(2)])
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_expected_underlier_mean_matches_jax(payoff: str, curved: bool) -> None:
    contracts = _contracts(3, seed=2).astype(np.float64)
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items() if k == "forward_start_step"}
    got = th.heston_expected_underlier_mean(
        torch.from_numpy(contracts), timesteps=STEPS, payoff=tgbm.PayoffKind(payoff),
        dtype=torch.float64, term=tgbm.TermStructure(**CURVES) if curved else None, **knobs)
    want = [jh.heston_expected_underlier_mean(
        jnp.asarray(c), timesteps=STEPS, payoff=jgbm.PayoffKind(payoff), dtype=jnp.float64,
        term=jgbm.TermStructure(**CURVES) if curved else None, **knobs) for c in contracts]
    assert (got is None) == (want[0] is None)
    assert (got is not None) == tgbm.has_closed_form_mean(tgbm.ModelKind.HESTON,
                                                          tgbm.PayoffKind(payoff))
    if got is not None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_char_fn_and_call_price_match_jax(seed: int) -> None:
    c = dict(zip(th.HESTON_CONTRACT_FIELDS, map(float, _contracts(1, seed)[0])))
    got = th.heston_call_price(**c, integration_points=512)
    want = jh.heston_call_price(**c, integration_points=512)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    cf = {k: v for k, v in c.items() if k != "strike"}
    u = np.array([0.0, 0.5, 3.0 - 1.0j, 40.0])
    np.testing.assert_allclose(th.heston_char_fn(u, **cf), jh.heston_char_fn(u, **cf), rtol=1e-12)
    assert abs(th.heston_char_fn(np.array([0.0]), **cf)[0] - 1.0) < 1e-12
    # parity holds by construction, and the call is worth more with more vol
    call, put = got
    df_r, df_q = np.exp(-c["rate"] * c["maturity"]), np.exp(-c["div_yield"] * c["maturity"])
    assert abs(call - put - (df_q * c["spot"] - df_r * c["strike"])) < 1e-9
    assert th.heston_call_price(**{**c, "v0": c["v0"] * 2, "theta": c["theta"] * 2},
                                integration_points=512)[0] > call


# --------------------------------------------------------------------------
# (c) the trainer
# --------------------------------------------------------------------------

SIM = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=7, antithetic=True,
           model="heston")
TERM4 = dict(rate_shape=(0.6, 0.9, 1.1, 1.4), div_shape=(1.2, 1.0, 1.0, 0.8))
# MEAN normalization needs the payoff's own closed-form mean
MEAN_OK = {"terminal", "asian_arithmetic", "forward_start"}
STRIKE_UNITS = {"variance_swap": (0.02, 0.10), "cliquet": (0.01, 0.08)}


def _bounds(payoff: str) -> dict[str, tuple[float, float]]:
    out = {f: (float(lo), float(hi)) for f, lo, hi in zip(th.HESTON_CONTRACT_FIELDS, LO, HI)}
    return {**out, "strike": STRIKE_UNITS.get(payoff, out["strike"])}


def _sim_kwargs(payoff: str, **over: object) -> dict[str, object]:
    return dict(SIM, payoff=payoff, normalization="mean" if payoff in MEAN_OK else "none",
                **PAYOFF_KNOBS[payoff], **over)


def _jax_pricer(payoff: str, term: dict | None = None) -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(
        **_sim_kwargs(payoff), term=jgbm.TermStructure(**term) if term else None).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def test_heston_slice_three_steps_match_jax() -> None:
    """Tier 2 (``test_torch_slice.py``'s tolerances): losses rtol 1e-4, the
    weights and batch-norm state after 3 steps atol 1e-5, TERMINAL under
    rate/div curves with MEAN normalization; the 10-wide first layer's
    weights cross through ``load_state_dict``."""
    jp = _jax_pricer("terminal", TERM4)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    assert tp.snapshot().sim.term == tgbm.TermStructure(**TERM4)
    first = next(v for k, v in tp.snapshot().model_state.items() if k.endswith("w_re"))
    assert sorted(first.shape) == [8, 10]
    np.testing.assert_allclose(_train(tp, ttr, 3), _train(jp, jtr, 3), rtol=1e-4)
    port_snap, jax_snap = tp.snapshot(), jp.snapshot()
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sim.skip == jax_snap.sim.skip
    assert port_snap.optimizer_state.count == jax_snap.optimizer_state.count


@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "barrier_up_out",
                                    "lookback_float_call", "variance_swap", "forward_start",
                                    "digital", "cliquet"])
def test_cuda_engine_resume_is_bit_exact_on_its_twin(payoff: str) -> None:
    """Tier 1, exact: snapshot → create → 2 more steps equals the continuous
    run on the Heston twin; the stream recorded is ``heston`` v1, except for
    the cliquet, which the scan runs (engine ``xla``, version 0)."""
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
        assert snap.cuda_stream_version == gbm_cuda.CUDA_STREAM_VERSIONS["heston"]
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_predict_price_nan_and_parity_match_jax(payoff: str) -> None:
    """Same weights in both packages: puts rtol 1e-5; calls NaN exactly where
    Heston has no closed-form mean, else parity on it (rtol 1e-5; 2e-4 for
    the arithmetic Asian's cancelling float32 series, of the strike), discounted at the
    curve-effective rate for the TERMINAL pricer, which runs under curves."""
    term = TERM4 if payoff == "terminal" else None
    jp = _jax_pricer(payoff, term)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    b = _bounds(payoff)
    lo, hi = np.array([v[0] for v in b.values()]), np.array([v[1] for v in b.values()])
    contracts = (lo + (hi - lo) * np.random.default_rng(4).random((5, 10))).astype(np.float32)
    want, got = jp.predict_price(contracts), tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5, atol=1e-7)
    parity = tgbm.has_closed_form_mean(tgbm.ModelKind.HESTON, tgbm.PayoffKind(payoff))
    assert parity == (payoff in MEAN_OK)
    assert np.all(np.isnan(got.call)) == (not parity) == bool(np.all(np.isnan(want.call)))
    if parity and payoff == "asian_arithmetic":
        # one ulp of g = e^{(r−q)dt} is ≈ 1e-4 of the series mean (see
        # test_torch_payoffs.py), and these calls pass through zero
        assert np.all(np.abs(got.call - want.call) <= 2e-4 * contracts[:, 1])
    elif parity:
        np.testing.assert_allclose(got.call, want.call, rtol=1e-5, atol=1e-6)
    if parity:
        listed = tp.predict_price([th.HestonContract(**dict(zip(th.HESTON_CONTRACT_FIELDS,
                                                                map(float, c))))
                                   for c in contracts])
        np.testing.assert_array_equal(listed.put, got.put)
