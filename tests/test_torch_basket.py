"""The port's basket family against the JAX package's.

(a) tier 1, exact: ``build_basket_spec``'s refusals (field and reason) and
    ``basket_cholesky``.
(b) tier 2, rtol 2e-5 (the normals differ by the ``erf_inv`` lowering's
    ulps, which the Cholesky mix and ``exp`` carry): the threefry simulator
    against ``simulate_basket_underlier_rows`` for every payoff × combine at
    rows 8, cols 32, A = 3 (flat, antithetic) and A = 1 (curved, plain);
    lookbacks measured against the strike, the variance swap and the cliquet
    against their own scale (0.01), where they cross zero or are small; the
    variance swap and the cliquet at rtol 1e-4 (their increments of ln B are
    differences of values near ln S, whose ulp is ~1e-5 of an increment);
    digital and barrier flips at the strike or the level counted.
(c) rtol 1e-6 (float64): ``expected_basket_underlier_mean`` for every payoff
    × combine, flat and curved, and ``has_closed_form_mean`` over the grid;
    ``geometric_basket_price`` against JAX's, and at one asset against
    ``black_scholes_price``.
(d) shard stability: rows ``[k, k + n)`` with ``row_offset=k`` are the same
    bits as those rows of the whole run.
(e) the trainer: a 3-step basket train on the threefry engine against the
    JAX ``GbmCVNNPricer`` from carried-over weights (``test_torch_slice.py``'s
    tolerances), ``predict_price`` against JAX, and a bit-exact
    snapshot/resume on the cuda engine's twin with the stream ``basket_gbm``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_payoffs import PAYOFF_KNOBS, _cvnn, _port_from_jax_snapshot, _train

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import analytic as ja
from spectralmc_tpu.ops import basket as jb
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import analytic as ta
from spectralmc_tpu_torch.ops import basket as tb
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

PAYOFFS = list(PAYOFF_KNOBS)
WEIGHTS = (0.5, 0.3, 0.2)
CORR = ((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0))
SPOT_M, VOL_M = (1.0, 1.1, 0.9), (1.0, 0.8, 1.2)
STEPS = 6
CURVES = dict(vol_shape=tuple(1.4 - 0.1 * i for i in range(STEPS)),
              rate_shape=tuple(0.5 + 0.2 * i for i in range(STEPS)),
              div_shape=tuple(1.3 - 0.1 * i for i in range(STEPS)))
LO = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
HI = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])


def _contracts(n: int, seed: int) -> np.ndarray:
    return (LO + (HI - LO) * np.random.default_rng(seed).random((n, 6))).astype(np.float32)


def _specs(combine: str, assets: int = 3):
    kw = dict(weights=WEIGHTS, correlation=CORR, spot_multipliers=SPOT_M, vol_multipliers=VOL_M)
    if assets == 1:
        kw = dict(weights=(1.0,), correlation=((1.0,),), spot_multipliers=(1.1,),
                  vol_multipliers=(0.9,))
    return (jb.build_basket_spec(**kw, combine=combine).expect("jax spec"),
            tb.build_basket_spec(**kw, combine=combine).expect("port spec"))


# --------------------------------------------------------------------------
# (a) the spec
# --------------------------------------------------------------------------

SPEC_REFUSALS = [
    dict(weights=(), correlation=()),
    dict(weights=(0.5, -0.5), correlation=((1.0, 0.0), (0.0, 1.0))),
    dict(weights=(0.5, 0.6), correlation=((1.0, 0.0), (0.0, 1.0))),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.0), (0.0, 1.0)), spot_multipliers=(1.0,)),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.0), (0.0, 1.0)), vol_multipliers=(1.0, 0.0)),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.0),)),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.3), (0.2, 1.0))),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.3), (0.3, 0.9))),
    dict(weights=(0.5, 0.5), correlation=((1.0, 1.5), (1.5, 1.0))),
    dict(weights=(0.5, 0.5), correlation=((1.0, 0.0), (0.0, 1.0)), combine="harmonic"),
]


@pytest.mark.parametrize("bad", SPEC_REFUSALS, ids=[str(i) for i in range(len(SPEC_REFUSALS))])
def test_build_basket_spec_refuses_as_jax_does(bad: dict) -> None:
    want = jb.build_basket_spec(**bad)
    got = tb.build_basket_spec(**bad)
    assert want.is_failure() and got.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)


@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
def test_spec_and_cholesky_match_jax(combine: str) -> None:
    js, ts = _specs(combine)
    assert ts.model_dump(mode="json") == js.model_dump(mode="json")
    assert ts.n_assets == js.n_assets == 3
    np.testing.assert_array_equal(tb.basket_cholesky(ts), jb.basket_cholesky(js))
    assert tb.basket_cholesky(ts) is tb.basket_cholesky(ts)  # cached


# --------------------------------------------------------------------------
# (b) the threefry simulator
# --------------------------------------------------------------------------


def _jax_rows(js, contracts: np.ndarray, payoff: str, **kw: object) -> np.ndarray:
    return np.stack([
        np.asarray(jb.simulate_basket_underlier_rows(
            jax.random.fold_in(jax.random.PRNGKey(3), i), jnp.asarray(c), spec=js,
            dtype=jnp.float32, payoff=jgbm.PayoffKind(payoff), **kw))
        for i, c in enumerate(contracts)
    ])


def _port_rows(ts, contracts: np.ndarray, payoff: str, **kw: object) -> np.ndarray:
    keys = rng.fold_in(rng.prng_key(3), torch.arange(len(contracts)))
    return tb.simulate_basket_underlier_rows(
        keys, torch.from_numpy(contracts), spec=ts, dtype=torch.float32,
        payoff=tgbm.PayoffKind(payoff), **kw).numpy()


def _assert_rows_close(got: np.ndarray, want: np.ndarray, payoff: str,
                       strike: np.ndarray) -> None:
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, strike[:, None, None])
    if payoff in ("variance_swap", "cliquet"):
        scale = np.maximum(scale, 0.01)
    # the variance swap and the cliquet take increments of ln B, each a
    # difference of two values near ln S ≈ 4.6 whose ulp (4.8e-7) is ~1e-5
    # of an increment
    rtol = 1e-4 if payoff in ("variance_swap", "cliquet") else 2e-5
    ok = np.abs(got - want) <= rtol * scale
    jumps = payoff == "digital" or payoff.startswith("barrier")
    assert np.sum(~ok) <= (2 if jumps else 0), np.max(np.abs(got - want) / scale)


@pytest.mark.parametrize("variant", ["a3_flat_anti", "a1_curved_plain"])
@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_threefry_simulator_matches_jax(payoff: str, combine: str, variant: str) -> None:
    js, ts = _specs(combine, assets=3 if variant.startswith("a3") else 1)
    contracts = _contracts(2, seed=5)
    kw = dict(timesteps=STEPS, rows=8, cols=32, **PAYOFF_KNOBS[payoff])
    jkw, tkw = dict(kw), dict(kw)
    if variant == "a3_flat_anti":
        jkw["antithetic_half"] = tkw["antithetic_half"] = 4
    else:
        jkw["term"], tkw["term"] = jgbm.TermStructure(**CURVES), tgbm.TermStructure(**CURVES)
    want = _jax_rows(js, contracts, payoff, **jkw)
    got = _port_rows(ts, contracts, payoff, **tkw)
    assert got.shape == want.shape == (2, 8, 32)
    _assert_rows_close(got, want, payoff, contracts[:, 1])


def test_row_offset_shards_reproduce_the_whole_run() -> None:
    """Tier 1, exact: rows 3..7 of a run equal a run of 5 rows at row_offset 3,
    antithetic pairing included (a pure function of the global row)."""
    _, ts = _specs("arithmetic")
    contracts = _contracts(2, seed=6)
    kw = dict(timesteps=4, cols=16, payoff="asian_arithmetic", antithetic_half=4)
    whole = _port_rows(ts, contracts, rows=8, **kw)
    shard = _port_rows(ts, contracts, rows=5, row_offset=3, **kw)
    np.testing.assert_array_equal(shard, whole[:, 3:])


# --------------------------------------------------------------------------
# (c) means, gates and the oracle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_expected_mean_and_closed_form_gate_match_jax(payoff: str, combine: str) -> None:
    js, ts = _specs(combine)
    contracts = _contracts(3, seed=2).astype(np.float64)
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items() if k != "barrier_rel"}
    model = "basket_gbm"
    assert tgbm.has_closed_form_mean(
        tgbm.ModelKind(model), tgbm.PayoffKind(payoff), combine=ts.combine
    ) == jgbm.has_closed_form_mean(jgbm.ModelKind(model), jgbm.PayoffKind(payoff),
                                   combine=js.combine)
    for curves in (None, CURVES):
        jt = None if curves is None else jgbm.TermStructure(**curves)
        tt = None if curves is None else tgbm.TermStructure(**curves)
        got = tb.expected_basket_underlier_mean(
            torch.from_numpy(contracts), ts, timesteps=STEPS, payoff=tgbm.PayoffKind(payoff),
            dtype=torch.float64, term=tt, **knobs)
        want = [jb.expected_basket_underlier_mean(
            jnp.asarray(c), js, timesteps=STEPS, payoff=jgbm.PayoffKind(payoff),
            dtype=jnp.float64, term=jt, **knobs) for c in contracts]
        if want[0] is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_geometric_basket_price_matches_jax_and_black_at_one_asset() -> None:
    js, ts = _specs("geometric")
    for c in _contracts(3, seed=8).astype(np.float64):
        got = ta.geometric_basket_price(*c, spec=ts)
        want = ja.geometric_basket_price(*(jnp.asarray(x) for x in c), spec=js)
        np.testing.assert_allclose([float(got.put), float(got.call)],
                                   [float(want.put), float(want.call)], rtol=1e-10)
        one = tb.build_basket_spec(weights=(1.0,), correlation=((1.0,),)).expect("one")
        single, black = ta.geometric_basket_price(*c, spec=one), ta.black_scholes_price(*c)
        np.testing.assert_allclose([float(single.put), float(single.call)],
                                   [float(black.put), float(black.call)], rtol=1e-12)
    g0, vol_eff, div_eff = tb.geometric_basket_effective_gbm(
        torch.tensor([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=torch.float64), ts)
    want = jb.geometric_basket_effective_gbm(
        jnp.asarray([100.0, 100.0, 1.0, 0.03, 0.01, 0.25]), js)
    np.testing.assert_allclose((g0, vol_eff, div_eff), want, rtol=1e-12)


BASKET_REFUSALS = [
    dict(model="basket_gbm"),
    dict(model="basket_gbm", basket="spec", scheme="euler"),
    dict(basket="spec"),
    dict(model="basket_gbm", basket="spec", payoff="digital"),
    dict(model="basket_gbm", basket="spec", payoff="variance_swap"),
    dict(model="basket_gbm", basket="spec", payoff="asian_geometric"),
]


@pytest.mark.parametrize("bad", BASKET_REFUSALS,
                         ids=[str(i) for i in range(len(BASKET_REFUSALS))])
def test_build_simulation_params_refuses_baskets_as_jax_does(bad: dict) -> None:
    """Field and reason equal (the arithmetic basket's MEAN refusals last)."""
    js, ts = _specs("arithmetic")
    base = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=0)
    want = jgbm.build_simulation_params(**base, **{**bad, **({"basket": js} if "basket" in bad
                                                             else {})})
    got = tgbm.build_simulation_params(**base, **{**bad, **({"basket": ts} if "basket" in bad
                                                            else {})})
    assert want.is_failure() and got.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)


@pytest.mark.parametrize("assets,engine", [(3, "cuda"), (8, "cuda"), (9, "xla")])
def test_cuda_engine_takes_one_to_eight_assets(assets: int, engine: str) -> None:
    corr = tuple(tuple(1.0 if i == j else 0.1 for j in range(assets)) for i in range(assets))
    spec = tb.build_basket_spec(weights=(1.0 / assets,) * assets, correlation=corr).expect("s")
    base = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=0,
                implementation="cuda", model="basket_gbm", basket=spec)
    sim = tgbm.build_simulation_params(**base).expect("sim")
    assert tgbm.resolve_implementation(sim).value == engine
    for xla in (dict(payoff="cliquet", normalization="none", **PAYOFF_KNOBS["cliquet"]),
                dict(term=tgbm.TermStructure(**{k: v[:4] for k, v in CURVES.items()}))):
        sim = tgbm.build_simulation_params(**base, **xla).expect("xla sim")
        assert tgbm.resolve_implementation(sim) == tgbm.SimImplementation.XLA


# --------------------------------------------------------------------------
# (e) the trainer
# --------------------------------------------------------------------------

SIM = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=7, model="basket_gbm")
BOUNDS = dict(zip(("spot", "strike", "maturity", "rate", "div_yield", "vol"), zip(LO, HI)))


def _jax_basket_pricer(combine: str, payoff: str) -> jtr.GbmCVNNPricer:
    js, _ = _specs(combine)
    norm = "mean" if jgbm.has_closed_form_mean(jgbm.ModelKind.BASKET_GBM,
                                               jgbm.PayoffKind(payoff),
                                               combine=js.combine) else "none"
    sim = jgbm.build_simulation_params(**SIM, basket=js, payoff=payoff, normalization=norm,
                                       antithetic=True, **PAYOFF_KNOBS[payoff]).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=float(lo), upper=float(hi))
              for k, (lo, hi) in BOUNDS.items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
def test_basket_slice_three_steps_match_jax(combine: str) -> None:
    """Tier 2 (``test_torch_slice.py``'s tolerances): losses rtol 1e-4, the
    weights after 3 steps atol 1e-5, TERMINAL with MEAN normalization to the
    basket's own mean; the spec rides in the checkpoint."""
    jp = _jax_basket_pricer(combine, "terminal")
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    assert tp.snapshot().sim.basket.combine.value == combine
    np.testing.assert_allclose(_train(tp, ttr, 3), _train(jp, jtr, 3), rtol=1e-4)
    port_snap, jax_snap = tp.snapshot(), jp.snapshot()
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sim.skip == jax_snap.sim.skip


@pytest.mark.parametrize("combine,payoff", [("arithmetic", "terminal"),
                                            ("arithmetic", "asian_geometric"),
                                            ("geometric", "variance_swap")])
def test_basket_predict_price_matches_jax(combine: str, payoff: str) -> None:
    """Same weights: puts rtol 1e-5; calls NaN where the combine has no
    closed-form mean, else parity (rtol 1e-5)."""
    jp = _jax_basket_pricer(combine, payoff)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    contracts = _contracts(5, seed=4)
    want, got = jp.predict_price(contracts), tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5, atol=1e-7)
    assert np.array_equal(np.isnan(got.call), np.isnan(want.call))
    np.testing.assert_allclose(got.call, want.call, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("payoff", ["terminal", "barrier_up_out", "forward_start"])
def test_cuda_engine_basket_resume_is_bit_exact_on_its_twin(payoff: str) -> None:
    """Tier 1, exact: snapshot → create → 2 more steps equals the continuous
    run on the basket kernel's twin; the stream recorded is ``basket_gbm``."""
    _, ts = _specs("arithmetic")
    norm = "mean" if payoff == "terminal" else "none"
    sim = tgbm.build_simulation_params(**SIM, basket=ts, payoff=payoff, normalization=norm,
                                       implementation="cuda", antithetic=True,
                                       **PAYOFF_KNOBS[payoff]).expect("sim")
    bounds = {k: tsobol.BoundSpec(lower=float(lo), upper=float(hi))
              for k, (lo, hi) in BOUNDS.items()}
    a = ttr.GbmCVNNPricer.create(ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf)),
                                 device="cpu").expect("a")
    before = gbm_cuda.LAUNCHES
    first = _train(a, ttr, 2)
    assert gbm_cuda.LAUNCHES == before  # CPU tensors run the twin
    snap = a.snapshot()
    assert snap.sim.implementation == tgbm.SimImplementation.CUDA
    assert snap.cuda_stream_version == gbm_cuda.CUDA_STREAM_VERSIONS["basket_gbm"] == 2
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))
    assert np.all(np.isfinite(first))
    pred = b.predict_price(_contracts(3, seed=1))
    assert np.all(np.isfinite(pred.put))
    assert np.all(np.isnan(pred.call)) == (payoff != "terminal")
