"""The port's pricing facade and the learned pricer's Greeks against the JAX
package's: ``analytic.implied_vol``, ``analytic_greeks``, the ``BlackScholes``
engine with ``simulate_terminal``, ``HostPrices`` and ``validate_contract``,
the contracts' ``as_array``, and ``GbmCVNNPricer.predict_greeks`` on weights
carried over from a JAX pricer's snapshot. Tiers and tolerances are in each
test's docstring.
"""

from __future__ import annotations

import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import analytic as janalytic
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import greeks as jgreeks
from spectralmc_tpu.ops import heston as jheston
from spectralmc_tpu.ops import merton as jmerton
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.core.errors.gbm import InvalidContract
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.core.result import Failure, Success
from spectralmc_tpu_torch.ops import analytic as tanalytic
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import greeks as tgreeks
from spectralmc_tpu_torch.ops import heston as theston
from spectralmc_tpu_torch.ops import merton as tmerton
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.ops.dispatch import make_mean_target
from spectralmc_tpu_torch.training import trainer as ttr
from test_torch_greeks import _one_torch_thread  # noqa: F401 — an autouse fixture
from test_torch_slice import BOUNDS, _cvnn, _port_from_jax_snapshot, _train
from test_torch_slice import SIM as SLICE_SIM

CONTRACT = dict(spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25)


# --------------------------------------------------------------------------
# implied_vol and the closed-form Greeks
# --------------------------------------------------------------------------


def test_implied_vol_round_trip_matches_jax() -> None:
    """Tier 2, float64: on a vol × moneyness grid, both sides, as one batch,
    the port's implied vol equals JAX's to rtol 1e-10 and inverts the port's
    Black price to the vol (abs 1e-10); Python numbers solve in float64."""
    vol, strike = (g.ravel() for g in np.meshgrid([0.08, 0.25, 0.9], [80.0, 100.0, 125.0]))
    p = tanalytic.black_scholes_price(100.0, torch.tensor(strike), 1.0, 0.03, 0.01,
                                      torch.tensor(vol))
    for option, price in (("call", p.call), ("put", p.put)):
        got = tanalytic.implied_vol(price, 100.0, torch.tensor(strike), 1.0, 0.03, 0.01,
                                    option=option)
        want = janalytic.implied_vol(jnp.asarray(price.numpy()), 100.0, jnp.asarray(strike),
                                     1.0, 0.03, 0.01, option=option)
        assert got.dtype == torch.float64 and got.shape == (9,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, err_msg=option)
        np.testing.assert_allclose(got.numpy(), vol, atol=1e-10, err_msg=option)
    one = float(tanalytic.implied_vol(float(p.call[4]), 100.0, 100.0, 1.0, 0.03, 0.01))
    assert one == pytest.approx(0.25, abs=1e-10)


def test_implied_vol_nan_bounds_match_jax() -> None:
    """Tier 1: NaN below the intrinsic, at or above the upper bound and past
    the bracket's ceiling (a true vol of 6 > hi), as in the JAX package; a
    float32 batch stays float32 and agrees with JAX's float32 solve to the
    float32 bracket's resolution (abs 1e-6)."""
    df_f = float(np.exp(-0.03) * 100.0 * np.exp(0.02))
    extreme = float(tanalytic.black_scholes_price(100.0, 100.0, 1.0, 0.03, 0.01, 6.0).call)
    for price, strike, option in ((0.0, 80.0, "call"), (df_f + 1.0, 80.0, "call"),
                                  (extreme, 100.0, "call"), (0.0, 120.0, "put")):
        got = float(tanalytic.implied_vol(price, 100.0, strike, 1.0, 0.03, 0.01, option=option))
        want = float(janalytic.implied_vol(price, 100.0, strike, 1.0, 0.03, 0.01, option=option))
        assert math.isnan(got) and math.isnan(want), (price, strike, option)
    prices32 = np.array([4.0, 9.5, 15.0], dtype=np.float32)
    got = tanalytic.implied_vol(torch.from_numpy(prices32), 100.0, 100.0, 1.0, 0.03, 0.01)
    want = janalytic.implied_vol(jnp.asarray(prices32), 100.0, 100.0, 1.0, 0.03, 0.01)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("payoff,option", [("terminal", "put"), ("terminal", "call"),
                                           ("asian_geometric", "call")])
def test_analytic_greeks_match_jax(payoff: str, option: str) -> None:
    """Tier 2, float64: price, every field and gamma (a second derivative)
    of the closed forms by autograd, port vs JAX's ``jax.grad``, rtol 1e-10."""
    kw = dict(payoff=tgbm.PayoffKind(payoff), timesteps=12)
    got = tgreeks.analytic_greeks(tgbm.BlackScholesContract(**CONTRACT),
                                  option=tgreeks.OptionSide(option), device="cpu", **kw)
    want = jgreeks.analytic_greeks(jgbm.BlackScholesContract(**CONTRACT),
                                   option=jgreeks.OptionSide(option),
                                   payoff=jgbm.PayoffKind(payoff), timesteps=12,
                                   dtype=jnp.float64)
    assert got.price == pytest.approx(want.price, rel=1e-10)
    for field, value in want.by_field.items():
        assert got.by_field[field] == pytest.approx(value, rel=1e-10, abs=1e-13), field
    assert got.gamma == pytest.approx(want.gamma, rel=1e-10)
    assert got.engine == tgbm.SimImplementation.XLA
    assert got.delta == got.by_field["spot"] and got.theta == -got.by_field["maturity"]
    assert got.vega == got.by_field["vol"] and got.rho == got.by_field["rate"]
    assert got.dual_delta == got.by_field["strike"] and got.div_rho == got.by_field["div_yield"]


# --------------------------------------------------------------------------
# The BlackScholes facade
# --------------------------------------------------------------------------

FACADE_CASES = {
    "terminal-mean": dict(),
    "asian-arithmetic": dict(payoff="asian_arithmetic", normalization="none"),
    "barrier": dict(payoff="barrier_up_out", barrier_rel=1.3, normalization="none"),
    "antithetic": dict(antithetic=True),
    "curved-term": dict(term=dict(vol_shape=(1.2, 0.8, 1.0, 1.0), rate_shape=(1.5, 0.5, 1.0, 1.0))),
    "american-put": dict(payoff="american_put", normalization="none"),
}


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_black_scholes_price_matches_jax(case: str) -> None:
    """Tier 2, float32 on the threefry engine: ``BlackScholes.price`` and
    ``price_to_host`` port vs JAX at rtol 1e-5 — the payoff vectors with an
    absolute floor of 1e-5 of the strike, the underliers' own rtol 1e-5
    (the normals' ``erf_inv`` ulps, ``test_torch_gbm.py`` (a)) carried into
    ``df·max(±(S − K), 0)``, which cancels near the strike; the American put
    at the host means only, rtol 2e-3 (the estimators' sums flip exercise
    decisions, ROADMAP Queue 3). The engine comes back advanced by one
    ``skip`` and prices the next draw; ``snapshot`` is the params."""
    kw = dict(FACADE_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "term" in kw:
        jkw["term"], tkw["term"] = jgbm.TermStructure(**kw["term"]), tgbm.TermStructure(**kw["term"])
    shape = dict(timesteps=4, network_size=64, batches_per_mc_run=8, mc_seed=3, skip=2)
    jsim = jgbm.build_simulation_params(**shape, **jkw).expect("jax")
    tsim = tgbm.build_simulation_params(**shape, **tkw).expect("port")
    jengine, tengine = jgbm.BlackScholes(jsim), tgbm.BlackScholes(tsim, device="cpu")
    jc, tc = jgbm.BlackScholesContract(**CONTRACT), tgbm.BlackScholesContract(**CONTRACT)
    jp, jnext = jengine.price(jc)
    tp, tnext = tengine.price(tc)
    american = case == "american-put"
    if not american:
        floor = 1e-5 * CONTRACT["strike"]
        np.testing.assert_allclose(tp.put_payoffs.numpy(), np.asarray(jp.put_payoffs), rtol=1e-5,
                                   atol=floor)
        np.testing.assert_allclose(tp.call_payoffs.numpy(), np.asarray(jp.call_payoffs),
                                   rtol=1e-5, atol=floor)
    assert float(tp.forward) == pytest.approx(float(jp.forward), rel=1e-6)
    assert float(tp.discount_factor) == pytest.approx(float(jp.discount_factor), rel=1e-6)
    assert tnext.params.skip == jnext.params.skip == 3 and tnext.snapshot() == tnext.params
    assert tnext.device == tengine.device
    jh, _ = jnext.price_to_host(jc)
    th, after = tnext.price_to_host(tc)
    assert after.params.skip == 4
    for field in ("put", "call", "put_intrinsic", "call_intrinsic", "put_convexity",
                  "call_convexity", "forward", "discount_factor"):
        want = getattr(jh, field)
        tol = 2e-3 if american and field in ("put", "call", "put_convexity", "call_convexity") \
            else 1e-5
        assert getattr(th, field) == pytest.approx(want, rel=tol, abs=1e-6), field
    assert isinstance(th, tgbm.HostPrices)


def test_black_scholes_keys_and_simulate_terminal_match_jax() -> None:
    """Tier 1 on the key words (integer threefry) and tier 2 on the paths:
    ``contract_key`` equals JAX's words, ``BlackScholes.simulate_terminal``
    and the module's ``simulate_terminal`` equal JAX's at rtol 1e-5 (the
    normals' ulps, ``test_torch_gbm.py`` (a)); on a ``"cuda"`` sim the facade runs kernel #1's
    TERMINAL branch (its twin here)."""
    shape = dict(timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=11)
    jsim = jgbm.build_simulation_params(**shape).expect("jax")
    tsim = tgbm.build_simulation_params(**shape).expect("port")
    jengine, tengine = jgbm.BlackScholes(jsim), tgbm.BlackScholes(tsim, device="cpu")
    for draw in (0, 5, 2**31 + 7):
        want = np.asarray(jengine.contract_key(draw)).astype(np.int64)
        assert tengine.contract_key(draw).tolist() == want.tolist()
    jc = jgbm.BlackScholesContract(**CONTRACT).as_array(jnp.float32)
    tc = tgbm.BlackScholesContract(**CONTRACT).as_array(torch.float32, "cpu")
    np.testing.assert_allclose(tengine.simulate_terminal(tc, 5).numpy(),
                               np.asarray(jengine.simulate_terminal(jc, 5)), rtol=1e-5)
    kw = dict(timesteps=4, batches=8, network_size=32, scheme=tgbm.PathScheme.LOG_EULER)
    got = tgbm.simulate_terminal(tengine.contract_key(5), tc, dtype=torch.float32, **kw)
    want = jgbm.simulate_terminal(jengine.contract_key(5), jc, dtype=jnp.float32,
                                  **{**kw, "scheme": jgbm.PathScheme.LOG_EULER})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    cuda = tgbm.BlackScholes(tsim.model_copy(update={"implementation": tgbm.SimImplementation.CUDA}),
                            device="cpu")
    from spectralmc_tpu_torch.ops import gbm_cuda

    words = cuda.contract_key(5).reshape(1, 2)
    twin = gbm_cuda.simulate_terminal_rows_cuda_plain(
        tc[None], words, timesteps=4, rows=8, cols=32, scheme=tgbm.PathScheme.LOG_EULER)
    assert torch.equal(cuda.simulate_terminal(tc, 5), twin.reshape(-1))


def test_black_scholes_refuses_non_gbm_like_jax() -> None:
    """Tier 1: a Heston sim is refused with JAX's exception and message."""
    shape = dict(timesteps=4, network_size=16, batches_per_mc_run=4, mc_seed=1, model="heston")
    with pytest.raises(ValueError) as jexc:
        jgbm.BlackScholes(jgbm.build_simulation_params(**shape).expect("jax"))
    with pytest.raises(ValueError) as texc:
        tgbm.BlackScholes(tgbm.build_simulation_params(**shape).expect("port"), device="cpu")
    assert str(texc.value) == str(jexc.value)


def test_contract_vectors_and_validation_match_jax() -> None:
    """Tier 1: ``CONTRACT_FIELDS``, each contract's ``as_array`` (float32 and
    float64, exact) and ``validate_contract``'s field, value and reason."""
    assert tgbm.CONTRACT_FIELDS == jgbm.CONTRACT_FIELDS and tgbm.CONTRACT_DIM == 6
    heston = dict(spot=100.0, strike=95.0, maturity=1.0, rate=0.03, div_yield=0.01, v0=0.04,
                  kappa=1.5, theta=0.05, xi=0.3, rho=-0.6)
    merton = dict(CONTRACT, lam=0.4, jump_mean=-0.1, jump_std=0.15)
    for jcls, tcls, fields in ((jgbm.BlackScholesContract, tgbm.BlackScholesContract, CONTRACT),
                               (jheston.HestonContract, theston.HestonContract, heston),
                               (jmerton.MertonContract, tmerton.MertonContract, merton)):
        for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
            got = tcls(**fields).as_array(td, "cpu")
            assert got.dtype == td
            np.testing.assert_array_equal(got.numpy(), np.asarray(jcls(**fields).as_array(jd)))
    assert isinstance(tgbm.validate_contract(tgbm.BlackScholesContract(**CONTRACT)), Success)
    for field in ("spot", "strike", "maturity", "vol"):
        bad = {**CONTRACT, field: 0.0}
        got = tgbm.validate_contract(tgbm.BlackScholesContract(**bad))
        want = jgbm.validate_contract(jgbm.BlackScholesContract(**bad))
        assert isinstance(got, Failure) and isinstance(got.error, InvalidContract)
        assert (got.error.field, got.error.value, got.error.reason) == (
            want.error.field, want.error.value, want.error.reason)


# --------------------------------------------------------------------------
# predict_greeks on weights carried over from a JAX pricer
# --------------------------------------------------------------------------


def _held_out(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    lo = np.array([b[0] for b in BOUNDS.values()])
    hi = np.array([b[1] for b in BOUNDS.values()])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


def _jax_pricer(**sim_overrides: object) -> jtr.GbmCVNNPricer:
    """A JAX pricer with the slice test's head (batch norm, residual)."""
    sim = jgbm.build_simulation_params(**{**SLICE_SIM, **sim_overrides}).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def _port_of(jp: jtr.GbmCVNNPricer) -> ttr.GbmCVNNPricer:
    """The port's pricer on the JAX pricer's carried ``model_state`` (an
    untrained one carries no Adam moments yet)."""
    snap = jp.snapshot()
    if snap.optimizer_state is None:
        cfg = ttr.GbmCVNNPricerConfig(
            sim=tgbm.SimulationParams(**snap.sim.model_dump(mode="json")),
            bounds={k: tsobol.BoundSpec(**v.model_dump()) for k, v in snap.bounds.items()},
            cvnn=tf.CVNNConfig.model_validate(snap.cvnn.model_dump(mode="json")),
            normalize_inputs=snap.normalize_inputs,
            model_state={k: np.asarray(v) for k, v in snap.model_state.items()},
        )
    else:
        cfg = _port_from_jax_snapshot(snap)
    return ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("port pricer")


@pytest.fixture(scope="module")
def trained() -> tuple[jtr.GbmCVNNPricer, ttr.GbmCVNNPricer]:
    """The JAX pricer after 2 steps (batch-norm statistics moved off their
    start) and the port's pricer on its snapshot."""
    jp = _jax_pricer()
    _train(jp, jtr, jstep, 2)
    return jp, _port_of(jp)


def _assert_greeks_close(got: ttr.GreeksPrediction, want: object) -> None:
    for name in ("put", "call", "put_jacobian", "call_jacobian"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for name in ("put_gamma", "call_gamma"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    assert got.fields == tuple(want.fields)


def test_predict_greeks_matches_jax_on_carried_weights(trained) -> None:
    """Tier 2: prices and Jacobians within atol 1e-6 and rtol 1e-4 of the JAX
    pricer's, gammas rtol 1e-3 (different reduction orders in the CVNN and
    the FFT), at N = 7 (N = 1's outputs are ``predict_price``'s and the
    padded batch's, below); the parity identity holds on the Jacobians:
    call − put = ∇[df·(F − K)] to rtol 1e-4 (atol 1e-5)."""
    jp, tp = trained
    contracts = _held_out(7, seed=7)
    got = tp.predict_greeks(contracts)
    _assert_greeks_close(got, jp.predict_greeks(contracts))
    assert got.put_jacobian.shape == (7, 6) and got.put_gamma.shape == (7,)
    x = torch.tensor(contracts, dtype=torch.float32, requires_grad=True)
    parity = torch.exp(-x[:, 3] * x[:, 2]) * (make_mean_target(tp._sim)(x) - x[:, 1])
    (want,) = torch.autograd.grad(parity.sum(), x)
    np.testing.assert_allclose(got.call_jacobian - got.put_jacobian, want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_predict_greeks_prices_equal_predict_price_and_pad_bit_exactly(trained) -> None:
    """Tier 1: ``predict_greeks``' put and call equal ``predict_price``'s bit for
    bit (the same forward on the same padded batch, the same host parity),
    and ``pad_to_bucket`` changes no bit of any output."""
    _, tp = trained
    for n in (1, 3, 7):
        contracts = _held_out(n, seed=10 + n)
        greeks = tp.predict_greeks(contracts)
        prices = tp.predict_price(contracts)
        np.testing.assert_array_equal(greeks.put, prices.put)
        np.testing.assert_array_equal(greeks.call, prices.call)
        padded = tp.predict_greeks(contracts, pad_to_bucket=True)
        for name in ("put", "call", "put_jacobian", "call_jacobian", "put_gamma", "call_gamma"):
            np.testing.assert_array_equal(getattr(padded, name), getattr(greeks, name))


def test_predict_greeks_term_case_matches_jax() -> None:
    """Tier 2 (as above) for a curved-market pricer (the JAX package's
    ``test_termstructure.py:454`` case), and the parity term's rate column
    carries the curve's mean rate factor through both df and the forward:
    ``d/dr[df·(F − K)] = −mr·T·df·(F − K) + df·mr·T·F`` (rtol 1e-4)."""
    term = dict(vol_shape=(1.3, 0.7, 1.1, 0.9, 1.2), rate_shape=(1.6, 0.4, 1.0, 1.2, 0.8))
    jp = _jax_pricer(term=jgbm.TermStructure(**term))
    tp = _port_of(jp)
    contracts = _held_out(3, seed=21)
    got = tp.predict_greeks(contracts)
    _assert_greeks_close(got, jp.predict_greeks(contracts))
    _, mr, mq = tgbm.TermStructure(**term).effective_factors(5)
    s0, k, t_m, r, q = (contracts[:, i].astype(np.float64) for i in range(5))
    df = np.exp(-r * mr * t_m)
    fwd = s0 * np.exp((r * mr - q * mq) * t_m)
    want = -mr * t_m * df * (fwd - k) + df * mr * t_m * fwd
    np.testing.assert_allclose(got.call_jacobian[:, 3] - got.put_jacobian[:, 3], want, rtol=1e-4,
                               atol=1e-5)


def test_predict_greeks_american_call_swaps_channels_like_jax() -> None:
    """Tier 2: an AMERICAN_CALL pricer serves the learned channel as the call
    (prices, Jacobian, gamma as JAX's), the put side NaN in every column, as
    ``predict_price`` serves it."""
    jp = _jax_pricer(payoff="american_call", normalization="none")
    tp = _port_of(jp)
    contracts = _held_out(3, seed=5)
    got = tp.predict_greeks(contracts)
    want = jp.predict_greeks(contracts)
    for name in ("put", "put_jacobian", "put_gamma"):
        assert np.isnan(getattr(got, name)).all() and np.isnan(np.asarray(getattr(want, name))).all()
    np.testing.assert_allclose(got.call, np.asarray(want.call), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.call_jacobian, np.asarray(want.call_jacobian), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.call_gamma, np.asarray(want.call_gamma), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(got.call, tp.predict_price(contracts).call)


def test_predict_greeks_nan_calls_without_parity_like_jax(caplog) -> None:
    """Tier 1 on where NaN goes: a barrier pricer has no closed-form E[u], so
    both packages give NaN call prices, Jacobians and gammas and finite put
    ones, and the port logs JAX's warning; the put side agrees at tier 2."""
    jp = _jax_pricer(payoff="barrier_up_out", barrier_rel=1.3, normalization="none")
    tp = _port_of(jp)
    contracts = _held_out(2, seed=9)
    with caplog.at_level(logging.WARNING):
        got = tp.predict_greeks(contracts)
    assert "call greeks unavailable" in caplog.text
    want = jp.predict_greeks(contracts)
    for name in ("call", "call_jacobian", "call_gamma"):
        assert np.isnan(getattr(got, name)).all() and np.isnan(np.asarray(getattr(want, name))).all()
    np.testing.assert_allclose(got.put_jacobian, np.asarray(want.put_jacobian), rtol=1e-4,
                               atol=1e-6)
    assert np.isfinite(got.put_gamma).all()
