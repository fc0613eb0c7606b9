"""The port's bump-and-reprice Greeks, knock-in prices and curve ladders
against the JAX package's (``ops/greeks.py``), and the refusals.

The same contracts and draws go through both packages at a small size
(``test_torch_greeks.py``'s helpers); tiers and tolerances are in each
test's docstring.
"""

from __future__ import annotations

import math
from unittest import mock

import numpy as np
import pytest
import torch
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import greeks as jgreeks
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda
from spectralmc_tpu_torch.ops import greeks as tgreeks
from test_torch_greeks import (  # noqa: F401 — _one_torch_thread is an autouse fixture
    CARD_SIM,
    CURVE,
    GBM,
    SMALL,
    _assert_greeks,
    _contracts,
    _one_torch_thread,
    _port_sim,
    _side,
    _sims,
)


# --------------------------------------------------------------------------
# Bump-and-reprice, knock-in and the curve ladders
# --------------------------------------------------------------------------

BUMP_CASES = {
    "barrier-up-out": (dict(payoff="barrier_up_out", barrier_rel=1.35, normalization="none"),
                       "call"),
    "digital": (dict(payoff="digital", normalization="none"), "call"),
    "terminal": (dict(), "put"),
    "american-put": (dict(payoff="american_put", normalization="none"), "put"),
}


@pytest.mark.parametrize("case,precision", [
    (case, precision) for case in BUMP_CASES for precision in ("float64", "float32")
    if not (case == "american-put" and precision == "float32")
])
def test_bump_greeks_matches_jax(case: str, precision: str) -> None:
    """Tier 2: ``bump_greeks`` port vs JAX on the same draw. Float64: rtol
    1e-9 on the price, every field and gamma. Float32: price rtol 1e-5; a
    field rtol 1e-4 plus what the prices' own agreement (1e-6 of the price,
    the normals' ulps) becomes through its difference quotient,
    ``2e-6·|price|/(2h_i)``; gamma rtol 1e-3 plus ``4e-6·|price|/h_0²``. The
    American put runs in float64 only: in float32 the two estimators' moment
    sums differ in order and flip exercise decisions (ROADMAP Queue 3)."""
    kw, option = BUMP_CASES[case]
    jsim, tsim = _sims(**SMALL, **kw, precision=precision)
    jc, tc = _contracts("gbm", strike=100.0)
    jside, tside = _side(option)
    want = jgreeks.bump_greeks(jsim, jc, option=jside)
    got = tgreeks.bump_greeks(tsim, tc, option=tside, device="cpu")
    if precision == "float64":
        _assert_greeks(got, want, price_rtol=1e-9, rtol=1e-9, atol=1e-12, gamma_rtol=1e-9,
                       gamma_atol=1e-12)
        return
    assert got.price == pytest.approx(want.price, rel=1e-5)
    values = np.array([getattr(tc, f) for f in tgbm.CONTRACT_FIELDS])
    h = 1e-2 * np.maximum(np.abs(values), 1e-3)
    for i, (field, value) in enumerate(want.by_field.items()):
        slack = 2e-6 * abs(want.price) / (2.0 * h[i])
        assert abs(got.by_field[field] - value) <= 1e-4 * abs(value) + slack, field
    assert abs(got.gamma - want.gamma) <= 1e-3 * abs(want.gamma) + 4e-6 * abs(want.price) / h[0] ** 2


def test_bump_greeks_is_one_simulator_call_on_the_cuda_engine() -> None:
    """Tier 1: a TERMINAL ``bump_greeks`` on the ``"cuda"`` engine prices its
    13 contracts in ONE call of the TERMINAL twin (one launch on the card)
    with the key words repeated, and its base row is the single-contract
    price bit for bit (common random numbers)."""
    sim = _port_sim(**{**CARD_SIM, "batches_per_mc_run": 8})
    c = tgbm.BlackScholesContract(**GBM)
    with mock.patch.object(gbm_cuda, "simulate_underlier_rows_cuda_plain",
                           wraps=gbm_cuda.simulate_underlier_rows_cuda_plain) as twin:
        g = tgreeks.bump_greeks(sim, c, device="cpu")
    assert twin.call_count == 1
    params, keys = twin.call_args.args[:2]
    assert params.shape == (13, 6) and torch.equal(keys, keys[:1].expand(13, 2))
    price_fn = tgreeks._make_raw_price_fn(sim, option=tgreeks.OptionSide.CALL, device="cpu")
    with torch.no_grad():
        assert g.price == float(price_fn(sim.skip, c.as_array(torch.float32, "cpu")))
    assert g.engine == tgbm.SimImplementation.CUDA


def test_knock_in_price_matches_jax_and_states_each_legs_engine() -> None:
    """Tier 2, float32 rtol 1e-4: ``knock_in_price`` port vs JAX on the
    threefry engine, where both legs walk one stream, and in + out equals
    the vanilla. On a ``"cuda"`` sim each leg keeps its own engine, as in
    the JAX package: the vanilla leg runs kernel #1 (its twin here), the
    knock-out leg the threefry scan."""
    kw = dict(payoff="barrier_up_out", barrier_rel=1.3, normalization="none")
    jsim, tsim = _sims(**SMALL, **kw)
    jc, tc = _contracts("gbm", strike=100.0)
    for option in ("call", "put"):
        jside, tside = _side(option)
        want = jgreeks.knock_in_price(jsim, jc, option=jside)
        got = tgreeks.knock_in_price(tsim, tc, option=tside, device="cpu")
        assert got == pytest.approx(want, rel=1e-4, abs=1e-6)
    csim = _port_sim(**SMALL, implementation="cuda", **kw)
    vanilla = csim.model_copy(update={"payoff": tgbm.PayoffKind.TERMINAL, "barrier_rel": None})
    assert tgreeks.greeks_engine(vanilla) == tgbm.SimImplementation.CUDA
    assert tgreeks.greeks_engine(csim) == tgbm.SimImplementation.XLA
    with mock.patch.object(gbm_cuda, "simulate_underlier_rows_cuda_plain",
                           wraps=gbm_cuda.simulate_underlier_rows_cuda_plain) as twin:
        assert math.isfinite(tgreeks.knock_in_price(csim, tc, device="cpu"))
    assert twin.call_count == 1  # the vanilla leg only


@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "variance_swap",
                                    "forward_start", "cliquet"])
def test_term_bucket_greeks_matches_jax(payoff: str) -> None:
    """Tier 2, float32: the ladders port vs JAX on the same draw, price rtol
    1e-5, buckets rtol 1e-4 (atol 1e-6)."""
    extra: dict = {"payoff": payoff}
    overrides: dict = {}
    if payoff == "forward_start":
        extra["forward_start_step"] = 3
    if payoff == "cliquet":
        extra.update(cliquet_reset_every=2, cliquet_floor=-0.05, cliquet_cap=0.08,
                     normalization="none")
        overrides["strike"] = 0.02
    if payoff == "variance_swap":
        overrides["strike"] = 0.05
    jsim, tsim = _sims(**SMALL, term=CURVE, **extra)
    jc, tc = _contracts("gbm", **overrides)
    want = jgreeks.term_bucket_greeks(jsim, jc, option=jgreeks.OptionSide.CALL)
    got = tgreeks.term_bucket_greeks(tsim, tc, option=tgreeks.OptionSide.CALL, device="cpu")
    assert got.price == pytest.approx(want.price, rel=1e-5)
    for name in ("vega_buckets", "rho_buckets", "div_buckets"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-4, atol=1e-6)
    assert got.engine == tgbm.SimImplementation.XLA


def test_term_bucket_greeks_euler_homogeneity() -> None:
    """Tier 2, float64: ``Σ_t vega_buckets[t]·vs[t] = vol·∂price/∂vol`` (and
    likewise rate and div) against ``mc_greeks`` on the same draw, rtol 1e-9."""
    _, sim = _sims(**SMALL, term=CURVE, precision="float64")
    c = tgbm.BlackScholesContract(**GBM)
    ladders = tgreeks.term_bucket_greeks(sim, c, device="cpu")
    scalar = tgreeks.mc_greeks(sim, c, device="cpu")
    vs, rs, qs = sim.term.shapes(sim.timesteps)
    assert ladders.price == pytest.approx(scalar.price, rel=1e-12)
    for buckets, shape, field in ((ladders.vega_buckets, vs, "vol"),
                                  (ladders.rho_buckets, rs, "rate"),
                                  (ladders.div_buckets, qs, "div_yield")):
        want = getattr(c, field) * scalar.by_field[field]
        assert sum(b * s for b, s in zip(buckets, shape)) == pytest.approx(want, rel=1e-9)


# --------------------------------------------------------------------------
# Refusals: JAX's exception types and messages
# --------------------------------------------------------------------------

REFUSALS = {
    "ipa-barrier": ("mc_greeks", dict(payoff="barrier_down_out", barrier_rel=0.8,
                                      normalization="none"), "call", {}),
    "ipa-digital": ("mc_greeks", dict(payoff="digital", normalization="none"), "call", {}),
    "american-side": ("mc_greeks", dict(payoff="american_put", normalization="none"), "call",
                      {}),
    "american-side-bump": ("bump_greeks", dict(payoff="american_call", normalization="none"),
                           "put", {}),
    "ladder-non-gbm": ("term_bucket_greeks", dict(model="heston"), "call", {}),
    "ladder-no-term": ("term_bucket_greeks", dict(), "call", {}),
    "ladder-indicator": ("term_bucket_greeks", dict(payoff="digital", normalization="none",
                                                    term=CURVE), "call", {}),
    "ladder-american": ("term_bucket_greeks", dict(payoff="american_put", normalization="none",
                                                   term=CURVE), "put", {}),
    "ladder-lookback": ("term_bucket_greeks", dict(payoff="lookback_fixed_call",
                                                   normalization="none", term=CURVE), "call",
                        {}),
    "knock-in-non-barrier": ("knock_in_price", dict(), "call", {}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case: str) -> None:
    """Tier 1: the same exception type and message as the JAX package's."""
    fn, kw, option, _ = REFUSALS[case]
    jsim, tsim = _sims(**SMALL, **kw)
    family = "heston" if kw.get("model") == "heston" else "gbm"
    jc, tc = _contracts(family)
    jside, tside = _side(option)
    with pytest.raises(Exception) as jexc:
        getattr(jgreeks, fn)(jsim, jc, option=jside)
    with pytest.raises(Exception) as texc:
        getattr(tgreeks, fn)(tsim, tc, option=tside, device="cpu")
    assert type(texc.value) is type(jexc.value)
    assert str(texc.value) == str(jexc.value)


def test_analytic_arithmetic_asian_refusal_matches_jax() -> None:
    """Tier 1: the closed forms refuse the arithmetic Asian with JAX's message."""
    with pytest.raises(ValueError) as jexc:
        jgreeks.make_analytic_price_fn(option=jgreeks.OptionSide.CALL,
                                       payoff=jgbm.PayoffKind.ASIAN_ARITHMETIC)
    with pytest.raises(ValueError) as texc:
        tgreeks.make_analytic_price_fn(option=tgreeks.OptionSide.CALL,
                                       payoff=tgbm.PayoffKind.ASIAN_ARITHMETIC)
    assert str(texc.value) == str(jexc.value)


def test_greeks_module_exports_jax_names() -> None:
    """Tier 1: every name of the JAX module's ``__all__`` exists in the port's,
    and ``OptionSide`` is the port's one enum (``ops/american.py``)."""
    from spectralmc_tpu_torch.ops import american

    assert set(jgreeks.__all__) <= set(tgreeks.__all__)
    for name in jgreeks.__all__:
        assert hasattr(tgreeks, name), name
    assert tgreeks.OptionSide is american.OptionSide
