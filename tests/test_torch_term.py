"""The port's term structures against the JAX package's.

(a) exact: ``TermStructure`` (``is_flat``, ``n_steps``, ``shapes``,
    ``effective_factors``), ``validate_term_structure`` and
    ``bootstrap_vol_shape`` (incl. the calendar-arbitrage failure), and every
    ``build_simulation_params`` refusal that involves a term or a model
    family, with the JAX package's field and reason.
(b) exact: ``has_closed_form_mean`` over the whole (model, payoff) grid,
    ``resolve_implementation`` over (model, payoff, term, scheme) with
    ``"cuda"`` for ``"pallas"`` (the JAX rules with its kernel-shape
    predicate switched on), ``cuda_stream_version`` against
    ``pallas_stream_version``'s keys.
(c) tier 2, rtol 1e-5: the threefry GBM engine under curves against the JAX
    package's, every payoff × scheme; a flat term is the same program bit
    for bit. rtol 1e-6 (float64): ``expected_underlier_mean`` with curves.
(d) rtol 1e-6 (float64): the oracles with curve arguments.
(e) the trainer: a 3-step curved-term GBM slice on the threefry engine
    against the JAX ``GbmCVNNPricer`` (``test_torch_slice.py``'s
    tolerances), ``predict_price`` with the curve-effective discount, and a
    bit-exact snapshot/resume on the term kernel's twin that carries ``term``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_payoffs import (
    BOUNDS,
    NO_MEAN,
    PAYOFF_KNOBS,
    STRIKE_UNITS,
    _cvnn,
    _port_from_jax_snapshot,
    _train,
)

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import analytic as ja
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import gbm_pallas as jpallas
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import analytic as ta
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

PAYOFFS = list(PAYOFF_KNOBS)
STEPS = 6
CURVES = dict(vol_shape=tuple(1.5 - 0.15 * i for i in range(STEPS)),
              rate_shape=tuple(0.5 + 0.2 * i for i in range(STEPS)),
              div_shape=tuple(1.3 - 0.1 * i for i in range(STEPS)))
TERMS = [
    {},
    dict(vol_shape=(1.0, 1.0, 1.0)),
    dict(rate_shape=(1.0, 1.0), div_shape=(1.0, 1.0)),
    dict(vol_shape=(1.2, 0.8, 1.0, 1.1)),
    dict(rate_shape=(0.5, 1.5), div_shape=(2.0, 0.0)),
    CURVES,
]


def _contracts(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


# --------------------------------------------------------------------------
# (a) the model and its validators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", TERMS, ids=[str(i) for i in range(len(TERMS))])
def test_term_structure_methods_match_jax(shapes: dict) -> None:
    got, want = tgbm.TermStructure(**shapes), jgbm.TermStructure(**shapes)
    assert got.is_flat() == want.is_flat()
    assert got.n_steps() == want.n_steps()
    n = got.n_steps() or 5
    assert got.shapes(n) == want.shapes(n)
    assert got.effective_factors(n) == want.effective_factors(n)
    assert (tgbm.curved(got) is None) == want.is_flat()
    assert got.model_dump() == want.model_dump()
    with pytest.raises(Exception, match="frozen|Instance is frozen"):
        got.vol_shape = ()


BAD_TERMS = [
    dict(vol_shape=(1.0, 1.0)),
    dict(rate_shape=(1.0,) * 7),
    dict(div_shape=(1.0, float("nan"), 1.0, 1.0, 1.0, 1.0)),
    dict(vol_shape=(1.0, -0.5, 1.0, 1.0, 1.0, 1.0)),
    dict(vol_shape=(0.0,) * 6),
    dict(rate_shape=(float("inf"),) * 6),
]


@pytest.mark.parametrize("shapes", BAD_TERMS, ids=[str(i) for i in range(len(BAD_TERMS))])
def test_validate_term_structure_refuses_as_jax_does(shapes: dict) -> None:
    got = tgbm.validate_term_structure(tgbm.TermStructure(**shapes), timesteps=STEPS)
    want = jgbm.validate_term_structure(jgbm.TermStructure(**shapes), timesteps=STEPS)
    assert got.is_failure() and want.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)
    assert tgbm.validate_term_structure(tgbm.TermStructure(**CURVES), timesteps=STEPS).is_success()
    built = tgbm.build_simulation_params(timesteps=STEPS, network_size=4, batches_per_mc_run=2,
                                         mc_seed=0, term=tgbm.TermStructure(**shapes))
    assert built.is_failure() and built.error.field == want.error.field


QUOTES = [
    (((2, 0.2), (4, 0.25), (6, 0.22)), 0.2),
    (((3, 0.3),), 0.25),
    (((1, 0.2), (6, 0.2)), 0.2),
    (((2, 0.3), (4, 0.2)), 0.2),  # calendar arbitrage
    (((0, 0.3),), 0.2),
    (((3, 0.3), (2, 0.3)), 0.2),
    (((3, -0.3),), 0.2),
    (((7, 0.3),), 0.2),
    ((), 0.2),
    (((3, 0.3),), 0.0),
]


@pytest.mark.parametrize("quotes,ref", QUOTES, ids=[str(i) for i in range(len(QUOTES))])
def test_bootstrap_vol_shape_matches_jax(quotes: tuple, ref: float) -> None:
    got = tgbm.bootstrap_vol_shape(quotes, timesteps=STEPS, reference_vol=ref)
    want = jgbm.bootstrap_vol_shape(quotes, timesteps=STEPS, reference_vol=ref)
    assert got.is_success() == want.is_success()
    if want.is_failure():
        assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)
        return
    assert got.value == want.value and len(got.value) == STEPS
    for k, sigma in quotes:  # the curve reproduces every quote
        rms = np.sqrt(np.mean(np.square(got.value[:k]))) * ref
        assert abs(rms - sigma) < 1e-12


BASE = dict(timesteps=STEPS, network_size=16, batches_per_mc_run=8, mc_seed=0)
FAMILY_REFUSALS = [
    dict(model="heston", term=dict(vol_shape=(1.1,) * STEPS)),
    dict(model="heston", term=dict(vol_shape=(1.0, 1.0))),
    dict(model="merton_jump", scheme="euler"),
    dict(model="merton_jump", term=dict(vol_shape=(1.0, 2.0))),
    dict(model="heston", basket=object()),
    dict(model="heston", payoff="asian_geometric"),
    dict(model="merton_jump", payoff="asian_geometric"),
    dict(model="heston", payoff="variance_swap"),
    dict(model="heston", payoff="digital"),
    dict(model="heston", payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.0,
         cliquet_cap=0.1),
    dict(model="merton_jump", payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.0,
         cliquet_cap=0.1),
    dict(model="merton_jump", payoff="barrier_up_out", barrier_rel=1.2),
    dict(term=dict(rate_shape=(1.0,) * 5)),
    dict(payoff="forward_start", forward_start_step=STEPS, term=CURVES),
]


@pytest.mark.parametrize("bad", FAMILY_REFUSALS, ids=[str(i) for i in range(len(FAMILY_REFUSALS))])
def test_build_simulation_params_refuses_terms_and_families_as_jax_does(bad: dict) -> None:
    jbad, tbad = dict(bad), dict(bad)
    if "term" in bad:
        jbad["term"], tbad["term"] = jgbm.TermStructure(**bad["term"]), tgbm.TermStructure(**bad["term"])
    want = jgbm.build_simulation_params(**BASE, **jbad)
    assert want.is_failure()
    got = tgbm.build_simulation_params(**BASE, **tbad)
    assert got.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, want.error.reason)


# --------------------------------------------------------------------------
# (b) the gates
# --------------------------------------------------------------------------

MODELS = ["gbm", "heston", "merton_jump"]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("payoff", [p.value for p in tgbm.PayoffKind])
def test_has_closed_form_mean_matches_jax_over_the_grid(model: str, payoff: str) -> None:
    assert tgbm.has_closed_form_mean(tgbm.ModelKind(model), tgbm.PayoffKind(payoff)) == \
        jgbm.has_closed_form_mean(jgbm.ModelKind(model), jgbm.PayoffKind(payoff))
    for combine in ("arithmetic", "geometric"):  # the basket rows, per combine
        assert tgbm.has_closed_form_mean(
            tgbm.ModelKind.BASKET_GBM, tgbm.PayoffKind(payoff),
            combine=tgbm.BasketCombine(combine),
        ) == jgbm.has_closed_form_mean(jgbm.ModelKind.BASKET_GBM, jgbm.PayoffKind(payoff),
                                       combine=jgbm.BasketCombine(combine))


# Merton under Euler is refused at config time in both packages
MODEL_SCHEMES = [(m, s) for m in MODELS for s in ("log_euler", "euler")
                 if (m, s) != ("merton_jump", "euler")]


@pytest.mark.parametrize("term", [None, "flat", "curved"])
@pytest.mark.parametrize("model,scheme", MODEL_SCHEMES)
def test_resolve_implementation_follows_the_jax_rules(
    model: str, scheme: str, term: str | None, monkeypatch: pytest.MonkeyPatch
) -> None:
    """The JAX rules with its kernel-shape predicate switched on (as on a
    TPU), ``"cuda"`` standing for ``"pallas"``, over every payoff."""
    monkeypatch.setattr(jpallas, "pallas_supported", lambda **kw: kw["dtype"] == jnp.float32)
    shapes = {None: None, "flat": dict(rate_shape=(1.0,) * STEPS),
              "curved": dict(rate_shape=CURVES["rate_shape"])}[term]
    for payoff in PAYOFFS:
        kw = dict(BASE, model=model, scheme=scheme, payoff=payoff, normalization="none",
                  **PAYOFF_KNOBS[payoff])
        jsim = jgbm.build_simulation_params(
            **kw, implementation="pallas",
            term=jgbm.TermStructure(**shapes) if shapes else None).expect("jax sim")
        tsim = tgbm.build_simulation_params(
            **kw, implementation="cuda",
            term=tgbm.TermStructure(**shapes) if shapes else None).expect("port sim")
        want = jgbm.resolve_implementation(jsim).value.replace("pallas", "cuda")
        assert tgbm.resolve_implementation(tsim).value == want, (payoff, want)
        xla = tsim.model_copy(update={"implementation": tgbm.SimImplementation.XLA})
        assert tgbm.resolve_implementation(xla) == tgbm.SimImplementation.XLA
        f64 = tsim.model_copy(update={"precision": tgbm.Precision.float64})
        assert tgbm.resolve_implementation(f64) == tgbm.SimImplementation.XLA


@pytest.mark.parametrize("model", [*MODELS, "basket_gbm"])
def test_cuda_stream_version_follows_pallas_stream_versions_keys(model: str) -> None:
    keys = gbm_cuda.CUDA_STREAM_VERSIONS
    assert set(keys) == {"gbm", "gbm_cliquet", "gbm_term", "heston", "merton_jump", "basket_gbm",
                         "american_gbm", "american_heston", "american_merton_jump",
                         "american_basket_gbm"}
    assert set(keys) <= set(jpallas.PALLAS_STREAM_VERSIONS)
    # give every key its own value in both tables, so that equal versions
    # mean equal keys
    marks = {k: i + 1 for i, k in enumerate(sorted(jpallas.PALLAS_STREAM_VERSIONS))}
    # the American kinds are ported under every dynamics (their own keys)
    for payoff in PAYOFFS + ["american_put", "american_call"]:
        for term in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpallas, "PALLAS_STREAM_VERSIONS", marks)
                mp.setattr(gbm_cuda, "CUDA_STREAM_VERSIONS", {k: marks[k] for k in keys})
                want = jpallas.pallas_stream_version(jgbm.ModelKind(model),
                                                     jgbm.PayoffKind(payoff), term=term)
                got = gbm_cuda.cuda_stream_version(tgbm.ModelKind(model),
                                                   tgbm.PayoffKind(payoff), term=term)
            assert got == want, (payoff, term)


# --------------------------------------------------------------------------
# (c) the threefry engine and the means under curves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["log_euler", "euler"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_threefry_engine_under_curves_matches_jax(payoff: str, scheme: str) -> None:
    assert jax.config.jax_threefry_partitionable
    contracts = _contracts(2, seed=11)
    rows, cols = 8, 16
    half = rows // 2 if scheme == "log_euler" else None
    knobs = PAYOFF_KNOBS[payoff]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(2)]
    want = np.stack([
        np.asarray(jgbm.simulate_underlier_rows(
            k, jnp.asarray(c), timesteps=STEPS, rows=rows, cols=cols, dtype=jnp.float32,
            scheme=jgbm.PathScheme(scheme), payoff=jgbm.PayoffKind(payoff),
            antithetic_half=half, term=jgbm.TermStructure(**CURVES), **knobs))
        for k, c in zip(keys, contracts)
    ])
    got = tgbm.simulate_underlier_rows(
        rng.fold_in(rng.prng_key(5), torch.arange(2)), torch.from_numpy(contracts),
        timesteps=STEPS, rows=rows, cols=cols, dtype=torch.float32,
        scheme=tgbm.PathScheme(scheme), payoff=tgbm.PayoffKind(payoff), antithetic_half=half,
        term=tgbm.TermStructure(**CURVES), **knobs,
    ).numpy()
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, contracts[:, 1, None, None])
    if payoff == "cliquet":
        scale = np.maximum(scale, knobs["cliquet_cap"])
    far = int((np.abs(got - want) > 1e-5 * scale).sum())
    assert far <= (1 if payoff == "digital" or payoff.startswith("barrier") else 0)


@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "cliquet", "variance_swap"])
def test_flat_term_is_the_same_program_bit_for_bit(payoff: str) -> None:
    c = torch.from_numpy(_contracts(2, seed=3))
    keys = rng.fold_in(rng.prng_key(1), torch.arange(2))
    flat = tgbm.TermStructure(vol_shape=(1.0,) * STEPS, rate_shape=(1.0,) * STEPS)
    for scheme in tgbm.PathScheme:
        kw = dict(timesteps=STEPS, rows=4, cols=8, dtype=torch.float32, scheme=scheme,
                  payoff=tgbm.PayoffKind(payoff), **PAYOFF_KNOBS[payoff])
        assert torch.equal(tgbm.simulate_underlier_rows(keys, c, term=flat, **kw),
                           tgbm.simulate_underlier_rows(keys, c, **kw))
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items()}
    mean = dict(timesteps=STEPS, payoff=tgbm.PayoffKind(payoff), dtype=torch.float32, **knobs)
    assert torch.equal(tgbm.expected_underlier_mean(c, term=flat, **mean),
                       tgbm.expected_underlier_mean(c, **mean))


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_expected_underlier_mean_under_curves_matches_jax(payoff: str) -> None:
    contracts = _contracts(4, seed=2).astype(np.float64)
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items() if k != "barrier_rel"}
    got = tgbm.expected_underlier_mean(
        torch.from_numpy(contracts), timesteps=STEPS, payoff=tgbm.PayoffKind(payoff),
        dtype=torch.float64, term=tgbm.TermStructure(**CURVES), **knobs)
    want = [jgbm.expected_underlier_mean(
        jnp.asarray(c), timesteps=STEPS, payoff=jgbm.PayoffKind(payoff), dtype=jnp.float64,
        term=jgbm.TermStructure(**CURVES), **knobs) for c in contracts]
    assert (got is None) == (want[0] is None)
    if got is not None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_discounting_uses_the_curve_effective_rate() -> None:
    c = torch.from_numpy(_contracts(3, seed=5))
    u = torch.full((3, 8), 90.0)
    term = tgbm.TermStructure(**CURVES)
    got = tgbm.terminal_to_prices(u, c, normalize=False, dtype=torch.float32, term=term)
    for i in range(3):
        want = jgbm.terminal_to_prices(jnp.asarray(u[i].numpy()), jnp.asarray(c[i].numpy()),
                                       normalize=False, dtype=jnp.float32,
                                       term=jgbm.TermStructure(**CURVES))
        np.testing.assert_allclose(got.put_payoffs[i].numpy(), np.asarray(want.put_payoffs),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got.forward[i]), float(want.forward), rtol=1e-6)
        np.testing.assert_allclose(float(got.discount_factor[i]), float(want.discount_factor),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# (d) the oracles with curve arguments
# --------------------------------------------------------------------------

GRID = [
    (100.0, 100.0, 1.0, 0.03, 0.01, 0.25),
    (100.0, 120.0, 0.5, 0.05, 0.0, 0.35),
    (90.0, 80.0, 2.0, 0.01, 0.03, 0.15),
]
PRICE_FIELDS = ("put", "call", "put_intrinsic", "call_intrinsic", "put_convexity",
                "call_convexity")


def _same_prices(got: object, want: object, scale: float) -> None:
    for f in PRICE_FIELDS:
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=1e-6,
                                   atol=1e-9 * scale, err_msg=f)


@pytest.mark.parametrize("c", GRID)
@pytest.mark.parametrize("curves", [CURVES, dict(vol_shape=CURVES["vol_shape"]),
                                    dict(rate_shape=CURVES["rate_shape"])],
                         ids=["all", "vol", "rate"])
def test_closed_form_oracles_under_curves_match_jax(c: tuple, curves: dict) -> None:
    full = {"vol_shape": (), "rate_shape": (), "div_shape": (), **curves}
    _same_prices(ta.term_effective_black(*c, **full), ja.term_effective_black(*c, **full), c[0])
    _same_prices(ta.term_geometric_asian_price(*c, timesteps=STEPS, **curves),
                 ja.term_geometric_asian_price(*c, timesteps=STEPS, **curves), c[0])
    for got, want in zip(ta.digital_price(*c, **curves), ja.digital_price(*c, **curves)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _same_prices(ta.forward_start_price(*c, timesteps=STEPS, start_step=2, **curves),
                 ja.forward_start_price(*c, timesteps=STEPS, start_step=2, **curves), c[0])
    # with all-ones curves the term oracles are the flat ones
    ones = dict(vol_shape=(1.0,) * STEPS, rate_shape=(1.0,) * STEPS, div_shape=(1.0,) * STEPS)
    _same_prices(ta.term_effective_black(*c, **ones), ta.black_scholes_price(*c), c[0])
    _same_prices(ta.term_geometric_asian_price(*c, timesteps=STEPS, **ones),
                 ta.geometric_asian_price(*c, timesteps=STEPS), c[0])


@pytest.mark.parametrize("c", GRID)
def test_lattice_oracles_under_curves_match_jax(c: tuple) -> None:
    spot = c[0]
    kw = dict(timesteps=STEPS, **CURVES)
    for rel, up in ((1.2, True), (0.85, False)):
        _same_prices(
            ta.discrete_barrier_price(*c, barrier_rel=rel, up=up, grid_points=257, **kw),
            ja.discrete_barrier_price(*c, barrier_rel=rel, up=up, grid_points=257, **kw), spot)
    got = ta.lookback_price(*c, grid_points=193, levels=65, **kw)
    want = ja.lookback_price(*c, grid_points=193, levels=65, **kw)
    for f in ("fixed_call", "fixed_put", "float_call", "float_put", "e_max", "e_min", "forward",
              "discount_factor"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6,
                                   atol=1e-9 * spot, err_msg=f)
    cq = dict(reset_every=2, local_floor=-0.05, local_cap=0.08, grid=1 << 12)
    strike_c = (c[0], 0.03, *c[2:])
    _same_prices(ta.cliquet_price(*strike_c, **kw, **cq), ja.cliquet_price(*strike_c, **kw, **cq),
                 0.1)


# --------------------------------------------------------------------------
# (e) the trainer
# --------------------------------------------------------------------------

SIM = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=7, antithetic=True)
TERM4 = dict(vol_shape=(1.3, 1.1, 0.9, 0.8), rate_shape=(0.6, 0.9, 1.1, 1.4),
             div_shape=(1.2, 1.0, 1.0, 0.8))


def _bounds(payoff: str) -> dict[str, tuple[float, float]]:
    return {**BOUNDS, "strike": STRIKE_UNITS.get(payoff, BOUNDS["strike"])}


def _sim_kwargs(payoff: str) -> dict[str, object]:
    return dict(SIM, payoff=payoff, normalization="none" if payoff in NO_MEAN else "mean",
                **PAYOFF_KNOBS[payoff])


def _jax_pricer(payoff: str) -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(**_sim_kwargs(payoff),
                                       term=jgbm.TermStructure(**TERM4)).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def test_curved_term_slice_three_steps_match_jax() -> None:
    """Tier 2 (``test_torch_slice.py``'s tolerances): losses rtol 1e-4, the
    weights and batch-norm state after 3 steps atol 1e-5, TERMINAL under all
    three curves with MEAN normalization to the curve-aware forward."""
    jp = _jax_pricer("terminal")
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    assert tp.snapshot().sim.term == tgbm.TermStructure(**TERM4)
    np.testing.assert_allclose(_train(tp, ttr, 3), _train(jp, jtr, 3), rtol=1e-4)
    port_snap, jax_snap = tp.snapshot(), jp.snapshot()
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sim.skip == jax_snap.sim.skip


@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "barrier_up_out",
                                    "variance_swap", "forward_start", "digital", "cliquet"])
def test_predict_price_under_curves_matches_jax(payoff: str) -> None:
    """Same weights in both packages: puts rtol 1e-5, calls by parity at the
    curve-effective discount (rtol 1e-5), NaN for the barrier."""
    jp = _jax_pricer(payoff)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    b = _bounds(payoff)
    lo, hi = np.array([v[0] for v in b.values()]), np.array([v[1] for v in b.values()])
    contracts = (lo + (hi - lo) * np.random.default_rng(4).random((5, 6))).astype(np.float32)
    want, got = jp.predict_price(contracts), tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5, atol=1e-7)
    assert np.array_equal(np.isnan(got.call), np.isnan(want.call))
    if not np.all(np.isnan(want.call)):
        np.testing.assert_allclose(got.call, want.call, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("payoff", ["terminal", "asian_arithmetic", "lookback_fixed_put",
                                    "variance_swap", "forward_start", "cliquet"])
def test_cuda_engine_resume_is_bit_exact_on_the_term_twin(payoff: str) -> None:
    """Tier 1, exact: snapshot → create → 2 more steps equals the continuous
    run; the snapshot carries ``term`` and records ``gbm_term``'s version, except
    for the curved cliquet, which the scan runs (engine ``xla``, version 0);
    under Euler a curved term runs the scan too."""
    term = tgbm.TermStructure(**TERM4)
    sim = tgbm.build_simulation_params(**_sim_kwargs(payoff), implementation="cuda",
                                       term=term).expect("s")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf), normalize_inputs=True)
    a = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("a")
    first = _train(a, ttr, 2)
    snap = a.snapshot()
    assert snap.sim.term == term and np.all(np.isfinite(first))
    if payoff == "cliquet":
        assert (snap.sim.implementation, snap.cuda_stream_version) == \
            (tgbm.SimImplementation.XLA, 0)
    else:
        assert snap.sim.implementation == tgbm.SimImplementation.CUDA
        assert snap.cuda_stream_version == gbm_cuda.CUDA_STREAM_VERSIONS["gbm_term"]
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))
    euler = sim.model_copy(update={"scheme": tgbm.PathScheme.EULER})
    assert tgbm.resolve_implementation(euler) == tgbm.SimImplementation.XLA
