"""The port's Monte-Carlo Greeks against the JAX package's (``ops/greeks.py``).

The same contracts and draws go through both packages at a small size. Tiers
and tolerances are in each test's docstring:

* the pathwise rule of kernels #1/#2 (``gbm_cuda.terminal_pathwise_vjp``)
  against JAX's on the same inputs, and against autograd through the
  threefry scan; the ``TerminalPathwise`` Function on the CPU twin against
  autograd through the twin; kernel #14's ``WalkAcc`` against autograd
  through ``walk_acc_plain``;
* ``mc_greeks`` on the threefry engine, port against JAX on the same draw,
  for every dynamics and payoff family; on the ``"cuda"`` engine (the twins
  here) against the closed forms;
* ``bump_greeks``, ``knock_in_price`` and ``term_bucket_greeks`` against JAX;
* every refusal with JAX's exception type and message.
"""

from __future__ import annotations

import math
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import gbm_pallas as jpallas
from spectralmc_tpu.ops import greeks as jgreeks
from spectralmc_tpu.ops import heston as jheston
from spectralmc_tpu.ops import merton as jmerton
from spectralmc_tpu_torch.ops import analytic as tanalytic
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, qmc, qmc_cuda, rng
from spectralmc_tpu_torch.ops import greeks as tgreeks
from spectralmc_tpu_torch.ops import heston as theston
from spectralmc_tpu_torch.ops import merton as tmerton

BASKET_KW = dict(weights=(0.5, 0.3, 0.2),
                 correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)))
MARKET = dict(spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01)
GBM = dict(MARKET, vol=0.25)
HESTON = dict(MARKET, v0=0.05, kappa=1.5, theta=0.05, xi=0.3, rho=-0.5)
MERTON = dict(MARKET, vol=0.2, lam=0.4, jump_mean=-0.1, jump_std=0.15)
SMALL = dict(timesteps=8, network_size=64, batches_per_mc_run=16, mc_seed=5)
CURVE = dict(vol_shape=(1.2, 1.1, 1.0, 0.9, 0.8, 0.9, 1.0, 1.1),
             rate_shape=(1.5, 1.5, 1.5, 1.5, 0.5, 0.5, 0.5, 0.5))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the scans are many small ops, which
    torch's thread pool slows while the suite's other workers hold the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sims(**kw: object) -> tuple[jgbm.SimulationParams, tgbm.SimulationParams]:
    """The same validated config in both packages (the basket's spec built in each)."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("model") == "basket_gbm":
        jkw["basket"] = jbasket.build_basket_spec(**BASKET_KW).expect("spec")
        tkw["basket"] = tbasket.build_basket_spec(**BASKET_KW).expect("spec")
    if "term" in kw:
        jkw["term"] = jgbm.TermStructure(**kw["term"])
        tkw["term"] = tgbm.TermStructure(**kw["term"])
    return (jgbm.build_simulation_params(**jkw).expect("jax sim"),
            tgbm.build_simulation_params(**tkw).expect("port sim"))


def _port_sim(**kw: object) -> tgbm.SimulationParams:
    """A config only the port has (the ``"cuda"`` engine)."""
    if "term" in kw:
        kw = {**kw, "term": tgbm.TermStructure(**kw["term"])}
    return tgbm.build_simulation_params(**kw).expect("port sim")


def _contracts(family: str, **overrides: float) -> tuple[object, object]:
    fields = {"gbm": GBM, "heston": HESTON, "merton": MERTON}[family]
    jcls = {"gbm": jgbm.BlackScholesContract, "heston": jheston.HestonContract,
            "merton": jmerton.MertonContract}[family]
    tcls = {"gbm": tgbm.BlackScholesContract, "heston": theston.HestonContract,
            "merton": tmerton.MertonContract}[family]
    return jcls(**{**fields, **overrides}), tcls(**{**fields, **overrides})


def _side(option: str) -> tuple[jgreeks.OptionSide, tgreeks.OptionSide]:
    return jgreeks.OptionSide(option), tgreeks.OptionSide(option)


def _assert_greeks(got: tgreeks.MCGreeks, want: jgreeks.MCGreeks, *, price_rtol: float,
                   rtol: float, atol: float, gamma_rtol: float, gamma_atol: float = 0.0,
                   skip: tuple[str, ...] = ()) -> None:
    assert got.price == pytest.approx(want.price, rel=price_rtol, abs=1e-12)
    assert tuple(got.by_field) == tuple(want.by_field)
    for field, value in want.by_field.items():
        if field not in skip:
            assert got.by_field[field] == pytest.approx(value, rel=rtol, abs=atol), field
    assert got.gamma == pytest.approx(want.gamma, rel=gamma_rtol, abs=gamma_atol)


# --------------------------------------------------------------------------
# The backward rules
# --------------------------------------------------------------------------


CURVE6 = dict(vol_shape=(1.3, 0.7, 1.1, 0.9, 1.2, 0.8), rate_shape=(1.6, 0.4, 1.0, 1.0, 1.2, 0.8),
              div_shape=(0.5, 1.5, 1.0, 1.0, 1.0, 1.0))
TWO = [[101.0, 97.0, 0.8, 0.04, 0.015, 0.3], [90.0, 100.0, 1.7, 0.01, 0.03, 0.2]]
ATM = [[100.0, 100.0, 1.0, 0.03, 0.01, 0.25]]  # the JAX package's test contract


@pytest.mark.parametrize("dtype,term", [(torch.float64, None), (torch.float32, None),
                                        (torch.float64, CURVE6), (torch.float32, CURVE6)],
                         ids=["f64", "f32", "f64-term", "f32-term"])
def test_pathwise_vjp_matches_jax(dtype, term) -> None:
    """Tier 2: ``terminal_pathwise_vjp`` port vs JAX on the same ``(g, s_t,
    contract)``, flat and with a curve's factors; float64 rtol 1e-12,
    float32 rtol 1e-6 (the five reductions sum in another order)."""
    gen = np.random.default_rng(3)
    c = np.array(TWO)
    s_t = c[:, :1, None] * np.exp(0.3 * gen.standard_normal((2, 8, 32)))
    g = gen.random((2, 8, 32))
    factors = None
    if term is not None:
        factors = gbm_cuda.term_pathwise_factors(tgbm.TermStructure(**term), 6)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    got = gbm_cuda.terminal_pathwise_vjp(torch.tensor(g, dtype=dtype), torch.tensor(s_t, dtype=dtype),
                                         torch.tensor(c, dtype=dtype), factors).numpy()
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    for i in range(2):
        want = np.asarray(jpallas.terminal_pathwise_vjp(
            jnp.asarray(g[i], np_dtype), jnp.asarray(s_t[i], np_dtype), jnp.asarray(c[i], np_dtype),
            factors))
        np.testing.assert_allclose(got[i], want, rtol=rtol, atol=rtol * 1e-3)


# (dtype, contracts, key seed, steps, rows, cols, antithetic half, term, uniform weights,
# rtol): the JAX package's three cases (tests/test_gbm_pallas.py:170,193,1018), its float32
# one on its own key and contract, the float64 ones on two contracts
SCAN_CASES = {
    "f64": (torch.float64, TWO, 9, 6, 16, 64, None, None, False, 1e-9),
    "f32-antithetic": (torch.float32, ATM, 4, 4, 8, 128, 4, None, True, 2e-4),
    "f64-term": (torch.float64, TWO, 9, 6, 16, 64, None, CURVE6, False, 1e-9),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_pathwise_function_matches_autograd_through_threefry_scan(case: str) -> None:
    """Tier 2: ``TerminalPathwise`` with the threefry scan as its forward —
    the rule over the scan's own output — equals autograd through that scan
    (the same map), in the JAX package's three cases and at its gates:
    float64 rtol 1e-9 (non-uniform cotangents, flat and curved), float32
    antithetic rtol 2e-4 with atol 1e-6 on the mean's cotangent (the ``W``
    recovery's float32 rounding)."""
    dtype, contracts, seed, steps, rows, cols, anti, term, uniform, rtol = SCAN_CASES[case]
    t = None if term is None else tgbm.TermStructure(**term)
    keys = (rng.prng_key(seed)[None] if len(contracts) == 1
            else rng.fold_in(rng.prng_key(seed), torch.arange(len(contracts))))

    def simulate(p: torch.Tensor, k: torch.Tensor = keys) -> torch.Tensor:
        return tgbm.simulate_terminal_rows(k, p, timesteps=steps, rows=rows, cols=cols,
                                           dtype=dtype, scheme=tgbm.PathScheme.LOG_EULER,
                                           antithetic_half=anti, term=t)

    c = torch.tensor(contracts, dtype=dtype)
    if uniform:
        w = torch.full((len(contracts), rows, cols), 1.0 / (rows * cols), dtype=dtype)
    else:
        w = torch.linspace(0.5, 2.0, len(contracts) * rows * cols, dtype=dtype).reshape(
            len(contracts), rows, cols)
    x = c.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(torch.sum(w * simulate(x)), x)
    factors = None if t is None else gbm_cuda.term_pathwise_factors(t, steps)
    y = c.clone().requires_grad_(True)
    out = gbm_cuda.TerminalPathwise.apply(y, keys, simulate, factors)
    (got,) = torch.autograd.grad(torch.sum(w * out), y)
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6 if uniform else 1e-9)
    assert torch.equal(got, gbm_cuda.terminal_pathwise_vjp(w, simulate(c), c, factors))


@pytest.mark.parametrize("term", [None, CURVE6], ids=["flat", "term"])
def test_terminal_function_on_twin_matches_autograd_through_twin(term) -> None:
    """Tier 2: ``simulate_terminal_rows_cuda_diff`` on CPU tensors runs the
    plain twin forward (the twin's values bit for bit), and its gradient is
    the rule over those values exactly. Against autograd through the twin's
    own float32 walk the maturity and vol columns differ by the ``W``
    recovery: ``W`` read off ``log(S_T/S0)`` carries the walk's float32
    roundings of ``log S``, at most (steps + 2) ulps of ``max |log S|`` a
    path, which ``∂/∂T`` divides by 2T and ``∂/∂vol`` by vol. Those two
    columns are held within ``Σ|g·S_T|`` times that bound, the others at
    rtol 1e-6; antithetic on."""
    c = torch.tensor(TWO, dtype=torch.float32)
    keys = rng.fold_in(rng.prng_key(4), torch.arange(2))
    steps = 6
    shape = dict(timesteps=steps, rows=8, cols=128, antithetic_half=4)
    t = None if term is None else tgbm.TermStructure(**term)
    if t is None:
        def twin(p):
            return gbm_cuda.simulate_terminal_rows_cuda_plain(
                p, keys, scheme=tgbm.PathScheme.LOG_EULER, **shape)
    else:
        from spectralmc_tpu_torch.ops import dynamics_cuda

        def twin(p):
            return dynamics_cuda.simulate_term_rows_cuda_plain(
                p, keys, term=t, payoff=tgbm.PayoffKind.TERMINAL, **shape)
    w = torch.linspace(0.5, 2.0, 2 * 8 * 128).reshape(2, 8, 128) / 1024.0
    x = c.clone().requires_grad_(True)
    out = gbm_cuda.simulate_terminal_rows_cuda_diff(x, keys, term=t, **shape)
    values = twin(c)
    assert torch.equal(out.detach(), values)
    (got,) = torch.autograd.grad(torch.sum(w * out), x)
    factors = None if t is None else gbm_cuda.term_pathwise_factors(t, steps)
    assert torch.equal(got, gbm_cuda.terminal_pathwise_vjp(w, values, c, factors))
    y = c.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(torch.sum(w * twin(y)), y)
    ulp = torch.finfo(torch.float32).eps * torch.log(values.reshape(2, -1)).abs().amax(dim=1)
    w_err = (steps + 2) * ulp * torch.sum(torch.abs(w * values).reshape(2, -1), dim=1)
    bound = torch.stack([w_err / (2.0 * c[:, 2]), w_err / c[:, 5]], dim=1)
    assert torch.all(torch.abs(got[:, [2, 5]] - want[:, [2, 5]]) <= bound)
    torch.testing.assert_close(got[:, [0, 1, 3, 4]], want[:, [0, 1, 3, 4]], rtol=1e-6, atol=0.0)


def test_walk_function_matches_autograd_through_twin() -> None:
    """Tier 2: ``qmc_cuda.walk_acc`` (the ``WalkAcc`` Function) on CPU tensors
    returns the twin's sums bit for bit, and its gradient on ``(log_spot,
    drift, vol_sdt)`` through a geometric-Asian call equals autograd through
    ``walk_acc_plain`` at rtol 1e-4 (16 steps, 16,384 points, three
    contracts). The design's reason is checked too: ``B`` read off the
    forward's output, instead of the second launch at ``(0, 0, 1)``, puts
    the short, low-vol contract's ``∂/∂vol_sdt`` more than 1e-4 away."""
    steps, count = 16, 32 * 512
    keys = rng.fold_in(rng.prng_key(31), torch.arange(3))
    _, directions, shift, _ = qmc._draw_tables(keys, steps, 1, 31)
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(steps), dtype=torch.float32)
    spot = torch.tensor([100.0, 80.0, 120.0])
    mat = torch.tensor([1.0, 0.25, 2.0])
    vol = torch.tensor([0.25, 0.15, 0.45])
    rate, div = torch.tensor([0.03, 0.0, 0.08]), torch.tensor([0.01, 0.04, 0.0])
    dt = mat / steps
    scalars = (torch.log(spot), (rate - div - 0.5 * vol * vol) * dt, vol * torch.sqrt(dt))
    strike = torch.tensor([[100.0], [75.0], [110.0]])

    def payoff(acc: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.mean(torch.clamp(torch.exp(acc / steps) - strike, min=0.0), dim=1))

    def grads(walk):
        xs = [x.clone().requires_grad_(True) for x in scalars]
        acc = walk(directions, shift, bridge, 0, *xs, timesteps=steps, count=count)
        return acc.detach(), torch.autograd.grad(payoff(acc), xs)

    acc, got = grads(qmc_cuda.walk_acc)
    acc_plain, want = grads(qmc_cuda.walk_acc_plain)
    assert torch.equal(acc, acc_plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
    # the rejected design: B read off the forward's output
    a = acc.clone().requires_grad_(True)
    (g_acc,) = torch.autograd.grad(payoff(a), a)
    t = float(steps)
    ls, d, v = (x.double()[:, None] for x in scalars)
    read = (acc.double() - t * ls - t * (t + 1.0) / 2.0 * d) / v
    read_grad = torch.sum(g_acc.double() * read, dim=1)
    rel = torch.abs(read_grad - want[2].double()) / torch.abs(want[2].double())
    assert float(rel[1]) > 1e-4


# --------------------------------------------------------------------------
# mc_greeks on the threefry engine, port against JAX
# --------------------------------------------------------------------------

# (config, family, option, contract overrides); float32 unless said
XLA_CASES = {
    "terminal": (dict(), "gbm", "call", {}),
    "terminal-put": (dict(), "gbm", "put", {}),
    "asian-arithmetic": (dict(payoff="asian_arithmetic", normalization="none"), "gbm", "call", {}),
    "asian-geometric": (dict(payoff="asian_geometric"), "gbm", "call", {}),
    "antithetic": (dict(antithetic=True), "gbm", "call", {}),
    "euler": (dict(scheme="euler"), "gbm", "call", {}),
    "curved-term": (dict(term=CURVE), "gbm", "put", {}),
    "merton": (dict(model="merton_jump", batches_per_mc_run=8), "merton", "call", {}),
    "basket": (dict(model="basket_gbm"), "gbm", "call", {}),
    "cliquet": (dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=-0.05,
                     cliquet_cap=0.08, normalization="none"), "gbm", "call", {"strike": 0.02}),
    "forward-start": (dict(payoff="forward_start", forward_start_step=3), "gbm", "call", {}),
    "lookback-fixed-put": (dict(payoff="lookback_fixed_put", normalization="none"), "gbm", "put",
                           {}),
    "lookback-float-call": (dict(payoff="lookback_float_call", normalization="none"), "gbm",
                            "put", {}),
    "variance-swap": (dict(payoff="variance_swap"), "gbm", "call", {"strike": 0.05}),
    "sobol-bb-geometric": (dict(payoff="asian_geometric", sampling="sobol_bb"), "gbm", "call", {}),
    "sobol-bb-terminal": (dict(sampling="sobol_bb"), "gbm", "call", {}),
    "f64-terminal": (dict(precision="float64"), "gbm", "call", {}),
    "f64-asian-arithmetic": (dict(payoff="asian_arithmetic", precision="float64"), "gbm", "call",
                             {}),
    "f64-heston": (dict(model="heston", precision="float64"), "heston", "call", {}),
    "f64-american-put": (dict(payoff="american_put", normalization="none", precision="float64"),
                         "gbm", "put", {}),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_mc_greeks_matches_jax_on_the_threefry_engine(case: str) -> None:
    """Tier 2, ``mc_greeks`` port vs JAX on the same draw (8 steps, 16 × 64
    paths; Merton 8 × 64). Float32: price rtol 1e-5, each field rtol 1e-4 with atol 1e-6,
    gamma rtol 1e-3 with atol 1e-6 (a lookback's delta is linear in spot, so
    its gamma is rounding about 0). Float64: rtol 1e-9 everywhere, the
    American put included (the port's estimator is JAX's there, op for op).
    The float32 arithmetic Asian runs without MEAN normalization: its mean
    target's geometric series ``g·(gⁿ − 1)/(g − 1)`` cancels in float32, where
    the two ``pow`` lowerings differ (ROADMAP: arithmetic-Asian parity 2e-4);
    float64 covers it with normalization on. Heston: JAX differentiates
    ``√max(v, 0)`` at ``v = 0`` to NaN (its ``maximum`` mask times an infinite
    root slope) where torch's ``clamp`` gives 0, so the fields JAX leaves NaN
    are held finite in the port instead: exactly maturity and the variance
    fields but ρ. Merton's ``lam`` under MEAN is 0 exactly (the fixed-count
    envelope, ``mc_greeks``' docstring): both sides must hold it within
    8 float32 eps of the price."""
    kw, family, option, overrides = XLA_CASES[case]
    jsim, tsim = _sims(**{**SMALL, **kw})
    jc, tc = _contracts(family, **overrides)
    jside, tside = _side(option)
    want = jgreeks.mc_greeks(jsim, jc, option=jside)
    got = tgreeks.mc_greeks(tsim, tc, option=tside, device="cpu")
    assert got.engine == tgbm.SimImplementation.XLA
    nan_fields = tuple(f for f, v in want.by_field.items() if math.isnan(v))
    assert all(math.isfinite(got.by_field[f]) for f in nan_fields)
    # JAX's NaN lies exactly in the fields that move the variance path
    assert set(nan_fields) == ({"maturity", "v0", "kappa", "theta", "xi"} if family == "heston"
                               else set())
    skip = nan_fields
    if family == "merton":
        # under MEAN the fixed-count lam derivative is 0 exactly (the
        # compensator is a uniform rescale that the normalization cancels):
        # both sides hold float32 rounding of it, a few eps of the price
        skip += ("lam",)
        eps = float(np.finfo(np.float32).eps)
        assert max(abs(got.by_field["lam"]), abs(want.by_field["lam"])) <= 8 * eps * want.price
    if kw.get("precision") == "float64":
        _assert_greeks(got, want, price_rtol=1e-9, rtol=1e-9, atol=1e-12, gamma_rtol=1e-9,
                       gamma_atol=1e-12, skip=skip)
    else:
        _assert_greeks(got, want, price_rtol=1e-5, rtol=1e-4, atol=1e-6, gamma_rtol=1e-3,
                       gamma_atol=1e-6, skip=skip)


# --------------------------------------------------------------------------
# The "cuda" engine (its plain twins on CPU tensors)
# --------------------------------------------------------------------------

CARD_SIM = dict(timesteps=16, network_size=256, batches_per_mc_run=64, mc_seed=7,
                implementation="cuda")


@pytest.mark.parametrize("option", ["put", "call"])
def test_cuda_engine_greeks_match_black_scholes(option: str) -> None:
    """Tier 4 (statistical), on the twins: ``greeks_engine`` is ``"cuda"``,
    ``mc_greeks`` runs the Function (the TERMINAL twin forward, the rule
    backward) three times, and its price and fields lie within 3% (abs 0.004,
    the price 0.01) of ``analytic_greeks``, as the JAX package holds its
    kernel engine (16,384 paths; gamma within 15%)."""
    sim = _port_sim(**CARD_SIM)
    c = tgbm.BlackScholesContract(spot=100.0, strike=100.0, maturity=1.0, rate=0.03,
                                  div_yield=0.01, vol=0.25)
    side = tgreeks.OptionSide(option)
    assert tgreeks.greeks_engine(sim) == tgbm.SimImplementation.CUDA
    with mock.patch.object(gbm_cuda, "simulate_underlier_rows_cuda_plain",
                           wraps=gbm_cuda.simulate_underlier_rows_cuda_plain) as twin:
        mc = tgreeks.mc_greeks(sim, c, option=side, device="cpu")
    assert twin.call_count == 3
    oracle = tgreeks.analytic_greeks(c, option=side, device="cpu")
    assert mc.engine == tgbm.SimImplementation.CUDA
    assert mc.price == pytest.approx(oracle.price, rel=0.02, abs=0.01)
    for field, want in oracle.by_field.items():
        assert mc.by_field[field] == pytest.approx(want, rel=0.03, abs=0.004), field
    assert mc.gamma == pytest.approx(oracle.gamma, rel=0.15)


def test_cuda_engine_curved_term_greeks_match_effective_black() -> None:
    """Tier 4, on the term kernel's twin: a curved GBM TERMINAL sim keeps the
    ``"cuda"`` engine, and its Greeks match autograd of Black at the curve's
    effective parameters (``term_effective_black``) within 4% (abs 0.006),
    the JAX package's gate for its curved pathwise Greeks."""
    sim = _port_sim(**{**CARD_SIM, "timesteps": 8}, term=CURVE)
    c = tgbm.BlackScholesContract(spot=100.0, strike=105.0, maturity=1.0, rate=0.03,
                                  div_yield=0.01, vol=0.25)
    assert tgreeks.greeks_engine(sim) == tgbm.SimImplementation.CUDA
    mc = tgreeks.mc_greeks(sim, c, option=tgreeks.OptionSide.PUT, device="cpu")
    x = c.as_array(torch.float64, "cpu").requires_grad_(True)
    put = tanalytic.term_effective_black(*x, vol_shape=CURVE["vol_shape"],
                                         rate_shape=CURVE["rate_shape"], div_shape=()).put
    (grad,) = torch.autograd.grad(put, x)
    assert mc.engine == tgbm.SimImplementation.CUDA
    assert mc.price == pytest.approx(float(put.detach()), rel=0.02, abs=0.01)
    for i, field in enumerate(tgbm.CONTRACT_FIELDS):
        want = float(grad[i])
        assert mc.by_field[field] == pytest.approx(want, abs=max(0.04 * abs(want), 0.006)), field


def test_greeks_engine_selection() -> None:
    """Tier 1: ``"cuda"`` only for GBM PSEUDO TERMINAL log-Euler float32 (flat
    or curved) on a ``"cuda"`` sim; ``"xla"`` for every other payoff,
    scheme, sampling or dtype; a ``"pallas"`` sim is refused as
    ``GbmCVNNPricer.create`` refuses it."""
    base = dict(timesteps=4, network_size=16, batches_per_mc_run=4, mc_seed=1)
    cuda = dict(base, implementation="cuda")
    assert tgreeks.greeks_engine(_port_sim(**cuda)) == tgbm.SimImplementation.CUDA
    assert tgreeks.greeks_engine(_port_sim(**cuda, term=dict(vol_shape=(1.2, 0.8, 1.0, 1.0)))) \
        == tgbm.SimImplementation.CUDA
    for extra in (dict(payoff="asian_arithmetic"), dict(scheme="euler"),
                  dict(sampling="sobol_bb"), dict(precision="float64"), dict(model="heston")):
        sim = _port_sim(**cuda, **extra)
        assert tgreeks.greeks_engine(sim) == tgbm.SimImplementation.XLA, extra
    assert tgreeks.greeks_engine(_sims(**base)[1]) == tgbm.SimImplementation.XLA
    pallas = tgbm.build_simulation_params(**base, implementation="pallas").expect("sim")
    with pytest.raises(ValueError, match="TPU hardware PRNG"):
        tgreeks.greeks_engine(pallas)
    with pytest.raises(ValueError, match="TPU hardware PRNG"):
        tgreeks.mc_greeks(pallas, tgbm.BlackScholesContract(**GBM), device="cpu")


def test_default_device_needs_a_card() -> None:
    """Tier 1: with no card, the default ``device="cuda"`` raises and nothing
    runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs there")
    _, sim = _sims(**SMALL)
    c = tgbm.BlackScholesContract(**GBM)
    for call in (lambda: tgreeks.mc_greeks(sim, c), lambda: tgreeks.bump_greeks(sim, c),
                 lambda: tgreeks.analytic_greeks(c), lambda: tgbm.BlackScholes(sim)):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            call()
