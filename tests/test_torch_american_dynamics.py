"""American (LSMC) pricing under Heston, Merton and baskets: the port against the JAX package.

* The threefry state rows (``heston_state_rows``, ``merton_state_rows``,
  ``basket_state_rows``) against JAX's on the same keys. Tier 2: the words
  are bit-exact and the normals agree to the ``erf_inv`` lowering's ulps, so
  prices agree to rtol 2e-5, Heston's variance to atol 1e-6 + rtol 2e-5 and
  the arithmetic basket's log dispersion (a difference of two values near
  ``ln S``) to 2e-5 of ``|ln B|``. Tier 1, exact: the port's last state row
  is its European simulator's TERMINAL value (the JAX tests' "forward
  stream bit parity").
* ``simulate_{heston,merton,basket}_american_underlier_rows`` against JAX:
  in float32 statistically (the regression sums run in another order, so β
  differs in its last ulps and paths near the exercise boundary flip: mean
  cashflow within 2e-3 relative, at most 2% of paths flipped, the JAX
  package's gate between its backwards); their Bermudan tail in float64
  exactly on shared state rows (rtol 1e-9: no path flips).
* ``build_simulation_params`` fails exactly where JAX's does, with the same
  field, value and reason (the fused-backward reasons without their TPU
  pointers), over model × side × market data × sampling × estimator; where
  it succeeds, the ``"cuda"`` engine's engine, backward and stream follow
  the design (``resolve_implementation``, ``resolve_lsmc_backward``,
  ``cuda_stream_version``).
* A Heston American put through ``GbmCVNNPricer`` in both packages: 3 steps
  on the threefry engine from the same seeded weights, losses within rtol
  1e-4 at 65,536 paths a contract, served puts within rtol 5e-5 and calls
  NaN. A flipped exercise moves a target by a path's cashflow: with the
  9-column basis (degree 5 and ``[v, v·x, v²]``) the third loss was 1.1e-4
  off at 32,768 paths (the GBM put's size) and 6.3e-5 at 65,536.
  On the ``"cuda"`` engine's twins every family records its kernel's stream
  and backward, a call pricer serves ``.call``, and resume is bit-exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import american as jam
from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.ops.greeks import OptionSide as JOptionSide
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import american_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.ops.basket import simulate_basket_underlier_rows
from spectralmc_tpu_torch.ops.heston import simulate_heston_underlier_rows
from spectralmc_tpu_torch.ops.merton import simulate_merton_underlier_rows
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr
from test_torch_american import _port_scope
from test_torch_slice import _cvnn, _train

FAMILIES = ["heston", "merton", "basket_arithmetic", "basket_geometric"]
LO = {"heston": [80.0, 80.0, 0.25, 0.0, 0.0, 0.03, 1.0, 0.03, 0.2, -0.8],
      "merton": [80.0, 80.0, 0.25, 0.0, 0.0, 0.15, 0.1, -0.15, 0.1],
      "basket": [80.0, 80.0, 0.25, 0.0, 0.0, 0.15]}
HI = {"heston": [120.0, 120.0, 2.0, 0.08, 0.04, 0.08, 2.5, 0.08, 0.5, -0.3],
      "merton": [120.0, 120.0, 2.0, 0.08, 0.04, 0.25, 0.8, 0.0, 0.25],
      "basket": [120.0, 120.0, 2.0, 0.08, 0.04, 0.45]}
BASKET_KW = dict(weights=(0.5, 0.3, 0.2),
                 correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)),
                 spot_multipliers=(1.0, 0.95, 1.05), vol_multipliers=(1.0, 1.2, 0.8))
STEPS, ROWS, COLS = 6, 8, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the twins and trainer steps are many
    small ops, which torch's thread pool slows tenfold and more while the
    suite's other workers hold the cores (past the suite's 120 s limit a
    test fails)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kind(family: str) -> str:
    return family.split("_")[0]


def _contracts(family: str, n: int, seed: int) -> np.ndarray:
    lo, hi = np.array(LO[_kind(family)]), np.array(HI[_kind(family)])
    return (lo + (hi - lo) * np.random.default_rng(seed).random((n, len(lo)))).astype(np.float32)


def _spec(family: str, mod=tbasket):
    return mod.build_basket_spec(**BASKET_KW, combine=family.split("_")[1]).expect("spec")


JKEYS = [jax.random.fold_in(jax.random.PRNGKey(9), d) for d in range(2)]
TKEYS = rng.fold_in(rng.prng_key(9), torch.arange(2))


def _jax_state_rows(family: str, c: np.ndarray, key: jax.Array, half: int | None,
                    dtype=jnp.float32) -> tuple[np.ndarray, np.ndarray | None]:
    """JAX's state rows for one contract: (price-space rows, second state)."""
    keys, sign = jgbm._row_streams(key, rows=ROWS, row_offset=0, antithetic_half=half,
                                   dtype=dtype)
    a = jnp.asarray(c, dtype)
    dt = a[2] / jnp.asarray(STEPS, dtype)
    if family == "heston":
        log_rows, v_rows = jam.heston_state_rows(
            keys, sign, spot=a[0], v0=a[5], timesteps=STEPS, rows=ROWS, cols=COLS, dtype=dtype,
            rate=a[3], div_yield=a[4], dt=dt, sqrt_dt=jnp.sqrt(dt), rho=a[9],
            rho_bar=jnp.sqrt(1.0 - a[9] * a[9]), kappa=a[6], theta=a[7], xi=a[8])
        return np.exp(np.asarray(log_rows)), np.asarray(v_rows)
    if family == "merton":
        m = jnp.exp(a[7] + 0.5 * a[8] * a[8]) - 1.0
        log_rows = jam.merton_state_rows(
            keys, sign, spot=a[0], timesteps=STEPS, rows=ROWS, cols=COLS, dtype=dtype,
            drift=(a[3] - a[4] - a[6] * m - 0.5 * a[5] * a[5]) * dt,
            vol_sqdt=a[5] * jnp.sqrt(dt), lam_dt=a[6] * dt, jump_mean=a[7], jump_std=a[8])
        return np.exp(np.asarray(log_rows)), None
    spec = _spec(family, jbasket)
    sigmas = a[5] * jnp.asarray(spec.vol_multipliers, dtype)
    lb, disp = jam.basket_state_rows(
        keys, sign, log_spots=jnp.log(a[0] * jnp.asarray(spec.spot_multipliers, dtype)),
        timesteps=STEPS, rows=ROWS, cols=COLS, dtype=dtype,
        drift=(a[3] - a[4] - 0.5 * sigmas * sigmas) * dt, sig_sqdt=sigmas * jnp.sqrt(dt),
        chol=jnp.asarray(jbasket.basket_cholesky(spec), dtype),
        weights=jnp.asarray(spec.weights, dtype), geometric=family == "basket_geometric")
    return np.exp(np.asarray(lb)), np.asarray(disp)


def _port_state_rows(family: str, c: np.ndarray, half: int | None,
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The port's state rows for a contract batch: (price-space rows, second state)."""
    dtype = torch.float32
    keys, sign = tgbm.row_keys(TKEYS, rows=ROWS, row_offset=0, antithetic_half=half, dtype=dtype)
    t = torch.from_numpy(c)
    col = [t[:, i, None, None] for i in range(t.shape[1])]
    dt = col[2] / torch.tensor(float(STEPS))
    if family == "heston":
        log_rows, v_rows = tam.heston_state_rows(
            keys, sign, spot=col[0], v0=col[5], timesteps=STEPS, rows=ROWS, cols=COLS,
            dtype=dtype, rate=col[3], div_yield=col[4], dt=dt, sqrt_dt=torch.sqrt(dt),
            rho=col[9], rho_bar=torch.sqrt(1.0 - col[9] * col[9]), kappa=col[6], theta=col[7],
            xi=col[8])
        return torch.exp(log_rows), v_rows
    if family == "merton":
        m = torch.exp(col[7] + 0.5 * col[8] * col[8]) - 1.0
        log_rows = tam.merton_state_rows(
            keys, sign, spot=col[0], timesteps=STEPS, rows=ROWS, cols=COLS, dtype=dtype,
            drift=(col[3] - col[4] - col[6] * m - 0.5 * col[5] * col[5]) * dt,
            vol_sqdt=col[5] * torch.sqrt(dt), lam_dt=col[6] * dt, jump_mean=col[7],
            jump_std=col[8])
        return torch.exp(log_rows), None
    spec = _spec(family)

    def per_asset(values: tuple[float, ...]) -> torch.Tensor:
        return torch.tensor(values)[:, None, None, None]

    sigmas = col[5] * per_asset(spec.vol_multipliers)
    lb, disp = tam.basket_state_rows(
        keys, sign, log_spots=torch.log(col[0] * per_asset(spec.spot_multipliers)),
        timesteps=STEPS, rows=ROWS, cols=COLS, dtype=dtype,
        drift=(col[3] - col[4] - 0.5 * sigmas * sigmas) * dt, sig_sqdt=sigmas * torch.sqrt(dt),
        chol=torch.as_tensor(tbasket.basket_cholesky(spec), dtype=dtype),
        weights=per_asset(spec.weights), geometric=family == "basket_geometric")
    return torch.exp(lb), disp


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("family", FAMILIES)
def test_state_rows_match_jax(family: str, antithetic: bool) -> None:
    half = ROWS // 2 if antithetic else None
    c = _contracts(family, 2, seed=3)
    got, got_extra = _port_state_rows(family, c, half)
    assert got.shape == (2, STEPS, ROWS, COLS)
    for i in range(2):
        want, want_extra = _jax_state_rows(family, c[i], JKEYS[i], half)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=2e-5)
        if family == "heston":
            np.testing.assert_allclose(got_extra[i].numpy(), want_extra, rtol=2e-5, atol=1e-6)
        elif family == "basket_arithmetic":
            tol = 2e-5 * np.abs(np.log(want))
            assert np.all(np.abs(got_extra[i].numpy() - want_extra) <= tol)
        elif family == "basket_geometric":
            assert not got_extra.any() and not want_extra.any()  # zeros: ln B is Markov


@pytest.mark.parametrize("family", FAMILIES)
def test_last_state_row_is_the_european_terminal_value(family: str) -> None:
    """Tier 1, exact: the state rows draw through the European simulator's
    own stream and step, so the last row is its TERMINAL output (the
    arithmetic basket's round trip ``exp(ln B)`` to 4 ulps)."""
    half = ROWS // 2
    c = _contracts(family, 2, seed=4)
    rows, _ = _port_state_rows(family, c, half)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, dtype=torch.float32,
              payoff=tgbm.PayoffKind.TERMINAL, antithetic_half=half)
    if family == "heston":
        terminal = simulate_heston_underlier_rows(TKEYS, torch.from_numpy(c), **kw)
    elif family == "merton":
        terminal = simulate_merton_underlier_rows(TKEYS, torch.from_numpy(c), **kw)
    else:
        terminal = simulate_basket_underlier_rows(TKEYS, torch.from_numpy(c), spec=_spec(family),
                                                  **kw)
    if family == "basket_arithmetic":
        np.testing.assert_allclose(rows[:, -1].numpy(), terminal.numpy(), rtol=4.8e-7)
    else:
        assert torch.equal(rows[:, -1], terminal)


SIM_CASES = [
    ("every1_put", dict(exercise_every=1)),
    ("every2_anti_call", dict(exercise_every=2, antithetic_half=ROWS // 2, call=True)),
    ("every3_cross_fit", dict(exercise_every=3, cross_fit=True)),
]


def _american_pair(family: str, dtype: np.dtype, kw: dict, rows: int = ROWS,
                   cols: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """``(port, jax)`` cashflows ``[C, rows, cols]`` of the threefry American
    simulator, from the encoded ``u = K − cf/df``."""
    kw = dict(kw)
    call = kw.pop("call", False)
    c = _contracts(family, 2, seed=5)
    common = dict(timesteps=STEPS, rows=rows, cols=cols, basis_degree=5, **kw)
    extra = {"spec": _spec(family)} if family.startswith("basket") else {}
    jextra = {"spec": _spec(family, jbasket)} if family.startswith("basket") else {}
    tfn = {"heston": tam.simulate_heston_american_underlier_rows,
           "merton": tam.simulate_merton_american_underlier_rows}.get(
        family, tam.simulate_basket_american_underlier_rows)
    jfn = {"heston": jam.simulate_heston_american_underlier_rows,
           "merton": jam.simulate_merton_american_underlier_rows}.get(
        family, jam.simulate_basket_american_underlier_rows)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    got = tfn(TKEYS, torch.from_numpy(c), dtype=tdtype,
              option=tam.OptionSide.CALL if call else tam.OptionSide.PUT, **extra, **common)
    want = np.stack([
        np.asarray(jfn(JKEYS[i], jnp.asarray(c[i]), dtype=jnp.dtype(dtype),
                       option=JOptionSide.CALL if call else JOptionSide.PUT, **jextra, **common))
        for i in range(2)
    ])
    df = np.exp(-c[:, 3] * c[:, 2])[:, None, None]
    return (c[:, 1, None, None] - got.numpy()) * df, (c[:, 1, None, None] - want) * df


@pytest.mark.parametrize("kw", [kw for _, kw in SIM_CASES], ids=[n for n, _ in SIM_CASES])
@pytest.mark.parametrize("family", FAMILIES)
def test_threefry_american_simulator_matches_jax(family: str, kw: dict) -> None:
    """float32 at 16,384 paths a contract: the mean cashflow within 2e-3
    relative and at most 2% of the paths flipped, a flip being a cashflow
    that moves by more than 1e-4 of the strike (the state rows' own rtol
    2e-5 moves one by about 2e-5 of the price). Below ~4,096 paths the
    9-column Heston basis is loose enough that one flip at the last date
    cascades through the earlier ones (a mean gap of 1% at 1,024 paths)."""
    kw = dict(kw, antithetic_half=16) if "antithetic_half" in kw else kw
    got, want = _american_pair(family, np.float32, kw, rows=32, cols=512)
    strike = _contracts(family, 2, seed=5)[:, 1]
    for i in range(2):
        assert np.all(np.isfinite(got[i]))
        assert abs(got[i].mean() - want[i].mean()) <= max(2e-3 * abs(want[i].mean()), 2e-3)
        assert np.mean(np.abs(got[i] - want[i]) > 1e-4 * strike[i]) <= 0.02


@pytest.mark.parametrize("family", FAMILIES)
def test_american_encode_matches_jax_exactly_in_float64(family: str) -> None:
    """float64 on the same float32 state rows (JAX's), through both
    packages' Bermudan tail (``_american_encode``) with the family's second
    state: the reduction orders' ulps stay far below every exercise
    boundary, so the cashflows agree path by path — the same estimator.
    (Both simulators draw float32 normals only where the dtype is float32:
    JAX's float64 draws take 64-bit uniforms, the port's threefry normals
    stay float32, so float64 runs are compared on shared rows.)"""
    c = _contracts(family, 1, seed=6)[0]
    keys, sign = jgbm._row_streams(JKEYS[0], rows=ROWS, row_offset=0, antithetic_half=None,
                                   dtype=jnp.float32)
    rows, extra = _jax_state_rows(family, c, JKEYS[0], None)
    log_rows = np.log(rows).astype(np.float64)
    if family == "heston":
        extra = np.maximum(extra, 0.0)
    elif family != "basket_arithmetic":
        extra = None
    extra = None if extra is None else extra.astype(np.float64)
    every = 2
    c64 = c.astype(np.float64)
    dt = c64[2] / STEPS
    want = jam._american_encode(
        jnp.asarray(log_rows), timesteps=STEPS, exercise_every=every,
        strike=jnp.float64(c64[1]), maturity=jnp.float64(c64[2]), rate=jnp.float64(c64[3]),
        dt=jnp.float64(dt), dtype=jnp.float64, put=True, basis_degree=5, axis_name=None,
        extra_rows=None if extra is None else jnp.asarray(extra))
    sel = slice(every - 1, None, every)
    t64 = torch.from_numpy(c64)[None]
    got = tam._american_encode(
        torch.from_numpy(log_rows[sel])[None], timesteps=STEPS, exercise_every=every,
        strike=t64[:, 1], maturity=t64[:, 2], rate=t64[:, 3], dt=t64[:, 2] / STEPS,
        dtype=torch.float64, put=True, basis_degree=5,
        extra_rows=None if extra is None else torch.from_numpy(extra[sel])[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


# --------------------------------------------------------------------------
# Config parity: model × side × market data × sampling × estimator
# --------------------------------------------------------------------------

MODELS = ["gbm", "heston", "merton_jump", "basket_arithmetic", "basket_geometric"]
MARKETS = {"flat": None, "curved_rate": dict(rate_shape=(0.5, 0.8, 1.1, 1.4)),
           "vol_curve": dict(vol_shape=(1.3, 1.1, 0.9, 0.7))}
ESTIMATORS = {"fused": dict(lsmc_fused_backward=True), "cross_fit": dict(lsmc_cross_fit=True)}
PARITY = [(m, p, k, s, e) for m in MODELS for p in ("american_put", "american_call")
          for k in MARKETS for s in ("pseudo", "sobol_bb") for e in ESTIMATORS]


def _config_kwargs(model: str, payoff: str, market: str, sampling: str, estimator: str,
                   mod_gbm, mod_basket) -> dict:
    kw = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=1, payoff=payoff,
              normalization="none", model=model.split("_")[0] if model.startswith("basket")
              else model, sampling=sampling, **ESTIMATORS[estimator])
    if model.startswith("basket"):
        kw["model"] = "basket_gbm"
        kw["basket"] = mod_basket.build_basket_spec(
            **BASKET_KW, combine=model.split("_")[1]).expect("spec")
    if MARKETS[market] is not None:
        kw["term"] = mod_gbm.TermStructure(**MARKETS[market])
    return kw


@pytest.mark.parametrize("model,payoff,market,sampling,estimator", PARITY,
                         ids=["-".join(c) for c in PARITY])
def test_american_config_parity(model: str, payoff: str, market: str, sampling: str,
                                estimator: str) -> None:
    """The first failure equals JAX's (field, value and reason); a config
    both accept resolves on the ``"cuda"`` engine as designed: the monitor
    kernel of its dynamics on flat market data (a curved GBM config runs the
    threefry forward), the CUDA backward for the single-state classic
    estimator (GBM, Merton, the geometric basket), the torch estimator for
    the two-state families and cross-fit, stream ``american_{model}`` (v3
    for GBM, else v2)."""
    args = (model, payoff, market, sampling, estimator)
    want = jgbm.build_simulation_params(**_config_kwargs(*args, jgbm, jbasket))
    got = tgbm.build_simulation_params(**_config_kwargs(*args, tgbm, tbasket))
    assert got.is_failure() == want.is_failure()
    if want.is_failure():
        assert (got.error.field, got.error.value, got.error.reason) == (
            want.error.field, want.error.value, _port_scope(want.error.reason))
        return
    sim = got.value.model_copy(update={"implementation": tgbm.SimImplementation.CUDA})
    flat = market == "flat"
    assert tgbm.resolve_implementation(sim) == (
        tgbm.SimImplementation.CUDA if flat else tgbm.SimImplementation.XLA)
    two_state = model in ("heston", "basket_arithmetic")
    classic = estimator == "fused" and flat and not two_state
    assert american_cuda.resolve_lsmc_backward(sim, rows=sim.batches_per_mc_run) == (
        american_cuda.LSMC_BACKWARD_VERSIONS["cuda"] if classic else 0)
    # GBM's monitor stream is v3 (its pair steps the flat kernel's); the
    # others are v2 (the basket's draws on the SFU, Heston's and Merton's
    # draws and steps on fixed roundings, Merton's three words a step)
    assert gbm_cuda.cuda_stream_version(sim.model, sim.payoff) == (3 if model == "gbm" else 2)


# --------------------------------------------------------------------------
# The trainer: a Heston American put in both packages
# --------------------------------------------------------------------------

HESTON_BOUNDS = {"spot": (95.0, 105.0), "strike": (95.0, 105.0), "maturity": (0.5, 1.5),
                 "rate": (0.01, 0.05), "div_yield": (0.0, 0.02), "v0": (0.03, 0.08),
                 "kappa": (1.0, 2.5), "theta": (0.03, 0.08), "xi": (0.2, 0.5),
                 "rho": (-0.8, -0.3)}
HESTON_SIM = dict(timesteps=6, network_size=16, batches_per_mc_run=4096, mc_seed=5,
                  model="heston", payoff="american_put", normalization="none",
                  lsmc_exercise_every=2)
HESTON_CONTRACTS = np.array([[100.0, 104.0, 1.0, 0.04, 0.01, 0.05, 1.5, 0.05, 0.3, -0.6],
                             [97.0, 96.0, 0.7, 0.02, 0.015, 0.07, 2.0, 0.04, 0.4, -0.4]],
                            dtype=np.float32)


def _heston_config(mod_gbm, mod_sobol, mod_f, mod_tr, **overrides: object):
    sim = mod_gbm.build_simulation_params(**{**HESTON_SIM, **overrides}).expect("sim")
    bounds = {k: mod_sobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in HESTON_BOUNDS.items()}
    return mod_tr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(mod_f),
                                      normalize_inputs=True)


@pytest.fixture(scope="module")
def heston_pair():
    jp = jtr.GbmCVNNPricer.create(_heston_config(jgbm, jsobol, jf, jtr)).expect("jax pricer")
    tp = ttr.GbmCVNNPricer.create(_heston_config(tgbm, tsobol, tf, ttr),
                                  device="cpu").expect("port pricer")
    return jp, tp, _train(jp, jtr, jstep, 3), _train(tp, ttr, tstep, 3)


def test_heston_american_put_three_steps_match_jax(heston_pair) -> None:
    """Tier 2: losses within rtol 1e-4 at 65,536 paths a contract; 10
    inputs; the threefry engine and the torch estimator (backward 0)."""
    jp, tp, jl, tl = heston_pair
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    snap = tp.snapshot()
    assert snap.sim.implementation == tgbm.SimImplementation.XLA
    assert snap.lsmc_backward_version == jp.snapshot().lsmc_backward_version == 0
    assert tstep.contract_dim(snap.sim) == 10


def test_heston_american_put_serves_like_jax(heston_pair) -> None:
    jp, tp, _, _ = heston_pair
    want = jp.predict_price(HESTON_CONTRACTS)
    got = tp.predict_price(HESTON_CONTRACTS)
    np.testing.assert_allclose(got.put, want.put, rtol=5e-5)
    assert np.all(np.isnan(got.call)) and np.all(np.isnan(want.call))


@pytest.mark.parametrize("model", ["heston", "merton_jump", "basket_gbm"])
def test_cuda_engine_american_pricer_records_its_kernel_and_resumes(model: str) -> None:
    """On the ``"cuda"`` engine (its twins on the CPU): the engine, the
    stream ``american_{model}`` (v2) and the
    family's backward are recorded,
    the mean target is None, a call pricer serves ``.call`` with the put
    NaN, and resume is bit-exact."""
    overrides: dict[str, object] = dict(implementation="cuda", model=model,
                                        payoff="american_call", batches_per_mc_run=64)
    bounds = HESTON_BOUNDS
    if model != "heston":
        bounds = {k: v for k, v in HESTON_BOUNDS.items()
                  if k in ("spot", "strike", "maturity", "rate", "div_yield")}
        bounds["vol"] = (0.15, 0.25)
        if model == "merton_jump":
            bounds.update(lam=(0.1, 0.8), jump_mean=(-0.15, 0.0), jump_std=(0.1, 0.25))
        else:
            overrides["basket"] = tbasket.build_basket_spec(
                **BASKET_KW, combine="geometric").expect("spec")
    sim = tgbm.build_simulation_params(**{**HESTON_SIM, **overrides}).expect("sim")
    cfg = ttr.GbmCVNNPricerConfig(
        sim=sim, bounds={k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in bounds.items()},
        cvnn=_cvnn(tf), normalize_inputs=True)
    assert tstep.make_mean_target(sim)(torch.ones((2, len(bounds)))) is None
    a = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("a")
    gbm_cuda.reset_launches()
    _train(a, ttr, tstep, 1)
    branch = {"heston": "american_heston", "merton_jump": "american_merton",
              "basket_gbm": "american_basket"}[model]
    assert gbm_cuda.LAUNCHES_BY_BRANCH[branch] == 0  # the twins ran: no kernel on the CPU
    snap = a.snapshot()
    assert (snap.sim.implementation, snap.cuda_stream_version) == (
        tgbm.SimImplementation.CUDA, 2)
    assert snap.lsmc_backward_version == (4 if model == "heston" else 3)
    pred = a.predict_price(np.asarray(
        [[float(np.mean(v)) for v in bounds.values()]], dtype=np.float32))
    assert np.all(np.isfinite(pred.call)) and np.all(np.isnan(pred.put))
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, tstep, 1), _train(b, ttr, tstep, 1))
