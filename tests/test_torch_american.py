"""The port's American (LSMC) pricing on GBM against the JAX package's.

Inputs come from numpy seeds (or one threefry key both packages expand to
the same words) and go through both packages:

* ``_ridge_chol_solve`` on random SPD, singular and all-zero Grams: 1e-6
  relative (the same operations in the same order; only the float32 ops'
  platforms differ);
* ``lsmc_backward`` against ``_lsmc_backward`` on the same random rows, every
  option: the sums run in another order, so β differs in its last ulps and
  near-boundary paths may flip — mean cashflow within 2e-3 relative, at most
  2% of paths flipped (the JAX package's own gate between its backwards);
* the threefry American simulator (flat, curved, antithetic, cross-fit,
  every ∈ {1, 2, 3}, put and call): the words are bit-exact and the normals
  agree to the ``erf_inv`` ulps, so u takes the same flip gate;
* ``simulate_paths`` to rtol 1e-5 (normal ulps through the walk);
* the float64 oracles to 1e-12; ``lsmc_price`` against the Bermudan tree and
  the r = 0 / q = 0 no-premium identities;
* the American gates of ``build_simulation_params``: the same refusals,
  fields and reasons.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.ops import american as jam
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops.greeks import OptionSide as JOptionSide
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import gbm as tgbm

RIDGE_CASES = ["spd3", "spd6", "spd9", "singular", "zero"]


def _gram(case: str) -> tuple[np.ndarray, np.ndarray]:
    gen = np.random.default_rng(RIDGE_CASES.index(case))
    if case == "zero":
        return np.zeros((6, 6), np.float32), np.zeros(6, np.float32)
    k = int(case[3:]) if case.startswith("spd") else 6
    a = gen.standard_normal((k, k if case.startswith("spd") else 1)).astype(np.float32)
    return (a @ a.T).astype(np.float32), gen.standard_normal(k).astype(np.float32)


@pytest.mark.parametrize("case", RIDGE_CASES)
def test_ridge_chol_solve_matches_jax(case: str) -> None:
    g, r = _gram(case)
    k = len(r)
    want = jam._ridge_chol_solve([[jnp.float32(g[i, j]) for j in range(k)] for i in range(k)],
                                 [jnp.float32(x) for x in r], dtype=jnp.float32)
    got = tam._ridge_chol_solve([[torch.tensor([g[i, j]]) for j in range(k)] for i in range(k)],
                                [torch.tensor([x]) for x in r], dtype=torch.float32)
    want = np.array([float(b) for b in want])
    got = np.array([float(b[0]) for b in got])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1e-30))


# the JAX package's own shape for its backward-vs-backward gate
# (tests/test_lsmc_pallas.py); the split-sample fit (fit_mask) regresses on
# half the paths, so its float32 case gets twice the columns (FIT_MASK_COLS)
N_MONITOR, ROWS, COLS = 8, 128, 256
FIT_MASK_COLS = 512
STRIKE, RATE, MATURITY = 100.0, 0.03, 1.0


def _rows(seed: int, log: bool = False, cols: int = COLS) -> np.ndarray:
    gen = np.random.default_rng(seed)
    z = gen.standard_normal((N_MONITOR, ROWS, cols)).astype(np.float32)
    steps = np.float32(0.2 * np.sqrt(1.0 / N_MONITOR)) * z + np.float32(0.01 / N_MONITOR)
    logs = np.log(np.float32(STRIKE)) + np.cumsum(steps, axis=0)
    return (logs if log else np.exp(logs)).astype(np.float32)


BACKWARD_CASES = ["put", "call", "fit_mask", "cross_fit", "extra_rows", "disc_to_prev", "log"]


def _backward_pair(case: str, dtype: np.dtype) -> tuple[np.ndarray, np.ndarray]:
    """``(port, jax)`` cashflows ``[ROWS, cols]`` of one option of the
    estimator, every input rounded to float32 and computed in ``dtype``."""
    log = case == "log"
    cols = FIT_MASK_COLS if case == "fit_mask" and dtype == np.float32 else COLS
    rows = _rows(10 + BACKWARD_CASES.index(case), log=log, cols=cols).astype(dtype)
    disc = np.float32(np.exp(-RATE * MATURITY / N_MONITOR)).astype(dtype)
    jkw: dict[str, object] = dict(put=case != "call", basis_degree=5, rows_in_log_space=log)
    tkw = dict(jkw)
    if case in ("fit_mask", "cross_fit"):
        mask = (np.arange(cols) % (2 if case == "fit_mask" else 3) == 0).astype(dtype)
        name = "fit_mask" if case == "fit_mask" else "cross_fit_mask"
        jkw[name], tkw[name] = jnp.asarray(mask), torch.from_numpy(mask)
    if case == "extra_rows":
        extra = (0.04 + 0.02 * np.random.default_rng(3).random((N_MONITOR, ROWS, cols)))
        extra = extra.astype(np.float32).astype(dtype)
        jkw["extra_rows"], tkw["extra_rows"] = jnp.asarray(extra), torch.from_numpy(extra)[None]
    if case == "disc_to_prev":
        seg = np.exp(-RATE * np.linspace(0.5, 1.5, N_MONITOR) / N_MONITOR)
        seg = seg.astype(np.float32).astype(dtype)
        jkw["disc_to_prev"], tkw["disc_to_prev"] = jnp.asarray(seg), torch.from_numpy(seg)[None]
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    want = jam._lsmc_backward(jnp.asarray(rows), strike=jnp.asarray(STRIKE, dtype),
                              disc=jnp.asarray(disc), dtype=jnp.dtype(dtype), **jkw)
    got = tam.lsmc_backward(torch.from_numpy(rows)[None],
                            strike=torch.tensor([STRIKE], dtype=tdtype),
                            disc=torch.from_numpy(np.asarray([disc])), dtype=tdtype, **tkw)
    return got[0].numpy(), np.asarray(want)


def _same_cashflows(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert abs(got.mean() - want.mean()) <= max(2e-3 * abs(want.mean()), 2e-3)
    assert np.mean(~np.isclose(got, want, rtol=1e-5, atol=1e-6)) <= 0.02


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_lsmc_backward_matches_jax(case: str) -> None:
    """float32: the statistical gate, mean within 2e-3 and at most 2% of
    paths flipped. The split-sample fit (``fit_mask``) runs at 512 columns:
    at 256 its half-sample β is loose enough that a flip at one date moves
    the next date's β and the flips cascade (2.45% of paths there, 0.15% at
    512); the float64 case below shows the estimators equal decision for
    decision."""
    _same_cashflows(*_backward_pair(case, np.float32))


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_lsmc_backward_matches_jax_exactly_in_float64(case: str) -> None:
    """float64 on the same float32-rounded inputs: the reduction orders'
    ulps stay far below every exercise boundary, so no path flips and the
    cashflows agree to 1e-9 relative — the estimators are the same."""
    got, want = _backward_pair(case, np.float64)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


KEY = jax.random.PRNGKey(3)
KEY_WORDS = torch.from_numpy(np.asarray(jax.random.key_data(KEY)).astype(np.int64))
CONTRACT = np.array([100.0, 105.0, 1.0, 0.05, 0.01, 0.25], dtype=np.float32)
CURVE = dict(vol_shape=tuple(1.5 - i / 6 for i in range(6)),
             rate_shape=tuple(0.5 + i / 6 for i in range(6)))

SIM_CASES = [
    ("every1", dict(exercise_every=1)),
    ("every2", dict(exercise_every=2)),
    ("every3", dict(exercise_every=3)),
    ("antithetic", dict(exercise_every=2, antithetic_half=4)),
    ("cross_fit", dict(exercise_every=1, cross_fit=True)),
    ("curved", dict(exercise_every=2, term=CURVE)),
    ("call", dict(exercise_every=1, call=True)),
]


@pytest.mark.parametrize("kw", [kw for _, kw in SIM_CASES], ids=[n for n, _ in SIM_CASES])
def test_threefry_american_simulator_matches_jax(kw: dict) -> None:
    kw = dict(kw)
    call = kw.pop("call", False)
    term = kw.pop("term", None)
    common = dict(timesteps=6, rows=8, cols=128, basis_degree=5, **kw)
    want = jam.simulate_american_underlier_rows(
        KEY, jnp.asarray(CONTRACT), dtype=jnp.float32,
        option=JOptionSide.CALL if call else JOptionSide.PUT,
        term=None if term is None else jgbm.TermStructure(**term), **common)
    got = tam.simulate_american_underlier_rows(
        KEY_WORDS[None], torch.from_numpy(CONTRACT)[None], dtype=torch.float32,
        option=tam.OptionSide.CALL if call else tam.OptionSide.PUT,
        term=None if term is None else tgbm.TermStructure(**term), **common)[0].numpy()
    want = np.asarray(want)
    # u = K − cf/df: compare the cashflows it encodes
    df = float(np.exp(-CONTRACT[3] * CONTRACT[2]))
    _same_cashflows((CONTRACT[1] - got) * df, (CONTRACT[1] - want) * df)


@pytest.mark.parametrize("scheme,normalize,term", [
    ("log_euler", False, None), ("euler", True, None), ("log_euler", True, CURVE),
])
def test_simulate_paths_matches_jax(scheme: str, normalize: bool, term: dict | None) -> None:
    want = jgbm.simulate_paths(KEY, jnp.asarray(CONTRACT), timesteps=6, paths=256,
                               dtype=jnp.float32, scheme=jgbm.PathScheme(scheme),
                               normalize=normalize,
                               term=None if term is None else jgbm.TermStructure(**term))
    got = tgbm.simulate_paths(KEY_WORDS[None], torch.from_numpy(CONTRACT)[None], timesteps=6,
                              paths=256, dtype=torch.float32, scheme=tgbm.PathScheme(scheme),
                              normalize=normalize,
                              term=None if term is None else tgbm.TermStructure(**term))
    assert got.shape == (1, 6, 256)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5)


ORACLE = dict(spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25)


@pytest.mark.parametrize("option", ["put", "call"])
def test_bermudan_oracles_match_jax(option: str) -> None:
    c = dict(ORACLE, div_yield=0.08, strike=95.0) if option == "call" else ORACLE
    assert tam.bermudan_tree_price(**c, exercise_dates=16, tree_steps=800, option=option) == \
        pytest.approx(jam.bermudan_tree_price(**c, exercise_dates=16, tree_steps=800,
                                              option=option), rel=1e-12)
    kw = dict(**c, timesteps=6, exercise_every=2, option=option, grid_points=513, **CURVE)
    assert tam.bermudan_grid_price(**kw) == pytest.approx(jam.bermudan_grid_price(**kw),
                                                          rel=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(split_sample=True), dict(cross_fit=True)],
                         ids=["classic", "split_sample", "cross_fit"])
def test_lsmc_cashflows_match_jax(kw: dict) -> None:
    want, want_t = jam.lsmc_cashflows(KEY, jnp.asarray(CONTRACT), timesteps=8, paths=1 << 15,
                                      dtype=jnp.float32, **kw)
    got, got_t = tam.lsmc_cashflows(KEY_WORDS[None], torch.from_numpy(CONTRACT)[None],
                                    timesteps=8, paths=1 << 15, dtype=torch.float32, **kw)
    np.testing.assert_allclose(got_t[0].numpy(), np.asarray(want_t), rtol=1e-5)
    _same_cashflows(got[0].numpy(), np.asarray(want))


PRICE_PATHS = 1 << 15


PRICE_CASES = [
    ("xla", "xla", {}),
    ("cuda", "cuda", {}),
    ("cuda-split_sample", "cuda", dict(split_sample=True)),
    ("cuda-cross_fit", "cuda", dict(cross_fit=True)),
]


@pytest.mark.parametrize("implementation,kw", [(i, kw) for _, i, kw in PRICE_CASES],
                         ids=[name for name, _, _ in PRICE_CASES])
def test_lsmc_price_against_the_tree(implementation: str, kw: dict) -> None:
    """A put on the tree's own 16 monitor dates: within max(4 SE, 1%) (the
    JAX package's tolerance; degree 5 is ≈ 0.1% low at this budget); on the
    ``"cuda"`` engine (its twins here) too, with each of its estimators."""
    contract = tgbm.BlackScholesContract(**ORACLE)
    got = tam.lsmc_price(KEY_WORDS, contract, timesteps=16, paths=PRICE_PATHS,
                         implementation=tgbm.SimImplementation(implementation), device="cpu",
                         **kw)
    want = tam.bermudan_tree_price(**ORACLE, exercise_dates=16)
    assert abs(got.price - want) <= max(4 * got.std_error, 0.01 * want)
    assert got.cv_std_error < got.std_error
    assert abs(got.cv_price - want) <= max(4 * got.cv_std_error, 0.01 * want)
    if implementation == "xla":
        jax_price = jam.lsmc_price(KEY, jgbm.BlackScholesContract(**ORACLE), timesteps=16,
                                   paths=PRICE_PATHS)
        assert got.price == pytest.approx(jax_price.price, rel=2e-3)
        assert got.european == pytest.approx(jax_price.european, rel=1e-4)


@pytest.mark.parametrize("option", ["put", "call"])
def test_no_premium_identities(option: str) -> None:
    """r = 0 put and q = 0 call: early exercise is worth nothing, so the
    Bermudan price is the Black price within max(4 SE, 0.5%) (the JAX
    package's gate)."""
    from spectralmc_tpu_torch.ops.analytic import black_scholes_price

    c = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.0, div_yield=0.0, vol=0.25)
    if option == "call":
        c = dict(c, rate=0.05)
    got = tam.lsmc_price(KEY_WORDS, tgbm.BlackScholesContract(**c), timesteps=12,
                         paths=PRICE_PATHS, option=tam.OptionSide(option), device="cpu")
    black = black_scholes_price(*c.values())
    want = float(black.put if option == "put" else black.call)
    assert abs(got.price - want) <= max(4 * got.std_error, 0.005 * want)


def test_lsmc_price_runs_where_the_caller_says() -> None:
    """No default device: leaving it out is an error, and a key on another
    device than the one asked for is refused, never copied over."""
    contract = tgbm.BlackScholesContract(**ORACLE)
    with pytest.raises(TypeError, match="device"):
        tam.lsmc_price(KEY_WORDS, contract, timesteps=4, paths=64)
    with pytest.raises(ValueError, match="meta"):
        tam.lsmc_price(KEY_WORDS.to("meta"), contract, timesteps=4, paths=64, device="cpu")


BASE = dict(timesteps=8, network_size=16, batches_per_mc_run=8, mc_seed=1,
            normalization="none")
GATE_CASES = [
    ("euler", dict(payoff="american_put", scheme="euler")),
    ("degree_0", dict(payoff="american_put", lsmc_basis_degree=0)),
    ("degree_9", dict(payoff="american_call", lsmc_basis_degree=9)),
    ("every_3", dict(payoff="american_put", lsmc_exercise_every=3)),
    ("one_date", dict(payoff="american_put", lsmc_exercise_every=8)),
    ("cross_fit_narrow", dict(payoff="american_put", lsmc_cross_fit=True, network_size=1)),
    ("fused_cross_fit", dict(payoff="american_put", lsmc_cross_fit=True,
                             lsmc_fused_backward=True)),
    ("fused_curved", dict(payoff="american_put", lsmc_fused_backward=True,
                          term=dict(rate_shape=(0.5,) * 4 + (1.5,) * 4))),
    ("sobol", dict(payoff="american_put", sampling="sobol_bb")),
    ("mean", dict(payoff="american_put", normalization="mean")),
    ("european_cross_fit", dict(payoff="terminal", lsmc_cross_fit=True)),
    ("european_fused", dict(payoff="asian_arithmetic", lsmc_fused_backward=True)),
]


@pytest.mark.parametrize("kw", [kw for _, kw in GATE_CASES], ids=[n for n, _ in GATE_CASES])
def test_american_gates_match_jax(kw: dict) -> None:
    kw = {**BASE, **kw}
    jkw, tkw = dict(kw), dict(kw)
    if "term" in kw:
        jkw["term"] = jgbm.TermStructure(**kw["term"])
        tkw["term"] = tgbm.TermStructure(**kw["term"])
    want = jgbm.build_simulation_params(**jkw)
    got = tgbm.build_simulation_params(**tkw)
    assert want.is_failure() and got.is_failure()
    assert (got.error.field, got.error.reason) == (want.error.field, _port_scope(want.error.reason))


def _port_scope(reason: str) -> str:
    """The JAX reason as the port words it: the fused-backward refusals drop
    their pointers to the TPU kernel's VMEM budget and module."""
    for tpu_only in (" past its VMEM budget (ops/lsmc_pallas.py scope)",
                     " (ops/lsmc_pallas.py scope)"):
        reason = reason.replace(tpu_only, "")
    return reason


def test_gbm_american_builds_and_other_dynamics_wait() -> None:
    """GBM American builds, and so does American under the other dynamics
    now that it is ported: the same parameters as JAX's build, and a
    simulator that runs (the Merton put's threefry forward and its torch
    estimator, finite underliers of the batch's shape)."""
    from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator

    sim = tgbm.build_simulation_params(**BASE, payoff="american_call", lsmc_exercise_every=2,
                                       lsmc_fused_backward=True).expect("sim")
    assert sim.payoff == tgbm.PayoffKind.AMERICAN_CALL
    kw = dict(**BASE, payoff="american_put", model="merton_jump")
    got = tgbm.build_simulation_params(**kw).expect("merton american")
    want = jgbm.build_simulation_params(**kw).expect("jax merton american")
    assert got.model_dump(mode="json") == want.model_dump(mode="json")
    contracts = torch.tensor([[100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 0.5, -0.1, 0.15]])
    u = make_underlier_simulator(got, rows=8)(KEY_WORDS[None], contracts)
    assert u.shape == (1, 8, 16) and bool(torch.isfinite(u).all())
