"""The port's QMC path sampling (Sobol + Brownian bridge) against the JAX package's.

(a) tier 1, exact: ``brownian_bridge_matrix`` (float64, and orthogonal to
    1e-10), ``_qmc_tables``, the scrambled Sobol words, the inverse CDF's top
    bucket (``0xFFFFFF`` gives ``√2·erf⁻¹(1 − 2⁻²⁴)``, not inf).
(b) tier 2, atol 2e-6: ``qmc_effective_normals_multi`` for F = 1, 2, 3 and a
    padded case (T·F > 64) against the JAX package's XLA path; the normals
    differ by ulps of ``log1p`` inside ``erf_inv`` (|z| <= 5.5), carried by
    the ``[T, T]`` bridge (|B| <= 1).
(c) the kernel twins against the Pallas kernels in interpret mode, as
    ``tests/test_qmc_pallas.py`` runs them: #13's twin within atol 2e-6,
    #14's within rtol 1e-6 of the accumulated ``Σ log S_t``.
(d) the ``SOBOL_BB`` branches of the GBM, Heston, Merton and basket
    simulators against the JAX package's (tier 2, rtol 2e-5; 1e-4 where a
    payoff differences values near ln S); the fused walk equals the scan over
    the generator's normals bit for bit; the refusals (American, antithetic).
(e) the trainer: ``SOBOL_BB`` GBM (geometric Asian, TERMINAL), Heston,
    Merton and basket configs snapshot and resume bit-exactly, record the
    threefry engine, keep ``sampling`` in the checkpoint and serve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_payoffs import PAYOFF_KNOBS, _cvnn, _train

from spectralmc_tpu.ops import basket as jb
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import heston as jh
from spectralmc_tpu.ops import merton as jm
from spectralmc_tpu.ops import qmc as jq
from spectralmc_tpu.ops import qmc_pallas as jqp
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import basket as tb
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import heston as th
from spectralmc_tpu_torch.ops import merton as tm
from spectralmc_tpu_torch.ops import qmc as tq
from spectralmc_tpu_torch.ops import qmc_cuda, rng
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

SEED = 9


def _keys(n: int, seed: int = 4) -> tuple[list, torch.Tensor]:
    jax_keys = [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n)]
    return jax_keys, rng.fold_in(rng.prng_key(seed), torch.arange(n))


# --------------------------------------------------------------------------
# (a) tables, words, the inverse CDF
# --------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 2, 5, 16, 64])
def test_bridge_matrix_equals_jax_and_is_orthogonal(steps: int) -> None:
    got = tq.brownian_bridge_matrix(steps)
    np.testing.assert_array_equal(got, jq.brownian_bridge_matrix(steps))
    np.testing.assert_allclose(got @ got.T, np.eye(steps), atol=1e-10)
    assert tq.brownian_bridge_matrix(steps) is got  # cached


@pytest.mark.parametrize("dims,seed", [(1, 0), (16, 9), (48, 12345), (64, 7)])
def test_qmc_tables_equal_jax(dims: int, seed: int) -> None:
    got_dirs, got_shift = tq._qmc_tables(dims, seed)
    want_dirs, want_shift = jq._qmc_tables(dims, seed)
    np.testing.assert_array_equal(got_dirs, want_dirs)
    np.testing.assert_array_equal(got_shift, want_shift)
    assert tq.qmc_sobol_dims(dims, 2) == jq.qmc_sobol_dims(dims, 2)


@pytest.mark.parametrize("start", [0, 37, 1 << 20])
def test_sobol_words_equal_jax(start: int) -> None:
    """The twin's words (the defining XOR over gray(n)) against the JAX
    package's split-table generator, each contract with its own shift."""
    dirs, host = jq._qmc_tables(12, SEED)
    shifts = np.stack([host ^ np.uint32(0x9E3779B9 * i & 0xFFFFFFFF) for i in range(2)])
    got = qmc_cuda.sobol_words(torch.from_numpy(dirs.astype(np.int64)),
                               torch.from_numpy(shifts.astype(np.int64)), start, 3000).numpy()
    for i in range(2):
        want = np.asarray(jsobol.sobol_uint32_t(jnp.asarray(dirs), jnp.asarray(shifts[i]),
                                                jnp.uint32(start), 3000))
        np.testing.assert_array_equal(got[i], want.astype(np.int64))


def test_inv_cdf_top_bucket_is_finite() -> None:
    words = torch.tensor([0xFFFFFF00, 0xFFFFFFFF, 0x00000000, 0x80000000], dtype=torch.int64)
    got = tq._inv_cdf(words).numpy()
    want = np.asarray(jq._inv_cdf(jnp.asarray(words.numpy().astype(np.uint32))))
    assert np.all(np.isfinite(got))
    x = torch.tensor([1.0 - 2.0**-24], dtype=torch.float32)
    top = float(torch.tensor(np.sqrt(2.0), dtype=torch.float32) * rng.erf_inv(x))
    assert got[0] == got[1] == top > 5.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------------------------
# (b) the generator against JAX's XLA path
# --------------------------------------------------------------------------

GENERATOR_CASES = [(8, 1, 8, 32, 0), (6, 2, 4, 32, 3), (5, 3, 8, 16, 1), (24, 3, 4, 16, 2)]


@pytest.mark.parametrize("steps,factors,rows,cols,offset", GENERATOR_CASES,
                         ids=["F1", "F2", "F3", "F3_padded"])
def test_effective_normals_multi_match_jax(steps: int, factors: int, rows: int, cols: int,
                                           offset: int) -> None:
    jax_keys, keys = _keys(2)
    want = np.stack([np.asarray(jq.qmc_effective_normals_multi(
        k, timesteps=steps, factors=factors, rows=rows, cols=cols, dtype=jnp.float32,
        mc_seed=SEED, row_offset=offset)) for k in jax_keys])
    got = tq.qmc_effective_normals_multi(keys, timesteps=steps, factors=factors, rows=rows,
                                         cols=cols, dtype=torch.float32, mc_seed=SEED,
                                         row_offset=offset).numpy()
    assert got.shape == want.shape == (2, steps, factors, rows, cols)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    if offset:  # shard stability: rows [offset, rows) of a run from 0
        whole = tq.qmc_effective_normals_multi(keys, timesteps=steps, factors=factors,
                                               rows=rows + offset, cols=cols,
                                               dtype=torch.float32, mc_seed=SEED).numpy()
        np.testing.assert_array_equal(got, whole[..., offset:, :])


def test_terminal_normals_are_level_zero_of_the_generator() -> None:
    """The terminal shortcut's variates are the generator's level-0 normals:
    the bridge's increments sum to W_T = √T·z₀, so Σ_t eff[t] = √T·z₀ (to the
    bridge product's float32 rounding); and they equal the JAX package's."""
    jax_keys, keys = _keys(2)
    z0 = tq.qmc_terminal_normals(keys, timesteps=8, factors=2, rows=4, cols=16,
                                 dtype=torch.float32, mc_seed=SEED, row_offset=1)
    full = tq.qmc_effective_normals_multi(keys, timesteps=8, factors=2, rows=4, cols=16,
                                          dtype=torch.float32, mc_seed=SEED, row_offset=1)
    np.testing.assert_allclose(full.double().sum(dim=1).numpy(),
                               (np.sqrt(8.0) * z0.double()).numpy(), atol=1e-5)
    want = np.asarray(jq.qmc_terminal_normals(jax_keys[0], timesteps=8, factors=2, rows=4,
                                              cols=16, dtype=jnp.float32, mc_seed=SEED,
                                              row_offset=1))
    np.testing.assert_allclose(z0[0].numpy(), want, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# (c) the kernel twins against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------


def _fused_inputs(steps: int, factors: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    dirs, host = jq._qmc_tables(steps * factors, SEED)
    shift_key = jax.random.split(jax.random.PRNGKey(4))[0]
    shift = host ^ np.asarray(jax.random.bits(shift_key, (steps * factors,), dtype=jnp.uint32))
    return dirs, shift, np.asarray(jq.brownian_bridge_matrix(steps), np.float32)


@pytest.mark.parametrize("steps,factors,start", [(8, 1, 0), (6, 2, 37), (4, 3, 1500)])
def test_bridge_twin_matches_pallas_interpret(steps: int, factors: int, start: int) -> None:
    dirs, shift, bb = _fused_inputs(steps, factors)
    want = np.asarray(jqp._fused_effective_normals(
        jnp.asarray(dirs), jnp.asarray(shift), jnp.asarray(bb), start, timesteps=steps,
        factors=factors, count=1024, interpret=True))
    got = qmc_cuda.bridge_normals(
        torch.from_numpy(dirs.astype(np.int64)), torch.from_numpy(shift.astype(np.int64))[None],
        torch.from_numpy(bb), start, timesteps=steps, factors=factors, count=1024)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("start", [0, 37])
def test_walk_twin_matches_pallas_interpret(start: int) -> None:
    dirs, shift, bb = _fused_inputs(8, 1)
    scalars = np.array([4.6, 0.001, 0.07], dtype=np.float32)
    want = np.asarray(jqp._fused_qmc_walk_acc(
        jnp.asarray(dirs), jnp.asarray(shift), jnp.asarray(bb), start,
        *(jnp.float32(x) for x in scalars), timesteps=8, count=1024, interpret=True))
    got = qmc_cuda.walk_acc(
        torch.from_numpy(dirs.astype(np.int64)), torch.from_numpy(shift.astype(np.int64))[None],
        torch.from_numpy(bb), start, *(torch.tensor([x]) for x in scalars), timesteps=8,
        count=1024)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_plain_walk_is_the_bridge_twin_plus_the_scan() -> None:
    """Tier 1, exact: #14's twin equals #13's twin walked by the scan."""
    dirs, shift, bb = _fused_inputs(8, 1)
    args = (torch.from_numpy(dirs.astype(np.int64)),
            torch.from_numpy(shift.astype(np.int64))[None], torch.from_numpy(bb), 5)
    eff = qmc_cuda.bridge_normals_plain(*args, timesteps=8, factors=1, count=512)[0, :, 0]
    logx, acc = torch.full((512,), 4.6), torch.zeros(512)
    for t in range(8):
        logx = (logx + torch.tensor(0.001)) + torch.tensor(0.07) * eff[t]
        acc = acc + logx
    got = qmc_cuda.walk_acc_plain(*args, torch.tensor([4.6]), torch.tensor([0.001]),
                                  torch.tensor([0.07]), timesteps=8, count=512)[0]
    assert torch.equal(got, acc)


# --------------------------------------------------------------------------
# (d) the SOBOL_BB branches of the simulators
# --------------------------------------------------------------------------

GBM = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.25], [90.0, 100.0, 0.5, 0.02, 0.0, 0.3]],
               dtype=np.float32)
HESTON = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6]] * 2,
                  dtype=np.float32)
MERTON = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 2.0, -0.1, 0.2]] * 2, dtype=np.float32)
QMC_PAYOFFS = ["terminal", "asian_geometric", "asian_arithmetic", "barrier_up_out",
               "lookback_float_put", "variance_swap", "forward_start", "cliquet"]


def _close(got: np.ndarray, want: np.ndarray, payoff: str, strike: float,
           rtol: float = 2e-5) -> None:
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, strike)
    if payoff in ("variance_swap", "cliquet"):
        scale = np.maximum(scale, 0.01)
    ok = np.abs(got - want) <= rtol * scale
    jumps = payoff == "digital" or payoff.startswith("barrier")
    assert np.sum(~ok) <= (2 if jumps else 0), np.max(np.abs(got - want) / scale)


def _simulate_both(jfn, tfn, contracts: np.ndarray, payoff: str, **kw: object):
    jax_keys, keys = _keys(len(contracts))
    knobs = dict(PAYOFF_KNOBS[payoff])
    want = np.stack([np.asarray(jfn(k, jnp.asarray(c), dtype=jnp.float32,
                                    payoff=jgbm.PayoffKind(payoff),
                                    sampling=jgbm.SamplingKind.SOBOL_BB, mc_seed=SEED,
                                    **{**kw.get("jax", {}), **kw["common"], **knobs}))
                     for k, c in zip(jax_keys, contracts)])
    got = tfn(keys, torch.from_numpy(contracts), dtype=torch.float32,
              payoff=tgbm.PayoffKind(payoff), sampling=tgbm.SamplingKind.SOBOL_BB,
              mc_seed=SEED, **{**kw.get("port", {}), **kw["common"], **knobs}).numpy()
    return got, want


@pytest.mark.parametrize("payoff", QMC_PAYOFFS + ["digital"])
def test_gbm_sobol_bb_matches_jax(payoff: str) -> None:
    common = dict(timesteps=8, rows=4, cols=32, row_offset=2)
    got, want = _simulate_both(
        jgbm.simulate_underlier_rows, tgbm.simulate_underlier_rows, GBM, payoff,
        common=common, jax=dict(scheme=jgbm.PathScheme.LOG_EULER),
        port=dict(scheme=tgbm.PathScheme.LOG_EULER))
    _close(got, want, payoff, 100.0)


@pytest.mark.parametrize("payoff", ["terminal", "asian_arithmetic", "barrier_down_out",
                                    "variance_swap", "forward_start"])
def test_heston_sobol_bb_matches_jax(payoff: str) -> None:
    knob = {"barrier_down_out": dict(barrier_rel=0.85)}.get(payoff, {})
    got, want = _simulate_both(
        jh.simulate_heston_underlier_rows, th.simulate_heston_underlier_rows, HESTON, payoff,
        common=dict(timesteps=6, rows=4, cols=32, **knob))
    _close(got, want, payoff, 100.0, rtol=1e-4 if payoff == "variance_swap" else 2e-5)


@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "lookback_fixed_call",
                                    "cliquet"])
def test_merton_sobol_bb_matches_jax(payoff: str) -> None:
    got, want = _simulate_both(
        jm.simulate_merton_underlier_rows, tm.simulate_merton_underlier_rows, MERTON, payoff,
        common=dict(timesteps=6, rows=4, cols=32))
    _close(got, want, payoff, 100.0)


@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
@pytest.mark.parametrize("payoff", ["terminal", "asian_geometric", "barrier_up_out",
                                    "variance_swap"])
def test_basket_sobol_bb_matches_jax(payoff: str, combine: str) -> None:
    kw = dict(weights=(0.5, 0.3, 0.2), correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3),
                                                    (0.2, 0.3, 1.0)), combine=combine)
    js, ts = jb.build_basket_spec(**kw).expect("j"), tb.build_basket_spec(**kw).expect("t")
    got, want = _simulate_both(
        jb.simulate_basket_underlier_rows, tb.simulate_basket_underlier_rows, GBM, payoff,
        common=dict(timesteps=6, rows=4, cols=32), jax=dict(spec=js), port=dict(spec=ts))
    _close(got, want, payoff, 100.0, rtol=1e-4 if payoff == "variance_swap" else 2e-5)


def test_fused_walk_equals_the_scan_over_the_generator() -> None:
    """Tier 1, exact: the SOBOL_BB geometric Asian's fused route equals the
    scan over ``qmc_effective_normals`` (the route is internal, not an engine)."""
    _, keys = _keys(2)
    c = torch.from_numpy(GBM)
    kw = dict(timesteps=8, rows=4, cols=32, dtype=torch.float32, scheme=tgbm.PathScheme.LOG_EULER,
              row_offset=3)
    fused = tgbm.simulate_underlier_rows(keys, c, payoff=tgbm.PayoffKind.ASIAN_GEOMETRIC,
                                         sampling=tgbm.SamplingKind.SOBOL_BB, mc_seed=SEED, **kw)
    zq = tq.qmc_effective_normals(keys, timesteps=8, rows=4, cols=32, dtype=torch.float32,
                                  mc_seed=SEED, row_offset=3)
    spot, _, maturity, rate, div, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / 8
    drift, vstep = (rate - div - 0.5 * vol * vol) * dt, vol * torch.sqrt(dt)
    x = torch.zeros((2, 4, 32)) + torch.log(spot)
    acc = torch.zeros((2, 4, 32))
    for t in range(8):
        x = x + drift + vstep * zq[:, t]
        acc = acc + x
    assert torch.equal(fused, torch.exp(acc / 8))


BASE = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=0)


def test_sobol_bb_refusals_match_jax() -> None:
    """Antithetic and the American kinds: field and reason equal (the port
    refuses the sampling for American under GBM and under Heston as the JAX
    package does)."""
    for knobs in (dict(antithetic=True), dict(payoff="american_put", normalization="none"),
                  dict(model="heston", payoff="american_put", normalization="none")):
        want = jgbm.build_simulation_params(**BASE, sampling="sobol_bb", **knobs)
        got = tgbm.build_simulation_params(**BASE, sampling="sobol_bb", **knobs)
        assert want.is_failure() and got.is_failure()
        assert (got.error.field, got.error.value, got.error.reason) == (
            want.error.field, want.error.value, want.error.reason)
    for model in ("gbm", "heston", "merton_jump"):
        sim = tgbm.build_simulation_params(**BASE, model=model, sampling="sobol_bb",
                                           implementation="cuda").expect(model)
        assert tgbm.resolve_implementation(sim) == tgbm.SimImplementation.XLA


# --------------------------------------------------------------------------
# (e) the trainer
# --------------------------------------------------------------------------

MARKET = {"spot": (95.0, 105.0), "strike": (95.0, 105.0), "maturity": (0.5, 1.5),
          "rate": (0.01, 0.05), "div_yield": (0.0, 0.02)}
FAMILY = {
    "gbm": {**MARKET, "vol": (0.15, 0.3)},
    "heston": {**MARKET, "v0": (0.03, 0.08), "kappa": (1.0, 2.5), "theta": (0.03, 0.08),
               "xi": (0.2, 0.5), "rho": (-0.8, -0.3)},
    "merton_jump": {**MARKET, "vol": (0.15, 0.25), "lam": (0.1, 0.8), "jump_mean": (-0.15, 0.0),
                    "jump_std": (0.1, 0.25)},
    "basket_gbm": {**MARKET, "vol": (0.2, 0.3)},
}


@pytest.mark.parametrize("model,payoff", [("gbm", "asian_geometric"), ("gbm", "terminal"),
                                          ("heston", "terminal"), ("merton_jump", "terminal"),
                                          ("basket_gbm", "asian_arithmetic")])
def test_sobol_bb_resume_is_bit_exact(model: str, payoff: str) -> None:
    basket = {}
    if model == "basket_gbm":
        basket["basket"] = tb.build_basket_spec(
            weights=(0.5, 0.3, 0.2),
            correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0))).expect("spec")
    sim = tgbm.build_simulation_params(**{**BASE, "mc_seed": 7}, model=model, payoff=payoff,
                                       sampling="sobol_bb", implementation="cuda",
                                       **basket).expect("sim")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in FAMILY[model].items()}
    a = ttr.GbmCVNNPricer.create(ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf)),
                                 device="cpu").expect("a")
    first = _train(a, ttr, 2)
    snap = a.snapshot()
    assert snap.sim.sampling == tgbm.SamplingKind.SOBOL_BB
    assert snap.sim.implementation == tgbm.SimImplementation.XLA
    assert snap.cuda_stream_version == 0
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))
    assert np.all(np.isfinite(first))
    assert np.all(np.isfinite(b.predict_price(np.array(
        [[(lo + hi) / 2 for lo, hi in FAMILY[model].values()]], dtype=np.float32)).put))
