"""The port's flat GBM payoff matrix against the JAX package's.

(a) tier 2, rtol 1e-5: the threefry engine's ``simulate_underlier_rows``
    against the JAX package's, every payoff × scheme on the same keys (the
    normals differ by the ``erf_inv`` lowering's few ulps), measured against
    the strike for the lookback encodings and the cap for the cliquet, whose
    values cross zero; digital and barrier values agree apart from counted
    flips at the strike or the level, where the values jump.
(b) rtol 1e-6 (float64): ``expected_underlier_mean`` and
    ``has_closed_form_mean`` for every payoff.
(c) every ``build_simulation_params`` refusal of the JAX package for these
    payoffs, with the same field and reason.
(d) the trainer: a 3-step slice on the arithmetic Asian (threefry engine)
    against the JAX ``GbmCVNNPricer`` from weights carried across by
    ``load_state_dict`` (tier 2 at ``test_torch_slice.py``'s tolerances); a
    bit-exact cuda-engine (twin) snapshot/resume on the CPU per kernel
    branch; ``predict_price`` puts, NaN calls and parity calls per payoff kind
    against the JAX package from the same weights (rtol 1e-5; 2e-4 for the
    arithmetic Asian's calls, whose float32 mean is a cancelling series).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr
from spectralmc_tpu_torch.training.adam_state import AdamStateSnapshot

PAYOFF_KNOBS: dict[str, dict[str, object]] = {
    "terminal": {},
    "asian_arithmetic": {},
    "asian_geometric": {},
    "barrier_up_out": dict(barrier_rel=1.2),
    "barrier_down_out": dict(barrier_rel=0.85),
    "digital": {},
    "lookback_fixed_call": {},
    "lookback_fixed_put": {},
    "lookback_float_call": {},
    "lookback_float_put": {},
    "variance_swap": {},
    "forward_start": dict(forward_start_step=3),
    "cliquet": dict(cliquet_reset_every=2, cliquet_floor=-0.05, cliquet_cap=0.08),
}
PAYOFFS = list(PAYOFF_KNOBS)
# MEAN normalization is refused for these (the JAX package's three gates)
NO_MEAN = {"digital", "cliquet", "barrier_up_out", "barrier_down_out", "lookback_fixed_call",
           "lookback_fixed_put", "lookback_float_call", "lookback_float_put"}


def _contracts(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


# --------------------------------------------------------------------------
# (a) the threefry engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["log_euler", "euler"])
@pytest.mark.parametrize("payoff", PAYOFFS)
def test_threefry_payoff_engine_matches_jax(payoff: str, scheme: str) -> None:
    contracts = _contracts(3, seed=11)
    rows, cols, steps = 8, 16, 6
    half = rows // 2 if scheme == "log_euler" else None
    knobs = PAYOFF_KNOBS[payoff]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), d) for d in range(3)]
    want = np.stack([
        np.asarray(jgbm.simulate_underlier_rows(
            k, jnp.asarray(c), timesteps=steps, rows=rows, cols=cols, dtype=jnp.float32,
            scheme=jgbm.PathScheme(scheme), payoff=jgbm.PayoffKind(payoff),
            antithetic_half=half, **knobs,
        ))
        for k, c in zip(keys, contracts)
    ])
    got = tgbm.simulate_underlier_rows(
        rng.fold_in(rng.prng_key(5), torch.arange(3)), torch.from_numpy(contracts),
        timesteps=steps, rows=rows, cols=cols, dtype=torch.float32,
        scheme=tgbm.PathScheme(scheme), payoff=tgbm.PayoffKind(payoff), antithetic_half=half,
        **knobs,
    ).numpy()
    assert got.shape == want.shape
    # the lookback encodings (2K − M, K − (S_T − m), …) and the cliquet sums
    # cross zero: their error is measured against the strike or the cap
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, contracts[:, 1, None, None])
    if payoff == "cliquet":
        scale = np.maximum(scale, knobs["cliquet_cap"])
    close = np.abs(got - want) <= 1e-5 * scale
    # a flip needs the path within ~1e-5 of the level: at most 1 in 384 paths
    jumps = payoff == "digital" or payoff.startswith("barrier")
    assert int((~close).sum()) <= (1 if jumps else 0)
    if payoff == "digital":
        assert np.all(np.abs(got - contracts[:, 1, None, None]) == 1.0)


def test_threefry_engine_forward_start_walks_the_t_keyed_tail() -> None:
    """Tier 1, exact within the port: u = spot·S_T/S_m uses the normals of
    steps m..N−1 (a TERMINAL walk from step m), not those of steps 0..N−m−1."""
    c = torch.from_numpy(_contracts(2, seed=3))
    keys = rng.fold_in(rng.prng_key(1), torch.arange(2))
    kw = dict(rows=4, cols=8, dtype=torch.float32, scheme=tgbm.PathScheme.LOG_EULER)
    fwd = tgbm.simulate_underlier_rows(keys, c, timesteps=6, payoff=tgbm.PayoffKind.FORWARD_START,
                                       forward_start_step=4, **kw)
    head = tgbm.simulate_terminal_rows(keys, c, timesteps=2, **kw)  # steps 0, 1
    assert not torch.allclose(fwd, head, rtol=1e-3)
    rows = tgbm.row_keys(keys, rows=4, row_offset=0, antithetic_half=None, dtype=torch.float32)[0]
    spot, _, maturity, rate, div, vol = (c[:, i, None, None] for i in range(6))
    dt = maturity / 6
    acc = torch.zeros((2, 4, 8))
    for t in (4, 5):
        z = rng.normal(rng.fold_in(rows, t), (8,))
        acc = acc + (rate - div - 0.5 * vol * vol) * dt + vol * torch.sqrt(dt) * z
    torch.testing.assert_close(fwd, spot * torch.exp(acc), rtol=1e-6, atol=0.0)


# --------------------------------------------------------------------------
# (b) the analytic means
# --------------------------------------------------------------------------


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_expected_underlier_mean_and_closed_form_gate_match_jax(payoff: str) -> None:
    contracts = _contracts(4, seed=2).astype(np.float64)
    knobs = {k: v for k, v in PAYOFF_KNOBS[payoff].items() if k != "barrier_rel"}
    assert tgbm.has_closed_form_mean(tgbm.ModelKind.GBM, tgbm.PayoffKind(payoff)) == \
        jgbm.has_closed_form_mean(jgbm.ModelKind.GBM, jgbm.PayoffKind(payoff))
    for steps in (4, 12):
        got = tgbm.expected_underlier_mean(torch.from_numpy(contracts), timesteps=steps,
                                           payoff=tgbm.PayoffKind(payoff), dtype=torch.float64,
                                           **knobs)
        want = [jgbm.expected_underlier_mean(jnp.asarray(c), timesteps=steps,
                                             payoff=jgbm.PayoffKind(payoff), dtype=jnp.float64,
                                             **knobs)
                for c in contracts]
        if want[0] is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    mean_f32 = tgbm.expected_underlier_mean(torch.from_numpy(contracts), timesteps=4,
                                            payoff=tgbm.PayoffKind(payoff), dtype=torch.float32,
                                            **knobs)
    assert mean_f32 is None or mean_f32.dtype == torch.float32


def test_expected_clipped_lognormal_return_matches_jax() -> None:
    mu = np.array([-0.01, 0.0, 0.02])
    s = np.array([0.05, 0.1, 0.2])
    got = tgbm.expected_clipped_lognormal_return(
        torch.from_numpy(mu), torch.from_numpy(s), torch.tensor(-0.05, dtype=torch.float64),
        torch.tensor(0.08, dtype=torch.float64))
    want = jgbm.expected_clipped_lognormal_return(
        jnp.asarray(mu), jnp.asarray(s), jnp.asarray(-0.05), jnp.asarray(0.08))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------------
# (c) refusals
# --------------------------------------------------------------------------

BASE = dict(timesteps=6, network_size=16, batches_per_mc_run=8, mc_seed=0)
REFUSALS = [
    dict(payoff="barrier_up_out", normalization="none"),
    dict(payoff="barrier_up_out", barrier_rel=0.9, normalization="none"),
    dict(payoff="barrier_down_out", barrier_rel=1.1, normalization="none"),
    dict(payoff="barrier_down_out", barrier_rel=0.0, normalization="none"),
    dict(barrier_rel=1.2),
    dict(payoff="lookback_fixed_call", barrier_rel=1.2, normalization="none"),
    dict(payoff="forward_start"),
    dict(payoff="forward_start", forward_start_step=0),
    dict(payoff="forward_start", forward_start_step=6),
    dict(forward_start_step=2),
    dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.0, normalization="none"),
    dict(payoff="cliquet", cliquet_reset_every=4, cliquet_floor=0.0, cliquet_cap=0.1,
         normalization="none"),
    dict(payoff="cliquet", cliquet_reset_every=6, cliquet_floor=0.0, cliquet_cap=0.1,
         normalization="none"),
    dict(payoff="cliquet", cliquet_reset_every=0, cliquet_floor=0.0, cliquet_cap=0.1,
         normalization="none"),
    dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.1, cliquet_cap=0.1,
         normalization="none"),
    dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=-1.0, cliquet_cap=0.1,
         normalization="none"),
    dict(cliquet_floor=0.0),
    dict(payoff="digital"),
    dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.1),
    dict(payoff="barrier_up_out", barrier_rel=1.2),
    dict(payoff="lookback_float_put"),
    dict(payoff="asian_geometric", lsmc_cross_fit=True),
    dict(payoff="variance_swap", lsmc_fused_backward=True),
    dict(payoff="asian_arithmetic", antithetic=True, batches_per_mc_run=7),
]


@pytest.mark.parametrize("bad", REFUSALS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_build_simulation_params_refuses_as_jax_does(bad: dict) -> None:
    cfg = {**BASE, **bad}
    want = jgbm.build_simulation_params(**cfg)
    got = tgbm.build_simulation_params(**cfg)
    assert want.is_failure() and got.is_failure()
    assert got.error.field == want.error.field
    assert got.error.reason == want.error.reason


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_every_flat_payoff_builds_and_resolves_to_its_engine(payoff: str) -> None:
    norm = "none" if payoff in NO_MEAN else "mean"
    for scheme in ("log_euler", "euler"):
        sim = tgbm.build_simulation_params(**BASE, payoff=payoff, normalization=norm,
                                           scheme=scheme, implementation="cuda",
                                           **PAYOFF_KNOBS[payoff]).expect(payoff)
        jsim = jgbm.build_simulation_params(**BASE, payoff=payoff, normalization=norm,
                                            scheme=scheme, **PAYOFF_KNOBS[payoff])
        assert jsim.is_success()
        euler_cliquet = payoff == "cliquet" and scheme == "euler"
        want = tgbm.SimImplementation.XLA if euler_cliquet else tgbm.SimImplementation.CUDA
        assert tgbm.resolve_implementation(sim) == want
    want_version = 2  # gbm_cliquet v2 (the cliquet kernel), gbm v2 (the flat kernel)
    assert gbm_cuda.cuda_stream_version(tgbm.ModelKind.GBM, tgbm.PayoffKind(payoff)) == want_version
    assert gbm_cuda.cuda_stream_version(tgbm.ModelKind.GBM, tgbm.PayoffKind.CLIQUET) == \
        gbm_cuda.CUDA_STREAM_VERSIONS["gbm_cliquet"]


# --------------------------------------------------------------------------
# (d) the trainer
# --------------------------------------------------------------------------

BOUNDS = {
    "spot": (80.0, 120.0),
    "strike": (80.0, 120.0),
    "maturity": (0.25, 2.0),
    "rate": (0.0, 0.08),
    "div_yield": (0.0, 0.04),
    "vol": (0.15, 0.45),
}
STRIKE_UNITS = {"variance_swap": (0.02, 0.10), "cliquet": (0.01, 0.08)}
SIM = dict(timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=7, antithetic=True)
TRAIN = dict(batch_size=8, learning_rate=1e-3, contract_chunk=4)


def _bounds(payoff: str) -> dict[str, tuple[float, float]]:
    return {**BOUNDS, "strike": STRIKE_UNITS.get(payoff, BOUNDS["strike"])}


def _cvnn(mod):
    """``test_torch_slice.py``'s head (no bias before the covariance BN)."""
    return mod.build_cvnn_config(
        layers=[
            mod.LinearCfg(width=8, bias=False, activation=mod.Activation.MODRELU),
            mod.CovBNCfg(),
            mod.ResidualCfg(
                body=mod.SequentialCfg(layers=(
                    mod.LinearCfg(width=12, activation=mod.Activation.ZRELU),
                    mod.LinearCfg(width=12),
                )),
                activation=mod.Activation.MODRELU,
            ),
        ],
        seed=11,
    ).expect("cvnn")


def _sim_kwargs(payoff: str) -> dict[str, object]:
    norm = "none" if payoff in NO_MEAN else "mean"
    return dict(SIM, payoff=payoff, normalization=norm, **PAYOFF_KNOBS[payoff])


def _jax_pricer(payoff: str) -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(**_sim_kwargs(payoff)).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def _port_from_jax_snapshot(snap: jtr.GbmCVNNPricerConfig, **sim_overrides: object):
    """The JAX checkpoint's fields mapped onto the port's config; the weights
    go through the port's ``load_state_dict`` in ``create``."""
    opt = snap.optimizer_state
    return ttr.GbmCVNNPricerConfig(
        sim=tgbm.SimulationParams(**{**snap.sim.model_dump(mode="json"), **sim_overrides}),
        bounds={k: tsobol.BoundSpec(**v.model_dump()) for k, v in snap.bounds.items()},
        cvnn=tf.CVNNConfig.model_validate(snap.cvnn.model_dump(mode="json")),
        global_step=snap.global_step,
        sobol_skip=snap.sobol_skip,
        normalize_inputs=snap.normalize_inputs,
        model_state={k: np.asarray(v) for k, v in snap.model_state.items()},
        optimizer_state=None if opt is None else AdamStateSnapshot(
            mu={k: np.asarray(v) for k, v in opt.mu.items()},
            nu={k: np.asarray(v) for k, v in opt.nu.items()},
            count=opt.count,
        ),
    )


def _train(pricer, mod_tr, n: int) -> np.ndarray:
    cfg = mod_tr.build_training_config(num_batches=n, **TRAIN).expect("training config")
    return np.asarray(pricer.train(cfg).expect("train").losses)


def test_asian_slice_three_steps_match_jax() -> None:
    """Tier 2 (``test_torch_slice.py``'s tolerances): losses rtol 1e-4, the
    weights and batch-norm state after 3 steps atol 1e-5, on the arithmetic
    Asian with MEAN normalization to its own mean."""
    jp = _jax_pricer("asian_arithmetic")
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    np.testing.assert_allclose(_train(tp, ttr, 3), _train(jp, jtr, 3), rtol=1e-4)
    port_snap, jax_snap = tp.snapshot(), jp.snapshot()
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sim.skip == jax_snap.sim.skip
    assert port_snap.optimizer_state.count == jax_snap.optimizer_state.count


@pytest.mark.parametrize("payoff", ["asian_arithmetic", "barrier_down_out", "lookback_fixed_put",
                                    "variance_swap", "cliquet", "forward_start"])
def test_cuda_engine_resume_is_bit_exact_on_its_twin(payoff: str) -> None:
    """Tier 1, exact: snapshot → create → 2 more steps equals the continuous
    run; the stream version recorded is the branch's key."""
    sim = tgbm.build_simulation_params(**_sim_kwargs(payoff), implementation="cuda").expect("s")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds(payoff).items()}
    cfg = ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf),
                                  normalize_inputs=payoff in STRIKE_UNITS)
    a = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("a")
    before = gbm_cuda.LAUNCHES
    first = _train(a, ttr, 2)
    assert gbm_cuda.LAUNCHES == before  # CPU tensors run the twin, never a kernel
    snap = a.snapshot()
    assert snap.sim.implementation == tgbm.SimImplementation.CUDA
    key = "gbm_cliquet" if payoff == "cliquet" else "gbm"
    assert snap.cuda_stream_version == gbm_cuda.CUDA_STREAM_VERSIONS[key]
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, 2), _train(b, ttr, 2))
    assert np.all(np.isfinite(first))


def test_euler_cliquet_on_the_cuda_engine_downgrades_to_threefry() -> None:
    """The cliquet kernel is log-Euler only: a fresh Euler config records the
    threefry engine and stream version 0, as the JAX trainer downgrades."""
    sim = tgbm.build_simulation_params(**_sim_kwargs("cliquet"), scheme="euler",
                                       implementation="cuda").expect("s")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in _bounds("cliquet").items()}
    p = ttr.GbmCVNNPricer.create(
        ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf)), device="cpu"
    ).expect("p")
    snap = p.snapshot()
    assert snap.sim.implementation == tgbm.SimImplementation.XLA
    assert snap.cuda_stream_version == 0


@pytest.mark.parametrize("payoff", PAYOFFS)
def test_predict_price_nan_and_parity_match_jax(payoff: str) -> None:
    """Same weights in both packages: puts rtol 1e-5; calls NaN exactly where
    ``has_closed_form_mean`` is false, else parity on the payoff's own mean,
    rtol 1e-5 against the JAX package's."""
    jp = _jax_pricer(payoff)
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    lo = np.array([b[0] for b in _bounds(payoff).values()])
    hi = np.array([b[1] for b in _bounds(payoff).values()])
    contracts = (lo + (hi - lo) * np.random.default_rng(4).random((5, 6))).astype(np.float32)
    want = jp.predict_price(contracts)
    got = tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5, atol=1e-7)
    assert np.array_equal(np.isnan(got.call), np.isnan(want.call))
    parity = tgbm.has_closed_form_mean(tgbm.ModelKind.GBM, tgbm.PayoffKind(payoff))
    assert np.all(np.isnan(got.call)) == (not parity)
    if parity:
        # the arithmetic Asian's E[u] sums g·(g^N − 1)/(g − 1) in float32 with
        # g = e^{(r−q)dt}: one ulp of g (the packages' exp differ by one) is
        # 1.2e-7/|g − 1| ≈ 1e-4 of the mean, so its calls agree to 2e-4
        rtol = 2e-4 if payoff == "asian_arithmetic" else 1e-5
        np.testing.assert_allclose(got.call, want.call, rtol=rtol, atol=1e-6)
        padded = tp.predict_price(contracts, pad_to_bucket=True)
        np.testing.assert_array_equal(padded.call, got.call)


def test_predict_price_runs_the_forward_at_the_bucket_shape() -> None:
    """The serving forward always sees a power-of-two batch (the last row
    repeated), so a row's value cannot depend on the row count of its batch:
    on the card cuBLAS and the row-mean reduction pick kernels by shape.
    Tier 1, exact: padded and unpadded calls agree bit for bit."""
    jp = _jax_pricer("asian_arithmetic")
    tp = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(jp.snapshot()),
                                  device="cpu").expect("port pricer")
    seen = []
    hook = tp.model.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[0]))
    contracts = _contracts(7, seed=9)
    try:
        plain = tp.predict_price(contracts)
        padded = tp.predict_price(contracts, pad_to_bucket=True)
    finally:
        hook.remove()
    assert seen == [8, 8]
    assert plain.put.shape == (7,)
    np.testing.assert_array_equal(plain.put, padded.put)
    np.testing.assert_array_equal(plain.call, padded.call)
