"""The port's main path as a whole against the JAX package's.

Sobol → MC (threefry engine) → FFT → CVNN forward/backward → Adam with a
warmup-cosine schedule, through ``GbmCVNNPricer`` in both packages, from the
same config and the same seeded weights. Tier 2: per-step losses agree to
rtol 1e-4 and weights/batch-norm state after the steps to atol 1e-5 (the
normals differ by the ``erf_inv`` lowering's ulps and the FFT and reductions
sum in another order). A JAX ``snapshot()`` resumes in the port and matches
the JAX continuation at the same tolerances; ``predict_price`` matches to
rtol 1e-5 and ``pad_to_bucket`` is bit-equal. The "cuda" engine (its plain
twin on the CPU) trains with finite, run-to-run identical losses.
"""

from __future__ import annotations

import numpy as np
import pytest

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.core.errors.trainer import EngineMismatch
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr
from spectralmc_tpu_torch.training.adam_state import AdamStateSnapshot

BOUNDS = {
    "spot": (80.0, 120.0),
    "strike": (80.0, 120.0),
    "maturity": (0.25, 2.0),
    "rate": (0.0, 0.08),
    "div_yield": (0.0, 0.04),
    "vol": (0.15, 0.45),
}
SIM = dict(timesteps=5, network_size=16, batches_per_mc_run=8, mc_seed=7, antithetic=True)
TRAIN = dict(batch_size=8, learning_rate=1e-3, contract_chunk=4)


def _cvnn(mod, *, first_bias: bool = False):
    """The production head's shape at width 8/12. The first linear has no
    bias by default: a bias right before the covariance batch norm (through a
    ModReLU that starts as the identity) has a gradient of pure rounding noise
    (``test_pre_batchnorm_bias_gradient_is_rounding_noise``), which Adam's
    normalisation turns into lr-sized steps of either sign in either package —
    a direction the comparison cannot pin."""
    return mod.build_cvnn_config(
        layers=[
            mod.LinearCfg(width=8, bias=first_bias, activation=mod.Activation.MODRELU),
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


def _jax_pricer() -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(**SIM).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(jf), normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def _port_config(**sim_overrides: object) -> ttr.GbmCVNNPricerConfig:
    sim = tgbm.build_simulation_params(**{**SIM, **sim_overrides}).expect("sim")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    return ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf), normalize_inputs=True)


def _schedule(mod):
    return mod.LRScheduleConfig(peak=5e-3, decay_steps=6, warmup_steps=2, end_value=1e-4)


def _train(pricer, mod_tr, mod_step, n: int) -> np.ndarray:
    cfg = mod_tr.build_training_config(num_batches=n, lr_schedule=_schedule(mod_step), **TRAIN)
    return np.asarray(pricer.train(cfg.expect("training config")).expect("train").losses)


def _assert_same_state(port_snap, jax_snap) -> None:
    assert set(port_snap.model_state) == set(jax_snap.model_state)
    for key, want in jax_snap.model_state.items():
        np.testing.assert_allclose(port_snap.model_state[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)
    assert port_snap.sobol_skip == jax_snap.sobol_skip
    assert port_snap.sim.skip == jax_snap.sim.skip
    assert port_snap.optimizer_state.count == jax_snap.optimizer_state.count


def _port_from_jax_snapshot(snap: jtr.GbmCVNNPricerConfig) -> ttr.GbmCVNNPricerConfig:
    opt = snap.optimizer_state
    return ttr.GbmCVNNPricerConfig(
        sim=tgbm.SimulationParams(**snap.sim.model_dump(mode="json")),
        bounds={k: tsobol.BoundSpec(**v.model_dump()) for k, v in snap.bounds.items()},
        cvnn=tf.CVNNConfig.model_validate(snap.cvnn.model_dump(mode="json")),
        global_step=snap.global_step,
        sobol_skip=snap.sobol_skip,
        normalize_inputs=snap.normalize_inputs,
        model_state={k: np.asarray(v) for k, v in snap.model_state.items()},
        optimizer_state=AdamStateSnapshot(
            mu={k: np.asarray(v) for k, v in opt.mu.items()},
            nu={k: np.asarray(v) for k, v in opt.nu.items()},
            count=opt.count,
        ),
    )


@pytest.fixture(scope="module")
def trained_pair():
    """Both packages after 3 identical steps from the same seeded weights."""
    jp = _jax_pricer()
    tp = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("port pricer")
    return jp, tp, _train(jp, jtr, jstep, 3), _train(tp, ttr, tstep, 3)


def test_three_steps_match_jax(trained_pair) -> None:
    jp, tp, jl, tl = trained_pair
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_same_state(tp.snapshot(), jp.snapshot())


def test_jax_snapshot_resumes_in_port(trained_pair) -> None:
    jp, _, _, _ = trained_pair
    snap = jp.snapshot()
    resumed = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(snap), device="cpu").expect("r")
    jcont = jtr.GbmCVNNPricer.create(snap).expect("jax continuation")
    np.testing.assert_allclose(_train(resumed, ttr, tstep, 2), _train(jcont, jtr, jstep, 2),
                               rtol=1e-4)
    _assert_same_state(resumed.snapshot(), jcont.snapshot())


def test_predict_price_matches_jax_and_pads_bit_exactly(trained_pair) -> None:
    jp, tp, _, _ = trained_pair
    gen = np.random.default_rng(3)
    lo = np.array([b[0] for b in BOUNDS.values()])
    hi = np.array([b[1] for b in BOUNDS.values()])
    contracts = (lo + (hi - lo) * gen.random((7, 6))).astype(np.float32)
    want = jp.predict_price(contracts)
    got = tp.predict_price(contracts)
    np.testing.assert_allclose(got.put, want.put, rtol=1e-5)
    np.testing.assert_allclose(got.call, want.call, rtol=1e-5)
    padded = tp.predict_price(contracts, pad_to_bucket=True)
    np.testing.assert_array_equal(padded.put, got.put)
    np.testing.assert_array_equal(padded.call, got.call)
    listed = tp.predict_price([tgbm.BlackScholesContract(**dict(zip(BOUNDS, map(float, c))))
                               for c in contracts])
    np.testing.assert_array_equal(listed.put, got.put)


def test_pre_batchnorm_bias_gradient_is_rounding_noise() -> None:
    """Why the 3-step comparison runs the first linear without a bias.

    With the bias on, the JAX first training step's gradient for that bias is
    below 1e-6 of the same layer's weight gradient (max-abs): the batch norm
    subtracts the batch mean, so the exact gradient is zero and what remains
    is float32 rounding (eps 1.19e-7) of the batch sum. Every other leaf's
    gradient is above that bound.
    """
    import jax
    import jax.numpy as jnp

    sim = jgbm.build_simulation_params(**SIM).expect("sim")
    model = jf.build_model(_cvnn(jf, first_bias=True), input_dim=6,
                           output_dim=sim.network_size).expect("model")
    params, bn_state = model.init()
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    sampler = jsobol.SobolSampler.create(jgbm.BlackScholesContract, bounds,
                                         jsobol.SobolConfig(seed=sim.mc_seed)).expect("sampler")
    t = sampler.device_table()
    table = jstep.SobolTable(directions=t["directions"], shift=t["shift"], lower=t["lower"],
                             upper=t["upper"])
    batch = TRAIN["batch_size"]
    unit = jsobol.sobol_unit(table.directions, table.shift, jnp.uint32(0), batch, jnp.float32)
    contracts = jsobol.scale_to_bounds(unit, table.lower, table.upper)
    specs = jax.vmap(jstep.make_mc_spectrum(sim))(jnp.arange(batch, dtype=jnp.uint32), contracts)
    inputs = jstep.make_input_normalizer(table, enabled=True, dtype=jnp.float32)(contracts)

    def loss(p):
        re, im, _ = model.apply(p, bn_state, inputs, jnp.zeros_like(inputs), train=True)
        return (jnp.mean(jnp.square(re - specs.real.astype(jnp.float32)))
                + jnp.mean(jnp.square(im - specs.imag.astype(jnp.float32))))

    grads = jax.grad(loss)(params)
    first = grads["layer_0"]["layer_0"]
    bound = 1e-6 * max(float(jnp.max(jnp.abs(first[k]))) for k in ("w_re", "w_im"))
    assert max(float(jnp.max(jnp.abs(first[k]))) for k in ("b_re", "b_im")) < bound
    others = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]
              if jax.tree_util.keystr(path) not in ("['layer_0']['layer_0']['b_re']",
                                                    "['layer_0']['layer_0']['b_im']")]
    assert min(float(jnp.max(jnp.abs(leaf))) for leaf in others) > bound


def test_port_resume_is_bit_exact_on_one_device() -> None:
    a = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("a")
    _train(a, ttr, tstep, 2)
    b = ttr.GbmCVNNPricer.create(a.snapshot(), device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, tstep, 2), _train(b, ttr, tstep, 2))


@pytest.mark.parametrize("implementation", ["xla", "cuda"])
def test_contract_chunking_is_bit_transparent(implementation: str) -> None:
    """One simulator call per chunk changes scheduling, not a single bit."""
    losses = []
    for chunk in (None, 2, 8):
        pricer = ttr.GbmCVNNPricer.create(
            _port_config(implementation=implementation), device="cpu"
        ).expect("p")
        cfg = ttr.build_training_config(num_batches=2, batch_size=8, learning_rate=1e-3,
                                        contract_chunk=chunk).expect("cfg")
        losses.append(np.asarray(pricer.train(cfg).expect("train").losses))
    np.testing.assert_array_equal(losses[0], losses[1])
    np.testing.assert_array_equal(losses[0], losses[2])


def test_cuda_engine_trains_deterministically_on_its_twin() -> None:
    runs = []
    for _ in range(2):
        p = ttr.GbmCVNNPricer.create(_port_config(implementation="cuda"), device="cpu")
        pricer = p.expect("cuda-engine pricer")
        runs.append(_train(pricer, ttr, tstep, 3))
        snap = pricer.snapshot()
        assert snap.sim.implementation == tgbm.SimImplementation.CUDA
        assert snap.cuda_stream_version == 2  # gbm v2
    assert np.all(np.isfinite(runs[0]))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_create_refuses_pallas_and_unported_features() -> None:
    pallas = _port_config(implementation="pallas")
    res = ttr.GbmCVNNPricer.create(pallas, device="cpu")
    assert res.is_failure() and isinstance(res.error, EngineMismatch)
    assert res.error.requested == "pallas"
    with pytest.raises(TypeError, match="MeshSpec"):  # a mesh is a parallel.mesh.MeshSpec
        ttr.GbmCVNNPricer.create(_port_config(), device="cpu", mesh_spec=object())
    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("p")
    cfg = ttr.build_training_config(num_batches=1, **TRAIN).expect("cfg")
    seen = []  # the interval plans, once refused here, train and commit
    pricer.train(cfg, commit_plan=ttr.IntervalCommit(interval=1),
                 commit_fn=lambda s, m: seen.append(m)).expect("interval plan")
    assert len(seen) == 1 and seen[0].startswith("step=1")
    assert pricer.train(cfg, commit_plan=ttr.FinalCommit()).is_failure()


def test_final_commit_hands_over_the_snapshot() -> None:
    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("p")
    seen = []
    cfg = ttr.build_training_config(num_batches=2, **TRAIN).expect("cfg")
    pricer.train(cfg, commit_plan=ttr.FinalCommit(), commit_fn=lambda s, m: seen.append((s, m)))
    assert len(seen) == 1 and seen[0][0].global_step == 2 and seen[0][1].startswith("step=2")


def test_midstream_cuda_checkpoint_needs_its_stream_version() -> None:
    pricer = ttr.GbmCVNNPricer.create(_port_config(implementation="cuda"), device="cpu").expect("p")
    _train(pricer, ttr, tstep, 1)
    snap = pricer.snapshot()
    stale = ttr.GbmCVNNPricerConfig(**{**snap.__dict__, "cuda_stream_version": 0})
    res = ttr.GbmCVNNPricer.create(stale, device="cpu")
    assert res.is_failure() and isinstance(res.error, EngineMismatch)


@pytest.mark.parametrize("warmup", [0, 3])
def test_warmup_cosine_rates_match_optax(warmup: int) -> None:
    """Tier 2: the schedule in float64 equals optax's (x64 on) to 1e-12."""
    import optax

    fn = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=4e-3, warmup_steps=warmup, decay_steps=10, end_value=1e-4
    )
    got = [tstep.make_optimizer(1e-3, tstep.LRScheduleConfig(
        peak=4e-3, warmup_steps=warmup, decay_steps=10, end_value=1e-4))(c) for c in range(14)]
    np.testing.assert_allclose(got, [float(fn(c)) for c in range(14)], rtol=1e-12, atol=1e-15)


def test_adam_steps_match_optax() -> None:
    """Tier 2, rtol 1e-6: three optax Adam updates on float32 leaves."""
    import jax.numpy as jnp
    import optax
    import torch

    from spectralmc_tpu_torch.training.adam_state import AdamState, adam_update_

    gen = np.random.default_rng(1)
    params = {"w": gen.standard_normal((3, 4)).astype(np.float32)}
    grads = [{"w": gen.standard_normal((3, 4)).astype(np.float32)} for _ in range(3)]
    opt = optax.adam(2e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp = {"w": jnp.asarray(params["w"])}
    state = opt.init(jp)
    tp = {"w": torch.from_numpy(params["w"].copy())}
    tstate = AdamState.zeros_like(tp)
    for g in grads:
        updates, state = opt.update({"w": jnp.asarray(g["w"])}, state, jp)
        jp = optax.apply_updates(jp, updates)
        adam_update_(tp, {"w": torch.from_numpy(g["w"])}, tstate, 2e-3)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)
    np.testing.assert_allclose(tstate.mu["w"].numpy(), np.asarray(state[0].mu["w"]), rtol=1e-6)
    np.testing.assert_allclose(tstate.nu["w"].numpy(), np.asarray(state[0].nu["w"]), rtol=1e-6)
