"""American pricers through ``GbmCVNNPricer`` in both packages.

* An American put on the threefry engine: 3 steps from the same config and
  seeded weights in the JAX package and the port, then a JAX ``snapshot()``
  resumed in the port against the JAX continuation. Tier 2: per-step losses
  to rtol 1e-4 (as for the European pricers, ``test_torch_slice.py``) and
  the prices served after them to rtol 5e-5. The regression sums run in
  another order, so β differs in its last ulps and a few paths near the
  exercise boundary flip their exercise date; at 32,768 paths a contract
  that moves a target by ≈ 1e-5 relative (measured: losses within 3e-5,
  prices within 1.3e-5), where at 128 paths a single flip moved a loss by
  1%. The weights are not compared leaf by leaf: Adam divides each gradient
  by its own scale, so those shifts move small leaves by up to 8e-5; the
  losses of steps 2 and 3 and the served prices read them all.
* The American call serves its learned price in the call column with the put
  NaN (and the put the other way round), as the JAX trainer maps them.
* A checkpoint recorded on one of the JAX package's TPU backwards
  (``lsmc_backward_version`` 1 or 2), or on another backward than the one
  that will run, and a ``"pallas"`` config, are refused with
  ``EngineMismatch``.
* On the ``"cuda"`` engine (its twins on the CPU) with the CUDA backward,
  ``lsmc_backward_version`` records 3 and resume is bit-exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.core.errors.trainer import EngineMismatch
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import american_cuda
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr
from test_torch_slice import BOUNDS, _cvnn, _port_from_jax_snapshot, _train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: its trainer steps are many small ops,
    which torch's thread pool slows tenfold and more while the suite's other
    workers hold the cores (past the suite's 120 s limit a test fails)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIM = dict(timesteps=6, network_size=16, batches_per_mc_run=2048, mc_seed=5,
           payoff="american_put", normalization="none", lsmc_exercise_every=2)
CONTRACTS = np.array([[100.0, 105.0, 1.0, 0.05, 0.01, 0.25],
                      [90.0, 85.0, 0.5, 0.02, 0.03, 0.35]], dtype=np.float32)


def _bounds(mod) -> dict:
    return {k: mod.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}


def _jax_pricer() -> jtr.GbmCVNNPricer:
    sim = jgbm.build_simulation_params(**SIM).expect("sim")
    cfg = jtr.GbmCVNNPricerConfig(sim=sim, bounds=_bounds(jsobol), cvnn=_cvnn(jf),
                                  normalize_inputs=True)
    return jtr.GbmCVNNPricer.create(cfg).expect("jax pricer")


def _port_config(**overrides: object) -> ttr.GbmCVNNPricerConfig:
    sim = tgbm.build_simulation_params(**{**SIM, **overrides}).expect("sim")
    return ttr.GbmCVNNPricerConfig(sim=sim, bounds=_bounds(tsobol), cvnn=_cvnn(tf),
                                   normalize_inputs=True)


@pytest.fixture(scope="module")
def trained_pair():
    jp = _jax_pricer()
    tp = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("port pricer")
    return jp, tp, _train(jp, jtr, jstep, 3), _train(tp, ttr, tstep, 3)


def test_american_put_three_steps_match_jax(trained_pair) -> None:
    jp, tp, jl, tl = trained_pair
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    snap, jsnap = tp.snapshot(), jp.snapshot()
    assert set(snap.model_state) == set(jsnap.model_state)
    assert (snap.sobol_skip, snap.sim.skip) == (jsnap.sobol_skip, jsnap.sim.skip)
    assert snap.lsmc_backward_version == jsnap.lsmc_backward_version == 0


def test_jax_american_snapshot_resumes_in_port(trained_pair) -> None:
    jp, _, _, _ = trained_pair
    snap = jp.snapshot()
    resumed = ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(snap), device="cpu").expect("r")
    jcont = jtr.GbmCVNNPricer.create(snap).expect("jax continuation")
    np.testing.assert_allclose(_train(resumed, ttr, tstep, 2), _train(jcont, jtr, jstep, 2),
                               rtol=1e-4)


def test_american_put_serves_like_jax(trained_pair) -> None:
    jp, tp, _, _ = trained_pair
    want = jp.predict_price(CONTRACTS)
    got = tp.predict_price(CONTRACTS)
    np.testing.assert_allclose(got.put, want.put, rtol=5e-5)
    assert np.all(np.isnan(got.call)) and np.all(np.isnan(want.call))


@pytest.mark.parametrize("implementation", ["xla", "cuda"])
def test_american_call_serves_the_call_column(implementation: str) -> None:
    """The learned channel carries the configured side: a call pricer's
    prices land in ``.call`` and ``.put`` is NaN (a put/call swap would pass
    any put-only test)."""
    pricer = ttr.GbmCVNNPricer.create(
        _port_config(payoff="american_call", implementation=implementation), device="cpu"
    ).expect("call pricer")
    losses = _train(pricer, ttr, tstep, 1)
    assert np.all(np.isfinite(losses))
    pred = pricer.predict_price(CONTRACTS)
    assert np.all(np.isnan(pred.put))
    assert np.all(np.isfinite(pred.call))
    put_pricer = ttr.GbmCVNNPricer.create(
        _port_config(implementation=implementation), device="cpu").expect("put pricer")
    put_pred = put_pricer.predict_price(CONTRACTS)
    assert np.all(np.isfinite(put_pred.put)) and np.all(np.isnan(put_pred.call))


@pytest.mark.parametrize("recorded", [1, 2])
def test_checkpoint_on_a_jax_tpu_backward_is_refused(trained_pair, recorded: int) -> None:
    jp, _, _, _ = trained_pair
    snap = _port_from_jax_snapshot(jp.snapshot())
    for sim in (snap.sim, snap.sim.model_copy(update={"implementation": "cuda",
                                                      "lsmc_fused_backward": True})):
        stale = ttr.GbmCVNNPricerConfig(**{**snap.__dict__, "sim": sim,
                                           "lsmc_backward_version": recorded})
        res = ttr.GbmCVNNPricer.create(stale, device="cpu")
        assert res.is_failure() and isinstance(res.error, EngineMismatch)
        assert res.error.requested == f"lsmc backward v{recorded}"


def test_pallas_american_config_is_refused() -> None:
    res = ttr.GbmCVNNPricer.create(_port_config(implementation="pallas",
                                                lsmc_fused_backward=True), device="cpu")
    assert res.is_failure() and isinstance(res.error, EngineMismatch)


def test_cuda_backward_is_recorded_and_resumes_bit_exactly() -> None:
    cfg = _port_config(implementation="cuda", lsmc_fused_backward=True, antithetic=True)
    a = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("a")
    _train(a, ttr, tstep, 2)
    snap = a.snapshot()
    assert snap.sim.implementation == tgbm.SimImplementation.CUDA
    assert snap.lsmc_backward_version == american_cuda.LSMC_BACKWARD_VERSIONS["cuda"]
    assert snap.cuda_stream_version == 3  # american_gbm v3
    b = ttr.GbmCVNNPricer.create(snap, device="cpu").expect("b")
    np.testing.assert_array_equal(_train(a, ttr, tstep, 2), _train(b, ttr, tstep, 2))
    # the same checkpoint on another backward cannot continue
    for version in (0, 4):
        stale = ttr.GbmCVNNPricerConfig(**{**snap.__dict__, "lsmc_backward_version": version})
        res = ttr.GbmCVNNPricer.create(stale, device="cpu")
        assert res.is_failure() and isinstance(res.error, EngineMismatch)


def test_torch_estimator_routes_record_version_zero() -> None:
    """Cross-fit on ``"cuda"`` (the kernel's rows, the torch estimator) and
    a curved term (the threefry forward, recorded ``xla``) record backward 0."""
    xfit = ttr.GbmCVNNPricer.create(_port_config(implementation="cuda", lsmc_cross_fit=True),
                                    device="cpu").expect("cross-fit")
    assert np.all(np.isfinite(_train(xfit, ttr, tstep, 1)))
    snap = xfit.snapshot()
    assert (snap.sim.implementation, snap.lsmc_backward_version) == (
        tgbm.SimImplementation.CUDA, 0)
    curve = tgbm.TermStructure(rate_shape=(0.5, 0.7, 0.9, 1.1, 1.3, 1.5))
    curved = ttr.GbmCVNNPricer.create(_port_config(implementation="cuda", term=curve),
                                      device="cpu").expect("curved")
    snap = curved.snapshot()
    assert (snap.sim.implementation, snap.lsmc_backward_version) == (
        tgbm.SimImplementation.XLA, 0)
