"""``tools/torch_model_check.py``, the port's snapshot/resume model checker,
on the CPU.

* tier 1, exact: every split schedule of 3 batches, each cut through the
  checkpoint bytes, ends bit-equal to the continuous run (0 violations) for
  TERMINAL on the ``"cuda"`` engine (its plain twins here), the float64
  threefry engine, the ``SOBOL_BB`` geometric Asian and the American put
  (backward version 3 recorded); a restore that drops the MC draw counter
  or Adam's step count between segments is counted, so the checker can
  fail; its ``compositions`` are ``tools/model_check.py``'s.
* tier 2 against JAX: the port's continuous final state against
  ``tools/model_check.py``'s continuous run on the same config from the
  same weights (threefry engine): counters and Adam's count exact, weights
  atol 1e-5 (``tests/test_torch_train_loop.py``'s weight tolerance), Adam's
  moments rtol 1e-4 with atol 1e-5 of each tensor's largest entry (they
  are gradients and their squares, in the hundreds here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.serialization.converters import deserialize_checkpoint, serialize_checkpoint
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu.training.adam_state import AdamStateSnapshot as JaxAdamSnapshot
from tests.test_torch_slice import _port_from_jax_snapshot
from tools import model_check as jax_check
from tools import torch_model_check as check


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small steps gain nothing from more, and the
    suite runs under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_compositions_are_the_jax_tools() -> None:
    for n in range(1, 7):
        assert list(check.compositions(n)) == list(jax_check.compositions(n))


@pytest.mark.parametrize("pricer,engine,backward", [
    ("terminal", "cuda", 0), ("terminal_f64", "xla", 0), ("qmc_asian", "xla", 0),
    ("american", "cuda", 3)])
def test_every_schedule_resumes_bit_exactly(pricer: str, engine: str, backward: int) -> None:
    base, training = check.config_for(pricer)
    report = check.run_model_check(base, 3, device="cpu", training=training)
    assert (report.schedules, report.violations) == (3, 0)
    assert (report.implementation, report.lsmc_backward_version) == (engine, backward)


@pytest.mark.parametrize("broken", ["mc_skip", "adam_count"])
def test_a_broken_restore_is_a_violation(broken: str) -> None:
    """A restore that loses the MC draw counter (``sim.skip``) or Adam's
    step count between segments changes every split schedule's end."""
    def restore(config):
        if broken == "mc_skip":
            return dataclasses.replace(config, sim=config.sim.model_copy(update={"skip": 0}))
        return dataclasses.replace(config, optimizer_state=dataclasses.replace(
            config.optimizer_state, count=0))

    base, training = check.config_for("terminal")
    report = check.run_model_check(base, 3, device="cpu", training=training, restore=restore)
    assert report.violations == report.schedules == 3


def _jax_base() -> jtr.GbmCVNNPricerConfig:
    """``tools/model_check.py``'s configuration, in the JAX package."""
    port, _ = check.config_for("terminal")
    sim = jgbm.build_simulation_params(
        mc_seed=17, timesteps=2, network_size=8, batches_per_mc_run=8).expect("sim")
    cvnn = jf.build_cvnn_config(
        layers=[jf.LinearCfg(width=8, activation=jf.Activation.MODRELU)], seed=23).expect("cvnn")
    bounds = {k: jsobol.BoundSpec(lower=b.lower, upper=b.upper) for k, b in port.bounds.items()}
    return jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn)


def test_continuous_run_matches_the_jax_tool() -> None:
    base = _jax_base()
    snap = jtr.GbmCVNNPricer.create(base).expect("jax pricer").snapshot()
    zeros = {k[len("params/"):]: np.zeros_like(np.asarray(v))
             for k, v in snap.model_state.items() if k.startswith("params/")}
    start = dataclasses.replace(snap, optimizer_state=JaxAdamSnapshot(mu=zeros, nu=zeros,
                                                                      count=0))
    jp = jtr.GbmCVNNPricer.create(start).expect("jax pricer")
    jp.train(jtr.build_training_config(num_batches=3, batch_size=4,
                                       learning_rate=1e-3).expect("cfg")).expect("train")
    blob, digest = serialize_checkpoint(jp.snapshot())
    want = jax_check._final_state(deserialize_checkpoint(blob, expected_hash=digest).expect("d"))

    port_start = _port_from_jax_snapshot(start)  # the same weights, zero Adam state
    _, training = check.config_for("terminal")
    got = check.train_schedule(port_start, (3,), device="cpu", training=training)
    assert got["implementation"] == "xla"
    for field in ("global_step", "sobol_skip", "mc_skip"):
        assert got[field] == want[field], field
    assert set(got["model"]) == set(want["model"]) and set(got["opt"]) == set(want["opt"])
    for key, value in want["model"].items():
        np.testing.assert_allclose(got["model"][key], value, rtol=0, atol=1e-5, err_msg=key)
    for key, value in want["opt"].items():
        scale = float(np.max(np.abs(value), initial=0.0))
        np.testing.assert_allclose(got["opt"][key], value, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=key)
