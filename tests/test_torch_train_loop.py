"""The port's training loop against the JAX package's: commit plans,
segments, metrics callbacks, ``profile_dir``, ``train_via_effects``, the
state after a diverged segment, and commits through the store.

Sizes are ``tests/test_trainer.py::make_pricer_config``'s (2 steps, a
16-wide network, 4 rows a run, one 24-wide layer), the same config in both
packages. Tiers:

* tier 1, exact, within the port: interval plans against ``NoCommit``
  (losses, gradient norms, weights); ``train_via_effects`` against ``train``
  (losses, commit messages, checkpoint bytes); the callbacks' losses and
  rates against ``TrainingResult`` and ``schedule_rates``; a diverged
  segment leaves the pre-segment state bit for bit.
* tier 1, exact, against JAX: segment sizes, ``start_step``s, commit steps
  and batches, ``NonFiniteLoss.step``, ``global_step`` and the counters.
* tier 2 against JAX: losses rtol 1e-4 and weights atol 1e-5 (the
  cross-package tolerance of ``tests/test_torch_slice.py``); rates rtol 1e-6
  (float32).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu.training.adam_state import AdamStateSnapshot as JaxAdamSnapshot
from spectralmc_tpu_torch.core.errors.trainer import CommitPlanMismatch, NonFiniteLoss
from spectralmc_tpu_torch.storage import (
    AsyncBlockchainModelStore,
    FileSystemObjectStore,
    make_commit_fn,
)
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr
from tests.test_torch_slice import _port_from_jax_snapshot
from tests.test_trainer import make_pricer_config

LR = 1e-3
BATCH = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small steps gain nothing from more, and the
    suite runs under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_config() -> ttr.GbmCVNNPricerConfig:
    return _port_from_jax_snapshot(_jax_config_as_snapshot())


def _jax_config_as_snapshot() -> jtr.GbmCVNNPricerConfig:
    """The JAX config with its seeded initial weights and empty Adam state,
    so the port starts from the same numbers."""
    jp = jtr.GbmCVNNPricer.create(make_pricer_config()).expect("jax pricer")
    snap = jp.snapshot()
    zeros = {k[len("params/"):]: np.zeros_like(np.asarray(v))
             for k, v in snap.model_state.items() if k.startswith("params/")}
    return dataclasses.replace(snap, optimizer_state=JaxAdamSnapshot(mu=zeros, nu=zeros, count=0))


@pytest.fixture(scope="module")
def start_snapshot() -> jtr.GbmCVNNPricerConfig:
    return _jax_config_as_snapshot()


def _port(snap: jtr.GbmCVNNPricerConfig) -> ttr.GbmCVNNPricer:
    return ttr.GbmCVNNPricer.create(_port_from_jax_snapshot(snap), device="cpu").expect("port")


def _jax(snap: jtr.GbmCVNNPricerConfig) -> jtr.GbmCVNNPricer:
    return jtr.GbmCVNNPricer.create(snap).expect("jax")


def _cfg(mod, n: int, **kw: object):
    return mod.build_training_config(num_batches=n, batch_size=BATCH, learning_rate=LR,
                                     **kw).expect("training config")


def _plan(mod, name: str):
    kind, _, interval = name.partition(":")
    cls = getattr(mod, kind)
    return cls(interval=int(interval)) if interval else cls()


PLANS = ["IntervalCommit:1", "IntervalCommit:2", "IntervalCommit:3",
         "FinalAndIntervalCommit:2", "FinalAndIntervalCommit:5", "FinalCommit"]


# --------------------------------------------------------------------------
# commit plans and segments
# --------------------------------------------------------------------------


@pytest.mark.parametrize("plan", PLANS)
def test_interval_plans_are_bit_transparent(start_snapshot, plan: str) -> None:
    """Tier 1: cutting the run adds host syncs and nothing else."""
    plain = _port(start_snapshot)
    want = plain.train(_cfg(ttr, 5)).expect("NoCommit")
    cut = _port(start_snapshot)
    got = cut.train(_cfg(ttr, 5), commit_plan=_plan(ttr, plan),
                    commit_fn=lambda s, m: None).expect(plan)
    np.testing.assert_array_equal(got.losses, want.losses)
    np.testing.assert_array_equal(got.grad_norms, want.grad_norms)
    a, b = plain.snapshot(), cut.snapshot()
    for key in a.model_state:
        np.testing.assert_array_equal(a.model_state[key], b.model_state[key], err_msg=key)
    for key in a.optimizer_state.mu:
        np.testing.assert_array_equal(a.optimizer_state.nu[key], b.optimizer_state.nu[key])
    assert (a.global_step, a.sobol_skip, a.sim.skip) == (b.global_step, b.sobol_skip, b.sim.skip)


@pytest.mark.parametrize("plan", PLANS[:5])
def test_commits_segments_and_start_steps_match_jax(start_snapshot, plan: str) -> None:
    """Tier 1 for the steps (commit steps and batches, segment sizes and
    start steps), tier 2 for the losses, 5 batches in both packages."""
    runs = {}
    for name, mod, make in (("jax", jtr, _jax), ("port", ttr, _port)):
        pricer = make(start_snapshot)
        commits, segments = [], []
        pricer.set_segment_callback(lambda s: segments.append((s.start_step, len(s.losses))))
        result = pricer.train(
            _cfg(mod, 5), commit_plan=_plan(mod, plan),
            commit_fn=lambda snap, msg: commits.append((snap.global_step, msg.split()[0],
                                                        msg.split()[-1])),
        ).expect(name)
        runs[name] = (commits, segments, result.losses)
    (jc, js, jl), (tc, ts, tl) = runs["jax"], runs["port"]
    assert tc == jc and ts == js
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_commit_plan_validation_and_execution(start_snapshot) -> None:
    """The port's ``tests/test_trainer.py::test_commit_plan_validation_and_execution``."""
    pricer = _port(start_snapshot)
    for kwargs in ({"commit_plan": ttr.FinalCommit()}, {"commit_fn": lambda s, m: None},
                   {"commit_plan": ttr.IntervalCommit(interval=0),
                    "commit_fn": lambda s, m: None}):
        assert isinstance(pricer.train(_cfg(ttr, 2), **kwargs).error, CommitPlanMismatch)
    commits: list[tuple[int, str]] = []

    def record(snapshot: ttr.GbmCVNNPricerConfig, message: str) -> None:
        commits.append((snapshot.global_step, message))

    pricer.train(_cfg(ttr, 5), commit_plan=ttr.FinalAndIntervalCommit(interval=2),
                 commit_fn=record).expect("train")
    assert [step for step, _ in commits] == [2, 4, 5]
    assert "loss=" in commits[0][1]
    commits.clear()
    _port(start_snapshot).train(_cfg(ttr, 4), commit_plan=ttr.IntervalCommit(interval=2),
                                commit_fn=record).expect("train")
    assert [step for step, _ in commits] == [2, 4]


def test_failing_commit_never_kills_training(start_snapshot, caplog) -> None:
    def boom(snapshot: object, message: str) -> None:
        raise RuntimeError("store down")

    result = _port(start_snapshot).train(
        _cfg(ttr, 3), commit_plan=ttr.IntervalCommit(interval=1), commit_fn=boom)
    assert result.expect("train").total_batches == 3
    assert sum("checkpoint commit failed" in r.message for r in caplog.records) == 3


def test_global_step_and_skip_accumulate_across_calls(start_snapshot) -> None:
    pricer = _port(start_snapshot)
    small = dict(batch_size=2, learning_rate=LR)
    pricer.train(ttr.build_training_config(num_batches=3, **small).expect("c")).expect("t")
    pricer.train(ttr.build_training_config(num_batches=2, **small).expect("c")).expect("t")
    snap = pricer.snapshot()
    assert (snap.global_step, snap.sobol_skip, snap.sim.skip) == (5, 10, 10)


# --------------------------------------------------------------------------
# metrics callbacks and the rates they report
# --------------------------------------------------------------------------


def test_step_callback_receives_metrics(start_snapshot) -> None:
    pricer = _port(start_snapshot)
    seen: list[ttr.StepMetrics] = []
    pricer.set_step_callback(seen.append)
    result = pricer.train(_cfg(ttr, 3)).expect("train")
    assert [m.step for m in seen] == [1, 2, 3]
    np.testing.assert_array_equal([m.loss for m in seen], result.losses)
    assert all(m.learning_rate == LR for m in seen)


def test_segment_callback_matches_per_step_metrics(start_snapshot) -> None:
    per_step: list[ttr.StepMetrics] = []
    segments: list[ttr.SegmentMetrics] = []
    pricer = _port(start_snapshot)
    pricer.set_step_callback(per_step.append)
    pricer.set_segment_callback(segments.append)
    result = pricer.train(_cfg(ttr, 5), commit_plan=ttr.IntervalCommit(interval=2),
                          commit_fn=lambda s, m: None).expect("train")
    assert [len(s.losses) for s in segments] == [2, 2, 1]
    assert [s.start_step for s in segments] == [1, 3, 5]
    flat = np.concatenate([s.losses for s in segments])
    np.testing.assert_array_equal(flat, [m.loss for m in per_step])
    np.testing.assert_array_equal(flat, result.losses)
    np.testing.assert_array_equal(np.concatenate([s.grad_norms for s in segments]),
                                  result.grad_norms)
    assert [m.step for m in per_step] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_rates_match_jax(warmup: int) -> None:
    """Tier 2 (float32): the port's rates at counts 2..9 equal optax's."""
    kw = dict(peak=5e-3, decay_steps=6, warmup_steps=warmup, end_value=1e-4)
    want = np.asarray(jstep.schedule_rates(jstep.LRScheduleConfig(**kw), 2, 8))
    got = tstep.schedule_rates(tstep.LRScheduleConfig(**kw), 2, 8)
    assert got.dtype == np.float32 and got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_reported_rates_are_the_schedules(start_snapshot) -> None:
    """Tier 1: under a warmup-cosine schedule the callbacks report
    ``schedule_rates`` at the global steps, across a resume."""
    schedule = tstep.LRScheduleConfig(peak=5e-3, decay_steps=6, warmup_steps=2, end_value=1e-4)
    pricer = _port(start_snapshot)
    pricer.train(_cfg(ttr, 1, lr_schedule=schedule)).expect("first step")
    steps: list[ttr.StepMetrics] = []
    segments: list[ttr.SegmentMetrics] = []
    pricer.set_step_callback(steps.append)
    pricer.set_segment_callback(segments.append)
    pricer.train(_cfg(ttr, 5, lr_schedule=schedule), commit_plan=ttr.IntervalCommit(interval=2),
                 commit_fn=lambda s, m: None).expect("train")
    want = tstep.schedule_rates(schedule, 1, 5)
    np.testing.assert_array_equal([m.learning_rate for m in steps], want)
    np.testing.assert_array_equal([s.learning_rate for s in segments], want[[1, 3, 4]])


# --------------------------------------------------------------------------
# profile_dir
# --------------------------------------------------------------------------


def test_profile_dir_writes_trace(start_snapshot, tmp_path) -> None:
    """torch.profiler's Chrome trace, with one ``train_segment`` range a
    segment (on the CPU: no CUDA activity is recorded)."""
    pricer = _port(start_snapshot)
    profile_dir = tmp_path / "trace"
    pricer.train(_cfg(ttr, 3), commit_plan=ttr.IntervalCommit(interval=1),
                 commit_fn=lambda s, m: None, profile_dir=str(profile_dir)).expect("train")
    traces = list(profile_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "train_segment" for e in events) == 3


# --------------------------------------------------------------------------
# train_via_effects
# --------------------------------------------------------------------------


def test_train_via_effects_equals_train_bit_exact(start_snapshot) -> None:
    a, b = _port(start_snapshot), _port(start_snapshot)
    ra = a.train(_cfg(ttr, 6)).expect("train")
    rb = b.train_via_effects(_cfg(ttr, 6)).expect("effects")
    np.testing.assert_array_equal(ra.losses, rb.losses)
    np.testing.assert_array_equal(ra.grad_norms, rb.grad_norms)
    sa, sb = ra.updated_config, rb.updated_config
    assert (sa.global_step, sa.sobol_skip, sa.sim.skip) == (sb.global_step, sb.sobol_skip,
                                                            sb.sim.skip)
    for k in sa.model_state:
        np.testing.assert_array_equal(sa.model_state[k], sb.model_state[k], err_msg=k)
    assert sa.optimizer_state.count == sb.optimizer_state.count
    for k in sa.optimizer_state.mu:
        np.testing.assert_array_equal(sa.optimizer_state.mu[k], sb.optimizer_state.mu[k])
        np.testing.assert_array_equal(sa.optimizer_state.nu[k], sb.optimizer_state.nu[k])


def test_train_via_effects_commit_boundaries_match_train(start_snapshot) -> None:
    def run(method_name: str) -> list[tuple[int, str]]:
        pricer = _port(start_snapshot)
        commits: list[tuple[int, str]] = []
        getattr(pricer, method_name)(
            _cfg(ttr, 5), commit_plan=ttr.FinalAndIntervalCommit(interval=2),
            commit_fn=lambda snap, msg: commits.append((snap.global_step, msg)),
        ).expect(method_name)
        return commits

    assert run("train") == run("train_via_effects")


def test_train_via_effects_plan_validation(start_snapshot) -> None:
    failure = _port(start_snapshot).train_via_effects(_cfg(ttr, 4), commit_plan=ttr.FinalCommit())
    assert isinstance(failure.error, CommitPlanMismatch)


def test_train_via_effects_inside_running_event_loop(start_snapshot) -> None:
    pricer = _port(start_snapshot)

    async def orchestrate():
        return pricer.train_via_effects(_cfg(ttr, 2))

    assert asyncio.run(orchestrate()).expect("effects").total_batches == 2


def _chain(root: Path, name: str) -> AsyncBlockchainModelStore:
    return AsyncBlockchainModelStore(FileSystemObjectStore(str(root), name))


def _payloads(store: AsyncBlockchainModelStore) -> list[tuple[str, bytes]]:
    async def read() -> list[tuple[str, bytes]]:
        versions = (await store.list_versions()).expect("versions")
        return [(v.message, (await store.load_checkpoint(v)).expect("payload"))
                for v in versions]

    return asyncio.run(read())


@pytest.mark.parametrize("inside_loop", [False, True], ids=["plain", "inside_loop"])
def test_train_via_effects_commits_reach_the_store(start_snapshot, tmp_path,
                                                   inside_loop: bool) -> None:
    """Tier 1: ``train_via_effects`` through ``make_commit_fn`` commits what
    ``train`` commits — the same messages and checkpoint bytes — also when
    it is called from inside a running event loop."""
    plan = ttr.FinalAndIntervalCommit(interval=2)
    want_store = _chain(tmp_path, "train")
    _port(start_snapshot).train(_cfg(ttr, 5), commit_plan=plan,
                                commit_fn=make_commit_fn(want_store)).expect("train")
    got_store = _chain(tmp_path, "effects")
    pricer = _port(start_snapshot)

    def run():
        return pricer.train_via_effects(_cfg(ttr, 5), commit_plan=plan,
                                        commit_fn=make_commit_fn(got_store))

    async def inside():
        return run()

    (asyncio.run(inside()) if inside_loop else run()).expect("effects")
    want, got = _payloads(want_store), _payloads(got_store)
    assert len(want) == 3
    assert [m for m, _ in got] == [m for m, _ in want]
    assert [p for _, p in got] == [p for _, p in want]


def test_train_from_inside_a_running_loop_commits_through_the_store(start_snapshot,
                                                                   tmp_path) -> None:
    store = _chain(tmp_path, "loop")

    async def orchestrate():
        return _port(start_snapshot).train(_cfg(ttr, 2), commit_plan=ttr.FinalCommit(),
                                           commit_fn=make_commit_fn(store))

    asyncio.run(orchestrate()).expect("train")
    assert len(_payloads(store)) == 1


def test_jax_train_via_effects_loses_make_commit_fn_commits(start_snapshot, tmp_path) -> None:
    """A finding about the reference, pinned without editing it: the JAX
    package's ``train_via_effects`` calls its ``make_commit_fn``, whose
    ``asyncio.run`` raises inside the interpreter's running loop, and
    ``_commit`` swallows the error — ``train`` leaves 2 versions, the effect
    path none. The port commits both (the test above)."""
    from spectralmc_tpu.storage import AsyncBlockchainModelStore as JaxStore
    from spectralmc_tpu.storage import FileSystemObjectStore as JaxFileStore
    from spectralmc_tpu.storage.checkpoint import make_commit_fn as jax_commit_fn

    counts = []
    for method in ("train", "train_via_effects"):
        store = JaxStore(JaxFileStore(str(tmp_path), method))
        getattr(_jax(start_snapshot), method)(
            _cfg(jtr, 4), commit_plan=jtr.IntervalCommit(interval=2),
            commit_fn=jax_commit_fn(store)).expect(method)
        counts.append(len(asyncio.run(store.list_versions()).expect("versions")))
    assert counts == [2, 0]


# --------------------------------------------------------------------------
# the state after a diverged segment
# --------------------------------------------------------------------------


def _planted(snap: jtr.GbmCVNNPricerConfig, where: str) -> jtr.GbmCVNNPricerConfig:
    """A NaN in the first ``w_re`` weight (the first step's loss is NaN), or
    in its Adam ``nu`` (the first step's loss is finite, its update NaN)."""
    model = {k: np.array(v) for k, v in snap.model_state.items()}
    opt = snap.optimizer_state
    nu = {k: np.array(v) for k, v in opt.nu.items()}
    key = sorted(k for k in model if k.endswith("w_re"))[0]
    (model[key] if where == "weight" else nu[key[len("params/"):]]).flat[0] = np.nan
    return dataclasses.replace(snap, model_state=model,
                               optimizer_state=JaxAdamSnapshot(mu=dict(opt.mu), nu=nu,
                                                               count=opt.count))


@pytest.fixture(scope="module")
def trained_snapshot(start_snapshot) -> jtr.GbmCVNNPricerConfig:
    jp = _jax(start_snapshot)
    jp.train(_cfg(jtr, 2)).expect("jax")
    return jp.snapshot()


@pytest.mark.parametrize("plan", ["NoCommit", "IntervalCommit:1"])
@pytest.mark.parametrize("where", ["weight", "moment"])
def test_diverged_segment_leaves_the_jax_state(trained_snapshot, where: str, plan: str) -> None:
    """A NaN planted in a JAX snapshot, resumed in both packages, 3 batches:
    the same ``NonFiniteLoss.step`` (tier 1), ``global_step``, counters and
    Adam count (tier 1) and weights (tier 2, NaN where JAX has NaN)."""
    bad = _planted(trained_snapshot, where)
    outcomes = []
    for mod, make in ((jtr, _jax), (ttr, _port)):
        pricer = make(bad)
        kw = {} if plan == "NoCommit" else {"commit_plan": _plan(mod, plan),
                                             "commit_fn": lambda s, m: None}
        outcomes.append((pricer.train(_cfg(mod, 3), **kw), pricer.snapshot()))
    (jres, jsnap), (tres, tsnap) = outcomes
    assert isinstance(tres.error, NonFiniteLoss)
    assert tres.error.step == jres.error.step
    assert tsnap.global_step == jsnap.global_step
    assert (tsnap.sobol_skip, tsnap.sim.skip) == (jsnap.sobol_skip, jsnap.sim.skip)
    assert tsnap.optimizer_state.count == jsnap.optimizer_state.count
    for key, want in jsnap.model_state.items():
        np.testing.assert_allclose(tsnap.model_state[key], np.asarray(want), atol=1e-5,
                                   equal_nan=True, err_msg=key)
    # the failing segment is the last one; with one batch a segment the
    # first was absorbed where the first loss was finite
    absorbed = 1 if (where, plan) == ("moment", "IntervalCommit:1") else 0
    assert tsnap.global_step == trained_snapshot.global_step + absorbed


def test_diverged_segment_restores_the_pre_segment_state_bit_for_bit(trained_snapshot) -> None:
    """Tier 1: weights, batch-norm buffers, Adam moments and count, and the
    counters after the failure equal those before the failing call."""
    pricer = _port(_planted(trained_snapshot, "moment"))
    pricer.train(_cfg(ttr, 1)).expect("the finite step")
    before = pricer.snapshot()
    assert isinstance(pricer.train(_cfg(ttr, 2)).error, NonFiniteLoss)
    after = pricer.snapshot()
    for key in before.model_state:
        np.testing.assert_array_equal(after.model_state[key], before.model_state[key])
    for key in before.optimizer_state.mu:
        np.testing.assert_array_equal(after.optimizer_state.mu[key],
                                      before.optimizer_state.mu[key])
        np.testing.assert_array_equal(after.optimizer_state.nu[key],
                                      before.optimizer_state.nu[key])
    assert after.optimizer_state.count == before.optimizer_state.count
    assert (after.global_step, after.sobol_skip, after.sim.skip) == (
        before.global_step, before.sobol_skip, before.sim.skip)


def test_train_via_effects_diverges_as_train_does(trained_snapshot) -> None:
    bad = _planted(trained_snapshot, "moment")
    plan = {"commit_plan": ttr.IntervalCommit(interval=1), "commit_fn": lambda s, m: None}
    a, b = _port(bad), _port(bad)
    ra = a.train(_cfg(ttr, 3), **plan)
    rb = b.train_via_effects(_cfg(ttr, 3), **plan)
    assert isinstance(rb.error, NonFiniteLoss) and rb.error.step == ra.error.step
    sa, sb = a.snapshot(), b.snapshot()
    assert sa.global_step == sb.global_step
    for key in sa.model_state:
        np.testing.assert_array_equal(sa.model_state[key], sb.model_state[key])
