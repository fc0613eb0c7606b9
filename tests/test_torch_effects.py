"""The port's effect system against the JAX package's.

The port's counterparts of ``tests/test_effects.py`` and
``tests/test_effects_depth.py`` (ADT invariants, the registry, composition,
every interpreter branch, the builders, the mock), and the interpreters of
both packages on the same effects. Tiers:

* tier 1, exact: effect classes, fields and kinds, the builders' output and
  the refusal reasons of every ``SimulatePaths`` gate equal the JAX
  package's; ``GenerateNormals`` through the port's interpreter equals
  ``ops/rng.py::normal_matrix``, and ``SimulatePaths`` → ``ComputeFFT``
  equals the trainer's ``make_mc_spectrum``; the key words of a draw equal
  ``jax.random.fold_in``'s.
* tier 2: ``GenerateNormals`` against the JAX interpreter within 4 float32
  ulps (the ``erf_inv`` lowering, as ``tests/test_torch_rng.py`` holds
  ``normal``); ``SimulatePaths`` payoffs and ``ComputeFFT`` spectra rtol
  1e-5 with an absolute floor of 1e-5 of the strike (``tests/test_torch_gbm.py``'s
  engine tolerance); ``ForwardPass`` with the JAX weights carried across
  atol 1e-5 (``tests/test_torch_slice.py``'s); ``ComputeLoss`` rtol 1e-6.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import get_args

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.effects import composition as jcomp
from spectralmc_tpu.effects import interpreter as jinterp
from spectralmc_tpu.effects import types as jtypes
from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import rng as jrng
from spectralmc_tpu.training import effects_builders as jbuild
from spectralmc_tpu_torch.core.result import Failure, Success
from spectralmc_tpu_torch.effects import (
    AdvanceCounter,
    BlockUntilReady,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    ComputeLoss,
    Effect,
    ForwardPass,
    GenerateNormals,
    HostDeviceTransfer,
    JitCall,
    LogMessage,
    LogMetrics,
    MockInterpreter,
    ReadMetadata,
    ReadObject,
    RestoreCounters,
    SharedRegistry,
    SimulatePaths,
    SpectralMCInterpreter,
    TrainSegment,
    UpdateMetadata,
    WriteObject,
    map_effect,
    parallel_effects,
    sequence_effects,
)
from spectralmc_tpu_torch.effects import types as ttypes
from spectralmc_tpu_torch.effects.errors import (
    DeviceError,
    MetadataError,
    MonteCarloError,
    RegistryError,
    StorageEffectError,
    UnknownEffect,
)
from spectralmc_tpu_torch.effects.interpreter import TENSORBOARD_WRITER_KEY
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import rng as trng
from spectralmc_tpu_torch.serialization import compute_sha256
from spectralmc_tpu_torch.storage import AsyncBlockchainModelStore, FileSystemObjectStore
from spectralmc_tpu_torch.storage.chain import ModelVersion
from spectralmc_tpu_torch.storage.object_store import InMemoryObjectStore
from spectralmc_tpu_torch.training import effects_builders as tbuild
from spectralmc_tpu_torch.training.step import make_mc_spectrum

CONTRACT = dict(spot=100.0, strike=98.0, maturity=1.2, rate=0.02, div_yield=0.01, vol=0.3)


def run(coro):
    return asyncio.run(coro)


def port_interp(**kw: object) -> SpectralMCInterpreter:
    return SpectralMCInterpreter.create(device="cpu", **kw)


def _ok(result):
    """The value of either package's ``Success``."""
    assert type(result).__name__ == "Success", result
    return result.value


def _err(result):
    assert type(result).__name__ == "Failure", result
    return result.error


def _classes(union: object) -> list[type]:
    out: list[type] = []
    for family in get_args(union):
        for cls in get_args(family) or (family,):
            if cls not in out:
                out.append(cls)
    return out


ALL_EFFECTS = _classes(Effect)


# --------------------------------------------------------------------------
# ADT invariants, and the same effects as the JAX package's
# --------------------------------------------------------------------------


def test_master_union_covers_seven_families() -> None:
    assert len(ALL_EFFECTS) == 20  # 3+3+5+3+3+2+1


def test_effects_match_the_jax_package_field_for_field() -> None:
    jax_classes = _classes(jtypes.Effect)
    assert [c.__name__ for c in ALL_EFFECTS] == [c.__name__ for c in jax_classes]
    for mine, theirs in zip(ALL_EFFECTS, jax_classes):
        assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs()), mine.__name__


@pytest.mark.parametrize("cls", ALL_EFFECTS, ids=lambda c: c.__name__)
def test_every_effect_is_frozen_and_slotted(cls: type) -> None:
    effect = cls()
    with pytest.raises(dataclasses.FrozenInstanceError):
        effect.kind = "mutated"  # type: ignore[misc]
    with pytest.raises((AttributeError, TypeError)):
        effect.sneaky_new_field = 1  # type: ignore[attr-defined]


def test_kind_discriminators_are_unique() -> None:
    kinds = [cls().kind for cls in ALL_EFFECTS]
    assert len(kinds) == len(set(kinds))
    assert SimulatePaths(spot=100.0, out_id="x").kind == "simulate_paths"


def test_validated_factory_rejects_bad_input() -> None:
    assert isinstance(ttypes.build_host_device_transfer("", "host_to_device"), Failure)
    assert isinstance(ttypes.build_host_device_transfer("x", "sideways"), Failure)
    assert _ok(ttypes.build_host_device_transfer("x", "device_to_host")).direction == (
        "device_to_host")


@pytest.mark.parametrize("commit_interval,final", [(None, False), (None, True), (2, True),
                                                   (2, False), (1, True), (3, False)])
def test_builders_match_the_jax_package(commit_interval: int | None, final: bool) -> None:
    kw = dict(num_batches=5, batch_size=4, learning_rate=1e-3,
              commit_interval=commit_interval, final_commit=final)
    mine = tbuild.build_training_run_effects(**kw).effects
    theirs = jbuild.build_training_run_effects(**kw).effects
    assert [dataclasses.asdict(e) for e in mine] == [dataclasses.asdict(e) for e in theirs]
    step = dict(step=3, batch_size=8, learning_rate=1e-3)
    assert ([dataclasses.asdict(e) for e in tbuild.build_training_step_effects(**step).effects]
            == [dataclasses.asdict(e) for e in jbuild.build_training_step_effects(**step).effects])


def test_builder_run_structure() -> None:
    seq = tbuild.build_training_run_effects(num_batches=5, batch_size=4, learning_rate=1e-3,
                                            commit_interval=2, final_commit=True)
    kinds = [e.kind for e in seq.effects]
    assert kinds.count("train_segment") == 3 and kinds.count("commit_version") == 3
    assert [e.length for e in seq.effects if e.kind == "train_segment"] == [2, 2, 1]


def test_simulation_builder_matches_the_jax_package() -> None:
    tsim = tgbm.build_simulation_params(timesteps=4, network_size=16, batches_per_mc_run=8,
                                        mc_seed=7, skip=3).expect("sim")
    jsim = jgbm.build_simulation_params(timesteps=4, network_size=16, batches_per_mc_run=8,
                                        mc_seed=7, skip=3).expect("sim")
    mine = tbuild.build_simulation_effects(tsim, tgbm.BlackScholesContract(**CONTRACT)).effects
    theirs = jbuild.build_simulation_effects(jsim, jgbm.BlackScholesContract(**CONTRACT)).effects
    assert [dataclasses.asdict(e) for e in mine] == [dataclasses.asdict(e) for e in theirs]


# --------------------------------------------------------------------------
# SharedRegistry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("put,get", [("put_array", "get_array"), ("put_blob", "get_blob"),
                                     ("put_model", "get_model"),
                                     ("put_optimizer", "get_optimizer"),
                                     ("put_function", "get_function")])
def test_registry_duplicate_key_rejected_per_store(put: str, get: str) -> None:
    reg = SharedRegistry()
    value = (lambda: 1) if "function" in put else b"v" if "blob" in put else torch.zeros(1)
    _ok(getattr(reg, put)("k", value))
    assert "duplicate" in _err(getattr(reg, put)("k", value)).reason
    assert isinstance(getattr(reg, get)("missing"), Failure)
    other = "put_blob" if put != "put_blob" else "put_array"
    _ok(getattr(reg, other)("k", b"v" if other == "put_blob" else torch.zeros(1)))


def test_registry_metadata_operations() -> None:
    reg = SharedRegistry()
    assert _ok(reg.update_metadata("n", "set", 5)) == 5
    assert _ok(reg.update_metadata("n", "increment", 0)) == 6
    assert _ok(reg.update_metadata("n", "add", 2.5)) == 8.5
    assert "unknown operation" in _err(reg.update_metadata("n", "xor", 1)).reason
    reg.update_metadata("s", "set", "text")
    assert "non-numeric" in _err(reg.update_metadata("s", "increment", 0)).reason
    assert "non-numeric" in _err(reg.update_metadata("s", "add", 1)).reason
    assert isinstance(_err(reg.get_metadata("missing")), RegistryError)


def test_registry_freeze_snapshot_is_immutable_and_detached() -> None:
    reg = SharedRegistry()
    reg.put_blob("a", b"1")
    reg.update_metadata("m", "set", 1)
    snap = reg.freeze_snapshot()
    with pytest.raises(TypeError):
        snap.blobs["b"] = b"2"  # type: ignore[index]
    reg.put_blob("b", b"2")
    reg.update_metadata("m", "set", 99)
    assert "b" not in snap.blobs and snap.metadata["m"] == 1


def test_registry_selective_clears() -> None:
    reg = SharedRegistry()
    reg.put_array("a", torch.zeros(1))
    reg.put_blob("b", b"x")
    reg.update_metadata("m", "set", 1)
    reg.clear_arrays()
    assert isinstance(reg.get_array("a"), Failure) and isinstance(reg.get_blob("b"), Success)
    reg.clear_blobs()
    assert isinstance(reg.get_blob("b"), Failure) and isinstance(reg.get_metadata("m"), Success)
    reg.clear_metadata()
    assert isinstance(reg.get_metadata("m"), Failure)


# --------------------------------------------------------------------------
# Device interpreter
# --------------------------------------------------------------------------


def test_host_device_transfer_roundtrip() -> None:
    interp = port_interp()
    interp.registry.put_array("t", torch.arange(4.0))
    _ok(run(interp.interpret(HostDeviceTransfer(tensor_id="t", direction="device_to_host"))))
    assert isinstance(_ok(interp.registry.get_array("t")), np.ndarray)
    _ok(run(interp.interpret(HostDeviceTransfer(tensor_id="t", direction="host_to_device"))))
    dev = _ok(interp.registry.get_array("t"))
    assert isinstance(dev, torch.Tensor) and dev.device == torch.device("cpu")
    np.testing.assert_array_equal(dev.numpy(), np.arange(4.0))
    assert _ok(run(interp.interpret(BlockUntilReady(tensor_id="t")))) == "t"


def test_interpreter_requires_an_explicit_device() -> None:
    with pytest.raises(TypeError):
        SpectralMCInterpreter.create()  # type: ignore[call-arg]


def test_device_effects_on_missing_tensor_fail() -> None:
    interp = port_interp()
    for effect in (HostDeviceTransfer(tensor_id="ghost"), BlockUntilReady(tensor_id="ghost")):
        assert isinstance(_err(run(interp.interpret(effect))), DeviceError)


def test_jit_call_wiring_executes_registered_callable() -> None:
    interp = port_interp()
    interp.registry.put_function("axpy", lambda a, x: a * x + 1.0)
    interp.registry.put_array("a", torch.tensor(3.0))
    interp.registry.put_array("x", torch.arange(4, dtype=torch.float32))
    assert _ok(run(interp.interpret(JitCall(fn_id="axpy", arg_ids=("a", "x"),
                                            out_id="y")))) == "y"
    np.testing.assert_array_equal(_ok(interp.registry.get_array("y")).numpy(),
                                  np.arange(4.0) * 3.0 + 1.0)


def test_jit_call_failures_are_device_errors() -> None:
    interp = port_interp()
    assert isinstance(_err(run(interp.interpret(JitCall(fn_id="nope")))), DeviceError)
    interp.registry.put_function("boom", lambda: (_ for _ in ()).throw(RuntimeError("kaput")))
    err = _err(run(interp.interpret(JitCall(fn_id="boom"))))
    assert isinstance(err, DeviceError) and "kaput" in err.reason
    interp.registry.put_function("needs_arg", lambda x: x)
    assert isinstance(_err(run(interp.interpret(JitCall(fn_id="needs_arg",
                                                        arg_ids=("ghost",))))), DeviceError)


# --------------------------------------------------------------------------
# Monte-Carlo interpreter, in both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,counter", [(1, 0), (7, 3), (2**40 + 5, 2**31 + 1)])
def test_generate_normals_through_both_interpreters(seed: int, counter: int) -> None:
    effect = dict(rows=8, cols=64, seed=seed, counter=counter, out_id="z")
    port = port_interp()
    _ok(run(port.interpret(GenerateNormals(**effect))))
    got = _ok(port.registry.get_array("z")).numpy()
    direct = trng.normal_matrix(trng.base_key(seed, "cpu"), counter, 8, 64, torch.float32)
    np.testing.assert_array_equal(got, direct.numpy())
    np.testing.assert_array_equal(trng.draw_key(trng.base_key(seed, "cpu"), counter).numpy(),
                                  np.asarray(jax.random.key_data(
                                      jrng.draw_key(jrng.base_key(seed), counter))))
    jax_interp = jinterp.SpectralMCInterpreter.create()
    _ok(run(jax_interp.interpret(jtypes.GenerateNormals(**effect))))
    want = np.asarray(jax_interp.registry.get_array("z").value)
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


def test_normal_stream_api_matches_jax() -> None:
    cfg = trng.build_normal_stream_config(rows=4, cols=32, seed=11, counter=2).expect("cfg")
    jcfg = jrng.build_normal_stream_config(rows=4, cols=32, seed=11, counter=2).expect("cfg")
    assert cfg.model_dump(mode="json") == jcfg.model_dump(mode="json")
    for _ in range(2):
        got = trng.stream_normals(cfg, "cpu").numpy()
        want = np.asarray(jrng.stream_normals(jcfg))
        ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4
        cfg, jcfg = trng.advance(cfg), jrng.advance(jcfg)
    assert cfg.counter == jcfg.counter == 4
    for bad in (dict(rows=0, cols=1, seed=0), dict(rows=1, cols=1, seed=-1),
                dict(rows=1, cols=1, seed=0, counter=-1)):
        assert type(trng.build_normal_stream_config(**bad).error).__name__ == type(
            jrng.build_normal_stream_config(**bad).error).__name__


def _simulate(payoff: str = "terminal", **over: object) -> dict[str, object]:
    return {**CONTRACT, "timesteps": 4, "batches": 8, "network_size": 16, "seed": 11,
            "counter": 4, "scheme": "log_euler", "normalization": "mean", "payoff": payoff,
            "model": "gbm", "precision": "float32", "out_id": "prices", **over}


@pytest.mark.parametrize("payoff,over", [
    ("terminal", {}), ("asian_arithmetic", {}), ("terminal", {"antithetic": True}),
    ("barrier_up_out", {"normalization": "none", "barrier_rel": 1.3}),
    ("terminal", {"term_vol": (1.0, 1.2, 0.8, 1.0), "term_rate": (1.0, 1.0, 1.5, 0.5)}),
    ("american_put", {"normalization": "none", "lsmc_exercise_every": 2}),
])
def test_simulate_paths_and_fft_match_jax(payoff: str, over: dict[str, object]) -> None:
    """The American put's exercise decisions depend on the regression's
    reduction order: at most 2% of its paths may differ past the tolerance
    (the torch estimator's gate against JAX, ``tests/test_torch_american.py``),
    and its spectrum, which such a path moves, is not compared."""
    effects = [SimulatePaths(**_simulate(payoff, **over)),
               ComputeFFT(in_id="prices", batches=8, network_size=16, out_id="spec")]
    port = port_interp()
    _ok(run(port.interpret_sequence(sequence_effects(effects))))
    jax_interp = jinterp.SpectralMCInterpreter.create()
    jeffects = [jtypes.SimulatePaths(**_simulate(payoff, **over)),
                jtypes.ComputeFFT(in_id="prices", batches=8, network_size=16, out_id="spec")]
    _ok(run(jax_interp.interpret_sequence(jcomp.sequence_effects(jeffects))))
    floor = 1e-5 * CONTRACT["strike"]
    for key in ("prices", "spec"):
        got = _ok(port.registry.get_array(key)).numpy()
        want = np.asarray(jax_interp.registry.get_array(key).value)
        assert got.shape == want.shape
        if payoff.startswith("american"):
            missed = ~np.isclose(got, want, rtol=1e-5, atol=floor)
            assert missed.sum() <= 0.02 * got.size, missed.sum()
            break
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor, err_msg=key)


def test_simulate_fft_effects_equal_the_trainers_spectrum_bit_exact() -> None:
    sim = tgbm.build_simulation_params(timesteps=3, network_size=16, batches_per_mc_run=8,
                                       mc_seed=11).expect("sim")
    contract = torch.tensor([list(CONTRACT.values())], dtype=torch.float32)
    direct = make_mc_spectrum(sim, device=torch.device("cpu"))(torch.tensor([4]), contract)[0]
    interp = port_interp()
    _ok(run(interp.interpret_sequence(sequence_effects([
        SimulatePaths(**{**_simulate(), "timesteps": 3}),
        ComputeFFT(in_id="prices", batches=8, network_size=16, out_id="spec"),
    ]))))
    np.testing.assert_array_equal(_ok(interp.registry.get_array("spec")).numpy(), direct.numpy())


def test_real_interpreter_montecarlo_pipeline() -> None:
    sim = tgbm.build_simulation_params(timesteps=2, network_size=16, batches_per_mc_run=4,
                                       mc_seed=7).expect("sim")
    interp = port_interp()
    seq = tbuild.build_simulation_effects(
        sim, tgbm.BlackScholesContract(spot=100.0, strike=100.0, maturity=1.0, rate=0.03,
                                       div_yield=0.01, vol=0.25), out_id="payoffs")
    _ok(run(interp.interpret_sequence(seq)))
    spectrum = _ok(interp.registry.get_array("payoffs/spectrum"))
    assert spectrum.shape == (16,) and float(spectrum[0].real) > 0  # ATM put
    assert _ok(interp.registry.get_metadata("mc_skip")) == 1


GATES = {
    "heston": dict(model="heston"),
    "bad_enum": dict(scheme="milstein"),
    "digital_mean": dict(payoff="digital"),
    "barrier_mean": dict(payoff="barrier_up_out", barrier_rel=1.3),
    "qmc_american": dict(payoff="american_put", normalization="none", sampling="sobol_bb"),
    "qmc_antithetic": dict(sampling="sobol_bb", antithetic=True),
    "american_euler": dict(payoff="american_put", normalization="none", scheme="euler"),
    "american_every": dict(payoff="american_put", normalization="none",
                           lsmc_exercise_every=3),
    "american_one_date": dict(payoff="american_put", normalization="none",
                              lsmc_exercise_every=4),
    "barrier_zero": dict(payoff="barrier_up_out", normalization="none"),
    "up_out_below": dict(payoff="barrier_up_out", normalization="none", barrier_rel=0.9),
    "down_out_above": dict(payoff="barrier_down_out", normalization="none", barrier_rel=1.1),
    "forward_start_step": dict(payoff="forward_start", forward_start_step=4),
    "stray_forward_start": dict(forward_start_step=2),
    "cliquet_missing": dict(payoff="cliquet", normalization="none", cliquet_reset_every=2),
    "cliquet_grid": dict(payoff="cliquet", normalization="none", cliquet_reset_every=3,
                         cliquet_floor=0.0, cliquet_cap=0.1),
    "cliquet_levels": dict(payoff="cliquet", normalization="none", cliquet_reset_every=2,
                           cliquet_floor=0.2, cliquet_cap=0.1),
    "cliquet_mean": dict(payoff="cliquet", cliquet_reset_every=2, cliquet_floor=0.0,
                         cliquet_cap=0.1),
    "stray_cliquet": dict(cliquet_cap=0.1),
    "term_length": dict(term_vol=(1.0, 1.0)),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_simulate_paths_gates_refuse_with_the_jax_reasons(case: str) -> None:
    fields = {**_simulate(), **GATES[case]}
    err = _err(run(port_interp().interpret(SimulatePaths(**fields))))
    want = _err(run(jinterp.SpectralMCInterpreter.create().interpret(
        jtypes.SimulatePaths(**fields))))
    assert isinstance(err, MonteCarloError)
    assert (err.effect_kind, err.reason) == (want.effect_kind, want.reason)


def test_generate_normals_duplicate_out_id_fails() -> None:
    interp = port_interp()
    effect = GenerateNormals(rows=2, cols=4, seed=1, counter=0, out_id="z")
    _ok(run(interp.interpret(effect)))
    assert isinstance(_err(run(interp.interpret(effect))), MonteCarloError)


# --------------------------------------------------------------------------
# Training interpreter
# --------------------------------------------------------------------------


def _cvnn(mod):
    return mod.build_cvnn_config(
        layers=[mod.LinearCfg(width=8, activation=mod.Activation.MODRELU), mod.CovBNCfg(),
                mod.LinearCfg(width=12, activation=mod.Activation.ZRELU)], seed=5,
    ).expect("cvnn")


@pytest.mark.parametrize("train", [False, True])
def test_forward_pass_matches_jax_with_its_weights(train: bool) -> None:
    jmodel = jf.build_model(_cvnn(jf), input_dim=6, output_dim=16).expect("jax model")
    params, state = jmodel.init()
    flat = {**{f"params/{k}": np.asarray(v) for k, v in _flat(params).items()},
            **{f"state/{k}": np.asarray(v) for k, v in _flat(state).items()}}
    model = tf.build_model(_cvnn(tf), input_dim=6, output_dim=16).expect("port model")
    tf.load_state_dict(model, flat).expect("weights carried across")
    inputs = np.random.default_rng(0).uniform(0.0, 1.0, (5, 6)).astype(np.float32)
    port = port_interp()
    port.registry.put_model("cvnn", model)
    port.registry.put_array("x", torch.from_numpy(inputs))
    buffers = [b.clone() for b in model.buffers()]
    _ok(run(port.interpret(ForwardPass(model_id="cvnn", in_id="x", out_id="y", train=train))))
    for before, after in zip(buffers, model.buffers()):  # apply()'s new state is dropped
        assert torch.equal(before, after)
    jax_interp = jinterp.SpectralMCInterpreter.create()
    jax_interp.registry.put_model("cvnn", (jmodel, params, state))
    jax_interp.registry.put_array("x", jnp.asarray(inputs))
    _ok(run(jax_interp.interpret(jtypes.ForwardPass(model_id="cvnn", in_id="x", out_id="y",
                                                    train=train))))
    for part in ("re", "im"):
        np.testing.assert_allclose(_ok(port.registry.get_array(f"y/{part}")).numpy(),
                                   np.asarray(jax_interp.registry.get_array(f"y/{part}").value),
                                   atol=1e-5)


def _flat(tree: object, prefix: str = "") -> dict[str, object]:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = leaf
    return out


@pytest.mark.parametrize("loss_type", ["mse", "mae", "huber"])
def test_compute_loss_matches_jax(loss_type: str) -> None:
    gen = np.random.default_rng(1)
    pred = (gen.standard_normal(32) + 1j * gen.standard_normal(32)).astype(np.complex64)
    target = (2.0 * gen.standard_normal(32)).astype(np.complex64)
    port = port_interp()
    port.registry.put_array("p", torch.from_numpy(pred))
    port.registry.put_array("t", torch.from_numpy(target))
    _ok(run(port.interpret(ComputeLoss(loss_type=loss_type, pred_id="p", target_id="t",
                                       out_id="l"))))
    jax_interp = jinterp.SpectralMCInterpreter.create()
    jax_interp.registry.put_array("p", jnp.asarray(pred))
    jax_interp.registry.put_array("t", jnp.asarray(target))
    _ok(run(jax_interp.interpret(jtypes.ComputeLoss(loss_type=loss_type, pred_id="p",
                                                    target_id="t", out_id="l"))))
    np.testing.assert_allclose(float(_ok(port.registry.get_array("l"))),
                               float(jax_interp.registry.get_array("l").value), rtol=1e-6)


def test_train_segment_and_log_metrics_effects() -> None:
    interp = port_interp()
    assert "no registered function" in _err(run(interp.interpret(TrainSegment(length=1)))).reason
    interp.registry.put_function("train_segment", lambda effect: effect.length * 10)
    assert _ok(run(interp.interpret(TrainSegment(length=3)))) == 30

    class Writer:
        scalars: list = []

        def add_scalar(self, tag: str, value: float, step: int) -> None:
            self.scalars.append((tag, value, step))

    interp.registry.put_model(TENSORBOARD_WRITER_KEY, Writer())
    assert _ok(run(interp.interpret(LogMetrics(step=7, metrics={"loss": 0.5})))) == 7
    assert Writer.scalars == [("loss", 0.5, 7)]


def test_mock_interpreter_records_and_asserts() -> None:
    mock = MockInterpreter(mock_results={TrainSegment: {"loss": 1.0}})
    seq = tbuild.build_training_step_effects(step=3, batch_size=8, learning_rate=1e-3)
    result = _ok(run(mock.interpret_sequence(seq)))
    assert result[0] == {"loss": 1.0}
    mock.assert_effect_sequence([TrainSegment, AdvanceCounter, AdvanceCounter, UpdateMetadata,
                                 LogMetrics])
    mock.assert_effect_count(AdvanceCounter, 2)
    mock.assert_contains(AdvanceCounter(stream="sobol", by=8))
    failing = MockInterpreter(mock_results={ReadMetadata: Failure("no")})
    assert isinstance(run(failing.interpret_sequence(sequence_effects(
        [ReadMetadata(key="k"), LogMessage()]))), Failure)
    assert len(failing.recorded) == 1
    mock.clear()
    assert mock.recorded == []


# --------------------------------------------------------------------------
# Storage interpreter against the real store
# --------------------------------------------------------------------------


def test_storage_effects_roundtrip_and_commit_on_a_filesystem_chain(tmp_path) -> None:
    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(tmp_path), "fx"))
    interp = port_interp(store=store)
    payload = b"effect-committed"
    interp.registry.put_blob("checkpoint", payload)
    seq = sequence_effects([
        WriteObject(key="scratch/obj", data_id="checkpoint"),
        ReadObject(key="scratch/obj", out_id="readback"),
        CommitVersion(data_id="checkpoint", content_hash=compute_sha256(payload),
                      message="via effects"),
    ])
    result = _ok(run(interp.interpret_sequence(seq)))
    assert _ok(interp.registry.get_blob("readback")) == payload
    version = result[2]
    assert isinstance(version, ModelVersion)
    assert (version.counter, version.message) == (0, "via effects")


def test_commit_version_checksum_mismatch_leaves_the_chain() -> None:
    store = AsyncBlockchainModelStore(InMemoryObjectStore("effects"))
    interp = port_interp(store=store)
    interp.registry.put_blob("ckpt", b"model-v1")
    _ok(run(interp.interpret(CommitVersion(data_id="ckpt", content_hash=compute_sha256(
        b"model-v1"), message="v1"))))
    interp.registry.put_blob("bad", b"model-v2")
    err = _err(run(interp.interpret(CommitVersion(data_id="bad", content_hash="0" * 64,
                                                  message="corrupt"))))
    assert isinstance(err, StorageEffectError)
    assert _ok(run(store.get_head())).counter == 0


def test_storage_effects_without_store_fail_loud() -> None:
    err = _err(run(port_interp().interpret(ReadObject(key="k", out_id="o"))))
    assert isinstance(err, StorageEffectError) and "no store" in err.reason


# --------------------------------------------------------------------------
# RNG, metadata, logging, routing and composition
# --------------------------------------------------------------------------


def test_rng_counter_capture_restore_advance() -> None:
    interp = port_interp()
    assert _ok(run(interp.interpret(CaptureCounters()))) == {"sobol_skip": 0, "mc_skip": 0}
    _ok(run(interp.interpret(RestoreCounters(sobol_skip=32, mc_skip=7))))
    assert _ok(run(interp.interpret(AdvanceCounter(stream="mc", by=5)))) == 12
    assert _ok(run(interp.interpret(AdvanceCounter(stream="sobol", by=8)))) == 40
    assert _ok(run(interp.interpret(CaptureCounters()))) == {"sobol_skip": 40, "mc_skip": 12}


def test_metadata_effects() -> None:
    interp = port_interp()
    assert isinstance(_err(run(interp.interpret(ReadMetadata(key="ghost")))), MetadataError)
    _ok(run(interp.interpret(UpdateMetadata(key="k", operation="set", value=3))))
    assert _ok(run(interp.interpret(ReadMetadata(key="k")))) == 3


def test_log_message_levels(caplog: pytest.LogCaptureFixture) -> None:
    interp = port_interp()
    with caplog.at_level(logging.WARNING, logger="spectralmc_tpu_torch.test"):
        _ok(run(interp.interpret(LogMessage(level="warning", message="heads up",
                                            logger="spectralmc_tpu_torch.test"))))
    assert any("heads up" in r.message for r in caplog.records)
    assert "bad level" in _err(run(interp.interpret(LogMessage(level="shout")))).reason


def test_unknown_effect_is_typed_failure() -> None:
    class NotAnEffect:
        kind = "imposter"

    err = _err(run(port_interp().interpret(NotAnEffect())))
    assert isinstance(err, UnknownEffect) and err.type_name == "NotAnEffect"


def test_sequence_fails_fast_and_skips_rest() -> None:
    interp = port_interp()
    executed: list[int] = []
    interp.registry.put_function("track", lambda *a: executed.append(1))
    seq = sequence_effects([JitCall(fn_id="track"), ReadMetadata(key="missing"),
                            JitCall(fn_id="track")])
    assert isinstance(run(interp.interpret_sequence(seq)), Failure)
    assert executed == [1]
    seq = sequence_effects([ComputeFFT(in_id="never_registered", batches=1, network_size=4,
                                       out_id="x"), LogMessage(message="unreachable")])
    assert isinstance(_err(run(interp.interpret_sequence(seq))), MonteCarloError)


def test_sequence_continuation_combines_results() -> None:
    seq = sequence_effects([UpdateMetadata(key="a", operation="set", value=2),
                            UpdateMetadata(key="b", operation="set", value=3)],
                           continuation=lambda results: results[0] * results[1])
    assert _ok(run(port_interp().interpret_sequence(seq))) == 6


def test_parallel_combiner_and_failure_propagation() -> None:
    interp = port_interp()
    par = parallel_effects([UpdateMetadata(key="x", operation="set", value=1),
                            UpdateMetadata(key="y", operation="set", value=2)], combiner=sum)
    assert _ok(run(interp.interpret_parallel(par))) == 3
    bad = parallel_effects([ReadMetadata(key="nope"), UpdateMetadata(key="z")])
    assert isinstance(run(interp.interpret_parallel(bad)), Failure)


def test_mapped_effect_applies_fn_to_success_only() -> None:
    interp = port_interp()
    interp.registry.update_metadata("k", "set", 10)
    assert _ok(run(interp.interpret(map_effect(ReadMetadata(key="k"), lambda v: v * 2)))) == 20
    assert isinstance(run(interp.interpret(map_effect(ReadMetadata(key="ghost"),
                                                      lambda v: v * 2))), Failure)
