"""The port's checkpoint wire format against the JAX package's (tier 1: exact bytes).

Both packages encode the same values to the same bytes, part by part; every
golden checkpoint of ``tests/fixtures/checkpoints/`` (JAX-written) decodes in
the port with its hash checked, re-encodes to its own bytes with its
provenance passed through, and resumes. Across the packages (tier 2, the
tolerances of ``tests/test_torch_slice.py``): a resumed fixture's losses
match the JAX package's to rtol 1e-4 (the American fixture's are only
finite: its exercise bits depend on reduction order), a port ``"xla"``
checkpoint decodes, predicts (rtol 1e-5) and resumes (rtol 1e-4) in the JAX
package and a freshly trained JAX one in the port, and the JAX package
refuses a port ``"cuda"`` checkpoint with a ``DecodeError`` on
``sim_params``. Decode failures are ``Failure`` results, never exceptions.

Hypothesis draws tensors (``derandomize=True``, 60 examples) and flipped
bytes of a real checkpoint (``derandomize=True``, 150 examples), both with
``deadline=None``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from spectralmc_tpu.core.errors.serialization import DecodeError as JaxDecodeError
from spectralmc_tpu.core.result import Failure as JaxFailure
from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.proto import common_pb2 as jcommon
from spectralmc_tpu.proto import models_pb2 as jmodels
from spectralmc_tpu.proto import simulation_pb2 as jsimulation
from spectralmc_tpu.proto import tensors_pb2 as jtensors
from spectralmc_tpu.proto import training_pb2 as jtraining
from spectralmc_tpu.serialization import converters as jconv
from spectralmc_tpu.training import adam_state as jadam
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.core.errors.serialization import ChecksumMismatch, DecodeError
from spectralmc_tpu_torch.core.errors.trainer import CheckpointMismatch
from spectralmc_tpu_torch.core.provenance import JaxEnv, Provenance, TorchEnv
from spectralmc_tpu_torch.core.result import Failure, Success
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.proto import common_pb2 as tcommon
from spectralmc_tpu_torch.proto import models_pb2 as tmodels
from spectralmc_tpu_torch.proto import simulation_pb2 as tsimulation
from spectralmc_tpu_torch.proto import tensors_pb2 as ttensors
from spectralmc_tpu_torch.proto import training_pb2 as ttraining
from spectralmc_tpu_torch.serialization import converters as tconv
from spectralmc_tpu_torch.training import adam_state as tadam
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "checkpoints"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
EUROPEAN_FIXTURES = sorted(n for n in MANIFEST if n != "gbm_american_put")
FIXTURE_ENV = JaxEnv(jax_version="0.9.0", backend="cpu", device_kind="cpu",
                     python_version="3.12.12")

PROTO_MODULES = ((jcommon, tcommon), (jmodels, tmodels), (jsimulation, tsimulation),
                 (jtensors, ttensors), (jtraining, ttraining))
PORT_ONLY_FIELDS = {"ModelCheckpointProto": {"cuda_stream_version": 13, "torch_env": 14}}

BOUNDS = {
    "spot": (95.0, 105.0),
    "strike": (95.0, 105.0),
    "maturity": (0.5, 1.5),
    "rate": (0.01, 0.05),
    "div_yield": (0.0, 0.02),
    "vol": (0.2, 0.3),
}
SIM = dict(timesteps=8, network_size=16, batches_per_mc_run=8, mc_seed=11)
RESUME = dict(num_batches=2, batch_size=4, learning_rate=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the trainer steps are many small ops,
    which torch's thread pool slows while the suite's other workers hold the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ok(result):
    assert isinstance(result, Success), f"expected Success, got {result!r}"
    return result.value


def _err(result):
    assert isinstance(result, Failure), f"expected Failure, got {result!r}"
    return result.error


def _wire(message) -> bytes:
    return message.SerializeToString(deterministic=True)


# --------------------------------------------------------------------------
# Schema parity
# --------------------------------------------------------------------------


def _messages(module) -> dict[str, object]:
    return dict(module.DESCRIPTOR.message_types_by_name)


def _field_sig(field) -> tuple:
    return (field.name, field.number, field.type, field.is_repeated,
            field.message_type.name if field.message_type else None,
            field.enum_type.name if field.enum_type else None,
            field.containing_oneof.name if field.containing_oneof else None,
            field.has_presence)


def _nested(desc) -> list:
    out = [desc]
    for sub in desc.nested_types:
        out.extend(_nested(sub))
    return out


JAX_MESSAGES = sorted(name for jmod, _ in PROTO_MODULES for name in _messages(jmod))


@pytest.mark.parametrize("name", JAX_MESSAGES)
def test_schema_parity(name: str) -> None:
    """Every JAX message has a port twin with the same fields (name, number,
    type, repetition, presence, oneof), nested map entries included; the port's
    only additions are ModelCheckpointProto fields 13 and 14."""
    jdesc = next(_messages(j)[name] for j, _ in PROTO_MODULES if name in _messages(j))
    tdesc = next(_messages(t)[name] for _, t in PROTO_MODULES if name in _messages(t))
    extra = PORT_ONLY_FIELDS.get(name, {})
    for jd, td in zip(_nested(jdesc), _nested(tdesc), strict=True):
        assert jd.name == td.name
        want = sorted(_field_sig(f) for f in jd.fields)
        got = sorted(_field_sig(f) for f in td.fields if f.name not in extra)
        assert got == want
        assert jd.GetOptions().map_entry == td.GetOptions().map_entry
    assert {f.name: f.number for f in tdesc.fields if f.name in extra} == extra
    assert tdesc.full_name == f"spectralmc_tpu_torch.{name}"


def test_schema_parity_enums_files_and_additions() -> None:
    for jmod, tmod in PROTO_MODULES:
        jenums, tenums = jmod.DESCRIPTOR.enum_types_by_name, tmod.DESCRIPTOR.enum_types_by_name
        assert set(jenums) == set(tenums)
        for name in jenums:
            assert ([(v.name, v.number) for v in jenums[name].values]
                    == [(v.name, v.number) for v in tenums[name].values])
        assert tmod.DESCRIPTOR.package == "spectralmc_tpu_torch"
        assert tmod.DESCRIPTOR.name == f"spectralmc_tpu_torch/proto/{jmod.DESCRIPTOR.name}"
    port_only = {n for _, t in PROTO_MODULES for n in _messages(t)} - set(JAX_MESSAGES)
    assert port_only == {"TorchEnvProto"}
    torch_env = tcommon.TorchEnvProto.DESCRIPTOR
    assert [(f.name, f.number, f.type) for f in torch_env.fields] == [
        ("torch_version", 1, 9), ("cuda_version", 2, 9), ("device_kind", 3, 9),
        ("python_version", 4, 9)]
    root = ttensors.ModelCheckpointProto.DESCRIPTOR.fields_by_name
    assert root["cuda_stream_version"].type == root["pallas_stream_version"].type  # uint32
    assert root["torch_env"].message_type is torch_env


# --------------------------------------------------------------------------
# Byte equality, part by part
# --------------------------------------------------------------------------

TENSOR_DTYPES = [np.float32, np.float64, np.complex64, np.complex128, np.uint32, np.int64,
                 np.bool_]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(hnp.arrays(dtype=st.sampled_from(TENSOR_DTYPES),
                  shape=hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4)))
def test_tensor_bytes_equal_jax(arr: np.ndarray) -> None:
    assert _wire(tconv.tensor_to_proto(arr)) == _wire(jconv.tensor_to_proto(arr))
    back = _ok(tconv.tensor_from_proto(tconv.tensor_to_proto(arr)))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_tensor_map_bytes_equal_jax() -> None:
    gen = np.random.default_rng(5)
    flat = {
        "params/layer_1/w_re": gen.standard_normal((3, 4)).astype(np.float32),
        "state/layer_0/count": np.asarray(np.uint32(7)),  # 0-d
        "params/layer_0/b": (gen.standard_normal(5) + 1j * gen.standard_normal(5)).astype(
            np.complex64),
        "empty": np.zeros((0, 2), np.float64),
        "a": np.arange(6, dtype=np.int64).reshape(2, 3).T,  # not C-contiguous
    }
    assert _wire(tconv.tensor_map_to_proto(flat)) == _wire(jconv.tensor_map_to_proto(flat))
    back = _ok(tconv.tensor_map_from_proto(tconv.tensor_map_to_proto(flat)))
    for key, want in flat.items():
        assert back[key].shape == want.shape
        np.testing.assert_array_equal(back[key], want)


TERM = dict(vol_shape=(1.3, 1.1, 0.9, 0.7, 0.8, 1.0, 1.2, 1.0), rate_shape=(0.7,) * 8,
            div_shape=())
BASKET = dict(weights=(0.5, 0.3, 0.2), correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3),
                                                    (0.2, 0.3, 1.0)),
              spot_multipliers=(1.0, 0.95, 1.05), vol_multipliers=(1.0, 1.2, 0.8),
              combine="geometric")
SIM_CASES = {
    "flat": dict(),
    "curved": dict(term=TERM),
    "flat_term_present": dict(term=dict()),
    "basket": dict(model="basket_gbm", basket=BASKET),
    "cliquet_zero_floor": dict(payoff="cliquet", normalization="none", cliquet_reset_every=4,
                               cliquet_floor=0.0, cliquet_cap=0.05),
    "sobol_bb": dict(sampling="sobol_bb", mc_seed=31),
    "american": dict(payoff="american_put", normalization="none", lsmc_basis_degree=3,
                     lsmc_exercise_every=2, lsmc_cross_fit=True),
    "barrier_euler_antithetic": dict(payoff="barrier_up_out", barrier_rel=1.25,
                                     normalization="none", scheme="euler", antithetic=True),
    "heston_float64_skip": dict(model="heston", precision="float64", skip=96),
    "merton_forward_start": dict(model="merton_jump", payoff="forward_start",
                                 forward_start_step=4),
}


def _sim(mod_gbm, mod_basket, case: dict):
    kw = {**SIM, **case}
    if "term" in kw:
        kw["term"] = mod_gbm.TermStructure(**kw["term"])
    if "basket" in kw:
        kw["basket"] = mod_basket.build_basket_spec(**kw["basket"]).expect("basket")
    return mod_gbm.build_simulation_params(**kw).expect("sim")


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_params_bytes_equal_jax(case: str) -> None:
    jsim = _sim(jgbm, jbasket, SIM_CASES[case])
    tsim = _sim(tgbm, tbasket, SIM_CASES[case])
    data = _wire(tconv.sim_params_to_proto(tsim))
    assert data == _wire(jconv.sim_params_to_proto(jsim))
    proto = tsimulation.SimulationParamsProto()
    proto.ParseFromString(data)
    assert _ok(tconv.sim_params_from_proto(proto)) == tsim


def _layers(mod) -> list:
    return [
        mod.LinearCfg(width=8, bias=False, activation=mod.Activation.MODRELU),
        mod.NaiveBNCfg(),
        mod.CovBNCfg(),
        mod.ResidualCfg(
            body=mod.SequentialCfg(layers=(
                mod.LinearCfg(width=12, activation=mod.Activation.ZRELU),
                mod.ResidualCfg(body=mod.LinearCfg()),
                mod.LinearCfg(width=12),
            )),
            activation=mod.Activation.MODRELU,
        ),
        mod.LinearCfg(),
    ]


def test_cvnn_config_bytes_equal_jax() -> None:
    jcfg = jf.build_cvnn_config(layers=_layers(jf), seed=11,
                                final_activation=jf.Activation.ZRELU).expect("jax")
    tcfg = tf.build_cvnn_config(layers=_layers(tf), seed=11,
                                final_activation=tf.Activation.ZRELU).expect("port")
    data = _wire(tconv.cvnn_config_to_proto(tcfg))
    assert data == _wire(jconv.cvnn_config_to_proto(jcfg))
    proto = tmodels.CVNNConfigProto()
    proto.ParseFromString(data)
    assert _ok(tconv.cvnn_config_from_proto(proto)) == tcfg


@pytest.mark.parametrize("schedule", [False, True])
def test_training_config_bytes_equal_jax(schedule: bool) -> None:
    sched = dict(peak=5e-3, decay_steps=60, warmup_steps=6, end_value=1e-5)
    kw = dict(num_batches=40, batch_size=64, learning_rate=2e-3, contract_chunk=16)
    jcfg = jtr.build_training_config(
        **kw, lr_schedule=jstep.LRScheduleConfig(**sched) if schedule else None).expect("jax")
    tcfg = ttr.build_training_config(
        **kw, lr_schedule=tstep.LRScheduleConfig(**sched) if schedule else None).expect("port")
    data = _wire(tconv.training_config_to_proto(tcfg))
    assert data == _wire(jconv.training_config_to_proto(jcfg))
    proto = ttraining.TrainingConfigProto()
    proto.ParseFromString(data)
    assert _ok(tconv.training_config_from_proto(proto)) == tcfg


def test_adam_state_bytes_equal_jax() -> None:
    gen = np.random.default_rng(9)
    mu = {"layer_0/w_re": gen.standard_normal((6, 8)).astype(np.float32),
          "layer_0/b_re": gen.standard_normal(8).astype(np.float32)}
    nu = {k: np.abs(v) for k, v in mu.items()}
    tsnap = tadam.AdamStateSnapshot(mu=mu, nu=nu, count=7)
    jsnap = jadam.AdamStateSnapshot(mu=mu, nu=nu, count=7)
    data = _wire(tconv.adam_state_to_proto(tsnap))
    assert data == _wire(jconv.adam_state_to_proto(jsnap))
    proto = ttensors.AdamStateProto()
    proto.ParseFromString(data)
    back = _ok(tconv.adam_state_from_proto(proto))
    assert back.count == 7 and back.schema_version == tadam.ADAM_SCHEMA_VERSION
    for key in mu:
        np.testing.assert_array_equal(back.mu[key], mu[key])
        np.testing.assert_array_equal(back.nu[key], nu[key])


# --------------------------------------------------------------------------
# The golden corpus in the port
# --------------------------------------------------------------------------


def _resume(config, *, device: str = "cpu") -> np.ndarray:
    pricer = ttr.GbmCVNNPricer.create(config, device=device).expect("resume")
    cfg = ttr.build_training_config(**RESUME).expect("training config")
    return np.asarray(pricer.train(cfg).expect("train").losses)


def _jax_resume(config) -> np.ndarray:
    pricer = jtr.GbmCVNNPricer.create(config).expect("jax resume")
    cfg = jtr.build_training_config(**RESUME).expect("training config")
    return np.asarray(pricer.train(cfg).expect("jax train").losses)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_checkpoint_decodes_reencodes_and_resumes_in_port(name: str) -> None:
    data = (FIXTURES / f"{name}.pb").read_bytes()
    cfg = _ok(tconv.deserialize_checkpoint(data, expected_hash=MANIFEST[name]))
    assert cfg.provenance == Provenance(jax_env=FIXTURE_ENV)
    assert (cfg.sim.implementation, cfg.pallas_stream_version, cfg.lsmc_backward_version,
            cfg.cuda_stream_version, cfg.global_step) == (tgbm.SimImplementation.XLA, 0, 0, 0, 2)
    again, digest = tconv.serialize_checkpoint(cfg)
    assert digest == MANIFEST[name]
    assert again == data
    if name == "gbm_qmc_terminal":
        assert cfg.sim.sampling == tgbm.SamplingKind.SOBOL_BB
    if name == "merton_cliquet":
        assert (cfg.sim.cliquet_reset_every, cfg.sim.cliquet_floor) == (4, 0.0)
    if name == "gbm_american_put":
        assert (cfg.sim.lsmc_basis_degree, cfg.sim.lsmc_exercise_every) == (3, 2)
    assert np.all(np.isfinite(_resume(cfg)))


@pytest.mark.parametrize("name", EUROPEAN_FIXTURES)
def test_golden_checkpoint_resume_matches_jax(name: str) -> None:
    data = (FIXTURES / f"{name}.pb").read_bytes()
    port = _resume(_ok(tconv.deserialize_checkpoint(data)))
    jax = _jax_resume(jconv.deserialize_checkpoint(data).expect(name))
    np.testing.assert_allclose(port, jax, rtol=1e-4)


# --------------------------------------------------------------------------
# Across the packages, both ways
# --------------------------------------------------------------------------


def _slice_cvnn(mod):
    """``tests/test_torch_slice.py``'s head at width 8/12 (no bias before the
    covariance batch norm: that bias's gradient is rounding noise)."""
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


def _port_config(implementation: str = "xla") -> ttr.GbmCVNNPricerConfig:
    sim = tgbm.build_simulation_params(**SIM, implementation=implementation).expect("sim")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    return ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_slice_cvnn(tf),
                                   normalize_inputs=True)


def _assert_prices_close(got, want) -> None:
    """rtol 1e-5 (``tests/test_torch_slice.py``), with an atol of 1e-5 of the
    batch's scale: a put is the mean of the network's real IFFT outputs, so a
    put near 0 carries the rounding of terms as large as the batch's largest
    put; a call is the put plus df·(E[u] − K), which adds that term's."""
    put, call = np.asarray(want.put), np.asarray(want.call)
    put_scale = np.abs(put).max()
    call_scale = max(put_scale, np.abs(call - put).max())
    np.testing.assert_allclose(np.asarray(got.put), put, rtol=1e-5, atol=1e-5 * put_scale)
    np.testing.assert_allclose(np.asarray(got.call), call, rtol=1e-5, atol=1e-5 * call_scale)


def _contracts(n: int = 7) -> np.ndarray:
    gen = np.random.default_rng(3)
    lo = np.array([b[0] for b in BOUNDS.values()])
    hi = np.array([b[1] for b in BOUNDS.values()])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


@pytest.fixture(scope="module")
def port_trained():
    """A port ``"xla"`` TERMINAL pricer after 2 steps, and its bytes."""
    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("port")
    pricer.train(ttr.build_training_config(**RESUME).expect("cfg")).expect("train")
    data, digest = tconv.serialize_checkpoint(pricer.snapshot())
    return pricer, data, digest


def test_port_snapshot_carries_torch_env_only(port_trained) -> None:
    pricer, data, digest = port_trained
    cfg = _ok(tconv.deserialize_checkpoint(data, expected_hash=digest))
    assert cfg.provenance.jax_env is None
    assert cfg.provenance.torch_env == TorchEnv(
        torch_version=torch.__version__, cuda_version=torch.version.cuda or "",
        device_kind="cpu", python_version=cfg.provenance.torch_env.python_version)
    proto = ttensors.ModelCheckpointProto()
    proto.ParseFromString(data)
    assert proto.HasField("torch_env") and not proto.HasField("env")
    assert tconv.serialize_checkpoint(cfg) == (data, digest)  # passes through


def test_port_checkpoint_predicts_and_resumes_in_jax(port_trained) -> None:
    """Done-condition 1 on the ``"xla"`` (threefry) engine."""
    pricer, data, _ = port_trained
    jcfg = jconv.deserialize_checkpoint(data).expect("jax decodes the port's bytes")
    jpricer = jtr.GbmCVNNPricer.create(jcfg).expect("jax create")
    contracts = _contracts()
    _assert_prices_close(jpricer.predict_price(contracts), pricer.predict_price(contracts))
    np.testing.assert_allclose(_jax_resume(jcfg), _resume(pricer.snapshot()), rtol=1e-4)


def test_port_checkpoint_bytes_equal_jax_reencode_but_provenance(port_trained) -> None:
    """The JAX package re-encodes the port's bytes with its own ``env``
    stamp; every other byte is the port's."""
    _, data, _ = port_trained
    jax_bytes, _ = jconv.serialize_checkpoint(jconv.deserialize_checkpoint(data).expect("jax"))
    jproto = jtensors.ModelCheckpointProto()
    jproto.ParseFromString(jax_bytes)
    env = JaxEnv(jax_version=jproto.env.jax_version, backend=jproto.env.backend,
                 device_kind=jproto.env.device_kind, python_version=jproto.env.python_version)
    cfg = _ok(tconv.deserialize_checkpoint(data))
    stamped = dataclasses.replace(cfg, provenance=Provenance(jax_env=env))
    assert tconv.serialize_checkpoint(stamped)[0] == jax_bytes
    assert _ok(tconv.deserialize_checkpoint(jax_bytes)).provenance == Provenance(jax_env=env)


def test_jax_refuses_a_port_cuda_checkpoint() -> None:
    """The JAX package has no Philox stream: a ``"cuda"`` checkpoint is a
    ``DecodeError`` on ``sim_params`` there, and keeps its stream version
    through the port's own bytes."""
    pricer = ttr.GbmCVNNPricer.create(_port_config("cuda"), device="cpu").expect("cuda")
    data, digest = tconv.serialize_checkpoint(pricer.snapshot())
    err = jconv.deserialize_checkpoint(data)
    assert isinstance(err, JaxFailure)
    assert isinstance(err.error, JaxDecodeError) and err.error.what == "sim_params"
    cfg = _ok(tconv.deserialize_checkpoint(data, expected_hash=digest))
    assert cfg.sim.implementation == tgbm.SimImplementation.CUDA
    assert cfg.cuda_stream_version == gbm_cuda.cuda_stream_version(
        tgbm.ModelKind.GBM, tgbm.PayoffKind.TERMINAL) > 0


def test_port_cuda_checkpoint_resumes_bit_exactly_from_bytes() -> None:
    """On the CPU the ``"cuda"`` engine runs its twins: resuming from the
    bytes equals resuming from the snapshot, and a stream version one lower
    is refused mid-stream."""
    pricer = ttr.GbmCVNNPricer.create(_port_config("cuda"), device="cpu").expect("cuda")
    pricer.train(ttr.build_training_config(**{**RESUME, "num_batches": 1}).expect("c"))
    snap = pricer.snapshot()
    data, digest = tconv.serialize_checkpoint(snap)
    cfg = _ok(tconv.deserialize_checkpoint(data, expected_hash=digest))
    assert (cfg.cuda_stream_version, cfg.global_step) == (snap.cuda_stream_version, 1)
    np.testing.assert_array_equal(_resume(cfg), _resume(snap))
    older, _ = tconv.serialize_checkpoint(
        dataclasses.replace(cfg, cuda_stream_version=cfg.cuda_stream_version - 1))
    refused = ttr.GbmCVNNPricer.create(_ok(tconv.deserialize_checkpoint(older)), device="cpu")
    assert type(_err(refused)).__name__ == "EngineMismatch"


@pytest.mark.parametrize("backward", [0, 1, 2, 3, 4])
def test_versions_round_trip_and_the_trainer_refuses(port_trained, backward: int) -> None:
    """The decoder keeps ``lsmc_backward_version`` and ``cuda_stream_version``
    as written; ``create`` refuses what cannot continue (the JAX package's
    TPU backwards 1 and 2, and ``"pallas"``), the decoder does not."""
    pricer, _, _ = port_trained
    snap = dataclasses.replace(pricer.snapshot(), lsmc_backward_version=backward,
                               cuda_stream_version=7)
    cfg = _ok(tconv.deserialize_checkpoint(tconv.serialize_checkpoint(snap)[0]))
    assert (cfg.lsmc_backward_version, cfg.cuda_stream_version) == (backward, 7)
    if backward in (1, 2):
        refused = _err(ttr.GbmCVNNPricer.create(cfg, device="cpu"))
        assert type(refused).__name__ == "EngineMismatch"
    pallas = dataclasses.replace(cfg, sim=cfg.sim.model_copy(
        update={"implementation": tgbm.SimImplementation.PALLAS}))
    decoded = _ok(tconv.deserialize_checkpoint(tconv.serialize_checkpoint(pallas)[0]))
    assert decoded.sim.implementation == tgbm.SimImplementation.PALLAS
    assert type(_err(ttr.GbmCVNNPricer.create(decoded, device="cpu"))).__name__ == (
        "EngineMismatch")


def _jax_config() -> jtr.GbmCVNNPricerConfig:
    sim = jgbm.build_simulation_params(**SIM).expect("sim")
    bounds = {k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    return jtr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_slice_cvnn(jf),
                                   normalize_inputs=True)


def test_fresh_jax_checkpoint_predicts_and_resumes_in_port() -> None:
    """Done-condition 2 beyond the corpus: a JAX pricer trained here."""
    jpricer = jtr.GbmCVNNPricer.create(_jax_config()).expect("jax")
    jpricer.train(jtr.build_training_config(**RESUME).expect("cfg")).expect("jax train")
    data, digest = jconv.serialize_checkpoint(jpricer.snapshot())
    cfg = _ok(tconv.deserialize_checkpoint(data, expected_hash=digest))
    assert cfg.provenance.jax_env is not None and cfg.provenance.torch_env is None
    assert tconv.serialize_checkpoint(cfg) == (data, digest)
    pricer = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("port")
    contracts = _contracts()
    _assert_prices_close(pricer.predict_price(contracts), jpricer.predict_price(contracts))
    np.testing.assert_allclose(_resume(cfg), _jax_resume(jpricer.snapshot()), rtol=1e-4)


# --------------------------------------------------------------------------
# Decode failures are results
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", TENSOR_DTYPES)
def test_every_checkpoint_dtype_roundtrips(dtype) -> None:
    arr = np.array([[1, 0], [0, 1]]).astype(dtype)
    back = _ok(tconv.tensor_from_proto(tconv.tensor_to_proto(arr)))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_zero_dim_and_empty_tensors() -> None:
    back = _ok(tconv.tensor_from_proto(tconv.tensor_to_proto(np.float32(3.5))))
    assert back.shape == () and float(back) == 3.5
    back = _ok(tconv.tensor_from_proto(tconv.tensor_to_proto(np.zeros((0, 4), np.float32))))
    assert back.shape == (0, 4)


def _tensor(**overrides) -> ttensors.TensorProto:
    proto = tconv.tensor_to_proto(np.arange(12, dtype=np.float32))
    for name, value in overrides.items():
        if name == "shape":
            del proto.shape[:]
            proto.shape.extend(value)
        else:
            setattr(proto, name, value)
    return proto


@pytest.mark.parametrize("case", ["truncated", "padded", "wrong_shape", "unknown_dtype",
                                  "object_dtype", "bfloat16"])
def test_bad_tensor_payload_is_a_decode_error(case: str) -> None:
    data = np.arange(12, dtype=np.float32).tobytes()
    proto = {
        "truncated": lambda: _tensor(data=data[:-4]),
        "padded": lambda: _tensor(data=data + b"\x00" * 4),
        "wrong_shape": lambda: _tensor(shape=[5, 3]),
        "unknown_dtype": lambda: _tensor(dtype="quaternion128"),
        "object_dtype": lambda: _tensor(dtype="object"),
        # 12 two-byte bfloat16 elements take 24 bytes, not the float32 array's 48
        "bfloat16": lambda: _tensor(dtype="bfloat16"),
    }[case]()
    err = _err(tconv.tensor_from_proto(proto))
    assert isinstance(err, DecodeError) and err.what == "tensor"
    if case in ("truncated", "padded", "bfloat16"):
        assert "bytes" in err.reason
    if case == "unknown_dtype":
        assert repr(proto.dtype) in err.reason
    if case == "bfloat16":  # sized as bfloat16, so its right-sized payload decodes
        assert "bfloat16" in err.reason
        back = _ok(tconv.tensor_from_proto(_tensor(dtype="bfloat16", data=data[:24])))
        assert back.dtype == torch.bfloat16 and tuple(back.shape) == (12,)


def test_tensor_map_failure_names_offending_key() -> None:
    proto = tconv.tensor_map_to_proto({"good": np.zeros(2, np.float32),
                                       "bad": np.zeros(2, np.float32)})
    proto.entries["bad"].data = b"\x00"
    assert "bad" in _err(tconv.tensor_map_from_proto(proto)).what


def test_decoded_tensor_owns_its_memory() -> None:
    back = _ok(tconv.tensor_from_proto(tconv.tensor_to_proto(np.arange(4, dtype=np.float32))))
    back[0] = 99.0  # a frombuffer view would be read-only
    assert back[0] == 99.0


def test_checkpoint_bitflip_fails_checksum(port_trained) -> None:
    _, data, digest = port_trained
    tampered = bytes([data[0] ^ 0xFF]) + data[1:]
    assert isinstance(_err(tconv.deserialize_checkpoint(tampered, expected_hash=digest)),
                      ChecksumMismatch)


def test_checkpoint_truncation_and_garbage_fail_decode(port_trained) -> None:
    _, data, _ = port_trained
    assert isinstance(tconv.deserialize_checkpoint(data[: len(data) // 2]), Failure)
    assert isinstance(tconv.deserialize_checkpoint(b"\xde\xad\xbe\xef" * 64), Failure)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.data())
def test_flipped_checkpoint_bytes_never_raise(data) -> None:
    """A byte of a real checkpoint xored at random decodes to a Success or a
    Failure, never an exception."""
    blob = (FIXTURES / "gbm_terminal.pb").read_bytes()
    at = data.draw(st.integers(0, len(blob) - 1))
    flip = data.draw(st.integers(1, 255))
    result = tconv.deserialize_checkpoint(blob[:at] + bytes([blob[at] ^ flip]) + blob[at + 1:])
    assert isinstance(result, (Success, Failure))


def test_wrong_shape_model_state_fails_reload(port_trained) -> None:
    pricer, _, _ = port_trained
    snap = pricer.snapshot()
    state = dict(snap.model_state)
    key = next(k for k in state if state[k].ndim >= 1)
    state[key] = np.zeros((3, 3), dtype=np.float32)
    data, _ = tconv.serialize_checkpoint(dataclasses.replace(snap, model_state=state))
    cfg = _ok(tconv.deserialize_checkpoint(data))
    assert isinstance(_err(ttr.GbmCVNNPricer.create(cfg, device="cpu")), CheckpointMismatch)


def test_unsupported_adam_schema_version_is_a_decode_error(port_trained) -> None:
    _, data, _ = port_trained
    proto = ttensors.ModelCheckpointProto()
    proto.ParseFromString(data)
    proto.adam_state.schema_version = 2
    err = _err(tconv.deserialize_checkpoint(_wire(proto)))
    assert isinstance(err, DecodeError) and err.what == "adam_state"


def test_legacy_optimizer_state_migrates_on_read(port_trained) -> None:
    """Field 7 (the positional optax map) is read into the named schema;
    the port writes field 9 only, as the JAX package does."""
    _, data, _ = port_trained
    proto = ttensors.ModelCheckpointProto()
    proto.ParseFromString(data)
    snap = _ok(tconv.adam_state_from_proto(proto.adam_state))
    legacy = {"opt/0/.count": np.asarray(np.int32(snap.count)),
              **{f"opt/0/.mu/{k}": v for k, v in snap.mu.items()},
              **{f"opt/0/.nu/{k}": v for k, v in snap.nu.items()}}
    proto.ClearField("adam_state")
    proto.optimizer_state.CopyFrom(tconv.tensor_map_to_proto(legacy))
    cfg = _ok(tconv.deserialize_checkpoint(_wire(proto)))
    assert isinstance(cfg.optimizer_state, tadam.AdamStateSnapshot)
    assert cfg.optimizer_state.count == snap.count
    for key in snap.mu:
        np.testing.assert_array_equal(cfg.optimizer_state.mu[key], snap.mu[key])
    written = ttensors.ModelCheckpointProto()
    written.ParseFromString(tconv.serialize_checkpoint(cfg)[0])
    assert written.HasField("adam_state") and not written.HasField("optimizer_state")
    assert tconv.serialize_checkpoint(cfg)[0] == data
    proto.optimizer_state.entries["opt/0/.count"].CopyFrom(
        tconv.tensor_to_proto(np.zeros(3, np.int32)))  # a count that is no scalar
    err = _err(tconv.deserialize_checkpoint(_wire(proto)))
    assert err.what == "optimizer_state(legacy)"
