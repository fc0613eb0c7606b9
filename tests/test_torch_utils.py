"""The port's utilities against the JAX package's: FLOP accounting, the
TensorBoard sinks, profiling, and the reduced-precision storage types.

Tiers (all exact):

* ``utils/flops.py``: the JAX package's hand counts (``tests/test_flops.py``)
  and, for the same ``CVNNConfig``, the JAX package's count — the port counts
  its ``ComplexLinear`` modules, the JAX package its 2-D parameter leaves;
* ``utils/tensorboard_writer.py``: ``tests/test_tensorboard.py``'s cases with
  its recording fake writer, on the port's store and checkpoints;
* bfloat16: the port decodes the JAX package's bytes to a ``torch.bfloat16``
  tensor whose float32 widening equals the JAX decode, and encodes it back
  to the same bytes.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.serialization import converters as jconv
from spectralmc_tpu.utils import flops as jflops
from spectralmc_tpu_torch.core.precision import Precision, ReducedPrecision
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.models.cvnn import ComplexLinear, ComplexSequential
from spectralmc_tpu_torch.serialization import compute_sha256
from spectralmc_tpu_torch.serialization import converters as tconv
from spectralmc_tpu_torch.storage import AsyncBlockchainModelStore, FileSystemObjectStore
from spectralmc_tpu_torch.storage.checkpoint import commit_snapshot
from spectralmc_tpu_torch.training import trainer as ttr
from spectralmc_tpu_torch.training.trainer import SegmentMetrics, StepMetrics
from spectralmc_tpu_torch.utils import profile_trace, span
from spectralmc_tpu_torch.utils import tensorboard_writer as tbw
from spectralmc_tpu_torch.utils.flops import (
    H100_SXM_PEAK_FP32_FLOPS,
    fft_flops,
    matmul_forward_flops,
    mfu,
    sim_path_steps,
    train_step_matmul_flops,
)

# --------------------------------------------------------------------------
# utils/flops.py
# --------------------------------------------------------------------------


def _linear(d_in: int, d_out: int, bias: bool = True) -> ComplexLinear:
    return ComplexLinear(d_in, d_out, bias=bias)


def test_forward_flops_hand_count() -> None:
    # one ComplexLinear (3 -> 4) at B = 2: 2 weights x 4*2*3*4 = 192 (= 8*B*in*out)
    assert matmul_forward_flops(_linear(3, 4), batch_size=2) == 192


def test_train_step_is_three_times_forward() -> None:
    assert train_step_matmul_flops(_linear(3, 4), batch_size=2) == 3 * 192


def test_nested_modules_and_biases() -> None:
    # biases are not matmuls; a nested 4 -> 2 layer adds its two weights,
    # 4*2*4*2 = 64 each
    tree = ComplexSequential((_linear(3, 4), ComplexSequential((_linear(4, 2, bias=False),))))
    assert matmul_forward_flops(tree, batch_size=2) == 192 + 2 * 64


def test_fft_flops_convention() -> None:
    assert fft_flops(4, 8) == 480  # 5*N*log2(N) per contract


def test_sim_path_steps() -> None:
    assert sim_path_steps(2, 3, 5, 7) == 2 * 3 * 5 * 7


def test_mfu_is_against_the_h100_float32_peak() -> None:
    assert H100_SXM_PEAK_FP32_FLOPS == 67e12
    tflops, frac = mfu(1e9, 1000.0)  # 1 GFLOP a step at 1000 steps/s = 1 TFLOP/s
    assert abs(tflops - 1.0) < 1e-12
    assert abs(frac - 1e12 / H100_SXM_PEAK_FP32_FLOPS) < 1e-15
    assert mfu(1e9, 1000.0, peak_flops=2e12)[1] == 0.5


def _head(mod, width: int):
    """The production head's shape (a projecting residual, in != out)."""
    return mod.build_cvnn_config(
        layers=[
            mod.LinearCfg(width=width, activation=mod.Activation.MODRELU),
            mod.CovBNCfg(),
            mod.ResidualCfg(body=mod.SequentialCfg(layers=(
                mod.LinearCfg(width=width + 4, activation=mod.Activation.ZRELU),
                mod.LinearCfg(width=width + 4),
            )), activation=mod.Activation.MODRELU),
            mod.NaiveBNCfg(),
            mod.LinearCfg(width=24, bias=False),
        ],
        seed=11,
    ).expect("cvnn")


@pytest.mark.parametrize("width,inputs,network,batch", [(8, 6, 16, 4), (256, 10, 512, 512)])
def test_flop_counts_equal_the_jax_package(width: int, inputs: int, network: int,
                                           batch: int) -> None:
    jmodel = jf.build_model(_head(jf, width), input_dim=inputs,
                            output_dim=network).expect("jax model")
    tmodel = tf.build_model(_head(tf, width), input_dim=inputs,
                            output_dim=network).expect("port model")
    params, _ = jmodel.init()
    assert matmul_forward_flops(tmodel, batch) == jflops.matmul_forward_flops(params, batch)
    assert train_step_matmul_flops(tmodel, batch) == jflops.train_step_matmul_flops(params, batch)
    assert fft_flops(batch, network) == jflops.fft_flops(batch, network)


# --------------------------------------------------------------------------
# utils/tensorboard_writer.py (tests/test_tensorboard.py's fake writer)
# --------------------------------------------------------------------------


class FakeWriter:
    def __init__(self) -> None:
        self.scalars: list[tuple[str, float, int]] = []
        self.texts: list[tuple[str, int]] = []
        self.hists: list[tuple[str, int]] = []
        self.flushes = 0
        self.closed = False

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars.append((tag, float(value), int(step)))

    def add_text(self, tag: str, text: str, step: int) -> None:
        self.texts.append((tag, step))

    def add_histogram(self, tag: str, values: object, step: int) -> None:
        self.hists.append((tag, step))

    def flush(self) -> None:
        self.flushes += 1

    def close(self) -> None:
        self.closed = True


@pytest.fixture
def fake(monkeypatch: pytest.MonkeyPatch) -> FakeWriter:
    writer = FakeWriter()
    monkeypatch.setattr(tbw, "_make_writer", lambda logdir: writer)
    return writer


def test_step_logger_scalars_and_flush(fake: FakeWriter) -> None:
    logger = tbw.TensorBoardLogger("unused", flush_every=2)
    for step in range(1, 5):
        logger(StepMetrics(step=step, loss=1.0 / step, grad_norm=0.5, learning_rate=1e-3))
    logger.close()
    assert {"train/loss", "train/grad_norm", "train/learning_rate"} <= {t for t, _, _ in
                                                                        fake.scalars}
    assert fake.flushes >= 2 and fake.closed


def test_segment_logger_matches_per_step_scalars(monkeypatch: pytest.MonkeyPatch) -> None:
    seg, per_step = FakeWriter(), FakeWriter()
    monkeypatch.setattr(tbw, "_make_writer", lambda logdir: seg)
    seg_logger = tbw.TensorBoardLogger("unused", flush_every=2)
    monkeypatch.setattr(tbw, "_make_writer", lambda logdir: per_step)
    step_logger = tbw.TensorBoardLogger("unused", flush_every=2)
    losses = np.array([3.0, 2.0, 1.5], dtype=np.float32)
    gnorms = np.array([0.3, 0.2, 0.1], dtype=np.float32)
    seg_logger.log_segment(SegmentMetrics(start_step=5, losses=losses, grad_norms=gnorms,
                                          learning_rate=1e-3))
    for i in range(3):
        step_logger(StepMetrics(step=5 + i, loss=float(losses[i]), grad_norm=float(gnorms[i]),
                                learning_rate=1e-3))
    assert seg.scalars == per_step.scalars and seg.flushes >= 1


def test_segment_logger_histogram_cadence(fake: FakeWriter) -> None:
    logger = tbw.TensorBoardLogger("unused", hist_every=10,
                                   param_source=lambda: {"w": np.zeros(2)})
    logger.log_segment(SegmentMetrics(1, np.ones(5), np.ones(5), 1e-3))
    assert fake.hists == []
    logger.log_segment(SegmentMetrics(6, np.ones(7), np.ones(7), 1e-3))
    assert fake.hists == [("w", 10)]
    logger.log_segment(SegmentMetrics(13, np.ones(19), np.ones(19), 1e-3))
    assert fake.hists == [("w", 10), ("w", 20), ("w", 30)]


def test_loggers_plug_into_the_trainers_callbacks(fake: FakeWriter) -> None:
    from tests.test_torch_train_loop import _jax_config_as_snapshot, _port

    pricer = _port(_jax_config_as_snapshot())
    logger = tbw.TensorBoardLogger("unused", flush_every=1)
    pricer.set_segment_callback(logger.log_segment)
    result = pricer.train(
        ttr.build_training_config(num_batches=3, batch_size=4, learning_rate=1e-3).expect("c"),
        commit_plan=ttr.IntervalCommit(interval=2), commit_fn=lambda s, m: None,
    ).expect("train")
    losses = [(v, s) for t, v, s in fake.scalars if t == "train/loss"]
    assert [s for _, s in losses] == [1, 2, 3]
    np.testing.assert_array_equal([v for v, _ in losses], result.losses.astype(np.float64))


def test_chain_history_writer(fake: FakeWriter, tmp_path) -> None:
    from tests.test_torch_train_loop import _jax_config_as_snapshot, _port

    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(tmp_path), "tb"))
    pricer = _port(_jax_config_as_snapshot())
    cfg = ttr.build_training_config(num_batches=1, batch_size=4, learning_rate=1e-3).expect("c")

    async def fill() -> None:
        for message in ("one", "two"):
            pricer.train(cfg).expect("train")
            (await commit_snapshot(store, pricer.snapshot(), message)).expect("commit")

    asyncio.run(fill())
    count = asyncio.run(tbw.log_chain_to_tensorboard(store, "unused")).expect("log")
    assert count == 2
    tags = {t for t, _, _ in fake.scalars}
    assert {"chain/global_step", "chain/param_count", "chain/versions_per_day"} <= tags
    assert [v for t, v, _ in fake.scalars if t == "chain/global_step"] == [1.0, 2.0]
    assert len(fake.texts) == 2 and fake.closed


def test_chain_writer_tolerates_non_checkpoint_payloads(fake: FakeWriter, tmp_path) -> None:
    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(tmp_path), "tb2"))
    payload = b"not a protobuf checkpoint"
    asyncio.run(store.commit(payload, compute_sha256(payload), "raw")).expect("commit")
    assert asyncio.run(tbw.log_chain_to_tensorboard(store, "unused")).expect("log") == 0
    assert len(fake.texts) == 1


# --------------------------------------------------------------------------
# utils/profiling.py
# --------------------------------------------------------------------------


def test_profile_trace_writes_a_chrome_trace(tmp_path) -> None:
    with profile_trace(str(tmp_path), device="cpu"):
        with torch.profiler.record_function("probe"):
            torch.ones(8).sum()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert any(e.get("name") == "probe" for e in json.loads(trace.read_text())["traceEvents"])


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch) -> None:
    def refuse(name: str) -> None:
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = span("spectralmc.step"), span("spectralmc.serve")
    assert first is second
    with first:
        with second:
            torch.ones(2).sum()


COLLECTIVE_SPANS = """
import json, sys
import torch
import torch.distributed as dist
from spectralmc_tpu_torch.ops.collectives import pmean, pmean_many, psum
from spectralmc_tpu_torch.utils import profile_trace

dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "/rdv", rank=0,
                        world_size=1)
try:
    with profile_trace(sys.argv[1], device="cpu"):
        psum(torch.ones(3), dist.group.WORLD)
        pmean(torch.ones(3, dtype=torch.complex64), dist.group.WORLD)
        pmean_many([torch.ones(2), torch.zeros(3)], dist.group.WORLD)
finally:
    dist.destroy_process_group()
"""


def test_one_collective_span_an_all_reduce(tmp_path) -> None:
    """``psum``, ``pmean`` and ``pmean_many`` (one all-reduce each) on a
    one-rank ``gloo`` group, in a process of its own."""
    subprocess.run([sys.executable, "-c", COLLECTIVE_SPANS, str(tmp_path)], check=True,
                   timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "spectralmc.collective" for e in events) == 3


def test_span_records_a_range_while_profiled(tmp_path) -> None:
    with profile_trace(str(tmp_path), device="cpu"):
        assert span("spectralmc.step") is not span("spectralmc.step")
        with span("spectralmc.step"):
            torch.ones(8).sum()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert [e.get("cat") for e in events if e.get("name") == "spectralmc.step"] == [
        "user_annotation"]
    assert span("spectralmc.step") is span("spectralmc.serve")  # off again


# --------------------------------------------------------------------------
# core/precision.py: the reduced-precision storage types
# --------------------------------------------------------------------------


def test_reduced_precision_names_and_dtypes() -> None:
    assert [p.value for p in ReducedPrecision] == ["bfloat16", "float16"]
    assert ReducedPrecision.bfloat16.to_torch() == torch.bfloat16
    assert ReducedPrecision.float16.to_torch() == torch.float16
    assert {p.value for p in ReducedPrecision}.isdisjoint(p.value for p in Precision)


def _bf16_values() -> np.ndarray:
    """Normals, zeros of both signs, infinities, NaN, the extremes and a
    subnormal, as float32, rounded to bfloat16 by the JAX package's type."""
    import ml_dtypes

    gen = np.random.default_rng(5)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.3895e38, -1.1755e-38, 9.2e-41,
                         1.0, -2.5], dtype=np.float32)
    values = np.concatenate([specials, (gen.standard_normal(54) * 100).astype(np.float32)])
    return values.reshape(8, 8).astype(ml_dtypes.bfloat16)


def test_bfloat16_decodes_widens_and_reencodes_to_its_bytes() -> None:
    jax_bytes = jconv.tensor_to_proto(_bf16_values()).SerializeToString()
    proto = tconv.tensors_pb2.TensorProto.FromString(jax_bytes)
    port = tconv.tensor_from_proto(proto).expect("bfloat16 decode")
    assert isinstance(port, torch.Tensor) and port.dtype == torch.bfloat16
    assert tuple(port.shape) == (8, 8)
    want = np.asarray(jconv.tensor_from_proto(proto).expect("jax decode"), dtype=np.float32)
    got = port.float().numpy()
    assert want.view(np.uint32).tolist() == got.view(np.uint32).tolist()  # NaN and -0 too
    assert tconv.tensor_to_proto(port).SerializeToString() == jax_bytes


def test_bfloat16_in_a_tensor_map_and_zero_dim() -> None:
    flat = {"a": torch.tensor(1.5, dtype=torch.bfloat16),
            "b": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "c": np.ones(2, np.float32)}
    back = tconv.tensor_map_from_proto(tconv.tensor_map_to_proto(flat)).expect("map")
    assert back["a"].shape == () and float(back["a"]) == 1.5
    assert torch.equal(back["b"], flat["b"]) and back["c"].dtype == np.float32
    jax_back = jconv.tensor_map_from_proto(
        jconv.tensors_pb2.TensorMapProto.FromString(
            tconv.tensor_map_to_proto(flat).SerializeToString())).expect("jax map")
    np.testing.assert_array_equal(np.asarray(jax_back["b"], dtype=np.float32),
                                  flat["b"].float().numpy())
