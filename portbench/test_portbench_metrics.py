"""CPU tests of each metric's arithmetic on small synthetic traces, and of
the counts against the smoke script's bounds at the launched shapes."""

from __future__ import annotations

import math
from pathlib import Path

import pytest

from portbench import core, tracing, tinycell
from portbench.counts import flops, kernels

ROOT = tinycell.ROOT


def _x(cat: str, name: str, ts: float, dur: float) -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# two calls from t = 0 to 1,000 µs; kernels (in µs) 100–300 and 250–400
# (overlapping), 600–700; a memcpy 900–950; a kernel before the window
EVENTS = [
    _x("user_annotation", tracing.CALL_RANGE, 0, 500),
    _x("user_annotation", tracing.CALL_RANGE, 500, 500),
    _x("kernel", "void gbm_paths_kernel<0, 0, false>(...)", 100, 200),
    _x("kernel", "volta_sgemm_128x64_nn", 250, 150),
    _x("kernel", "void gbm_paths_kernel<0, 0, false>(...)", 600, 100),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900, 50),
    _x("kernel", "early", -300, 100),
    _x("cpu_op", "aten::mm", 0, 90),
    _x("cpu_op", "aten::copy_", 700, 250),
    _x("cpu_op", "aten::to", 720, 30),
]


@pytest.fixture(scope="module")
def reading() -> tracing.TraceReading:
    return tracing.reduce_events(EVENTS, calls=2, steps=8)


def test_reduce_events(reading: tracing.TraceReading) -> None:
    assert reading.window_s == pytest.approx(1e-3)
    assert reading.busy_s == pytest.approx((300 + 100 + 50) * 1e-6)
    assert [k[0] for k in reading.kernels].count("void gbm_paths_kernel<0, 0, false>(...)") == 2
    assert len(reading.kernels) == 3
    # gaps: 0–100 (aten::mm), 400–600 (no operation), 700–900 (aten::copy_; aten::to
    # covers 720–750 only), 950–1000 (aten::copy_ ends at 950: none)
    assert reading.idle_by_host["aten::mm"] == pytest.approx(100e-6)
    assert reading.idle_by_host["aten::copy_"] == pytest.approx(200e-6)
    assert reading.idle_by_host["python (no traced operation)"] == pytest.approx(250e-6)
    top = reading.breakdown()
    assert top["device_ops"][0][0] == "void gbm_paths_kernel<0, 0, false>(...)"
    assert top["device_ops"][0][1] == pytest.approx(300e-6)


class _Outcome:
    def __init__(self, trace: tracing.TraceReading, **measures: object) -> None:
        self.trace, self.measures = trace, measures


class _Ctx:
    def __init__(self, cell: str, trace: bool, root: Path = ROOT) -> None:
        self.cell, self.trace = core.load_cell(root, cell), trace


def _read(name: str, outcome: object, ctx: object) -> float | None:
    return core.metric_reader(ROOT, name).read(outcome, ctx)


def test_train_metrics(reading: tracing.TraceReading) -> None:
    ctx = _Ctx("terminal_train_8k", True)
    out = _Outcome(reading)
    assert _read("device_idle_pct.train", out, ctx) == pytest.approx(55.0)
    assert _read("launches_per_step.train", out, ctx) == pytest.approx(3 / 8)
    bound_ms = kernels.gbm_paths_bound_ms("terminal", 256, 2048, 512, 16)[0]
    assert _read("roofline_pct.gbm_paths", out, ctx) == pytest.approx(100 * bound_ms / 0.15)
    least = flops.step_least_seconds(ctx.cell.config)
    assert _read("step_mfu_pct.train", out, ctx) == pytest.approx(100 * least / (1e-3 / 8))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory: pytest.TempPathFactory) -> Path:
    return tinycell.make_root(tmp_path_factory.mktemp("metrics"))


def test_american_and_mesh_metrics(tiny_root: Path) -> None:
    events = EVENTS[:2] + [
        _x("kernel", "(anonymous namespace)::american_gbm_kernel(float const*, ...)", 0, 100),
        _x("kernel", "void lsmc::backward_kernel<5, false, true>(lsmc::Args)", 100, 300),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, ...)", 400, 40)]
    out = _Outcome(tracing.reduce_events(events, calls=2, steps=4))
    american = _Ctx("american_put_train_8k", True)
    bound = kernels.american_gbm_bound_ms(256, 2048, 512, 16, 1)[0]
    assert _read("roofline_pct.american_gbm", out, american) == pytest.approx(100 * bound / 0.1)
    bound = kernels.lsmc_backward_bound_ms(256, 2048, 512, 16, 5)[0]
    assert _read("roofline_pct.lsmc_backward", out, american) == pytest.approx(100 * bound / 0.3)
    mesh = _Ctx(tinycell.TINY["sharded"], True, tiny_root)
    assert core.metric_reader(tiny_root, "allreduce_ms_per_step").read(out, mesh) == (
        pytest.approx(40e-3 / 4))
    least = flops.step_least_seconds(mesh.cell.config) / 4  # rank 0's share of the step
    assert _read("step_mfu_pct.train", out, mesh) == pytest.approx(100 * least / (1e-3 / 4))


def test_serve_metrics(reading: tracing.TraceReading) -> None:
    ctx = _Ctx("terminal_serve_book", True)
    out = _Outcome(reading, padded_rows=[65536, 65536, 65536])
    assert _read("device_idle_pct.serve", out, ctx) == pytest.approx(55.0)
    call = flops.serve_call_flops(ctx.cell.config, 65536)
    assert _read("serve_mfu_pct", out, ctx) == pytest.approx(100 * 2 * call / 1e-3 / 67e12)


def test_silent_without_events() -> None:
    empty = tracing.reduce_events(EVENTS[:2], calls=2, steps=8)
    for cell, names in (("terminal_train_8k", ("device_idle_pct.train", "step_mfu_pct.train",
                                               "launches_per_step.train",
                                               "roofline_pct.gbm_paths")),
                        ("terminal_serve_book", ("device_idle_pct.serve", "serve_mfu_pct"))):
        for name in names:
            assert _read(name, _Outcome(empty, padded_rows=[1, 1]), _Ctx(cell, True)) is None


def test_end_to_end_metrics() -> None:
    train = _Ctx("terminal_train_8k", False)
    assert _read("train_contracts_per_s", _Outcome(None, contracts=8192 * 40, window_s=20.0),
                 train) == pytest.approx(16384.0)
    assert _read("setup_s", _Outcome(None, setup_s=12.5), train) == 12.5
    serve = _Ctx("terminal_serve_book", False)
    assert _read("serve_contracts_per_s", _Outcome(None, contracts=40000 * 300, window_s=30.0),
                 serve) == pytest.approx(400000.0)


def test_cvnn_flops_follow_the_conventions() -> None:
    config = core.load_cell(ROOT, "terminal_train_8k").config
    shapes = flops.complex_linear_shapes(config["cvnn"]["layers"], 6, 512)
    assert shapes == [(6, 256), (256, 256), (256, 256), (256, 512)]
    assert flops.train_matmul_flops(shapes, 8192) == 3 * 8 * 8192 * (6 * 256 + 2 * 256 * 256
                                                                     + 256 * 512)
    assert flops.fft_flops(8192, 512) == 8192 * 5 * 512 * 9


@pytest.mark.parametrize("name, got, want", [
    ("#1 gbm_paths TERMINAL", lambda: kernels.gbm_paths_bound_ms("terminal", 256, 2048, 512, 16),
     (1.867, "operations")),
    ("#4 american_gbm", lambda: kernels.american_gbm_bound_ms(256, 2048, 512, 16, 1),
     (5.128, "bytes")),
    ("#11 lsmc_backward", lambda: kernels.lsmc_backward_bound_ms(256, 2048, 512, 16),
     (5.449, "bytes")),
])
def test_counts_match_the_smoke_bounds(name: str, got, want: tuple[float, str]) -> None:
    ms, by = got()
    assert (round(ms, 3), by) == want, name


def test_counts_equal_the_smoke_script_today() -> None:
    import chip_smoke

    assert kernels.gbm_paths_bound_ms("terminal", 256, 2048, 512, 16) == chip_smoke.bound_ms(
        "terminal", 256, 16)
    assert kernels.american_gbm_bound_ms(256, 2048, 512, 16, 1) == chip_smoke.american_bound_ms(
        256, 2048, 512, 16, 1)
    assert kernels.lsmc_backward_bound_ms(256, 2048, 512, 16) == chip_smoke.lsmc_bound_ms(
        256, 2048, 512, 16)
    assert math.isclose(flops.PEAK_FP32_FLOPS, chip_smoke.FP32_OPS_PER_S)
