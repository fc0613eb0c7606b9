"""CPU tests of ``spans.py`` on a small hand-written Chrome trace, of the
existing readings with the program's spans in the trace, and of the spans a
traced tiny cell shows.

    python -m pytest portbench -q -p no:cacheprovider
"""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import core, run, spans, tinycell, tracing
from portbench.test_portbench_metrics import EVENTS, _Ctx, _Outcome, _read, _x

SEED = 2**31 + 977


def _runtime(name: str, ts: float, dur: float, correlation: int, tid: int = 1) -> dict:
    return {**_x("cuda_runtime", name, ts, dur), "tid": tid,
            "args": {"correlation": correlation}}


def _device(cat: str, name: str, ts: float, dur: float, correlation: int) -> dict:
    return {**_x(cat, name, ts, dur), "tid": 7, "args": {"correlation": correlation}}


def _span(name: str, ts: float, dur: float) -> dict:
    return {**_x("user_annotation", name, ts, dur), "tid": 1}


def _op(name: str, ts: float, dur: float) -> dict:
    return {**_x("cpu_op", name, ts, dur), "tid": 1}


# one call, 0–1,000 µs: one segment of two steps; the first step's payoff
# span (20–60) launches a kernel that runs 300–400, after the span ended, and
# a copy to pageable memory that syncs (cudaStreamSynchronize 45–55 inside
# aten::item); its Adam span (100–200) launches a kernel running 420–460;
# the card idles 460–600, between two aten ops of the second step's CVNN
# span (500–700), where another thread, with no span of its own, launches
# the GEMM; the segment's fetch (800–900) syncs outside every step
SPANNED = [
    _span(tracing.CALL_RANGE, 0, 1000),
    _span("train_segment", 10, 980),
    _span("spectralmc.step", 15, 250),
    _span("spectralmc.step.payoff", 20, 40),
    _runtime("cudaLaunchKernel", 30, 5, 1),
    _op("aten::item", 40, 18),
    _op("aten::_local_scalar_dense", 41, 16),
    _runtime("cudaMemcpyAsync", 42, 2, 2),
    _runtime("cudaStreamSynchronize", 45, 10, 3),
    _span("spectralmc.step.adam", 100, 100),
    _runtime("cudaLaunchKernel", 110, 5, 4),
    _span("spectralmc.step", 300, 450),
    _span("spectralmc.step.cvnn_forward", 500, 200),
    _op("aten::mm", 510, 40),
    _op("aten::add", 650, 40),
    _runtime("cudaLaunchKernel", 660, 5, 5, tid=2),
    _span("spectralmc.train.fetch", 800, 100),
    _runtime("cudaStreamSynchronize", 810, 50, 6),
    _device("kernel", "void at::native::elementwise_kernel<put>(...)", 300, 100, 1),
    _device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 405, 5, 2),
    _device("kernel", "multi_tensor_apply_kernel<adam>", 420, 40, 4),
    _device("kernel", "volta_sgemm_128x64_nn", 600, 50, 5),
]


@pytest.fixture(scope="module")
def reading() -> spans.SpanReading:
    return spans.reduce_spans(SPANNED)


STEP = "train_segment/spectralmc.step"


def test_device_operations_go_to_the_span_that_launched_them(reading) -> None:
    # the put kernel runs 300–400, under the second step's span on the
    # host's clock, but was launched in the first step's payoff span
    assert reading.device_s[f"{STEP}/spectralmc.step.payoff"] == pytest.approx(105e-6)
    assert reading.launches[f"{STEP}/spectralmc.step.payoff"] == 1
    assert reading.device_s[f"{STEP}/spectralmc.step.adam"] == pytest.approx(40e-6)
    # launched from a thread that runs no span: the span running elsewhere
    assert reading.device_s[f"{STEP}/spectralmc.step.cvnn_forward"] == pytest.approx(50e-6)
    assert sum(reading.launches.values()) == 3  # kernels; the memcpy is no launch
    assert reading.busy_s == pytest.approx(195e-6)


def test_syncs_inside_steps_alone_count_per_step(reading) -> None:
    assert reading.syncs == {f"{STEP}/spectralmc.step.payoff": 1,
                             "train_segment/spectralmc.train.fetch": 1}
    assert reading.sync_sites == {
        f"{STEP}/spectralmc.step.payoff | aten::item > aten::_local_scalar_dense"
        " | cudaStreamSynchronize": 1,
        "train_segment/spectralmc.train.fetch |  | cudaStreamSynchronize": 1}
    assert spans.syncs_per_step(reading) == pytest.approx(0.5)
    # host time of the steps (250 + 450 µs) less what waited inside them: the
    # sync (10 µs) and the copy to pageable memory (2 µs)
    assert reading.wait_s[f"{STEP}/spectralmc.step.payoff"] == pytest.approx(12e-6)
    assert spans.host_enqueue_ms_per_step(reading) == pytest.approx((700 - 12) / 2 / 1e3)
    assert reading.runtime_s[f"{STEP}/spectralmc.step.payoff | cudaLaunchKernel"] == (
        pytest.approx(5e-6))


def test_a_launch_that_waits_for_the_queue_is_waiting() -> None:
    # the second launch holds the host 200 µs: the launch queue was full
    events = [_span(tracing.CALL_RANGE, 0, 1000), _span("spectralmc.step", 0, 900),
              _runtime("cudaLaunchKernel", 10, 5, 1), _runtime("cudaLaunchKernel", 20, 200, 2)]
    reading = spans.reduce_spans(events)
    assert reading.wait_s == {"spectralmc.step": pytest.approx(200e-6)}
    assert reading.syncs == {}
    assert spans.host_enqueue_ms_per_step(reading) == pytest.approx(0.7)


def test_idle_gaps_go_to_the_span_at_their_midpoint(reading) -> None:
    # gaps: 0–300 (midpoint 150: Adam), 400–405 and 410–420 (the second step),
    # 460–600 (530: the CVNN span, inside aten::mm, which the spans ignore),
    # 650–1000 (825: the fetch)
    assert reading.idle_s[f"{STEP}/spectralmc.step.adam"] == pytest.approx(300e-6)
    assert reading.idle_s[STEP] == pytest.approx(15e-6)
    assert reading.idle_s[f"{STEP}/spectralmc.step.cvnn_forward"] == pytest.approx(140e-6)
    assert reading.idle_s["train_segment/spectralmc.train.fetch"] == pytest.approx(350e-6)


def test_per_layer_numbers(reading) -> None:
    assert spans.spectrum_ms_per_step(reading) == pytest.approx(105e-3 / 2)
    assert spans.cvnn_ms_per_step(reading) == pytest.approx(50e-3 / 2)
    assert spans.adam_ms_per_step(reading) == pytest.approx(40e-3 / 2)
    assert spans.serve_host_ms_per_call(reading) is None
    assert reading.spans == {"train_segment": 1, STEP: 2, f"{STEP}/spectralmc.step.payoff": 1,
                             f"{STEP}/spectralmc.step.adam": 1,
                             f"{STEP}/spectralmc.step.cvnn_forward": 1,
                             "train_segment/spectralmc.train.fetch": 1}
    cover = spans.coverage(reading)
    assert cover["device_outside_pct"] == 0.0
    assert cover["idle_outside_pct"] == 0.0


def test_serve_host_time_leaves_out_what_waited() -> None:
    # two calls: the first waits in its forward's sync (10–20) and in its
    # fetch's copy to pageable memory (30–70); the second in its fetch alone
    events = [_span(tracing.CALL_RANGE, 0, 100), _span("spectralmc.serve", 0, 90),
              _span("spectralmc.serve.forward", 5, 20),
              _runtime("cudaStreamSynchronize", 10, 10, 1),
              _span("spectralmc.serve.fetch", 30, 50), _runtime("cudaMemcpyAsync", 30, 40, 2),
              _device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60, 10, 2),
              _span(tracing.CALL_RANGE, 100, 100), _span("spectralmc.serve", 100, 80),
              _span("spectralmc.serve.fetch", 120, 40), _runtime("cudaMemcpyAsync", 120, 30, 3),
              _device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 140, 10, 3)]
    assert spans.serve_host_ms_per_call(spans.reduce_spans(events)) == pytest.approx(
        (90 - 10 - 40 + 80 - 30) / 2 / 1e3)


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_silent_without_spans(name: str) -> None:
    bare = [e for e in SPANNED if not spans.is_program_span(e)]
    assert spans.METRICS[name](spans.reduce_spans(bare)) is None
    assert spans.METRICS[name](None) is None


def test_the_existing_readings_ignore_the_spans() -> None:
    """``reduce_events`` and the accepted readers give the same numbers with
    the program's spans in the trace as without; only the idle gaps' host
    names may change."""
    added = [_span("train_segment", 0, 1000), _span("spectralmc.step", 300, 400)]
    bare = tracing.reduce_events(EVENTS, calls=2, steps=8)
    spanned = tracing.reduce_events(EVENTS + added, calls=2, steps=8)
    for name in ("window_s", "busy_s", "kernels", "device_ops", "calls", "steps"):
        assert getattr(spanned, name) == getattr(bare, name), name
    assert sum(spanned.idle_by_host.values()) == pytest.approx(sum(bare.idle_by_host.values()))
    # the gaps that no host operation covered now name the span around them
    assert spanned.idle_by_host["spectralmc.step"] == pytest.approx(200e-6)
    assert spanned.idle_by_host["train_segment"] == pytest.approx(50e-6)
    assert "python (no traced operation)" not in spanned.idle_by_host
    for cell, names in (("terminal_train_8k", ("device_idle_pct.train", "step_mfu_pct.train",
                                               "launches_per_step.train",
                                               "roofline_pct.gbm_paths")),
                        ("terminal_serve_book", ("device_idle_pct.serve", "serve_mfu_pct"))):
        ctx = _Ctx(cell, True)
        for name in names:
            want = _read(name, _Outcome(bare, padded_rows=[65536] * 3), ctx)
            assert _read(name, _Outcome(spanned, padded_rows=[65536] * 3), ctx) == want, name


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory: pytest.TempPathFactory) -> Path:
    return tinycell.make_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("kind, per_unit", [
    ("train", {"spectralmc.step": 1, "spectralmc.step.sample": 1, "spectralmc.step.paths": 2,
               "spectralmc.step.payoff": 2, "spectralmc.step.fft": 2,
               "spectralmc.step.cvnn_forward": 1, "spectralmc.step.cvnn_backward": 1,
               "spectralmc.step.adam": 1}),
    ("serve", {"spectralmc.serve": 1, "spectralmc.serve.prepare": 1,
               "spectralmc.serve.forward": 1, "spectralmc.serve.fetch": 1,
               "spectralmc.serve.parity": 1}),
])
def test_a_traced_tiny_cell_shows_the_programs_spans(tiny_root: Path, kind: str,
                                                     per_unit: dict[str, int]) -> None:
    cell = tinycell.TINY[kind]
    with spans.kept_events() as kept:
        result, _ = run.run_cell(tiny_root, cell, SEED, 0.5, True, "cpu", 0.0)
    assert result["correct"] and len(kept) == 1
    reading = spans.reduce_spans(kept[0])
    traffic = core.load_cell(tiny_root, cell).traffic
    units = (traffic["trace_calls"] * traffic.get("batches_per_call", 1))
    for name, n in per_unit.items():
        assert spans.span_count(reading, name) == n * units, name
    numbers = spans.report(reading)
    assert numbers["count"] == units
    if kind == "train":
        assert spans.host_enqueue_ms_per_step(reading) > 0
        assert spans.syncs_per_step(reading) == 0  # no card, no runtime call
        assert spans.serve_host_ms_per_call(reading) is None
    else:
        assert spans.serve_host_ms_per_call(reading) > 0
        assert spans.host_enqueue_ms_per_step(reading) is None
