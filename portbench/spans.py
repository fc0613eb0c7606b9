"""The program's spans in a traced window: where each device operation was
launched, which runtime calls held the host, and where each idle gap fell.

    python3 portbench/spans.py --workload <name> --seed <n>

runs one cell as ``run.py --trace 1`` does, prints the run's result line and
then one JSON object that puts the traced window under the program's spans
(``spectralmc_tpu_torch/utils/profiling.py``), per training step or per
``predict_price`` call, with the per-layer numbers of ``METRICS`` and the
spans' coverage.

The reduction (``reduce_spans``):

* the program's spans are the ``user_annotation`` ranges named
  ``train_segment`` or ``spectralmc.*``; the span path of an instant on a
  host thread is the chain of those running there, outermost first, joined
  by ``/`` (``""`` where none runs);
* a device operation (kernel, memcpy, memset) goes to the path of the
  runtime call that issued it, found by the ``correlation`` argument the two
  share, and not to what ran on the host while the card ran it, nor to a
  ``gpu_user_annotation`` envelope (which holds the card's idle time too);
* a runtime call's path is its own thread's, or where that thread runs no
  span (the autograd engine's thread, which runs a card's backward), the
  deepest path running on any thread as it starts;
* a synchronising runtime call (``SYNCS``) counts under its path and by its
  call site (the outermost and the innermost host operation around it); its
  host time, that of a copy to or from pageable memory (which returns only
  once the copy is done) and that of any runtime call longer than
  ``LONG_CALL_US`` (a launch that found the launch queue full) is time the
  host waited for the card (``wait_s``);
* an idle gap of the window (no device operation running) goes to the
  deepest path at its midpoint.

The window is ``tracing.reduce_events``' own: from the first
``portbench.call`` range's start to the last one's end.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import tracing  # noqa: E402

SEGMENT = "train_segment"
STEP = "spectralmc.step"
SERVE = "spectralmc.serve"
PREFIX = "spectralmc."
RUNTIME = ("cuda_runtime", "cuda_driver")
TOP_RUNTIME = 16
# no launch or copy takes this long unless it waited: for a free slot in the
# card's launch queue, or for the card to reach a copy from pageable memory
LONG_CALL_US = 50.0
# calls (`cuda*` and `cu*` names) that return only once the card has caught up
SYNCS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyFromSymbol",
    "cudaMemcpyToSymbol", "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2", "cuMemcpyDtoD_v2",
})


@dataclass
class SpanReading:
    """Seconds and counts by span path, over the traced window."""

    busy_s: float
    device_s: dict[str, float] = field(default_factory=dict)  # launched there
    launches: dict[str, int] = field(default_factory=dict)  # kernels launched there
    idle_s: dict[str, float] = field(default_factory=dict)  # gaps with their midpoint there
    syncs: dict[str, int] = field(default_factory=dict)  # SYNCS calls
    wait_s: dict[str, float] = field(default_factory=dict)  # host time waiting for the card
    sync_sites: dict[str, int] = field(default_factory=dict)  # "path | outer > inner op | call"
    runtime_s: dict[str, float] = field(default_factory=dict)  # "path | call" -> host time
    host_s: dict[str, float] = field(default_factory=dict)  # a span's path -> its host time
    spans: dict[str, int] = field(default_factory=dict)  # a span's path -> how many


def last(path: str) -> str:
    return path.rsplit("/", 1)[-1]


class Timeline:
    """The path of each instant of one host thread, from properly nested
    ranges ``(start, end, name)``; ``owned`` holds each range's own path
    (its name last), start and end."""

    def __init__(self, ranges: list[tuple[float, float, str]]) -> None:
        self.times: list[float] = []
        self.paths: list[str] = []
        self.owned: list[tuple[str, float, float]] = []
        stack: list[tuple[float, str]] = []

        def mark(t: float) -> str:
            self.times.append(t)
            self.paths.append("/".join(name for _, name in stack))
            return self.paths[-1]

        for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= start:
                mark(stack.pop()[0])
            stack.append((end, name))
            self.owned.append((mark(start), start, end))
        while stack:
            mark(stack.pop()[0])

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        return self.paths[i] if i >= 0 else ""


def _ranges(events: list[dict[str, Any]],
            keep: Callable[[dict[str, Any]], bool]) -> dict[Any, Timeline]:
    by_thread: dict[Any, list[tuple[float, float, str]]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and keep(e):
            ts, thread = float(e["ts"]), (e.get("pid"), e.get("tid"))
            by_thread[thread].append((ts, ts + float(e["dur"]), e["name"]))
    return {thread: Timeline(ranges) for thread, ranges in by_thread.items()}


def is_program_span(e: dict[str, Any]) -> bool:
    return e.get("cat") == "user_annotation" and (
        e["name"] == SEGMENT or e["name"].startswith(PREFIX))


def reduce_spans(events: list[dict[str, Any]]) -> SpanReading:
    """The reading of a Chrome trace's events (``ts`` and ``dur`` in µs)."""
    xs = [e for e in events if e.get("ph") == "X"]
    calls = [e for e in xs
             if e["name"] == tracing.CALL_RANGE and e.get("cat") == "user_annotation"]
    if not calls:
        raise ValueError(f"no {tracing.CALL_RANGE} range in the trace")
    lo = min(float(e["ts"]) for e in calls)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in calls)
    spans = _ranges(xs, is_program_span)
    ops = _ranges(xs, lambda e: e.get("cat") == "cpu_op")
    device_events = [e for e in xs if e.get("cat") in tracing.DEVICE_CATEGORIES]
    pageable = {_correlation(e) for e in device_events
                if e["cat"] == "gpu_memcpy" and "Pageable" in e["name"]}

    def deepest(t: float) -> str:
        return max((tl.at(t) for tl in spans.values()), key=lambda p: p.count("/") + bool(p),
                   default="")

    def path(e: dict[str, Any]) -> str:
        # a thread without a span of its own (the autograd engine's, which
        # runs the backward on a card) works for the span running elsewhere
        timeline = spans.get((e.get("pid"), e.get("tid")))
        own = timeline.at(float(e["ts"])) if timeline else ""
        return own or deepest(float(e["ts"]))

    device_s: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    syncs: dict[str, int] = defaultdict(int)
    wait_s: dict[str, float] = defaultdict(float)
    sites: dict[str, int] = defaultdict(int)
    runtime_s: dict[str, float] = defaultdict(float)
    host_s: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    issued: dict[Any, str] = {}
    for e in xs:
        if e.get("cat") not in RUNTIME:
            continue
        where = path(e)
        issued[_correlation(e)] = where
        if not lo <= float(e["ts"]) <= hi:
            continue
        runtime_s[f"{where} | {e['name']}"] += float(e["dur"]) / 1e6
        if (e["name"] in SYNCS or _correlation(e) in pageable
                or float(e["dur"]) > LONG_CALL_US):
            wait_s[where] += float(e["dur"]) / 1e6
        if e["name"] in SYNCS:
            syncs[where] += 1
            timeline = ops.get((e.get("pid"), e.get("tid")))
            chain = timeline.at(float(e["ts"])).split("/") if timeline else [""]
            site = chain[0] if len(chain) == 1 else f"{chain[0]} > {chain[-1]}"
            sites[f"{where} | {site} | {e['name']}"] += 1
    for timeline in spans.values():
        for own, start, end in timeline.owned:
            if lo <= start <= hi:
                host_s[own] += (end - start) / 1e6
                counts[own] += 1
    device = []
    for e in device_events:
        start, end = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if end <= start:
            continue
        device.append((start, end))
        where = issued.get(_correlation(e), "")
        device_s[where] += (end - start) / 1e6
        launches[where] += e["cat"] == "kernel"
    busy = tracing.merged(device)
    idle: dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end > gap_start:
            idle[deepest((gap_start + gap_end) / 2)] += (gap_end - gap_start) / 1e6
    return SpanReading(busy_s=sum(e - s for s, e in busy) / 1e6, device_s=dict(device_s),
                       launches=dict(launches), idle_s=dict(idle), syncs=dict(syncs),
                       wait_s=dict(wait_s), sync_sites=dict(sites), runtime_s=dict(runtime_s),
                       host_s=dict(host_s), spans=dict(counts))


def _correlation(e: dict[str, Any]) -> Any:
    return (e.get("args") or {}).get("correlation")


# -- the per-layer numbers ---------------------------------------------------


def span_count(r: SpanReading, name: str) -> int:
    return sum(n for p, n in r.spans.items() if last(p) == name)


def _device_ms_per_step(r: SpanReading | None, *names: str) -> float | None:
    steps = span_count(r, STEP) if r else 0
    if not steps:
        return None
    return 1e3 * sum(s for p, s in r.device_s.items() if last(p) in names) / steps


def spectrum_ms_per_step(r: SpanReading | None) -> float | None:
    """Device time launched in the payoff and FFT spans, a step, in ms."""
    return _device_ms_per_step(r, "spectralmc.step.payoff", "spectralmc.step.fft")


def cvnn_ms_per_step(r: SpanReading | None) -> float | None:
    """Device time launched in the CVNN's forward and backward spans, a step."""
    return _device_ms_per_step(r, "spectralmc.step.cvnn_forward",
                               "spectralmc.step.cvnn_backward")


def adam_ms_per_step(r: SpanReading | None) -> float | None:
    """Device time launched in the Adam span, a step, in ms."""
    return _device_ms_per_step(r, "spectralmc.step.adam")


def _in_step(path: str) -> bool:
    return STEP in path.split("/")


def host_enqueue_ms_per_step(r: SpanReading | None) -> float | None:
    """Host time of the step spans less the calls inside them that waited
    for the card (``wait_s``), a step, in ms."""
    steps = span_count(r, STEP) if r else 0
    if not steps:
        return None
    held = sum(s for p, s in r.host_s.items() if last(p) == STEP)
    waited = sum(s for p, s in r.wait_s.items() if _in_step(p))
    return 1e3 * (held - waited) / steps


def syncs_per_step(r: SpanReading | None) -> float | None:
    """Synchronising runtime calls inside the step spans, a step: a count."""
    steps = span_count(r, STEP) if r else 0
    if not steps:
        return None
    return sum(n for p, n in r.syncs.items() if _in_step(p)) / steps


def serve_host_ms_per_call(r: SpanReading | None) -> float | None:
    """Host time of ``predict_price`` less the calls inside it that waited
    for the card (the fetch's copy, and any synchronise before it), a call,
    in ms."""
    calls = span_count(r, SERVE) if r else 0
    if not calls:
        return None
    held = sum(s for p, s in r.host_s.items() if last(p) == SERVE)
    waited = sum(s for p, s in r.wait_s.items() if SERVE in p.split("/"))
    return 1e3 * (held - waited) / calls


METRICS: dict[str, Callable[[SpanReading | None], float | None]] = {
    "spectrum_ms_per_step.train": spectrum_ms_per_step,
    "cvnn_ms_per_step.train": cvnn_ms_per_step,
    "adam_ms_per_step.train": adam_ms_per_step,
    "host_enqueue_ms_per_step.train": host_enqueue_ms_per_step,
    "syncs_per_step.train": syncs_per_step,
    "serve_host_ms_per_call": serve_host_ms_per_call,
}


def coverage(r: SpanReading) -> dict[str, float | None]:
    """Inside the segments: the share of busy time launched in
    ``train_segment`` or ``spectralmc.step`` itself rather than in a span
    beneath them, and the share of idle time whose midpoint lies in no span
    beneath ``train_segment``, in percent."""
    loose = sum(s for p, s in r.device_s.items() if last(p) in (SEGMENT, STEP))
    inside = {p: s for p, s in r.idle_s.items() if SEGMENT in p.split("/")}
    idle = sum(inside.values())
    return {"device_outside_pct": 100.0 * loose / r.busy_s if r.busy_s else None,
            "idle_outside_pct": (100.0 * sum(s for p, s in inside.items() if last(p) == SEGMENT)
                                 / idle if idle else None)}


def report(r: SpanReading) -> dict[str, Any]:
    """Per step (a training window) or per call (a serving one): each path's
    device ms, kernel launches, idle ms, syncs, ms waited and its spans' host
    ms; the call sites of the syncs; the runtime calls that held the host
    longest; the per-layer numbers; the coverage."""
    per = span_count(r, STEP) or span_count(r, SERVE) or 1
    paths = sorted(set(r.device_s) | set(r.idle_s) | set(r.wait_s) | set(r.host_s))
    by_path = {p: {"device_ms": 1e3 * r.device_s.get(p, 0.0) / per,
                   "launches": r.launches.get(p, 0) / per,
                   "idle_ms": 1e3 * r.idle_s.get(p, 0.0) / per,
                   "syncs": r.syncs.get(p, 0) / per,
                   "wait_ms": 1e3 * r.wait_s.get(p, 0.0) / per,
                   "host_ms": 1e3 * r.host_s.get(p, 0.0) / per} for p in paths}
    runtime = sorted(r.runtime_s.items(), key=lambda kv: -kv[1])[:TOP_RUNTIME]
    return {"per": "step" if span_count(r, STEP) else "call", "count": per,
            "busy_ms": 1e3 * r.busy_s / per, "by_path": by_path,
            "sync_sites": {k: n / per for k, n in sorted(r.sync_sites.items())},
            "runtime_ms": {k: 1e3 * v / per for k, v in runtime},
            "metrics": {name: fn(r) for name, fn in METRICS.items()},
            "coverage": coverage(r)}


@contextlib.contextmanager
def kept_events() -> Iterator[list[list[dict[str, Any]]]]:
    """While open, every trace ``tracing.reduce_events`` reads is also kept
    in the yielded list."""
    kept: list[list[dict[str, Any]]] = []
    reduce_events = tracing.reduce_events

    def keep(events: list[dict[str, Any]], calls: int, steps: int) -> tracing.TraceReading:
        kept.append(events)
        return reduce_events(events, calls, steps)

    tracing.reduce_events = keep
    try:
        yield kept
    finally:
        tracing.reduce_events = reduce_events


def main(argv: list[str] | None = None) -> int:
    import argparse

    from portbench import run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    with kept_events() as kept:  # a traced window is the cell's own traced calls
        code = run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", "0", "--trace", "1"])
    if code == 0:
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          **report(reduce_spans(kept[-1]))}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
