"""A torch.profiler window over whole calls, reduced to what the per-layer
metrics read: the device operations' intervals, the traced window, and the
host operation that ran across each idle gap.

Each traced call runs inside a ``portbench.call`` range; the window runs
from the first range's start to the last one's end, in the trace's own
clock. The trace file goes to the temporary directory and is deleted once
read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

CALL_RANGE = "portbench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


@dataclass
class TraceReading:
    """Times in seconds. ``kernels`` holds ``(name, start, duration)`` of the
    CUDA kernels inside the window; ``busy_s`` is the union of every device
    operation's interval inside it; ``calls`` and ``steps`` count the work."""

    window_s: float
    busy_s: float
    kernels: list[tuple[str, float, float]]
    calls: int
    steps: int
    idle_by_host: dict[str, float] = field(default_factory=dict)
    device_ops: dict[str, float] = field(default_factory=dict)

    def breakdown(self) -> dict[str, list[list[Any]]]:
        def top(d: dict[str, float]) -> list[list[Any]]:
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle_by_host)}


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def reduce_events(events: list[dict[str, Any]], calls: int, steps: int) -> TraceReading:
    """The reading of a Chrome trace's events (``ts`` and ``dur`` in µs)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == CALL_RANGE
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {CALL_RANGE} range in the trace")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device, kernels, by_name = [], [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, end = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if end <= start:
            continue
        device.append((start, end))
        by_name[e["name"]] += (end - start) / 1e6
        if e["cat"] == "kernel":
            kernels.append((e["name"], float(e["ts"]) / 1e6, float(e["dur"]) / 1e6))
    busy = merged(device)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES
                  and e.get("name") != CALL_RANGE)
    starts = [h[0] for h in host]
    idle: dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end > gap_start:
            idle[_host_at(host, starts, (gap_start + gap_end) / 2)] += (gap_end - gap_start) / 1e6
    return TraceReading(window_s=(hi - lo) / 1e6, busy_s=sum(e - s for s, e in busy) / 1e6,
                        kernels=kernels, calls=calls, steps=steps, idle_by_host=dict(idle),
                        device_ops=dict(by_name))


def _host_at(host: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost host operation running at ``t`` (the shortest that
    covers it, among the latest started)."""
    best: tuple[float, str] | None = None
    i = bisect.bisect_right(starts, t)
    for start, end, name in reversed(host[max(0, i - 512):i]):
        if end >= t and (best is None or end - start < best[0]):
            best = (end - start, name)
    return best[1] if best else "python (no traced operation)"


@contextlib.contextmanager
def traced(device: torch.device,
           enabled: bool = True) -> Iterator[Callable[[], list[dict[str, Any]]]]:
    """Profile the block; yields a function that returns the trace's events
    once the block has ended (none where ``enabled`` is false)."""
    from torch.profiler import ProfilerActivity, profile

    holder: dict[str, list[dict[str, Any]]] = {"events": []}
    if not enabled:
        yield lambda: holder["events"]
        return
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield lambda: holder["events"]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["events"] = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def call_range() -> contextlib.AbstractContextManager[Any]:
    return torch.profiler.record_function(CALL_RANGE)


def idle_pct(reading: TraceReading | None) -> float | None:
    """Percent of the traced window in which no device operation ran."""
    if reading is None or reading.busy_s <= 0:
        return None
    return 100.0 * (reading.window_s - reading.busy_s) / reading.window_s
