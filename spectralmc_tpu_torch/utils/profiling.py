"""Profiling hooks: a torch.profiler trace of a block, and a host step timer.

``profile_trace`` records CPU activity, and CUDA activity when the device is
a card, and writes a Chrome trace (``*.pt.trace.json``) into ``logdir``
through ``tensorboard_trace_handler``, which needs no tensorboard package.
``GbmCVNNPricer.train(profile_dir=...)`` wraps the call in it, with one
``train_segment`` range a segment.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, *, device: torch.device | str) -> Iterator[object]:
    """Record the enclosed block with torch.profiler; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@dataclass
class StepTimer:
    """Host-side wall-clock per-step accumulator."""

    times: list[float] = field(default_factory=list)
    _start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        assert self._start is not None, "start() before stop()"
        elapsed = time.perf_counter() - self._start
        self.times.append(elapsed)
        self._start = None
        return elapsed

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
