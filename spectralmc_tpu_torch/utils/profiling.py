"""Profiling hooks: a torch.profiler trace of a block, and the program's spans.

``profile_trace`` records CPU activity, and CUDA activity when the device is
a card, and writes a Chrome trace (``*.pt.trace.json``) into ``logdir``
through ``tensorboard_trace_handler``, which needs no tensorboard package.
``GbmCVNNPricer.train(profile_dir=...)`` wraps the call in it.

``span(name)`` marks a layer boundary of the program. While a torch profiler
records on this thread it is a ``torch.profiler.record_function`` range, so
the span lands in the same trace as the kernels it launches, on the
profiler's clock, nested in the enclosing span; otherwise it is one shared
no-op context, and costs one check. The spans, by layer:

* trainer: ``train_segment`` (a segment), ``spectralmc.train.segment_start``
  (the weight and moment clones), ``spectralmc.train.fetch`` (the segment's
  one device→host copy of losses and norms);
* fused step: ``spectralmc.step`` (a batch), ``spectralmc.step.sample``
  (Sobol contracts and draws), per chunk ``spectralmc.step.paths`` (the key
  fold and the path kernel), ``spectralmc.step.payoff`` (mean target, MEAN
  row mean, discounted put) and ``spectralmc.step.fft``;
  ``spectralmc.step.cvnn_forward`` (input normaliser, model, loss),
  ``spectralmc.step.cvnn_backward`` and ``spectralmc.step.adam`` (gradient
  norm and update);
* collectives: ``spectralmc.collective`` (an all-reduce);
* serve: ``spectralmc.serve`` (a ``predict_price`` call) over
  ``spectralmc.serve.prepare`` (contracts to the device),
  ``spectralmc.serve.forward`` (the forward and the parity mean),
  ``spectralmc.serve.fetch`` (the copy back, which waits for the card) and
  ``spectralmc.serve.parity`` (the residue check and host parity).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.autograd import _profiler_enabled

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(logdir: str, *, device: torch.device | str) -> Iterator[object]:
    """Record the enclosed block with torch.profiler; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def span(name: str) -> contextlib.AbstractContextManager[object]:
    """A ``record_function`` range named ``name`` while a torch profiler
    records on this thread, else the shared no-op context."""
    return torch.profiler.record_function(name) if _profiler_enabled() else _NO_SPAN
