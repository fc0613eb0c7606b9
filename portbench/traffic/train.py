"""Closed-loop training: one trainer calls ``GbmCVNNPricer.train`` again and
again, each call ``batches_per_call`` batches under ``NoCommit`` and each
ending in its own synchronise.

Set-up builds the pricer from the seed with the benchmark's weights, runs
the first calls with ``program.Capture`` installed (their first steps are
the ones the reference follows, and they build and warm every kernel and
shape the window uses: they are the warm-up). The window closes at the
end of the first call that finishes after ``--seconds``; with ``--trace 1``
it is ``trace_calls`` calls under the profiler instead.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from portbench import checks, inputs, program, tracing, train_check
from portbench.core import Context, Outcome, stamp

CHECK_CALLS_MAX = 8  # calls allowed for the capture to see its steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Session:
    """One trainer's run: its window and what the capture read."""

    attempted: int
    failed: int
    measures: dict[str, Any]
    memory_peak: int
    reading: tracing.TraceReading | None
    capture: program.Capture
    losses: list[float]
    missing_launches: float | None


def session(ctx: Context, weights: dict[str, torch.Tensor], *, mesh_spec: Any = None,
            profile: bool = True,
            agree: Callable[[bool], bool] = lambda done: done) -> Session:
    """Set-up, the checked calls and the window of one trainer; with
    ``mesh_spec`` this rank's share of a sharded trainer, ``profile`` whether
    this rank traces a ``--trace 1`` window and ``agree`` how the ranks agree
    that the window is over (rank 0's clock decides)."""
    config, mix, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    shards = 1 if mesh_spec is None else mesh_spec.batch_size_divisor
    batch, chunk = config["training"]["batch_size"], config["training"]["contract_chunk"]
    local = batch // shards
    chunks = local // min(chunk, local)
    per_call = mix["batches_per_call"]
    pricer = program.make_pricer(config, ctx.seed, device,
                                 {k: v.cpu().numpy() for k, v in weights.items()}, mesh_spec)
    train_config = program.training_config(config, per_call)
    stamp(ctx, "pricer made")

    capture = program.Capture(pricer, chunks, train_check.CHECK_STEPS)
    losses: list[float] = []
    with capture:
        for _ in range(CHECK_CALLS_MAX):
            losses += [float(x) for x in pricer.train(train_config).expect("train").losses]
            if capture.done:
                break
    _sync(device)
    stamp(ctx, "checked calls done")
    setup_s = time.perf_counter() - ctx.started

    attempted = failed = 0

    def one_call() -> None:
        nonlocal attempted, failed
        result = pricer.train(train_config)
        _sync(device)
        attempted += 1
        failed += isinstance(result, program.Failure)

    launched_before = program.kernel_launches()
    reading = None
    start = time.perf_counter()
    if ctx.trace:
        with tracing.traced(device, enabled=profile) as events:
            for _ in range(mix["trace_calls"]):
                with tracing.call_range():
                    one_call()
        if profile:
            reading = tracing.reduce_events(events(), attempted, attempted * per_call)
    else:
        while True:
            one_call()
            if agree(time.perf_counter() - start >= ctx.seconds):
                break
    window_s = time.perf_counter() - start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    missing = None
    if config["kernel_branches"]:  # each path kernel branch launches once a chunk
        launched = program.kernel_launches()
        missing = float(sum(attempted * per_call * chunks
                            - (launched[b] - launched_before.get(b, 0))
                            for b in config["kernel_branches"]))
    measures = {"setup_s": setup_s, "window_s": window_s,
                "contracts": (attempted - failed) * per_call * batch,
                "steps": attempted * per_call}
    del pricer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Session(attempted, failed, measures, memory_peak, reading, capture, losses, missing)


def found(ctx: Context, numbers: dict[str, float]) -> list[checks.Check]:
    """The checks of the numbers the cell's limits name."""
    limits = ctx.cell.limits
    return [checks.Check(n, v, limits[n]) for n, v in numbers.items() if n in limits]


def measured(ctx: Context) -> tuple[Session, train_check.Side, list[torch.Tensor],
                                    dict[str, torch.Tensor]]:
    """The session, the program's side of the comparison, the checked steps'
    targets and the weights the run started from."""
    program.apply_runtime()
    config = ctx.cell.config
    weights = inputs.make_weights(inputs.network(config), ctx.seed, ctx.device)
    s = session(ctx, weights)
    contracts, targets = s.capture.per_step(config["training"]["batch_size"])
    got = train_check.program_side(contracts, targets, s.losses, s.capture.first_mu,
                                   s.capture.weights_after, weights,
                                   train_check.sample(config, ctx.seed))
    return s, got, targets, weights


def run(ctx: Context, shards: int = 1, measure: Callable[..., Any] = measured) -> Outcome:
    config = ctx.cell.config
    s, got, targets, weights = measure(ctx)
    numbers = {} if s.missing_launches is None else {"missing_launches": s.missing_launches}
    numbers.update(train_check.numbers(config, ctx.seed, ctx.device, weights, got, targets,
                                       train_check.sample(config, ctx.seed), shards))
    return Outcome(s.attempted, s.failed, s.measures, found(ctx, numbers), s.memory_peak,
                   s.reading)
