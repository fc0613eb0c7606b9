"""Book revaluation in a closed loop: one client calls
``GbmCVNNPricer.predict_price`` on one book after another, each call
starting as the last one returns. The pricer serves one call at a time, so
the next book is always ready and the pricer is never left waiting for
load, however fast it gets. The window closes at the end of the first call
that finishes after ``--seconds``; what it measures is the contracts
revalued in it over its time.

Set-up builds the pricer from the seed with the benchmark's weights,
untrained, draws ``books`` books of sizes spread evenly over
``[smallest, largest]`` (in an order drawn from the seed) from a held-out
Sobol range, and serves ``warm_calls`` of them.
With ``--trace 1`` the window is ``trace_calls`` calls under the profiler.
One call in ``check_every``, drawn from the seed, keeps its prices for the
reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import checks, inputs, program, serve_check, tracing
from portbench.core import Context, Outcome, stamp


def run(ctx: Context) -> Outcome:
    config, mix, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    program.apply_runtime()
    program.quiet_residue_warnings()
    weights = inputs.make_weights(inputs.network(config), ctx.seed, device)
    pricer = program.make_pricer(config, ctx.seed, device,
                                 {k: v.cpu().numpy() for k, v in weights.items()})
    stamp(ctx, "pricer made")
    books = inputs.books(config, ctx.seed, mix["books"], mix["smallest"], mix["largest"])
    stamp(ctx, "books drawn")
    for i in range(mix["warm_calls"]):
        pricer.predict_price(books[i % len(books)])
    setup_s = time.perf_counter() - ctx.started

    keep = np.random.default_rng(ctx.seed)
    rows: list[int] = []
    padded: list[int] = []
    kept: list[tuple[int, np.ndarray, np.ndarray]] = []
    failed = served = 0

    def one_call() -> None:
        nonlocal failed, served
        index = len(rows)
        book = books[index % len(books)]
        try:
            prices = pricer.predict_price(book)
        except Exception:  # noqa: BLE001 — a call that raises is a failed call
            prices = None
        rows.append(len(book))
        padded.append(1 << (len(book) - 1).bit_length())
        if prices is None:
            failed += 1
            return
        served += len(book)
        if keep.random() < 1.0 / mix["check_every"] or index == 0:
            kept.append((index % len(books), prices.put.copy(), prices.call.copy()))

    reading = None
    start = time.perf_counter()
    if ctx.trace:
        with tracing.traced(device) as events:
            for _ in range(mix["trace_calls"]):
                with tracing.call_range():
                    one_call()
        reading = tracing.reduce_events(events(), len(rows), 0)
    else:
        while time.perf_counter() - start < ctx.seconds:
            one_call()
    window_s = time.perf_counter() - start
    stamp(ctx, f"window closed: {len(rows)} calls")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    measures = {"setup_s": setup_s, "window_s": window_s,
                "contracts": served, "padded_rows": padded}
    del pricer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = [serve_check.reference_prices(config, weights, books[b], device) for b, _, _ in kept]
    numbers = serve_check.compare([(p, c) for _, p, c in kept], want)
    found = [checks.Check(n, v, ctx.cell.limits[n]) for n, v in numbers.items()]
    return Outcome(len(rows), failed, measures, found, memory_peak, reading)
