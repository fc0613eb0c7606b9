"""``step_mfu_pct.train``: the least time the card could take for a training
step's counted work (each path or LSMC kernel launch at its own bound, the
CVNN's matmul FLOPs and the spectrum FFTs at the float32 peak:
``counts/flops.py``) over the measured step time (the traced window over its
steps), in percent of the NVIDIA H100 SXM peaks at 700 W. On a mesh, rank
0's share of the step's work over rank 0's step time."""

from portbench.counts.flops import step_least_seconds


def read(outcome, ctx):
    t = outcome.trace
    if t is None or not t.steps or not t.kernels:
        return None
    shards = ctx.cell.traffic.get("mesh", [1, 1])[0]  # a rank does its shard's share
    return 100.0 * step_least_seconds(ctx.cell.config) / shards / (t.window_s / t.steps)
