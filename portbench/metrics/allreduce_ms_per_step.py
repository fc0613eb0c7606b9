"""``allreduce_ms_per_step``: device time of rank 0's NCCL kernels (the one
all-reduce of loss, gradients and batch-norm statistics a step) in the
traced window, over its steps, in milliseconds."""

PATTERN = "nccl"


def read(outcome, ctx):
    t = outcome.trace
    times = [d for name, _, d in (t.kernels if t else []) if PATTERN in name.lower()]
    if not times or not t.steps:
        return None
    return 1e3 * sum(times) / t.steps
