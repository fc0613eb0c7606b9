"""``launches_per_step.train``: CUDA kernel events in the traced window over
the training steps it holds. A count: it repeats exactly."""


def read(outcome, ctx):
    t = outcome.trace
    if t is None or not t.steps or not t.kernels:
        return None
    return len(t.kernels) / t.steps
