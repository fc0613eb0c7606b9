"""``device_idle_pct.train``: the traced window of whole ``train`` calls less
the union of the device operations' intervals, over the window, in percent."""

from portbench.tracing import idle_pct


def read(outcome, ctx):
    return idle_pct(outcome.trace)
