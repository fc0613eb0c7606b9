"""``device_idle_pct.serve``: the traced window of whole ``predict_price``
calls less the union of the device operations' intervals, over the window,
in percent."""

from portbench.tracing import idle_pct


def read(outcome, ctx):
    return idle_pct(outcome.trace)
