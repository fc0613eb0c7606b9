"""``train_contracts_per_s``: every contract trained in the window over the
window's whole time, the window being whole ``train`` calls, each ending in
its own synchronise. Host clock."""


def read(outcome, ctx):
    if "contracts" not in outcome.measures or ctx.trace:
        return None
    return outcome.measures["contracts"] / outcome.measures["window_s"]
