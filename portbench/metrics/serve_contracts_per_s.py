"""``serve_contracts_per_s``: the contracts of every book that
``predict_price`` revalued in the window over the window's whole time, the
load offered above what the pricer sustains. Host clock."""


def read(outcome, ctx):
    if "contracts" not in outcome.measures or ctx.trace:
        return None
    return outcome.measures["contracts"] / outcome.measures["window_s"]
