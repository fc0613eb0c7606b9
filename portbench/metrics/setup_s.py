"""``setup_s``: seconds from process start to the first timed call (imports,
the CUDA context, kernel libraries loaded or built, the pricer made from
the seed, the cell's shapes warmed). Host clock."""


def read(outcome, ctx):
    return outcome.measures["setup_s"]
