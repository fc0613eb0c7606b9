"""``roofline_pct.lsmc_backward``: the LSMC backward #11's bound at its
launched shape (``counts/kernels.py``: contract_chunk x rows x cols paths,
one date a monitor step) over its mean device time a launch in the traced
window, in percent."""

from portbench.counts.kernels import lsmc_backward_bound_ms

PATTERN = "backward_kernel"


def read(outcome, ctx):
    t = outcome.trace
    times = [d for name, _, d in (t.kernels if t else []) if PATTERN in name]
    if not times:
        return None
    p, chunk = ctx.cell.config["pricer"], ctx.cell.config["training"]["contract_chunk"]
    knobs = p["knobs"]
    bound_ms, _ = lsmc_backward_bound_ms(chunk, p["batches_per_mc_run"], p["network_size"],
                                         p["timesteps"] // knobs["lsmc_exercise_every"],
                                         knobs["lsmc_basis_degree"])
    return 100.0 * (bound_ms / 1e3) / (sum(times) / len(times))
