"""``roofline_pct.gbm_paths``: path kernel #1's bound at its launched shape
(``counts/kernels.py``, contract_chunk x rows x cols x steps) over its mean
device time a launch in the traced window, in percent."""

from portbench.counts.kernels import gbm_paths_bound_ms

PATTERN = "gbm_paths_kernel"


def read(outcome, ctx):
    t = outcome.trace
    times = [d for name, _, d in (t.kernels if t else []) if PATTERN in name]
    if not times:
        return None
    p, chunk = ctx.cell.config["pricer"], ctx.cell.config["training"]["contract_chunk"]
    bound_ms, _ = gbm_paths_bound_ms(p["payoff"], chunk, p["batches_per_mc_run"],
                                     p["network_size"], p["timesteps"])
    return 100.0 * (bound_ms / 1e3) / (sum(times) / len(times))
