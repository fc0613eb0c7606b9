"""``serve_mfu_pct``: the CVNN forward's matmul FLOPs and the inverse FFTs
of every traced ``predict_price`` call (at its padded row count,
``counts/flops.py``) over the traced window, as a share of the float32 peak
of an NVIDIA H100 SXM at 700 W (67 TFLOP/s)."""

from portbench.counts.flops import PEAK_FP32_FLOPS, serve_call_flops


def read(outcome, ctx):
    t = outcome.trace
    if t is None or not t.kernels:
        return None
    rows = outcome.measures["padded_rows"][:t.calls]
    flops = sum(serve_call_flops(ctx.cell.config, n) for n in rows)
    return 100.0 * flops / t.window_s / PEAK_FP32_FLOPS
