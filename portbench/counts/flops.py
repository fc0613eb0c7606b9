"""FLOP conventions of the fused step and of serving, and the least time of a step.

The conventions are frozen copies of ``spectralmc_tpu_torch/utils/flops.py``
as it stood when this benchmark was written (they are the JAX package's):

* a ``ComplexLinear`` ``[B, in] -> [B, out]`` is four real matmuls, each
  weight in two of them: ``8·B·in·out`` forward FLOPs;
* forward and backward of a training step: three times the forward;
* an N-point complex FFT is ``5·N·log2(N)`` FLOPs, one per contract (the
  batch-mean spectrum is one FFT of the row mean), and one inverse FFT per
  served row.

The widths come from the configuration's CVNN description, walked as the
port's factory walks it (width threading, a projection where a residual
body changes width, the output head appended), so no program object is
needed to count.
"""

from __future__ import annotations

import math
from typing import Any

from portbench.counts import kernels

PEAK_FP32_FLOPS = kernels.FP32_OPS_PER_S


def complex_linear_shapes(layers: list[dict[str, Any]], input_dim: int,
                          output_dim: int) -> list[tuple[int, int]]:
    """``(in, out)`` of every ComplexLinear of the CVNN, head included."""
    shapes: list[tuple[int, int]] = []

    def walk(layer: dict[str, Any], dim: int) -> int:
        kind = layer["kind"]
        if kind == "linear":
            out = layer.get("width") or dim
            shapes.append((dim, out))
            return out
        if kind in ("cov_bn", "naive_bn"):
            return dim
        if kind == "sequential":
            for sub in layer["layers"]:
                dim = walk(sub, dim)
            return dim
        if kind == "residual":
            out = walk(layer["body"], dim)
            if out != dim:
                shapes.append((dim, out))
            return out
        raise ValueError(f"unknown layer kind {kind!r}")

    dim = input_dim
    for layer in layers:
        dim = walk(layer, dim)
    shapes.append((dim, output_dim))
    return shapes


def forward_matmul_flops(shapes: list[tuple[int, int]], rows: int) -> int:
    return sum(8 * rows * i * o for i, o in shapes)


def train_matmul_flops(shapes: list[tuple[int, int]], rows: int) -> int:
    return 3 * forward_matmul_flops(shapes, rows)


def fft_flops(count: int, points: int) -> int:
    return count * int(5 * points * math.log2(points))


def step_least_seconds(config: dict[str, Any]) -> float:
    """The least time the card could take for one training step's counted
    work: each path or LSMC kernel launch at its own bound, and the CVNN's
    matmul FLOPs and the spectrum FFTs at the float32 peak."""
    sim, train = config["pricer"], config["training"]
    batch, chunk = train["batch_size"], train["contract_chunk"]
    rows, cols, steps = sim["batches_per_mc_run"], sim["network_size"], sim["timesteps"]
    launches = batch // chunk
    if sim["payoff"].startswith("american"):
        every = sim.get("lsmc_exercise_every", 1)
        path_ms = kernels.american_gbm_bound_ms(chunk, rows, cols, steps, every)[0]
        path_ms += kernels.lsmc_backward_bound_ms(chunk, rows, cols, steps // every,
                                                  sim.get("lsmc_basis_degree", 5))[0]
    else:
        path_ms = kernels.gbm_paths_bound_ms(sim["payoff"], chunk, rows, cols, steps)[0]
    shapes = complex_linear_shapes(config["cvnn"]["layers"], config["input_dim"], cols)
    flops = train_matmul_flops(shapes, batch) + fft_flops(batch, cols)
    return launches * path_ms / 1e3 + flops / PEAK_FP32_FLOPS


def serve_call_flops(config: dict[str, Any], rows: int) -> int:
    """The CVNN forward's matmul FLOPs and the inverse FFTs of one served
    call of ``rows`` (padded) rows."""
    cols = config["pricer"]["network_size"]
    shapes = complex_linear_shapes(config["cvnn"]["layers"], config["input_dim"], cols)
    return forward_matmul_flops(shapes, rows) + fft_flops(rows, cols)
