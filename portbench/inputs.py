"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: the network's weights and batch-norm state, and served books.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from portbench.reference import sobol
from portbench.reference.cvnn import Network

INPUT_DIM = 6  # spot, strike, maturity, rate, div_yield, vol
BIAS_SCALE = 0.05  # linear and modReLU biases: uniform in ±this
BOOK_START = 1 << 31  # books come from a Sobol range that training never reaches


def network(config: dict[str, Any]) -> Network:
    return Network(config["cvnn"]["layers"], INPUT_DIM, config["pricer"]["network_size"])


def make_weights(net: Network, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Flat ``params/<path>`` and ``state/<path>`` float32 tensors on ``device``.

    One uniform draw on the device from ``seed`` fills every linear weight
    (Glorot-uniform, ``±sqrt(6 / (in + out))``), every linear and modReLU bias
    (``±BIAS_SCALE``); the covariance batch norms start as the layer's own
    initialisation does (``Γ = I/√2``, ``β = 0``, running covariance ``I/2``).
    """
    sizes: list[tuple[str, tuple[int, ...], float]] = []
    for path, (n_in, n_out, bias) in net.linear_shapes.items():
        bound = math.sqrt(6.0 / (n_in + n_out))
        sizes += [(f"{path}/w_re", (n_in, n_out), bound), (f"{path}/w_im", (n_in, n_out), bound)]
        if bias:
            sizes += [(f"{path}/b_re", (n_out,), BIAS_SCALE), (f"{path}/b_im", (n_out,), BIAS_SCALE)]
    sizes += [(f"{path}/b", (width,), BIAS_SCALE) for path, width in net.modrelu.items()]
    total = sum(math.prod(shape) for _, shape, _ in sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out: dict[str, torch.Tensor] = {}
    at = 0
    for key, shape, scale in sizes:
        n = math.prod(shape)
        out[f"params/{key}"] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    for path, width in net.cov_bn.items():
        half_root = torch.full((width,), 1.0 / math.sqrt(2.0), device=device)
        zero = torch.zeros(width, device=device)
        out.update({f"params/{path}/g_rr": half_root, f"params/{path}/g_ri": zero,
                    f"params/{path}/g_ii": half_root.clone(), f"params/{path}/beta_re": zero.clone(),
                    f"params/{path}/beta_im": zero.clone(),
                    f"state/{path}/mean_re": zero.clone(), f"state/{path}/mean_im": zero.clone(),
                    f"state/{path}/c_rr": torch.full((width,), 0.5, device=device),
                    f"state/{path}/c_ri": zero.clone(),
                    f"state/{path}/c_ii": torch.full((width,), 0.5, device=device)})
    return out


def split(flat: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """``(weights, state)`` keyed by path, without the prefixes."""
    weights = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    state = {k[len("state/"):]: v for k, v in flat.items() if k.startswith("state/")}
    return weights, state


def bounds(config: dict[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    lo = np.array([config["bounds"][f][0] for f in config["fields"]], dtype=np.float64)
    hi = np.array([config["bounds"][f][1] for f in config["fields"]], dtype=np.float64)
    return lo, hi


def books(config: dict[str, Any], seed: int, count: int, smallest: int,
          largest: int) -> list[np.ndarray]:
    """``count`` books of contracts ``[n, 6]`` float32, consecutive from a
    held-out Sobol range. The sizes are the same for every seed, spread
    evenly over ``[smallest, largest]``; the seed draws their order, so
    that it changes the contracts and not the work."""
    grid = smallest + ((largest - smallest) * (np.arange(count) + 0.5) / count).astype(np.int64)
    sizes = np.random.default_rng(seed).permutation(grid)
    table = sobol.scrambled(INPUT_DIM, seed)
    lo, hi = bounds(config)
    points = sobol.contracts(table, lo, hi, BOOK_START, int(sizes.sum()))
    ends = np.cumsum(sizes)
    return [np.ascontiguousarray(points[e - n:e]) for n, e in zip(sizes, ends)]
