"""The training cells' comparison with the plain reference.

The program's timed ``train`` call is followed through its first
``CHECK_STEPS`` steps (``program.Capture``). The reference works out again,
from the seed, the Sobol contracts of those steps and, for one contract of
every chunk of every checked step, its row in the chunk drawn from the seed,
their Monte-Carlo spectrum targets; it then trains the
benchmark's weights on its own contracts and on the program's targets, one
Adam step a batch. Simulating all the targets again would take minutes at
the production batch, so the network's stage follows the program's targets
and the sample checks that stage's input on its own. The numbers, of which
a cell's limits file names those it compares:

* ``contracts_gap``: the worst contract field's gap over its bound's span;
* ``target_gap``: the worst sampled contract's ``‖t_prog − t_ref‖ / ‖t_ref‖``;
* ``price_gap``: the same of the spectrum's zero-frequency term alone, which
  is the number of columns times the contract's Monte-Carlo price;
* ``loss_gap``: the worst step's relative loss gap;
* ``grad_gap``: the first gradient, as Adam's first moments hold it after
  step 1, by the worst leaf's gap of norms;
* ``change_gap``: the weights' change over the steps, by the worst leaf's
  gap of norms, leaves whose reference gradient is nought to rounding left
  out (``checks.moving_leaves``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from portbench import checks, inputs
from portbench.reference import sobol
from portbench.reference.american import american_put_spectra
from portbench.reference.cvnn import ADAM_B1
from portbench.reference.gbm import terminal_spectra
from portbench.reference.train import follow

CHECK_STEPS = 3
NUMBERS = ("contracts_gap", "target_gap", "price_gap", "loss_gap", "grad_gap", "change_gap")


@dataclass
class Side:
    """One side of the comparison, on the host in float32."""

    contracts: list[torch.Tensor]  # per step, [B, D]
    sample_targets: torch.Tensor  # [S, N] complex
    losses: list[float]
    first_grads: dict[str, torch.Tensor]
    change: dict[str, torch.Tensor]


def sample(config: dict[str, Any], seed: int) -> list[tuple[int, int]]:
    """``(step, row)`` of the contracts whose targets are simulated again: one
    in each chunk of each checked step, so that a fault confined to one chunk
    (its draws, its contracts' offset, the last chunk's slice) is always seen;
    the row within the chunk is drawn from the seed."""
    batch = config["training"]["batch_size"]
    chunk = min(config["training"]["contract_chunk"], batch)
    within = np.random.default_rng(seed).integers(0, chunk, size=(CHECK_STEPS, batch // chunk))
    return [(step, c * chunk + int(r)) for step in range(CHECK_STEPS)
            for c, r in enumerate(within[step])]


def reference_contracts(config: dict[str, Any], seed: int) -> list[torch.Tensor]:
    batch = config["training"]["batch_size"]
    table = sobol.scrambled(inputs.INPUT_DIM, seed)
    lo, hi = inputs.bounds(config)
    return [torch.from_numpy(sobol.contracts(table, lo, hi, s * batch, batch))
            for s in range(CHECK_STEPS)]


def reference_targets(config: dict[str, Any], seed: int, contracts: list[torch.Tensor],
                      picked: list[tuple[int, int]], device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    p, batch = config["pricer"], config["training"]["batch_size"]
    params = torch.stack([contracts[s][r] for s, r in picked]).to(device)
    draws = torch.tensor([s * batch + r for s, r in picked], dtype=torch.int64, device=device)
    shape = dict(mc_seed=seed, rows=p["batches_per_mc_run"], cols=p["network_size"],
                 steps=p["timesteps"], dtype=dtype)
    if p["payoff"] == "american_put":
        return american_put_spectra(params, draws, degree=p["knobs"]["lsmc_basis_degree"],
                                    **shape).cpu()
    if p["payoff"] != "terminal":
        raise ValueError(f"the reference has no {p['payoff']!r} payoff")
    return terminal_spectra(params, draws, normalize=p["normalization"] == "mean",
                            **shape).cpu()


def normalized(config: dict[str, Any], contracts: torch.Tensor) -> torch.Tensor:
    lo, hi = (torch.from_numpy(b.astype(np.float32)) for b in inputs.bounds(config))
    return (contracts - lo) / (hi - lo)


def reference_side(config: dict[str, Any], seed: int, device: torch.device,
                   weights_flat: dict[str, torch.Tensor], targets: list[torch.Tensor],
                   picked: list[tuple[int, int]], dtype: torch.dtype = torch.float32,
                   rows: slice = slice(None), shards: int = 1) -> Side:
    """The reference in ``dtype`` (float32; bfloat16 for the control), the
    network's stage on ``targets`` with the batch in ``shards`` equal shards
    (each normalized by its own batch statistics, the loss their mean);
    ``rows`` of each batch only (all: the reference; a part: the faults that
    leave the rest of the batch out)."""
    contracts = [c.to(dtype).float() for c in reference_contracts(config, seed)]
    sample_targets = reference_targets(config, seed, contracts, picked, device, dtype)
    weights, state = inputs.split(weights_flat)
    batches = [(normalized(config, c[rows]).to(device), t[rows].to(device))
               for c, t in zip(contracts, targets)]
    followed = follow(inputs.network(config), weights, state, batches,
                      config["training"]["learning_rate"], dtype, shards)
    change = {k: followed.weights[k] - weights[k].float().cpu() for k in weights}
    return Side([c[rows] for c in contracts], sample_targets, followed.losses,
                followed.first_grads, change)


def program_side(contracts: list[torch.Tensor], targets: list[torch.Tensor], losses: list[float],
                 first_mu: dict[str, Any] | None, weights_after: dict[str, Any] | None,
                 weights_flat: dict[str, torch.Tensor], picked: list[tuple[int, int]]) -> Side:
    """The program's outputs: each checked step's contracts and targets, its
    losses, Adam's first moments after step 1 and the weights after the
    checked steps."""
    try:
        sample_targets = torch.stack([targets[s][r] for s, r in picked])
    except IndexError:
        sample_targets = torch.zeros(0)
    first = {k: torch.from_numpy(np.asarray(v, np.float32)) / (1.0 - ADAM_B1)
             for k, v in (first_mu or {}).items()}
    weights, _ = inputs.split(weights_flat)
    after = weights_after or {}
    change = {k: torch.from_numpy(np.asarray(after[k], np.float32)) - weights[k].float().cpu()
              for k in weights if k in after}
    return Side(contracts, sample_targets, losses[:CHECK_STEPS], first, change)


def numbers(config: dict[str, Any], seed: int, device: torch.device,
            weights_flat: dict[str, torch.Tensor], got: Side, targets: list[torch.Tensor],
            picked: list[tuple[int, int]], shards: int = 1) -> dict[str, float]:
    """Every number of the comparison (all infinite where the program's
    checked steps do not hold the batch they were asked for)."""
    batch = config["training"]["batch_size"]
    expected = [(batch, config["pricer"]["network_size"])] * CHECK_STEPS
    if [tuple(t.shape) for t in targets] != expected:
        return {name: float("inf") for name in NUMBERS}
    want = reference_side(config, seed, device, weights_flat, targets, picked, shards=shards)
    return compare(config, got, want)


def compare(config: dict[str, Any], got: Side, want: Side) -> dict[str, float]:
    lo, hi = inputs.bounds(config)
    span = (hi - lo).astype(np.float32)
    if len(got.contracts) != len(want.contracts):
        contracts_gap = float("inf")
    else:
        contracts_gap = max(checks.scaled_gap(g.numpy(), w.numpy(), span)
                            for g, w in zip(got.contracts, want.contracts))
    return {
        "contracts_gap": contracts_gap,
        "target_gap": checks.relative_rows_gap(got.sample_targets, want.sample_targets),
        "price_gap": checks.relative_rows_gap(got.sample_targets[..., :1],
                                              want.sample_targets[..., :1]),
        "loss_gap": checks.losses_gap(got.losses, want.losses),
        "grad_gap": checks.worst_leaf_gap(got.first_grads, want.first_grads),
        "change_gap": checks.worst_leaf_gap(got.change, want.change,
                                            checks.moving_leaves(want.first_grads)),
    }
