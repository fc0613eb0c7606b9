"""The reference's training steps: loss, gradients and Adam over given batches."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.cvnn import Network, adam_step, spectrum_loss


@dataclass
class Followed:
    losses: list[float]
    first_grads: dict[str, torch.Tensor]  # float32, on the host
    weights: dict[str, torch.Tensor]  # after the last step, float32, on the host


def follow(net: Network, weights: dict[str, torch.Tensor], state: dict[str, torch.Tensor],
           batches: list[tuple[torch.Tensor, torch.Tensor]], learning_rate: float,
           dtype: torch.dtype = torch.float32, shards: int = 1) -> Followed:
    """Train copies of ``weights`` on ``batches`` of ``(normalized inputs,
    complex targets)``, one Adam step each, all arithmetic in ``dtype``. With
    ``shards``, data-parallel training: the batch splits into equal shards,
    each through the network with its own batch statistics, and the loss is
    the mean of the shards' losses."""
    w = {k: v.detach().to(dtype).clone() for k, v in weights.items()}
    s = {k: v.detach().to(dtype).clone() for k, v in state.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    count, losses, first = 0, [], {}
    for inputs, targets in batches:
        leaves = {k: v.requires_grad_(True) for k, v in w.items()}
        loss = sum(spectrum_loss(net, leaves, s, x.to(dtype), t)
                   for x, t in zip(inputs.chunk(shards), targets.chunk(shards))) / shards
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        w = {k: v.detach() for k, v in leaves.items()}
        if not first:
            first = {k: g.float().cpu() for k, g in grads.items()}
        losses.append(float(loss.detach().float()))
        count = adam_step(w, grads, mu, nu, count, learning_rate)
    return Followed(losses, first, {k: v.float().cpu() for k, v in w.items()})
