"""Adam, written out as optax computes it, and its typed checkpoint state.

``AdamStateSnapshot`` is the JAX package's schema (``training/adam_state.py``
there): ``mu``/``nu`` moment maps keyed by parameter path (the
``model_state`` keys without their ``params/`` prefix), the shared step
``count`` and a ``schema_version``. A JAX snapshot's fields, as numpy arrays,
resume here unchanged.

``adam_update_`` is optax's ``adam`` — ``scale_by_adam`` chained with
``scale_by_learning_rate`` — step by step, not ``torch.optim.Adam`` (whose
bias correction is arranged differently and so rounds differently):

    mu    = (1 − b1)·g + b1·mu
    nu    = (1 − b2)·g² + b2·nu
    count = count + 1
    u     = (mu / (1 − b1^count)) / (sqrt(nu / (1 − b2^count)) + eps)
    p     = p + (−lr(count − 1))·u

with every tensor op in float32 and the bias corrections formed in float64
and rounded once (the JAX package's tests run with x64 on, where optax does
the same). ``warmup_cosine_rate`` is optax's ``warmup_cosine_decay_schedule``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

ADAM_SCHEMA_VERSION = 1
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

_LEGACY_COUNT_KEY = "opt/0/.count"
_LEGACY_MU_PREFIX = "opt/0/.mu/"
_LEGACY_NU_PREFIX = "opt/0/.nu/"


@dataclass(frozen=True)
class AdamStateSnapshot:
    """Named Adam moments keyed by parameter path + the shared step count."""

    mu: Mapping[str, np.ndarray]
    nu: Mapping[str, np.ndarray]
    count: int
    schema_version: int = field(default=ADAM_SCHEMA_VERSION)

    def __post_init__(self) -> None:
        if set(self.mu) != set(self.nu):
            raise ValueError(
                f"mu/nu parameter sets differ: {sorted(set(self.mu) ^ set(self.nu))}"
            )
        if self.schema_version != ADAM_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported adam schema_version {self.schema_version} "
                f"(this build reads v{ADAM_SCHEMA_VERSION})"
            )


def migrate_legacy_flat(flat: Mapping[str, np.ndarray]) -> AdamStateSnapshot:
    """Upgrade a positional ``opt/0/.{count,mu,nu}`` map to the named schema."""
    if _LEGACY_COUNT_KEY not in flat:
        raise KeyError(
            f"legacy adam state missing {_LEGACY_COUNT_KEY!r}; keys={sorted(flat)[:5]}"
        )
    mu = {k[len(_LEGACY_MU_PREFIX):]: np.asarray(v) for k, v in flat.items()
          if k.startswith(_LEGACY_MU_PREFIX)}
    nu = {k[len(_LEGACY_NU_PREFIX):]: np.asarray(v) for k, v in flat.items()
          if k.startswith(_LEGACY_NU_PREFIX)}
    return AdamStateSnapshot(mu=mu, nu=nu, count=int(np.asarray(flat[_LEGACY_COUNT_KEY])))


def coerce_optimizer_state(
    state: "AdamStateSnapshot | Mapping[str, np.ndarray] | None",
) -> AdamStateSnapshot | None:
    """Accept either schema (typed v1 or legacy flat map) and return v1."""
    if state is None or isinstance(state, AdamStateSnapshot):
        return state
    return migrate_legacy_flat(state)


@dataclass
class AdamState:
    """Live moments on the parameters' device, keyed by parameter path."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int

    @classmethod
    def zeros_like(cls, params: Mapping[str, torch.Tensor]) -> "AdamState":
        return cls(
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
            count=0,
        )

    @classmethod
    def restore(
        cls, params: Mapping[str, torch.Tensor], snapshot: AdamStateSnapshot
    ) -> "AdamState":
        """Reattach checkpointed moments; a moment set that does not match
        the model fails with a named KeyError."""

        def place(named: Mapping[str, np.ndarray], key: str, like: torch.Tensor) -> torch.Tensor:
            if key not in named:
                raise KeyError(f"adam state missing moment for parameter {key!r}")
            t = torch.as_tensor(np.array(named[key]), dtype=like.dtype, device=like.device)
            return t.reshape(like.shape).clone()

        return cls(
            mu={k: place(snapshot.mu, k, p) for k, p in params.items()},
            nu={k: place(snapshot.nu, k, p) for k, p in params.items()},
            count=snapshot.count,
        )

    def snapshot(self) -> AdamStateSnapshot:
        return AdamStateSnapshot(
            mu={k: v.detach().cpu().numpy().copy() for k, v in self.mu.items()},
            nu={k: v.detach().cpu().numpy().copy() for k, v in self.nu.items()},
            count=self.count,
        )


def warmup_cosine_rate(
    count: int, *, peak: float, warmup_steps: int, decay_steps: int, end_value: float
) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup, decay, end)`` at ``count``."""
    if count < warmup_steps:  # linear warmup from 0 (optax's polynomial_schedule, power 1)
        frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
        return (0.0 - peak) * frac + peak
    alpha = 0.0 if peak == 0.0 else end_value / peak
    span = decay_steps - warmup_steps
    t = min(float(count - warmup_steps), float(span))
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
    return peak * ((1.0 - alpha) * cosine + alpha)


@torch.no_grad()
def adam_update_(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamState,
    learning_rate: float,
) -> None:
    """One optax Adam step, in place on ``params`` and ``state``.

    ``learning_rate`` is the rate for the step count BEFORE this update (the
    schedule's position), as optax's ``scale_by_schedule`` applies it.
    """
    count = state.count + 1
    bc1 = float(np.float32(1.0 - ADAM_B1**count))
    bc2 = float(np.float32(1.0 - ADAM_B2**count))
    step = float(np.float32(-learning_rate))
    for key, p in params.items():
        g = grads[key]
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[key]
        nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[key]
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        p.add_(step * update)
        state.mu[key] = mu
        state.nu[key] = nu
    state.count = count
