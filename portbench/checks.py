"""The numbers that decide ``correct``, each against a limit of its own.

Every number is a gap between what the program produced and what the plain
reference works out from the same inputs; a gap that cannot be read (a
missing answer, a shape that differs, a NaN) reads infinity.
"""

from __future__ import annotations

import math
import statistics
import sys
from dataclasses import dataclass

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
NOUGHT_GRADIENT = 1e-3


@dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def scaled_gap(got: np.ndarray, want: np.ndarray, scale: np.ndarray | float) -> float:
    """``max |got − want| / scale`` (inf where the shapes differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    return _finite(float(np.max(np.abs(got - want) / scale)))


def relative_rows_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's ``‖got − want‖ / ‖want‖`` (rows of complex spectra)."""
    if got.shape != want.shape:
        return math.inf
    num = torch.linalg.vector_norm((got - want).to(torch.complex128), dim=-1)
    den = torch.linalg.vector_norm(want.to(torch.complex128), dim=-1)
    return _finite(float(torch.max(num / den)))


def losses_gap(got: list[float], want: list[float]) -> float:
    if len(got) != len(want):
        return math.inf
    return _finite(max(abs(g - w) / abs(w) for g, w in zip(got, want)))


def worst_leaf_gap(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor],
                   leaves: list[str] | None = None) -> float:
    """The worst leaf's gap of norms, ``|‖got‖ − ‖want‖|``, over the larger of
    that leaf's reference norm and the median leaf's."""
    if set(got) != set(want):
        return math.inf
    keys = sorted(want) if leaves is None else leaves
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    median = statistics.median(norms.values())
    gaps = [abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k]) / max(norms[k], median)
            for k in keys]
    return _finite(max(gaps)) if gaps else math.inf


def moving_leaves(first_grads: dict[str, torch.Tensor]) -> list[str]:
    """Leaves whose reference first gradient is not nought to rounding."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in first_grads.items()}
    median = statistics.median(norms.values())
    return sorted(k for k, n in norms.items() if n >= NOUGHT_GRADIENT * median)


def report(checks: list[Check]) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
