"""Shared type aliases: the typed names for the package's open containers.

* ``TensorTree`` — a nested dict of tensors (model parameters, batch-norm
  state, Adam moments) keyed by the JAX package's parameter paths.
* ``EffectResult`` — the open union of values the effect interpreters
  produce (a registry key, a count, a ``ModelVersion``, a counters dict).
"""

from __future__ import annotations

from typing import Any, TypeAlias

TensorTree: TypeAlias = Any
EffectResult: TypeAlias = Any

__all__ = ["EffectResult", "TensorTree"]
