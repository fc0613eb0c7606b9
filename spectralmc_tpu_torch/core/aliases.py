"""Shared type aliases: the typed names for the package's open containers.

* ``TensorTree`` — a nested dict of tensors (model parameters, batch-norm
  state, Adam moments) keyed by the JAX package's parameter paths.
"""

from __future__ import annotations

from typing import Any, TypeAlias

TensorTree: TypeAlias = Any

__all__ = ["TensorTree"]
