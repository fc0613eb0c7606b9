"""Errors for the precision policy (the JAX package's ``core/errors/precision.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class PrecisionError:
    dtype: str
    reason: str


@dataclass(frozen=True, slots=True)
class X64Disabled:
    dtype: str
    reason: str


NumericalError = Union[PrecisionError, X64Disabled]
