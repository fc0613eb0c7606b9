"""Errors for the Sobol sampler (the JAX package's ``core/errors/sobol.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class InvalidBounds:
    field: str
    lower: float
    upper: float
    reason: str


@dataclass(frozen=True, slots=True)
class BoundsFieldMismatch:
    expected: tuple[str, ...]
    provided: tuple[str, ...]
    reason: str


@dataclass(frozen=True, slots=True)
class DimensionTooLarge:
    dimension: int
    max_dimension: int
    reason: str


@dataclass(frozen=True, slots=True)
class InvalidSkip:
    skip: int
    reason: str


SobolError = Union[InvalidBounds, BoundsFieldMismatch, DimensionTooLarge, InvalidSkip]
