"""Errors for the deterministic key-stream (the JAX package's ``core/errors/rng.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class InvalidShape:
    rows: int
    cols: int
    reason: str


@dataclass(frozen=True, slots=True)
class SeedOutOfRange:
    seed: int
    reason: str


@dataclass(frozen=True, slots=True)
class InvalidCounter:
    counter: int
    reason: str


RngError = Union[InvalidShape, SeedOutOfRange, InvalidCounter]
