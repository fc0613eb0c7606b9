"""Errors for the GBM simulator (the JAX package's ``core/errors/gbm.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class InvalidSimulationParams:
    field: str
    value: object
    reason: str


@dataclass(frozen=True, slots=True)
class MemoryLimitExceeded:
    total_paths: int
    limit: int
    dtype: str
    reason: str


@dataclass(frozen=True, slots=True)
class InvalidContract:
    field: str
    value: float
    reason: str


GBMError = Union[InvalidSimulationParams, MemoryLimitExceeded, InvalidContract]
