"""Errors for the CVNN factory (the JAX package's ``core/errors/cvnn.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class InvalidLayerConfig:
    layer_index: int
    kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class WidthMismatch:
    expected: int
    actual: int
    reason: str


@dataclass(frozen=True, slots=True)
class InvalidModelConfig:
    field: str
    reason: str


@dataclass(frozen=True, slots=True)
class StateDictMismatch:
    key: str
    reason: str


CVNNError = Union[InvalidLayerConfig, WidthMismatch, InvalidModelConfig, StateDictMismatch]
