"""Errors for the checkpoint wire format (the JAX package's
``core/errors/serialization.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class ChecksumMismatch:
    expected: str
    actual: str
    reason: str


@dataclass(frozen=True, slots=True)
class DecodeError:
    what: str
    reason: str


@dataclass(frozen=True, slots=True)
class DTypeMismatch:
    expected: str
    actual: str
    reason: str


@dataclass(frozen=True, slots=True)
class ShapeMismatch:
    expected: tuple[int, ...]
    actual: tuple[int, ...]
    reason: str


SerializationError = Union[ChecksumMismatch, DecodeError, DTypeMismatch, ShapeMismatch]
