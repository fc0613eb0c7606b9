"""Effect interpretation errors: the JAX package's ``effects/errors.py``, class for class."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class DeviceError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class MonteCarloError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class TrainingError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class StorageEffectError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class RNGError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class MetadataError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class LoggingError:
    effect_kind: str
    reason: str


@dataclass(frozen=True, slots=True)
class RegistryError:
    key: str
    reason: str


@dataclass(frozen=True, slots=True)
class UnknownEffect:
    type_name: str


EffectError = Union[
    DeviceError,
    MonteCarloError,
    TrainingError,
    StorageEffectError,
    RNGError,
    MetadataError,
    LoggingError,
    RegistryError,
    UnknownEffect,
]
