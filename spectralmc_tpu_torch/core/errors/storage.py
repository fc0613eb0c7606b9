"""Errors for the storage layer (the JAX package's ``core/errors/storage.py``).

The object-store errors classify backend failures (missing bucket or object,
denied, throttled, network); the chain errors cover compare-and-swap
conflicts and corruption.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


# --- object-store operation errors ---------------------------------------


@dataclass(frozen=True, slots=True)
class BucketNotFound:
    bucket: str


@dataclass(frozen=True, slots=True)
class ObjectNotFound:
    bucket: str
    key: str


@dataclass(frozen=True, slots=True)
class AccessDenied:
    bucket: str
    key: str
    reason: str


@dataclass(frozen=True, slots=True)
class PreconditionFailed:
    bucket: str
    key: str
    expected_etag: str


@dataclass(frozen=True, slots=True)
class Throttled:
    bucket: str
    key: str
    code: str


@dataclass(frozen=True, slots=True)
class NetworkError:
    bucket: str
    key: str
    reason: str


@dataclass(frozen=True, slots=True)
class UnknownStoreError:
    bucket: str
    key: str
    reason: str


StoreOpError = Union[
    BucketNotFound,
    ObjectNotFound,
    AccessDenied,
    PreconditionFailed,
    Throttled,
    NetworkError,
    UnknownStoreError,
]


# --- chain-level errors ----------------------------------------------------


@dataclass(frozen=True, slots=True)
class NotFastForward:
    head_counter: int
    expected_counter: int
    reason: str


@dataclass(frozen=True, slots=True)
class ChainParseError:
    key: str
    reason: str


@dataclass(frozen=True, slots=True)
class VersionNotFound:
    identifier: str
    reason: str


@dataclass(frozen=True, slots=True)
class ChecksumError:
    expected: str
    actual: str


ChainError = Union[NotFastForward, ChainParseError, VersionNotFound, ChecksumError]
StorageError = Union[StoreOpError, ChainError]
