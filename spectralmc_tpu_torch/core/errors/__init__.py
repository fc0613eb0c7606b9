"""Frozen error ADTs, one module per subsystem (the JAX package's
``core/errors``): failures are data carried in ``Result``, not exceptions.
The checkpoint wire format's and the storage layer's errors are exported
here too.
"""

from spectralmc_tpu_torch.core.errors.serialization import (
    ChecksumMismatch,
    DecodeError,
    DTypeMismatch,
    SerializationError,
    ShapeMismatch,
)
from spectralmc_tpu_torch.core.errors.storage import (
    AccessDenied,
    BucketNotFound,
    ChainError,
    ChainParseError,
    ChecksumError,
    NetworkError,
    NotFastForward,
    ObjectNotFound,
    PreconditionFailed,
    StorageError,
    StoreOpError,
    Throttled,
    UnknownStoreError,
    VersionNotFound,
)

__all__ = [
    "AccessDenied",
    "BucketNotFound",
    "ChainError",
    "ChainParseError",
    "ChecksumError",
    "ChecksumMismatch",
    "DTypeMismatch",
    "DecodeError",
    "NetworkError",
    "NotFastForward",
    "ObjectNotFound",
    "PreconditionFailed",
    "SerializationError",
    "ShapeMismatch",
    "StorageError",
    "StoreOpError",
    "Throttled",
    "UnknownStoreError",
    "VersionNotFound",
]

