"""Precision policy — the single source of truth for dtypes.

The same ``Precision`` enum as the JAX package's ``core/precision.py`` (so a
checkpoint's precision field maps 1:1), with maps to ``torch`` and ``numpy``
dtypes. PyTorch has float64 everywhere, so there is no x64 switch to check;
``validate_available`` is kept as the seam the builders call.

``ReducedPrecision`` is the storage-only tier (``bfloat16``, ``float16``):
legal for checkpoint payloads and activations, never as a Monte-Carlo dtype.
numpy has no bfloat16, so a bfloat16 payload decodes to a torch tensor
(``serialization/converters.py::tensor_from_proto``).
"""

from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch

from spectralmc_tpu_torch.core.errors.precision import PrecisionError
from spectralmc_tpu_torch.core.result import Failure, Result, Success


class Precision(enum.Enum):
    """Full-precision dtypes legal for Monte-Carlo simulation and training."""

    float32 = "float32"
    float64 = "float64"
    complex64 = "complex64"
    complex128 = "complex128"

    # --- dtype maps (O(1), loss-free) -------------------------------------

    def to_torch(self) -> torch.dtype:
        return _TORCH_MAP[self]

    def to_np(self) -> np.dtype:
        return np.dtype(self.value)

    @classmethod
    def from_np(cls, dtype: np.dtype) -> "Result[Precision, PrecisionError]":
        key = np.dtype(dtype).name
        try:
            return Success(cls(key))
        except ValueError:
            return Failure(PrecisionError(dtype=key, reason="not a full-precision dtype"))

    # --- float <-> complex bijection --------------------------------------

    def is_complex(self) -> bool:
        return self in (Precision.complex64, Precision.complex128)

    def to_complex(self) -> "Precision":
        return {
            Precision.float32: Precision.complex64,
            Precision.float64: Precision.complex128,
            Precision.complex64: Precision.complex64,
            Precision.complex128: Precision.complex128,
        }[self]

    def from_complex(self) -> "Precision":
        return {
            Precision.complex64: Precision.float32,
            Precision.complex128: Precision.float64,
            Precision.float32: Precision.float32,
            Precision.float64: Precision.float64,
        }[self]

    def validate_available(self) -> "Result[Precision, PrecisionError]":
        """Every full precision is available under PyTorch."""
        return Success(self)


_TORCH_MAP = {
    Precision.float32: torch.float32,
    Precision.float64: torch.float64,
    Precision.complex64: torch.complex64,
    Precision.complex128: torch.complex128,
}


class ReducedPrecision(enum.Enum):
    """Storage/activation-only dtypes; never legal as an MC dtype."""

    bfloat16 = "bfloat16"
    float16 = "float16"

    def to_torch(self) -> torch.dtype:
        return torch.bfloat16 if self is ReducedPrecision.bfloat16 else torch.float16


AnyPrecision = Union[Precision, ReducedPrecision]


def real_dtype_of(precision: Precision) -> torch.dtype:
    """The real torch dtype backing a (possibly complex) precision."""
    return precision.from_complex().to_torch()
