"""Functional core: Result ADT, error ADTs, precision policy, validation."""

from spectralmc_tpu_torch.core.precision import Precision, ReducedPrecision, real_dtype_of
from spectralmc_tpu_torch.core.result import (
    Failure,
    Result,
    Success,
    UnwrapError,
    collect_results,
    fold_results,
    partition_results,
)
from spectralmc_tpu_torch.core.validation import validate_model

__all__ = [
    "Failure",
    "Precision",
    "ReducedPrecision",
    "Result",
    "Success",
    "UnwrapError",
    "collect_results",
    "fold_results",
    "partition_results",
    "real_dtype_of",
    "validate_model",
]
