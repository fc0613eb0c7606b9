"""Pydantic construction wrapped into Result (the JAX package's ``core/validation.py``)."""

from __future__ import annotations

from typing import Any, Mapping, Type, TypeVar

from pydantic import BaseModel, ValidationError

from spectralmc_tpu_torch.core.result import Failure, Result, Success

TModel = TypeVar("TModel", bound=BaseModel)


def validate_model(
    model_cls: Type[TModel], data: Mapping[str, Any]
) -> Result[TModel, ValidationError]:
    """Construct a pydantic model, returning ``Failure`` instead of raising."""
    try:
        return Success(model_cls.model_validate(dict(data)))
    except ValidationError as exc:
        return Failure(exc)
