"""Errors for the trainer (the JAX package's ``core/errors/trainer.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True, slots=True)
class InvalidTrainingConfig:
    field: str
    value: object
    reason: str


@dataclass(frozen=True, slots=True)
class CommitPlanMismatch:
    reason: str


@dataclass(frozen=True, slots=True)
class NonFiniteLoss:
    step: int
    loss: float
    reason: str


@dataclass(frozen=True, slots=True)
class CheckpointMismatch:
    field: str
    reason: str


@dataclass(frozen=True, slots=True)
class EngineMismatch:
    """A config's recorded MC engine cannot be honored by this package.

    The engines draw different bit streams (threefry ``"xla"``, the TPU
    hardware PRNG ``"pallas"``, Philox ``"cuda"``), so running a config on an
    engine other than the one it names would silently change the normals.
    The port has no ``"pallas"`` stream, so such configs fail here.
    """

    requested: str
    effective: str
    reason: str


TrainerError = Union[
    InvalidTrainingConfig, CommitPlanMismatch, NonFiniteLoss, CheckpointMismatch, EngineMismatch
]
