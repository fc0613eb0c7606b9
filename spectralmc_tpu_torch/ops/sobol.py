"""Scrambled Sobol contract sampler on torch tensors.

The port of the JAX package's ``ops/sobol.py``: the same Joe-Kuo direction
numbers (``_sobol_directions.py``), the same linear-matrix scramble plus
digital shift drawn from ``numpy.random.default_rng(seed)`` at init, and the
same uint32 points, bit for bit, for every ``(start, count)``.

Point ``n`` is the XOR of the direction columns selected by the bits of
``gray(n) = n ^ (n >> 1)``, XOR the shift. The JAX package assembles that
XOR from split tables to spare TPU vector work; the port computes the
defining XOR directly, one direction column at a time (32 passes over a
``[count, d]`` int64 tensor), which is the same GF(2) value and is small at
the trainer's batch sizes. uint32 words ride in int64.
"""

from __future__ import annotations

from typing import Generic, Mapping, Type, TypeVar

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors.sobol import (
    BoundsFieldMismatch,
    DimensionTooLarge,
    InvalidBounds,
    InvalidSkip,
    SobolError,
)
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.ops._sobol_directions import MAX_DIMENSION, M_INIT, POLY

BITS = 32

TModel = TypeVar("TModel", bound=BaseModel)


# --------------------------------------------------------------------------
# Direction numbers (host-side, once per sampler)
# --------------------------------------------------------------------------


def direction_numbers(dimension: int) -> np.ndarray:
    """``[dimension, BITS]`` uint32 direction numbers V_k = m_k << (BITS - k).

    Standard Joe-Kuo recurrence; dimension 0 is the van der Corput sequence
    (all m_k = 1).
    """
    if dimension > MAX_DIMENSION:
        raise ValueError(f"dimension {dimension} > MAX_DIMENSION {MAX_DIMENSION}")
    v = np.zeros((dimension, BITS), dtype=np.uint64)
    for j in range(dimension):
        poly = POLY[j]
        s = max(poly.bit_length() - 1, 0)
        if s == 0:  # first dimension: van der Corput
            m = [1] * BITS
        else:
            m = list(M_INIT[j][:s])
            # interior coefficients a_1..a_{s-1} of the primitive polynomial
            a = (poly - (1 << s) - 1) >> 1
            for k in range(s, BITS):
                new = m[k - s] ^ (m[k - s] << s)
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        new ^= m[k - i] << i
                m.append(new)
        for k in range(BITS):
            v[j, k] = np.uint64(m[k]) << np.uint64(BITS - 1 - k)
    return v.astype(np.uint32)


def lms_scramble(
    v: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Owen linear-matrix-scramble of direction numbers + digital shift.

    For each dimension draw a random lower-triangular (MSB-first) bit matrix L
    with unit diagonal and set V'_k = L·V_k over GF(2). The draws consume
    ``rng`` in the same order as the JAX package, so a seed gives the same
    scrambled table. Returns (scrambled ``[d, BITS]`` uint32, shift ``[d]``).
    """
    d = v.shape[0]
    shifts = np.arange(BITS - 1, -1, -1, dtype=np.uint32)  # bit 0 of axis = MSB
    vbits = ((v[:, None, :] >> shifts[None, :, None]) & 1).astype(np.uint8)
    lmat = np.tril(rng.integers(0, 2, size=(d, BITS, BITS), dtype=np.uint8), k=-1)
    lmat |= np.eye(BITS, dtype=np.uint8)[None, :, :]
    ybits = (lmat @ vbits) & 1
    weights = (np.uint32(1) << shifts).astype(np.uint32)
    scrambled = np.einsum("dik,i->dk", ybits.astype(np.uint64), weights.astype(np.uint64))
    shift = rng.integers(0, 1 << 32, size=(d,), dtype=np.uint32)
    return scrambled.astype(np.uint32), shift


# --------------------------------------------------------------------------
# Point generation (any device)
# --------------------------------------------------------------------------


def sobol_uint32(
    directions: torch.Tensor, shift: torch.Tensor, start: int, count: int
) -> torch.Tensor:
    """Raw scrambled Sobol points ``[count, d]`` (uint32 words in int64).

    ``directions`` is ``[d, BITS]`` and ``shift`` ``[d]``, both int64 tensors
    holding uint32 words.
    """
    n = start + torch.arange(count, dtype=torch.int64, device=directions.device)
    gray = (n ^ (n >> 1))[:, None]  # [count, 1]
    acc = shift[None, :].expand(count, -1).clone()
    for k in range(BITS):
        select = -((gray >> k) & 1)  # 0 or all ones
        acc ^= select & directions[None, :, k]
    return acc


def sobol_unit(
    directions: torch.Tensor,
    shift: torch.Tensor,
    start: int,
    count: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scrambled Sobol points in [0, 1) as ``[count, d]`` floats."""
    words = sobol_uint32(directions, shift, start, count)
    if dtype == torch.float64:
        return words.to(torch.float64) * 2.0**-32
    # float32: keep the top 24 bits so the mantissa is exact and u < 1.
    return (words >> 8).to(torch.float32) * 2.0**-24


def scale_to_bounds(
    unit: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor
) -> torch.Tensor:
    """Affine map of unit-cube points into per-column [lower, upper) bounds."""
    return lower[None, :] + unit * (upper - lower)[None, :]


# --------------------------------------------------------------------------
# Typed sampler over a pydantic model
# --------------------------------------------------------------------------


class BoundSpec(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    lower: float
    upper: float


def build_bound_spec(lower: float, upper: float) -> Result[BoundSpec, SobolError]:
    if not (np.isfinite(lower) and np.isfinite(upper)):
        return Failure(InvalidBounds(field="", lower=lower, upper=upper, reason="non-finite bound"))
    if lower >= upper:
        return Failure(
            InvalidBounds(field="", lower=lower, upper=upper, reason="lower must be < upper")
        )
    return Success(BoundSpec(lower=lower, upper=upper))


class DomainBounds(BaseModel):
    """Field-name → BoundSpec map; must exactly cover the target model's fields."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    bounds: Mapping[str, BoundSpec]


def build_domain_bounds(
    model_cls: Type[BaseModel], bounds: Mapping[str, BoundSpec]
) -> Result[DomainBounds, SobolError]:
    expected = tuple(model_cls.model_fields.keys())
    provided = tuple(bounds.keys())
    if set(expected) != set(provided):
        return Failure(
            BoundsFieldMismatch(
                expected=expected,
                provided=provided,
                reason="bounds must cover exactly the model's fields",
            )
        )
    for name, spec in bounds.items():
        checked = build_bound_spec(spec.lower, spec.upper)
        if isinstance(checked, Failure):
            return Failure(
                InvalidBounds(
                    field=name, lower=spec.lower, upper=spec.upper, reason=checked.error.reason
                )
            )
    return Success(DomainBounds(bounds=dict(bounds)))


class SobolConfig(BaseModel):
    """Seed + resume skip + scramble switch (the JAX package's ``SobolConfig``)."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    seed: int
    skip: int = 0
    scramble: bool = True


class SobolSampler(Generic[TModel]):
    """Quasi-random contract sampler; resume state is the explicit ``skip``."""

    def __init__(
        self,
        model_cls: Type[TModel],
        domain: DomainBounds,
        config: SobolConfig,
        directions_u32: np.ndarray,
        shift_u32: np.ndarray,
    ) -> None:
        self._model_cls = model_cls
        self._domain = domain
        self._config = config
        self._directions = directions_u32
        self._shift = shift_u32
        order = tuple(model_cls.model_fields.keys())
        self._lower = np.array([domain.bounds[f].lower for f in order], dtype=np.float64)
        self._upper = np.array([domain.bounds[f].upper for f in order], dtype=np.float64)

    @classmethod
    def create(
        cls,
        model_cls: Type[TModel],
        domain: Mapping[str, BoundSpec] | DomainBounds,
        config: SobolConfig,
    ) -> Result["SobolSampler[TModel]", SobolError]:
        if not isinstance(domain, DomainBounds):
            built = build_domain_bounds(model_cls, domain)
            if isinstance(built, Failure):
                return Failure(built.error)
            domain = built.value
        else:
            checked = build_domain_bounds(model_cls, domain.bounds)
            if isinstance(checked, Failure):
                return Failure(checked.error)
        dim = len(model_cls.model_fields)
        if dim > MAX_DIMENSION:
            return Failure(
                DimensionTooLarge(
                    dimension=dim, max_dimension=MAX_DIMENSION, reason="embed more Joe-Kuo data"
                )
            )
        if config.skip < 0:
            return Failure(InvalidSkip(skip=config.skip, reason="skip must be non-negative"))
        v = direction_numbers(dim)
        if config.scramble:
            v, shift = lms_scramble(v, np.random.default_rng(config.seed))
        else:
            shift = np.zeros((dim,), dtype=np.uint32)
        return Success(cls(model_cls, domain, config, v, shift))

    def with_skip(self, skip: int) -> "SobolSampler[TModel]":
        return SobolSampler(
            self._model_cls,
            self._domain,
            self._config.model_copy(update={"skip": skip}),
            self._directions,
            self._shift,
        )

    def device_table(self, device: torch.device | str) -> dict[str, torch.Tensor]:
        """Sampling constants on ``device``: directions, shift, bounds columns."""
        return {
            "directions": torch.as_tensor(self._directions.astype(np.int64), device=device),
            "shift": torch.as_tensor(self._shift.astype(np.int64), device=device),
            "lower": torch.as_tensor(self._lower, dtype=torch.float32, device=device),
            "upper": torch.as_tensor(self._upper, dtype=torch.float32, device=device),
        }

    def sample_array(
        self,
        count: int,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.float32,
        start: int | None = None,
    ) -> torch.Tensor:
        """``[count, d]`` scaled points from ``start`` (default: the skip)."""
        table = self.device_table(device)
        begin = self._config.skip if start is None else start
        unit = sobol_unit(table["directions"], table["shift"], begin, count, dtype)
        lower = torch.as_tensor(self._lower, dtype=dtype, device=device)
        upper = torch.as_tensor(self._upper, dtype=dtype, device=device)
        return scale_to_bounds(unit, lower, upper)
