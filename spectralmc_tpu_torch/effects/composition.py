"""Effect composition: the JAX package's ``effects/composition.py``.

``EffectSequence`` threads results through an optional continuation;
``EffectParallel`` gathers with an optional combiner; ``map_effect`` is the
functor over a single effect's result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from spectralmc_tpu_torch.core.aliases import EffectResult
from spectralmc_tpu_torch.effects.types import Effect


@dataclass(frozen=True)
class EffectSequence:
    effects: tuple[Effect, ...]
    continuation: Callable[[tuple[EffectResult, ...]], EffectResult] | None = None


@dataclass(frozen=True)
class EffectParallel:
    effects: tuple[Effect, ...]
    combiner: Callable[[tuple[EffectResult, ...]], EffectResult] | None = None


@dataclass(frozen=True)
class MappedEffect:
    effect: Effect
    fn: Callable[[EffectResult], EffectResult] = field(repr=False, default=lambda x: x)


def sequence_effects(
    effects: Sequence[Effect],
    continuation: Callable[[tuple[EffectResult, ...]], EffectResult] | None = None,
) -> EffectSequence:
    return EffectSequence(effects=tuple(effects), continuation=continuation)


def parallel_effects(
    effects: Sequence[Effect],
    combiner: Callable[[tuple[EffectResult, ...]], EffectResult] | None = None,
) -> EffectParallel:
    return EffectParallel(effects=tuple(effects), combiner=combiner)


def map_effect(effect: Effect, fn: Callable[[EffectResult], EffectResult]) -> MappedEffect:
    return MappedEffect(effect=effect, fn=fn)
