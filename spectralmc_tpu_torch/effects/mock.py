"""MockInterpreter — records effects without executing.

The JAX package's ``effects/mock.py``: programmable ``mock_results`` per
effect type, recording of every interpreted effect, and the assertion
helpers (``assert_effect_sequence``, ``assert_effect_count``,
``assert_contains``). Effect-producing code is unit-tested with it with no
device and no store.
"""

from __future__ import annotations

from typing import Type

from spectralmc_tpu_torch.core.aliases import EffectResult
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.effects.composition import EffectParallel, EffectSequence, MappedEffect
from spectralmc_tpu_torch.effects.errors import EffectError
from spectralmc_tpu_torch.effects.types import Effect


class MockInterpreter:
    def __init__(self, mock_results: dict[Type[object], EffectResult] | None = None) -> None:
        self.recorded: list[Effect] = []
        self.mock_results: dict[Type[object], EffectResult] = dict(mock_results or {})

    async def interpret(self, effect: Effect | MappedEffect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, MappedEffect):
            inner = await self.interpret(effect.effect)
            assert isinstance(inner, Success)
            return Success(effect.fn(inner.value))
        self.recorded.append(effect)
        result = self.mock_results.get(type(effect))
        if isinstance(result, (Success, Failure)):
            return result  # pre-wrapped Result
        return Success(result)

    async def interpret_sequence(self, sequence: EffectSequence) -> Result[EffectResult, EffectError]:
        results: list[EffectResult] = []
        for effect in sequence.effects:
            result = await self.interpret(effect)
            if not isinstance(result, Success):
                return result
            results.append(result.value)
        if sequence.continuation is not None:
            return Success(sequence.continuation(tuple(results)))
        return Success(tuple(results))

    async def interpret_parallel(self, parallel: EffectParallel) -> Result[EffectResult, EffectError]:
        results: list[EffectResult] = []
        for effect in parallel.effects:
            result = await self.interpret(effect)
            if not isinstance(result, Success):
                return result
            results.append(result.value)
        values = tuple(results)
        if parallel.combiner is not None:
            return Success(parallel.combiner(values))
        return Success(values)

    # -- assertion helpers -------------------------------------------------------

    def assert_effect_sequence(self, expected_types: list[Type[object]]) -> None:
        actual = [type(e) for e in self.recorded]
        assert actual == expected_types, f"effect sequence {actual} != {expected_types}"

    def assert_effect_count(self, effect_type: Type[object], count: int) -> None:
        actual = sum(isinstance(e, effect_type) for e in self.recorded)
        assert actual == count, f"{effect_type.__name__} count {actual} != {count}"

    def assert_contains(self, effect: Effect) -> None:
        assert effect in self.recorded, f"{effect!r} not in recorded effects"

    def clear(self) -> None:
        self.recorded.clear()
