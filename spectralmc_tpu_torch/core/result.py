"""Rust-style ``Result`` ADT used for all expected-failure control flow.

The same ADT as the JAX package's ``core/result.py``: ``Success``/``Failure``
variants, monadic ``map``/``and_then``, ``collect_results`` (first failure
wins), ``partition_results`` and ``fold_results`` (early-exit fold — the
training-loop fold). The Result layer is pure host-side Python; tensor code
returns plain tensors and the host wraps outcomes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, Iterable, NoReturn, TypeVar, Union

T = TypeVar("T")
U = TypeVar("U")
E = TypeVar("E")
F = TypeVar("F")
S = TypeVar("S")
X = TypeVar("X")


@dataclass(frozen=True, slots=True)
class Success(Generic[T, E]):
    """Successful outcome carrying ``value``."""

    value: T

    def is_success(self) -> bool:
        return True

    def is_failure(self) -> bool:
        return False

    def map(self, fn: Callable[[T], U]) -> "Result[U, E]":
        return Success(fn(self.value))

    def map_err(self, fn: Callable[[E], F]) -> "Result[T, F]":
        return Success(self.value)

    def and_then(self, fn: Callable[[T], "Result[U, E]"]) -> "Result[U, E]":
        return fn(self.value)

    # Alias kept for parity with the reference's monadic naming.
    flat_map = and_then

    def or_else(self, fn: Callable[[E], "Result[T, F]"]) -> "Result[T, F]":
        return Success(self.value)

    def unwrap_or(self, default: T) -> T:
        return self.value

    def unwrap_or_else(self, fn: Callable[[E], T]) -> T:
        return self.value

    def expect(self, message: str) -> T:
        return self.value


@dataclass(frozen=True, slots=True)
class Failure(Generic[T, E]):
    """Failed outcome carrying ``error``."""

    error: E

    def is_success(self) -> bool:
        return False

    def is_failure(self) -> bool:
        return True

    def map(self, fn: Callable[[T], U]) -> "Result[U, E]":
        return Failure(self.error)

    def map_err(self, fn: Callable[[E], F]) -> "Result[T, F]":
        return Failure(fn(self.error))

    def and_then(self, fn: Callable[[T], "Result[U, E]"]) -> "Result[U, E]":
        return Failure(self.error)

    flat_map = and_then

    def or_else(self, fn: Callable[[E], "Result[T, F]"]) -> "Result[T, F]":
        return fn(self.error)

    def unwrap_or(self, default: T) -> T:
        return default

    def unwrap_or_else(self, fn: Callable[[E], T]) -> T:
        return fn(self.error)

    def expect(self, message: str) -> NoReturn:
        raise UnwrapError(f"{message}: {self.error!r}")


Result = Union[Success[T, E], Failure[T, E]]


class UnwrapError(RuntimeError):
    """Raised when ``expect`` is called on a ``Failure``."""


def collect_results(results: Iterable[Result[T, E]]) -> Result[tuple[T, ...], E]:
    """Collect an iterable of results into one; first ``Failure`` wins."""
    values: list[T] = []
    for res in results:
        if isinstance(res, Failure):
            return Failure(res.error)
        values.append(res.value)
    return Success(tuple(values))


def partition_results(
    results: Iterable[Result[T, E]],
) -> tuple[tuple[T, ...], tuple[E, ...]]:
    """Split results into (successes, failures), preserving order."""
    values: list[T] = []
    errors: list[E] = []
    for res in results:
        if isinstance(res, Success):
            values.append(res.value)
        else:
            errors.append(res.error)
    return tuple(values), tuple(errors)


def fold_results(
    items: Iterable[X],
    step: Callable[[S, X], Result[S, E]],
    initial: S,
) -> Result[S, E]:
    """Early-exit fold: thread state through ``step``; stop on first Failure.

    This is the host-side shape of segmented training loops.
    """
    state = initial
    for item in items:
        res = step(state, item)
        if isinstance(res, Failure):
            return Failure(res.error)
        state = res.value
    return Success(state)
