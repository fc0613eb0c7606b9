"""Deterministic throttle-retry engine.

The JAX package's ``storage/retry.py``: ``retry_on_throttle`` with a schedule computed up-front
(``min(base * 2^n, max)``), an explicit control ADT
(RetryScheduled/RetryExhausted/RetryGiveUp), retrying throttle errors and
giving up immediately on precondition failures and non-retryables.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Awaitable, Callable, TypeVar, Union

from spectralmc_tpu_torch.core.errors.storage import PreconditionFailed, StoreOpError, Throttled
from spectralmc_tpu_torch.core.result import Failure, Result

T = TypeVar("T")


@dataclass(frozen=True, slots=True)
class RetryScheduled:
    attempt: int
    delay_seconds: float


@dataclass(frozen=True, slots=True)
class RetryExhausted:
    attempts: int
    last_error: StoreOpError


@dataclass(frozen=True, slots=True)
class RetryGiveUp:
    error: StoreOpError
    reason: str


RetryDecision = Union[RetryScheduled, RetryExhausted, RetryGiveUp]


def retry_schedule(base: float, maximum: float, attempts: int) -> tuple[float, ...]:
    """The full backoff schedule, computed up front (deterministic)."""
    return tuple(min(base * (2.0**n), maximum) for n in range(attempts))


def decide_retry(
    error: StoreOpError, attempt: int, schedule: tuple[float, ...]
) -> RetryDecision:
    """Pure retry policy: throttles retry per schedule; CAS failures give up."""
    if isinstance(error, PreconditionFailed):
        return RetryGiveUp(
            error=error, reason="CAS precondition failed — caller must re-read"
        )
    if not isinstance(error, Throttled):
        return RetryGiveUp(error=error, reason="non-retryable error class")
    if attempt >= len(schedule):
        return RetryExhausted(attempts=attempt, last_error=error)
    return RetryScheduled(attempt=attempt, delay_seconds=schedule[attempt])


async def retry_on_throttle(
    op: Callable[[], Awaitable[Result[T, StoreOpError]]],
    *,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    max_attempts: int = 5,
) -> Result[T, StoreOpError]:
    """Run ``op`` retrying throttles with the precomputed schedule."""
    schedule = retry_schedule(base_delay, max_delay, max_attempts)
    attempt = 0
    while True:
        result = await op()
        if not isinstance(result, Failure):
            return result
        decision = decide_retry(result.error, attempt, schedule)
        if isinstance(decision, (RetryGiveUp, RetryExhausted)):
            return result
        await asyncio.sleep(decision.delay_seconds)
        attempt += 1
