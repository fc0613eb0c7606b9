"""Production inference client: pinned / tracking modes with hot swap.

The JAX package's ``storage/inference.py``: ``PinnedMode(counter)`` vs
``TrackingMode``; ``start()`` loads the pinned version or HEAD; tracking
mode runs an asyncio poll loop that hot-swaps the model snapshot (atomic
reference assignment) whenever ``head.counter`` advances; a circuit breaker
stops polling after ``max_consecutive_failures``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import TYPE_CHECKING, Union

from spectralmc_tpu_torch.core.errors.storage import StorageError, VersionNotFound
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.storage.chain import ModelVersion
from spectralmc_tpu_torch.storage.checkpoint import load_snapshot_from_checkpoint
from spectralmc_tpu_torch.storage.store import AsyncBlockchainModelStore

if TYPE_CHECKING:  # pragma: no cover — typing-only, breaks the import cycle
    from spectralmc_tpu_torch.training.trainer import GbmCVNNPricerConfig

logger = logging.getLogger(__name__)

DEFAULT_MAX_CONSECUTIVE_FAILURES = 5


@dataclass(frozen=True, slots=True)
class PinnedMode:
    counter: int

    def __post_init__(self) -> None:
        if self.counter < 0:
            raise ValueError("pinned counter must be >= 0")


@dataclass(frozen=True, slots=True)
class TrackingMode:
    pass


InferenceMode = Union[PinnedMode, TrackingMode]


@dataclass(frozen=True)
class LoadedModel:
    """What ``get_model`` hands out: the config snapshot + its provenance."""

    version: ModelVersion
    config: "GbmCVNNPricerConfig"


class InferenceClient:
    """Serves the latest (or a pinned) committed model.

    The client holds configs; build a pricer from one with
    ``GbmCVNNPricer.create(loaded.config, device=...)``. An async context
    manager::

        async with InferenceClient(store, TrackingMode()) as client:
            loaded = client.get_model()
    """

    def __init__(
        self,
        store: AsyncBlockchainModelStore,
        mode: InferenceMode,
        *,
        poll_interval: float = 5.0,
        max_consecutive_failures: int = DEFAULT_MAX_CONSECUTIVE_FAILURES,
    ) -> None:
        self._store = store
        self._mode = mode
        self._poll_interval = poll_interval
        self._max_failures = max_consecutive_failures
        self._current: LoadedModel | None = None
        self._poll_task: asyncio.Task[None] | None = None
        self._stopped = asyncio.Event()
        self.consecutive_failures = 0
        self.circuit_open = False

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> Result[LoadedModel, StorageError]:
        if isinstance(self._mode, PinnedMode):
            version = await self._store.get_version(self._mode.counter)
            if isinstance(version, Failure):
                return Failure(version.error)
            loaded = await self._load(version.value)
            if isinstance(loaded, Failure):
                return Failure(loaded.error)
        else:
            head = await self._store.get_head()
            if isinstance(head, Failure):
                return Failure(head.error)
            if head.value is None:
                return Failure(
                    VersionNotFound(identifier="HEAD", reason="chain is empty")
                )
            loaded = await self._load(head.value)
            if isinstance(loaded, Failure):
                return Failure(loaded.error)
            self._poll_task = asyncio.create_task(self._poll_loop())
        assert self._current is not None
        return Success(self._current)

    async def stop(self) -> None:
        self._stopped.set()
        if self._poll_task is not None:
            self._poll_task.cancel()
            try:
                await self._poll_task
            except asyncio.CancelledError:
                pass
            self._poll_task = None

    async def __aenter__(self) -> "InferenceClient":
        result = await self.start()
        if isinstance(result, Failure):
            raise RuntimeError(f"inference client start failed: {result.error!r}")
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.stop()

    # -- serving ---------------------------------------------------------------

    def get_model(self) -> LoadedModel | None:
        """Current snapshot — a plain attribute read, safe to call from any task."""
        return self._current

    async def _load(self, version: ModelVersion) -> Result[LoadedModel, StorageError]:
        config = await load_snapshot_from_checkpoint(self._store, version)
        if isinstance(config, Failure):
            return Failure(config.error)
        loaded = LoadedModel(version=version, config=config.value)
        self._current = loaded  # atomic reference swap
        return Success(loaded)

    # -- tracking loop -----------------------------------------------------------

    async def _poll_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(self._stopped.wait(), timeout=self._poll_interval)
                return  # stopped
            except asyncio.TimeoutError:
                pass
            try:
                head = await self._store.get_head()
                if isinstance(head, Failure) or head.value is None:
                    raise RuntimeError(f"head fetch failed: {getattr(head, 'error', None)!r}")
                current = self._current
                if current is None or head.value.counter > current.version.counter:
                    loaded = await self._load(head.value)
                    if isinstance(loaded, Failure):
                        raise RuntimeError(f"hot swap failed: {loaded.error!r}")
                    logger.info("hot-swapped to version %s", head.value.version_id)
                self.consecutive_failures = 0
            except Exception as exc:  # noqa: BLE001 — poll must survive anything
                self.consecutive_failures += 1
                logger.warning(
                    "poll failure %d/%d: %s",
                    self.consecutive_failures,
                    self._max_failures,
                    exc,
                )
                if self.consecutive_failures >= self._max_failures:
                    self.circuit_open = True
                    logger.error("circuit breaker open — tracking stopped")
                    return
