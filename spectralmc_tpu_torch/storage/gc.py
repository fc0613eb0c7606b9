"""Garbage collection of old versions.

The JAX package's ``storage/gc.py``:
``RetentionPolicy{keep_versions, keep_min_versions, protect_counters}``, genesis
always protected, the PreviewGC/ExecuteGC mode ADT, size estimation, batch
delete, and a ``GCReport``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Union

from spectralmc_tpu_torch.core.errors.storage import StorageError
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.storage.chain import ModelVersion
from spectralmc_tpu_torch.storage.store import (
    GC_LOG_PREFIX,
    VERSIONS_PREFIX,
    AsyncBlockchainModelStore,
)


@dataclass(frozen=True, slots=True)
class RetentionPolicy:
    keep_versions: int
    keep_min_versions: int = 3
    protect_counters: tuple[int, ...] = ()

    def effective_keep(self) -> int:
        return max(self.keep_versions, self.keep_min_versions)


@dataclass(frozen=True, slots=True)
class PreviewGC:
    pass


@dataclass(frozen=True, slots=True)
class ExecuteGC:
    pass


GCMode = Union[PreviewGC, ExecuteGC]


@dataclass(frozen=True)
class GCReport:
    deleted: tuple[int, ...]
    protected: tuple[int, ...]
    bytes_freed: int
    dry_run: bool
    details: tuple[str, ...] = field(default_factory=tuple)


def plan_gc(
    versions: tuple[ModelVersion, ...], policy: RetentionPolicy
) -> tuple[tuple[ModelVersion, ...], tuple[ModelVersion, ...]]:
    """Pure split (to_delete, protected). Genesis (counter 0) is always protected."""
    keep = policy.effective_keep()
    newest = {v.counter for v in versions[-keep:]} if keep > 0 else set()
    protected_set = newest | {0} | set(policy.protect_counters)
    to_delete = tuple(v for v in versions if v.counter not in protected_set)
    protected = tuple(v for v in versions if v.counter in protected_set)
    return to_delete, protected


class GarbageCollector:
    def __init__(self, store: AsyncBlockchainModelStore, policy: RetentionPolicy) -> None:
        self._store = store
        self._policy = policy

    async def run(self, mode: GCMode) -> Result[GCReport, StorageError]:
        versions = await self._store.list_versions()
        if isinstance(versions, Failure):
            return Failure(versions.error)
        to_delete, protected = plan_gc(versions.value, self._policy)

        bytes_freed = 0
        details: list[str] = []
        object_store = self._store.object_store
        for version in to_delete:
            prefix = f"{VERSIONS_PREFIX}{version.directory_name}/"
            keys = await object_store.list(prefix)
            if isinstance(keys, Failure):
                return Failure(keys.error)
            if isinstance(mode, ExecuteGC):
                # Tombstone FIRST (crash-safe ordering): the chain skeleton —
                # counter/semver/hash links — survives the payload deletion,
                # so verification can prove the gap is GC, not tampering.
                tombstone = json.dumps(version.model_dump(), sort_keys=True).encode()
                written = await object_store.put(
                    f"{GC_LOG_PREFIX}{version.directory_name}.json", tombstone
                )
                if isinstance(written, Failure):
                    return Failure(written.error)
            for key in keys.value:
                head = await object_store.head(key)
                if isinstance(head, Success):
                    bytes_freed += head.value[0]
                if isinstance(mode, ExecuteGC):
                    deleted = await object_store.delete(key)
                    if isinstance(deleted, Failure):
                        return Failure(deleted.error)
            details.append(f"{version.directory_name}: {len(keys.value)} objects")

        return Success(
            GCReport(
                deleted=tuple(v.counter for v in to_delete),
                protected=tuple(v.counter for v in protected),
                bytes_freed=bytes_freed,
                dry_run=isinstance(mode, PreviewGC),
                details=tuple(details),
            )
        )


async def run_gc(
    store: AsyncBlockchainModelStore, policy: RetentionPolicy, mode: GCMode
) -> Result[GCReport, StorageError]:
    return await GarbageCollector(store, policy).run(mode)
