"""Checkpoint <-> store glue.

The JAX package's ``storage/checkpoint.py``:
``create_checkpoint_from_snapshot`` (proto bytes + sha256), ``commit_snapshot``,
``load_snapshot_from_checkpoint`` (rebuild the pricer config from a stored
version), plus a synchronous ``make_commit_fn`` adapter for the trainer's
commit-plan seam. It runs the async commit with ``asyncio.run``; where an
event loop is already running in the calling thread (``train`` or
``train_via_effects`` called from async code, or the effect interpreter's own
loop) it runs it on a side thread, so the commit reaches the store there too.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import TYPE_CHECKING

from spectralmc_tpu_torch.core.errors.storage import StorageError
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.serialization import deserialize_checkpoint, serialize_checkpoint
from spectralmc_tpu_torch.storage.chain import ModelVersion
from spectralmc_tpu_torch.storage.store import AsyncBlockchainModelStore

if TYPE_CHECKING:  # pragma: no cover
    from spectralmc_tpu_torch.training.trainer import CommitFn, GbmCVNNPricerConfig


def create_checkpoint_from_snapshot(snapshot: "GbmCVNNPricerConfig") -> tuple[bytes, str]:
    """(proto bytes, sha256 content hash)."""
    return serialize_checkpoint(snapshot)


async def commit_snapshot(
    store: AsyncBlockchainModelStore, snapshot: "GbmCVNNPricerConfig", message: str
) -> Result[ModelVersion, StorageError]:
    data, content_hash = create_checkpoint_from_snapshot(snapshot)
    return await store.commit(data, content_hash, message)


async def load_snapshot_from_checkpoint(
    store: AsyncBlockchainModelStore, version: ModelVersion
) -> Result["GbmCVNNPricerConfig", StorageError]:
    """Rebuild the full pricer config from a committed version.

    The proto checkpoint is self-describing: the architecture record rides
    inside it. The caller builds the pricer with
    ``GbmCVNNPricer.create(config, device=...)``.
    """
    data = await store.load_checkpoint(version)
    if isinstance(data, Failure):
        return Failure(data.error)
    restored = deserialize_checkpoint(data.value, expected_hash=version.content_hash)
    if isinstance(restored, Failure):
        from spectralmc_tpu_torch.core.errors.storage import ChainParseError

        return Failure(ChainParseError(key=version.directory_name, reason=repr(restored.error)))
    return Success(restored.value)


def make_commit_fn(store: AsyncBlockchainModelStore) -> "CommitFn":
    """Adapt the async store into the trainer's synchronous commit hook.

    Raises on commit failure so the trainer's swallow-and-log policy applies
    (commits never kill training).
    """

    def commit(snapshot: "GbmCVNNPricerConfig", message: str) -> None:
        def run() -> Result[ModelVersion, StorageError]:
            return asyncio.run(commit_snapshot(store, snapshot, message))

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            result = run()
        else:  # asyncio.run would raise in this thread
            with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
                result = pool.submit(run).result()
        if isinstance(result, Failure):
            raise RuntimeError(f"commit failed: {result.error!r}")

    return commit
