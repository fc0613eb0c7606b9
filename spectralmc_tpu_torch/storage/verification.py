"""Chain integrity verification.

The JAX package's ``storage/verification.py``: genesis invariants
(counter 0, empty parent, semver 1.0.0), sequential counters, the Merkle
property ``parent_hash == prev.content_hash``, semver progression
``1.0.<counter>``, the ChainValid/ChainCorrupted outcome ADT,
``find_corruption`` and per-version artifact completeness checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from spectralmc_tpu_torch.core.errors.storage import StorageError
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.storage.chain import GENESIS_SEMVER, ModelVersion
from spectralmc_tpu_torch.storage.store import (
    CHECKPOINT_NAME,
    CONTENT_HASH_NAME,
    METADATA_NAME,
    VERSIONS_PREFIX,
    AsyncBlockchainModelStore,
)


@dataclass(frozen=True, slots=True)
class ChainValid:
    versions: int


@dataclass(frozen=True, slots=True)
class ChainCorrupted:
    corruption_type: str
    version_counter: int
    details: str


ChainVerdict = Union[ChainValid, ChainCorrupted]


def verify_chain_links(versions: tuple[ModelVersion, ...]) -> ChainVerdict:
    """Pure verification over an ordered version list."""
    if not versions:
        return ChainValid(versions=0)
    genesis = versions[0]
    if genesis.counter != 0:
        return ChainCorrupted(
            corruption_type="genesis_counter",
            version_counter=genesis.counter,
            details=f"genesis counter {genesis.counter} != 0",
        )
    if genesis.parent_hash != "":
        return ChainCorrupted(
            corruption_type="genesis_parent",
            version_counter=0,
            details="genesis parent_hash must be empty",
        )
    if genesis.semantic_version != GENESIS_SEMVER:
        return ChainCorrupted(
            corruption_type="genesis_semver",
            version_counter=0,
            details=f"genesis semver {genesis.semantic_version} != {GENESIS_SEMVER}",
        )
    for prev, cur in zip(versions, versions[1:]):
        if cur.counter != prev.counter + 1:
            return ChainCorrupted(
                corruption_type="counter_gap",
                version_counter=cur.counter,
                details=f"counter {cur.counter} after {prev.counter}",
            )
        if cur.parent_hash != prev.content_hash:  # the Merkle property
            return ChainCorrupted(
                corruption_type="merkle_break",
                version_counter=cur.counter,
                details=(
                    f"parent_hash {cur.parent_hash[:12]} != "
                    f"prev content_hash {prev.content_hash[:12]}"
                ),
            )
        if cur.semantic_version != f"1.0.{cur.counter}":
            return ChainCorrupted(
                corruption_type="semver_progression",
                version_counter=cur.counter,
                details=f"semver {cur.semantic_version} != 1.0.{cur.counter}",
            )
    return ChainValid(versions=len(versions))


async def verify_chain_detailed(
    store: AsyncBlockchainModelStore,
) -> Result[ChainVerdict, StorageError]:
    """Full-chain verification, GC-aware.

    Garbage-collected versions are merged back in from their ``gc_log/``
    tombstones (counter + hash links only), so every invariant — sequential
    counters, the Merkle property, semver progression — is checked across
    the whole history. A gap with no tombstone is real corruption.
    """
    versions = await store.list_versions()
    if isinstance(versions, Failure):
        return Failure(versions.error)
    tombstones = await store.list_tombstones()
    if isinstance(tombstones, Failure):
        return Failure(tombstones.error)
    merged = {v.counter: v for v in tombstones.value}
    merged.update({v.counter: v for v in versions.value})
    chain = tuple(merged[c] for c in sorted(merged))
    verdict = verify_chain_links(chain)
    if isinstance(verdict, ChainCorrupted):
        return Success(verdict)
    # HEAD must point at the last version
    head = await store.get_head()
    if isinstance(head, Failure):
        return Failure(head.error)
    if head.value is None and versions.value:
        return Success(
            ChainCorrupted(
                corruption_type="missing_head",
                version_counter=versions.value[-1].counter,
                details="versions exist but chain.json is absent",
            )
        )
    if head.value is not None and versions.value and (
        head.value.counter != versions.value[-1].counter
    ):
        return Success(
            ChainCorrupted(
                corruption_type="stale_head",
                version_counter=head.value.counter,
                details=(
                    f"HEAD counter {head.value.counter} != last version "
                    f"{versions.value[-1].counter}"
                ),
            )
        )
    return Success(verdict)


async def find_corruption(
    store: AsyncBlockchainModelStore,
) -> Result[ChainCorrupted | None, StorageError]:
    """First corruption found, checking links then per-version payload hashes."""
    verdict = await verify_chain_detailed(store)
    if isinstance(verdict, Failure):
        return Failure(verdict.error)
    if isinstance(verdict.value, ChainCorrupted):
        return Success(verdict.value)
    versions = await store.list_versions()
    if isinstance(versions, Failure):
        return Failure(versions.error)
    for version in versions.value:
        payload = await store.load_checkpoint(version)
        if isinstance(payload, Failure):
            return Success(
                ChainCorrupted(
                    corruption_type="payload",
                    version_counter=version.counter,
                    details=repr(payload.error),
                )
            )
    return Success(None)


async def verify_version_completeness(
    store: AsyncBlockchainModelStore, version: ModelVersion
) -> Result[tuple[str, ...], StorageError]:
    """Missing artifact names for a version (empty tuple == complete)."""
    prefix = f"{VERSIONS_PREFIX}{version.directory_name}/"
    missing: list[str] = []
    for name in (CHECKPOINT_NAME, METADATA_NAME, CONTENT_HASH_NAME):
        head = await store.object_store.head(prefix + name)
        if isinstance(head, Failure):
            missing.append(name)
    return Success(tuple(missing))
