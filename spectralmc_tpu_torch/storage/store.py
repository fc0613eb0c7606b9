"""AsyncBlockchainModelStore — the atomic CAS commit protocol.

The JAX package's ``storage/store.py``, with the same object keys and the
same bytes in ``chain.json``, ``metadata.json`` and ``content_hash.txt``, so
a chain either package writes verifies in the other. The 10-step commit:
fetch HEAD → build version (genesis or
parent=HEAD.content_hash, patch bump) → parallel upload of
``versions/<dir>/{checkpoint.pb, metadata.json, content_hash.txt}`` → fetch
``chain.json`` + ETag → fast-forward check (rollback on drift) → CAS PUT
``chain.json`` with If-Match (precondition failure → rollback + conflict) →
append audit-log JSONL (non-fatal) → return version.

Failures are ``Result`` ADTs, and the backend is any ``ObjectStore``
(in memory, a filesystem with real CAS, or S3 through aioboto3).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
from datetime import datetime, timezone

from spectralmc_tpu_torch.core.errors.storage import (
    ChainParseError,
    NotFastForward,
    ObjectNotFound,
    PreconditionFailed,
    StorageError,
    VersionNotFound,
)
from spectralmc_tpu_torch.core.errors.storage import ChecksumError as ChecksumErr
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.storage.chain import (
    ModelVersion,
    create_genesis_version,
    create_next_version,
)
from spectralmc_tpu_torch.storage.object_store import ObjectStore
from spectralmc_tpu_torch.storage.retry import retry_on_throttle

CHAIN_KEY = "chain.json"
VERSIONS_PREFIX = "versions/"
AUDIT_PREFIX = "audit_log/"
GC_LOG_PREFIX = "gc_log/"
CHECKPOINT_NAME = "checkpoint.pb"
METADATA_NAME = "metadata.json"
CONTENT_HASH_NAME = "content_hash.txt"

_VERSION_FIELDS = (
    "counter",
    "semantic_version",
    "parent_hash",
    "content_hash",
    "timestamp",
    "message",
)


def _chain_payload(version: ModelVersion) -> bytes:
    record = version.model_dump()
    record["record_hash"] = version.compute_hash()
    return json.dumps(record, sort_keys=True).encode("utf-8")


def _parse_chain(data: bytes) -> Result[ModelVersion, StorageError]:
    try:
        record = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        return Failure(ChainParseError(key=CHAIN_KEY, reason=str(exc)))
    missing = [f for f in _VERSION_FIELDS if f not in record]
    if missing:
        return Failure(ChainParseError(key=CHAIN_KEY, reason=f"missing fields {missing}"))
    try:
        version = ModelVersion(**{f: record[f] for f in _VERSION_FIELDS})
    except Exception as exc:  # pydantic ValidationError
        return Failure(ChainParseError(key=CHAIN_KEY, reason=str(exc)))
    expected = record.get("record_hash")
    if expected is not None and expected != version.compute_hash():
        return Failure(ChainParseError(key=CHAIN_KEY, reason="record_hash mismatch (tampered)"))
    return Success(version)



def _sha256(data: bytes) -> str:
    """The content hash (``serialization.compute_sha256``'s, here without
    the serialization package, so the store loads without torch)."""
    return hashlib.sha256(data).hexdigest()


class AsyncBlockchainModelStore:
    """Content-addressed version chain over any ``ObjectStore``."""

    def __init__(self, store: ObjectStore) -> None:
        self._store = store

    @property
    def bucket(self) -> str:
        return self._store.bucket

    @property
    def object_store(self) -> ObjectStore:
        return self._store

    # -- head / chain ---------------------------------------------------------

    async def get_head(self) -> Result[ModelVersion | None, StorageError]:
        """Current chain head, ``None`` when the chain is empty.

        Throttle-retried with its own schedule.
        """
        result = await retry_on_throttle(lambda: self._store.get(CHAIN_KEY))
        if isinstance(result, Failure):
            if isinstance(result.error, ObjectNotFound):
                return Success(None)
            return Failure(result.error)
        data, _etag = result.value
        return _parse_chain(data)

    async def _get_head_with_etag(
        self,
    ) -> Result[tuple[ModelVersion | None, str | None], StorageError]:
        result = await retry_on_throttle(lambda: self._store.get(CHAIN_KEY))
        if isinstance(result, Failure):
            if isinstance(result.error, ObjectNotFound):
                return Success((None, None))
            return Failure(result.error)
        data, etag = result.value
        parsed = _parse_chain(data)
        if isinstance(parsed, Failure):
            return Failure(parsed.error)
        return Success((parsed.value, etag))

    # -- commit (the 10-step protocol) -----------------------------------------

    async def commit(
        self, checkpoint: bytes, content_hash: str, message: str
    ) -> Result[ModelVersion, StorageError]:
        if _sha256(checkpoint) != content_hash:
            return Failure(
                ChecksumErr(expected=content_hash, actual=_sha256(checkpoint))
            )

        # 1-2: fetch HEAD, build the candidate version
        head_res = await self._get_head_with_etag()
        if isinstance(head_res, Failure):
            return Failure(head_res.error)
        head, head_etag = head_res.value
        version = (
            create_genesis_version(content_hash, message)
            if head is None
            else create_next_version(head, content_hash, message)
        )
        prefix = f"{VERSIONS_PREFIX}{version.directory_name}/"
        artifact_keys = (
            prefix + CHECKPOINT_NAME,
            prefix + METADATA_NAME,
            prefix + CONTENT_HASH_NAME,
        )
        metadata = version.model_dump()
        metadata["record_hash"] = version.compute_hash()

        # 3: parallel artifact upload
        uploads = await asyncio.gather(
            retry_on_throttle(lambda: self._store.put(artifact_keys[0], checkpoint)),
            retry_on_throttle(
                lambda: self._store.put(
                    artifact_keys[1], json.dumps(metadata, sort_keys=True).encode()
                )
            ),
            retry_on_throttle(
                lambda: self._store.put(artifact_keys[2], content_hash.encode())
            ),
        )
        for up in uploads:
            if isinstance(up, Failure):
                await self._rollback_artifacts(artifact_keys)
                return Failure(up.error)

        # 4-5: re-fetch chain + fast-forward check
        recheck = await self._get_head_with_etag()
        if isinstance(recheck, Failure):
            await self._rollback_artifacts(artifact_keys)
            return Failure(recheck.error)
        head2, etag2 = recheck.value
        if (head is None) != (head2 is None) or (
            head is not None and head2 is not None and head2.counter != head.counter
        ):
            await self._rollback_artifacts(artifact_keys)
            return Failure(
                NotFastForward(
                    head_counter=-1 if head2 is None else head2.counter,
                    expected_counter=-1 if head is None else head.counter,
                    reason="HEAD moved during commit",
                )
            )

        # 6-7: CAS publish
        payload = _chain_payload(version)
        if etag2 is None:
            cas = await retry_on_throttle(
                lambda: self._store.put(CHAIN_KEY, payload, if_none_match=True)
            )
        else:
            cas = await retry_on_throttle(
                lambda: self._store.put(CHAIN_KEY, payload, if_match=etag2)
            )
        if isinstance(cas, Failure):
            await self._rollback_artifacts(artifact_keys)
            if isinstance(cas.error, PreconditionFailed):
                return Failure(
                    NotFastForward(
                        head_counter=-1,
                        expected_counter=version.counter - 1,
                        reason="CAS precondition failed — concurrent commit won",
                    )
                )
            return Failure(cas.error)

        # 8: audit log (non-fatal on failure)
        await self._append_audit(version)
        return Success(version)

    async def _rollback_artifacts(self, keys: tuple[str, ...]) -> None:
        """Best-effort parallel delete."""
        await asyncio.gather(*(self._store.delete(k) for k in keys), return_exceptions=True)

    async def _append_audit(self, version: ModelVersion) -> None:
        stamp = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%S%fZ")
        key = f"{AUDIT_PREFIX}{stamp}_{version.version_id}.jsonl"
        line = json.dumps(
            {**version.model_dump(), "record_hash": version.compute_hash()}, sort_keys=True
        )
        result = await self._store.put(key, (line + "\n").encode())
        if isinstance(result, Failure):
            import logging

            logging.getLogger(__name__).warning("audit log append failed: %r", result.error)

    # -- reads -----------------------------------------------------------------

    async def list_versions(self) -> Result[tuple[ModelVersion, ...], StorageError]:
        """All committed versions, by counter."""
        listing = await retry_on_throttle(lambda: self._store.list(VERSIONS_PREFIX))
        if isinstance(listing, Failure):
            return Failure(listing.error)
        versions: dict[int, ModelVersion] = {}
        for key in listing.value:
            if not key.endswith("/" + METADATA_NAME):
                continue
            got = await self._store.get(key)
            if isinstance(got, Failure):
                return Failure(got.error)
            try:
                record = json.loads(got.value[0])
                version = ModelVersion(**{f: record[f] for f in _VERSION_FIELDS})
            except Exception as exc:
                return Failure(ChainParseError(key=key, reason=str(exc)))
            versions[version.counter] = version
        return Success(tuple(versions[c] for c in sorted(versions)))

    async def list_tombstones(self) -> Result[tuple[ModelVersion, ...], StorageError]:
        """Versions the garbage collector freed, preserved as chain skeleton.

        GC writes each collected version's metadata record under ``gc_log/``
        before deleting its artifacts, so chain verification can still check
        counters and the Merkle property across the gap (a gap without one
        is tampering).
        """
        listing = await retry_on_throttle(lambda: self._store.list(GC_LOG_PREFIX))
        if isinstance(listing, Failure):
            return Failure(listing.error)
        versions: dict[int, ModelVersion] = {}
        for key in listing.value:
            got = await self._store.get(key)
            if isinstance(got, Failure):
                return Failure(got.error)
            try:
                record = json.loads(got.value[0])
                version = ModelVersion(**{f: record[f] for f in _VERSION_FIELDS})
            except Exception as exc:
                return Failure(ChainParseError(key=key, reason=str(exc)))
            versions[version.counter] = version
        return Success(tuple(versions[c] for c in sorted(versions)))

    async def get_version(self, counter: int) -> Result[ModelVersion, StorageError]:
        versions = await self.list_versions()
        if isinstance(versions, Failure):
            return Failure(versions.error)
        for v in versions.value:
            if v.counter == counter:
                return Success(v)
        return Failure(
            VersionNotFound(identifier=f"counter={counter}", reason="no such version")
        )

    async def load_checkpoint(self, version: ModelVersion) -> Result[bytes, StorageError]:
        """Checkpoint bytes, verified against the version's content hash."""
        key = f"{VERSIONS_PREFIX}{version.directory_name}/{CHECKPOINT_NAME}"
        result = await retry_on_throttle(lambda: self._store.get(key))
        if isinstance(result, Failure):
            return Failure(result.error)
        data, _ = result.value
        actual = _sha256(data)
        if actual != version.content_hash:
            return Failure(ChecksumErr(expected=version.content_hash, actual=actual))
        return Success(data)
