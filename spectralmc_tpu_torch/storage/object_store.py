"""Async object-store seam: the protocol and its in-memory, filesystem and S3
backends (the JAX package's ``storage/object_store.py``).

Every backend gives the same compare-and-swap contract: ``put`` with
``if_match`` (fail unless the current ETag matches) or ``if_none_match``
(fail if the key exists), ETags that change with the content, and idempotent
deletes. The filesystem store's ETag is the content's SHA-256, and its CAS
runs under an asyncio lock with an atomic replace.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
from pathlib import Path
from typing import Protocol, runtime_checkable

from spectralmc_tpu_torch.core.errors.storage import (
    ObjectNotFound,
    PreconditionFailed,
    StoreOpError,
    UnknownStoreError,
)
from spectralmc_tpu_torch.core.result import Failure, Result, Success


def compute_etag(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@runtime_checkable
class ObjectStore(Protocol):
    """The minimal surface the blockchain store needs (get/put/delete/list/head).

    ``put`` supports the two conditional modes the CAS protocol uses:
    ``if_match`` (fail unless the current ETag matches) and ``if_none_match``
    (fail if the key exists) — S3's ``If-Match`` / ``If-None-Match: *``.
    """

    bucket: str

    async def get(self, key: str) -> Result[tuple[bytes, str], StoreOpError]: ...

    async def put(
        self,
        key: str,
        data: bytes,
        *,
        if_match: str | None = None,
        if_none_match: bool = False,
    ) -> Result[str, StoreOpError]: ...

    async def delete(self, key: str) -> Result[None, StoreOpError]: ...

    async def list(self, prefix: str) -> Result[tuple[str, ...], StoreOpError]: ...

    async def head(self, key: str) -> Result[tuple[int, str], StoreOpError]: ...


class FileSystemObjectStore:
    """Local-directory backend with real CAS semantics (hermetic tests/dev).

    Keys map to files under ``root/bucket/``; ETags are content SHA-256.
    All mutations serialize through one asyncio lock, making the
    read-compare-replace sequence atomic within a process; writes go through
    ``os.replace`` so readers never observe partial objects.
    """

    def __init__(self, root: str | os.PathLike[str], bucket: str) -> None:
        self.bucket = bucket
        self._base = Path(root) / bucket
        self._base.mkdir(parents=True, exist_ok=True)
        self._lock = asyncio.Lock()

    def _path(self, key: str) -> Path:
        path = (self._base / key).resolve()
        if not str(path).startswith(str(self._base.resolve())):
            raise ValueError(f"key escapes bucket: {key!r}")
        return path

    async def get(self, key: str) -> Result[tuple[bytes, str], StoreOpError]:
        path = self._path(key)
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return Failure(ObjectNotFound(bucket=self.bucket, key=key))
        except OSError as exc:
            return Failure(UnknownStoreError(bucket=self.bucket, key=key, reason=str(exc)))
        return Success((data, compute_etag(data)))

    async def put(
        self,
        key: str,
        data: bytes,
        *,
        if_match: str | None = None,
        if_none_match: bool = False,
    ) -> Result[str, StoreOpError]:
        path = self._path(key)
        async with self._lock:
            exists = path.exists()
            if if_none_match and exists:
                current = compute_etag(path.read_bytes())
                return Failure(
                    PreconditionFailed(bucket=self.bucket, key=key, expected_etag=current)
                )
            if if_match is not None:
                if not exists:
                    return Failure(ObjectNotFound(bucket=self.bucket, key=key))
                current = compute_etag(path.read_bytes())
                if current != if_match:
                    return Failure(
                        PreconditionFailed(
                            bucket=self.bucket, key=key, expected_etag=if_match
                        )
                    )
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(path.suffix + ".tmp")
                tmp.write_bytes(data)
                os.replace(tmp, path)
            except OSError as exc:
                return Failure(
                    UnknownStoreError(bucket=self.bucket, key=key, reason=str(exc))
                )
        return Success(compute_etag(data))

    async def delete(self, key: str) -> Result[None, StoreOpError]:
        path = self._path(key)
        async with self._lock:
            try:
                path.unlink(missing_ok=True)
            except OSError as exc:
                return Failure(
                    UnknownStoreError(bucket=self.bucket, key=key, reason=str(exc))
                )
        return Success(None)

    async def list(self, prefix: str) -> Result[tuple[str, ...], StoreOpError]:
        base = self._base
        try:
            keys = sorted(
                str(p.relative_to(base))
                for p in base.rglob("*")
                if p.is_file() and str(p.relative_to(base)).startswith(prefix)
            )
        except OSError as exc:
            return Failure(UnknownStoreError(bucket=self.bucket, key=prefix, reason=str(exc)))
        return Success(tuple(keys))

    async def head(self, key: str) -> Result[tuple[int, str], StoreOpError]:
        path = self._path(key)
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return Failure(ObjectNotFound(bucket=self.bucket, key=key))
        except OSError as exc:
            return Failure(UnknownStoreError(bucket=self.bucket, key=key, reason=str(exc)))
        return Success((len(data), compute_etag(data)))


class InMemoryObjectStore:
    """Dict-backed backend with the same CAS semantics (fastest hermetic seam).

    Same conditional-put contract as the filesystem/S3 backends; mutations
    serialize through one asyncio lock so read-compare-replace is atomic.
    """

    def __init__(self, bucket: str) -> None:
        self.bucket = bucket
        self._objects: dict[str, bytes] = {}
        self._lock = asyncio.Lock()

    async def get(self, key: str) -> Result[tuple[bytes, str], StoreOpError]:
        data = self._objects.get(key)
        if data is None:
            return Failure(ObjectNotFound(bucket=self.bucket, key=key))
        return Success((data, compute_etag(data)))

    async def put(
        self,
        key: str,
        data: bytes,
        *,
        if_match: str | None = None,
        if_none_match: bool = False,
    ) -> Result[str, StoreOpError]:
        async with self._lock:
            current = self._objects.get(key)
            if if_none_match and current is not None:
                return Failure(
                    PreconditionFailed(
                        bucket=self.bucket, key=key, expected_etag=compute_etag(current)
                    )
                )
            if if_match is not None:
                if current is None:
                    return Failure(ObjectNotFound(bucket=self.bucket, key=key))
                if compute_etag(current) != if_match:
                    return Failure(
                        PreconditionFailed(
                            bucket=self.bucket, key=key, expected_etag=if_match
                        )
                    )
            self._objects[key] = bytes(data)
        return Success(compute_etag(data))

    async def delete(self, key: str) -> Result[None, StoreOpError]:
        async with self._lock:
            self._objects.pop(key, None)
        return Success(None)

    async def list(self, prefix: str) -> Result[tuple[str, ...], StoreOpError]:
        return Success(tuple(sorted(k for k in self._objects if k.startswith(prefix))))

    async def head(self, key: str) -> Result[tuple[int, str], StoreOpError]:
        data = self._objects.get(key)
        if data is None:
            return Failure(ObjectNotFound(bucket=self.bucket, key=key))
        return Success((len(data), compute_etag(data)))


def make_s3_object_store(bucket: str, *, endpoint_url: str | None = None) -> ObjectStore:
    """S3 backend (aioboto3); the endpoint defaults to ``AWS_ENDPOINT_URL``.

    Raises ImportError with guidance when aioboto3 is not installed; the
    filesystem store needs nothing extra.
    """
    from spectralmc_tpu_torch.storage.s3_store import S3ObjectStore

    return S3ObjectStore(bucket, endpoint_url=endpoint_url)
