"""S3/MinIO ``ObjectStore`` backend on aioboto3 (the JAX package's
``storage/s3_store.py``).

``aioboto3`` and ``botocore`` are imported inside the functions that use
them, so this module imports without them; constructing an
``S3ObjectStore`` without aioboto3 raises ImportError. Backend failures are
classified into the storage error ADTs; conditional writes use S3's
``If-Match`` and ``If-None-Match: *``.
"""

from __future__ import annotations

import os

from spectralmc_tpu_torch.core.errors.storage import (
    AccessDenied,
    BucketNotFound,
    NetworkError,
    ObjectNotFound,
    PreconditionFailed,
    StoreOpError,
    Throttled,
    UnknownStoreError,
)
from spectralmc_tpu_torch.core.result import Failure, Result, Success

_THROTTLE_CODES = {"SlowDown", "RequestLimitExceeded", "ServiceUnavailable", "Throttling"}


def _boto_errors() -> tuple[type[Exception], type[Exception]]:
    """``(ClientError, BotoCoreError)`` from botocore, imported on use."""
    from botocore.exceptions import BotoCoreError, ClientError

    return ClientError, BotoCoreError


def _classify(exc: Exception, bucket: str, key: str) -> StoreOpError:
    code = exc.response.get("Error", {}).get("Code", "")
    if code in ("NoSuchBucket",):
        return BucketNotFound(bucket=bucket)
    if code in ("NoSuchKey", "404", "NotFound"):
        return ObjectNotFound(bucket=bucket, key=key)
    if code in ("AccessDenied", "403"):
        return AccessDenied(bucket=bucket, key=key, reason=str(exc))
    if code in ("PreconditionFailed", "412"):
        return PreconditionFailed(bucket=bucket, key=key, expected_etag="")
    if code in _THROTTLE_CODES:
        return Throttled(bucket=bucket, key=key, code=code)
    return UnknownStoreError(bucket=bucket, key=key, reason=str(exc))


class S3ObjectStore:
    """aioboto3-backed ObjectStore with genuine If-Match/If-None-Match CAS."""

    def __init__(self, bucket: str, *, endpoint_url: str | None = None) -> None:
        try:
            import aioboto3
            from botocore.config import Config as BotoConfig
        except ImportError as exc:
            raise ImportError(
                "the S3 backend needs aioboto3 (pip extra 's3'); without it use "
                "FileSystemObjectStore or InMemoryObjectStore"
            ) from exc
        self.bucket = bucket
        self._endpoint = endpoint_url or os.environ.get("AWS_ENDPOINT_URL")
        self._session = aioboto3.Session()
        self._config = BotoConfig(
            max_pool_connections=50, retries={"max_attempts": 3, "mode": "adaptive"}
        )

    def _client(self) -> "object":
        return self._session.client("s3", endpoint_url=self._endpoint, config=self._config)

    async def get(self, key: str) -> Result[tuple[bytes, str], StoreOpError]:
        client_error, boto_error = _boto_errors()
        try:
            async with self._client() as s3:
                resp = await s3.get_object(Bucket=self.bucket, Key=key)
                data = await resp["Body"].read()
                return Success((data, resp["ETag"].strip('"')))
        except client_error as exc:
            return Failure(_classify(exc, self.bucket, key))
        except boto_error as exc:
            return Failure(NetworkError(bucket=self.bucket, key=key, reason=str(exc)))

    async def put(
        self,
        key: str,
        data: bytes,
        *,
        if_match: str | None = None,
        if_none_match: bool = False,
    ) -> Result[str, StoreOpError]:
        client_error, boto_error = _boto_errors()
        kwargs: dict[str, object] = {"Bucket": self.bucket, "Key": key, "Body": data}
        if if_match is not None:
            kwargs["IfMatch"] = if_match
        if if_none_match:
            kwargs["IfNoneMatch"] = "*"
        try:
            async with self._client() as s3:
                resp = await s3.put_object(**kwargs)
                return Success(resp["ETag"].strip('"'))
        except client_error as exc:
            return Failure(_classify(exc, self.bucket, key))
        except boto_error as exc:
            return Failure(NetworkError(bucket=self.bucket, key=key, reason=str(exc)))

    async def delete(self, key: str) -> Result[None, StoreOpError]:
        client_error, boto_error = _boto_errors()
        try:
            async with self._client() as s3:
                await s3.delete_object(Bucket=self.bucket, Key=key)
                return Success(None)
        except client_error as exc:
            return Failure(_classify(exc, self.bucket, key))
        except boto_error as exc:
            return Failure(NetworkError(bucket=self.bucket, key=key, reason=str(exc)))

    async def list(self, prefix: str) -> Result[tuple[str, ...], StoreOpError]:
        client_error, boto_error = _boto_errors()
        keys: list[str] = []
        try:
            async with self._client() as s3:
                paginator = s3.get_paginator("list_objects_v2")
                async for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
                    keys.extend(obj["Key"] for obj in page.get("Contents", ()))
            return Success(tuple(sorted(keys)))
        except client_error as exc:
            return Failure(_classify(exc, self.bucket, prefix))
        except boto_error as exc:
            return Failure(NetworkError(bucket=self.bucket, key=prefix, reason=str(exc)))

    async def head(self, key: str) -> Result[tuple[int, str], StoreOpError]:
        client_error, boto_error = _boto_errors()
        try:
            async with self._client() as s3:
                resp = await s3.head_object(Bucket=self.bucket, Key=key)
                return Success((resp["ContentLength"], resp["ETag"].strip('"')))
        except client_error as exc:
            return Failure(_classify(exc, self.bucket, key))
        except boto_error as exc:
            return Failure(NetworkError(bucket=self.bucket, key=key, reason=str(exc)))
