"""Content-addressed, Merkle-linked model versioning (the JAX package's
``storage``): chain primitives, the compare-and-swap commit protocol, the
retry engine, chain verification, garbage collection, the pinned/tracking
``InferenceClient``, the audit log and the CLI
(``python -m spectralmc_tpu_torch.storage``).

The store is host-side and backend-agnostic: an async ``ObjectStore``
protocol with in-memory, filesystem and S3 backends. Object keys,
``chain.json``, ``metadata.json`` and ``content_hash.txt`` are byte for byte
the JAX package's, so either package verifies, serves and extends a chain
the other wrote.
"""


# Lazy exports (PEP 562): the CLI (``__main__``) and the chain store load
# without torch; the checkpoint glue and the client import it when named.
_EXPORTS = {
    "AsyncBlockchainModelStore": "spectralmc_tpu_torch.storage.store",
    "ChainCorrupted": "spectralmc_tpu_torch.storage.verification",
    "ChainValid": "spectralmc_tpu_torch.storage.verification",
    "ExecuteGC": "spectralmc_tpu_torch.storage.gc",
    "FileSystemObjectStore": "spectralmc_tpu_torch.storage.object_store",
    "GCReport": "spectralmc_tpu_torch.storage.gc",
    "GarbageCollector": "spectralmc_tpu_torch.storage.gc",
    "InMemoryObjectStore": "spectralmc_tpu_torch.storage.object_store",
    "InferenceClient": "spectralmc_tpu_torch.storage.inference",
    "LoadedModel": "spectralmc_tpu_torch.storage.inference",
    "ModelVersion": "spectralmc_tpu_torch.storage.chain",
    "ObjectStore": "spectralmc_tpu_torch.storage.object_store",
    "PinnedMode": "spectralmc_tpu_torch.storage.inference",
    "PreviewGC": "spectralmc_tpu_torch.storage.gc",
    "RetentionPolicy": "spectralmc_tpu_torch.storage.gc",
    "TrackingMode": "spectralmc_tpu_torch.storage.inference",
    "bump_semantic_version": "spectralmc_tpu_torch.storage.chain",
    "commit_snapshot": "spectralmc_tpu_torch.storage.checkpoint",
    "compute_etag": "spectralmc_tpu_torch.storage.object_store",
    "create_checkpoint_from_snapshot": "spectralmc_tpu_torch.storage.checkpoint",
    "create_genesis_version": "spectralmc_tpu_torch.storage.chain",
    "create_next_version": "spectralmc_tpu_torch.storage.chain",
    "find_corruption": "spectralmc_tpu_torch.storage.verification",
    "load_snapshot_from_checkpoint": "spectralmc_tpu_torch.storage.checkpoint",
    "make_commit_fn": "spectralmc_tpu_torch.storage.checkpoint",
    "make_s3_object_store": "spectralmc_tpu_torch.storage.object_store",
    "run_gc": "spectralmc_tpu_torch.storage.gc",
    "verify_chain_detailed": "spectralmc_tpu_torch.storage.verification",
    "verify_chain_links": "spectralmc_tpu_torch.storage.verification",
    "verify_version_completeness": "spectralmc_tpu_torch.storage.verification",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> object:
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS))
