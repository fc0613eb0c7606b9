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

from spectralmc_tpu_torch.storage.chain import (
    ModelVersion,
    bump_semantic_version,
    create_genesis_version,
    create_next_version,
)
from spectralmc_tpu_torch.storage.object_store import (
    FileSystemObjectStore,
    InMemoryObjectStore,
    ObjectStore,
    compute_etag,
    make_s3_object_store,
)
from spectralmc_tpu_torch.storage.store import AsyncBlockchainModelStore
from spectralmc_tpu_torch.storage.checkpoint import (
    commit_snapshot,
    create_checkpoint_from_snapshot,
    load_snapshot_from_checkpoint,
    make_commit_fn,
)
from spectralmc_tpu_torch.storage.inference import (
    InferenceClient,
    LoadedModel,
    PinnedMode,
    TrackingMode,
)
from spectralmc_tpu_torch.storage.verification import (
    ChainCorrupted,
    ChainValid,
    find_corruption,
    verify_chain_detailed,
    verify_chain_links,
    verify_version_completeness,
)
from spectralmc_tpu_torch.storage.gc import (
    ExecuteGC,
    GarbageCollector,
    GCReport,
    PreviewGC,
    RetentionPolicy,
    run_gc,
)

__all__ = [
    "AsyncBlockchainModelStore",
    "ChainCorrupted",
    "ChainValid",
    "ExecuteGC",
    "FileSystemObjectStore",
    "GCReport",
    "GarbageCollector",
    "InMemoryObjectStore",
    "InferenceClient",
    "LoadedModel",
    "ModelVersion",
    "ObjectStore",
    "PinnedMode",
    "PreviewGC",
    "RetentionPolicy",
    "TrackingMode",
    "bump_semantic_version",
    "commit_snapshot",
    "compute_etag",
    "create_checkpoint_from_snapshot",
    "create_genesis_version",
    "create_next_version",
    "find_corruption",
    "load_snapshot_from_checkpoint",
    "make_commit_fn",
    "make_s3_object_store",
    "run_gc",
    "verify_chain_detailed",
    "verify_chain_links",
    "verify_version_completeness",
]
