"""Version-chain primitives.

The JAX package's ``storage/chain.py``, byte for byte in what it hashes:
``ModelVersion`` with counter/semver/parent/content hashes, ``version_id`` =
``v%010d``, ``directory_name`` = ``{id}_{semver}_{hash[:8]}``, a record hash
over pipe-joined fields, patch bumping, genesis construction.
"""

from __future__ import annotations

import hashlib
from datetime import datetime, timezone

from pydantic import BaseModel, ConfigDict

GENESIS_SEMVER = "1.0.0"


class ModelVersion(BaseModel):
    """One Merkle link: ``parent_hash`` must equal the parent's ``content_hash``."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    counter: int
    semantic_version: str
    parent_hash: str
    content_hash: str
    timestamp: str
    message: str = ""

    @property
    def version_id(self) -> str:
        return f"v{self.counter:010d}"

    @property
    def directory_name(self) -> str:
        return f"{self.version_id}_{self.semantic_version}_{self.content_hash[:8]}"

    def compute_hash(self) -> str:
        """Tamper-evidence hash over the record's own fields."""
        joined = "|".join(
            (
                str(self.counter),
                self.semantic_version,
                self.parent_hash,
                self.content_hash,
                self.timestamp,
                self.message,
            )
        )
        return hashlib.sha256(joined.encode("utf-8")).hexdigest()


def bump_semantic_version(semver: str) -> str:
    """Patch bump; the chain invariant is ``1.0.<counter>``."""
    major, minor, patch = semver.split(".")
    return f"{major}.{minor}.{int(patch) + 1}"


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def create_genesis_version(content_hash: str, message: str = "genesis") -> ModelVersion:
    return ModelVersion(
        counter=0,
        semantic_version=GENESIS_SEMVER,
        parent_hash="",
        content_hash=content_hash,
        timestamp=_now_iso(),
        message=message,
    )


def create_next_version(parent: ModelVersion, content_hash: str, message: str) -> ModelVersion:
    return ModelVersion(
        counter=parent.counter + 1,
        semantic_version=bump_semantic_version(parent.semantic_version),
        parent_hash=parent.content_hash,
        content_hash=content_hash,
        timestamp=_now_iso(),
        message=message,
    )
