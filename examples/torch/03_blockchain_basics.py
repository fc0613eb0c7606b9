"""Example 3 — blockchain store basics: commit, chain, verify, tamper, in the PyTorch port.

The port's counterpart of ``examples/03_blockchain_basics.py``. The store is
host-side: no kernel runs, and ``--device`` only checks that the device
asked for is there. Run: python examples/torch/03_blockchain_basics.py [--device cpu]
"""

from __future__ import annotations

import asyncio
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.serialization import compute_sha256  # noqa: E402
from spectralmc_tpu_torch.storage import (  # noqa: E402
    AsyncBlockchainModelStore,
    ChainValid,
    FileSystemObjectStore,
    verify_chain_detailed,
)


async def _chain(root: str) -> dict[str, object]:
    store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "demo"))
    versions = []
    for i in range(3):
        payload = f"model-checkpoint-{i}".encode()
        version = (
            await store.commit(payload, compute_sha256(payload), f"release {i}")
        ).expect("commit")
        versions.append(version)

    verdict = (await verify_chain_detailed(store)).expect("verify")

    # tamper with an artifact -> load fails the checksum
    listed = (await store.list_versions()).expect("list")
    target = listed[1]
    await store.object_store.put(
        f"versions/{target.directory_name}/checkpoint.pb", b"tampered!"
    )
    loaded = await store.load_checkpoint(target)
    return {"versions": versions, "verdict": verdict,
            "tampered": type(loaded).__name__, "tampered_error": loaded.error}


def run(device: torch.device | str) -> dict[str, object]:
    """The committed versions, the chain's verdict and the tampered load's
    outcome (a ``Failure``)."""
    del device  # the chain store runs on the host
    with tempfile.TemporaryDirectory() as root:
        return asyncio.run(_chain(root))


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    for version in out["versions"]:
        print(f"committed {version.version_id} semver={version.semantic_version} "
              f"parent={version.parent_hash[:8] or '(genesis)'}")
    assert isinstance(out["verdict"], ChainValid)
    print(f"chain valid: {out['verdict'].versions} versions")
    print(f"tampered load -> {out['tampered']}: {out['tampered_error']!r}")


if __name__ == "__main__":
    main()
