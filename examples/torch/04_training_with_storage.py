"""Example 4 — training with interval blockchain commits + reload, in the PyTorch port.

The port's counterpart of ``examples/04_training_with_storage.py``: 8
batches on the ``"cuda"`` engine (kernel #1) committed every 3 and at the
end through ``make_commit_fn``; HEAD reloaded with
``load_snapshot_from_checkpoint`` trains on bit-equal to the pricer that
never stopped. Run: python examples/torch/04_training_with_storage.py [--device cpu]
"""

from __future__ import annotations

import asyncio
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.models.factory import (  # noqa: E402
    Activation,
    LinearCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops.gbm import build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.storage import (  # noqa: E402
    AsyncBlockchainModelStore,
    FileSystemObjectStore,
)
from spectralmc_tpu_torch.storage.checkpoint import (  # noqa: E402
    load_snapshot_from_checkpoint,
    make_commit_fn,
)
from spectralmc_tpu_torch.training import (  # noqa: E402
    FinalAndIntervalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

BOUNDS = {
    "spot": BoundSpec(lower=80, upper=120),
    "strike": BoundSpec(lower=80, upper=120),
    "maturity": BoundSpec(lower=0.25, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}


def make_config(implementation: str = "cuda") -> GbmCVNNPricerConfig:
    sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42,
        implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=1
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)


def run(device: torch.device | str, *, num_batches: int = 8, interval: int = 3,
        implementation: str = "cuda") -> dict[str, object]:
    """The training losses, the committed versions' messages, HEAD's
    checkpoint bytes, and the two runs after HEAD: the pricer that never
    stopped and the one reloaded from HEAD."""
    with tempfile.TemporaryDirectory() as root:
        store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "training"))
        pricer = GbmCVNNPricer.create(make_config(implementation), device=device).expect("pricer")
        result = pricer.train(
            build_training_config(num_batches=num_batches, batch_size=8,
                                  learning_rate=2e-3).expect("cfg"),
            commit_plan=FinalAndIntervalCommit(interval=interval),
            commit_fn=make_commit_fn(store),
        ).expect("training")

        versions = asyncio.run(store.list_versions()).expect("list")

        # reload HEAD and continue — identical to continuous training
        head = asyncio.run(store.get_head()).expect("head")
        head_bytes = asyncio.run(store.load_checkpoint(head)).expect("head bytes")
        restored_cfg = asyncio.run(load_snapshot_from_checkpoint(store, head)).expect("load")
    restored = GbmCVNNPricer.create(restored_cfg, device=device).expect("restored")
    more = build_training_config(num_batches=2, batch_size=8, learning_rate=2e-3).expect("cfg")
    r1 = pricer.train(more).expect("t")
    r2 = restored.train(more).expect("t")
    return {"losses": np.asarray(result.losses), "total_batches": result.total_batches,
            "final_loss": result.final_loss,
            "versions": [(v.version_id, v.message) for v in versions],
            "head_bytes": head_bytes, "continued": np.asarray(r1.losses),
            "resumed": np.asarray(r2.losses),
            "resume_equal": bool(np.array_equal(r1.losses, r2.losses))}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"trained {out['total_batches']} batches, final loss {out['final_loss']:.3f}")
    for version_id, message in out["versions"]:
        print(f"  {version_id}: {message}")
    print("resume == continuous:", out["resume_equal"])


if __name__ == "__main__":
    main()
