"""Example 5 — pinned and tracking inference clients with hot swap, in the PyTorch port.

The port's counterpart of ``examples/05_inference_client.py``: a pricer
trained on the ``"cuda"`` engine (kernel #1) commits v0 and v1; a pinned
client serves v0, a tracking client hot-swaps to v1, and the served model
prices bit-equal through the instance and the columnar paths.
Run: python examples/torch/05_inference_client.py [--device cpu]
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
from spectralmc_tpu_torch.ops.gbm import BlackScholesContract, build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.serialization import serialize_checkpoint  # noqa: E402
from spectralmc_tpu_torch.storage import (  # noqa: E402
    AsyncBlockchainModelStore,
    FileSystemObjectStore,
    InferenceClient,
    PinnedMode,
    TrackingMode,
)
from spectralmc_tpu_torch.storage.checkpoint import commit_snapshot  # noqa: E402
from spectralmc_tpu_torch.training import (  # noqa: E402
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
CONTRACT = BlackScholesContract(spot=100, strike=100, maturity=1.0, rate=0.03, div_yield=0.01,
                                vol=0.25)


def make_pricer(device: torch.device | str, implementation: str) -> GbmCVNNPricer:
    sim = build_simulation_params(
        timesteps=2, network_size=16, batches_per_mc_run=4, mc_seed=42,
        implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=16, activation=Activation.MODRELU)], seed=1
    ).expect("cvnn")
    return GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn), device=device
    ).expect("pricer")


async def _serve(root: str, device: torch.device | str, implementation: str) -> dict[str, object]:
    store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "serving"))
    cfg = build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3).expect("c")

    # train + commit v0
    pricer = make_pricer(device, implementation)
    pricer.train(cfg).expect("t")
    v0 = pricer.snapshot()
    (await commit_snapshot(store, v0, "v0")).expect("commit")

    # pinned client serves exactly v0 forever
    async with InferenceClient(store, PinnedMode(counter=0)) as pinned:
        loaded = pinned.get_model()
        out = {"pinned": loaded.version.version_id, "pinned_step": loaded.config.global_step,
               "pinned_bytes": serialize_checkpoint(loaded.config)[0],
               "v0_bytes": serialize_checkpoint(v0)[0]}

    # tracking client hot-swaps when a new version lands
    tracker = InferenceClient(store, TrackingMode(), poll_interval=0.05)
    (await tracker.start()).expect("start")
    out["tracking_start"] = tracker.get_model().version.version_id

    pricer.train(cfg).expect("t")
    v1 = pricer.snapshot()
    (await commit_snapshot(store, v1, "v1")).expect("commit")
    for _ in range(100):
        await asyncio.sleep(0.05)
        if tracker.get_model().version.counter == 1:
            break
    tracked = tracker.get_model()
    out["tracking_swapped"] = tracked.version.version_id
    await tracker.stop()
    out["v1_bytes"] = serialize_checkpoint(v1)[0]
    out["tracked_bytes"] = serialize_checkpoint(tracked.config)[0]

    # serve a prediction from the tracked snapshot, and from the trainer
    serving = GbmCVNNPricer.create(tracked.config, device=device).expect("serve")
    pred = serving.predict_price([CONTRACT])
    out["served_put"] = float(pred.put[0])
    out["trainer_put"] = float(pricer.predict_price([CONTRACT]).put[0])

    # hot path for a fleet that already holds contracts columnar: a [N, 6]
    # numpy array (model_fields order) skips Python marshalling and is
    # bit-identical to the instance path (one host->device copy and one
    # device->host copy a call)
    arr = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.25]], np.float32)
    out["columnar_put"] = float(serving.predict_price(arr).put[0])
    return out


def run(device: torch.device | str, *, implementation: str = "cuda") -> dict[str, object]:
    """The versions each client served, the committed snapshots' bytes and
    the bytes the clients loaded, and the served put three ways: through
    the instance path, the columnar path and the trainer itself."""
    with tempfile.TemporaryDirectory() as root:
        out = asyncio.run(_serve(root, device, implementation))
    return out


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"pinned: serving {out['pinned']} (global_step={out['pinned_step']})")
    print(f"tracking: started on {out['tracking_start']}")
    print(f"tracking: hot-swapped to {out['tracking_swapped']}")
    print(f"served put price: {out['served_put']:.4f}")
    assert out["columnar_put"] == out["served_put"]
    print(f"columnar fast path: {out['columnar_put']:.4f} (bit-equal)")


if __name__ == "__main__":
    main()
