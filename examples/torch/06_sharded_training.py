"""Example 6 — sharded training on a mesh of ranks, in the PyTorch port.

The port's counterpart of ``examples/06_sharded_training.py``. The JAX
example shards over a (4, 2) mesh of 8 virtual devices in one process; the
port runs one ``torch.distributed`` rank a shard (``docs/torch_sharding.md``),
here a (2, 2) mesh of 4 ranks: contracts split 2 ways, each contract's MC
rows 2 ways. On the CPU the ranks join over gloo; with as many cards as
ranks each rank takes a card over nccl; on one card all four share it over
gloo (nccl takes no two ranks on one card). Each rank launches kernel #1 on
its shard. Run: python examples/torch/06_sharded_training.py [--device cpu]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples.torch._common import (  # noqa: E402
    device_from_argv,
    join_world,
    launches_since,
    rank_args,
    rank_layout,
    run_ranks,
    state_digest,
)
from spectralmc_tpu_torch.models.factory import (  # noqa: E402
    Activation,
    LinearCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops import gbm_cuda  # noqa: E402
from spectralmc_tpu_torch.ops.gbm import build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.parallel import build_mesh_spec  # noqa: E402
from spectralmc_tpu_torch.parallel.distributed import shutdown_distributed  # noqa: E402
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


def make_config(implementation: str) -> GbmCVNNPricerConfig:
    sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42,
        implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=1
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)


def training(num_batches: int):
    return build_training_config(num_batches=num_batches, batch_size=16,
                                 learning_rate=2e-3).expect("c")


def rank_main(rank: int, world: int, root: str, job: dict[str, object]) -> None:
    """One rank: join the world, train this rank's shard of the mesh and
    write its losses, launches and replica digest to ``root``."""
    device = join_world(rank, world, root, job)
    spec = build_mesh_spec(batch_shards=job["batch_shards"],
                           paths_shards=job["paths_shards"]).expect("mesh")
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    sharded = GbmCVNNPricer.create(make_config(job["implementation"]), device=device,
                                   mesh_spec=spec).expect("sharded")
    result = sharded.train(training(job["num_batches"])).expect("t")
    Path(root, f"rank{rank}.json").write_text(json.dumps({
        "losses": [float(x) for x in result.losses], "launches": launches_since(before),
        "digest": state_digest(sharded.model)}))
    shutdown_distributed()


def run(device: torch.device | str, *, batch_shards: int = 2, paths_shards: int = 2,
        num_batches: int = 6, implementation: str = "cuda",
        timeout_s: float = 600.0) -> dict[str, object]:
    """The single-device losses, rank 0's sharded losses, their largest
    relative gap, whether every rank ended on the same replica, the ranks'
    devices and backend, and the kernel launches summed over the ranks (each
    rank counts its own, in its process)."""
    world = batch_shards * paths_shards
    devices, backend = rank_layout(device, world)
    single = GbmCVNNPricer.create(make_config(implementation), device=device).expect("single")
    r_single = single.train(training(num_batches)).expect("t")
    ranks = run_ranks(__file__, world, {
        "devices": devices, "backend": backend, "batch_shards": batch_shards,
        "paths_shards": paths_shards, "num_batches": num_batches,
        "implementation": implementation, "timeout_s": timeout_s}, timeout_s)
    sharded = np.asarray(ranks[0]["losses"])
    rank_launches: dict[str, int] = {}
    for r in ranks:
        for branch, n in r["launches"].items():
            rank_launches[branch] = rank_launches.get(branch, 0) + n
    return {"devices": devices, "backend": backend, "mesh": (batch_shards, paths_shards),
            "single": np.asarray(r_single.losses), "sharded": sharded,
            "max_rel_diff": float(np.max(np.abs(sharded - r_single.losses)
                                         / np.abs(r_single.losses))),
            "replicas_equal": all(r["losses"] == ranks[0]["losses"]
                                  and r["digest"] == ranks[0]["digest"] for r in ranks),
            "rank_launches": rank_launches}


def main(argv: list[str] | None = None) -> None:
    as_rank = rank_args(argv)
    if as_rank is not None:
        rank_main(*as_rank)
        return
    out = run(device_from_argv(__doc__, argv))
    shape = "x".join(map(str, out["mesh"]))
    print(f"ranks: {len(out['devices'])} x {out['devices'][0]} over {out['backend']}")
    print(f"sharded ({shape} mesh) vs single-device: max relative loss diff = "
          f"{out['max_rel_diff']:.2e}")


if __name__ == "__main__":
    main()
