"""Example 8 — multi-process training over a global (slice, batch, paths) mesh,
in the PyTorch port.

The port's counterpart of ``examples/08_distributed_training.py``. It starts
itself as two ranks; each joins the world over a rendezvous file (a cluster
gives ``tcp://host:port`` instead), builds the global mesh with
``build_global_mesh_spec`` and trains its shard, with the blockchain commit
gated to rank 0 by ``coordinator_only``. The JAX example gives each process
4 virtual devices; the port gives each rank one device, so the mesh is
(2 slices, 1, 1). On the CPU the ranks join over gloo; with two cards each
takes one over nccl; on one card both share it over gloo. Each rank
launches kernel #1 on its shard.
Run: python examples/torch/08_distributed_training.py [--device cpu]
"""

from __future__ import annotations

import asyncio
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

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
from spectralmc_tpu_torch.parallel.distributed import (  # noqa: E402
    build_global_mesh_spec,
    coordinator_only,
    current_runtime,
    shutdown_distributed,
)
from spectralmc_tpu_torch.storage import (  # noqa: E402
    AsyncBlockchainModelStore,
    ChainValid,
    FileSystemObjectStore,
    verify_chain_detailed,
)
from spectralmc_tpu_torch.storage.checkpoint import make_commit_fn  # noqa: E402
from spectralmc_tpu_torch.training import (  # noqa: E402
    FinalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)


def make_config(implementation: str) -> GbmCVNNPricerConfig:
    bounds = {
        "spot": BoundSpec(lower=80, upper=120),
        "strike": BoundSpec(lower=80, upper=120),
        "maturity": BoundSpec(lower=0.25, upper=1.5),
        "rate": BoundSpec(lower=0.0, upper=0.08),
        "div_yield": BoundSpec(lower=0.0, upper=0.04),
        "vol": BoundSpec(lower=0.15, upper=0.45),
    }
    sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7,
        implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=3
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn, normalize_inputs=True)


def rank_main(rank: int, world: int, root: str, job: dict[str, object]) -> None:
    """One rank: join, build the global mesh, train with rank 0's commit and
    write what it saw to ``root``."""
    device = join_world(rank, world, root, job)
    runtime = current_runtime()
    # slice axis = one row per process; contract data parallelism spans
    # ("slice", "batch")
    spec = build_global_mesh_spec(
        num_slices=world, batch_shards_per_slice=1, paths_shards=1
    ).expect("global mesh")
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    pricer = GbmCVNNPricer.create(make_config(job["implementation"]), device=device,
                                  mesh_spec=spec).expect("pricer")
    store = AsyncBlockchainModelStore(FileSystemObjectStore(job["store"], "models"))
    commit_fn = coordinator_only(make_commit_fn(store), name="commit")
    tc = build_training_config(num_batches=8, batch_size=8, learning_rate=2e-3).expect("tc")
    result = pricer.train(tc, commit_plan=FinalCommit(), commit_fn=commit_fn).expect("train")
    Path(root, f"rank{rank}.json").write_text(json.dumps({
        "mesh": spec.shape,
        "process_index": runtime.process_index, "process_count": runtime.process_count,
        "global_device_count": runtime.global_device_count,
        "is_coordinator": runtime.is_coordinator, "total_batches": result.total_batches,
        "losses": [float(x) for x in result.losses], "final_loss": result.final_loss,
        "launches": launches_since(before), "digest": state_digest(pricer.model)}))
    shutdown_distributed()


def run(device: torch.device | str, *, processes: int = 2, implementation: str = "cuda",
        timeout_s: float = 600.0) -> dict[str, object]:
    """What each rank saw (its index, the world, its losses and launches),
    the ranks' devices and backend, whether they ended on one replica, and
    the chain the run left: its verdict and its versions."""
    devices, backend = rank_layout(device, processes)
    with tempfile.TemporaryDirectory() as store_root:
        ranks = run_ranks(__file__, processes, {
            "devices": devices, "backend": backend, "store": store_root,
            "implementation": implementation, "timeout_s": timeout_s}, timeout_s)
        store = AsyncBlockchainModelStore(FileSystemObjectStore(store_root, "models"))
        verdict = asyncio.run(verify_chain_detailed(store)).expect("verify")
        versions = asyncio.run(store.list_versions()).expect("list")
    launches: dict[str, int] = {}
    for r in ranks:
        for branch, n in r["launches"].items():
            launches[branch] = launches.get(branch, 0) + n
    return {"devices": devices, "backend": backend, "ranks": ranks, "verdict": verdict,
            "versions": [(v.version_id, v.message) for v in versions],
            "replicas_equal": len({r["digest"] for r in ranks}) == 1,
            "rank_launches": launches}


def main(argv: list[str] | None = None) -> None:
    as_rank = rank_args(argv)
    if as_rank is not None:
        rank_main(*as_rank)
        return
    out = run(device_from_argv(__doc__, argv))
    print(f"ranks: {len(out['devices'])} x {out['devices'][0]} over {out['backend']}, "
          f"global mesh {out['ranks'][0]['mesh']}")
    for r in out["ranks"]:
        i = r["process_index"]
        print(f"[worker {i}] joined: {r['process_count']} processes, "
              f"{r['global_device_count']} global devices")
        print(f"[worker {i}] trained {r['total_batches']} batches, final loss "
              f"{r['final_loss']:.4f}"
              + (" (committed HEAD)" if r["is_coordinator"] else " (commit gated off)"))
    assert isinstance(out["verdict"], ChainValid) and len(out["versions"]) == 1
    print(f"chain HEAD: {out['versions'][-1][0]} — exactly one commit from process 0")


if __name__ == "__main__":
    main()
