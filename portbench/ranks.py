"""One rank of a sharded training cell, in a process of its own on card
``rank`` (or on the CPU with ``gloo``).

    python3 -m portbench.ranks <root> <workload> <seed> <seconds> <trace> <rank> <world> <dir> <started> <device>

It joins the world over a rendezvous file in ``<dir>``, builds its replica
of the pricer on the cell's mesh, runs ``traffic/train.py``'s session (rank
0's clock closes the window for every rank, and only rank 0 traces) and
writes ``<dir>/rank<rank>.pt``: its measures and its captured steps.
``<started>`` is the wall-clock time at which the run started, the origin
of ``setup_s``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist


def main(argv: list[str]) -> None:
    root, workload, seed, seconds, trace, rank, world, where, started, kind = argv
    rank_i, world_i = int(rank), int(world)
    root_path = Path(root)
    if str(root_path) not in sys.path:
        sys.path.insert(0, str(root_path))
    from portbench import core, inputs, program
    from spectralmc_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )
    from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec

    cell = core.load_cell(root_path, workload)
    mix = cell.traffic
    if kind == "cuda":
        torch.cuda.set_device(rank_i)
    device = torch.device("cuda", rank_i) if kind == "cuda" else torch.device("cpu")
    program.apply_runtime()
    initialize_distributed(coordinator_address=f"file://{where}/rendezvous",
                           num_processes=world_i, process_id=rank_i, device_type=device.type,
                           timeout_s=600.0).expect("join")
    mesh = build_mesh_spec(batch_shards=mix["mesh"][0], paths_shards=mix["mesh"][1]).expect("mesh")
    # the process started after the run did: set-up counts from the run's start
    origin = time.perf_counter() - (time.time() - float(started))
    ctx = core.Context(cell, int(seed), float(seconds), trace == "1", device, origin)
    flag = torch.zeros(1, device=device)

    def agree(done: bool) -> bool:
        flag.fill_(float(done))
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    weights = inputs.make_weights(inputs.network(cell.config), int(seed), device)
    driver = core.traffic_driver(root_path, "train")
    s = driver.session(ctx, weights, mesh_spec=mesh, profile=rank_i == 0, agree=agree)
    torch.save({"attempted": s.attempted, "failed": s.failed, "measures": s.measures,
                "memory_peak": s.memory_peak, "reading": s.reading, "losses": s.losses,
                "missing_launches": s.missing_launches, "contracts": s.capture.contracts,
                "targets": s.capture.targets, "first_mu": s.capture.first_mu,
                "weights_after": s.capture.weights_after}, Path(where) / f"rank{rank_i}.pt")
    shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
