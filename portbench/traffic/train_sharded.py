"""Closed-loop data-parallel training: ``traffic/train.py``'s trainer on a
mesh of ``mesh`` = (batch shards, paths shards) ranks, one process a card
(``portbench/ranks.py``), joined over ``torch.distributed`` (``nccl`` on
the cards, ``gloo`` on the CPU) through a rendezvous file in a directory of
the run's own under the temporary directory. NCCL's shared-memory transport
is off, so nothing lands in ``/dev/shm``.

Rank 0's clock closes every rank's window, rank 0 alone traces, and the
ranks write their measures and checked steps to that directory; the run
gathers them (the batch of a step is its ranks' shards in rank order),
waits for every rank to end and then runs the reference, on card 0, on the
whole batch with each shard's own batch statistics.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

from portbench import core, inputs, train_check
from portbench.core import Context, Outcome

RANK_TIMEOUT_S = 320.0


def _rank_files(ctx: Context, where: str) -> list[dict[str, Any]]:
    world, root = ctx.cell.chips, ctx.cell.root
    started = time.time() - (time.perf_counter() - ctx.started)
    env = {**os.environ, "NCCL_SHM_DISABLE": "1",
           "PYTHONPATH": os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")])}
    argv = [str(root), ctx.cell.name, str(ctx.seed), str(ctx.seconds), str(int(ctx.trace))]
    procs = [subprocess.Popen([sys.executable, "-m", "portbench.ranks", *argv, str(rank),
                               str(world), where, repr(started), ctx.device.type], env=env)
             for rank in range(world)]
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed with exit codes {bad}")
    return [torch.load(Path(where) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _steps(chunks: list[torch.Tensor], local: int) -> list[torch.Tensor]:
    rows = torch.cat(chunks)
    return [rows[i:i + local] for i in range(0, rows.shape[0], local)]


def measured(ctx: Context) -> tuple[Any, train_check.Side, list[torch.Tensor],
                                    dict[str, torch.Tensor]]:
    config = ctx.cell.config
    shards = ctx.cell.traffic["mesh"][0]
    local = config["training"]["batch_size"] // shards
    where = tempfile.mkdtemp(prefix="portbench-ranks-")
    try:
        ranks = _rank_files(ctx, where)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    first = ranks[0]
    per_rank = [(_steps(r["contracts"], local), _steps(r["targets"], local)) for r in ranks]
    count = min(len(c) for c, _ in per_rank)
    contracts = [torch.cat([c[s] for c, _ in per_rank]) for s in range(count)]
    targets = [torch.cat([t[s] for _, t in per_rank]) for s in range(count)]
    weights = inputs.make_weights(inputs.network(config), ctx.seed, ctx.device)
    got = train_check.program_side(contracts, targets, first["losses"], first["first_mu"],
                                   first["weights_after"], weights,
                                   train_check.sample(config, ctx.seed))
    missing = [r["missing_launches"] for r in ranks]
    s = core.traffic_driver(ctx.cell.root, "train").Session(
        first["attempted"], first["failed"],
        dict(first["measures"], setup_s=max(r["measures"]["setup_s"] for r in ranks)),
        max(r["memory_peak"] for r in ranks), first["reading"], None, first["losses"],
        None if None in missing else float(sum(missing)))
    return s, got, targets, weights


def run(ctx: Context) -> Outcome:
    return core.traffic_driver(ctx.cell.root, "train").run(ctx, ctx.cell.traffic["mesh"][0],
                                                            measured)
