"""The readings the limits of ``portbench/limits/<cell>.json`` are set from.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--device cuda:0]

For each seed, in one process and at the cell's own size: the program's
numbers against the reference (the lower readings), and the numbers of the
control and of the planted faults, each put in the program's place:

* ``control``: the reference computed in bfloat16, the precision below the
  configuration's float32;
* training cells, ``half_batch``: the reference trained on half of each
  batch, the mean taken over the rest (a state left unchanged reads 1 on
  ``change_gap`` and ``grad_gap`` by their measure and needs no run); on a
  mesh, ``exchange_left_out``: rank 0 trained on its own shard alone;
* serving cells, ``altered``: one served price replaced by its neighbour's
  in every checked call; ``half_book``: the second half of every book left
  unpriced.

Prints one JSON line per seed and reading. Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import core, inputs, program, serve_check, train_check  # noqa: E402

CHECKED_CALLS = 8


def train_readings(cell: core.Cell, seed: int, device: torch.device) -> dict[str, dict]:
    config = cell.config
    batch = config["training"]["batch_size"]
    shards = cell.traffic.get("mesh", [1, 1])[0]
    ctx = core.Context(cell, seed, 0.0, False, device, time.perf_counter())
    _, got, targets, weights = core.traffic_driver(cell.root, cell.traffic["driver"]).measured(ctx)
    picked = train_check.sample(config, seed)

    def reference(**kw: object) -> train_check.Side:
        return train_check.reference_side(config, seed, device, weights, targets, picked, **kw)

    want = reference(shards=shards)
    readings = {"program": train_check.compare(config, got, want),
                "control": train_check.compare(config, reference(dtype=torch.bfloat16,
                                                                 shards=shards), want),
                "half_batch": train_check.compare(config, reference(rows=slice(0, batch // 2),
                                                                    shards=shards), want)}
    if shards > 1:  # each rank trains on its own shard: rank 0's is what it reports
        readings["exchange_left_out"] = train_check.compare(
            config, reference(rows=slice(0, batch // shards)), want)
    return readings


def serve_readings(cell: core.Cell, seed: int, device: torch.device) -> dict[str, dict]:
    config, mix = cell.config, cell.traffic
    program.quiet_residue_warnings()
    weights = inputs.make_weights(inputs.network(config), seed, device)
    pricer = program.make_pricer(config, seed, device,
                                 {k: v.cpu().numpy() for k, v in weights.items()})
    books = inputs.books(config, seed, CHECKED_CALLS, mix["smallest"], mix["largest"])
    served = [pricer.predict_price(book) for book in books]
    got = [(p.put, p.call) for p in served]
    del pricer
    want = [serve_check.reference_prices(config, weights, b, device) for b in books]
    low = [serve_check.reference_prices(config, weights, b, device, torch.bfloat16)
           for b in books]

    def altered(pair: tuple[np.ndarray, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        put, call = pair[0].copy(), pair[1].copy()
        put[0], call[0] = put[1], call[1]
        return put, call

    half = [(p[:len(p) // 2], c[:len(c) // 2]) for p, c in got]
    return {"program": serve_check.compare(got, want),
            "control": serve_check.compare(low, want),
            "altered": serve_check.compare([altered(g) for g in got], want),
            "half_book": serve_check.compare(half, want)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    program.apply_runtime()
    cell = core.load_cell(ROOT, args.workload)
    readings = serve_readings if cell.traffic["driver"] == "serve" else train_readings
    for seed in args.seeds:
        start = time.perf_counter()
        for kind, numbers in readings(cell, seed, device).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": kind,
                              **numbers}), flush=True)
        print(f"control: seed {seed} took {time.perf_counter() - start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
