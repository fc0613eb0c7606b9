"""Run one cell of the benchmark of ``spectralmc_tpu_torch`` once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its limits and its metrics are
found by name (``portbench/core.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, which also
close standard error. Without a card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import checks, core  # noqa: E402

NO_CARD = 3
FORBIDDEN_LOADED = 4


def power_limit_w() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: Any, started: float) -> tuple[dict[str, Any], list[checks.Check]]:
    """The result line's object and the checks of one run (no card check:
    the caller chose ``device``)."""
    import torch

    cell = core.load_cell(root, workload)
    ctx = core.Context(cell, seed, seconds, trace, torch.device(device), started)
    core.stamp(ctx, "imported")
    outcome = core.traffic_driver(root, cell.traffic["driver"]).run(ctx)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = core.metric_reader(root, m["name"]).read(outcome, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu"
    dev: dict[str, Any] = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
                           "kind": kind, "count": cell.chips,
                           "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if ctx.device.type == "cuda":
        dev["power_limit"] = power_limit_w()
    result: dict[str, Any] = {
        "correct": bool(outcome.attempted > 0 and all(c.ok for c in outcome.checks)),
        "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
        "device": dev}
    if trace and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
        result["breakdown"] = outcome.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return result, outcome.checks


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: a steadier host
    import torch

    torch.set_num_threads(1)

    chips = core.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {have}; no result",
              file=sys.stderr)
        return NO_CARD
    result, found = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda:0", STARTED)
    loaded = core.forbidden_loaded()
    if loaded:
        print(f"portbench: loaded in the measuring process: {loaded}; no result", file=sys.stderr)
        return FORBIDDEN_LOADED
    checks.report(found)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
