"""Throwaway benchmark roots for the CPU tests: a copy of ``portbench/`` and
a ``BENCHMARK.json`` in a temporary directory, with cells cut to a size the
CPU runs in seconds (the port's ``"cuda"`` engine runs its plain twin on CPU
tensors). A new cell, configuration or metric is added there as a later
change adds one: new files and new entries, no edit of a file that is there.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TINY = {"train": "tiny_train", "american": "tiny_american", "serve": "tiny_serve",
        "sharded": "tiny_train_x4"}


def tiny_config(name: str = "gbm_terminal_8k") -> dict[str, Any]:
    config = json.loads((HERE / "configs" / f"{name}.json").read_text())
    config["name"] = f"tiny_{name}"
    config["pricer"].update(network_size=32, batches_per_mc_run=8)
    layers = config["cvnn"]["layers"]
    layers[0]["width"] = 16
    for layer in layers[2]["body"]["layers"]:
        layer["width"] = 16
    config["training"].update(batch_size=16, contract_chunk=8)
    config["kernel_branches"] = []  # the plain twin counts no launch
    return config


def make_root(tmp: Path) -> Path:
    """A root whose ``BENCHMARK.json`` adds the cells ``tiny_train``,
    ``tiny_american``, ``tiny_serve`` and ``tiny_train_x4`` (four ``gloo``
    ranks on the CPU; files ``configs/tiny_*.json``,
    ``traffic/tiny_serve_book.json`` and ``limits/tiny_*.json``)."""
    shutil.copytree(HERE, tmp / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp / "portbench"
    for name in ("gbm_terminal_8k", "gbm_american_put_8k"):
        (pb / "configs" / f"tiny_{name}.json").write_text(json.dumps(tiny_config(name)))
    mix = json.loads((HERE / "traffic" / "closed_serve_book.json").read_text())
    mix.update(books=4, smallest=33, largest=64, check_every=2, trace_calls=3)
    (pb / "traffic" / "tiny_serve_book.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] += [{"name": f"tiny_{name}", "source": "test", "reduced": [],
                          "file": f"portbench/configs/tiny_{name}.json", "why": "a CPU-sized copy"}
                         for name in ("gbm_terminal_8k", "gbm_american_put_8k")]
    bench["workloads"] += [
        {"name": TINY["train"], "config": "tiny_gbm_terminal_8k", "traffic": "closed_train_4",
         "chips": 1, "why": "test"},
        {"name": TINY["american"], "config": "tiny_gbm_american_put_8k",
         "traffic": "closed_train_2", "chips": 1, "why": "test"},
        {"name": TINY["serve"], "config": "tiny_gbm_terminal_8k", "traffic": "tiny_serve_book",
         "chips": 1, "why": "test"},
        {"name": TINY["sharded"], "config": "tiny_gbm_terminal_8k",
         "traffic": "closed_train_4_x4", "chips": 4, "why": "test"}]
    copies = {"terminal_train_8k": TINY["train"], "american_put_train_8k": TINY["american"],
              "terminal_serve_book": TINY["serve"]}
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] += [copies[w] for w in metric["workloads"] if w in copies]
            if TINY["train"] in metric["workloads"]:  # the mesh reports what one card does
                metric["workloads"].append(TINY["sharded"])
    # the mesh's cell is not in the checkout's BENCHMARK.json (PERF.md says why):
    # its limits file, its traffic mix and its metric's reader are, and an entry adds each
    bench["per_layer"].append({"name": "allreduce_ms_per_step", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "collectives",
                              "moves": "train_contracts_per_s", "workloads": [TINY["sharded"]]})
    for cell, tiny in {**copies, "terminal_train_8k_x4": TINY["sharded"]}.items():
        shutil.copy(pb / "limits" / f"{cell}.json", pb / "limits" / f"{tiny}.json")
    # at 256 paths a contract the exercise decisions that flip between the
    # estimator's two float32 orders of summation move a price by percents
    limits = json.loads((pb / "limits" / f"{TINY['american']}.json").read_text())
    limits.pop("target_gap", None)
    limits["price_gap"] = 0.05
    (pb / "limits" / f"{TINY['american']}.json").write_text(json.dumps(limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
