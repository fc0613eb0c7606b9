"""What the harness finds by name: cells, configurations, traffic mixes,
limits and metric readers, all under one root (the checkout, or a test's
temporary directory that holds a ``BENCHMARK.json`` and a ``portbench/``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

FORBIDDEN = ("jax", "jaxlib", "flax", "spectralmc_tpu")


def load_json(path: Path) -> Any:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything its run reads."""

    root: Path
    name: str
    chips: int
    config_name: str
    config: dict[str, Any]
    traffic_name: str
    traffic: dict[str, Any]
    limits: dict[str, float]
    end_to_end: list[dict[str, Any]] = field(default_factory=list)
    per_layer: list[dict[str, Any]] = field(default_factory=list)


def _applies(metric: dict[str, Any], cell: str, reported: set[str]) -> bool:
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``: its configuration file,
    its traffic mix ``portbench/traffic/<traffic>.json``, its limits
    ``portbench/limits/<cell>.json`` and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(root, name, int(w["chips"]), w["config"], config, w["traffic"], traffic, limits,
                e2e, per_layer)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a harness file by its path (metric and traffic names may hold
    dots), once a process under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def metric_reader(root: Path, name: str) -> ModuleType:
    return load_module(root / "portbench" / "metrics" / f"{name}.py", f"portbench_metric.{name}")


def traffic_driver(root: Path, driver: str) -> ModuleType:
    return load_module(root / "portbench" / "traffic" / f"{driver}.py", f"portbench_traffic.{driver}")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, jaxlib's,
    flax's or the JAX package's (``spectralmc_tpu_torch`` is the port)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """One run of one cell."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    started: float  # time.perf_counter() as the process started


@dataclass
class Outcome:
    """What a traffic driver hands back: its counts and host-clock measures,
    the traced reading (``--trace 1``), the checks and the memory peak."""

    attempted: int
    failed: int
    measures: dict[str, Any]
    checks: list[Any]
    memory_peak_bytes: int
    trace: Any = None  # tracing.TraceReading


def stamp(ctx: Context, label: str) -> None:
    """Where set-up's time goes: seconds since the process started, on stderr."""
    print(f"portbench: {label} at {time.perf_counter() - ctx.started:.3f} s", file=sys.stderr,
          flush=True)
