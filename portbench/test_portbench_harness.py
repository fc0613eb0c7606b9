"""CPU tests of the harness: discovery by name, the result line, failure
without a card, and the import rules.

    python -m pytest portbench -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core, run, tinycell

ROOT = tinycell.ROOT
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory: pytest.TempPathFactory) -> Path:
    return tinycell.make_root(tmp_path_factory.mktemp("bench"))


def test_benchmark_cells_resolve_by_name() -> None:
    bench = core.load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = core.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert core.traffic_driver(ROOT, cell.traffic["driver"]).run
        assert set(cell.limits) >= {"contracts_gap"} or set(cell.limits) >= {"put_gap"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert core.metric_reader(ROOT, m["name"]).read


def test_a_new_cell_needs_only_new_files_and_entries(tiny_root: Path) -> None:
    for kind, name in tinycell.TINY.items():
        cell = core.load_cell(tiny_root, name)
        assert cell.config["name"].startswith("tiny_gbm_")
        assert cell.traffic["driver"] == {"serve": "serve", "sharded": "train_sharded"}.get(
            kind, "train")
    # every file the checkout has is still the checkout's, byte for byte
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = tiny_root / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


@pytest.mark.parametrize("cell", sorted(tinycell.TINY.values()))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(tiny_root: Path, cell: str, trace: bool) -> None:
    result, found = run.run_cell(tiny_root, cell, SEED, 0.5, trace, "cpu", 0.0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, number in result["checks"].items():
        assert set(number) == {"value", "limit"} and number["value"] <= number["limit"], name
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["metrics"] == {}  # no device events on the CPU: every reader is silent
    else:
        assert "setup_s" in result["metrics"]
        for metric in result["metrics"].values():
            assert set(metric) == {"value", "unit"} and metric["value"] > 0
    json.dumps(result)


def test_no_card_no_result(tmp_path: Path) -> None:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "terminal_train_8k",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path: Path) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "terminal_train_8k", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _loaded_by(modules: list[str]) -> set[str]:
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import importlib; importlib.import_module({m!r})\n" for m in modules)
            + "from portbench import core\n"
            + "b = core.load_json(core.Path(%r) / 'BENCHMARK.json')\n" % str(ROOT)
            + "for m in b['end_to_end'] + b['per_layer']: core.metric_reader(core.Path(%r), m['name'])\n"
            % str(ROOT)
            + "for d in ('train', 'serve', 'train_sharded'):\n"
            + "    core.traffic_driver(core.Path(%r), d)\n" % str(ROOT)
            + "core.metric_reader(core.Path(%r), 'allreduce_ms_per_step')\n" % str(ROOT)
            + "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax() -> None:
    loaded = _loaded_by(["portbench.run", "portbench.program", "portbench.control",
                         "portbench.ranks", "spectralmc_tpu_torch.parallel.mesh"])
    assert "spectralmc_tpu_torch" in loaded  # the port is the system under test
    assert not {m for m in loaded if m.split(".")[0] in core.FORBIDDEN}


def test_the_reference_loads_nothing_of_the_program() -> None:
    modules = [f"portbench.reference.{p.stem}" for p in (ROOT / "portbench" / "reference").glob("*.py")
               if p.stem != "__init__"]
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = {m.split(".")[0] for m in out.stdout.split()}
    assert not tops & {*core.FORBIDDEN, "spectralmc_tpu_torch"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"__future__", "math", "dataclasses", "typing",
                                              "numpy", "torch", "portbench"}, (path, name)
                assert not name.startswith("portbench.") or name.startswith("portbench.reference"), (
                    path, name)


def test_forbidden_names_are_compared_whole(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setitem(sys.modules, "spectralmc_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "spectralmc_tpu.ops", sys)
    assert core.forbidden_loaded() == ["spectralmc_tpu.ops"]
