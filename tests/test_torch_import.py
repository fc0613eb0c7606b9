"""The PyTorch port imports with JAX unavailable (tier 1: exact).

A subprocess, because this test process already imported jax (conftest).
Every module of ``spectralmc_tpu_torch``, the port's examples and its model
checker are imported with ``jax`` and the JAX package blocked in
``sys.modules``.
"""

from __future__ import annotations

import pkgutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _port_modules() -> list[str]:
    import spectralmc_tpu_torch

    return [
        m.name
        for m in pkgutil.walk_packages(spectralmc_tpu_torch.__path__, "spectralmc_tpu_torch.")
    ]


def test_every_port_module_imports_without_jax() -> None:
    modules = _port_modules()
    assert "spectralmc_tpu_torch.training.trainer" in modules
    for name in ("effects.interpreter", "effects.registry", "effects.mock",
                 "training.effects_builders", "utils.flops", "utils.profiling",
                 "utils.tensorboard_writer"):
        assert f"spectralmc_tpu_torch.{name}" in modules
    for name in ("gbm_cuda", "dynamics_cuda", "heston", "merton", "basket", "basket_cuda", "qmc",
                 "qmc_cuda", "american", "american_cuda", "greeks", "collectives"):
        assert f"spectralmc_tpu_torch.ops.{name}" in modules
    for name in ("parallel", "parallel.mesh", "parallel.trainer", "parallel.distributed",
                 "runtime.transfer"):
        assert f"spectralmc_tpu_torch.{name}" in modules
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spectralmc_tpu'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=100
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_lazy_top_level_exports_resolve() -> None:
    import spectralmc_tpu_torch as port

    for name in port.__all__:
        if name != "__version__":
            assert getattr(port, name) is not None


def test_top_level_exports_are_the_modules_own_objects() -> None:
    import importlib

    import spectralmc_tpu_torch as port

    for name, module in (("term_effective_black", "ops.analytic"), ("lsmc_price", "ops.american"),
                         ("bermudan_tree_price", "ops.american"), ("OptionSide", "ops.american"),
                         ("BlackScholes", "ops.gbm"), ("mc_greeks", "ops.greeks"),
                         ("analytic_greeks", "ops.greeks")):
        assert name in port.__all__
        assert getattr(port, name) is getattr(
            importlib.import_module(f"spectralmc_tpu_torch.{module}"), name)


def test_examples_and_checker_import_without_jax() -> None:
    """``examples/torch/*.py`` and ``tools/torch_model_check.py`` load with
    JAX and the JAX package blocked, and load neither."""
    paths = sorted(str(p) for p in (REPO / "examples" / "torch").glob("*.py"))
    paths.append(str(REPO / "tools" / "torch_model_check.py"))
    assert len(paths) == 15  # 13 examples, their shared module, the checker
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spectralmc_tpu'] = None\n"
        "import importlib.util\n"
        f"for i, path in enumerate({paths!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'loaded_{i}', path)\n"
        "    sys.modules[spec.name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(sys.modules[spec.name])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and (\n"
        "    m == 'jax' or m.startswith('jax.') or m == 'spectralmc_tpu'\n"
        "    or m.startswith('spectralmc_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=100
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_storage_cli_loads_without_torch() -> None:
    """The storage CLI (the ``spectralmc-torch-storage`` console script)
    works on chain bytes alone: it loads, and answers ``--help``, with torch
    blocked."""
    script = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.argv = ['spectralmc-torch-storage', '--help']\n"
        "from spectralmc_tpu_torch.storage.__main__ import main\n"
        "try:\n"
        "    main()\n"
        "except SystemExit as exit:\n"
        "    assert exit.code == 0, exit.code\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=100
    )
    assert proc.returncode == 0, proc.stderr
    assert "verify" in proc.stdout
