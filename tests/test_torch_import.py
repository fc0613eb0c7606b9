"""The PyTorch port imports with JAX unavailable (tier 1: exact).

A subprocess, because this test process already imported jax (conftest).
Every module of ``spectralmc_tpu_torch`` is imported with ``jax`` and the
JAX package blocked in ``sys.modules``.
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
