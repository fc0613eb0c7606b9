"""A run with the timed path broken underneath comes out not correct, and so
does the control: CPU-sized cells, the harness's look for a card skipped.

Faults, each planted in the program for one run: a training step that
returns its state unchanged; half of each batch left out, the mean taken
over the rest; on a mesh, the exchange between the ranks left out (planted
in the rank processes through a ``sitecustomize`` module); a served price
altered where it is produced; half of every book left unpriced. The control, the reference in bfloat16 put in the
program's place, and the planted faults read through ``control.py`` must
fail at least one limit while the program passes all.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, core, run, tinycell
from spectralmc_tpu_torch.training import step as step_module
from spectralmc_tpu_torch.training import trainer as trainer_module

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory: pytest.TempPathFactory) -> Path:
    return tinycell.make_root(tmp_path_factory.mktemp("faults"))


def _correct(root: Path, cell: str) -> bool:
    result, _ = run.run_cell(root, cell, SEED, 0.3, False, "cpu", 0.0)
    return result["correct"]


@pytest.mark.parametrize("cell", sorted(tinycell.TINY.values()))
def test_unbroken_runs_are_correct(tiny_root: Path, cell: str) -> None:
    assert _correct(tiny_root, cell)


def test_state_left_unchanged(tiny_root: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(step_module, "adam_update_", lambda params, grads, state, lr: None)
    assert not _correct(tiny_root, tinycell.TINY["train"])


def test_half_of_the_batch_left_out(tiny_root: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    original = trainer_module.make_fused_batch

    def half(model, sim, table, *, batch_size, **kw):
        return original(model, sim, table, batch_size=batch_size // 2,
                        **{**kw, "contract_chunk": kw["contract_chunk"] // 2})

    monkeypatch.setattr(trainer_module, "make_fused_batch", half)
    assert not _correct(tiny_root, tinycell.TINY["train"])


def test_last_chunk_of_each_step_broken(tiny_root: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    """The last chunk of every step simulates its neighbours' contracts: the
    network's stage trains on the program's targets and cannot see it, the
    sampled targets (one in every chunk) can."""
    config = core.load_cell(tiny_root, tinycell.TINY["train"]).config
    per_step = config["training"]["batch_size"] // config["training"]["contract_chunk"]
    original = step_module.make_mc_spectrum
    chunks = [0]

    def make_mc_spectrum(sim, **kw):
        inner = original(sim, **kw)

        def mc_spectrum(draws: torch.Tensor, contracts: torch.Tensor) -> torch.Tensor:
            chunks[0] += 1
            return inner(draws, contracts.roll(1, 0) if chunks[0] % per_step == 0 else contracts)

        return mc_spectrum

    monkeypatch.setattr(step_module, "make_mc_spectrum", make_mc_spectrum)
    assert not _correct(tiny_root, tinycell.TINY["train"])


def test_served_price_altered(tiny_root: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    original = trainer_module.GbmCVNNPricer._predict_packed

    def altered(self, arr: torch.Tensor) -> torch.Tensor:
        packed = original(self, arr).clone()
        packed[3] = packed[4]
        return packed

    monkeypatch.setattr(trainer_module.GbmCVNNPricer, "_predict_packed", altered)
    assert not _correct(tiny_root, tinycell.TINY["serve"])


def test_half_of_the_book_unpriced(tiny_root: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    original = trainer_module.GbmCVNNPricer.predict_price

    def half(self, contracts, **kw):
        prices = original(self, contracts, **kw)
        n = len(prices.put) // 2
        return trainer_module.PricePrediction(put=prices.put[:n], call=prices.call[:n],
                                              imag_residue=prices.imag_residue)

    monkeypatch.setattr(trainer_module.GbmCVNNPricer, "predict_price", half)
    assert not _correct(tiny_root, tinycell.TINY["serve"])


RANK_PLANTS = {
    "state_unchanged": "import spectralmc_tpu_torch.training.step as s\n"
                       "s.adam_update_ = lambda params, grads, state, lr: None\n",
    "half_batch": "import spectralmc_tpu_torch.training.trainer as t\n"
                  "make = t.make_fused_batch\n"
                  "def half(model, sim, table, *, batch_size, **kw):\n"
                  "    kw['contract_chunk'] //= 2\n"
                  "    return make(model, sim, table, batch_size=batch_size // 2, **kw)\n"
                  "t.make_fused_batch = half\n",
    "exchange_left_out": "import spectralmc_tpu_torch.training.step as s\n"
                         "s.pmean_many = lambda tensors, group: list(tensors)\n",
}


@pytest.mark.parametrize("fault", sorted(RANK_PLANTS))
def test_sharded_faults(tiny_root: Path, tmp_path: Path, monkeypatch: pytest.MonkeyPatch,
                        fault: str) -> None:
    (tmp_path / "sitecustomize.py").write_text(RANK_PLANTS[fault])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path),
                                                      os.environ.get("PYTHONPATH", "")]))
    assert not _correct(tiny_root, tinycell.TINY["sharded"])


@pytest.mark.parametrize("cell", sorted(tinycell.TINY.values()))
def test_control_and_faults_fail_a_limit(tiny_root: Path, cell: str) -> None:
    loaded = core.load_cell(tiny_root, cell)
    readings = (control.serve_readings if loaded.traffic["driver"] == "serve"
                else control.train_readings)(loaded, SEED, torch.device("cpu"))
    limits = loaded.limits

    def fails(numbers: dict[str, float]) -> bool:
        return any(not np.isfinite(v) or v > limits[k] for k, v in numbers.items() if k in limits)

    assert not fails(readings.pop("program"))
    assert set(readings) >= {"control"}
    for kind, numbers in readings.items():
        assert fails(numbers), kind


@pytest.mark.cuda
def test_cells_on_the_card(tiny_root: Path) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the path kernel runs only on the card")
    config = core.load_cell(tiny_root, tinycell.TINY["train"]).config
    assert config["kernel_branches"] == []
    for cell in tinycell.TINY.values():
        result, _ = run.run_cell(tiny_root, cell, SEED, 0.5, False, "cuda:0", 0.0)
        assert result["correct"], result["checks"]
