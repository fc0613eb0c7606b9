"""The system under test: ``spectralmc_tpu_torch``'s pricer, built from a
configuration file and handed the benchmark's inputs and weights.

This is the one harness module that imports the program. It takes from it
the pricer, its kernel launch counters, and one seam to read what the timed
call produced in its first steps (``Capture``).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from spectralmc_tpu_torch.core.result import Failure
from spectralmc_tpu_torch.models.factory import CVNNConfig
from spectralmc_tpu_torch.ops import gbm_cuda
from spectralmc_tpu_torch.ops.gbm import build_simulation_params
from spectralmc_tpu_torch.ops.sobol import BoundSpec
from spectralmc_tpu_torch.runtime.torch_runtime import get_torch_handle
from spectralmc_tpu_torch.training import step as step_module
from spectralmc_tpu_torch.training.trainer import (
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    TrainingConfig,
    build_training_config,
)

__all__ = ["Capture", "Failure", "apply_runtime", "kernel_launches", "make_pricer",
           "quiet_residue_warnings", "training_config"]


def apply_runtime() -> None:
    """The port's numerics policy: TF32 off, deterministic algorithms."""
    get_torch_handle()


def make_pricer(config: dict[str, Any], seed: int, device: torch.device,
                weights: dict[str, np.ndarray], mesh_spec: Any = None) -> GbmCVNNPricer:
    """A fresh pricer of ``config`` whose sampler and Monte-Carlo stream are
    keyed by ``seed`` and whose weights and batch-norm state are ``weights``
    (flat ``params/<path>`` and ``state/<path>`` keys); with ``mesh_spec``
    this rank's replica of a sharded pricer."""
    p = config["pricer"]
    sim = build_simulation_params(
        timesteps=p["timesteps"], network_size=p["network_size"],
        batches_per_mc_run=p["batches_per_mc_run"], mc_seed=seed,
        implementation=p["implementation"], payoff=p["payoff"], model=p["model"],
        sampling=p["sampling"], normalization=p["normalization"], scheme=p["scheme"],
        **p.get("knobs", {}),
    ).expect("simulation params")
    cvnn = CVNNConfig.model_validate({**config["cvnn"], "seed": seed % 2**31})
    bounds = {k: BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in config["bounds"].items()}
    pricer_config = GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn,
                                        normalize_inputs=p["normalize_inputs"],
                                        model_state=weights)
    return GbmCVNNPricer.create(pricer_config, device=device,
                                mesh_spec=mesh_spec).expect("pricer")


def training_config(config: dict[str, Any], num_batches: int) -> TrainingConfig:
    t = config["training"]
    return build_training_config(num_batches=num_batches, batch_size=t["batch_size"],
                                 learning_rate=t["learning_rate"],
                                 contract_chunk=t["contract_chunk"]).expect("training config")


def kernel_launches() -> dict[str, int]:
    """The program's own launch counts, by kernel and branch."""
    return dict(gbm_cuda.LAUNCHES_BY_BRANCH)


def quiet_residue_warnings() -> None:
    """Untrained weights trip ``predict_price``'s inverse-FFT residue warning
    on every call; raise the trainer's logger to ERROR so that no log write
    lands in the window."""
    logging.getLogger("spectralmc_tpu_torch.training.trainer").setLevel(logging.ERROR)


class Capture:
    """What the timed ``train`` call produced in its first ``steps`` steps.

    While installed, every Monte-Carlo chunk the fused step computes is kept
    (its draws, contracts and spectrum targets), the Adam state is read as
    step 2 starts (its first moments are the first gradient times 1 − b1) and
    the weights as step ``steps + 1`` starts.
    """

    def __init__(self, pricer: GbmCVNNPricer, chunks_per_step: int, steps: int) -> None:
        self._pricer, self._per_step, self._steps = pricer, chunks_per_step, steps
        self._chunks = 0
        self._original = step_module.make_mc_spectrum
        self.contracts: list[torch.Tensor] = []
        self.targets: list[torch.Tensor] = []
        self.first_mu: dict[str, np.ndarray] | None = None
        self.weights_after: dict[str, np.ndarray] | None = None

    @property
    def done(self) -> bool:
        return self.weights_after is not None

    def _on_chunk(self) -> None:
        if self._chunks == self._per_step and self.first_mu is None:
            self.first_mu = dict(self._pricer.snapshot().optimizer_state.mu)
        if self._chunks == self._steps * self._per_step and self.weights_after is None:
            state = self._pricer.snapshot().model_state
            self.weights_after = {k[len("params/"):]: v for k, v in state.items()
                                  if k.startswith("params/")}

    def __enter__(self) -> "Capture":
        def make_mc_spectrum(sim: Any, **kw: Any) -> Any:
            inner = self._original(sim, **kw)

            def mc_spectrum(draws: torch.Tensor, contracts: torch.Tensor) -> torch.Tensor:
                self._on_chunk()
                out = inner(draws, contracts)
                if self._chunks < self._steps * self._per_step:
                    self.contracts.append(contracts.detach().clone())
                    self.targets.append(out.detach().clone())
                self._chunks += 1
                return out

            return mc_spectrum

        step_module.make_mc_spectrum = make_mc_spectrum
        return self

    def __exit__(self, *exc: object) -> None:
        step_module.make_mc_spectrum = self._original
        self.contracts = [t.cpu() for t in self.contracts]
        self.targets = [t.cpu() for t in self.targets]

    def per_step(self, batch: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """``(contracts, targets)`` of each captured step, ``[B, D]`` and ``[B, N]``."""
        contracts, targets = torch.cat(self.contracts), torch.cat(self.targets)
        return ([contracts[i:i + batch] for i in range(0, contracts.shape[0], batch)],
                [targets[i:i + batch] for i in range(0, targets.shape[0], batch)])
