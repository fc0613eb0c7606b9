"""Model-family dispatch — the (PayoffKind × SimImplementation) seam.

The port of the JAX package's ``ops/dispatch.py`` for GBM dynamics with
pseudo-random paths and flat market data: every payoff kind but the
American ones, on the threefry engine or the CUDA kernels. Every caller
builds its simulator here. Simulators take a BATCH of contracts — one kernel
launch per batch on the ``"cuda"`` engine — where the JAX package ``vmap``s
a one-contract simulator.
"""

from __future__ import annotations

from typing import Callable

import torch

from spectralmc_tpu_torch.ops.gbm import (
    CONTRACT_DIM,
    BlackScholesContract,
    PayoffKind,
    SimImplementation,
    SimulationParams,
    expected_underlier_mean,
    require_slice,
    resolve_implementation,
    simulate_underlier_rows,
)
from spectralmc_tpu_torch.ops.gbm_cuda import (
    simulate_cliquet_rows_cuda,
    simulate_underlier_rows_cuda,
)

Simulator = Callable[..., torch.Tensor]


def contract_class(sim: SimulationParams) -> type:
    """The contract model for the sim's dynamics (the model-family seam)."""
    require_slice(sim)
    return BlackScholesContract


def contract_dim(sim: SimulationParams) -> int:
    require_slice(sim)
    return CONTRACT_DIM


def make_underlier_simulator(sim: SimulationParams, *, rows: int) -> Simulator:
    """``(key_words [C, 2], contracts [C, 6], row_offset=0) -> [C, rows, network]``.

    The engine is the one ``resolve_implementation`` says will run: on
    ``"cuda"`` cliquets go to the cliquet kernel and every other payoff to
    the flat kernel, each with its knobs; on ``"xla"`` to the threefry
    simulator. Both engines key rows by GLOBAL index, so ``row_offset``
    shards are stable.
    """
    require_slice(sim)
    resolved = resolve_implementation(sim)
    anti_half = sim.batches_per_mc_run // 2 if sim.antithetic else None
    if resolved == SimImplementation.PALLAS:
        raise ValueError(
            "the 'pallas' engine draws the TPU hardware PRNG; this package cannot run it"
        )
    if resolved == SimImplementation.CUDA:
        if sim.payoff == PayoffKind.CLIQUET:

            def simulate_cliquet(
                key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
            ) -> torch.Tensor:
                return simulate_cliquet_rows_cuda(
                    contracts.to(torch.float32),
                    key_words,
                    timesteps=sim.timesteps,
                    rows=rows,
                    cols=sim.network_size,
                    reset_every=sim.cliquet_reset_every,
                    floor=sim.cliquet_floor,
                    cap=sim.cliquet_cap,
                    antithetic_half=anti_half,
                    row_offset=row_offset,
                )

            return simulate_cliquet

        def simulate_cuda(
            key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
        ) -> torch.Tensor:
            return simulate_underlier_rows_cuda(
                contracts.to(torch.float32),
                key_words,
                timesteps=sim.timesteps,
                rows=rows,
                cols=sim.network_size,
                scheme=sim.scheme,
                payoff=sim.payoff,
                barrier_rel=sim.barrier_rel,
                forward_start_step=sim.forward_start_step,
                antithetic_half=anti_half,
                row_offset=row_offset,
            )

        return simulate_cuda

    dtype = sim.precision.to_torch()

    def simulate_xla(
        key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
    ) -> torch.Tensor:
        return simulate_underlier_rows(
            key_words,
            contracts,
            timesteps=sim.timesteps,
            rows=rows,
            cols=sim.network_size,
            dtype=dtype,
            scheme=sim.scheme,
            payoff=sim.payoff,
            row_offset=row_offset,
            barrier_rel=sim.barrier_rel,
            antithetic_half=anti_half,
            forward_start_step=sim.forward_start_step,
            cliquet_reset_every=sim.cliquet_reset_every,
            cliquet_floor=sim.cliquet_floor,
            cliquet_cap=sim.cliquet_cap,
        )

    return simulate_xla


def make_mean_target(sim: SimulationParams) -> Callable[[torch.Tensor], torch.Tensor | None]:
    """``contracts [..., 6] -> E[underlier] [...]``, the payoff's own analytic
    mean (None where no closed form exists)."""
    require_slice(sim)
    dtype = sim.precision.to_torch()

    def mean_target(contracts: torch.Tensor) -> torch.Tensor | None:
        return expected_underlier_mean(
            contracts,
            timesteps=sim.timesteps,
            payoff=sim.payoff,
            dtype=dtype,
            forward_start_step=sim.forward_start_step,
            cliquet_reset_every=sim.cliquet_reset_every,
            cliquet_floor=sim.cliquet_floor,
            cliquet_cap=sim.cliquet_cap,
        )

    return mean_target


__all__ = [
    "contract_class",
    "contract_dim",
    "make_mean_target",
    "make_underlier_simulator",
]
