"""Model-family dispatch — the (ModelKind × PayoffKind × SimImplementation) seam.

The port of the JAX package's ``ops/dispatch.py``: the single mapping from
``SimulationParams`` to the contract model, the underlier simulator and the
analytic-mean target of its dynamics (GBM, Heston, Merton, baskets; flat or
curved market data; pseudo-random or Sobol/Brownian-bridge paths; every
payoff kind under every dynamics; the threefry engine or the CUDA
kernels). Every caller builds its simulator here. Simulators
take a BATCH of contracts — one kernel launch per batch on the ``"cuda"``
engine — where the JAX package ``vmap``s a one-contract simulator.
"""

from __future__ import annotations

from typing import Callable

import torch

from spectralmc_tpu_torch.ops.american import (
    OptionSide,
    simulate_american_underlier_rows,
    simulate_basket_american_underlier_rows,
    simulate_heston_american_underlier_rows,
    simulate_merton_american_underlier_rows,
)
from spectralmc_tpu_torch.ops.basket import (
    expected_basket_underlier_mean,
    simulate_basket_underlier_rows,
)
from spectralmc_tpu_torch.ops.collectives import ProcessGroup
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    CONTRACT_DIM,
    BlackScholesContract,
    ModelKind,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    SimulationParams,
    curved,
    expected_underlier_mean,
    resolve_implementation,
    simulate_underlier_rows,
)
from spectralmc_tpu_torch.ops.heston import (
    HESTON_CONTRACT_DIM,
    HestonContract,
    heston_expected_underlier_mean,
    simulate_heston_underlier_rows,
)
from spectralmc_tpu_torch.ops.merton import (
    MERTON_CONTRACT_DIM,
    MertonContract,
    merton_expected_underlier_mean,
    simulate_merton_underlier_rows,
)

Simulator = Callable[..., torch.Tensor]

_CONTRACTS: dict[ModelKind, tuple[type, int]] = {
    ModelKind.GBM: (BlackScholesContract, CONTRACT_DIM),
    ModelKind.HESTON: (HestonContract, HESTON_CONTRACT_DIM),
    ModelKind.MERTON_JUMP: (MertonContract, MERTON_CONTRACT_DIM),
    ModelKind.BASKET_GBM: (BlackScholesContract, CONTRACT_DIM),
}


def contract_class(sim: SimulationParams) -> type:
    """The contract model for the sim's dynamics (the model-family seam)."""
    return _CONTRACTS[sim.model][0]


def contract_dim(sim: SimulationParams) -> int:
    return _CONTRACTS[sim.model][1]


def _cuda_simulator(
    sim: SimulationParams, *, rows: int, anti_half: int | None, paths_group: ProcessGroup | None
) -> Simulator:
    """The kernel wrapper ``resolve_implementation`` chose, with its knobs."""
    from spectralmc_tpu_torch.ops import american_cuda, basket_cuda, dynamics_cuda, gbm_cuda

    shape = dict(timesteps=sim.timesteps, rows=rows, cols=sim.network_size,
                 antithetic_half=anti_half)
    if sim.payoff in AMERICAN_PAYOFFS:  # flat log-Euler, every dynamics
        launch = american_cuda.simulate_american_underlier_rows_cuda
        knobs = dict(option=_option_side(sim), model=sim.model, spec=sim.basket,
                     basis_degree=sim.lsmc_basis_degree, exercise_every=sim.lsmc_exercise_every,
                     cross_fit=sim.lsmc_cross_fit, paths_group=paths_group,
                     backward=american_cuda.resolve_lsmc_backward(
                         sim, rows=rows, sharded=paths_group is not None))
    elif sim.payoff == PayoffKind.CLIQUET:  # flat log-Euler GBM only
        launch = gbm_cuda.simulate_cliquet_rows_cuda
        knobs = dict(reset_every=sim.cliquet_reset_every, floor=sim.cliquet_floor,
                     cap=sim.cliquet_cap)
    else:
        knobs = dict(payoff=sim.payoff, barrier_rel=sim.barrier_rel,
                     forward_start_step=sim.forward_start_step)
        if sim.model == ModelKind.HESTON:
            launch = dynamics_cuda.simulate_heston_rows_cuda
        elif sim.model == ModelKind.BASKET_GBM:
            launch = basket_cuda.simulate_basket_rows_cuda
            knobs["spec"] = sim.basket
        elif sim.model == ModelKind.MERTON_JUMP:
            launch = dynamics_cuda.simulate_merton_rows_cuda
        elif curved(sim.term) is not None:
            launch = dynamics_cuda.simulate_term_rows_cuda
            knobs["term"] = sim.term
        else:
            launch = gbm_cuda.simulate_underlier_rows_cuda
            knobs["scheme"] = sim.scheme

    def simulate_cuda(
        key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
    ) -> torch.Tensor:
        return launch(contracts.to(torch.float32), key_words, row_offset=row_offset,
                      **shape, **knobs)

    return simulate_cuda


def _option_side(sim: SimulationParams) -> OptionSide:
    return OptionSide.PUT if sim.payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL


def make_underlier_simulator(
    sim: SimulationParams, *, rows: int, paths_group: ProcessGroup | None = None
) -> Simulator:
    """``(key_words [C, 2], contracts [C, D], row_offset=0) -> [C, rows, network]``.

    The engine is the one ``resolve_implementation`` says will run, decided
    here once: on ``"cuda"`` the kernel of the sim's dynamics (the cliquet,
    flat, term, Heston, Merton or basket kernel; for an American kind its
    dynamics' monitor-row kernel and the backward ``resolve_lsmc_backward``
    names), on ``"xla"`` the threefry simulator of its dynamics (for an
    American kind its state-row simulator), with the term knob, the
    basket's spec and, for ``SOBOL_BB``, the sampling and its seed. Every
    engine keys rows by GLOBAL index, so ``row_offset`` shards are stable.
    ``paths_group`` is the mesh's paths group when the caller simulates one
    shard of the rows (JAX's ``axis_name``): only the American kinds use it
    (their LSMC regression all-reduces its moment sums over it, and on the
    ``"cuda"`` engine runs the torch estimator); the pathwise simulators
    ignore it.
    """
    resolved = resolve_implementation(sim)
    anti_half = sim.batches_per_mc_run // 2 if sim.antithetic else None
    if resolved == SimImplementation.PALLAS:
        raise ValueError(
            "the 'pallas' engine draws the TPU hardware PRNG; this package cannot run it"
        )
    if resolved == SimImplementation.CUDA:
        return _cuda_simulator(sim, rows=rows, anti_half=anti_half, paths_group=paths_group)

    kwargs = dict(
        timesteps=sim.timesteps, rows=rows, cols=sim.network_size,
        dtype=sim.precision.to_torch(), payoff=sim.payoff, barrier_rel=sim.barrier_rel,
        antithetic_half=anti_half, forward_start_step=sim.forward_start_step,
        cliquet_reset_every=sim.cliquet_reset_every, cliquet_floor=sim.cliquet_floor,
        cliquet_cap=sim.cliquet_cap, term=sim.term,
    )
    if sim.sampling != SamplingKind.PSEUDO:
        kwargs.update(sampling=sim.sampling, mc_seed=sim.mc_seed)
    if sim.payoff in AMERICAN_PAYOFFS:
        american = dict(
            timesteps=sim.timesteps, rows=rows, cols=sim.network_size,
            dtype=sim.precision.to_torch(), option=_option_side(sim),
            basis_degree=sim.lsmc_basis_degree, exercise_every=sim.lsmc_exercise_every,
            antithetic_half=anti_half, cross_fit=sim.lsmc_cross_fit, paths_group=paths_group,
        )
        if sim.model == ModelKind.HESTON:
            forward = simulate_heston_american_underlier_rows
        elif sim.model == ModelKind.MERTON_JUMP:
            forward = simulate_merton_american_underlier_rows
        elif sim.model == ModelKind.BASKET_GBM:
            forward = simulate_basket_american_underlier_rows
            american["spec"] = sim.basket
        else:  # GBM, flat or curved (the config refuses curves for the others)
            forward = simulate_american_underlier_rows
            american["term"] = sim.term

        def simulate_american(
            key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
        ) -> torch.Tensor:
            return forward(key_words, contracts, row_offset=row_offset, **american)

        return simulate_american
    if sim.model == ModelKind.HESTON:
        scan = simulate_heston_underlier_rows
    elif sim.model == ModelKind.MERTON_JUMP:
        scan = simulate_merton_underlier_rows
    elif sim.model == ModelKind.BASKET_GBM:
        scan = simulate_basket_underlier_rows
        kwargs["spec"] = sim.basket
    else:
        scan = simulate_underlier_rows
        kwargs["scheme"] = sim.scheme

    def simulate_xla(
        key_words: torch.Tensor, contracts: torch.Tensor, row_offset: int = 0
    ) -> torch.Tensor:
        return scan(key_words, contracts, row_offset=row_offset, **kwargs)

    return simulate_xla


def make_mean_target(sim: SimulationParams) -> Callable[[torch.Tensor], torch.Tensor | None]:
    """``contracts [..., D] -> E[underlier] [...]``, the payoff's own analytic
    mean under the sim's dynamics and curves (None where no closed form
    exists)."""
    kwargs = dict(timesteps=sim.timesteps, payoff=sim.payoff, dtype=sim.precision.to_torch(),
                  forward_start_step=sim.forward_start_step, term=sim.term)
    cliquet = dict(cliquet_reset_every=sim.cliquet_reset_every, cliquet_floor=sim.cliquet_floor,
                   cliquet_cap=sim.cliquet_cap)
    if sim.model == ModelKind.HESTON:
        return lambda contracts: heston_expected_underlier_mean(contracts, **kwargs)
    if sim.model == ModelKind.MERTON_JUMP:
        return lambda contracts: merton_expected_underlier_mean(contracts, **kwargs, **cliquet)
    if sim.model == ModelKind.BASKET_GBM:
        return lambda contracts: expected_basket_underlier_mean(contracts, sim.basket, **kwargs,
                                                                **cliquet)
    return lambda contracts: expected_underlier_mean(contracts, **kwargs, **cliquet)


__all__ = [
    "contract_class",
    "contract_dim",
    "make_mean_target",
    "make_underlier_simulator",
]
