"""Pure effect-description builders: the JAX package's
``training/effects_builders.py``.

One MC pricing (``build_simulation_effects``), one fused training batch
(``build_training_step_effects``) and a whole run with its interval and
final commits (``build_training_run_effects``). The device work of a batch
is one ``TrainSegment``: sampling, simulation, FFT and the update are the
trainer's fused batch. Orchestration tests assert these structures with
``MockInterpreter`` — no device, no store.
"""

from __future__ import annotations

from spectralmc_tpu_torch.effects.composition import EffectSequence, sequence_effects
from spectralmc_tpu_torch.effects.types import (
    AdvanceCounter,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    LogMessage,
    LogMetrics,
    SimulatePaths,
    TrainSegment,
    UpdateMetadata,
)
from spectralmc_tpu_torch.ops.gbm import BlackScholesContract, SimulationParams


def segment_lengths(num_batches: int, interval: int | None) -> list[int]:
    """A run cut at commit boundaries: full intervals, then the rest."""
    if interval is None:
        return [num_batches]
    full, rem = divmod(num_batches, interval)
    return [interval] * full + ([rem] if rem else [])


def build_simulation_effects(
    sim: SimulationParams, contract: BlackScholesContract, *, out_id: str = "payoffs"
) -> EffectSequence:
    """One MC pricing as data: simulate, FFT, advance the MC counter."""
    return sequence_effects(
        [
            SimulatePaths(
                spot=contract.spot,
                strike=contract.strike,
                maturity=contract.maturity,
                rate=contract.rate,
                div_yield=contract.div_yield,
                vol=contract.vol,
                timesteps=sim.timesteps,
                batches=sim.batches_per_mc_run,
                network_size=sim.network_size,
                seed=sim.mc_seed,
                counter=sim.skip,
                scheme=sim.scheme.value,
                normalization=sim.normalization.value,
                payoff=sim.payoff.value,
                model=sim.model.value,
                precision=sim.precision.value,
                antithetic=sim.antithetic,
                barrier_rel=sim.barrier_rel or 0.0,
                lsmc_basis_degree=sim.lsmc_basis_degree,
                lsmc_exercise_every=sim.lsmc_exercise_every,
                forward_start_step=sim.forward_start_step or 0,
                cliquet_reset_every=sim.cliquet_reset_every or 0,
                cliquet_floor=sim.cliquet_floor,
                cliquet_cap=sim.cliquet_cap,
                sampling=sim.sampling.value,
                term_vol=sim.term.vol_shape if sim.term else (),
                term_rate=sim.term.rate_shape if sim.term else (),
                term_div=sim.term.div_shape if sim.term else (),
                out_id=out_id,
            ),
            ComputeFFT(
                in_id=out_id,
                batches=sim.batches_per_mc_run,
                network_size=sim.network_size,
                out_id=out_id + "/spectrum",
            ),
            AdvanceCounter(stream="mc", by=1),
        ]
    )


def build_training_step_effects(
    *, step: int, batch_size: int, learning_rate: float
) -> EffectSequence:
    """One fused training batch as data."""
    return sequence_effects(
        [
            TrainSegment(length=1, batch_size=batch_size, learning_rate=learning_rate),
            AdvanceCounter(stream="sobol", by=batch_size),
            AdvanceCounter(stream="mc", by=batch_size),
            UpdateMetadata(key="global_step", operation="increment", value=0),
            LogMetrics(step=step, metrics={}),
        ]
    )


def build_training_run_effects(
    *,
    num_batches: int,
    batch_size: int,
    learning_rate: float,
    commit_interval: int | None = None,
    final_commit: bool = False,
) -> EffectSequence:
    """A full run with interval/final checkpoint effects: segments cut at
    the commit interval, a commit after each full one except where the final
    commit lands on the same step."""
    effects: list[object] = [
        LogMessage(level="info", message=f"training run: {num_batches} batches"),
        CaptureCounters(out_id="counters/initial"),
    ]
    done = 0
    for seg in segment_lengths(num_batches, commit_interval):
        effects.append(
            TrainSegment(
                length=seg,
                batch_size=batch_size,
                learning_rate=learning_rate,
                commit_after=commit_interval is not None and seg == commit_interval,
            )
        )
        done += seg
        if commit_interval is not None and seg == commit_interval and not (
            done == num_batches and final_commit
        ):
            effects.append(
                CommitVersion(data_id="checkpoint", content_hash="", message=f"batch {done}")
            )
    if final_commit:
        effects.append(
            CommitVersion(data_id="checkpoint", content_hash="", message=f"final {done}")
        )
    effects.append(LogMessage(level="info", message="training run complete"))
    return sequence_effects(effects)  # type: ignore[arg-type]
