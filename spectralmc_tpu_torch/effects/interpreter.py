"""Effect interpreters — the single impure boundary.

The JAX package's ``effects/interpreter.py`` on PyTorch: one class per
family, all ``async interpret(effect) -> Result``, routed by
``SpectralMCInterpreter``, which also runs sequences fail-fast (a
continuation over the results) and parallel gathers. Every interpreter that
touches tensors takes an explicit ``device``; nothing is picked by default.

* ``DeviceInterpreter``: a ``HostDeviceTransfer`` moves a registry entry with
  ``torch.as_tensor(..., device=)`` or ``.cpu().numpy()``, ``BlockUntilReady``
  synchronises the tensor's device, and a ``JitCall`` calls the registered
  callable as it is.
* ``MonteCarloInterpreter`` runs the real simulation: ``GenerateNormals`` on
  ``ops/rng.py``'s stream API, ``SimulatePaths`` on the threefry engine keyed
  ``fold_in(prng_key(seed), counter)`` with every gate and refusal reason of
  the JAX package's, ``ComputeFFT`` on ``ops/spectrum.py``.
* ``GradientStep``/``TrainSegment`` call a registered function (the trainer
  registers its segment as ``"train_segment"``).
"""

from __future__ import annotations

import asyncio
import logging
from typing import NoReturn

import torch

from spectralmc_tpu_torch.core.aliases import EffectResult
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.effects.composition import EffectParallel, EffectSequence, MappedEffect
from spectralmc_tpu_torch.effects.errors import (
    DeviceError,
    EffectError,
    LoggingError,
    MetadataError,
    MonteCarloError,
    RNGError,
    StorageEffectError,
    TrainingError,
    UnknownEffect,
)
from spectralmc_tpu_torch.effects.registry import SharedRegistry
from spectralmc_tpu_torch.effects.types import (
    AdvanceCounter,
    BlockUntilReady,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    ComputeLoss,
    Effect,
    ForwardPass,
    GenerateNormals,
    GradientStep,
    HostDeviceTransfer,
    JitCall,
    LogMessage,
    LogMetrics,
    ReadMetadata,
    ReadObject,
    RestoreCounters,
    SimulatePaths,
    TrainSegment,
    UpdateMetadata,
    WriteObject,
)

TENSORBOARD_WRITER_KEY = "_tensorboard_writer"


def assert_never(value: NoReturn) -> NoReturn:
    raise AssertionError(f"unhandled effect type: {type(value).__name__}")


class DeviceInterpreter:
    def __init__(self, registry: SharedRegistry, device: torch.device | str) -> None:
        self._registry = registry
        self._device = torch.device(device)

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, HostDeviceTransfer):
            got = self._registry.get_array(effect.tensor_id)
            if isinstance(got, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(got.error)))
            if effect.direction == "device_to_host":
                value = got.value
                if isinstance(value, torch.Tensor):
                    value = value.detach().cpu().numpy()
            else:
                value = torch.as_tensor(got.value, device=self._device)
            self._registry.replace_array(effect.tensor_id, value)
            return Success(effect.tensor_id)
        if isinstance(effect, BlockUntilReady):
            got = self._registry.get_array(effect.tensor_id)
            if isinstance(got, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(got.error)))
            if isinstance(got.value, torch.Tensor) and got.value.is_cuda:
                torch.cuda.synchronize(got.value.device)
            return Success(effect.tensor_id)
        if isinstance(effect, JitCall):
            fn = self._registry.get_function(effect.fn_id)
            if isinstance(fn, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(fn.error)))
            args = []
            for arg_id in effect.arg_ids:
                got = self._registry.get_array(arg_id)
                if isinstance(got, Failure):
                    return Failure(
                        DeviceError(effect_kind=effect.kind, reason=repr(got.error))
                    )
                args.append(got.value)
            try:
                out = fn.value(*args)
            except Exception as exc:  # noqa: BLE001 — the callable's failure is the effect's
                return Failure(DeviceError(effect_kind=effect.kind, reason=str(exc)))
            if effect.out_id:
                self._registry.replace_array(effect.out_id, out)
            return Success(effect.out_id)
        assert_never(effect)


def _simulate_paths_refusal(effect: SimulatePaths) -> str | None:
    """The ``build_simulation_params`` gates that the effect route would
    otherwise bypass, with the JAX package's reasons; None when it may run.
    ``SimulatePaths`` carries Black–Scholes market fields only, so anything
    but GBM is refused first."""
    from spectralmc_tpu_torch.ops.gbm import (
        AMERICAN_PAYOFFS,
        BARRIER_PAYOFFS,
        ModelKind,
        PathScheme,
        PayoffKind,
        SamplingKind,
        has_closed_form_mean,
    )

    payoff = PayoffKind(effect.payoff)
    if ModelKind(effect.model) != ModelKind.GBM:
        # Heston contracts carry 10 fields and baskets a spec that the
        # effect's 6-field market record cannot express
        return "SimulatePaths carries BS market fields only (model=gbm)"
    mean = effect.normalization == "mean"
    if mean and payoff == PayoffKind.DIGITAL:
        return "the digital ±1 underlier encoding is not scale-equivariant; use normalization='none'"
    if mean and not has_closed_form_mean(ModelKind.GBM, payoff):
        return f"payoff={payoff.value!r} has no closed-form E[underlier]; use normalization='none'"
    if SamplingKind(effect.sampling) == SamplingKind.SOBOL_BB:
        if payoff in AMERICAN_PAYOFFS:
            return ("LSMC early exercise draws its own pseudo stream; QMC applies to "
                    "path-independent payoffs")
        if effect.antithetic:
            return ("antithetic mirroring breaks the Sobol net's digital-shift "
                    "randomization; choose one scheme")
    if payoff in AMERICAN_PAYOFFS:
        if PathScheme(effect.scheme) != PathScheme.LOG_EULER:
            return "LSMC early exercise is log-Euler only"
        every = effect.lsmc_exercise_every
        if every < 1 or effect.timesteps % every:
            return f"lsmc_exercise_every={every} must divide timesteps={effect.timesteps}"
        if effect.timesteps // every < 2:
            return "early exercise needs >= 2 monitor dates"
    if payoff in BARRIER_PAYOFFS:
        if effect.barrier_rel <= 0.0:
            return f"payoff={payoff.value!r} requires barrier_rel > 0"
        # an up-out level <= spot (or a down-out level >= spot) knocks every
        # path at step 1 and silently prices everything to zero
        if payoff == PayoffKind.BARRIER_UP_OUT and effect.barrier_rel <= 1.0:
            return "up-and-out barrier must be > 1x spot"
        if payoff == PayoffKind.BARRIER_DOWN_OUT and not 0.0 < effect.barrier_rel < 1.0:
            return "down-and-out barrier must be in (0, 1)x spot"
    if payoff == PayoffKind.FORWARD_START:
        if not 1 <= effect.forward_start_step < effect.timesteps:
            return ("forward_start requires an interior forward_start_step (got "
                    f"{effect.forward_start_step} for timesteps={effect.timesteps})")
    elif effect.forward_start_step:
        return f"payoff={payoff.value!r} takes no strike-setting date"
    if payoff == PayoffKind.CLIQUET:
        if (effect.cliquet_reset_every <= 0 or effect.cliquet_floor is None
                or effect.cliquet_cap is None):
            return "cliquet requires cliquet_reset_every, cliquet_floor and cliquet_cap"
        if (effect.timesteps % effect.cliquet_reset_every
                or effect.timesteps // effect.cliquet_reset_every < 2):
            return "cliquet_reset_every must divide timesteps with >= 2 reset periods"
        if not -1.0 < effect.cliquet_floor < effect.cliquet_cap:
            return "need -1 < cliquet_floor < cliquet_cap"
        if mean:
            return ("the cliquet clipped-return sum is not scale-equivariant; use "
                    "normalization='none'")
    elif (effect.cliquet_reset_every or effect.cliquet_floor is not None
          or effect.cliquet_cap is not None):
        return f"payoff={payoff.value!r} takes no cliquet reset grid or clip levels"
    return None


class MonteCarloInterpreter:
    def __init__(self, registry: SharedRegistry, device: torch.device | str) -> None:
        self._registry = registry
        self._device = torch.device(device)

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, GenerateNormals):
            from spectralmc_tpu_torch.ops.rng import base_key, normal_matrix

            matrix = normal_matrix(base_key(effect.seed, self._device), effect.counter,
                                   effect.rows, effect.cols, torch.float32)
            put = self._registry.put_array(effect.out_id, matrix)
            if isinstance(put, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.out_id)
        if isinstance(effect, SimulatePaths):
            return self._simulate_paths(effect)
        if isinstance(effect, ComputeFFT):
            from spectralmc_tpu_torch.ops.spectrum import payoff_spectrum

            got = self._registry.get_array(effect.in_id)
            if isinstance(got, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(got.error)))
            spectrum = payoff_spectrum(
                got.value, batches=effect.batches, network_size=effect.network_size
            )
            put = self._registry.put_array(effect.out_id, spectrum)
            if isinstance(put, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.out_id)
        assert_never(effect)

    def _simulate_paths(self, effect: SimulatePaths) -> Result[EffectResult, EffectError]:
        """Discounted put payoffs ``[batches * network_size]`` of one contract."""
        from spectralmc_tpu_torch.core.precision import Precision
        from spectralmc_tpu_torch.ops import rng
        from spectralmc_tpu_torch.ops.american import OptionSide, simulate_american_underlier_rows
        from spectralmc_tpu_torch.ops.gbm import (
            AMERICAN_PAYOFFS,
            ModelKind,
            PathScheme,
            PayoffKind,
            SamplingKind,
            TermStructure,
            expected_underlier_mean,
            simulate_underlier_rows,
            terminal_to_prices,
            validate_term_structure,
        )

        try:
            scheme = PathScheme(effect.scheme)
            payoff = PayoffKind(effect.payoff)
            ModelKind(effect.model)
            dtype = Precision(effect.precision).to_torch()
            sampling = SamplingKind(effect.sampling)
        except ValueError as exc:
            return Failure(MonteCarloError(effect_kind=effect.kind, reason=f"bad enum value: {exc}"))
        refusal = _simulate_paths_refusal(effect)
        if refusal is not None:
            return Failure(MonteCarloError(effect_kind=effect.kind, reason=refusal))
        term = None
        if effect.term_vol or effect.term_rate or effect.term_div:
            checked = validate_term_structure(
                TermStructure(vol_shape=effect.term_vol, rate_shape=effect.term_rate,
                              div_shape=effect.term_div),
                timesteps=effect.timesteps,
            )
            if isinstance(checked, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind,
                                               reason=checked.error.reason))
            term = checked.value
        contract = torch.tensor(
            [[effect.spot, effect.strike, effect.maturity, effect.rate, effect.div_yield,
              effect.vol]], dtype=dtype, device=self._device)
        key = rng.fold_in(rng.prng_key(effect.seed, self._device), effect.counter)[None]
        anti_half = effect.batches // 2 if effect.antithetic else None
        common = dict(timesteps=effect.timesteps, rows=effect.batches, cols=effect.network_size,
                      dtype=dtype, antithetic_half=anti_half, term=term)
        if payoff in AMERICAN_PAYOFFS:
            side = OptionSide.PUT if payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL
            rows = simulate_american_underlier_rows(
                key, contract, option=side, basis_degree=effect.lsmc_basis_degree,
                exercise_every=effect.lsmc_exercise_every, **common)
        else:
            rows = simulate_underlier_rows(
                key, contract, scheme=scheme, payoff=payoff,
                barrier_rel=effect.barrier_rel if effect.barrier_rel > 0.0 else None,
                forward_start_step=effect.forward_start_step or None,
                cliquet_reset_every=effect.cliquet_reset_every or None,
                cliquet_floor=effect.cliquet_floor, cliquet_cap=effect.cliquet_cap,
                sampling=sampling, mc_seed=effect.seed, **common)
        normalize = effect.normalization == "mean"
        mean_target = None
        if normalize:
            mean_target = expected_underlier_mean(
                contract, timesteps=effect.timesteps, payoff=payoff, dtype=dtype, term=term,
                forward_start_step=effect.forward_start_step or None)
        prices = terminal_to_prices(rows.reshape(1, -1), contract, normalize=normalize,
                                    dtype=dtype, mean_target=mean_target, term=term)
        put = self._registry.put_array(effect.out_id, prices.put_payoffs[0])
        if isinstance(put, Failure):
            return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
        return Success(effect.out_id)


class TrainingInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, ForwardPass):
            model = self._registry.get_model(effect.model_id)
            inputs = self._registry.get_array(effect.in_id)
            if isinstance(model, Failure) or isinstance(inputs, Failure):
                return Failure(TrainingError(effect_kind=effect.kind, reason="missing model/input"))
            out_re, out_im = _forward(model.value, inputs.value, train=effect.train)
            self._registry.replace_array(effect.out_id + "/re", out_re)
            self._registry.replace_array(effect.out_id + "/im", out_im)
            return Success(effect.out_id)
        if isinstance(effect, ComputeLoss):
            pred = self._registry.get_array(effect.pred_id)
            target = self._registry.get_array(effect.target_id)
            if isinstance(pred, Failure) or isinstance(target, Failure):
                return Failure(TrainingError(effect_kind=effect.kind, reason="missing pred/target"))
            diff = torch.as_tensor(pred.value) - torch.as_tensor(target.value)
            if effect.loss_type == "mse":
                loss = torch.mean(torch.square(torch.abs(diff)))
            elif effect.loss_type == "mae":
                loss = torch.mean(torch.abs(diff))
            else:  # huber
                a = torch.abs(diff)
                loss = torch.mean(torch.where(a < 1.0, 0.5 * a * a, a - 0.5))
            self._registry.replace_array(effect.out_id, loss)
            return Success(effect.out_id)
        if isinstance(effect, (GradientStep, TrainSegment)):
            fn_id = "train_segment" if isinstance(effect, TrainSegment) else "gradient_step"
            fn = self._registry.get_function(fn_id)
            if isinstance(fn, Failure):
                return Failure(
                    TrainingError(effect_kind=effect.kind, reason=f"no registered function {fn_id!r}")
                )
            try:
                out = fn.value(effect)
            except Exception as exc:  # noqa: BLE001 — the function's failure is the effect's
                return Failure(TrainingError(effect_kind=effect.kind, reason=str(exc)))
            return Success(out)
        if isinstance(effect, LogMetrics):
            writer = self._registry.get_model(TENSORBOARD_WRITER_KEY)
            if isinstance(writer, Success):
                for name, value in (effect.metrics or {}).items():
                    writer.value.add_scalar(name, value, effect.step)
            logging.getLogger("spectralmc_tpu_torch.metrics").info(
                "step=%d %s", effect.step, dict(effect.metrics or {})
            )
            return Success(effect.step)
        assert_never(effect)


@torch.no_grad()
def _forward(
    model: torch.nn.Module, inputs: torch.Tensor, *, train: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CVNN on real inputs (zero imaginary part). ``train=True`` uses the
    batch statistics, as the JAX package's ``apply(train=True)`` does, and —
    as there, where the new batch-norm state is returned and dropped — leaves
    the module's running statistics as they were."""
    was_training = model.training
    saved = [b.clone() for b in model.buffers()] if train else []
    model.train(train)
    try:
        re = torch.as_tensor(inputs)
        return model(re, torch.zeros_like(re))
    finally:
        for buffer, value in zip(model.buffers(), saved):
            buffer.copy_(value)
        model.train(was_training)


class StorageInterpreter:
    def __init__(self, registry: SharedRegistry, store: "object | None") -> None:
        self._registry = registry
        self._store = store  # AsyncBlockchainModelStore

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if self._store is None:
            return Failure(
                StorageEffectError(effect_kind=effect.kind, reason="no store configured")
            )
        if isinstance(effect, ReadObject):
            got = await self._store.object_store.get(effect.key)
            if isinstance(got, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(got.error)))
            self._registry.put_blob(effect.out_id, got.value[0])
            return Success(effect.out_id)
        if isinstance(effect, WriteObject):
            blob = self._registry.get_blob(effect.data_id)
            if isinstance(blob, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(blob.error)))
            put = await self._store.object_store.put(effect.key, blob.value)
            if isinstance(put, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.key)
        if isinstance(effect, CommitVersion):
            blob = self._registry.get_blob(effect.data_id)
            if isinstance(blob, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(blob.error)))
            committed = await self._store.commit(blob.value, effect.content_hash, effect.message)
            if isinstance(committed, Failure):
                return Failure(
                    StorageEffectError(effect_kind=effect.kind, reason=repr(committed.error))
                )
            return Success(committed.value)
        assert_never(effect)


class RNGInterpreter:
    """Counters live in registry metadata — the whole RNG state (stateless keys)."""

    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, CaptureCounters):
            sobol = self._registry.get_metadata("sobol_skip")
            mc = self._registry.get_metadata("mc_skip")
            return Success({
                "sobol_skip": sobol.value if isinstance(sobol, Success) else 0,
                "mc_skip": mc.value if isinstance(mc, Success) else 0,
            })
        if isinstance(effect, RestoreCounters):
            self._registry.update_metadata("sobol_skip", "set", effect.sobol_skip)
            self._registry.update_metadata("mc_skip", "set", effect.mc_skip)
            return Success(None)
        if isinstance(effect, AdvanceCounter):
            key = "sobol_skip" if effect.stream == "sobol" else "mc_skip"
            result = self._registry.update_metadata(key, "add", effect.by)
            if isinstance(result, Failure):
                return Failure(RNGError(effect_kind=effect.kind, reason=repr(result.error)))
            return Success(result.value)
        assert_never(effect)


class MetadataInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, ReadMetadata):
            got = self._registry.get_metadata(effect.key)
            if isinstance(got, Failure):
                return Failure(MetadataError(effect_kind=effect.kind, reason=repr(got.error)))
            return Success(got.value)
        if isinstance(effect, UpdateMetadata):
            result = self._registry.update_metadata(effect.key, effect.operation, effect.value)
            if isinstance(result, Failure):
                return Failure(MetadataError(effect_kind=effect.kind, reason=repr(result.error)))
            return Success(result.value)
        assert_never(effect)


class LoggingInterpreter:
    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, LogMessage):
            level = getattr(logging, effect.level.upper(), None)
            if level is None:
                return Failure(
                    LoggingError(effect_kind=effect.kind, reason=f"bad level {effect.level}")
                )
            logging.getLogger(effect.logger).log(level, effect.message)
            return Success(None)
        assert_never(effect)


_FAMILY_OF_KIND = {
    **dict.fromkeys(("host_device_transfer", "block_until_ready", "jit_call"), "_device"),
    **dict.fromkeys(("generate_normals", "simulate_paths", "compute_fft"), "_montecarlo"),
    **dict.fromkeys(("forward_pass", "compute_loss", "gradient_step", "train_segment",
                     "log_metrics"), "_training"),
    **dict.fromkeys(("read_object", "write_object", "commit_version"), "_storage"),
    **dict.fromkeys(("capture_counters", "restore_counters", "advance_counter"), "_rng"),
    **dict.fromkeys(("read_metadata", "update_metadata"), "_metadata"),
    "log_message": "_logging",
}


class SpectralMCInterpreter:
    """Routes the master union; runs sequences (fail-fast) and parallels."""

    def __init__(
        self,
        registry: SharedRegistry | None = None,
        store: "object | None" = None,
        *,
        device: torch.device | str,
    ) -> None:
        self.registry = registry if registry is not None else SharedRegistry()
        self.device = torch.device(device)
        self._device = DeviceInterpreter(self.registry, self.device)
        self._montecarlo = MonteCarloInterpreter(self.registry, self.device)
        self._training = TrainingInterpreter(self.registry)
        self._storage = StorageInterpreter(self.registry, store)
        self._rng = RNGInterpreter(self.registry)
        self._metadata = MetadataInterpreter(self.registry)
        self._logging = LoggingInterpreter()

    @classmethod
    def create(
        cls, *, device: torch.device | str, store: "object | None" = None
    ) -> "SpectralMCInterpreter":
        return cls(SharedRegistry(), store, device=device)

    async def interpret(self, effect: Effect | MappedEffect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, MappedEffect):
            inner = await self.interpret(effect.effect)
            if isinstance(inner, Failure):
                return inner
            return Success(effect.fn(inner.value))
        family = _FAMILY_OF_KIND.get(getattr(effect, "kind", None))
        if family is None:
            return Failure(UnknownEffect(type_name=type(effect).__name__))
        return await getattr(self, family).interpret(effect)

    async def interpret_sequence(
        self, sequence: EffectSequence
    ) -> Result[EffectResult, EffectError]:
        results: list[EffectResult] = []
        for effect in sequence.effects:
            result = await self.interpret(effect)
            if isinstance(result, Failure):
                return result  # fail-fast
            results.append(result.value)
        if sequence.continuation is not None:
            return Success(sequence.continuation(tuple(results)))
        return Success(tuple(results))

    async def interpret_parallel(self, parallel: EffectParallel) -> Result[EffectResult, EffectError]:
        results = await asyncio.gather(*(self.interpret(e) for e in parallel.effects))
        for result in results:
            if isinstance(result, Failure):
                return result
        values = tuple(r.value for r in results)
        if parallel.combiner is not None:
            return Success(parallel.combiner(values))
        return Success(values)
