"""Proto converters: the port's configs, tensors and Adam state <-> its schemas.

The JAX package's ``serialization/converters.py``, name for name, on the
port's types and its own generated modules (``spectralmc_tpu_torch.proto``,
the same messages and field numbers). Every converter call that touches a
message is the JAX package's, in its order, so the same values give the same
bytes: ``serialize_checkpoint`` writes
``SerializeToString(deterministic=True)`` (map entries sorted by key) and
its sha256.

What differs:

* Provenance passes through (``core/provenance.py``): the decoded config
  keeps the ``JaxEnvProto`` (field 8) or ``TorchEnvProto`` (field 14) that
  the bytes held, and encoding writes back exactly those. A JAX checkpoint
  re-encodes here to its own bytes; the port never stamps ``env``.
* ``cuda_stream_version`` (field 13) round-trips, as do
  ``lsmc_backward_version`` 3 and 4. The decoder refuses nothing that the
  schema allows: whether a checkpoint can continue is the trainer's call
  (``GbmCVNNPricer.create``).
* numpy has no ``bfloat16`` (the JAX package decodes it with ``ml_dtypes``,
  which the port does not need): ``tensor_from_proto`` decodes a
  ``bfloat16`` tensor to a CPU ``torch.bfloat16`` tensor, and
  ``tensor_to_proto`` encodes one back to its own bytes. Widened to float32
  its values equal the JAX package's decode.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import asdict, fields
from typing import TYPE_CHECKING, Mapping

import numpy as np
import torch

from spectralmc_tpu_torch.core.errors.serialization import (
    ChecksumMismatch,
    DecodeError,
    SerializationError,
)
from spectralmc_tpu_torch.core.precision import Precision, ReducedPrecision
from spectralmc_tpu_torch.core.provenance import JaxEnv, Provenance, TorchEnv
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.models.factory import (
    Activation,
    CovBNCfg,
    CVNNConfig,
    LayerCfg,
    LinearCfg,
    NaiveBNCfg,
    ResidualCfg,
    SequentialCfg,
)
from spectralmc_tpu_torch.ops.basket import BasketSpec, build_basket_spec
from spectralmc_tpu_torch.ops.gbm import (
    ForwardNormalization,
    ModelKind,
    PathScheme,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    SimulationParams,
    TermStructure,
)
from spectralmc_tpu_torch.ops.sobol import BoundSpec
from spectralmc_tpu_torch.proto import (
    common_pb2,
    models_pb2,
    simulation_pb2,
    tensors_pb2,
    training_pb2,
)

if TYPE_CHECKING:  # pragma: no cover
    from spectralmc_tpu_torch.training.adam_state import AdamStateSnapshot
    from spectralmc_tpu_torch.training.trainer import GbmCVNNPricerConfig, TrainingConfig

# --------------------------------------------------------------------------
# Hashing
# --------------------------------------------------------------------------


def compute_sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def verify_checksum(data: bytes, expected: str) -> Result[bytes, SerializationError]:
    actual = compute_sha256(data)
    if actual != expected:
        return Failure(
            ChecksumMismatch(expected=expected, actual=actual, reason="payload corrupted")
        )
    return Success(data)


# --------------------------------------------------------------------------
# Enums
# --------------------------------------------------------------------------

_PRECISION_TO_PROTO = {
    Precision.float32: common_pb2.PRECISION_FLOAT32,
    Precision.float64: common_pb2.PRECISION_FLOAT64,
    Precision.complex64: common_pb2.PRECISION_COMPLEX64,
    Precision.complex128: common_pb2.PRECISION_COMPLEX128,
}
_PRECISION_FROM_PROTO = {v: k for k, v in _PRECISION_TO_PROTO.items()}

_SCHEME_TO_PROTO = {
    PathScheme.LOG_EULER: common_pb2.PATH_SCHEME_LOG_EULER,
    PathScheme.EULER: common_pb2.PATH_SCHEME_EULER,
}
_SCHEME_FROM_PROTO = {v: k for k, v in _SCHEME_TO_PROTO.items()}

_NORM_TO_PROTO = {
    ForwardNormalization.NONE: common_pb2.FORWARD_NORMALIZATION_NONE,
    ForwardNormalization.MEAN: common_pb2.FORWARD_NORMALIZATION_MEAN,
}
_NORM_FROM_PROTO = {v: k for k, v in _NORM_TO_PROTO.items()}

_ACTIVATION_TO_PROTO = {
    Activation.NONE: models_pb2.ACTIVATION_NONE,
    Activation.ZRELU: models_pb2.ACTIVATION_ZRELU,
    Activation.MODRELU: models_pb2.ACTIVATION_MODRELU,
}
_ACTIVATION_FROM_PROTO = {v: k for k, v in _ACTIVATION_TO_PROTO.items()}


# --------------------------------------------------------------------------
# Tensors
# --------------------------------------------------------------------------


def tensor_to_proto(arr: "np.ndarray | torch.Tensor") -> tensors_pb2.TensorProto:
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        bits = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        return tensors_pb2.TensorProto(shape=list(arr.shape), dtype="bfloat16",
                                       data=bits.tobytes())
    # tobytes() emits C-order for any layout; ascontiguousarray would promote
    # 0-d arrays to 1-d and lose the scalar shape.
    a = np.asarray(arr)
    return tensors_pb2.TensorProto(
        shape=list(a.shape), dtype=a.dtype.name, data=a.tobytes()
    )


def tensor_from_proto(
    proto: tensors_pb2.TensorProto,
) -> "Result[np.ndarray | torch.Tensor, SerializationError]":
    """The tensor as numpy, or as a CPU ``torch.bfloat16`` tensor for the
    dtype numpy cannot name (its 16-bit words read as int16, then viewed)."""
    bfloat16 = proto.dtype == ReducedPrecision.bfloat16.value
    try:
        dtype = np.dtype(np.int16 if bfloat16 else proto.dtype)
    except (TypeError, ValueError):
        return Failure(DecodeError(what="tensor", reason=f"unknown dtype {proto.dtype!r}"))
    if dtype.hasobject:
        return Failure(DecodeError(what="tensor", reason=f"unknown dtype {proto.dtype!r}"))
    shape = tuple(proto.shape)
    expected = math.prod(shape) * dtype.itemsize  # a 0-d tensor holds one element
    if len(proto.data) != expected:
        return Failure(
            DecodeError(
                what="tensor",
                reason=f"payload {len(proto.data)} bytes != {expected} for {shape} "
                f"{proto.dtype if bfloat16 else dtype}",
            )
        )
    decoded = np.frombuffer(proto.data, dtype=dtype).reshape(shape).copy()
    if bfloat16:
        return Success(torch.from_numpy(decoded).view(torch.bfloat16))
    return Success(decoded)


def tensor_map_to_proto(flat: Mapping[str, np.ndarray]) -> tensors_pb2.TensorMapProto:
    proto = tensors_pb2.TensorMapProto()
    for key in sorted(flat):  # deterministic serialization order
        proto.entries[key].CopyFrom(tensor_to_proto(flat[key]))
    return proto


def tensor_map_from_proto(
    proto: tensors_pb2.TensorMapProto,
) -> Result[dict[str, np.ndarray], SerializationError]:
    out: dict[str, np.ndarray] = {}
    for key, tp in proto.entries.items():
        res = tensor_from_proto(tp)
        if isinstance(res, Failure):
            return Failure(DecodeError(what=f"tensor_map[{key}]", reason=repr(res.error)))
        out[key] = res.value
    return Success(out)


# --------------------------------------------------------------------------
# Simulation config
# --------------------------------------------------------------------------


def basket_spec_to_proto(spec: BasketSpec) -> simulation_pb2.BasketSpecProto:
    n = len(spec.weights)
    flat_corr = [spec.correlation[i][j] for i in range(n) for j in range(n)]
    return simulation_pb2.BasketSpecProto(
        weights=list(spec.weights),
        spot_multipliers=list(spec.spot_multipliers),
        vol_multipliers=list(spec.vol_multipliers),
        correlation=flat_corr,
        combine=spec.combine.value,
    )


def basket_spec_from_proto(
    proto: simulation_pb2.BasketSpecProto,
) -> Result[BasketSpec, SerializationError]:
    n = len(proto.weights)
    if len(proto.correlation) != n * n:
        return Failure(
            DecodeError(
                what="basket.correlation",
                reason=f"expected {n * n} row-major entries, got {len(proto.correlation)}",
            )
        )
    corr = tuple(tuple(proto.correlation[i * n + j] for j in range(n)) for i in range(n))
    built = build_basket_spec(
        weights=tuple(proto.weights),
        correlation=corr,
        spot_multipliers=tuple(proto.spot_multipliers) or None,
        vol_multipliers=tuple(proto.vol_multipliers) or None,
        combine=proto.combine or "arithmetic",
    )
    if isinstance(built, Failure):
        return Failure(DecodeError(what="basket", reason=repr(built.error)))
    return Success(built.value)


def sim_params_to_proto(sim: SimulationParams) -> simulation_pb2.SimulationParamsProto:
    proto = simulation_pb2.SimulationParamsProto(
        timesteps=sim.timesteps,
        network_size=sim.network_size,
        batches_per_mc_run=sim.batches_per_mc_run,
        mc_seed=sim.mc_seed,
        skip=sim.skip,
        precision=_PRECISION_TO_PROTO[sim.precision],
        scheme=_SCHEME_TO_PROTO[sim.scheme],
        normalization=_NORM_TO_PROTO[sim.normalization],
        implementation=sim.implementation.value,
        payoff=sim.payoff.value,
        model=sim.model.value,
        barrier_rel=sim.barrier_rel or 0.0,  # 0 encodes absent (invalid as a level)
        antithetic=sim.antithetic,
        lsmc_basis_degree=sim.lsmc_basis_degree,
        lsmc_exercise_every=sim.lsmc_exercise_every,
        lsmc_cross_fit=sim.lsmc_cross_fit,
        lsmc_fused_backward=sim.lsmc_fused_backward,
        forward_start_step=sim.forward_start_step or 0,  # 0 encodes absent
        cliquet_reset_every=sim.cliquet_reset_every or 0,  # 0 encodes absent
        sampling=sim.sampling.value,
    )
    if sim.cliquet_floor is not None:
        proto.cliquet_floor = sim.cliquet_floor  # explicit presence: 0.0 is a level
    if sim.cliquet_cap is not None:
        proto.cliquet_cap = sim.cliquet_cap
    if sim.basket is not None:
        proto.basket.CopyFrom(basket_spec_to_proto(sim.basket))
    if sim.term is not None:
        proto.term.vol_shape.extend(sim.term.vol_shape)
        proto.term.rate_shape.extend(sim.term.rate_shape)
        proto.term.div_shape.extend(sim.term.div_shape)
        # an all-flat TermStructure would serialize indistinguishably from
        # "absent" with empty shapes; mark presence explicitly
        proto.term.SetInParent()
    return proto


def sim_params_from_proto(
    proto: simulation_pb2.SimulationParamsProto,
) -> Result[SimulationParams, SerializationError]:
    basket = None
    if proto.HasField("basket"):
        decoded = basket_spec_from_proto(proto.basket)
        if isinstance(decoded, Failure):
            return Failure(decoded.error)
        basket = decoded.value
    try:
        return Success(
            SimulationParams(
                timesteps=proto.timesteps,
                network_size=proto.network_size,
                batches_per_mc_run=proto.batches_per_mc_run,
                mc_seed=proto.mc_seed,
                skip=proto.skip,
                precision=_PRECISION_FROM_PROTO[proto.precision],
                scheme=_SCHEME_FROM_PROTO[proto.scheme],
                normalization=_NORM_FROM_PROTO[proto.normalization],
                implementation=SimImplementation(proto.implementation or "xla"),
                payoff=PayoffKind(proto.payoff or "terminal"),
                model=ModelKind(proto.model or "gbm"),
                basket=basket,
                barrier_rel=proto.barrier_rel if proto.barrier_rel > 0.0 else None,
                antithetic=proto.antithetic,
                # 0 = absent (a checkpoint older than the field) -> degree 5
                lsmc_basis_degree=proto.lsmc_basis_degree or 5,
                lsmc_exercise_every=proto.lsmc_exercise_every or 1,
                lsmc_cross_fit=proto.lsmc_cross_fit,
                lsmc_fused_backward=proto.lsmc_fused_backward,
                # 0 = absent (non-forward-start checkpoint)
                forward_start_step=proto.forward_start_step or None,
                # 0 = absent (non-cliquet checkpoint); floor/cap carry
                # explicit proto3 presence (0.0 is a meaningful floor)
                cliquet_reset_every=proto.cliquet_reset_every or None,
                cliquet_floor=proto.cliquet_floor if proto.HasField("cliquet_floor") else None,
                cliquet_cap=proto.cliquet_cap if proto.HasField("cliquet_cap") else None,
                # "" = a checkpoint older than QMC -> the pseudo stream
                sampling=SamplingKind(proto.sampling or "pseudo"),
                # absent = a checkpoint older than curves -> flat market
                term=TermStructure(
                    vol_shape=tuple(proto.term.vol_shape),
                    rate_shape=tuple(proto.term.rate_shape),
                    div_shape=tuple(proto.term.div_shape),
                )
                if proto.HasField("term")
                else None,
            )
        )
    except (KeyError, ValueError) as exc:
        return Failure(DecodeError(what="sim_params", reason=str(exc)))


# --------------------------------------------------------------------------
# CVNN config with the complete recursive layer oneof
# --------------------------------------------------------------------------


def _layer_to_proto(cfg: LayerCfg) -> models_pb2.LayerCfgProto:
    proto = models_pb2.LayerCfgProto()
    if isinstance(cfg, LinearCfg):
        proto.linear.has_width = cfg.width is not None
        proto.linear.width = cfg.width if cfg.width is not None else 0
        proto.linear.bias = cfg.bias
        proto.linear.activation = _ACTIVATION_TO_PROTO[cfg.activation]
    elif isinstance(cfg, NaiveBNCfg):
        proto.naive_bn.SetInParent()
    elif isinstance(cfg, CovBNCfg):
        proto.cov_bn.SetInParent()
    elif isinstance(cfg, SequentialCfg):
        proto.sequential.layers.extend(_layer_to_proto(sub) for sub in cfg.layers)
    elif isinstance(cfg, ResidualCfg):
        proto.residual.body.CopyFrom(_layer_to_proto(cfg.body))
        proto.residual.activation = _ACTIVATION_TO_PROTO[cfg.activation]
    else:  # pragma: no cover — exhaustiveness backstop
        raise TypeError(f"unknown layer cfg {type(cfg)!r}")
    return proto


def _layer_from_proto(
    proto: models_pb2.LayerCfgProto,
) -> Result[LayerCfg, SerializationError]:
    kind = proto.WhichOneof("kind")
    if kind == "linear":
        act = _ACTIVATION_FROM_PROTO.get(proto.linear.activation, Activation.NONE)
        return Success(
            LinearCfg(
                width=proto.linear.width if proto.linear.has_width else None,
                bias=proto.linear.bias,
                activation=act,
            )
        )
    if kind == "naive_bn":
        return Success(NaiveBNCfg())
    if kind == "cov_bn":
        return Success(CovBNCfg())
    if kind == "sequential":
        subs = []
        for sub in proto.sequential.layers:
            res = _layer_from_proto(sub)
            if isinstance(res, Failure):
                return res
            subs.append(res.value)
        return Success(SequentialCfg(layers=tuple(subs)))
    if kind == "residual":
        body = _layer_from_proto(proto.residual.body)
        if isinstance(body, Failure):
            return body
        act = _ACTIVATION_FROM_PROTO.get(proto.residual.activation, Activation.NONE)
        return Success(ResidualCfg(body=body.value, activation=act))
    return Failure(DecodeError(what="layer_cfg", reason=f"unset oneof kind {kind!r}"))


def cvnn_config_to_proto(cfg: CVNNConfig) -> models_pb2.CVNNConfigProto:
    return models_pb2.CVNNConfigProto(
        precision=_PRECISION_TO_PROTO[cfg.precision],
        layers=[_layer_to_proto(layer) for layer in cfg.layers],
        seed=cfg.seed,
        final_activation=_ACTIVATION_TO_PROTO[cfg.final_activation],
    )


def cvnn_config_from_proto(
    proto: models_pb2.CVNNConfigProto,
) -> Result[CVNNConfig, SerializationError]:
    layers = []
    for lp in proto.layers:
        res = _layer_from_proto(lp)
        if isinstance(res, Failure):
            return Failure(res.error)
        layers.append(res.value)
    precision = _PRECISION_FROM_PROTO.get(proto.precision)
    if precision is None:
        return Failure(DecodeError(what="cvnn_config", reason="unset precision"))
    return Success(
        CVNNConfig(
            precision=precision,
            layers=tuple(layers),
            seed=proto.seed,
            final_activation=_ACTIVATION_FROM_PROTO.get(
                proto.final_activation, Activation.NONE
            ),
        )
    )


# --------------------------------------------------------------------------
# Training config
# --------------------------------------------------------------------------


def training_config_to_proto(cfg: "TrainingConfig") -> training_pb2.TrainingConfigProto:
    proto = training_pb2.TrainingConfigProto(
        num_batches=cfg.num_batches,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        contract_chunk=cfg.contract_chunk or 0,
    )
    if cfg.lr_schedule is not None:
        proto.lr_schedule.CopyFrom(
            training_pb2.LRScheduleProto(
                peak=cfg.lr_schedule.peak,
                decay_steps=cfg.lr_schedule.decay_steps,
                warmup_steps=cfg.lr_schedule.warmup_steps,
                end_value=cfg.lr_schedule.end_value,
            )
        )
    return proto


def training_config_from_proto(
    proto: training_pb2.TrainingConfigProto,
) -> Result["TrainingConfig", SerializationError]:
    from spectralmc_tpu_torch.training.step import LRScheduleConfig
    from spectralmc_tpu_torch.training.trainer import build_training_config

    schedule = None
    if proto.HasField("lr_schedule"):
        schedule = LRScheduleConfig(
            peak=proto.lr_schedule.peak,
            decay_steps=proto.lr_schedule.decay_steps,
            warmup_steps=proto.lr_schedule.warmup_steps,
            end_value=proto.lr_schedule.end_value,
        )
    res = build_training_config(
        num_batches=proto.num_batches,
        batch_size=proto.batch_size,
        learning_rate=proto.learning_rate,
        contract_chunk=proto.contract_chunk or None,
        lr_schedule=schedule,
    )
    if isinstance(res, Failure):
        return Failure(DecodeError(what="training_config", reason=repr(res.error)))
    return Success(res.value)


# --------------------------------------------------------------------------
# Adam state (typed, versioned)
# --------------------------------------------------------------------------


def adam_state_to_proto(snapshot: "AdamStateSnapshot") -> tensors_pb2.AdamStateProto:
    return tensors_pb2.AdamStateProto(
        schema_version=snapshot.schema_version,
        mu=tensor_map_to_proto(snapshot.mu),
        nu=tensor_map_to_proto(snapshot.nu),
        count=snapshot.count,
    )


def adam_state_from_proto(
    proto: tensors_pb2.AdamStateProto,
) -> Result["AdamStateSnapshot", SerializationError]:
    from spectralmc_tpu_torch.training.adam_state import ADAM_SCHEMA_VERSION, AdamStateSnapshot

    if proto.schema_version != ADAM_SCHEMA_VERSION:
        return Failure(
            DecodeError(
                what="adam_state",
                reason=f"schema_version {proto.schema_version} unsupported "
                f"(this build reads v{ADAM_SCHEMA_VERSION})",
            )
        )
    mu = tensor_map_from_proto(proto.mu)
    if isinstance(mu, Failure):
        return Failure(mu.error)
    nu = tensor_map_from_proto(proto.nu)
    if isinstance(nu, Failure):
        return Failure(nu.error)
    try:
        return Success(
            AdamStateSnapshot(
                mu=mu.value, nu=nu.value, count=proto.count,
                schema_version=proto.schema_version,
            )
        )
    except ValueError as exc:
        return Failure(DecodeError(what="adam_state", reason=str(exc)))


# --------------------------------------------------------------------------
# Checkpoint root
# --------------------------------------------------------------------------


def _record(cls: type, proto: object) -> object:
    """A provenance record from its message, field by field."""
    return cls(**{f.name: getattr(proto, f.name) for f in fields(cls)})


def checkpoint_to_proto(config: "GbmCVNNPricerConfig") -> tensors_pb2.ModelCheckpointProto:
    proto = tensors_pb2.ModelCheckpointProto(
        sim=sim_params_to_proto(config.sim),
        cvnn=cvnn_config_to_proto(config.cvnn),
        global_step=config.global_step,
        sobol_skip=config.sobol_skip,
        normalize_inputs=config.normalize_inputs,
        pallas_stream_version=config.pallas_stream_version,
        lsmc_backward_version=config.lsmc_backward_version,
        cuda_stream_version=config.cuda_stream_version,
    )
    # the records the config came with, never a fresh stamp (module docstring)
    record = config.provenance
    if record.jax_env is not None:
        proto.env.CopyFrom(common_pb2.JaxEnvProto(**asdict(record.jax_env)))
    if record.torch_env is not None:
        proto.torch_env.CopyFrom(common_pb2.TorchEnvProto(**asdict(record.torch_env)))
    for name in sorted(config.bounds):
        spec = config.bounds[name]
        proto.bounds[name].lower = spec.lower
        proto.bounds[name].upper = spec.upper
    if config.model_state is not None:
        proto.model_state.CopyFrom(tensor_map_to_proto(config.model_state))
    if config.optimizer_state is not None:
        # always WRITE the typed schema; legacy flat maps migrate first
        from spectralmc_tpu_torch.training.adam_state import coerce_optimizer_state

        proto.adam_state.CopyFrom(
            adam_state_to_proto(coerce_optimizer_state(config.optimizer_state))
        )
    return proto


def checkpoint_from_proto(
    proto: tensors_pb2.ModelCheckpointProto,
) -> Result["GbmCVNNPricerConfig", SerializationError]:
    from spectralmc_tpu_torch.training.adam_state import migrate_legacy_flat
    from spectralmc_tpu_torch.training.trainer import GbmCVNNPricerConfig

    sim = sim_params_from_proto(proto.sim)
    if isinstance(sim, Failure):
        return Failure(sim.error)
    cvnn = cvnn_config_from_proto(proto.cvnn)
    if isinstance(cvnn, Failure):
        return Failure(cvnn.error)
    bounds = {
        name: BoundSpec(lower=bp.lower, upper=bp.upper) for name, bp in proto.bounds.items()
    }
    model_state: dict[str, np.ndarray] | None = None
    if proto.HasField("model_state"):
        res = tensor_map_from_proto(proto.model_state)
        if isinstance(res, Failure):
            return Failure(res.error)
        model_state = res.value
    optimizer_state: "AdamStateSnapshot | None" = None
    if proto.HasField("adam_state"):
        adam = adam_state_from_proto(proto.adam_state)
        if isinstance(adam, Failure):
            return Failure(adam.error)
        optimizer_state = adam.value
    elif proto.HasField("optimizer_state"):
        # the legacy positional optax path map: migrate on read
        res = tensor_map_from_proto(proto.optimizer_state)
        if isinstance(res, Failure):
            return Failure(res.error)
        try:
            optimizer_state = migrate_legacy_flat(res.value)
        except (KeyError, TypeError, ValueError) as exc:
            return Failure(DecodeError(what="optimizer_state(legacy)", reason=str(exc)))
    jax_env = _record(JaxEnv, proto.env) if proto.HasField("env") else None
    torch_env = _record(TorchEnv, proto.torch_env) if proto.HasField("torch_env") else None
    return Success(
        GbmCVNNPricerConfig(
            sim=sim.value,
            bounds=bounds,
            cvnn=cvnn.value,
            global_step=proto.global_step,
            sobol_skip=proto.sobol_skip,
            normalize_inputs=proto.normalize_inputs,
            pallas_stream_version=proto.pallas_stream_version,
            lsmc_backward_version=proto.lsmc_backward_version,
            model_state=model_state,
            optimizer_state=optimizer_state,
            cuda_stream_version=proto.cuda_stream_version,
            provenance=Provenance(jax_env=jax_env, torch_env=torch_env),
        )
    )


def serialize_checkpoint(config: "GbmCVNNPricerConfig") -> tuple[bytes, str]:
    """Checkpoint bytes and their content hash (sha256)."""
    data = checkpoint_to_proto(config).SerializeToString(deterministic=True)
    return data, compute_sha256(data)


def deserialize_checkpoint(
    data: bytes, *, expected_hash: str | None = None
) -> Result["GbmCVNNPricerConfig", SerializationError]:
    if expected_hash is not None:
        checked = verify_checksum(data, expected_hash)
        if isinstance(checked, Failure):
            return Failure(checked.error)
    proto = tensors_pb2.ModelCheckpointProto()
    try:
        proto.ParseFromString(data)
    except Exception as exc:  # noqa: BLE001 — protobuf's DecodeError, or upb's
        return Failure(DecodeError(what="checkpoint", reason=str(exc)))
    return checkpoint_from_proto(proto)
