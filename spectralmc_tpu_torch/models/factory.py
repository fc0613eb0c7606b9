"""Declarative CVNN config → ``nn.Module`` compiler.

The port of the JAX package's ``models/factory.py``: the same layer-config
ADT (pydantic, so a JAX ``CVNNConfig`` dumps and loads 1:1), the same width
threading and automatic projection on width mismatch, the same appended
output head, and a state dict keyed by the JAX flat keys
(``params/<path>`` for parameters, ``state/<path>`` for batch-norm running
statistics). ``load_state_dict`` accepts those keys with numpy arrays: that
is how weights carry over from the JAX package.
"""

from __future__ import annotations

import enum
from typing import Annotated, Literal, Mapping, Union

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict, Field

from spectralmc_tpu_torch.core.errors.cvnn import (
    CVNNError,
    InvalidLayerConfig,
    InvalidModelConfig,
    StateDictMismatch,
)
from spectralmc_tpu_torch.core.precision import Precision
from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.models.cvnn import (
    ComplexLinear,
    ComplexModule,
    ComplexResidual,
    ComplexSequential,
    CovarianceComplexBatchNorm,
    ModReLU,
    NaiveComplexBatchNorm,
    ZReLU,
)
from spectralmc_tpu_torch.ops import rng


class Activation(enum.Enum):
    NONE = "none"
    ZRELU = "zrelu"
    MODRELU = "modrelu"


class LinearCfg(BaseModel):
    """Dense layer; ``width=None`` preserves the incoming width."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["linear"] = "linear"
    width: int | None = None
    bias: bool = True
    activation: Activation = Activation.NONE


class NaiveBNCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["naive_bn"] = "naive_bn"


class CovBNCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["cov_bn"] = "cov_bn"


class SequentialCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["sequential"] = "sequential"
    layers: tuple["LayerCfg", ...]


class ResidualCfg(BaseModel):
    """Residual block; a projection is auto-inserted when the body changes width."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["residual"] = "residual"
    body: "LayerCfg"
    activation: Activation = Activation.NONE


LayerCfg = Annotated[
    Union[LinearCfg, NaiveBNCfg, CovBNCfg, SequentialCfg, ResidualCfg],
    Field(discriminator="kind"),
]

SequentialCfg.model_rebuild()
ResidualCfg.model_rebuild()


class CVNNConfig(BaseModel):
    """Architecture record, serialized into checkpoints."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    precision: Precision = Precision.float32
    layers: tuple[LayerCfg, ...]
    seed: int
    final_activation: Activation = Activation.NONE


def build_cvnn_config(
    *,
    layers: tuple[LayerCfg, ...] | list[LayerCfg],
    seed: int,
    precision: Precision = Precision.float32,
    final_activation: Activation = Activation.NONE,
) -> Result[CVNNConfig, CVNNError]:
    if seed < 0:
        return Failure(InvalidModelConfig(field="seed", reason="seed must be >= 0"))
    if precision.is_complex():
        return Failure(
            InvalidModelConfig(
                field="precision", reason="config precision is the real backing dtype"
            )
        )
    return Success(
        CVNNConfig(
            precision=precision,
            layers=tuple(layers),
            seed=seed,
            final_activation=final_activation,
        )
    )


# --------------------------------------------------------------------------
# Compilation: config → module tree
# --------------------------------------------------------------------------


def _activation_layer(act: Activation, width: int, dtype: torch.dtype) -> ComplexModule | None:
    if act == Activation.NONE:
        return None
    if act == Activation.ZRELU:
        return ZReLU()
    return ModReLU(width, dtype=dtype)


def _compile_layer(
    cfg: LayerCfg, in_dim: int, dtype: torch.dtype, index: int
) -> Result[tuple[ComplexModule, int], CVNNError]:
    """Compile one config node; returns (module, out_dim)."""
    if isinstance(cfg, LinearCfg):
        out_dim = cfg.width if cfg.width is not None else in_dim
        if out_dim <= 0:
            return Failure(
                InvalidLayerConfig(layer_index=index, kind="linear", reason="width must be > 0")
            )
        linear = ComplexLinear(in_dim, out_dim, bias=cfg.bias, dtype=dtype)
        act = _activation_layer(cfg.activation, out_dim, dtype)
        layer = linear if act is None else ComplexSequential((linear, act))
        return Success((layer, out_dim))
    if isinstance(cfg, NaiveBNCfg):
        return Success((NaiveComplexBatchNorm(in_dim, dtype=dtype), in_dim))
    if isinstance(cfg, CovBNCfg):
        return Success((CovarianceComplexBatchNorm(in_dim, dtype=dtype), in_dim))
    if isinstance(cfg, SequentialCfg):
        compiled: list[ComplexModule] = []
        dim = in_dim
        for i, sub in enumerate(cfg.layers):
            res = _compile_layer(sub, dim, dtype, index * 1000 + i)
            if isinstance(res, Failure):
                return Failure(res.error)
            layer, dim = res.value
            compiled.append(layer)
        return Success((ComplexSequential(tuple(compiled)), dim))
    if isinstance(cfg, ResidualCfg):
        body_res = _compile_layer(cfg.body, in_dim, dtype, index * 1000)
        if isinstance(body_res, Failure):
            return Failure(body_res.error)
        body, out_dim = body_res.value
        projection = (
            ComplexLinear(in_dim, out_dim, bias=False, dtype=dtype) if out_dim != in_dim else None
        )
        post = _activation_layer(cfg.activation, out_dim, dtype)
        return Success((ComplexResidual(body, projection, post), out_dim))
    return Failure(
        InvalidLayerConfig(layer_index=index, kind=type(cfg).__name__, reason="unknown layer kind")
    )


class CVNN(ComplexSequential):
    """A compiled complex-valued model: the layer tree plus its config.

    ``init_from_seed`` reproduces the JAX ``model.init()`` from
    ``config.seed`` (threefry keys), bit for bit.
    """

    def __init__(
        self,
        config: CVNNConfig,
        layers: tuple[ComplexModule, ...],
        input_dim: int,
        output_dim: int,
    ) -> None:
        super().__init__(layers)
        self.config = config
        self.input_dim = input_dim
        self.output_dim = output_dim

    def init_from_seed(self) -> None:
        self.init_from_key(rng.prng_key(self.config.seed))


def build_model(
    config: CVNNConfig, *, input_dim: int, output_dim: int
) -> Result[CVNN, CVNNError]:
    """Compile config → model, threading widths and appending the output head.

    The returned module holds the seeded initial weights on the CPU.
    """
    if input_dim <= 0 or output_dim <= 0:
        return Failure(InvalidModelConfig(field="input/output_dim", reason="must be positive"))
    dtype = config.precision.to_torch()
    compiled: list[ComplexModule] = []
    dim = input_dim
    for i, layer_cfg in enumerate(config.layers):
        res = _compile_layer(layer_cfg, dim, dtype, i)
        if isinstance(res, Failure):
            return Failure(res.error)
        layer, dim = res.value
        compiled.append(layer)
    compiled.append(ComplexLinear(dim, output_dim, bias=True, dtype=dtype))
    final_act = _activation_layer(config.final_activation, output_dim, dtype)
    if final_act is not None:
        compiled.append(final_act)
    model = CVNN(config, tuple(compiled), input_dim, output_dim)
    model.init_from_seed()
    return Success(model)


# --------------------------------------------------------------------------
# State-dict round-trip in the JAX flat-key scheme
# --------------------------------------------------------------------------


def param_key(name: str) -> str:
    """``named_parameters`` name -> JAX parameter path (``layer_0/w_re``)."""
    return name.replace(".", "/")


def get_state_dict(model: CVNN) -> dict[str, np.ndarray]:
    """Flatten parameters and buffers to host numpy arrays under JAX keys."""
    out: dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        out[f"params/{param_key(name)}"] = p.detach().cpu().numpy().copy()
    for name, b in model.named_buffers():
        out[f"state/{param_key(name)}"] = b.detach().cpu().numpy().copy()
    return out


def load_state_dict(model: CVNN, flat: Mapping[str, np.ndarray]) -> Result[CVNN, CVNNError]:
    """Copy a flat JAX-keyed dict into ``model`` in place, checking keys,
    shapes and dtypes first (nothing is written on a mismatch)."""
    targets: dict[str, torch.Tensor] = {
        **{f"params/{param_key(n)}": p for n, p in model.named_parameters()},
        **{f"state/{param_key(n)}": b for n, b in model.named_buffers()},
    }
    if set(targets) != set(flat):
        missing = set(targets) - set(flat)
        extra = set(flat) - set(targets)
        return Failure(
            StateDictMismatch(
                key=sorted(missing | extra)[0],
                reason=f"missing={sorted(missing)} extra={sorted(extra)}",
            )
        )
    for key, target in targets.items():
        got = np.asarray(flat[key])
        if tuple(got.shape) != tuple(target.shape):
            return Failure(
                StateDictMismatch(
                    key=key, reason=f"shape {got.shape} != expected {tuple(target.shape)}"
                )
            )
        if torch.from_numpy(np.zeros((), dtype=got.dtype)).dtype != target.dtype:
            return Failure(
                StateDictMismatch(key=key, reason=f"dtype {got.dtype} != expected {target.dtype}")
            )
    with torch.no_grad():
        for key, target in targets.items():
            target.copy_(torch.from_numpy(np.array(flat[key])))
    return Success(model)
