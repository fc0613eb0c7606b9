"""Effect ADTs — 7 families, frozen dataclasses with ``kind`` discriminators.

The JAX package's ``effects/types.py``: every effect, field and ``kind`` is
kept, so a description built for one package reads the same in the other.
What the device effects mean on PyTorch (``effects/interpreter.py``):

| effect             | on PyTorch                                            |
|--------------------|-------------------------------------------------------|
| HostDeviceTransfer | ``torch.as_tensor(..., device=)`` / ``.cpu().numpy()`` |
| BlockUntilReady    | a synchronise on the tensor's device                  |
| JitCall            | the registered callable, called as it is             |
| TrainSegment       | the trainer's segment: ``length`` fused batches       |

The ``"jit_call"`` and ``"block_until_ready"`` kinds keep their JAX names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Mapping, Union

from spectralmc_tpu_torch.core.result import Failure, Result, Success

# --------------------------------------------------------------------------
# Device family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class HostDeviceTransfer:
    kind: Literal["host_device_transfer"] = "host_device_transfer"
    tensor_id: str = ""
    direction: Literal["host_to_device", "device_to_host"] = "host_to_device"


@dataclass(frozen=True, slots=True)
class BlockUntilReady:
    kind: Literal["block_until_ready"] = "block_until_ready"
    tensor_id: str = ""


@dataclass(frozen=True, slots=True)
class JitCall:
    kind: Literal["jit_call"] = "jit_call"
    fn_id: str = ""
    arg_ids: tuple[str, ...] = ()
    out_id: str = ""


DeviceEffect = Union[HostDeviceTransfer, BlockUntilReady, JitCall]


def build_host_device_transfer(
    tensor_id: str, direction: str
) -> Result[HostDeviceTransfer, str]:
    """Validated factory (parity: TensorTransfer's same-device rejection)."""
    if direction not in ("host_to_device", "device_to_host"):
        return Failure(f"invalid direction {direction!r}")
    if not tensor_id:
        return Failure("tensor_id required")
    return Success(HostDeviceTransfer(tensor_id=tensor_id, direction=direction))  # type: ignore[arg-type]


# --------------------------------------------------------------------------
# Monte-Carlo family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class GenerateNormals:
    kind: Literal["generate_normals"] = "generate_normals"
    rows: int = 0
    cols: int = 0
    seed: int = 0
    counter: int = 0  # the draw index (the checkpointed "skip")
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class SimulatePaths:
    kind: Literal["simulate_paths"] = "simulate_paths"
    spot: float = 0.0
    strike: float = 0.0
    maturity: float = 0.0
    rate: float = 0.0
    div_yield: float = 0.0
    vol: float = 0.0
    timesteps: int = 0
    batches: int = 0
    network_size: int = 0
    seed: int = 0
    counter: int = 0
    scheme: str = "log_euler"
    normalization: str = "mean"
    payoff: str = "terminal"  # PayoffKind value
    model: str = "gbm"  # ModelKind value
    precision: str = "float32"  # Precision value
    antithetic: bool = False  # second half of rows mirrors the first's normals
    barrier_rel: float = 0.0  # knockout level x spot; 0 = not a barrier payoff
    # LSMC knobs (AMERICAN payoff kinds only; mirror SimulationParams)
    lsmc_basis_degree: int = 5
    lsmc_exercise_every: int = 1
    # strike-setting grid index (FORWARD_START payoff only; 0 = unset)
    forward_start_step: int = 0
    # cliquet reset grid + clip levels (CLIQUET payoff only; reset 0 = unset;
    # floor/cap are None-when-absent — 0.0 is a meaningful floor)
    cliquet_reset_every: int = 0
    cliquet_floor: float | None = None
    cliquet_cap: float | None = None
    sampling: str = "pseudo"  # SamplingKind value (path-increment source)
    # piecewise-constant curves (TermStructure shapes; () = flat). GBM only.
    term_vol: tuple[float, ...] = ()
    term_rate: tuple[float, ...] = ()
    term_div: tuple[float, ...] = ()
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class ComputeFFT:
    kind: Literal["compute_fft"] = "compute_fft"
    in_id: str = ""
    batches: int = 0
    network_size: int = 0
    out_id: str = ""


MonteCarloEffect = Union[GenerateNormals, SimulatePaths, ComputeFFT]


# --------------------------------------------------------------------------
# Training family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ForwardPass:
    kind: Literal["forward_pass"] = "forward_pass"
    model_id: str = ""
    in_id: str = ""
    out_id: str = ""
    train: bool = False


@dataclass(frozen=True, slots=True)
class ComputeLoss:
    kind: Literal["compute_loss"] = "compute_loss"
    loss_type: Literal["mse", "mae", "huber"] = "mse"
    pred_id: str = ""
    target_id: str = ""
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class GradientStep:
    """Fused backward + optimizer update (a registered ``gradient_step`` callable)."""

    kind: Literal["gradient_step"] = "gradient_step"
    model_id: str = ""
    optimizer_id: str = ""
    loss_id: str = ""


@dataclass(frozen=True, slots=True)
class TrainSegment:
    """``length`` fused batches with one device→host fetch at the end — the
    execution unit (the trainer's segment)."""

    kind: Literal["train_segment"] = "train_segment"
    length: int = 0
    batch_size: int = 0
    learning_rate: float = 0.0
    commit_after: bool = False


@dataclass(frozen=True, slots=True)
class LogMetrics:
    kind: Literal["log_metrics"] = "log_metrics"
    step: int = 0
    metrics: Mapping[str, float] = None  # type: ignore[assignment]


TrainingEffect = Union[ForwardPass, ComputeLoss, GradientStep, TrainSegment, LogMetrics]


# --------------------------------------------------------------------------
# Storage family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ReadObject:
    kind: Literal["read_object"] = "read_object"
    key: str = ""
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class WriteObject:
    kind: Literal["write_object"] = "write_object"
    key: str = ""
    data_id: str = ""


@dataclass(frozen=True, slots=True)
class CommitVersion:
    kind: Literal["commit_version"] = "commit_version"
    data_id: str = ""
    content_hash: str = ""
    message: str = ""


StorageEffect = Union[ReadObject, WriteObject, CommitVersion]


# --------------------------------------------------------------------------
# RNG family — stateless keys make state capture trivial
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class CaptureCounters:
    kind: Literal["capture_counters"] = "capture_counters"
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class RestoreCounters:
    kind: Literal["restore_counters"] = "restore_counters"
    sobol_skip: int = 0
    mc_skip: int = 0


@dataclass(frozen=True, slots=True)
class AdvanceCounter:
    kind: Literal["advance_counter"] = "advance_counter"
    stream: Literal["sobol", "mc"] = "mc"
    by: int = 1


RngEffect = Union[CaptureCounters, RestoreCounters, AdvanceCounter]


# --------------------------------------------------------------------------
# Metadata family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ReadMetadata:
    kind: Literal["read_metadata"] = "read_metadata"
    key: str = ""
    out_id: str = ""


@dataclass(frozen=True, slots=True)
class UpdateMetadata:
    kind: Literal["update_metadata"] = "update_metadata"
    key: str = ""
    operation: Literal["set", "add", "increment"] = "set"
    value: float | int | str = 0


MetadataEffect = Union[ReadMetadata, UpdateMetadata]


# --------------------------------------------------------------------------
# Logging family
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class LogMessage:
    kind: Literal["log_message"] = "log_message"
    level: Literal["debug", "info", "warning", "error"] = "info"
    message: str = ""
    logger: str = "spectralmc_tpu"


LoggingEffect = Union[LogMessage]


# --------------------------------------------------------------------------
# Master union
# --------------------------------------------------------------------------

Effect = Union[
    DeviceEffect,
    MonteCarloEffect,
    TrainingEffect,
    StorageEffect,
    RngEffect,
    MetadataEffect,
    LoggingEffect,
]
