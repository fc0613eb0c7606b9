"""Observability utilities: TensorBoard logging, profiling, FLOP accounting."""

from spectralmc_tpu_torch.utils.profiling import StepTimer, profile_trace
from spectralmc_tpu_torch.utils.tensorboard_writer import (
    TensorBoardLogger,
    log_chain_to_tensorboard,
)

__all__ = ["StepTimer", "TensorBoardLogger", "log_chain_to_tensorboard", "profile_trace"]
