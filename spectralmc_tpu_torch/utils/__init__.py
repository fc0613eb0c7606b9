"""Observability utilities: TensorBoard logging, profiling, FLOP accounting."""

from spectralmc_tpu_torch.utils.profiling import profile_trace, span
from spectralmc_tpu_torch.utils.tensorboard_writer import (
    TensorBoardLogger,
    log_chain_to_tensorboard,
)

__all__ = ["TensorBoardLogger", "log_chain_to_tensorboard", "profile_trace", "span"]
