"""Training orchestrator: the fused Sobol→MC→FFT→CVNN→Adam step on PyTorch."""

from spectralmc_tpu_torch.training.trainer import (
    CommitPlan,
    FinalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    NoCommit,
    PricePrediction,
    TrainingConfig,
    TrainingResult,
    build_training_config,
)

__all__ = [
    "CommitPlan",
    "FinalCommit",
    "GbmCVNNPricer",
    "GbmCVNNPricerConfig",
    "NoCommit",
    "PricePrediction",
    "TrainingConfig",
    "TrainingResult",
    "build_training_config",
]
