"""Training orchestrator: the fused Sobol→MC→FFT→CVNN→Adam step on PyTorch."""

from spectralmc_tpu_torch.training.trainer import (
    CommitPlan,
    FinalAndIntervalCommit,
    FinalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    IntervalCommit,
    NoCommit,
    PricePrediction,
    SegmentMetrics,
    StepMetrics,
    TrainingConfig,
    TrainingResult,
    build_training_config,
)

__all__ = [
    "CommitPlan",
    "FinalAndIntervalCommit",
    "FinalCommit",
    "GbmCVNNPricer",
    "GbmCVNNPricerConfig",
    "IntervalCommit",
    "NoCommit",
    "PricePrediction",
    "SegmentMetrics",
    "StepMetrics",
    "TrainingConfig",
    "TrainingResult",
    "build_training_config",
]
