"""Complex-valued neural-network layers and the declarative model factory."""

from spectralmc_tpu_torch.models.cvnn import (
    ComplexLinear,
    ComplexResidual,
    ComplexSequential,
    CovarianceComplexBatchNorm,
    ModReLU,
    NaiveComplexBatchNorm,
    ZReLU,
)
from spectralmc_tpu_torch.models.factory import (
    CVNN,
    Activation,
    CovBNCfg,
    CVNNConfig,
    LinearCfg,
    NaiveBNCfg,
    ResidualCfg,
    SequentialCfg,
    build_cvnn_config,
    build_model,
    get_state_dict,
    load_state_dict,
)

__all__ = [
    "CVNN",
    "Activation",
    "ComplexLinear",
    "ComplexResidual",
    "ComplexSequential",
    "CovBNCfg",
    "CVNNConfig",
    "CovarianceComplexBatchNorm",
    "LinearCfg",
    "ModReLU",
    "NaiveBNCfg",
    "NaiveComplexBatchNorm",
    "ResidualCfg",
    "SequentialCfg",
    "ZReLU",
    "build_cvnn_config",
    "build_model",
    "get_state_dict",
    "load_state_dict",
]
