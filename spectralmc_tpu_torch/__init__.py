"""spectralmc_tpu_torch — the PyTorch/CUDA port of the JAX package.

Complex-valued neural networks trained online on the DFT (characteristic
function) of Monte-Carlo payoff distributions, served as a pricer. This
package carries the main path — Sobol contracts → Monte-Carlo → FFT → CVNN →
Adam, with snapshot/resume and serving — on PyTorch for GBM (flat or under
piecewise-constant term structures), Heston, Merton and basket dynamics,
pseudo-random or Sobol/Brownian-bridge paths and every payoff (the American
ones, by Longstaff–Schwartz regression, under GBM, Heston, Merton and
baskets), with the MC hot loop in hand-written CUDA kernels for Hopper
(``csrc/gbm_paths.cu``, ``csrc/dynamics_paths.cu``, ``csrc/basket_paths.cu``,
``csrc/qmc_paths.cu``, ``csrc/american_paths.cu``,
``csrc/american_dynamics.cu``, and the LSMC backwards
``csrc/lsmc_backward.cu`` and ``csrc/lsmc_two_state.cu``). Checkpoints are
the JAX package's protobuf bytes (``serialization``, ``proto``), committed
to and served from the same content-addressed chain (``storage``), at the
end of a run or at an interval. A run is also described as data and
interpreted (``effects``, ``GbmCVNNPricer.train_via_effects``); ``utils``
holds the TensorBoard sinks, the profiler trace and the FLOP count. Greeks
come by autograd of the MC price (``ops/greeks.py``: pathwise through the
kernels' backward rules, bump-and-reprice, the closed forms) and of the
learned pricer (``GbmCVNNPricer.predict_greeks``); ``BlackScholes`` is the
one-contract pricing facade.
It imports neither JAX nor the JAX package; the tests hold it against both.
"""

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): importing the package does not import torch.
_EXPORTS = {
    "Result": "spectralmc_tpu_torch.core.result",
    "Success": "spectralmc_tpu_torch.core.result",
    "Failure": "spectralmc_tpu_torch.core.result",
    "Precision": "spectralmc_tpu_torch.core.precision",
    "BlackScholes": "spectralmc_tpu_torch.ops.gbm",
    "BlackScholesContract": "spectralmc_tpu_torch.ops.gbm",
    "SimulationParams": "spectralmc_tpu_torch.ops.gbm",
    "build_simulation_params": "spectralmc_tpu_torch.ops.gbm",
    "PathScheme": "spectralmc_tpu_torch.ops.gbm",
    "PayoffKind": "spectralmc_tpu_torch.ops.gbm",
    "ModelKind": "spectralmc_tpu_torch.ops.gbm",
    "SimImplementation": "spectralmc_tpu_torch.ops.gbm",
    "SamplingKind": "spectralmc_tpu_torch.ops.gbm",
    "TermStructure": "spectralmc_tpu_torch.ops.gbm",
    "bootstrap_vol_shape": "spectralmc_tpu_torch.ops.gbm",
    "term_effective_black": "spectralmc_tpu_torch.ops.analytic",
    "HestonContract": "spectralmc_tpu_torch.ops.heston",
    "heston_call_price": "spectralmc_tpu_torch.ops.heston",
    "MertonContract": "spectralmc_tpu_torch.ops.merton",
    "merton_call_price": "spectralmc_tpu_torch.ops.merton",
    "BasketCombine": "spectralmc_tpu_torch.ops.basket",
    "BasketSpec": "spectralmc_tpu_torch.ops.basket",
    "build_basket_spec": "spectralmc_tpu_torch.ops.basket",
    "lsmc_price": "spectralmc_tpu_torch.ops.american",
    "bermudan_tree_price": "spectralmc_tpu_torch.ops.american",
    "OptionSide": "spectralmc_tpu_torch.ops.american",
    "mc_greeks": "spectralmc_tpu_torch.ops.greeks",
    "analytic_greeks": "spectralmc_tpu_torch.ops.greeks",
    "black_scholes_price": "spectralmc_tpu_torch.ops.analytic",
    "geometric_basket_price": "spectralmc_tpu_torch.ops.analytic",
    "BoundSpec": "spectralmc_tpu_torch.ops.sobol",
    "SobolSampler": "spectralmc_tpu_torch.ops.sobol",
    "build_cvnn_config": "spectralmc_tpu_torch.models.factory",
    "build_model": "spectralmc_tpu_torch.models.factory",
    "Activation": "spectralmc_tpu_torch.models.factory",
    "LinearCfg": "spectralmc_tpu_torch.models.factory",
    "GbmCVNNPricer": "spectralmc_tpu_torch.training.trainer",
    "GbmCVNNPricerConfig": "spectralmc_tpu_torch.training.trainer",
    "build_training_config": "spectralmc_tpu_torch.training.trainer",
    "NoCommit": "spectralmc_tpu_torch.training.trainer",
    "FinalCommit": "spectralmc_tpu_torch.training.trainer",
    "IntervalCommit": "spectralmc_tpu_torch.training.trainer",
    "FinalAndIntervalCommit": "spectralmc_tpu_torch.training.trainer",
    "AsyncBlockchainModelStore": "spectralmc_tpu_torch.storage.store",
    "FileSystemObjectStore": "spectralmc_tpu_torch.storage.object_store",
    "InferenceClient": "spectralmc_tpu_torch.storage.inference",
}

__all__ = ["__version__", *sorted(_EXPORTS)]


def __dir__() -> list[str]:
    return sorted(__all__)


def __getattr__(name: str) -> object:
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
