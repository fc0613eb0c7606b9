"""Functional core: Result ADT, error ADTs, precision policy, validation."""


# Lazy exports (PEP 562): ``result`` and the error types load without
# torch; ``precision`` and ``validation`` import it when named.
_EXPORTS = {
    "Failure": "spectralmc_tpu_torch.core.result",
    "Precision": "spectralmc_tpu_torch.core.precision",
    "ReducedPrecision": "spectralmc_tpu_torch.core.precision",
    "Result": "spectralmc_tpu_torch.core.result",
    "Success": "spectralmc_tpu_torch.core.result",
    "UnwrapError": "spectralmc_tpu_torch.core.result",
    "collect_results": "spectralmc_tpu_torch.core.result",
    "fold_results": "spectralmc_tpu_torch.core.result",
    "partition_results": "spectralmc_tpu_torch.core.result",
    "real_dtype_of": "spectralmc_tpu_torch.core.precision",
    "validate_model": "spectralmc_tpu_torch.core.validation",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> object:
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS))
