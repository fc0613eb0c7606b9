"""SharedRegistry — the typed data plane between effects.

The JAX package's ``effects/registry.py``: typed stores with duplicate-key
rejection, Result-returning getters, ``update_metadata`` with
set/add/increment semantics, ``freeze_snapshot()`` into an immutable view and
selective ``clear_*``.

On PyTorch the array store holds ``torch.Tensor`` values (and the numpy
arrays a ``device_to_host`` transfer leaves), and the model store holds the
port's ``nn.Module`` itself — the CVNN with its weights and batch-norm
buffers inside — not the JAX package's ``(cvnn, params, state)`` bundle:
a ``ForwardPass`` calls the module.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import MappingProxyType
from typing import Callable, Mapping

import numpy as np
import torch

from spectralmc_tpu_torch.core.result import Failure, Result, Success
from spectralmc_tpu_torch.effects.errors import RegistryError

MetadataValue = int | float | str
Array = torch.Tensor | np.ndarray


@dataclass(frozen=True)
class FrozenRegistrySnapshot:
    arrays: Mapping[str, Array]
    blobs: Mapping[str, bytes]
    metadata: Mapping[str, MetadataValue]
    models: Mapping[str, object]  # nn.Module (or a writer under TENSORBOARD_WRITER_KEY)
    optimizers: Mapping[str, object]
    functions: Mapping[str, Callable[..., object]]


class SharedRegistry:
    def __init__(self) -> None:
        self._arrays: dict[str, Array] = {}
        self._blobs: dict[str, bytes] = {}
        self._metadata: dict[str, MetadataValue] = {}
        self._models: dict[str, object] = {}
        self._optimizers: dict[str, object] = {}
        self._functions: dict[str, Callable[..., object]] = {}

    # -- generic helpers -----------------------------------------------------

    def _put(self, store: dict[str, object], key: str, value: object, what: str) -> Result[None, RegistryError]:
        if key in store:
            return Failure(RegistryError(key=key, reason=f"duplicate {what} key"))
        store[key] = value
        return Success(None)

    def _get(self, store: dict[str, object], key: str, what: str) -> Result[object, RegistryError]:
        if key not in store:
            return Failure(RegistryError(key=key, reason=f"unknown {what} key"))
        return Success(store[key])

    # -- arrays ---------------------------------------------------------------

    def put_array(self, key: str, value: Array) -> Result[None, RegistryError]:
        return self._put(self._arrays, key, value, "array")

    def get_array(self, key: str) -> Result[Array, RegistryError]:
        return self._get(self._arrays, key, "array")

    def replace_array(self, key: str, value: Array) -> None:
        self._arrays[key] = value

    # -- blobs ----------------------------------------------------------------

    def put_blob(self, key: str, value: bytes) -> Result[None, RegistryError]:
        return self._put(self._blobs, key, value, "blob")

    def get_blob(self, key: str) -> Result[bytes, RegistryError]:
        return self._get(self._blobs, key, "blob")

    # -- metadata with set/add/increment (reference update_metadata) -----------

    def get_metadata(self, key: str) -> Result[MetadataValue, RegistryError]:
        return self._get(self._metadata, key, "metadata")

    def update_metadata(
        self, key: str, operation: str, value: MetadataValue
    ) -> Result[MetadataValue, RegistryError]:
        if operation == "set":
            self._metadata[key] = value
            return Success(value)
        current = self._metadata.get(key, 0)
        if operation == "increment":
            if not isinstance(current, (int, float)):
                return Failure(RegistryError(key=key, reason="increment on non-numeric"))
            self._metadata[key] = current + 1
            return Success(self._metadata[key])
        if operation == "add":
            if not isinstance(current, (int, float)) or not isinstance(value, (int, float)):
                return Failure(RegistryError(key=key, reason="add on non-numeric"))
            self._metadata[key] = current + value
            return Success(self._metadata[key])
        return Failure(RegistryError(key=key, reason=f"unknown operation {operation!r}"))

    # -- models / optimizers / functions ----------------------------------------

    def put_model(self, key: str, value: object) -> Result[None, RegistryError]:
        return self._put(self._models, key, value, "model")

    def get_model(self, key: str) -> Result[object, RegistryError]:
        return self._get(self._models, key, "model")

    def put_optimizer(self, key: str, value: object) -> Result[None, RegistryError]:
        return self._put(self._optimizers, key, value, "optimizer")

    def get_optimizer(self, key: str) -> Result[object, RegistryError]:
        return self._get(self._optimizers, key, "optimizer")

    def put_function(self, key: str, value: Callable[..., object]) -> Result[None, RegistryError]:
        return self._put(self._functions, key, value, "function")

    def get_function(self, key: str) -> Result[Callable[..., object], RegistryError]:
        return self._get(self._functions, key, "function")

    # -- snapshot / clear --------------------------------------------------------

    def freeze_snapshot(self) -> FrozenRegistrySnapshot:
        return FrozenRegistrySnapshot(
            arrays=MappingProxyType(dict(self._arrays)),
            blobs=MappingProxyType(dict(self._blobs)),
            metadata=MappingProxyType(dict(self._metadata)),
            models=MappingProxyType(dict(self._models)),
            optimizers=MappingProxyType(dict(self._optimizers)),
            functions=MappingProxyType(dict(self._functions)),
        )

    def clear_arrays(self) -> None:
        self._arrays.clear()

    def clear_blobs(self) -> None:
        self._blobs.clear()

    def clear_metadata(self) -> None:
        self._metadata.clear()
