"""Checkpoint provenance: which package, library and device wrote the bytes.

A checkpoint the JAX package wrote carries ``JaxEnvProto`` (field 8); one the
port wrote carries ``TorchEnvProto`` (field 14). The port never re-stamps a
record: a config decoded from bytes keeps the records those bytes held, and
encoding it writes them back unchanged, so a JAX checkpoint re-encodes in
the port to its own bytes. A snapshot taken by the port's trainer carries a
fresh ``TorchEnv`` and no ``JaxEnv``.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass

import torch


@dataclass(frozen=True, slots=True)
class JaxEnv:
    """``JaxEnvProto``: the environment of a JAX-package writer."""

    jax_version: str = ""
    backend: str = ""
    device_kind: str = ""
    python_version: str = ""


@dataclass(frozen=True, slots=True)
class TorchEnv:
    """``TorchEnvProto``: the environment of a port writer."""

    torch_version: str = ""
    cuda_version: str = ""
    device_kind: str = ""
    python_version: str = ""


@dataclass(frozen=True, slots=True)
class Provenance:
    """The environment records a checkpoint carries; ``None`` = absent."""

    jax_env: JaxEnv | None = None
    torch_env: TorchEnv | None = None


def torch_env_snapshot(device: torch.device | str) -> TorchEnv:
    """The record for a checkpoint written from a pricer on ``device``."""
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return TorchEnv(
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda or "",
        device_kind=kind,
        python_version=platform.python_version(),
    )
