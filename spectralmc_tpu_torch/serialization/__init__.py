"""The checkpoint wire format: configs, tensors and Adam state <-> protobuf.

The JAX package's ``serialization`` names, on the port's types and its own
schemas (``spectralmc_tpu_torch.proto``): the same values give the same
bytes and the same sha256 in both packages. ``torch_env_snapshot`` takes the
place of ``jax_env_snapshot``; provenance passes through
(``converters`` module docstring).
"""

from spectralmc_tpu_torch.core.provenance import torch_env_snapshot
from spectralmc_tpu_torch.serialization.converters import (
    adam_state_from_proto,
    adam_state_to_proto,
    checkpoint_from_proto,
    checkpoint_to_proto,
    compute_sha256,
    cvnn_config_from_proto,
    cvnn_config_to_proto,
    deserialize_checkpoint,
    serialize_checkpoint,
    sim_params_from_proto,
    sim_params_to_proto,
    tensor_from_proto,
    tensor_map_from_proto,
    tensor_map_to_proto,
    tensor_to_proto,
    training_config_from_proto,
    training_config_to_proto,
    verify_checksum,
)

__all__ = [
    "adam_state_from_proto",
    "adam_state_to_proto",
    "checkpoint_from_proto",
    "checkpoint_to_proto",
    "compute_sha256",
    "cvnn_config_from_proto",
    "cvnn_config_to_proto",
    "deserialize_checkpoint",
    "serialize_checkpoint",
    "sim_params_from_proto",
    "sim_params_to_proto",
    "tensor_from_proto",
    "tensor_map_from_proto",
    "tensor_map_to_proto",
    "tensor_to_proto",
    "torch_env_snapshot",
    "training_config_from_proto",
    "training_config_to_proto",
    "verify_checksum",
]
