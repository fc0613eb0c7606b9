"""The checkpoint wire format's schemas: the JAX package's five, with the
same messages and field numbers, in the proto package
``spectralmc_tpu_torch``, plus ``TorchEnvProto`` and
``ModelCheckpointProto`` fields 13 (``cuda_stream_version``) and 14
(``torch_env``).

The generated ``*_pb2`` modules are committed; regenerate them with
``python -m spectralmc_tpu_torch.proto.regen``.
"""

from spectralmc_tpu_torch.proto import (
    common_pb2,
    models_pb2,
    simulation_pb2,
    tensors_pb2,
    training_pb2,
)

__all__ = ["common_pb2", "models_pb2", "simulation_pb2", "tensors_pb2", "training_pb2"]
