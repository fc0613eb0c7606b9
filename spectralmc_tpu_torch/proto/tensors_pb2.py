# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spectralmc_tpu_torch/proto/tensors.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from spectralmc_tpu_torch.proto import common_pb2 as spectralmc__tpu__torch_dot_proto_dot_common__pb2
from spectralmc_tpu_torch.proto import simulation_pb2 as spectralmc__tpu__torch_dot_proto_dot_simulation__pb2
from spectralmc_tpu_torch.proto import models_pb2 as spectralmc__tpu__torch_dot_proto_dot_models__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(spectralmc_tpu_torch/proto/tensors.proto\x12\x14spectralmc_tpu_torch\x1a\'spectralmc_tpu_torch/proto/common.proto\x1a+spectralmc_tpu_torch/proto/simulation.proto\x1a\'spectralmc_tpu_torch/proto/models.proto\"9\n\x0bTensorProto\x12\r\n\x05shape\x18\x01 \x03(\x04\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"\xa7\x01\n\x0eTensorMapProto\x12\x42\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x31.spectralmc_tpu_torch.TensorMapProto.EntriesEntry\x1aQ\n\x0c\x45ntriesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x30\n\x05value\x18\x02 \x01(\x0b\x32!.spectralmc_tpu_torch.TensorProto:\x02\x38\x01\"\x9b\x01\n\x0e\x41\x64\x61mStateProto\x12\x16\n\x0eschema_version\x18\x01 \x01(\r\x12\x30\n\x02mu\x18\x02 \x01(\x0b\x32$.spectralmc_tpu_torch.TensorMapProto\x12\x30\n\x02nu\x18\x03 \x01(\x0b\x32$.spectralmc_tpu_torch.TensorMapProto\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\"\xdc\x05\n\x14ModelCheckpointProto\x12\x38\n\x03sim\x18\x01 \x01(\x0b\x32+.spectralmc_tpu_torch.SimulationParamsProto\x12\x46\n\x06\x62ounds\x18\x02 \x03(\x0b\x32\x36.spectralmc_tpu_torch.ModelCheckpointProto.BoundsEntry\x12\x33\n\x04\x63vnn\x18\x03 \x01(\x0b\x32%.spectralmc_tpu_torch.CVNNConfigProto\x12\x13\n\x0bglobal_step\x18\x04 \x01(\x04\x12\x12\n\nsobol_skip\x18\x05 \x01(\x04\x12\x39\n\x0bmodel_state\x18\x06 \x01(\x0b\x32$.spectralmc_tpu_torch.TensorMapProto\x12=\n\x0foptimizer_state\x18\x07 \x01(\x0b\x32$.spectralmc_tpu_torch.TensorMapProto\x12.\n\x03\x65nv\x18\x08 \x01(\x0b\x32!.spectralmc_tpu_torch.JaxEnvProto\x12\x38\n\nadam_state\x18\t \x01(\x0b\x32$.spectralmc_tpu_torch.AdamStateProto\x12\x18\n\x10normalize_inputs\x18\n \x01(\x08\x12\x1d\n\x15pallas_stream_version\x18\x0b \x01(\r\x12\x1d\n\x15lsmc_backward_version\x18\x0c \x01(\r\x12\x1b\n\x13\x63uda_stream_version\x18\r \x01(\r\x12\x36\n\ttorch_env\x18\x0e \x01(\x0b\x32#.spectralmc_tpu_torch.TorchEnvProto\x1aS\n\x0b\x42oundsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x33\n\x05value\x18\x02 \x01(\x0b\x32$.spectralmc_tpu_torch.BoundSpecProto:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spectralmc_tpu_torch.proto.tensors_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSORMAPPROTO_ENTRIESENTRY._options = None
  _TENSORMAPPROTO_ENTRIESENTRY._serialized_options = b'8\001'
  _MODELCHECKPOINTPROTO_BOUNDSENTRY._options = None
  _MODELCHECKPOINTPROTO_BOUNDSENTRY._serialized_options = b'8\001'
  _TENSORPROTO._serialized_start=193
  _TENSORPROTO._serialized_end=250
  _TENSORMAPPROTO._serialized_start=253
  _TENSORMAPPROTO._serialized_end=420
  _TENSORMAPPROTO_ENTRIESENTRY._serialized_start=339
  _TENSORMAPPROTO_ENTRIESENTRY._serialized_end=420
  _ADAMSTATEPROTO._serialized_start=423
  _ADAMSTATEPROTO._serialized_end=578
  _MODELCHECKPOINTPROTO._serialized_start=581
  _MODELCHECKPOINTPROTO._serialized_end=1313
  _MODELCHECKPOINTPROTO_BOUNDSENTRY._serialized_start=1230
  _MODELCHECKPOINTPROTO_BOUNDSENTRY._serialized_end=1313
# @@protoc_insertion_point(module_scope)
