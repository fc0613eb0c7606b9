# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spectralmc_tpu_torch/proto/models.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from spectralmc_tpu_torch.proto import common_pb2 as spectralmc__tpu__torch_dot_proto_dot_common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\'spectralmc_tpu_torch/proto/models.proto\x12\x14spectralmc_tpu_torch\x1a\'spectralmc_tpu_torch/proto/common.proto\"{\n\x0eLinearCfgProto\x12\x11\n\thas_width\x18\x01 \x01(\x08\x12\r\n\x05width\x18\x02 \x01(\r\x12\x0c\n\x04\x62ias\x18\x03 \x01(\x08\x12\x39\n\nactivation\x18\x04 \x01(\x0e\x32%.spectralmc_tpu_torch.ActivationProto\"\x11\n\x0fNaiveBNCfgProto\"\x0f\n\rCovBNCfgProto\"I\n\x12SequentialCfgProto\x12\x33\n\x06layers\x18\x01 \x03(\x0b\x32#.spectralmc_tpu_torch.LayerCfgProto\"\x80\x01\n\x10ResidualCfgProto\x12\x31\n\x04\x62ody\x18\x01 \x01(\x0b\x32#.spectralmc_tpu_torch.LayerCfgProto\x12\x39\n\nactivation\x18\x02 \x01(\x0e\x32%.spectralmc_tpu_torch.ActivationProto\"\xbd\x02\n\rLayerCfgProto\x12\x36\n\x06linear\x18\x01 \x01(\x0b\x32$.spectralmc_tpu_torch.LinearCfgProtoH\x00\x12\x39\n\x08naive_bn\x18\x02 \x01(\x0b\x32%.spectralmc_tpu_torch.NaiveBNCfgProtoH\x00\x12\x35\n\x06\x63ov_bn\x18\x03 \x01(\x0b\x32#.spectralmc_tpu_torch.CovBNCfgProtoH\x00\x12>\n\nsequential\x18\x04 \x01(\x0b\x32(.spectralmc_tpu_torch.SequentialCfgProtoH\x00\x12:\n\x08residual\x18\x05 \x01(\x0b\x32&.spectralmc_tpu_torch.ResidualCfgProtoH\x00\x42\x06\n\x04kind\"\xce\x01\n\x0f\x43VNNConfigProto\x12\x37\n\tprecision\x18\x01 \x01(\x0e\x32$.spectralmc_tpu_torch.PrecisionProto\x12\x33\n\x06layers\x18\x02 \x03(\x0b\x32#.spectralmc_tpu_torch.LayerCfgProto\x12\x0c\n\x04seed\x18\x03 \x01(\x04\x12?\n\x10\x66inal_activation\x18\x04 \x01(\x0e\x32%.spectralmc_tpu_torch.ActivationProto*p\n\x0f\x41\x63tivationProto\x12\x1a\n\x16\x41\x43TIVATION_UNSPECIFIED\x10\x00\x12\x13\n\x0f\x41\x43TIVATION_NONE\x10\x01\x12\x14\n\x10\x41\x43TIVATION_ZRELU\x10\x02\x12\x16\n\x12\x41\x43TIVATION_MODRELU\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spectralmc_tpu_torch.proto.models_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ACTIVATIONPROTO._serialized_start=1002
  _ACTIVATIONPROTO._serialized_end=1114
  _LINEARCFGPROTO._serialized_start=106
  _LINEARCFGPROTO._serialized_end=229
  _NAIVEBNCFGPROTO._serialized_start=231
  _NAIVEBNCFGPROTO._serialized_end=248
  _COVBNCFGPROTO._serialized_start=250
  _COVBNCFGPROTO._serialized_end=265
  _SEQUENTIALCFGPROTO._serialized_start=267
  _SEQUENTIALCFGPROTO._serialized_end=340
  _RESIDUALCFGPROTO._serialized_start=343
  _RESIDUALCFGPROTO._serialized_end=471
  _LAYERCFGPROTO._serialized_start=474
  _LAYERCFGPROTO._serialized_end=791
  _CVNNCONFIGPROTO._serialized_start=794
  _CVNNCONFIGPROTO._serialized_end=1000
# @@protoc_insertion_point(module_scope)
