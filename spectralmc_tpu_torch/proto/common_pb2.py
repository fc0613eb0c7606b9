# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spectralmc_tpu_torch/proto/common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\'spectralmc_tpu_torch/proto/common.proto\x12\x14spectralmc_tpu_torch\"\x8d\x01\n\x11ModelVersionProto\x12\x0f\n\x07\x63ounter\x18\x01 \x01(\x04\x12\x18\n\x10semantic_version\x18\x02 \x01(\t\x12\x13\n\x0bparent_hash\x18\x03 \x01(\t\x12\x14\n\x0c\x63ontent_hash\x18\x04 \x01(\t\x12\x11\n\ttimestamp\x18\x05 \x01(\t\x12\x0f\n\x07message\x18\x06 \x01(\t\"`\n\x0bJaxEnvProto\x12\x13\n\x0bjax_version\x18\x01 \x01(\t\x12\x0f\n\x07\x62\x61\x63kend\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_kind\x18\x03 \x01(\t\x12\x16\n\x0epython_version\x18\x04 \x01(\t\"i\n\rTorchEnvProto\x12\x15\n\rtorch_version\x18\x01 \x01(\t\x12\x14\n\x0c\x63uda_version\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_kind\x18\x03 \x01(\t\x12\x16\n\x0epython_version\x18\x04 \x01(\t*\x8c\x01\n\x0ePrecisionProto\x12\x19\n\x15PRECISION_UNSPECIFIED\x10\x00\x12\x15\n\x11PRECISION_FLOAT32\x10\x01\x12\x15\n\x11PRECISION_FLOAT64\x10\x02\x12\x17\n\x13PRECISION_COMPLEX64\x10\x03\x12\x18\n\x14PRECISION_COMPLEX128\x10\x04*`\n\x0fPathSchemeProto\x12\x1b\n\x17PATH_SCHEME_UNSPECIFIED\x10\x00\x12\x19\n\x15PATH_SCHEME_LOG_EULER\x10\x01\x12\x15\n\x11PATH_SCHEME_EULER\x10\x02*\x82\x01\n\x19\x46orwardNormalizationProto\x12%\n!FORWARD_NORMALIZATION_UNSPECIFIED\x10\x00\x12\x1e\n\x1a\x46ORWARD_NORMALIZATION_NONE\x10\x01\x12\x1e\n\x1a\x46ORWARD_NORMALIZATION_MEAN\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spectralmc_tpu_torch.proto.common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PRECISIONPROTO._serialized_start=415
  _PRECISIONPROTO._serialized_end=555
  _PATHSCHEMEPROTO._serialized_start=557
  _PATHSCHEMEPROTO._serialized_end=653
  _FORWARDNORMALIZATIONPROTO._serialized_start=656
  _FORWARDNORMALIZATIONPROTO._serialized_end=786
  _MODELVERSIONPROTO._serialized_start=66
  _MODELVERSIONPROTO._serialized_end=207
  _JAXENVPROTO._serialized_start=209
  _JAXENVPROTO._serialized_end=305
  _TORCHENVPROTO._serialized_start=307
  _TORCHENVPROTO._serialized_end=412
# @@protoc_insertion_point(module_scope)
