# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spectralmc_tpu_torch/proto/training.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)spectralmc_tpu_torch/proto/training.proto\x12\x14spectralmc_tpu_torch\"\xa9\x01\n\x13TrainingConfigProto\x12\x13\n\x0bnum_batches\x18\x01 \x01(\r\x12\x12\n\nbatch_size\x18\x02 \x01(\r\x12\x15\n\rlearning_rate\x18\x03 \x01(\x01\x12\x16\n\x0e\x63ontract_chunk\x18\x04 \x01(\r\x12:\n\x0blr_schedule\x18\x05 \x01(\x0b\x32%.spectralmc_tpu_torch.LRScheduleProto\"]\n\x0fLRScheduleProto\x12\x0c\n\x04peak\x18\x01 \x01(\x01\x12\x13\n\x0b\x64\x65\x63\x61y_steps\x18\x02 \x01(\r\x12\x14\n\x0cwarmup_steps\x18\x03 \x01(\r\x12\x11\n\tend_value\x18\x04 \x01(\x01\"l\n\x10StepMetricsProto\x12\x0c\n\x04step\x18\x01 \x01(\x04\x12\x0c\n\x04loss\x18\x02 \x01(\x01\x12\x11\n\tgrad_norm\x18\x03 \x01(\x01\x12\x15\n\rlearning_rate\x18\x04 \x01(\x01\x12\x12\n\nbatch_time\x18\x05 \x01(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spectralmc_tpu_torch.proto.training_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRAININGCONFIGPROTO._serialized_start=68
  _TRAININGCONFIGPROTO._serialized_end=237
  _LRSCHEDULEPROTO._serialized_start=239
  _LRSCHEDULEPROTO._serialized_end=332
  _STEPMETRICSPROTO._serialized_start=334
  _STEPMETRICSPROTO._serialized_end=442
# @@protoc_insertion_point(module_scope)
