# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spectralmc_tpu_torch/proto/simulation.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from spectralmc_tpu_torch.proto import common_pb2 as spectralmc__tpu__torch_dot_proto_dot_common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n+spectralmc_tpu_torch/proto/simulation.proto\x12\x14spectralmc_tpu_torch\x1a\'spectralmc_tpu_torch/proto/common.proto\"{\n\x0f\x42\x61sketSpecProto\x12\x0f\n\x07weights\x18\x01 \x03(\x01\x12\x18\n\x10spot_multipliers\x18\x02 \x03(\x01\x12\x17\n\x0fvol_multipliers\x18\x03 \x03(\x01\x12\x13\n\x0b\x63orrelation\x18\x04 \x03(\x01\x12\x0f\n\x07\x63ombine\x18\x05 \x01(\t\"N\n\x12TermStructureProto\x12\x11\n\tvol_shape\x18\x01 \x03(\x01\x12\x12\n\nrate_shape\x18\x02 \x03(\x01\x12\x11\n\tdiv_shape\x18\x03 \x03(\x01\"\x92\x06\n\x15SimulationParamsProto\x12\x11\n\ttimesteps\x18\x01 \x01(\r\x12\x14\n\x0cnetwork_size\x18\x02 \x01(\r\x12\x1a\n\x12\x62\x61tches_per_mc_run\x18\x03 \x01(\r\x12\x0f\n\x07mc_seed\x18\x04 \x01(\x04\x12\x0c\n\x04skip\x18\x05 \x01(\x04\x12\x37\n\tprecision\x18\x06 \x01(\x0e\x32$.spectralmc_tpu_torch.PrecisionProto\x12\x35\n\x06scheme\x18\x07 \x01(\x0e\x32%.spectralmc_tpu_torch.PathSchemeProto\x12\x46\n\rnormalization\x18\x08 \x01(\x0e\x32/.spectralmc_tpu_torch.ForwardNormalizationProto\x12\x16\n\x0eimplementation\x18\t \x01(\t\x12\x0e\n\x06payoff\x18\n \x01(\t\x12\r\n\x05model\x18\x0b \x01(\t\x12\x35\n\x06\x62\x61sket\x18\x0c \x01(\x0b\x32%.spectralmc_tpu_torch.BasketSpecProto\x12\x13\n\x0b\x62\x61rrier_rel\x18\r \x01(\x01\x12\x12\n\nantithetic\x18\x0e \x01(\x08\x12\x19\n\x11lsmc_basis_degree\x18\x0f \x01(\r\x12\x1b\n\x13lsmc_exercise_every\x18\x10 \x01(\r\x12\x10\n\x08sampling\x18\x11 \x01(\t\x12\x36\n\x04term\x18\x12 \x01(\x0b\x32(.spectralmc_tpu_torch.TermStructureProto\x12\x1a\n\x12\x66orward_start_step\x18\x13 \x01(\r\x12\x1b\n\x13\x63liquet_reset_every\x18\x14 \x01(\r\x12\x1a\n\rcliquet_floor\x18\x15 \x01(\x01H\x00\x88\x01\x01\x12\x18\n\x0b\x63liquet_cap\x18\x16 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0elsmc_cross_fit\x18\x17 \x01(\x08\x12\x1b\n\x13lsmc_fused_backward\x18\x18 \x01(\x08\x42\x10\n\x0e_cliquet_floorB\x0e\n\x0c_cliquet_cap\"m\n\rContractProto\x12\x0c\n\x04spot\x18\x01 \x01(\x01\x12\x0e\n\x06strike\x18\x02 \x01(\x01\x12\x10\n\x08maturity\x18\x03 \x01(\x01\x12\x0c\n\x04rate\x18\x04 \x01(\x01\x12\x11\n\tdiv_yield\x18\x05 \x01(\x01\x12\x0b\n\x03vol\x18\x06 \x01(\x01\".\n\x0e\x42oundSpecProto\x12\r\n\x05lower\x18\x01 \x01(\x01\x12\r\n\x05upper\x18\x02 \x01(\x01\"@\n\x10SobolConfigProto\x12\x0c\n\x04seed\x18\x01 \x01(\x04\x12\x0c\n\x04skip\x18\x02 \x01(\x04\x12\x10\n\x08scramble\x18\x03 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spectralmc_tpu_torch.proto.simulation_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BASKETSPECPROTO._serialized_start=110
  _BASKETSPECPROTO._serialized_end=233
  _TERMSTRUCTUREPROTO._serialized_start=235
  _TERMSTRUCTUREPROTO._serialized_end=313
  _SIMULATIONPARAMSPROTO._serialized_start=316
  _SIMULATIONPARAMSPROTO._serialized_end=1102
  _CONTRACTPROTO._serialized_start=1104
  _CONTRACTPROTO._serialized_end=1213
  _BOUNDSPECPROTO._serialized_start=1215
  _BOUNDSPECPROTO._serialized_end=1261
  _SOBOLCONFIGPROTO._serialized_start=1263
  _SOBOLCONFIGPROTO._serialized_end=1327
# @@protoc_insertion_point(module_scope)
