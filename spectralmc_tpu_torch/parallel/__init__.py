"""Sharded training over ranks: meshes of process groups and the sharded step."""

from spectralmc_tpu_torch.parallel.mesh import MeshSpec, build_mesh_spec
from spectralmc_tpu_torch.parallel.trainer import make_sharded_batch, make_sharded_segment

__all__ = ["MeshSpec", "build_mesh_spec", "make_sharded_batch", "make_sharded_segment"]
