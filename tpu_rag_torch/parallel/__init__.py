from tpu_rag_torch.parallel.mesh import Mesh, mesh_from_spec
from tpu_rag_torch.parallel.sharded import ShardedFlatIndex, ShardedIVFIndex

__all__ = ["Mesh", "mesh_from_spec", "ShardedFlatIndex", "ShardedIVFIndex"]
