"""Device-mesh parallelism of the port (``zebra_tpu/parallel/``): the sharded
index (one state per mesh device, a partial top-k merge) and the
tensor-parallel embedding towers."""

from zebra_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_axis_size
from zebra_tpu_torch.parallel.sharded import ShardedIndex, ShardedLSHIndex
from zebra_tpu_torch.parallel.towers import make_tower_mesh, shard_tower

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_axis_size",
    "ShardedIndex",
    "ShardedLSHIndex",
    "make_tower_mesh",
    "shard_tower",
]
