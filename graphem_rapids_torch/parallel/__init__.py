"""The sharded multi-card tier over ``torch.distributed``.

Counterpart of ``graphem_rapids_tpu/parallel``: the graph is edge-partitioned
across the ranks of a process group (one rank per card); spring forces are
gathered per vertex shard and assembled with an all_gather, and the kNN
reference tiles are sharded, with the global neighbor set merged by an
all_gather, an all_to_all, a ring of point-to-point rotations, or the
bin-fold ring whose per-hop fold is the CUDA kernel K3.
"""

from .mesh import (
    EDGE_AXIS,
    Mesh,
    default_mesh,
    distributed_init,
    make_mesh,
    mesh_is_multiprocess,
    replicate_to_mesh,
)
from .sharded_embedder import ShardedGraphEmbedder, ShardedGraphEmbedderTorch
from .sharded_step import build_sharded_step

__all__ = [
    "EDGE_AXIS",
    "Mesh",
    "default_mesh",
    "distributed_init",
    "make_mesh",
    "mesh_is_multiprocess",
    "replicate_to_mesh",
    "ShardedGraphEmbedder",
    "ShardedGraphEmbedderTorch",
    "build_sharded_step",
]
