"""parallel: the dense engine on an x-slab mesh (libcloudphxx_tpu/parallel:
decomp's slab decomposition and dense_mesh).

One process holds a list of shards, each on a torch device of its own (by
default all on one); the ring exchange of the reference's MPI / multi-GPU
layer (SURVEY section 2.3) is a copy between the shards' devices.  The
flat multi-device front (multi.particles_multi_t) and decomp's flat
pieces are not ported (ROADMAP.md, Queue 1, "Multi-device").
"""

from .decomp import (ShardDomain, local_config, make_mesh, shard_domains,
                     slab_widths)
from .dense_mesh import (MeshRunner, dense_step_sharded, gather_dense,
                         gather_state, pad_cell_field, rebin_sharded,
                         scatter_dense, unpad_cell_field)

__all__ = [
    "MeshRunner",
    "ShardDomain",
    "dense_step_sharded",
    "gather_dense",
    "gather_state",
    "local_config",
    "make_mesh",
    "pad_cell_field",
    "rebin_sharded",
    "scatter_dense",
    "shard_domains",
    "slab_widths",
    "unpad_cell_field",
]
