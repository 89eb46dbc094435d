"""parallel: the x-slab decomposition (libcloudphxx_tpu/parallel): the
flat engine's multi-device front (multi.particles_multi_t, the factory's
pick for dev_count > 1) over decomp's slabs, courant halos and ring
migration, and the dense engine on an x-slab mesh (dense_mesh).

One process holds a list of shards, each on a torch device of its own (by
default all on one); the ring exchange of the reference's MPI / multi-GPU
layer (SURVEY section 2.3) is a copy between the shards' devices.
"""

from .decomp import (MIGRATING_ATTRS, ShardDomain, build_multichip_step,
                     device_put_domains, local_config, make_mesh, migrate,
                     replicate_state_for_mesh, shard_domains,
                     sharded_async_step, sharded_sync_step, slab_widths,
                     xchng_courants)
from .dense_mesh import (MeshRunner, dense_step_sharded, gather_dense,
                         gather_state, pad_cell_field, rebin_sharded,
                         scatter_dense, unpad_cell_field)
from .multi import MeshSrcEngine, particles_multi_t

__all__ = [
    "MIGRATING_ATTRS",
    "MeshRunner",
    "MeshSrcEngine",
    "ShardDomain",
    "build_multichip_step",
    "dense_step_sharded",
    "device_put_domains",
    "gather_dense",
    "gather_state",
    "local_config",
    "make_mesh",
    "migrate",
    "pad_cell_field",
    "particles_multi_t",
    "rebin_sharded",
    "replicate_state_for_mesh",
    "scatter_dense",
    "shard_domains",
    "sharded_async_step",
    "sharded_sync_step",
    "slab_widths",
    "unpad_cell_field",
    "xchng_courants",
]
