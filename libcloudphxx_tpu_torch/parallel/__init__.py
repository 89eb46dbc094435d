"""parallel: the x-slab decomposition (libcloudphxx_tpu/parallel): the
flat engine's multi-device front (multi.particles_multi_t, the factory's
pick for dev_count > 1) over decomp's slabs, courant halos and ring
migration, and the dense engine on an x-slab mesh (dense_mesh).

One process holds a list of shards, each on a torch device of its own (by
default all on one); the ring exchange of the reference's MPI / multi-GPU
layer (SURVEY section 2.3) is a copy between the shards' devices.  With a
torch.distributed process group (gloo) the shards are spread over the
group's processes, and the ring's payloads between them are messages
(decomp.ring_exchange); twoproc runs both fronts so in two processes
(the counterpart of tools/dryrun_2proc.py).
"""

from .decomp import (MIGRATING_ATTRS, NCCL_REFUSAL, ShardDomain,
                     build_multichip_step, device_put_domains, group_sum,
                     local_config, local_domains, make_mesh, migrate,
                     owned_shards, replicate_state_for_mesh, ring_exchange,
                     shard_domains, sharded_async_step, sharded_sync_step,
                     slab_widths, xchng_courants)
from .dense_mesh import (MeshRunner, dense_step_sharded, gather_dense,
                         gather_state, pad_cell_field, rebin_sharded,
                         scatter_dense, unpad_cell_field)
from .multi import MeshSrcEngine, particles_multi_t

__all__ = [
    "MIGRATING_ATTRS",
    "MeshRunner",
    "MeshSrcEngine",
    "NCCL_REFUSAL",
    "ShardDomain",
    "build_multichip_step",
    "dense_step_sharded",
    "device_put_domains",
    "gather_dense",
    "gather_state",
    "group_sum",
    "local_config",
    "local_domains",
    "make_mesh",
    "migrate",
    "owned_shards",
    "pad_cell_field",
    "particles_multi_t",
    "rebin_sharded",
    "replicate_state_for_mesh",
    "ring_exchange",
    "scatter_dense",
    "shard_domains",
    "sharded_async_step",
    "sharded_sync_step",
    "slab_widths",
    "unpad_cell_field",
    "xchng_courants",
]
