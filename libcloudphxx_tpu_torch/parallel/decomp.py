"""The x-slab decomposition of the dense mesh (libcloudphxx_tpu/parallel/
decomp.py: slab_widths, local_config, ShardDomain, shard_domains,
make_mesh).

The JAX package runs the mesh as one shard_map program over a
jax.sharding.Mesh axis "x".  The port runs it in one process that holds a
list of shards, each on a torch device of its own (by default all on the
one device the caller names), and moves the ring's payloads as copies
between those devices (parallel/dense_mesh.py).  Slabs may be uneven, as
the reference's distmem_opts.hpp makes them: every shard is padded to the
widest, and its ShardDomain says which columns are its own.
"""

import dataclasses

import torch

from ..lgrngn.state import StaticConfig


def slab_widths(nx: int, n_shards: int):
    """Cells a slab, the remainder spread from the left (reference
    src/detail/distmem_opts.hpp)."""
    base, rem = divmod(nx, n_shards)
    return [base + (1 if s < rem else 0) for s in range(n_shards)]


def local_config(cfg: StaticConfig, n_shards: int) -> StaticConfig:
    """A shard's static config (decomp.py:76-93): the padded slab, x from
    0, n_sd_max split evenly.  The port keeps x global on every shard, so
    its mesh reads only the grid of this config (nx, n_cell: the rows the
    shard's re-binning sorts into, parallel/dense_mesh.rebin_sharded)."""
    if cfg.n_sd_max % n_shards != 0:
        raise ValueError("lgrngn: n_sd_max must divide by the shard count")
    nx_pad = max(slab_widths(cfg.nx, n_shards))
    return dataclasses.replace(
        cfg, nx=nx_pad, n_cell=nx_pad * max(1, cfg.ny) * max(1, cfg.nz),
        n_sd_max=cfg.n_sd_max // n_shards, x0=0.0, x1=nx_pad * cfg.dx)


@dataclasses.dataclass(frozen=True)
class ShardDomain:
    """One shard of the x-slab mesh: its columns col0 .. col0 + nxl - 1 of
    the global grid (the JAX package's ShardDomain holds nxl and the
    slab-local bounds of the Lagrangian domain, which the port, keeping x
    global, does not need), and the device that holds it."""
    col0: int
    nxl: int
    device: torch.device


def make_mesh(n_shards: int, device="cuda"):
    """The shards' devices (the counterpart of decomp.make_mesh,
    decomp.py:454-458): every shard on ``device``, or, for a sequence of
    devices, the shards spread over them in contiguous blocks."""
    if n_shards < 1:
        raise ValueError(f"make_mesh: n_shards must be >= 1, got {n_shards}")
    if isinstance(device, (str, torch.device)):
        return [torch.device(device)] * n_shards
    devs = [torch.device(d) for d in device]
    return [devs[s * len(devs) // n_shards] for s in range(n_shards)]


def shard_domains(cfg: StaticConfig, devices):
    """A ShardDomain a device of ``devices`` (make_mesh), the slabs
    slab_widths wide."""
    n_shards = len(devices)
    if n_shards > cfg.nx:
        raise ValueError(f"shard_domains: {n_shards} slabs of at least one "
                         f"column cannot cover nx = {cfg.nx}")
    doms, col0 = [], 0
    for w, dev in zip(slab_widths(cfg.nx, n_shards), devices):
        doms.append(ShardDomain(col0=col0, nxl=w, device=torch.device(dev)))
        col0 += w
    return doms
