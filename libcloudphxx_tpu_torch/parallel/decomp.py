"""The x-slab decomposition (libcloudphxx_tpu/parallel/decomp.py): the
slab geometry of the dense mesh and of the flat multi-device front, and
the flat front's per-shard steps (courant halos, the halo-2 courant
exchange of pred_corr advection, the ring migration of SDs).

The JAX package runs a mesh as one shard_map program over a
jax.sharding.Mesh axis "x".  The port runs it in one process that holds a
list of shards, each on a torch device of its own (by default all on the
one device the caller names), and moves the ring's payloads as copies
between those devices.  Slabs may be uneven, as the reference's
distmem_opts.hpp makes them: every shard is padded to the widest, and its
ShardDomain says which columns are its own.

The layer also runs as one program in several processes (the JAX
package's multi-controller run, tools/dryrun_2proc.py): given a
torch.distributed process group of P ranks, rank r holds the contiguous
shards [r S / P, (r + 1) S / P) of the S (owned_shards), every rank builds
the same global host values and keeps its own slabs, and the ring's
payloads cross a process boundary as point-to-point messages
(ring_exchange); the sums over all shards are all-reduces (group_sum).
The functions take ``doms``, every shard's ShardDomain (the global
geometry, the same in every process), and ``shards``, the States of the
shards this process owns, in order; ``group`` None is one process that
owns them all.

The flat front keeps the JAX package's slab-local coordinates: a shard is
a flat-engine State of local_config's padded slab, x from 0, so that the
flat engine's transport, cells and walls run on it unchanged; a migrating
SD's x is re-based on the ring (the reference's rmt + x - lcl rule,
pack.ipp:14-27).  The dense mesh (parallel/dense_mesh.py) keeps x global.
"""

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..lgrngn import chemistry, hskpng, transport
from ..lgrngn.enums import as_t
from ..lgrngn.particles import step_async_body, step_cond_body
from ..lgrngn.source import MIGRATING_ATTRS, migrating_attrs
from ..lgrngn.state import OUT_MIGRATION_OVERFLOW, State, StaticConfig
from ..ops.philox import shard_key


def slab_widths(nx: int, n_shards: int):
    """Cells a slab, the remainder spread from the left (reference
    src/detail/distmem_opts.hpp)."""
    base, rem = divmod(nx, n_shards)
    return [base + (1 if s < rem else 0) for s in range(n_shards)]


def local_config(cfg: StaticConfig, n_shards: int,
                 widths=None) -> StaticConfig:
    """A shard's static config (decomp.py:76-93): the padded slab in local
    coordinates, x from 0, n_sd_max split evenly.  The dense mesh reads
    only its grid (nx, n_cell: the rows the shard's re-binning sorts into,
    parallel/dense_mesh.rebin_sharded); the flat front runs on it."""
    if cfg.n_sd_max % n_shards != 0:
        raise ValueError("lgrngn: n_sd_max must divide by the shard count")
    nx_pad = max(widths or slab_widths(cfg.nx, n_shards))
    return dataclasses.replace(
        cfg, nx=nx_pad, n_cell=nx_pad * cfg.ny * cfg.nz,
        n_sd_max=cfg.n_sd_max // n_shards, x0=0.0, x1=nx_pad * cfg.dx)


@dataclasses.dataclass(frozen=True)
class ShardDomain:
    """One shard of an x-slab mesh: its columns col0 .. col0 + nxl - 1 of
    the global grid, the device that holds it, and its Lagrangian domain
    [lo, hi) in slab-local x (the JAX package's ShardDomain, decomp.py:
    65-77: the global crop x0 > 0 or x1 < nx*dx on the end slabs).  The
    dense mesh, which keeps x global, reads col0 and nxl alone."""
    col0: int
    nxl: int
    device: torch.device
    lo: float
    hi: float


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


def shard_domains(cfg: StaticConfig, devices, widths=None):
    """A ShardDomain a device of ``devices`` (make_mesh), the slabs
    ``widths`` (slab_widths by default) wide (decomp.py:105-112)."""
    n_shards = len(devices)
    if n_shards > cfg.nx:
        raise ValueError(f"shard_domains: {n_shards} slabs of at least one "
                         f"column cannot cover nx = {cfg.nx}")
    doms, col0 = [], 0
    for w, dev in zip(widths or slab_widths(cfg.nx, n_shards), devices):
        doms.append(ShardDomain(
            col0=col0, nxl=w, device=torch.device(dev),
            lo=max(0.0, cfg.x0 - col0 * cfg.dx),
            hi=min(w * cfg.dx, cfg.x1 - col0 * cfg.dx)))
        col0 += w
    return doms


def device_put_domains(cfg: StaticConfig, devices, widths=None):
    """The counterpart of decomp.device_put_domains (decomp.py:558): the
    domains already name their devices, so it is shard_domains."""
    return shard_domains(cfg, devices, widths)


def on_device(device):
    """The context that makes ``device`` current where it is a card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------- the ring
NCCL_REFUSAL = (
    "the multi-device layer's process ring runs over gloo only: NCCL "
    "rejects two ranks on one device, and no machine with two cards has "
    "run it (ROADMAP.md, Queue 1, \"NCCL, one process a card: waits for a "
    "machine with two cards\")")

# the tags of the two directions of a ring exchange (with two processes
# each rank's left and right neighbour is the same rank)
_LEFTWARD, _RIGHTWARD = 0, 1


def rank_and_size(group):
    """(rank, size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def owned_shards(n_shards: int, group=None) -> range:
    """The global indices of the shards this process holds: all of them
    without a process group; in a group of P processes, rank r's
    contiguous block [r S / P, (r + 1) S / P), as the JAX package's global
    mesh puts process 0's devices first.  Refuses an NCCL group and a
    shard count that does not split evenly."""
    if group is None:
        return range(n_shards)
    if str(dist.get_backend(group)) == "nccl":
        raise NotImplementedError(NCCL_REFUSAL)
    rank, size = rank_and_size(group)
    if n_shards % size:
        raise ValueError(
            f"multi-device layer: {n_shards} shards do not split evenly "
            f"over {size} processes")
    per = n_shards // size
    return range(rank * per, (rank + 1) * per)


def local_domains(doms, group=None):
    """The ShardDomains of the shards this process owns (owned_shards)."""
    return [doms[s] for s in owned_shards(len(doms), group)]


def _to_bytes(tensors):
    """A payload (a list of tensors on one device) as one uint8 tensor on
    the host: gloo's point-to-point ops take CPU tensors (on a CUDA tensor
    its TCP transport fails, "writev ...: Bad address", PyTorch 2.11 with
    CUDA 12.8 on an H100), so a payload of a card is staged through the
    host here."""
    if not tensors:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu()


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _from_bytes(buf, like, device):
    """The inverse of _to_bytes: tensors shaped as ``like``'s, on
    ``device``."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        # the clone starts a storage of its own, aligned for any dtype
        out.append(buf[at:at + n].clone().view(t.dtype).reshape(t.shape)
                   .to(device))
        at += n
    return out


def ring_exchange(to_left, to_right, doms, group=None):
    """One exchange around the ring of shards, the one step every
    cross-shard operation takes (the reference's MPI exchange,
    mpi_exchange.ipp:20-331).  ``doms`` are this process's shards'
    ShardDomains, in ring order; ``to_left[i]`` and ``to_right[i]`` the
    lists of tensors its shard i sends to the left and to the right
    neighbour.  Returns (from_left, from_right): what each shard gets
    from the left neighbour (its to_right) and from the right one (its
    to_left), on the shard's device.

    Between the shards of one process a payload is a copy to the
    receiver's device.  Across a process boundary (a ``group`` of more
    than one process: the first shard's left and the last shard's right
    neighbour live on the ranks before and after this one) it is one
    message a direction, sent and received in one dist.batch_isend_irecv,
    so that no order of blocking sends can deadlock; gloo takes host
    tensors, so the message is staged through the host (_to_bytes).
    Every shard's payloads must have the same shapes: a receiver sizes
    what comes in by what it sends the other way."""
    n = len(doms)
    rank, size = rank_and_size(group)
    ring = size == 1
    from_left, from_right = [None] * n, [None] * n
    for i, dom in enumerate(doms):
        if i > 0 or ring:
            from_left[i] = [t.to(dom.device) for t in to_right[(i - 1) % n]]
        if i < n - 1 or ring:
            from_right[i] = [t.to(dom.device) for t in to_left[(i + 1) % n]]
    if ring:
        return from_left, from_right
    if str(dist.get_backend(group)) == "nccl":
        raise NotImplementedError(NCCL_REFUSAL)
    peer = lambda r: dist.get_global_rank(group, r % size)
    left, right = peer(rank - 1), peer(rank + 1)
    send_l, send_r = _to_bytes(to_left[0]), _to_bytes(to_right[-1])
    recv_l = torch.empty(_nbytes(to_right[-1]), dtype=torch.uint8)
    recv_r = torch.empty(_nbytes(to_left[0]), dtype=torch.uint8)
    ops = []
    if send_l.numel():
        ops += [dist.P2POp(dist.isend, send_l, left, group, _LEFTWARD),
                dist.P2POp(dist.irecv, recv_r, right, group, _LEFTWARD)]
    if send_r.numel():
        ops += [dist.P2POp(dist.isend, send_r, right, group, _RIGHTWARD),
                dist.P2POp(dist.irecv, recv_l, left, group, _RIGHTWARD)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    from_left[0] = _from_bytes(recv_l, to_right[-1], doms[0].device)
    from_right[-1] = _from_bytes(recv_r, to_left[0], doms[-1].device)
    return from_left, from_right


def group_sum(t, group=None):
    """``t`` summed over the processes of ``group`` (an all-reduce, staged
    through the host as ring_exchange's messages are); ``t`` itself
    without one."""
    if rank_and_size(group)[1] == 1:
        return t
    host = t.detach().to("cpu", copy=True)
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    return host.to(t.device)


def pad_cell_field(cfg, arr, doms, nx_pad=None):
    """A global cell field (..., n_cell) -> a padded slab a shard of
    ``doms``, on the shard's device; padded columns copy the slab's last
    live column (a safe, finite value, multi.py:89-98).  ``nx_pad`` is
    the padded width, the widest of ``doms`` by default (give it where
    ``doms`` are some of the shards)."""
    lead, nyz = arr.shape[:-1], cfg.ny * cfg.nz
    g = arr.reshape(*lead, cfg.nx, nyz)
    cols = torch.arange(nx_pad or max(dom.nxl for dom in doms),
                        device=arr.device)
    return [g[..., torch.clamp(cols + dom.col0, max=dom.col0 + dom.nxl - 1),
              :].reshape(*lead, -1).to(dom.device) for dom in doms]


def unpad_cell_field(cfg, fields, doms):
    """The inverse of pad_cell_field: a global (..., n_cell) field on the
    first shard's device."""
    dev, nyz = fields[0].device, cfg.ny * cfg.nz
    lead = fields[0].shape[:-1]
    return torch.cat([f.reshape(*lead, -1, nyz)[..., :dom.nxl, :].to(dev)
                      for f, dom in zip(fields, doms)],
                     dim=-2).reshape(*lead, -1)


def pad_courants(cfg, cx, cy, cz, doms, nx_pad=None):
    """The global staggered courants -> each shard's (courant_x,
    courant_y, courant_z) (multi.py:107-136): the slab's x faces and the
    one after its last live column (the right halo face, which
    xchng_courants refreshes from the neighbour), its columns' y and z
    faces; zero past them.  ``nx_pad`` as pad_cell_field's."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    nx_pad = nx_pad or max(dom.nxl for dom in doms)
    out = []
    for dom in doms:
        c0, w = dom.col0, dom.nxl

        def cut(a, planes, extra):
            if a.numel() == 0:
                return a.to(dom.device)
            g = a.reshape(planes, -1)
            o = g.new_zeros((nx_pad + extra, g.shape[1]))
            o[:w + extra] = g[c0:c0 + w + extra]
            return o.reshape(-1).to(dom.device)

        out.append((cut(cx, nx + 1, 1), cut(cy, nx, 0), cut(cz, nx, 0)))
    return out


def unpad_courants(cfg, shards, doms):
    """The inverse of pad_courants: the global (courant_x, courant_y,
    courant_z) on the first shard's device, the last x face from the last
    shard's halo."""
    dev = shards[0].n.device
    nx_pad = max(dom.nxl for dom in doms)

    def cat(name, extra):
        parts = [getattr(s, name) for s in shards]
        if parts[0].numel() == 0:
            return parts[0]
        g = [p.reshape(nx_pad + extra, -1).to(dev) for p in parts]
        rows = [a[:dom.nxl] for a, dom in zip(g, doms)]
        if extra:
            rows.append(g[-1][doms[-1].nxl:doms[-1].nxl + 1])
        return torch.cat(rows).reshape(-1)

    return cat("courant_x", 1), cat("courant_y", 0), cat("courant_z", 0)


def xchng_courants(cfg: StaticConfig, shards, doms, group=None):
    """Refresh each shard's right courant halo from its right neighbour's
    first face (decomp.py:115-136; reference xchng_courants.ipp:207-320
    with halo_size 1, implicit or euler advection).  The halo face sits
    after the slab's live faces; the last shard's comes from the first
    shard's face (the ring is the periodic wrap).  ``cfg`` is the local
    config.  Returns the shards."""
    if cfg.n_dims == 0 or shards[0].courant_x.numel() == 0:
        return shards
    nyz = cfg.ny * cfg.nz
    mine = local_domains(doms, group)
    _, from_right = ring_exchange([[st.courant_x[:nyz]] for st in shards],
                                  [[] for _ in shards], mine, group)
    out = []
    for st, dom, (face,) in zip(shards, mine, from_right):
        cx = st.courant_x.clone()
        cx[dom.nxl * nyz:(dom.nxl + 1) * nyz] = face
        out.append(dataclasses.replace(st, courant_x=cx))
    return out


def xchng_courants_pc(cfg: StaticConfig, shards, doms, group=None):
    """The halo-2 courant exchange of pred_corr advection
    (decomp.py:139-180; reference xchng_courants.ipp:207-320 with
    halo_size 2, particles_impl.ipp:361-371): each shard's courants in a
    layout shifted by 2 x planes, (cx_ext, cy_ext, cz_ext):

      cx_ext: x faces -2 .. nx_pad + 2 ((nx_pad + 5) * ny * nz values),
      cy_ext, cz_ext: x columns -2 .. nx_pad + 1, or None off their grid,

    the two planes before the slab the left neighbour's last two live ones,
    after its live planes the right neighbour's first three (faces) or two
    (columns).  Only planes within [-2, nxl + 2] / [-2, nxl + 1] are
    meaningful.  Every slab must be at least 2 cells wide."""
    ny, nz = cfg.ny, cfg.nz
    mine = local_domains(doms, group)
    # (name, plane stride, planes sent to the left)
    axes = [("courant_x", ny * nz, 3)]
    if cfg.n_dims == 3:
        axes.append(("courant_y", (ny + 1) * nz, 2))
    if cfg.n_dims > 1:
        axes.append(("courant_z", ny * (nz + 1), 2))
    to_left = [[getattr(st, a)[:n * stride] for a, stride, n in axes]
               for st in shards]
    to_right = [[getattr(st, a)[(dom.nxl - 2) * stride:dom.nxl * stride]
                 for a, stride, _ in axes]
                for st, dom in zip(shards, mine)]
    from_left, from_right = ring_exchange(to_left, to_right, mine, group)
    ext = {}
    for k, (name, stride, n_send_r) in enumerate(axes):
        out = []
        for st, dom, fl, fr in zip(shards, mine, from_left, from_right):
            arr = getattr(st, name)
            e = arr.new_zeros((arr.numel() // stride + 2 + n_send_r)
                              * stride)
            e[:2 * stride] = fl[k]
            e[2 * stride:2 * stride + arr.numel()] = arr
            at = (2 + dom.nxl) * stride
            e[at:at + n_send_r * stride] = fr[k]
            out.append(e)
        ext[name] = out
    none = [None] * len(shards)
    return list(zip(ext["courant_x"], ext.get("courant_y", none),
                    ext.get("courant_z", none)))


def adve_pred_corr_sharded(cfg: StaticConfig, state: State, dom: ShardDomain,
                           ext) -> State:
    """Predictor-corrector SD advection on a shard (decomp.py:183-234;
    reference adve.ipp:168-304 with halo_size 2): the explicit-Euler
    predictor with the slab's courants, then the corrector displacement
    at the midpoint from the halo-extended courants ``ext``
    (xchng_courants_pc), whose x may lie up to two cells outside the slab.
    Final positions outside the slab are the ring migration's."""
    ny, nz = cfg.ny, cfg.nz
    cx_ext, cy_ext, cz_ext = ext
    x_old, y_old, z_old = state.x, state.y, state.z
    # the predictor: the SDs sit in live cells
    x, y, z = transport._advance(cfg, state, state.ijk, x_old, y_old, z_old,
                                 transport._axis_euler)
    if cfg.n_dims > 1:
        z = torch.clamp(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    if cfg.n_dims == 3:
        y_wr = transport._wrap(y, cfg.y0, cfg.y1)
        y_old = y_old + (y_wr - y)
        y = y_wr
    # the corrector at the midpoint, gathered from the ext layout (+2)
    floor = lambda p, d: torch.floor(p / d).to(torch.int64)
    i = torch.clamp(floor(x, cfg.dx), -2, dom.nxl + 1)
    j = torch.clamp(floor(y, cfg.dy), 0, ny - 1) if cfg.n_dims == 3 \
        else torch.zeros_like(i)
    k = torch.clamp(floor(z, cfg.dz), 0, nz - 1) if cfg.n_dims > 1 \
        else torch.zeros_like(i)
    f = lambda a: a.to(x.dtype)
    lft = ((i + 2) * ny + j) * nz + k
    upd = dict(x=(x + x_old + transport._euler_disp(
        x, cfg.dx, f(i), cx_ext[lft], cx_ext[lft + ny * nz])) / 2.0)
    if cfg.n_dims == 3:
        fre = ((i + 2) * (ny + 1) + j) * nz + k
        upd["y"] = (y + y_old + transport._euler_disp(
            y, cfg.dy, f(j), cy_ext[fre], cy_ext[fre + nz])) / 2.0
    if cfg.n_dims > 1:
        blw = ((i + 2) * ny + j) * (nz + 1) + k
        upd["z"] = (z + z_old + transport._euler_disp(
            z, cfg.dz, f(k), cz_ext[blw], cz_ext[blw + 1])) / 2.0
    return dataclasses.replace(state, **upd)


def _rows(cfg: StaticConfig, st: State):
    """The names of the per-SD attributes that migrate (migrating_attrs,
    those the State sizes) and their values as one (rows, n_sd) matrix,
    the dissolved masses' 8 rows after them with chem_switch."""
    names = [a for a in migrating_attrs(cfg)
             if getattr(st, a).numel() == st.n.numel()]
    mat = [getattr(st, a) for a in names]
    if cfg.chem_switch:
        mat += list(st.chem.unbind(0))
    return names, torch.stack(mat)


def _pack(mat, mask, buf, x_row, shift):
    """The first ``buf`` SDs that ``mask`` marks, in slot order (a stable
    sort puts them first), their x shifted by ``shift``; zero past them
    (decomp.py:268-286).  Returns (payload (rows, buf), valid (buf,), the
    count that did not fit)."""
    idx = torch.argsort((~mask).to(torch.int8), stable=True)[:buf]
    valid = mask[idx]
    pay = mat[:, idx]
    pay[x_row] += shift
    return torch.where(valid, pay, 0.0), valid, \
        torch.clamp(mask.sum() - buf, min=0)


def _unpack(mat, alive, pay, valid):
    """Put the payload's valid lanes into the first dead slots, in slot
    order (decomp.py:308-321); the others are dropped.  Returns (mat,
    alive)."""
    n_sd = mat.shape[1]
    slots = torch.argsort(alive.to(torch.int8), stable=True)[:valid.numel()]
    tgt = torch.where(valid, slots, n_sd)
    out = torch.nn.functional.pad(mat, (0, 1))
    out[:, tgt] = pay
    alive = torch.nn.functional.pad(alive, (0, 1))
    alive[tgt] = valid
    return out[:, :n_sd], alive[:n_sd]


def migrate(cfg: StaticConfig, shards, doms, buf: int, group=None):
    """Exchange the SDs that left their slab with the two x neighbours
    (decomp.py:237-332; reference mpi_exchange.ipp:20-331,
    step_async_and_copy.ipp:28-206).  ``cfg`` is the local config, ``buf``
    the buffer's slots a direction.  On each shard the movers are packed
    (_pack), their x re-based (a right mover lands at x - hi(sender) +
    lo(receiver), and the ends wrap periodically) and killed locally;
    under open_side_walls those leaving the global domain die instead.
    The payloads, each of fixed shape (the buffer's columns and their
    valid lanes), go around the ring (ring_exchange), the one from the
    left first put into the receiver's dead slots, then the one from the
    right; the dissolved masses ride along.  What did not fit a buffer is
    counted in the sender's puddle slot OUT_MIGRATION_OVERFLOW.  Then
    transport.post_step re-bins every shard.  Returns the shards."""
    S = len(doms)
    mine = owned_shards(S, group)
    names, sent, kept = None, [], []
    for s, st in zip(mine, shards):
        dom = doms[s]
        with on_device(dom.device):
            n = st.n
            go_l, go_r = (n > 0) & (st.x < dom.lo), (n > 0) & (st.x >= dom.hi)
            if cfg.open_side_walls:
                # SDs leaving the global domain die, as transport.bcnd
                # kills them (the ring would make the wall periodic)
                kill = torch.zeros_like(go_l)
                if s == 0:
                    kill |= go_l
                if s == S - 1:
                    kill |= go_r
                n = torch.where(kill, 0.0, n)
                go_l, go_r = go_l & ~kill, go_r & ~kill
            names, mat = _rows(cfg, dataclasses.replace(st, n=n))
            x_row = names.index("x")
            left = _pack(mat, go_l, buf, x_row,
                         doms[(s - 1) % S].hi - dom.lo)
            right = _pack(mat, go_r, buf, x_row,
                          doms[(s + 1) % S].lo - dom.hi)
            mat[0] = torch.where(go_l | go_r, 0.0, mat[0])
            sent.append((left, right))
            kept.append(mat)
    from_left, from_right = ring_exchange(
        [list(left[:2]) for left, _ in sent],
        [list(right[:2]) for _, right in sent],
        [doms[s] for s in mine], group)
    out = []
    for s, st, mat, (l_out, r_out), fl, fr in zip(
            mine, shards, kept, sent, from_left, from_right):
        with on_device(doms[s].device):
            alive = mat[0] > 0
            for pay, valid in (fl, fr):
                mat, alive = _unpack(mat, alive, pay, valid)
            rows = dict(zip(names, mat.unbind(0)))
            if cfg.chem_switch:
                rows["chem"] = mat[len(names):]
            puddle = st.puddle.clone()
            puddle[OUT_MIGRATION_OVERFLOW] += (l_out[2] + r_out[2]
                                               ).to(puddle.dtype)
            out.append(transport.post_step(cfg, dataclasses.replace(
                st, puddle=puddle, **rows)))
    return out


def sharded_sync_step(cfg: StaticConfig, group=None):
    """The condensation phase of the shards (decomp.py:382-400): the
    courant-halo refresh, then the serial engine's condensation body
    (lgrngn/particles.step_cond_body: kernel F a cell, or G in exact mode,
    on each shard's padded slab) and, with chem_switch and ``chem``, the
    chemistry substeps.  ``cfg`` is the local config, ``group`` the
    processes the shards are spread over (module docstring); returns
    step(shards, doms, dt, RH_max, var_rho=False, turb_cond=False,
    plain=False, chem=True, **ice_kw)."""

    def step(shards, doms, dt, RH_max, var_rho=False, turb_cond=False,
             plain=False, chem=True, **ice_kw):
        shards = xchng_courants(cfg, shards, doms, group)
        out = []
        for st, dom in zip(shards, local_domains(doms, group)):
            with on_device(dom.device):
                st = step_cond_body(cfg, st, dt, RH_max, var_rho, turb_cond,
                                    plain=plain, **ice_kw)
                if cfg.chem_switch and chem:
                    st = chemistry.sstp_chem_loop(
                        cfg, hskpng.hskpng_Tpr_state(cfg, st), dt, True,
                        True, True)
            out.append(st)
        return out

    return step


def sharded_async_step(cfg: StaticConfig, sstp_coal: int, buf: int,
                       switches=(True, True, True, False), group=None):
    """The transport phase of the shards with the ring migration
    (decomp.py:403-451): on each shard the serial engine's async process
    set (lgrngn/particles.step_async_body: coalescence, the SGS block,
    advection, the turbulent displacement, sedimentation, subsidence,
    recycling) with the walls in y and z alone (decomp.py:335-379's
    _bcnd_z_only is transport.bcnd with x_walls False: the x wrap is the
    ring's) and pred_corr's corrector on the halo-2 courants, then
    migrate.
    ``cfg`` is the local config, ``switches`` step_async_body's, ``group``
    sharded_sync_step's.  Returns step(shards, doms, params, w_LS,
    sgs_mix_len, dt)."""
    pred_corr = as_t(cfg.adve_scheme) == as_t.pred_corr

    def step(shards, doms, params, w_LS, sgs_mix_len, dt):
        exts = xchng_courants_pc(cfg, shards, doms, group) if pred_corr \
            else [None] * len(shards)
        out = []
        for st, dom, ext in zip(shards, local_domains(doms, group), exts):
            adve = (lambda c, s, dom=dom, ext=ext:
                    adve_pred_corr_sharded(c, s, dom, ext)) if pred_corr \
                else transport.adve
            on = lambda a, dom=dom: None if a is None else a.to(dom.device)
            with on_device(dom.device):
                out.append(step_async_body(
                    cfg, sstp_coal, switches, st, params, on(w_LS), dt,
                    on(sgs_mix_len), adve=adve, x_walls=False))
        return migrate(cfg, out, doms, buf, group)

    return step


def build_multichip_step(devices, cfg: StaticConfig, sstp_coal=1, buf=None,
                         switches=None, group=None):
    """The whole multi-device step (decomp.py:470-502): the courant halos
    and the shards' condensation, then their transport with the ring
    migration.  ``devices`` are every shard's.  Returns (step(shards,
    doms, params, w_LS, sgs_mix_len, dt, RH_max), the local config)."""
    cfg_l = local_config(cfg, len(devices))
    buf = buf or max(16, cfg_l.n_sd_max // 4)
    if switches is None:
        switches = (cfg.coal_switch, True, cfg.sedi_switch, False)
    sync = sharded_sync_step(cfg_l, group)
    async_ = sharded_async_step(cfg_l, sstp_coal, buf, switches, group)

    def whole_step(shards, doms, params, w_LS, sgs_mix_len, dt, RH_max):
        return async_(sync(shards, doms, dt, RH_max), doms, params, w_LS,
                      sgs_mix_len, dt)

    return whole_step, cfg_l


def replicate_state_for_mesh(cfg: StaticConfig, devices, state_builder,
                             widths=None, group=None):
    """The States of the shards this process owns (owned_shards over
    ``devices``, every shard's), each from ``state_builder(shard_index,
    cfg_local)`` and on its device (decomp.py:505-525; with a group, the
    counterpart of decomp.global_put, decomp.py:528-557: every process
    builds from the same host values and keeps its own shards)."""
    cfg_l = local_config(cfg, len(devices), widths)
    out = []
    for s in owned_shards(len(devices), group):
        st, dev = state_builder(s, cfg_l), devices[s]
        out.append(dataclasses.replace(st, **{
            f: getattr(st, f).to(dev) for f in
            (fld.name for fld in dataclasses.fields(State))
            if isinstance(getattr(st, f), torch.Tensor)}))
    return out


# the per-cell State fields (chemistry's (6, n_cell) rows included) that
# a shard holds as its padded slab
_CELL_FIELDS = ("th", "rv", "rhod", "p", "T", "RH", "eta", "dv",
                "diss_rate", "ambient_chem", "sstp_tmp_chem")


def shard_state(cfg: StaticConfig, g: State, doms, cap: int, group=None):
    """A global State -> each shard's State of the padded slab in local
    coordinates (multi.py:223-295): a shard's live SDs in slot order at
    its first slots, x and ijk re-based (i is the outermost index of ijk,
    so the slab's shift is an offset), its cells padded
    (pad_cell_field), its courants sliced (pad_courants); the puddles
    zero; shard s draws with the key word ops/philox.shard_key(s), s its
    global index, whichever process holds it.  With a ``group``, the
    shards this process owns (the counterpart of decomp.global_put,
    decomp.py:528-557: every process shards the same global State).
    Raises where a slab holds more SDs than ``cap``."""
    nyz = cfg.ny * cfg.nz
    ends = torch.tensor(np.cumsum([d.nxl for d in doms]),
                        device=g.n.device)
    shard = torch.searchsorted(ends, g.ijk // nyz, right=True)
    shard = torch.where(g.n > 0, shard, -1)
    sels = [torch.nonzero(shard == s).reshape(-1) for s in range(len(doms))]
    most = max(int(sel.numel()) for sel in sels)
    if most > cap:
        raise RuntimeError(
            f"libcloudphxx: shard SD count {most} exceeds the per-device "
            f"capacity {cap}; raise n_sd_max")
    per_sd = {"ijk"} | set(migrating_attrs(cfg))
    chem = g.chem.numel() > 0
    mine = owned_shards(len(doms), group)
    own = [doms[s] for s in mine]
    nx_pad = max(d.nxl for d in doms)
    cells = {f: pad_cell_field(cfg, getattr(g, f), own, nx_pad)
             for f in _CELL_FIELDS if getattr(g, f).numel()}
    if not cfg.exact_sstp_cond:
        for f in ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh"):
            cells[f] = pad_cell_field(cfg, getattr(g, f), own, nx_pad)
    cour = pad_courants(cfg, g.courant_x, g.courant_y, g.courant_z, own,
                        nx_pad)
    out = []
    for i, (s, dom) in enumerate(zip(mine, own)):
        sel = sels[s]
        k = sel.numel()
        upd = {}
        for f in dataclasses.fields(State):
            v = getattr(g, f.name)
            if f.name in per_sd and v.numel() == g.n.numel():
                o = v.new_zeros(cap)
                o[:k] = v[sel]
                if f.name == "x":
                    o[:k] -= dom.col0 * cfg.dx
                elif f.name == "ijk":
                    o[:k] -= dom.col0 * nyz
                upd[f.name] = o.to(dom.device)
        if chem:
            o = g.chem.new_zeros((g.chem.shape[0], cap))
            o[:, :k] = g.chem[:, sel]
            upd["chem"] = o.to(dom.device)
        upd.update({f: v[i] for f, v in cells.items()})
        upd.update(zip(("courant_x", "courant_y", "courant_z"), cour[i]))
        upd["puddle"] = torch.zeros_like(g.puddle)
        for f in dataclasses.fields(State):
            v = upd.get(f.name, getattr(g, f.name))
            if isinstance(v, torch.Tensor):
                upd[f.name] = v.to(dom.device)
        out.append(dataclasses.replace(g, rng_key=shard_key(s), **upd))
    return out


def gather_flat(cfg: StaticConfig, shards, doms) -> State:
    """The inverse of shard_state (multi.py:164-221): the shards' SDs in
    one global State in shard-major slot order (their dead slots too,
    zeroed), x and ijk back in global coordinates, the cells unpadded,
    the puddles summed; the random stream of shard 0 with the serial
    engine's key word.  On the first shard's device."""
    dev, nyz = shards[0].n.device, cfg.ny * cfg.nz
    per_sd = set(migrating_attrs(cfg)) | {"ijk"}
    upd = {}
    for f in dataclasses.fields(State):
        name = f.name
        vals = [getattr(st, name) for st in shards]
        if not isinstance(vals[0], torch.Tensor) or name.startswith(
                "courant_"):
            continue
        if vals[0].numel() == 0:
            upd[name] = vals[0].to(dev)
        elif name in per_sd:
            parts = []
            for st, dom, v in zip(shards, doms, vals):
                alive = st.n > 0
                off = dom.col0 * (cfg.dx if name == "x" else nyz)
                if name in ("x", "ijk"):
                    v = torch.where(alive, v + off, 0)
                parts.append(v.to(dev))
            upd[name] = torch.cat(parts)
        elif name == "chem":
            upd[name] = torch.cat([torch.where(st.n > 0, v, 0.0).to(dev)
                                   for st, v in zip(shards, vals)], dim=1)
        elif name == "puddle":
            upd[name] = sum(v.to(dev) for v in vals)
        else:
            upd[name] = unpad_cell_field(cfg, vals, doms)
    cx, cy, cz = unpad_courants(cfg, shards, doms)
    return dataclasses.replace(shards[0], courant_x=cx, courant_y=cy,
                               courant_z=cz, rng_key=0, **upd)
