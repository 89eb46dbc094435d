"""The dense cell-major engine on an x-slab mesh (libcloudphxx_tpu/parallel/
dense_mesh.py).

The occupancy matrix (n_cell, cap) is row-major in cells with x outermost,
so an x slab is a contiguous row range: each shard holds the rows of its
columns, padded to the widest slab (decomp.ShardDomain).  Everything in the
dense step is row-local except the re-binning after transport, so a shard
runs the serial engine's kernels on its rows (lgrngn/dense.step_fused_shard:
kernels B, E and C's unwrapped form, which gives the droplets that leave
the slab target -1; under pred_corr C's pred_corr form on a slab, whose
corrector reads the shard's courants in the halo-2 layout that
scatter_dense exchanges once, decomp.xchng_courants_pc), and
rebin_sharded then

  1. kills the droplets that left the global domain under open side walls
     and wraps the others' x (periodic side walls),
  2. packs the cross-shard movers of the edge columns into fixed buffers
     of ``buf`` a direction (the shorter way round the ring), each with the
     global row it left, counting what does not fit,
  3. sends the buffers around the ring (decomp.ring_exchange: copies to
     the neighbours' devices, messages between processes; the reference's
     MPI exchange, mpi_exchange.ipp:20-331),
  4. puts the arrivals into a halo column on each side of the shard's
     rows, each in the row of the level it left, in the order it had
     there, and re-bins the rows with kernel D on that extended slab: a row
     takes its droplets from its own, its neighbours' and the halo's rows
     in the order the serial engine's kernel D takes them from the
     neighbouring columns, so the mesh's rows hold the serial engine's
     droplets lane for lane, and
  5. repairs with the global re-bin of the shard (dense._rebin_global)
     where a row has a far mover or an arrival is further than one cell
     from its row (a process reads its shards' flags in one transfer).

Every SD that is dropped is added to the shard's ``overflow``.

With a torch.distributed process ``group`` (decomp's module docstring)
the functions take every shard's ShardDomain and this process's shards:
scatter_dense keeps the slabs the process owns, the payloads cross
between processes as messages, the far-mover flags stay each shard's own
decision and the count of SDs sent across slab edges, and a const-multi
population's request for one more coalescence substep, are summed over
the processes.

Unlike the JAX mesh, which re-bases x to slab-local coordinates (as the
reference's MPI ranks do, pack.ipp:14-27), the port keeps x in global
coordinates on every shard: a shard's transport then does the same float
operations as the serial engine's, so
the mesh reproduces the serial engine's positions bit for bit.  The ring's
shift is then the periodic wrap alone.

The mover packing and the halo are plain PyTorch: the JAX package
computes them in XLA, outside any Pallas kernel.
"""

import dataclasses

import torch

from ..lgrngn import dense
from ..lgrngn.condensation import exact_route
from ..lgrngn.dense import DenseState
from ..lgrngn.enums import as_t
from ..lgrngn.hskpng import ijk_of_xyz
from ..lgrngn.state import OUT_COAL_OVERFLOW
from ..models import mpdata
from ..ops.step import column_of, level_of, wrap_x
from .decomp import (group_sum, local_config, local_domains, make_mesh,
                     on_device, owned_shards, pad_cell_field, ring_exchange,
                     shard_domains, unpad_cell_field, xchng_courants_pc)

_CELLS = ("rhod", "p", "T", "RH", "eta", "dv", "sstp_tmp_th", "sstp_tmp_rv")


def _nx_pad(doms):
    return max(dom.nxl for dom in doms)


def _pred_corr(cfg):
    return as_t(cfg.adve_scheme) == as_t.pred_corr


def _check_pred_corr(cfg, doms):
    """pred_corr's halo-2 courant exchange reads two live columns of each
    slab (decomp.xchng_courants_pc), as the flat front's does."""
    if _pred_corr(cfg) and min(dom.nxl for dom in doms) < 2:
        raise NotImplementedError(
            "dense mesh: pred_corr SD advection needs slabs of at least 2 "
            f"columns (its halo-2 courant exchange), got "
            f"{[dom.nxl for dom in doms]}")


def _edge_rows(mat, nz, nxl, n_edge, dim=0):
    """Rows (along ``dim``) of the first ``n_edge`` live columns, then of
    the last ``n_edge`` (dense_mesh.py:31-44).  The two blocks stay
    disjoint: on a slab of nxl <= 2 * n_edge columns the second starts past
    the first, in padded (SD-free) columns or past the matrix's end."""
    start = max(n_edge, nxl - n_edge) * nz
    lo = mat.narrow(dim, 0, n_edge * nz)
    if start >= mat.shape[dim]:
        return lo
    hi = mat.narrow(dim, start, min(n_edge * nz, mat.shape[dim] - start))
    return torch.cat([lo, hi], dim)


def scatter_dense(cfg, d: DenseState, doms, group=None):
    """A global DenseState -> a DenseState a shard (the layout
    dense_mesh.scatter_dense makes, dense_mesh.py:170-232, with x kept in
    global coordinates).  Padded rows hold no SDs, padded columns copy the
    slab's last live column's cell values, the staggered courants are
    sliced as multi._pad_courant_{x,z} do, and under pred_corr their
    halo-2 layout is exchanged around the ring once here (the courants do
    not change between loads).  Each shard draws from the state's own
    (rng_seed, rng_step), keyed by its global rows; shard 0 takes the
    puddle and the overflow count, so that gather_state gives them back.
    In exact mode the private ambient planes ride as the others.  With a
    ``group``, the shards this process owns (every process scatters the
    same global state: decomp.global_put's counterpart).  A pending merge
    runs first (dense.flush_merge)."""
    _check_pred_corr(cfg, doms)
    d = dense.flush_merge(cfg, d)
    nz, cap = cfg.nz, d.cap
    nx_pad = _nx_pad(doms)
    mine = owned_shards(len(doms), group)
    cells = {a: pad_cell_field(cfg, getattr(d, a), [doms[s] for s in mine],
                               nx_pad) for a in _CELLS}
    cx = d.courant_x.reshape(cfg.nx + 1, nz)
    cz = d.courant_z.reshape(cfg.nx, nz + 1)
    shards = []
    for i, s in enumerate(mine):
        dom = doms[s]
        c0, w, dev = dom.col0, dom.nxl, dom.device
        rows = slice(c0 * nz, (c0 + w) * nz)

        def sd(a):
            out = a.new_zeros((nx_pad * nz, cap))
            out[:w * nz] = a[rows]
            return out.to(dev)

        cx_s = cx.new_zeros((nx_pad + 1, nz))
        cx_s[:w + 1] = cx[c0:c0 + w + 1]
        cz_s = cz.new_zeros((nx_pad, nz + 1))
        cz_s[:w] = cz[c0:c0 + w]
        own = lambda a: (a if s == 0 else torch.zeros_like(a)).to(dev)
        shards.append(DenseState(
            **{a: sd(getattr(d, a)) for a in dense.attrs_of(cfg)},
            **{a: cells[a][i] for a in _CELLS},
            courant_x=cx_s.reshape(-1).to(dev),
            courant_z=cz_s.reshape(-1).to(dev),
            puddle=own(d.puddle), overflow=own(d.overflow),
            rng_seed=d.rng_seed, rng_step=d.rng_step))
    if _pred_corr(cfg):
        shards = [dataclasses.replace(st, halo_cx=hx, halo_cz=hz)
                  for st, (hx, _, hz) in zip(
                      shards, xchng_courants_pc(cfg, shards, doms, group))]
    return shards


def gather_state(cfg, shards, doms) -> DenseState:
    """The inverse of scatter_dense: the shards' population as one global
    DenseState at their row capacity, on the first shard's device (each
    row keeps its droplets in lane order, alive first), the puddles and
    overflow counts summed (the sticky coalescence overflow flag taken as
    the largest), the random stream of shard 0."""
    nz, cap = cfg.nz, shards[0].cap
    dev = shards[0].n.device
    attrs = dense.attrs_of(cfg)
    cells, vals = [], {a: [] for a in attrs}
    for d, dom in zip(shards, doms):
        rows = dom.nxl * nz
        cell = torch.arange(dom.col0 * nz, dom.col0 * nz + rows,
                            device=dev)[:, None].expand(rows, cap)
        alive = d.n[:rows].to(dev) > 0
        cells.append(torch.where(alive, cell, cfg.n_cell).reshape(-1))
        for a in attrs:
            vals[a].append(getattr(d, a)[:rows].to(dev).reshape(-1))
    planes, overflow = dense._distribute(
        cfg.n_cell, cap, torch.cat(cells), [torch.cat(v) for v in
                                            vals.values()])
    nx_pad = _nx_pad(doms)
    last, w_last = shards[-1], doms[-1].nxl
    cx = torch.cat(
        [s.courant_x.reshape(nx_pad + 1, nz)[:dom.nxl].to(dev)
         for s, dom in zip(shards, doms)]
        + [last.courant_x.reshape(nx_pad + 1, nz)[w_last:w_last + 1].to(dev)])
    cz = torch.cat([s.courant_z.reshape(nx_pad, nz + 1)[:dom.nxl].to(dev)
                    for s, dom in zip(shards, doms)])
    puddles = torch.stack([s.puddle.to(dev) for s in shards])
    puddle = puddles.sum(0)
    puddle[OUT_COAL_OVERFLOW] = puddles[:, OUT_COAL_OVERFLOW].max()
    return DenseState(
        **dict(zip(attrs, planes)),
        **{a: unpad_cell_field(cfg, [getattr(s, a) for s in shards], doms)
           for a in _CELLS},
        courant_x=cx.reshape(-1), courant_z=cz.reshape(-1),
        puddle=puddle,
        overflow=sum(s.overflow.to(dev) for s in shards) + overflow,
        rng_seed=shards[0].rng_seed, rng_step=shards[0].rng_step,
        rebins=sum(s.rebins for s in shards))


def gather_dense(cfg, shards, doms):
    """Host-side: the shards' alive SDs as numpy arrays of their
    attributes and global ``cell``, the puddle summed over the shards and
    the total ``overflow`` (dense_mesh.gather_dense, dense_mesh.py:
    258-295)."""
    d = gather_state(cfg, shards, doms)
    alive = (d.n > 0).cpu().numpy()
    rows = torch.arange(cfg.n_cell)[:, None].expand(cfg.n_cell, d.cap)
    out = {a: getattr(d, a).cpu().numpy()[alive] for a in dense.ATTRS}
    out["cell"] = rows.numpy()[alive]
    out["puddle"] = d.puddle.cpu().numpy()
    out["overflow"] = float(d.overflow)
    return out


def _pack(blk, mask, buf):
    """The first ``buf`` SDs of the edge slots ``blk`` (the planes stacked,
    (k, slots)) that ``mask`` (slots,) marks, in row-major order, zeros
    past them: (payload (k, buf), the number that did not fit, the number
    packed)."""
    pos = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (pos < buf), pos, buf)
    out = blk.new_zeros((blk.shape[0], buf + 1))
    out.scatter_(1, dst.expand(blk.shape[0], -1), torch.where(mask, blk, 0.0))
    count = mask.sum()
    return out[:, :buf], torch.clamp(count - buf, min=0), \
        torch.clamp(count, max=buf)


def _halos(cfg, dom, from_l, from_r, cap):
    """The arrivals from the left and from the right neighbour (each the
    planes stacked, then the global row each left, (k + 1, m)) as the two
    halo columns: (planes (k, 2 nz, cap), the left halo's rows then the
    right's; the target of each of their slots in the extended slab (-1
    where dead); the number of arrivals that do not fit a row; the number
    that are further than one cell from their row).  Each arrival sits in
    the row of the level it left, after the earlier arrivals from the same
    global row, so that a halo's rows hold a neighbour's droplets in their
    order there.  An arrival that lands in the shard's edge column within
    a level of its row, from the column next to the slab, targets that row
    (the extended slab's column 1, or nxl); any other stays in its halo row
    and is the repair's."""
    nz, k = cfg.nz, from_l.shape[0] - 1
    arr = torch.cat([from_l, from_r], 1)
    right = torch.arange(arr.shape[1], device=arr.device) >= from_l.shape[1]
    n, x, z = arr[0], arr[dense.ATTRS.index("x")], arr[dense.ATTRS.index("z")]
    src = arr[-1].long()
    alive = n > 0
    k_src = src % nz
    h = torch.where(alive, right * nz + k_src, 2 * nz)
    h_s, order = torch.sort(h, stable=True)
    rank = torch.empty_like(h)
    rank[order] = torch.arange(h.numel(), device=h.device) \
        - torch.searchsorted(h_s, h_s)
    fits = alive & (rank < cap)
    slot = torch.where(fits, h * cap + rank, 2 * nz * cap)
    planes = arr.new_zeros((k, 2 * nz * cap + 1))
    planes.scatter_(1, slot.expand(k, -1), arr[:k])
    c0, w = dom.col0, dom.nxl
    adj = torch.where(right, (c0 + w) % cfg.nx, (c0 - 1) % cfg.nx)
    edge = torch.where(right, c0 + w - 1, c0)
    k_t = level_of(cfg, z).long()
    near = (src // nz == adj) & (column_of(cfg, x).long() == edge) \
        & ((k_t - k_src).abs() <= 1)
    to = torch.where(near, torch.where(right, w, 1) * nz + k_t,
                     torch.where(right, (w + 1) * nz, 0) + k_src)
    tgt = torch.full((2 * nz * cap + 1,), -1, dtype=torch.int32,
                     device=n.device)
    tgt.scatter_(0, slot, to.to(torch.int32))
    return (planes[:, :-1].reshape(k, 2 * nz, cap),
            tgt[:-1].reshape(2 * nz, cap), (alive & ~fits).sum(),
            (fits & ~near).sum())


def _extend(cfg, d, dom, tgt, from_l, from_r):
    """The shard ``d`` as an extended slab of nx_pad + 2 columns, its
    rows after a halo column of the arrivals from the left (column 0) and
    the halo of the arrivals from the right at column nxl + 1 (over the
    padded columns of a narrow slab): (cfg of the extended slab, the
    extended DenseState, each slot's target row there, the arrivals that
    do not fit, those the repair must place)."""
    nz = cfg.nz
    attrs = dense.attrs_of(cfg)
    nx_e = d.n_cell // nz + 2
    halo, halo_t, lost, stray = _halos(cfg, dom, from_l, from_r, d.cap)
    at = (dom.nxl + 1) * nz
    e = torch.cat([halo[:, :nz], torch.stack([getattr(d, a) for a in attrs]),
                   torch.zeros_like(halo[:, :nz])], 1)
    e[:, at:at + nz] = halo[:, nz:]
    t = torch.cat([halo_t[:nz],
                   torch.where(tgt >= 0, tgt + nz, -1).to(torch.int32),
                   torch.full_like(halo_t[:nz], -1)])
    t[at:at + nz] = halo_t[nz:]
    cfg_e = dataclasses.replace(cfg, nx=nx_e, n_cell=nx_e * nz)
    return (cfg_e, dataclasses.replace(d, **dict(zip(attrs, e.unbind(0)))),
            t, lost, stray)


def _repair(cfg, cfg_e, d, dom):
    """The global re-bin of an extended slab (dense._rebin_global): each
    live droplet to the row of its position, the shard's own clamped to
    its columns; an arrival outside them is dropped and counted."""
    nz = cfg.nz
    g = ijk_of_xyz(cfg, d.x, None, d.z)
    col = g // nz - dom.col0
    row = torch.arange(d.n_cell, device=d.n.device)[:, None]
    halo = (row < nz) | (row >= (dom.nxl + 1) * nz)
    alive = d.n > 0
    out = alive & halo & ((col < 0) | (col >= dom.nxl))
    col = torch.clamp(col, 0, dom.nxl - 1)
    tgt = torch.where(alive & ~out, (col + 1) * nz + g % nz, d.n_cell)
    d = dataclasses.replace(d, overflow=d.overflow + out.sum().to(
        d.overflow.dtype))
    return dense._rebin_global(cfg_e, d, tgt)


def rebin_sharded(cfg, shards, doms, tgts, fars, buf, *, plain=False,
                  group=None, grow=False):
    """The re-binning of the mesh after the shards' transport (see the
    module docstring; dense_mesh.py:50-152).  ``shards`` hold the positions
    after kernel C's unwrapped form, ``tgts`` its local target rows (-1
    for a droplet that leaves its shard), ``fars`` the shards' far-mover
    row counts; ``buf`` is the mover capacity a direction.  With ``grow``
    (a const-multi population's coalescing step) the shards' coalescence
    overflow flags are read too, and cleared where one is set, as the
    serial engine's run_device_lgrngn does.  Returns (the shards, the
    number of SDs sent across slab edges on the first shard's device,
    whether a flag was set on a shard of any process)."""
    nz = cfg.nz
    nx_pad = _nx_pad(doms)
    n_edge = min(2, nx_pad // 2) or 1
    attrs = dense.attrs_of(cfg)
    own = local_domains(doms, group)
    out, pay_l, pay_r, sent = [], [], [], []
    for d, dom, tgt in zip(shards, own, tgts):
        with on_device(dom.device):
            n, x = d.n, d.x
            mover = (n > 0) & (tgt < 0)
            out_x = (x < cfg.x0) | (x >= cfg.x1)
            if cfg.open_side_walls:
                # SDs leaving the global domain die (the first and the last
                # shard's); the others ride the ring
                n = torch.where(mover & out_x, 0.0, n)
                mover = mover & ~out_x
            else:
                x = torch.where(mover & out_x, wrap_x(cfg, x), x)
            # the way out: the shorter one round the ring from the row's
            # column to the droplet's; each mover carries its global row
            row = torch.arange(d.n_cell, device=n.device)
            g_row = ((dom.col0 + row // nz) * nz + row % nz).to(x.dtype)
            step = torch.remainder(column_of(cfg, x) - (g_row // nz)[:, None]
                                   + cfg.nx // 2, cfg.nx) - cfg.nx // 2
            go_l, go_r = mover & (step < 0), mover & (step >= 0)
            planes = dict({a: getattr(d, a) for a in attrs}, n=n, x=x)
            edge = lambda a: _edge_rows(a, nz, dom.nxl, n_edge,
                                        dim=a.dim() - 2)
            blk = edge(torch.stack([planes[a] for a in attrs]
                                   + [g_row[:, None].expand_as(n)])
                       ).reshape(len(attrs) + 1, -1)
            blk_l, blk_r = edge(go_l).reshape(-1), edge(go_r).reshape(-1)
            p_l, ovf_l, sent_l = _pack(blk, blk_l, buf)
            p_r, ovf_r, sent_r = _pack(blk, blk_r, buf)
            # movers outside the edge blocks (a jump longer than CFL allows)
            # are dropped too, and counted
            lost_long = mover.sum() - blk_l.sum() - blk_r.sum()
            planes["n"] = torch.where(mover, 0.0, n)
            d = dataclasses.replace(
                d, overflow=d.overflow + (ovf_l + ovf_r + lost_long).to(
                    d.overflow.dtype), **planes)
        out.append(d)
        pay_l.append(p_l)
        pay_r.append(p_r)
        sent.append(sent_l + sent_r)
    from_left, from_right = ring_exchange([[p] for p in pay_l],
                                          [[p] for p in pay_r], own, group)
    ext, flags = [], []
    for i, (d, dom, tgt) in enumerate(zip(out, own, tgts)):
        with on_device(dom.device):
            cfg_e, d, t, lost, stray = _extend(cfg, d, dom, tgt,
                                               from_left[i][0],
                                               from_right[i][0])
            d = dataclasses.replace(d, overflow=d.overflow + lost.to(
                d.overflow.dtype))
            if nx_pad >= 3:
                d = dense.merge(cfg_e, d, t, plain=plain)
            ext.append((cfg_e, d))
            flags.append(torch.stack([
                fars[i].to(stray.dtype) + stray,
                d.puddle[OUT_COAL_OVERFLOW].to(stray.dtype)]))
    # one transfer reads every shard's repair and growth flags (none on
    # slabs narrower than the merge needs, which are re-binned whole, and
    # no coalescence flag to read: no transfer)
    dev0 = own[0].device
    read = nx_pad >= 3 or grow
    host = torch.stack([f.to(dev0) for f in flags]).cpu() if read else None
    grew = False
    if grow:
        grew = int(group_sum((host[:, 1] > 0).sum(), group)) > 0
    for i, (dom, (cfg_e, d)) in enumerate(zip(own, ext)):
        with on_device(dom.device):
            if nx_pad < 3 or host[i, 0] > 0:
                d = _repair(cfg, cfg_e, d, dom)
            rows = slice(nz, nz + nx_pad * nz)
            d = dataclasses.replace(d, **{a: getattr(d, a)[rows]
                                          for a in attrs})
            if grew:
                pud = d.puddle.clone()
                pud[OUT_COAL_OVERFLOW] = 0.0
                d = dataclasses.replace(d, puddle=pud)
        out[i] = d
    return out, group_sum(sum(c.to(dev0) for c in sent), group), grew


def dense_step_sharded(cfg, doms, sstp_coal: int, buf: int, do_coal: bool,
                       do_sedi: bool, RH_max: float, *, coal_pairing="stride",
                       plain=False, group=None):
    """One microphysics step of the mesh (dense_mesh.py:298-332): on each
    shard condensation, coalescence and transport with x unwrapped
    (lgrngn/dense.step_fused_shard), then rebin_sharded.  ``cfg`` is the
    global configuration, ``doms`` every shard's domain
    (decomp.shard_domains), ``group`` the processes they are spread over
    (the module docstring).  Returns step(shards, th, rv, params, dt) ->
    (shards, th, rv, crossed, grew) with ``shards`` this process's, th and
    rv a padded slab field a shard of them (pad_cell_field), ``crossed``
    the SDs sent across slab edges (of every process) and ``grew`` whether
    a const-multi population's coalescence asked for one more substep (as
    the serial engine's run_device_lgrngn reads it; False otherwise)."""
    if exact_route(cfg):
        # the JAX mesh refuses the same (dense_mesh.py:302-308); at one
        # substep exact mode runs kernel B and refreshes the private planes
        raise NotImplementedError(
            "dense mesh: exact substepping with sstp_cond or sstp_cond_act "
            "> 1 is not supported (the JAX mesh refuses it too, "
            "dense_mesh.py:302-308); at one substep the mesh runs it")
    if cfg.n_dims == 3:
        # the slabs, the ring and kernel C's unwrapped form are 2-D
        raise NotImplementedError(
            "dense mesh: the 3-D grid is not supported (the JAX package's "
            "mesh runs the 2-D grid only); the serial dense engine runs it")
    dense.supported(cfg)
    _check_pred_corr(cfg, doms)
    local_config(cfg, len(doms))      # n_sd_max split evenly, as JAX's
    if buf < 1:
        raise ValueError(f"dense mesh: buf must be >= 1, got {buf}")
    own = local_domains(doms, group)
    grow = do_coal and cfg.pure_const_multi

    def step(shards, th, rv, params, dt):
        res = []
        for d, th_s, rv_s, dom in zip(shards, th, rv, own):
            with on_device(dom.device):
                res.append(dense.step_fused_shard(
                    cfg, d, th_s, rv_s, params, dt, RH_max, sstp_coal,
                    do_coal, do_sedi, (dom.col0, dom.nxl),
                    coal_pairing=coal_pairing, plain=plain))
        shards, th, rv, tgts, fars = (list(v) for v in zip(*res))
        shards, crossed, grew = rebin_sharded(
            cfg, shards, doms, tgts, fars, buf, plain=plain, group=group,
            grow=grow)
        return shards, th, rv, crossed, grew

    return step


class MeshRunner:
    """A Kinematic2D case on the dense x-slab mesh (the counterpart of
    tools/bench_mesh.py bench_dense and of the test helper _mesh_runner,
    tests/test_dense_mesh.py:53-98).  A step is kernel A on the global th
    and rv, as the JAX runner does, the fields padded to the slabs, the
    shards' step (dense_step_sharded) and the fields unpadded into the
    model; spin-up steps run without coalescence and sedimentation, with
    RH capped at 1.01, as Kinematic2D.run_device_lgrngn's do, and a
    const-multi population's coalescence grows sstp_coal as there (the
    public API's count, model.prtcls._sstp_coal_extra; the JAX mesh keeps
    it fixed).  The population starts as the model's dense_state.  Every
    shard is on the model's device; ``buf`` defaults to every slot of a
    column's rows, which no move under CFL <= 1 overfills."""

    def __init__(self, model, n_shards=8, buf=None):
        self.model = model
        self.cfg = cfg = model.cfg
        self.doms = shard_domains(cfg, make_mesh(n_shards, model.device))
        d = model.dense_state
        self.buf = buf or cfg.nz * d.cap
        self._steps = {}
        self.load(d, model.th, model.rv)

    def load(self, d, th, rv):
        """Start from the global population ``d`` and the fields th, rv
        (its courants, under pred_corr in their halo-2 layout, exchanged
        here once); the crossing count starts at 0."""
        self.shards = scatter_dense(self.cfg, d, self.doms)
        self.model.th, self.model.rv = th, rv
        self.crossed = torch.zeros((), dtype=torch.int64,
                                   device=self.doms[0].device)

    def _step_fn(self, spinup, plain):
        m, cfg = self.model, self.cfg
        sstp_coal = m._sstp_coal()
        key = (spinup, plain, sstp_coal)
        if key not in self._steps:
            self._steps[key] = dense_step_sharded(
                cfg, self.doms, sstp_coal, self.buf,
                m._does_coal(spinup), (not spinup) and cfg.sedi_switch,
                1.01 if spinup else 44.0, coal_pairing=m.coal_pairing,
                plain=plain)
        return self._steps[key]

    def step(self, spinup=False, *, plain=False):
        m, cfg, doms = self.model, self.cfg, self.doms
        th, rv = mpdata.advect2(m.th, m.rv, m.gc_x, m.gc_z, m.G,
                                n_iters=m.mpdata_iters, fct=m.fct,
                                plain=plain)
        self.shards, th_s, rv_s, crossed, grew = self._step_fn(
            spinup, plain)(
            self.shards, pad_cell_field(cfg, th.reshape(-1), doms),
            pad_cell_field(cfg, rv.reshape(-1), doms),
            m.opts_init.kernel_parameters, m.setup.dt)
        m.th = unpad_cell_field(cfg, th_s, doms).reshape(cfg.nx, cfg.nz)
        m.rv = unpad_cell_field(cfg, rv_s, doms).reshape(cfg.nx, cfg.nz)
        self.crossed = self.crossed + crossed
        m.prtcls._sstp_coal_extra += int(grew)

    def run(self, nt, spinup=0, *, plain=False):
        """``nt`` steps, the first ``spinup`` of them spin-up steps."""
        for i in range(nt):
            self.step(i < spinup, plain=plain)

    def state(self) -> DenseState:
        """The population as one global DenseState (gather_state)."""
        return gather_state(self.cfg, self.shards, self.doms)
