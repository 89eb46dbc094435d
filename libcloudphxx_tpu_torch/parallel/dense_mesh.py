"""The dense cell-major engine on an x-slab mesh (libcloudphxx_tpu/parallel/
dense_mesh.py).

The occupancy matrix (n_cell, cap) is row-major in cells with x outermost,
so an x slab is a contiguous row range: each shard holds the rows of its
columns, padded to the widest slab (decomp.ShardDomain).  Everything in the
dense step is row-local except the re-binning after transport, so a shard
runs the serial engine's kernels on its rows (lgrngn/dense.step_fused_shard:
kernels B, E and C's unwrapped form, which leaves x unwrapped and gives the
droplets that leave the slab target -1), and rebin_sharded then

  1. kills the droplets that left the global domain under open side walls
     and wraps the others' x (periodic side walls),
  2. packs the cross-shard movers of the edge columns into fixed buffers
     of ``buf`` a direction, counting what does not fit,
  3. re-bins the rest locally (kernel D, the global re-bin where a row has
     a far mover: the far flags of all shards are read in one transfer),
  4. sends the buffers around the ring, as copies to the neighbours'
     devices (the reference's MPI exchange, mpi_exchange.ipp:20-331), and
  5. puts the arrivals into the free lanes of their rows, in the JAX
     package's stable order, counting what does not fit.

Every SD that is dropped is added to the shard's ``overflow``.

Unlike the JAX mesh, which re-bases x to slab-local coordinates (as the
reference's MPI ranks do, pack.ipp:14-27), the port keeps x in global
coordinates on every shard: one process holds all of them, and a shard's
transport then does the same float operations as the serial engine's, so
the mesh reproduces the serial engine's positions bit for bit.  The ring's
shift is then the periodic wrap alone.

The mover packing and the injection are plain PyTorch: the JAX package
computes them in XLA, outside any Pallas kernel.
"""

import contextlib
import dataclasses

import torch

from ..lgrngn import coalescence as coal_mod
from ..lgrngn import dense
from ..lgrngn.dense import ATTRS, DenseState
from ..lgrngn.enums import as_t, kernel_t
from ..lgrngn.hskpng import ijk_of_xyz
from ..models import mpdata
from ..ops.step import column_of, level_of, wrap_x
from .decomp import local_config, make_mesh, shard_domains

_CELLS = ("rhod", "p", "T", "RH", "eta", "dv", "sstp_tmp_th", "sstp_tmp_rv")


def _on(device):
    """The context that makes ``device`` current where it is a card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _nx_pad(doms):
    return max(dom.nxl for dom in doms)


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


def pad_cell_field(cfg, arr, doms):
    """A global (n_cell,) cell field -> a padded slab a shard, on the
    shard's device; padded columns copy the slab's last live column."""
    g = arr.reshape(cfg.nx, cfg.nz)
    cols = torch.arange(_nx_pad(doms), device=arr.device)
    return [g[torch.clamp(cols + dom.col0, max=dom.col0 + dom.nxl - 1)]
            .reshape(-1).to(dom.device) for dom in doms]


def unpad_cell_field(cfg, fields, doms):
    """The inverse of pad_cell_field: a global (n_cell,) field on the first
    shard's device."""
    dev = fields[0].device
    return torch.cat([f.reshape(-1, cfg.nz)[:dom.nxl].to(dev)
                      for f, dom in zip(fields, doms)]).reshape(-1)


def scatter_dense(cfg, d: DenseState, doms):
    """A global DenseState -> a DenseState a shard (the layout
    dense_mesh.scatter_dense makes, dense_mesh.py:170-232, with x kept in
    global coordinates).  Padded rows hold no SDs, padded columns copy the
    slab's last live column's cell values, the staggered courants are
    sliced as multi._pad_courant_{x,z} do.  Each shard draws from the
    state's own (rng_seed, rng_step), keyed by its global rows; shard 0
    takes the puddle and the overflow count, so that gather_state gives
    them back."""
    nz, cap = cfg.nz, d.cap
    nx_pad = _nx_pad(doms)
    cells = {a: pad_cell_field(cfg, getattr(d, a), doms) for a in _CELLS}
    cx = d.courant_x.reshape(cfg.nx + 1, nz)
    cz = d.courant_z.reshape(cfg.nx, nz + 1)
    shards = []
    for s, dom in enumerate(doms):
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
            **{a: sd(getattr(d, a)) for a in ATTRS},
            **{a: cells[a][s] for a in _CELLS},
            courant_x=cx_s.reshape(-1).to(dev),
            courant_z=cz_s.reshape(-1).to(dev),
            puddle=own(d.puddle), overflow=own(d.overflow),
            rng_seed=d.rng_seed, rng_step=d.rng_step))
    return shards


def gather_state(cfg, shards, doms) -> DenseState:
    """The inverse of scatter_dense: the shards' population as one global
    DenseState at their row capacity, on the first shard's device (each
    row keeps its droplets in lane order, alive first), the puddles and
    overflow counts summed, the random stream of shard 0."""
    nz, cap = cfg.nz, shards[0].cap
    dev = shards[0].n.device
    cells, vals = [], {a: [] for a in ATTRS}
    for d, dom in zip(shards, doms):
        rows = dom.nxl * nz
        cell = torch.arange(dom.col0 * nz, dom.col0 * nz + rows,
                            device=dev)[:, None].expand(rows, cap)
        alive = d.n[:rows].to(dev) > 0
        cells.append(torch.where(alive, cell, cfg.n_cell).reshape(-1))
        for a in ATTRS:
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
    total = lambda a: sum(getattr(s, a).to(dev) for s in shards)
    return DenseState(
        **dict(zip(ATTRS, planes)),
        **{a: unpad_cell_field(cfg, [getattr(s, a) for s in shards], doms)
           for a in _CELLS},
        courant_x=cx.reshape(-1), courant_z=cz.reshape(-1),
        puddle=total("puddle"), overflow=total("overflow") + overflow,
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
    out = {a: getattr(d, a).cpu().numpy()[alive] for a in ATTRS}
    out["cell"] = rows.numpy()[alive]
    out["puddle"] = d.puddle.cpu().numpy()
    out["overflow"] = float(d.overflow)
    return out


def _pack(blk, mask, buf):
    """The first ``buf`` SDs of the edge slots ``blk`` (ATTRS' planes
    stacked, (7, slots)) that ``mask`` (slots,) marks, in row-major order,
    zeros past them: (payload (7, buf), the number that did not fit, the
    number packed)."""
    pos = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (pos < buf), pos, buf)
    out = blk.new_zeros((len(ATTRS), buf + 1))
    out.scatter_(1, dst.expand(len(ATTRS), -1), torch.where(mask, blk, 0.0))
    count = mask.sum()
    return out[:, :buf], torch.clamp(count - buf, min=0), \
        torch.clamp(count, max=buf)


def _local_rows(cfg, d, dom):
    """The local row of each live SD from its position (ijk_of_xyz on the
    global grid, clamped to the shard's columns); d.n_cell where dead."""
    g = ijk_of_xyz(cfg, d.x, None, d.z)
    i = torch.clamp(g // cfg.nz, dom.col0, dom.col0 + dom.nxl - 1)
    return torch.where(d.n > 0, (i - dom.col0) * cfg.nz + g % cfg.nz,
                       d.n_cell)


def _inject(cfg, d, dom, arr):
    """Put the arrivals ``arr`` (ATTRS' planes stacked, (7, m)) into the
    free lanes of their rows: the k-th arrival of a row (in arrival order)
    after the row's live SDs, as dense_mesh.py:125-152 does.  An arrival
    outside the shard's columns or past a full row is counted in
    ``overflow``.  The rows are classified in kernel C's float operations,
    as the serial engine's merge places them.  No host sync."""
    n_cell, cap, nz = d.n_cell, d.cap, cfg.nz
    n, x, z = arr[0], arr[ATTRS.index("x")], arr[ATTRS.index("z")]
    alive = n > 0
    i_t, k_t = column_of(cfg, x), level_of(cfg, z)
    inside = alive & (i_t >= dom.col0) & (i_t < dom.col0 + dom.nxl)
    row = torch.where(inside, ((i_t - dom.col0) * nz + k_t).long(), n_cell)
    # each arrival's rank among its row's (stable): its place in the sorted
    # rows less the first place of its row
    row_s, order = torch.sort(row, stable=True)
    rank = torch.empty_like(row)
    rank[order] = torch.arange(row.numel(), device=row.device) \
        - torch.searchsorted(row_s, row_s)
    lane = (d.n > 0).sum(1)[torch.clamp(row, max=n_cell - 1)] + rank
    ok = inside & (lane < cap)
    flat_idx = torch.where(ok, row * cap + lane, n_cell * cap)
    # the planes and a dump for the arrivals that do not land; 4 slots of
    # it keep every plane 16-byte aligned where n_cell * cap is a
    # multiple of 4
    flat = torch.nn.functional.pad(torch.stack(
        [getattr(d, a).reshape(-1) for a in ATTRS]), (0, 4))
    flat.scatter_(1, flat_idx.expand(len(ATTRS), -1), arr)
    planes = flat[:, :n_cell * cap].reshape(len(ATTRS), n_cell, cap)
    lost = (alive & ~ok).sum()
    return dataclasses.replace(
        d, overflow=d.overflow + lost.to(d.overflow.dtype),
        **dict(zip(ATTRS, planes.unbind(0))))


def rebin_sharded(cfg, shards, doms, tgts, fars, buf, *, plain=False):
    """The re-binning of the mesh after the shards' transport (see the
    module docstring; dense_mesh.py:50-152).  ``shards`` hold the positions
    after kernel C's unwrapped form, ``tgts`` its local target rows (-1
    for a droplet that leaves its shard), ``fars`` the shards' far-mover
    row counts; ``buf`` is the mover capacity a direction.  Returns (the
    shards, the number of SDs sent across slab edges, on the first shard's
    device)."""
    n_shards, nz = len(shards), cfg.nz
    cfg_l = local_config(cfg, n_shards)
    nx_pad = cfg_l.nx
    n_edge = min(2, nx_pad // 2) or 1
    out, pay_l, pay_r, sent = [], [], [], []
    for d, dom, tgt in zip(shards, doms, tgts):
        with _on(dom.device):
            n, x = d.n, d.x
            mover = (n > 0) & (tgt < 0)
            out_lo, out_hi = x < cfg.x0, x >= cfg.x1
            go_l = mover & (out_lo | (~out_hi
                                      & (column_of(cfg, x) < dom.col0)))
            go_r = mover & ~go_l
            if cfg.open_side_walls:
                # SDs leaving the global domain die (the first and the last
                # shard's); the others ride the ring
                gone = mover & (out_lo | out_hi)
                n = torch.where(gone, 0.0, n)
                go_l, go_r = go_l & ~gone, go_r & ~gone
            else:
                x = torch.where(mover & (out_lo | out_hi), wrap_x(cfg, x), x)
            planes = dict({a: getattr(d, a) for a in ATTRS}, n=n, x=x)
            edge = lambda a: _edge_rows(a, nz, dom.nxl, n_edge,
                                        dim=a.dim() - 2)
            blk = edge(torch.stack([planes[a] for a in ATTRS])).reshape(
                len(ATTRS), -1)
            blk_l, blk_r = edge(go_l).reshape(-1), edge(go_r).reshape(-1)
            p_l, ovf_l, sent_l = _pack(blk, blk_l, buf)
            p_r, ovf_r, sent_r = _pack(blk, blk_r, buf)
            # movers outside the edge blocks (a jump longer than CFL allows)
            # are dropped too, and counted
            lost_long = (go_l | go_r).sum() - blk_l.sum() - blk_r.sum()
            planes["n"] = torch.where(go_l | go_r, 0.0, n)
            d = dataclasses.replace(
                d, overflow=d.overflow + (ovf_l + ovf_r + lost_long).to(
                    d.overflow.dtype), **planes)
            if nx_pad >= 3:
                d = dense.merge(cfg_l, d, tgt, plain=plain)
        out.append(d)
        pay_l.append(p_l)
        pay_r.append(p_r)
        sent.append(sent_l + sent_r)
    # the far-mover repair (and, on slabs narrower than the merge needs,
    # the whole re-bin): one transfer reads every shard's flag
    dev0 = doms[0].device
    repair = [True] * n_shards if nx_pad < 3 else \
        (torch.stack([f.to(dev0) for f in fars]) > 0).tolist()
    for s, (dom, fix) in enumerate(zip(doms, repair)):
        d = out[s]
        with _on(dom.device):
            if fix:
                d = dense._rebin_global(cfg_l, d, _local_rows(cfg, d, dom))
            left, right = (s - 1) % n_shards, (s + 1) % n_shards
            arr = torch.cat([pay_r[left].to(dom.device),
                             pay_l[right].to(dom.device)], 1)
            out[s] = _inject(cfg, d, dom, arr)
    return out, sum(c.to(dev0) for c in sent)


def dense_step_sharded(cfg, doms, sstp_coal: int, buf: int, do_coal: bool,
                       do_sedi: bool, RH_max: float, *, coal_pairing="stride",
                       plain=False):
    """One microphysics step of the mesh (dense_mesh.py:298-332): on each
    shard condensation, coalescence and transport with x unwrapped
    (lgrngn/dense.step_fused_shard), then rebin_sharded.  ``cfg`` is the
    global configuration, ``doms`` the shards (decomp.shard_domains).
    Returns step(shards, th, rv, params, dt) -> (shards, th, rv, crossed)
    with th and rv a padded slab field a shard (pad_cell_field) and
    ``crossed`` the SDs sent across slab edges."""
    if cfg.exact_sstp_cond:
        # the mesh's payload does not carry the per-SD ambient planes
        raise NotImplementedError(
            "dense mesh: exact substepping is not supported (the JAX mesh "
            "refuses it too, dense_mesh.py:303-309)")
    if as_t(cfg.adve_scheme) == as_t.pred_corr:
        # the corrector reads the courants of any cell a droplet reaches,
        # which a shard does not hold
        raise NotImplementedError(
            "dense mesh: pred_corr SD advection is not supported (the flat "
            "mesh's halo-2 courant exchange goes with ROADMAP.md, Queue 1, "
            "\"Multi-device: the flat front\")")
    if cfg.n_dims == 3:
        # the slabs, the ring and kernel C's unwrapped form are 2-D
        raise NotImplementedError(
            "dense mesh: the 3-D grid is not supported (ROADMAP.md, Queue "
            "1, \"The dense mesh in 3-D and with the onishi kernels\"); the "
            "serial dense engine runs it")
    if cfg.coal_switch and kernel_t(cfg.kernel) in coal_mod.TURBULENT:
        # kernel E's onishi form has no shard rows (ShardRows)
        raise NotImplementedError(
            f"dense mesh: collision kernel {kernel_t(cfg.kernel).name} is "
            "not supported (ROADMAP.md, Queue 1, \"The dense mesh in 3-D and "
            "with the onishi kernels\"); the serial dense engine runs it")
    if cfg.pure_const_multi and cfg.coal_switch:
        # a const-multi population grows sstp_coal from a flag of each
        # step's coalescence, which the mesh's step does not read
        raise NotImplementedError(
            "dense mesh: coalescence of a const-multi population is not "
            "supported (its sstp_coal growth runs on one device)")
    dense.supported(cfg)
    local_config(cfg, len(doms))      # n_sd_max split evenly, as JAX's
    if buf < 1:
        raise ValueError(f"dense mesh: buf must be >= 1, got {buf}")

    def step(shards, th, rv, params, dt):
        res = []
        for d, th_s, rv_s, dom in zip(shards, th, rv, doms):
            with _on(dom.device):
                res.append(dense.step_fused_shard(
                    cfg, d, th_s, rv_s, params, dt, RH_max, sstp_coal,
                    do_coal, do_sedi, (dom.col0, dom.nxl),
                    coal_pairing=coal_pairing, plain=plain))
        shards, th, rv, tgts, fars = (list(v) for v in zip(*res))
        shards, crossed = rebin_sharded(cfg, shards, doms, tgts, fars, buf,
                                        plain=plain)
        return shards, th, rv, crossed

    return step


class MeshRunner:
    """A Kinematic2D case on the dense x-slab mesh (the counterpart of
    tools/bench_mesh.py bench_dense and of the test helper _mesh_runner,
    tests/test_dense_mesh.py:53-98).  A step is kernel A on the global th
    and rv, as the JAX runner does, the fields padded to the slabs, the
    shards' step (dense_step_sharded) and the fields unpadded into the
    model; spin-up steps run without coalescence and sedimentation, with
    RH capped at 1.01, as Kinematic2D.run_device_lgrngn's do.  The
    population starts as the model's dense_state.  Every shard is on the
    model's device; ``buf`` defaults to every slot of a column's rows,
    which no move under CFL <= 1 overfills."""

    def __init__(self, model, n_shards=8, buf=None):
        self.model = model
        self.cfg = cfg = model.cfg
        self.doms = shard_domains(cfg, make_mesh(n_shards, model.device))
        d = model.dense_state
        self.buf = buf or cfg.nz * d.cap
        self._steps = {}
        self.load(d, model.th, model.rv)

    def load(self, d, th, rv):
        """Start from the global population ``d`` and the fields th, rv;
        the crossing count starts at 0."""
        self.shards = scatter_dense(self.cfg, d, self.doms)
        self.model.th, self.model.rv = th, rv
        self.crossed = torch.zeros((), dtype=torch.int64,
                                   device=self.doms[0].device)

    def _step_fn(self, spinup, plain):
        key = (spinup, plain)
        if key not in self._steps:
            m, cfg = self.model, self.cfg
            self._steps[key] = dense_step_sharded(
                cfg, self.doms, cfg.sstp_coal, self.buf,
                m._does_coal(spinup), (not spinup) and cfg.sedi_switch,
                1.01 if spinup else 44.0, coal_pairing=m.coal_pairing,
                plain=plain)
        return self._steps[key]

    def step(self, spinup=False, *, plain=False):
        m, cfg, doms = self.model, self.cfg, self.doms
        th, rv = mpdata.advect2(m.th, m.rv, m.gc_x, m.gc_z, m.G,
                                n_iters=m.mpdata_iters, fct=m.fct,
                                plain=plain)
        self.shards, th_s, rv_s, crossed = self._step_fn(spinup, plain)(
            self.shards, pad_cell_field(cfg, th.reshape(-1), doms),
            pad_cell_field(cfg, rv.reshape(-1), doms),
            m.opts_init.kernel_parameters, m.setup.dt)
        m.th = unpad_cell_field(cfg, th_s, doms).reshape(cfg.nx, cfg.nz)
        m.rv = unpad_cell_field(cfg, rv_s, doms).reshape(cfg.nx, cfg.nz)
        self.crossed = self.crossed + crossed

    def run(self, nt, spinup=0, *, plain=False):
        """``nt`` steps, the first ``spinup`` of them spin-up steps."""
        for i in range(nt):
            self.step(i < spinup, plain=plain)

    def state(self) -> DenseState:
        """The population as one global DenseState (gather_state)."""
        return gather_state(self.cfg, self.shards, self.doms)
