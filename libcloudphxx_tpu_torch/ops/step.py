"""The resident microphysics step and the re-binning merge
(libcloudphxx_tpu/ops/pallas_step.py: step_resident, rebin_x).

The TPU runs the step as one Pallas kernel over row blocks
(pallas_step._kernel) plus the x pass of the re-binning
(pallas_step._xmerge_kernel).  On the card the same work runs as four
hand-written kernels, each beside its plain PyTorch version:

  kernel B  csrc/cond.cu       cond / cond_plain: condensation substeps;
            with a pending merge (``pending_tgt``) its merge-prologue form,
            csrc/cond_merged.cu / cond_merged_plain: the previous step's
            re-binning (kernel D's row code), then the condensation of the
            merged rows
  kernel E  csrc/coal.cu       ops/coal.coal_resident: coalescence substeps
  kernel C  csrc/transport.cu  transport / transport_plain: vt refresh,
            advection, sedimentation, subsidence, walls, puddle partials,
            and the target cell of every droplet (or the vt refresh alone);
            with a ``slab`` the unwrapped form a shard of the x-slab mesh
            runs; on the 3-D grid (``y3``) the 3-D forms, which also advect
            and wrap y (csrc/transport3d.cu, bricks of rows streamed by
            persistent blocks: transport3d_plan)
  kernel D  csrc/merge.cu      rebin_x / rebin_x_plain: each row takes its
            droplets from itself and its eight neighbours (the z and the x
            pass of the re-binning at once); seven planes, or eleven with
            the exact mode's private ambient planes; on the 3-D grid
            (csrc/merge3d.cu, a brick of rows a block: merge3d_plan)
            from itself and its 26 neighbours, x and y periodic, with the
            y plane riding: eight planes, or twelve;
            with ``mpdata`` its MPDATA-epilogue form, csrc/merge_mpdata.cu:
            a cluster of CTAs more a field advects the next step's th and
            rv

Dispatch is by device: CPU tensors run the plain version, CUDA tensors
launch the kernel (float32, contiguous, or the wrapper raises), and
``plain=True`` runs the plain version on any device, for comparisons and
timings.  Layout: SD planes (n_cell, cap), row i*nz + k holding cell
(i, k), or on the 3-D grid row (i*ny + j)*nz + k holding cell (i, j, k);
cell fields (n_cell,).
"""

import functools
from typing import NamedTuple

import torch

from .. import _ext
from ..common import constants as c
from ..common import theta_dry
from ..lgrngn.condensation import _advance_rw2_core, _root_iters
from ..lgrngn.enums import as_t, vt_t
from ..lgrngn.hskpng import hskpng_Tpr
from ..lgrngn.vterm import vt_in_kernel
from . import coal as coal_ops
from .compact import stable_partition_rows

# source rows of the merge, as (di, dk) offsets in this order: own row,
# the z neighbours, then the columns to the left and to the right
MERGE_SOURCES = ((0, 0), (0, -1), (0, 1), (-1, 0), (-1, -1), (-1, 1),
                 (1, 0), (1, -1), (1, 1))
# on the 3-D grid, (di, dj, dk) in this order: dk innermost, then dj, then
# di, each 0, -1, 1 (the own row first)
MERGE_SOURCES_3D = tuple((di, dj, dk) for di in (0, -1, 1)
                         for dj in (0, -1, 1) for dk in (0, -1, 1))
# rebin_x_plain's candidate slots a block of destination rows
MERGE_BLOCK = 1 << 25
# kernel D's 3-D forms: at most MERGE3D_MAX_BRICK destination rows (warps)
# a block (csrc/merge3d.cuh kMaxBrick).  An H100 SM gives its blocks
# SM_SHARED bytes of shared memory, BLOCK_RESERVED of them each block's
# own, and a block at most BLOCK_SHARED.
MERGE3D_MAX_BRICK = 16
SM_SHARED = 233_472
BLOCK_SHARED = 232_448
BLOCK_RESERVED = 1_024


# kernel C's 3-D forms (csrc/transport3d.cuh): warps a block (a row each
# at a time), the rows a warp's prefetch of n runs ahead, the floats of a
# row's cell fields in its ring slot, the slots of a warp's rows in a
# brick, and the blocks an SM the launch bounds keep; an H100 has H100_SMS
# SMs
C3D_WARPS, C3D_AHEAD, C3D_FIELDS, C3D_SLOTS, C3D_MIN_BLOCKS = 8, 2, 16, 512, 3
H100_SMS = 132


class Transport3dPlan(NamedTuple):
    """The launch of kernel C's 3-D forms in the 16-byte layout: bricks of
    ``brick`` consecutive rows (C3D_WARPS warps, warp w on the brick's rows
    w, w + C3D_WARPS, ...), ``blocks`` persistent blocks walking the bricks
    b, b + blocks, ..., ``smem`` bytes of dynamic shared memory a block."""
    brick: int
    blocks: int
    smem: int


def transport3d_smem(cap):
    """csrc/transport3d.cuh c3_smem: each warp's ring of C3D_AHEAD + 1 rows
    (n, then the row's C3D_FIELDS fields, 4 bytes each), then its list of
    live slots (2 bytes a slot)."""
    return C3D_WARPS * ((C3D_AHEAD + 1) * (cap + C3D_FIELDS) * 4 + 2 * cap)


def transport3d_plan(cap, n_cell, resident=None):
    """Kernel C's 3-D forms' plan at row capacity ``cap`` (a multiple of
    128: the 16-byte layout) on ``n_cell`` rows: bricks of C3D_WARPS x
    max(1, C3D_SLOTS / cap) rows (32 at cap 128, 8 from cap 512), and as
    many blocks as the card holds at once, ``resident`` (an H100's SMs
    times the blocks an SM by shared memory, at most C3D_MIN_BLOCKS, where
    not given), but no more than there are bricks.  Raises for a capacity
    no block holds."""
    cap, n_cell = int(cap), int(n_cell)
    smem = transport3d_smem(cap)
    if cap < 128 or cap % 128 or smem > BLOCK_SHARED or n_cell < 1:
        raise ValueError(
            f"transport: no 3-D streaming plan at capacity {cap} on {n_cell} "
            f"rows: a multiple of 128 whose {smem} bytes of shared memory "
            f"fit a block's {BLOCK_SHARED}")
    brick = C3D_WARPS * max(1, C3D_SLOTS // cap)
    if resident is None:
        resident = H100_SMS * max(1, min(
            C3D_MIN_BLOCKS, SM_SHARED // (smem + BLOCK_RESERVED)))
    bricks = -(-n_cell // brick)
    return Transport3dPlan(brick, max(1, min(bricks, int(resident))), smem)


@functools.lru_cache(maxsize=None)
def card_transport3d(pc, vt, cap):
    """Blocks of kernel C's 3-D streaming kernel (the pred_corr form's with
    ``pc``) under formula ``vt`` the card holds at once at capacity
    ``cap``: its blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    after cudaFuncSetAttribute takes the dynamic shared memory) times the
    SMs.  Raises where no block fits an SM."""
    try:
        a = _ext.attributes("lcp_transport_3d_attrs", vt, int(pc), cap)
    except RuntimeError as e:
        raise ValueError(f"transport: the card refuses the 3-D streaming "
                         f"kernel at capacity {cap}: {e}") from None
    if a["blocks_per_sm"] < 1:
        raise ValueError(f"transport: no block of the 3-D streaming kernel "
                         f"at capacity {cap} fits an SM")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return a["blocks_per_sm"] * sms


def _rows(cfg, n_cell, like, col0=0):
    """Each row's column (from ``col0``) and level, as (n_cell, 1) planes of
    ``like``'s dtype."""
    r = torch.arange(n_cell, device=like.device)
    return (r // cfg.nz + col0).to(like.dtype)[:, None], \
        (r % cfg.nz).to(like.dtype)[:, None]


def _rows3(cfg, n_cell, like):
    """Each row's (i, j, k) on the 3-D grid, as (n_cell, 1) planes of
    ``like``'s dtype."""
    r = torch.arange(n_cell, device=like.device)
    f = lambda a: a.to(like.dtype)[:, None]
    return f(r // (cfg.ny * cfg.nz)), f((r // cfg.nz) % cfg.ny), \
        f(r % cfg.nz)


def _wrap(a0, a1, x):
    w = a1 - a0
    q = x - a0
    return a0 + (q - torch.floor(q / torch.full((), w, dtype=x.dtype,
                                               device=x.device)) * w)


def wrap_x(cfg, x):
    """x wrapped into [x0, x1) by the periodic side walls, in kernel C's
    float operations."""
    return _wrap(cfg.x0, cfg.x1, x)


def wrap_y(cfg, y):
    """y wrapped into [y0, y1) by the periodic side walls (3-D), as
    wrap_x."""
    return _wrap(cfg.y0, cfg.y1, y)


def column_of(cfg, x):
    """The grid column of each position, clamped to [0, nx), in kernel
    C's float operations (the grid starts at 0, not at x0)."""
    dx = torch.full((), cfg.dx, dtype=x.dtype, device=x.device)
    return torch.clamp(torch.floor(x / dx), 0, cfg.nx - 1)


def level_of(cfg, z):
    """The grid level of each position, clamped to [0, nz), as
    column_of."""
    dz = torch.full((), cfg.dz, dtype=z.dtype, device=z.device)
    return torch.clamp(torch.floor(z / dz), 0, cfg.nz - 1)


def row_of_y(cfg, y):
    """The j index of each y on the 3-D grid, clamped to [0, ny), as
    column_of."""
    dy = torch.full((), cfg.dy, dtype=y.dtype, device=y.device)
    return torch.clamp(torch.floor(y / dy), 0, cfg.ny - 1)


def _slab(cfg, n_cell, slab):
    """(col0, ncol) of a mesh shard's ``slab``, checked; (0, nx) for
    None."""
    if slab is None:
        return 0, cfg.nx
    col0, ncol = (int(v) for v in slab)
    if n_cell % cfg.nz or col0 < 0 or not 1 <= ncol <= n_cell // cfg.nz:
        raise ValueError(f"transport: slab ({col0}, {ncol}) does not fit "
                         f"{n_cell} rows of {cfg.nz} levels")
    return col0, ncol


# ---------------------------------------------------------------- kernel B
def cond_plain(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv, rvadv,
               th0, rv0, rhod, dv, lam_D, lam_K, p0):
    """Percell substepped condensation of every row (pallas_step.py:191-231
    with the closure after the loop).  th0/rv0 are the cell values saved at
    the previous step's end, thadv/rvadv the advected ones; the advective
    increment enters in sstp_cond equal parts.  Returns
    (rw2, th, rv, T, p, RH, eta)."""
    col = lambda a: a[:, None]
    dth = (thadv - th0) / sstp_cond
    drv = (rvadv - rv0) / sstp_cond
    dt_sub = dt / sstp_cond
    wgt = n * ((4.0 / 3) * c.pi * c.rho_w) / col(dv * rhod)
    # the vt plane of the previous step's end, rebuilt from the cell state
    # it was computed from (pallas_step.py:203-210)
    T0, p_prev, _RH0, eta_prev = hskpng_Tpr(cfg, th0, rv0, rhod, p0)
    vt = vt_in_kernel(cfg, rw2, col(T0), col(p_prev), col(rhod), col(eta_prev))
    th, rv = th0, rv0
    for _ in range(sstp_cond):
        th = th + dth
        rv = rv + drv
        T, p, RH, eta = hskpng_Tpr(cfg, th, rv, rhod, p0)
        rw2n = _advance_rw2_core(
            dt_sub, rw2, rd3, kpa, vt, col(rhod), col(rv), col(T), col(p),
            col(RH), col(eta), col(lam_D), col(lam_K), RH_max)
        drw3 = rw2n * torch.sqrt(rw2n) \
            - rw2 * torch.sqrt(torch.clamp(rw2, min=0.0))
        # the row sum accumulates in float64 (as the kernel does), so the
        # summation order of kernel and plain version drops out
        dcell = -torch.sum(wgt * drw3, dim=1, dtype=torch.float64).to(th.dtype)
        th, rv = th + dcell * theta_dry.d_th_d_rv(T, th), rv + dcell
        rw2 = rw2n
    T, p, RH, eta = hskpng_Tpr(cfg, th, rv, rhod, p0)
    return rw2, th, rv, T, p, RH, eta


def cond_merged_plain(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, vt, x,
                      z, tgt, thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K,
                      p0):
    """The plain version of kernel B's merge-prologue form: the pending
    merge of the planes n ... z by their targets ``tgt`` (rebin_x_plain),
    then cond_plain on the merged rows.  Returns cond_plain's seven, then
    the merged (n, rw2, rd3, kpa, vt, x, z) and the drops a row."""
    merged = rebin_x_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt)
    n_m, rw2_m, rd3_m, kpa_m = merged[:4]
    return cond_plain(cfg, sstp_cond, dt, RH_max, n_m, rw2_m, rd3_m, kpa_m,
                      thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K,
                      p0) + tuple(merged)


def cond(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv, rvadv, th0,
         rv0, rhod, dv, lam_D, lam_K, p0, *, pending_tgt=None, vt=None,
         x=None, z=None, plain=False):
    """Kernel B, or its plain version cond_plain (same arguments and
    results).  With ``pending_tgt``, the int32 target row of every slot of
    a step whose re-binning was deferred (lgrngn/dense.DenseState
    .pending_tgt), the planes n, rw2, rd3, kpa and ``vt``, ``x``, ``z``
    are that step's, before the merge: kernel B's merge-prologue form
    (_ext.COND_MERGED; the TPU kernel's deferred-x prologue) merges each
    row first, with kernel D's row code, and condenses the merged row, or
    its plain version cond_merged_plain (same results: cond's seven, then
    the merged seven planes and the drops a row)."""
    if pending_tgt is not None:
        return _cond_merged(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa,
                            vt, x, z, pending_tgt, thadv, rvadv, th0, rv0,
                            rhod, dv, lam_D, lam_K, p0, plain)
    args = (n, rw2, rd3, kpa, thadv, rvadv, th0, rv0, rhod, dv, lam_D,
            lam_K, p0)
    if _ext.use_plain("cond", n, plain):
        return cond_plain(cfg, sstp_cond, dt, RH_max, *args)
    return _launch_cond(_ext.COND, cfg, sstp_cond, dt, RH_max, *args)


def _cond_merged(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, vt, x, z, tgt,
                 thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0, plain):
    """cond with a pending merge: kernel B's merge-prologue form or
    cond_merged_plain."""
    if any(a is None for a in (vt, x, z)):
        raise ValueError("cond: a pending merge needs the planes vt, x, z")
    if cfg.n_dims != 2 or cfg.nx < 3:
        raise ValueError("cond: the merge-prologue form needs the 2-D grid "
                         "with nx >= 3")
    fields = (thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0)
    if _ext.use_plain("cond_merged", n, plain):
        return cond_merged_plain(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa,
                                 vt, x, z, tgt, *fields)
    planes = (n, rw2, rd3, kpa, vt, x, z)
    _ext.check_planes("cond_merged", n.shape[1], *planes, tgt)
    _ext.check("cond_merged", *planes)
    _ext.check("cond_merged", tgt, dtype=torch.int32)
    merged = tuple(torch.empty_like(p) for p in planes)
    drops = torch.empty(n.shape[0], dtype=n.dtype, device=n.device)
    return _launch_cond(
        _ext.COND_MERGED, cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa,
        *fields, vt.data_ptr(), x.data_ptr(), z.data_ptr(), tgt.data_ptr(),
        *(m.data_ptr() for m in merged), drops.data_ptr(), cfg.nx,
        cfg.nz) + merged + (drops,)


def _launch_cond(kernel, cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv,
                 rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0, *form):
    """Check kernel B's four planes and nine cell fields, launch ``kernel``
    (a form of B) on them with the form's own arguments ``form`` after
    B's, and return (rw2, th, rv, T, p, RH, eta)."""
    name = kernel.name
    n_cell, cap = n.shape
    _ext.check_planes(name, cap, n, rw2, rd3, kpa)
    fields = (thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0)
    if any(a.shape != (n_cell,) for a in fields):
        raise ValueError(f"{name}: cell fields must be ({n_cell},)")
    cells = torch.stack(fields)
    _ext.check(name, n, rw2, rd3, kpa, cells)
    if n.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 - 1 SD lanes")
    rw2_out = torch.empty_like(rw2)
    cells_out = torch.empty((6, n_cell), dtype=n.dtype, device=n.device)
    pos, buf = _ext.cond_scratch(n.numel(), n.device)
    # the rows fullest first; under a pending merge as they were before it:
    # a step moves few droplets between rows, and a count of the targets
    # (an index_add's atomics, or bincount's wait for the card) costs more
    # than the order saves
    order = _ext.longest_first((n > 0).sum(1))
    kernel.launch(
        n.data_ptr(), rw2.data_ptr(), rd3.data_ptr(), kpa.data_ptr(),
        cells.data_ptr(), rw2_out.data_ptr(), cells_out.data_ptr(),
        pos.data_ptr(), buf.data_ptr(), order.data_ptr(), n_cell, cap,
        int(sstp_cond), dt / sstp_cond, float(RH_max), int(cfg.th_dry),
        int(cfg.const_p), int(cfg.RH_formula), _root_iters(n.dtype),
        vt_t(cfg.terminal_velocity).value, *form)
    return (rw2_out,) + tuple(cells_out.unbind(0))


# ---------------------------------------------------------------- kernel C
def _cell_of(pos, d, n):
    """The cell index along an axis of each position, as
    lgrngn/hskpng.ijk_of_xyz computes it (a float64 division, the floor
    clamped to [0, n)), dividing by a tensor (see transport_plain)."""
    q = pos.to(torch.float64) / torch.full((), d, dtype=torch.float64,
                                           device=pos.device)
    return torch.clamp(torch.floor(q).to(torch.int64), 0, n - 1)


def halo_column(cfg, i, col0, ncol):
    """A global column ``i`` as a column of a shard's halo-2 layout
    (parallel/decomp.xchng_courants_pc): i - col0, taken modulo nx into
    [-2, ncol + 1] (the ring's halo holds the columns across the periodic
    wrap), clamped there."""
    li = i - col0
    li = torch.where(li < -2, li + cfg.nx,
                     torch.where(li > ncol + 1, li - cfg.nx, li))
    return torch.clamp(li, -2, ncol + 1)


def pred_corr(cfg, x, z, i_row, k_row, C_l, C_r, C_b, C_a, courants,
              yax=None, slab=None):
    """The predictor-corrector SD advection of a row's droplets
    (libcloudphxx_tpu/lgrngn/dense.py:962-1005, the port's flat
    transport.adve; reference adve.ipp:184-304): the euler predictor with
    the row's courants, z kept inside the domain, x (and y) wrapped with
    its old position shifted alike (unless the side walls are open), then
    the mean of the two displacements, the corrector's taken with the
    courants of the predictor's cell, gathered from the staggered
    ``courants`` = (courant_x (nx+1)*ny*nz, courant_z nx*ny*(nz+1)[,
    courant_y nx*(ny+1)*nz]) with transport.courant_indices' index math.
    On the 3-D grid ``yax`` = (y, j_row, C_f, C_h).  On a shard of the
    x-slab mesh (``slab`` = (col0, ncol)) ``courants`` are the shard's in
    the halo-2 layout of parallel/decomp.xchng_courants_pc (x faces from
    -2, z columns from -2), read at the predictor's halo_column.  Returns
    (x, z), or (x, z, y) with ``yax``."""
    dCx, dCz = (C_r - C_l)[:, None], (C_a - C_b)[:, None]
    x_old, z_old = x, z
    x = x + dCx * (x - cfg.dx * i_row) + cfg.dx * C_l[:, None]
    z = z + dCz * (z - cfg.dz * k_row) + cfg.dz * C_b[:, None]
    if yax is not None:
        y, j_row, C_f, C_h = yax
        y_old = y
        y = y + (C_h - C_f)[:, None] * (y - cfg.dy * j_row) \
            + cfg.dy * C_f[:, None]
    z = torch.clamp(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    if not cfg.open_side_walls:
        x_wr = wrap_x(cfg, x)
        x_old = x_old + (x_wr - x)
        x = x_wr
        if yax is not None:
            y_wr = wrap_y(cfg, y)
            y_old = y_old + (y_wr - y)
            y = y_wr
    cx, cz = courants[:2]
    i_m, k_m = _cell_of(x, cfg.dx, cfg.nx), _cell_of(z, cfg.dz, cfg.nz)
    if slab is not None:
        li = halo_column(cfg, i_m, *slab) + 2
        lft, blw = li * cfg.nz + k_m, li * (cfg.nz + 1) + k_m
        rgt = lft + cfg.nz
    elif yax is None:
        lft = i_m * cfg.nz + k_m
        rgt, blw = lft + cfg.nz, lft + i_m
    else:
        j_m = _cell_of(y, cfg.dy, cfg.ny)
        lft = (i_m * cfg.ny + j_m) * cfg.nz + k_m
        rgt, blw = lft + cfg.ny * cfg.nz, lft + i_m * cfg.ny + j_m
    dx_ = (cx[rgt] - cx[lft]) * (x - cfg.dx * i_m.to(x.dtype)) \
        + cfg.dx * cx[lft]
    dz_ = (cz[blw + 1] - cz[blw]) * (z - cfg.dz * k_m.to(z.dtype)) \
        + cfg.dz * cz[blw]
    x, z = (x + x_old + dx_) / 2.0, (z + z_old + dz_) / 2.0
    if yax is None:
        return x, z
    cy = courants[2]
    fre = lft + i_m * cfg.nz
    dy_ = (cy[fre + cfg.nz] - cy[fre]) * (y - cfg.dy * j_m.to(y.dtype)) \
        + cfg.dy * cy[fre]
    return x, z, (y + y_old + dy_) / 2.0


def transport_plain(cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta,
                    C_l, C_r, C_b, C_a, *, do_adve=True, w_cells=None,
                    slab=None, courants=None, y3=None):
    """vt refresh, SD advection, sedimentation, subsidence, walls and
    puddle, then each droplet's target row (pallas_step.py:338-487).
    ``do_adve`` moves the droplets with the courants C_* (under pred_corr
    also with the staggered ``courants`` = (courant_x, courant_z[,
    courant_y]): see pred_corr), ``do_sedi`` by their vt, and ``w_cells``
    (n_cell,), when given, is the subsidence velocity of each row
    (pallas_step.py:369-370).
    Returns (n, x, z, vt, tgt, rowinfo): ``tgt`` is the int32 target row (-1 for dead slots; a
    droplet that moved more than one cell on an axis keeps its row and sets
    the row's flag), ``rowinfo`` (n_cell, 8) the per-row puddle partials
    (liquid volume, dry volume, liquid number, particle number) and
    far-mover flag.  A slot dead at load (n == 0) comes out with n = x = z
    = vt = 0 and target -1, as kernel C writes it; the merge reads only the
    slots it takes, so no droplet sees that.  With no transport at all (no
    advection, sedimentation or subsidence) only vt is refreshed: n, x and
    z come back as they went in, and tgt and rowinfo are None.

    On the 3-D grid ``y3`` = (y, C_f, C_h), the y plane and each row's
    front and hind courants (libcloudphxx_tpu/lgrngn/dense.py:918-1030):
    y is advected by the scheme of x, wrapped by the periodic side walls
    or killed beyond the open ones, the target row is (i*ny + j)*nz + k,
    and a move by more than one cell in y (the wrap aside) is a far move;
    the result has y after the six.

    With a ``slab`` = (col0, ncol) it is the unwrapped form a shard of the
    x-slab mesh runs (the TPU kernel's x_wrap=False, pallas_step.py:378-382;
    parallel/dense_mesh.py): the rows are the global columns col0 .. col0 +
    n_cell / nz - 1 of ``cfg``'s grid, the first ncol of them the shard's
    own; x stays unwrapped,
    the open side walls do not kill, and a droplet outside the shard's
    columns or outside [x0, x1) gets target -1 and no far flag (the mesh
    moves it).  The targets are local rows; the near test has no x-wrap
    clause.  Under pred_corr the slab form reads ``courants`` in the
    halo-2 layout (pred_corr) and wraps x as the serial form does, so
    that the positions are the serial engine's; a droplet that moved
    across the periodic wrap leaves too (on one shard its column is the
    shard's own)."""
    n_cell, cap = n.shape
    col0, ncol = _slab(cfg, n_cell, slab)
    three = y3 is not None
    if three and slab is not None:
        raise ValueError("transport: the 3-D grid has no unwrapped form")
    live0 = n > 0
    col = lambda a: a[:, None]
    # divisions by a tensor, not a Python number: on the card PyTorch
    # turns those into multiplications by the reciprocal, which would
    # classify a droplet on a cell face differently from the kernel
    full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)
    if three:
        y, C_f, C_h = y3
        i_row, j_row, k_row = _rows3(cfg, n_cell, x)
    else:
        i_row, k_row = _rows(cfg, n_cell, x, col0)
    vt = vt_in_kernel(cfg, rw2, col(T), col(p), col(rhod), col(eta))
    if not (do_adve or do_sedi or w_cells is not None):
        if slab is not None:
            raise ValueError("transport: a slab needs some transport")
        return (n, x, z, torch.where(live0, vt, 0.0), None, None) \
            + ((y,) if three else ())

    scheme = as_t(cfg.adve_scheme)
    pc = do_adve and scheme == as_t.pred_corr
    if pc:
        x, z, *yy = pred_corr(cfg, x, z, i_row, k_row, C_l, C_r, C_b, C_a,
                              courants,
                              (y, j_row, C_f, C_h) if three else None,
                              slab=slab)
        y = yy[0] if three else None
    elif do_adve:
        dCx = col(C_r - C_l)
        dCz = col(C_a - C_b)
        dCy = col(C_h - C_f) if three else None
        if scheme == as_t.implicit:
            x = (x + cfg.dx * (col(C_l) - i_row * dCx)) / (1.0 - dCx)
            z = (z + cfg.dz * (col(C_b) - k_row * dCz)) / (1.0 - dCz)
            if three:
                y = (y + cfg.dy * (col(C_f) - j_row * dCy)) / (1.0 - dCy)
        else:  # euler
            x = x + dCx * (x - cfg.dx * i_row) + cfg.dx * col(C_l)
            z = z + dCz * (z - cfg.dz * k_row) + cfg.dz * col(C_b)
            if three:
                y = y + dCy * (y - cfg.dy * j_row) + cfg.dy * col(C_f)
    if do_sedi:
        z = z - dt * vt
    if w_cells is not None:
        z = z - dt * col(w_cells)

    if slab is None:      # else the mesh's re-binning wraps or kills
        if cfg.open_side_walls:
            n = torch.where((x >= cfg.x1) | (x < cfg.x0), 0.0, n)
        else:
            x = wrap_x(cfg, x)
    elif pc and not cfg.open_side_walls:
        x = wrap_x(cfg, x)
    if three:
        if cfg.open_side_walls:
            n = torch.where((y >= cfg.y1) | (y < cfg.y0), 0.0, n)
        else:
            y = wrap_y(cfg, y)
    zero = torch.zeros(n_cell, dtype=n.dtype, device=n.device)
    liq_vol = dry_vol = liq_num = prt_num = zero
    if cfg.periodic_topbot_walls:
        w = cfg.z1 - cfg.z0
        q = z - cfg.z0
        z = cfg.z0 + (q - torch.floor(q / full(w)) * w)
    else:
        n = torch.where(z >= cfg.z1, 0.0, n)
        fell = (z < cfg.z0) & (n > 0)
        nf = torch.where(fell, n, 0.0)
        vol_c = 4.0 / 3 * c.pi
        liq_vol = torch.sum(
            vol_c * nf * rw2 * torch.sqrt(torch.clamp(rw2, min=0.0)), dim=1)
        dry_vol = torch.sum(vol_c * nf * rd3, dim=1)
        liq_num = torch.sum(torch.where(rw2 > 0, nf, 0.0), dim=1)
        prt_num = torch.sum(nf, dim=1)
        n = torch.where(fell, 0.0, n)

    alive = n > 0
    k_t = level_of(cfg, z)
    i_t = column_of(cfg, x)
    dk = k_t - k_row
    di = i_t - i_row
    near_x = (di == 0.0) | (di == 1.0) | (di == -1.0)
    if slab is None:
        wrap = float(cfg.nx - 1)
        near_x = near_x | (di == wrap) | (di == -wrap)
    else:
        leaves = (x < cfg.x0) | (x >= cfg.x1) | (i_t < col0) \
            | (i_t >= col0 + ncol)
        wrap = float(cfg.nx - 1)
        if pc and not cfg.open_side_walls and wrap > 1.0:
            leaves = leaves | (di == wrap) | (di == -wrap)
        alive = alive & ~leaves
    near = (torch.abs(dk) <= 1.0) & near_x
    if three:
        j_t = row_of_y(cfg, y)
        dj = j_t - j_row
        wrap_j = float(cfg.ny - 1)
        near = near & ((dj == 0.0) | (dj == 1.0) | (dj == -1.0)
                       | (dj == wrap_j) | (dj == -wrap_j))
        cell = (i_t * cfg.ny + j_t) * cfg.nz + k_t
    else:
        cell = (i_t - col0) * cfg.nz + k_t
    rows = torch.arange(n_cell, device=n.device, dtype=torch.int32)[:, None]
    tgt = torch.where(near, cell.to(torch.int32), rows)
    tgt = torch.where(alive, tgt, -1)
    far = (alive & ~near).any(dim=1).to(n.dtype)
    rowinfo = torch.stack([liq_vol, dry_vol, liq_num, prt_num, far,
                           zero, zero, zero], dim=1)
    n, x, z, vt = (torch.where(live0, a, 0.0) for a in (n, x, z, vt))
    return (n, x, z, vt, tgt, rowinfo) + (
        (torch.where(live0, y, 0.0),) if three else ())


def transport(cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta, C_l,
              C_r, C_b, C_a, *, do_adve=True, w_cells=None, slab=None,
              courants=None, y3=None, plain=False):
    """Kernel C, or its plain version transport_plain (same arguments and
    results); with a ``slab`` kernel C's unwrapped form, counted as
    _ext.TRANSPORT_UNWRAPPED; advecting under pred_corr its pred_corr
    form, counted as _ext.TRANSPORT_PRED_CORR, which reads ``courants``,
    and with a ``slab`` too its pred_corr form on a shard,
    _ext.TRANSPORT_PRED_CORR_UNWRAPPED, which reads them in the halo-2
    layout; on the 3-D grid (``y3``) its 3-D forms, _ext.TRANSPORT_3D and
    _ext.TRANSPORT_3D_PRED_CORR."""
    pc = do_adve and as_t(cfg.adve_scheme) == as_t.pred_corr
    if pc and courants is None:
        raise ValueError("transport: pred_corr needs the staggered courants")
    kw = dict(do_adve=do_adve, w_cells=w_cells, slab=slab,
              courants=courants, y3=y3)
    args = (n, rw2, rd3, x, z, T, p, rhod, eta, C_l, C_r, C_b, C_a)
    if _ext.use_plain("transport", n, plain):
        return transport_plain(cfg, dt, do_sedi, *args, **kw)
    n_cell, cap = n.shape
    moves = do_adve or do_sedi or w_cells is not None
    col0, ncol = _slab(cfg, n_cell, slab)
    if not moves and slab is not None:
        raise ValueError("transport: a slab needs some transport")
    three = y3 is not None
    if three and slab is not None:
        raise ValueError("transport: the 3-D grid has no unwrapped form")
    y, C_f, C_h = y3 if three else (None, None, None)
    _ext.check_planes("transport", cap, n, rw2, *((rd3, x, z) if moves
                                                   else ()),
                      *((y,) if three and moves else ()))
    # the subsidence row only where there is subsidence: the kernel reads
    # it with do_subs alone; the 3-D forms read C_f and C_h after C_a
    cells = torch.stack([T, p, rhod, eta, C_l, C_r, C_b, C_a]
                        + ([C_f, C_h] if three else [])
                        + ([w_cells] if w_cells is not None else []))
    if cells.shape[1:] != (n_cell,):
        raise ValueError(f"transport: cell fields must be ({n_cell},)")
    _ext.check("transport", n, rw2, *((rd3, x, z) if moves else ()),
               *((y,) if three and moves else ()), cells)
    vt_out = torch.empty_like(n)
    if moves:
        n_out, x_out, z_out = (torch.empty_like(n) for _ in range(3))
        y_out = torch.empty_like(n) if three else None
        tgt = torch.empty((n_cell, cap), dtype=torch.int32, device=n.device)
        rowinfo = torch.empty((n_cell, 8), dtype=n.dtype, device=n.device)
        ptr = lambda a: a.data_ptr()
    else:
        n_out, x_out, z_out, y_out, tgt, rowinfo = n, x, z, y, None, None
        ptr = lambda a: None
    if three:
        kernel = _ext.TRANSPORT_3D_PRED_CORR if pc else _ext.TRANSPORT_3D
        plan = (C3D_WARPS, 1)       # the scalar layout's: unused
        if cap % 128 == 0:
            vt = vt_t(cfg.terminal_velocity).value
            plan = transport3d_plan(cap, n_cell,
                                    card_transport3d(pc, vt, cap))[:2]
        extra = (ptr(y), ptr(y_out), cfg.ny, cfg.dy, cfg.y0, cfg.y1) + plan
    else:
        kernel, extra = (_ext.TRANSPORT, ()) if slab is None else \
            (_ext.TRANSPORT_UNWRAPPED, (col0, ncol))
        if pc:
            kernel = _ext.TRANSPORT_PRED_CORR if slab is None else \
                _ext.TRANSPORT_PRED_CORR_UNWRAPPED
    if pc:
        cx, cz = courants[:2]
        shapes = ((cfg.nx + 1) * cfg.ny * cfg.nz,
                  cfg.nx * cfg.ny * (cfg.nz + 1))
        if slab is not None:  # the halo-2 layout (xchng_courants_pc)
            nx_pad = n_cell // cfg.nz
            shapes = ((nx_pad + 6) * cfg.nz, (nx_pad + 4) * (cfg.nz + 1))
        if three:
            cy = courants[2]
            shapes += (cfg.nx * (cfg.ny + 1) * cfg.nz,)
        if tuple(a.shape for a in courants) != tuple((k,) for k in shapes):
            raise ValueError("transport: courants must be the staggered "
                             "(nx+1)*ny*nz, nx*ny*(nz+1) (and 3-D "
                             "nx*(ny+1)*nz) fields, on a slab in the halo-2 "
                             "layout")
        _ext.check("transport", n, *courants)
        extra += (cx.data_ptr(), cz.data_ptr()) + (
            (cy.data_ptr(),) if three else ())
    kernel.launch(
        n.data_ptr(), rw2.data_ptr(), ptr(rd3), ptr(x), ptr(z),
        cells.data_ptr(), ptr(n_out), ptr(x_out), ptr(z_out),
        vt_out.data_ptr(), ptr(tgt), ptr(rowinfo), n_cell, cap, cfg.nx,
        cfg.nz, cfg.dx, cfg.dz, float(dt), cfg.x0, cfg.x1, cfg.z0, cfg.z1,
        int(as_t(cfg.adve_scheme) == as_t.implicit), int(do_adve),
        int(do_sedi), int(w_cells is not None), int(cfg.open_side_walls),
        int(cfg.periodic_topbot_walls), vt_t(cfg.terminal_velocity).value,
        *extra)
    return (n_out, x_out, z_out, vt_out, tgt, rowinfo) + (
        (y_out,) if three else ())


def step_resident(cfg, sstp_cond, dt, RH_max, do_sedi, n, rw2, rd3, kpa, x,
                  z, thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, C_l, C_r,
                  C_b, C_a, p0, *, do_cond=True, do_coal=False, do_adve=True,
                  w_cells=None, params=(), sstp_coal=1, rng=(0, 0),
                  coal_pairing="stride", slab=None, closure=None,
                  courants=None, y3=None, pending_tgt=None, vt=None,
                  plain=False):
    """One microphysics step or a phase of one (pallas_step.step_resident
    with its phase flags): condensation (kernel B) with ``do_cond``, else
    the cell closure of th0/rv0 (the post-condensation values of the async
    phase, pallas_step.py:229-231; ``closure``, its (T, p, RH, eta) where
    the caller has it); with ``do_coal`` coalescence (kernel E,
    sstp_coal substeps of the draws ``rng`` = (seed, step)); then, where any
    of advection (``do_adve``), sedimentation (``do_sedi``) or subsidence
    (``w_cells``, the velocity of each row) runs, transport and
    classification (kernel C), and the merge (rebin_x) follows.  With no
    transport kernel C refreshes vt alone where condensation did not run;
    after condensation alone vt is None: the phase keeps the stale plane,
    as the TPU kernel's cond-only phase does (pallas_step.py:338-342).
    Returns (n, rw2, rd3, kpa, vt, x, z, tgt, th, rv, T, p, RH, eta,
    rowinfo), rowinfo's lane 6 the coalescence overflow flag of each row;
    with no transport tgt is None, and so is rowinfo unless coalescence
    ran (then it holds that flag alone).  A shard of the x-slab mesh passes
    its ``slab`` = (col0, ncol): transport is kernel C's unwrapped form and
    the coalescence draws are keyed by the global rows, from col0 * nz.
    ``courants``, the staggered (courant_x, courant_z[, courant_y]), are
    what pred_corr advection reads.  On the 3-D grid ``y3`` = (y, C_f,
    C_h) (transport): y rides coalescence and transport, and the result
    has it after the fifteen.  With ``pending_tgt`` (a deferred merge's
    targets, ``vt`` that step's vt plane) the planes are the previous
    step's before its merge, and condensation runs kernel B's
    merge-prologue form (cond): the step goes on from the merged rows, and
    rowinfo's lane 5 holds the droplets each row could not hold."""
    drops = None
    if pending_tgt is not None:
        if not do_cond:
            raise ValueError("step_resident: a pending merge rides the "
                             "condensation (kernel B's merge-prologue form)")
        (rw2, th, rv, T, p, RH, eta, n, _, rd3, kpa, _, x, z,
         drops) = cond(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv,
                       rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0,
                       pending_tgt=pending_tgt, vt=vt, x=x, z=z, plain=plain)
    elif do_cond:
        rw2, th, rv, T, p, RH, eta = cond(
            cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv, rvadv, th0,
            rv0, rhod, dv, lam_D, lam_K, p0, plain=plain)
    else:
        th, rv = th0, rv0
        T, p, RH, eta = closure if closure is not None \
            else hskpng_Tpr(cfg, th, rv, rhod, p0)
    y = None if y3 is None else y3[0]
    if do_coal:
        n, rw2, rd3, kpa, x, z, *yy, coal_ovf = coal_ops.coal_resident(
            cfg, params, sstp_coal, dt, *rng, n, rw2, rd3, kpa, x, z, T, p,
            rhod, eta, dv, pairing=coal_pairing,
            row0=0 if slab is None else int(slab[0]) * cfg.nz, y=y,
            plain=plain)
        y = yy[0] if yy else None
    vt = tgt = rowinfo = None
    if do_adve or do_sedi or w_cells is not None or not do_cond:
        n, x, z, vt, tgt, rowinfo, *yy = transport(
            cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta, C_l, C_r,
            C_b, C_a, do_adve=do_adve, w_cells=w_cells, slab=slab,
            courants=courants, y3=None if y3 is None else (y,) + y3[1:],
            plain=plain)
        y = yy[0] if yy else None
    if (do_coal or drops is not None) and rowinfo is None:
        rowinfo = torch.zeros((n.shape[0], 8), dtype=n.dtype,
                              device=n.device)
    if do_coal:
        rowinfo[:, 6] = coal_ovf.to(rowinfo.dtype)
    if drops is not None:
        rowinfo[:, 5] = drops.to(rowinfo.dtype)
    return (n, rw2, rd3, kpa, vt, x, z, tgt, th, rv, T, p, RH, eta,
            rowinfo) + (() if y3 is None else (y,))


# ---------------------------------------------------------------- kernel D
def _merge_sources(cfg, n_cell, device, three=False):
    """(n_cell, 9) source rows of each destination row, in MERGE_SOURCES
    order, and whether each exists (no z neighbour beyond the walls); on
    the 3-D grid (``three``) (n_cell, 27), in MERGE_SOURCES_3D order, x
    and y periodic."""
    r = torch.arange(n_cell, device=device)
    ny = cfg.ny if three else 1
    i, j, k = r // (ny * cfg.nz), (r // cfg.nz) % ny, r % cfg.nz
    src, ok = [], []
    for off in (MERGE_SOURCES_3D if three else MERGE_SOURCES):
        di, dj, dk = off if three else (off[0], 0, off[1])
        ks = k + dk
        src.append((torch.remainder(i + di, cfg.nx) * ny
                    + torch.remainder(j + dj, ny)) * cfg.nz
                   + torch.clamp(ks, 0, cfg.nz - 1))
        ok.append((ks >= 0) & (ks < cfg.nz))
    return torch.stack(src, 1), torch.stack(ok, 1)


def rebin_x_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, *, extra=()):
    """Row r takes, in MERGE_SOURCES order and lane order within each
    source, every droplet of its own and its eight neighbouring rows whose
    target is r, packed alive-first; lanes past the last droplet are zero.
    The planes ``extra`` (the exact mode's four private ambient planes, or
    none; on the 3-D grid the y plane first) ride with the seven.  On the
    3-D grid the sources are the own row and its 26 neighbours, in
    MERGE_SOURCES_3D order.  The destination rows go in blocks of at most
    MERGE_BLOCK candidate slots (a row's sources times the capacity), so
    that a full-width 3-D grid's candidates fit in memory.  Returns (n,
    rw2, rd3, kpa, vt, x, z, *extra, drops) with ``drops`` (n_cell,) the
    droplets each row could not hold."""
    n_cell, cap = n.shape
    src, ok = _merge_sources(cfg, n_cell, n.device, cfg.n_dims == 3)
    planes = (n, rw2, rd3, kpa, vt, x, z) + tuple(extra)
    block = max(1, MERGE_BLOCK // (src.shape[1] * cap))
    keep_lanes = torch.arange(cap, device=n.device)[None, :]
    outs, drops = [], []
    for r0 in range(0, n_cell, block):
        s = src[r0:r0 + block]
        rows = torch.arange(r0, r0 + s.shape[0], device=n.device)
        take = ok[r0:r0 + block, :, None] & (tgt[s] == rows[:, None, None])
        flat = lambda a: a.reshape(s.shape[0], -1)
        part, count = stable_partition_rows(
            flat(take), tuple(flat(p[s]) for p in planes))
        keep = keep_lanes < count
        outs.append(tuple(torch.where(keep, o[:, :cap], 0.0) for o in part))
        drops.append(torch.clamp(count[:, 0] - cap, min=0).to(n.dtype))
    return tuple(torch.cat(c) for c in zip(*outs)) + (torch.cat(drops),)


class Merge3dPlan(NamedTuple):
    """The launch of kernel D's 3-D forms: block b of column (i, j) = b //
    ``bricks`` owns the ``brick`` rows (a warp each) from level (b %
    bricks) * brick of it, clipped at nz, and stages the targets of the 3 x
    3 columns around it at those levels and one more on each side into
    ``smem`` bytes of dynamic shared memory."""
    brick: int
    bricks: int
    smem: int


def merge3d_smem(brick, cap):
    """csrc/merge3d.cuh brick_smem: a byte a slot of 9 x (brick + 2) staged
    rows at a row stride of whole 128-slot tiles, then each row's list of
    the slots it takes (4 bytes a slot)."""
    return 9 * (brick + 2) * (-(-cap // 128) * 128) + 4 * brick * cap


def merge3d_plan(cap, nz, brick=None):
    """Kernel D's 3-D forms' plan at row capacity ``cap`` on columns of
    ``nz`` rows: bricks of at most MERGE3D_MAX_BRICK rows, a column split
    into as few as hold it and their heights as even as a whole number
    allows (at nz = 76 bricks of 16 rows, the last 12), lowered until two
    blocks' shared memory fits an SM.  ``brick`` forces the height (any
    from 1 to MERGE3D_MAX_BRICK whose shared memory a block may take;
    above nz a brick's last warps have no row).  Raises for a height no
    block holds."""
    if brick is None:
        bricks = -(-int(nz) // MERGE3D_MAX_BRICK)
        brick = -(-int(nz) // bricks)
        while brick > 1 and 2 * (merge3d_smem(brick, cap)
                                 + BLOCK_RESERVED) > SM_SHARED:
            brick -= 1
    brick = int(brick)
    smem = merge3d_smem(brick, cap)
    if not 1 <= brick <= MERGE3D_MAX_BRICK or smem > BLOCK_SHARED:
        raise ValueError(
            f"rebin_x: no 3-D merge plan with a brick of {brick} rows at "
            f"capacity {cap}: 1 to {MERGE3D_MAX_BRICK} rows whose "
            f"{smem} bytes of shared memory fit a block's {BLOCK_SHARED}")
    return Merge3dPlan(brick, -(-int(nz) // brick), smem)


@functools.lru_cache(maxsize=None)
def card_merge3d(kernel, plan, cap):
    """Raise unless the card runs ``kernel`` (_ext.MERGE_3D or
    MERGE_3D_EXACT) at ``plan`` and row capacity ``cap`` in both its
    layouts: cudaFuncSetAttribute must take the plan's dynamic shared
    memory and at least one block must fit an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns the
    kernel's attributes (_ext.attributes) in the 16-byte layout."""
    for vec in (0, 1):
        try:
            a = _ext.attributes(kernel.symbol + "_attrs", vec, plan.brick,
                                cap)
        except RuntimeError as e:
            raise ValueError(
                f"{kernel.name}: the card refuses a brick of {plan.brick} "
                f"rows at capacity {cap}, {plan.smem} bytes of dynamic "
                f"shared memory (cudaFuncSetAttribute): {e}") from None
        if a["blocks_per_sm"] < 1:
            raise ValueError(
                f"{kernel.name}: no block of a brick of {plan.brick} rows "
                f"at capacity {cap} ({plan.smem} bytes of dynamic shared "
                f"memory, {a['registers']} registers a thread) fits an SM "
                f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return a


def rebin_x_mpdata_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, mpdata):
    """The plain version of kernel D's MPDATA-epilogue form: rebin_x_plain,
    then models/mpdata._advect_body of th and rv, ``mpdata`` = (th, rv,
    gc_x, gc_z, G, n_iters, fct) with th and rv the (n_cell,) cell fields.
    Returns rebin_x_plain's results and the advected th and rv, (nx,
    nz)."""
    from ..models.mpdata import _advect_body
    th, rv, gc_x, gc_z, G, n_iters, fct = mpdata
    G = _mpdata_G(cfg, G, th)
    return rebin_x_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt) + tuple(
        _advect_body(f.reshape(cfg.nx, cfg.nz), gc_x, gc_z, G, int(n_iters),
                     bool(fct)) for f in (th, rv))


def _mpdata_G(cfg, G, like):
    """G as an (nx, nz) field of ``like``'s type and device (a number or
    an array, as models/mpdata takes it)."""
    return torch.broadcast_to(torch.as_tensor(
        G, dtype=like.dtype, device=like.device), (cfg.nx, cfg.nz))


def rebin_x(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, *, extra=(), mpdata=None,
            plain=False):
    """Kernel D, or its plain version rebin_x_plain (same arguments and
    results).  It does the work of the z-merge epilogue of
    pallas_step._kernel and of pallas_step._xmerge_kernel together.  With
    four ``extra`` planes (the exact mode's sd_th, sd_rv, sd_rh and sd_p)
    it is D's 11-plane form, counted as _ext.MERGE_EXACT.  On the 3-D grid
    ``extra`` is y, or y and the four private planes: D's 3-D forms,
    _ext.MERGE_3D (eight planes) and _ext.MERGE_3D_EXACT (twelve), at
    merge3d_plan's bricks.  With
    ``mpdata`` = (th, rv, gc_x, gc_z, G, n_iters, fct), the post-
    condensation cell fields and kernel A's arguments, the seven-plane 2-D
    form also advects th and rv for the next step: D's MPDATA-epilogue
    form, _ext.MERGE_MPDATA (the TPU x-merge kernel's epilogue), or its
    plain version rebin_x_mpdata_plain; the results then end with the
    advected th and rv, (nx, nz), bitwise kernel A's."""
    three = cfg.n_dims == 3
    if cfg.nx < 3 or (three and cfg.ny < 3):
        raise ValueError("rebin_x: the merge needs nx >= 3 (left, own and "
                         "right columns must differ), and ny >= 3 on the "
                         "3-D grid")
    if len(extra) not in ((1, 5) if three else (0, 4)):
        raise ValueError(f"rebin_x: {'1 or 5' if three else '0 or 4'} "
                         f"extra planes, got {len(extra)}")
    if mpdata is not None:
        if three or extra:
            raise ValueError("rebin_x: the MPDATA epilogue rides the "
                             "seven-plane form on the 2-D grid")
        return _rebin_x_mpdata(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, mpdata,
                               plain)
    planes = (n, rw2, rd3, kpa, vt, x, z) + tuple(extra)
    if _ext.use_plain("rebin_x", n, plain):
        return rebin_x_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt,
                             extra=extra)
    n_cell, cap = n.shape
    _ext.check_planes("rebin_x", cap, *planes, tgt)
    _ext.check("rebin_x", *planes)
    _ext.check("rebin_x", tgt, dtype=torch.int32)
    outs = tuple(torch.empty_like(p) for p in planes)
    drops = torch.empty(n_cell, dtype=n.dtype, device=n.device)
    exact = len(extra) > int(three)
    if three:
        kernel = _ext.MERGE_3D_EXACT if exact else _ext.MERGE_3D
        plan = merge3d_plan(cap, cfg.nz)
        card_merge3d(kernel, plan, cap)
        dims = (n_cell, cap, cfg.nx, cfg.ny, cfg.nz, plan.brick)
    else:
        kernel = _ext.MERGE_EXACT if exact else _ext.MERGE
        dims = (n_cell, cap, cfg.nx, cfg.nz)
    kernel.launch(*(p.data_ptr() for p in planes), tgt.data_ptr(),
                  *(o.data_ptr() for o in outs), drops.data_ptr(), *dims)
    return outs + (drops,)


def _rebin_x_mpdata(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, mpdata, plain):
    """rebin_x with ``mpdata``: kernel D's MPDATA-epilogue form or
    rebin_x_mpdata_plain."""
    from ..models.mpdata import launch_plan
    if _ext.use_plain("merge_mpdata", n, plain):
        return rebin_x_mpdata_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt,
                                    mpdata)
    th, rv, gc_x, gc_z, G, n_iters, fct = mpdata
    planes = (n, rw2, rd3, kpa, vt, x, z)
    n_cell, cap = n.shape
    nx, nz = cfg.nx, cfg.nz
    _ext.check_planes("merge_mpdata", cap, *planes, tgt)
    G = _mpdata_G(cfg, G, th).contiguous()
    if th.numel() != n_cell or rv.numel() != n_cell \
            or gc_x.shape != (nx + 1, nz) or gc_z.shape != (nx, nz + 1):
        raise ValueError(
            f"merge_mpdata: th and rv must hold the {n_cell} cells and the "
            f"courants fit the {nx}x{nz} grid, got {tuple(th.shape)}, "
            f"{tuple(rv.shape)}, {tuple(gc_x.shape)}, {tuple(gc_z.shape)}")
    if int(n_iters) < 1:
        raise ValueError(f"merge_mpdata: n_iters must be >= 1, got {n_iters}")
    _ext.check("merge_mpdata", *planes, th, rv, gc_x, gc_z, G)
    _ext.check("merge_mpdata", tgt, dtype=torch.int32)
    outs = tuple(torch.empty_like(p) for p in planes)
    drops = torch.empty(n_cell, dtype=n.dtype, device=n.device)
    adv = torch.empty((2, nx, nz), dtype=n.dtype, device=n.device)
    # a cluster of at most 8 CTAs a field, kernel A's slabs
    plan = launch_plan(nx, nz, bool(fct), max_cluster=8)
    _ext.MERGE_MPDATA.launch(
        *(p.data_ptr() for p in planes), tgt.data_ptr(),
        *(o.data_ptr() for o in outs), drops.data_ptr(), n_cell, cap, nx, nz,
        th.data_ptr(), rv.data_ptr(), adv[0].data_ptr(), adv[1].data_ptr(),
        gc_x.data_ptr(), gc_z.data_ptr(), G.data_ptr(), int(n_iters),
        int(bool(fct)), *plan)
    return outs + (drops,) + tuple(adv.unbind(0))
