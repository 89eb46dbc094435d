"""The resident microphysics step and the re-binning merge
(libcloudphxx_tpu/ops/pallas_step.py: step_resident, rebin_x).

The TPU runs the step as one Pallas kernel over row blocks
(pallas_step._kernel) plus the x pass of the re-binning
(pallas_step._xmerge_kernel).  On the card the same work runs as four
hand-written kernels, each beside its plain PyTorch version:

  kernel B  csrc/cond.cu       cond / cond_plain: condensation substeps
  kernel E  csrc/coal.cu       ops/coal.coal_resident: coalescence substeps
  kernel C  csrc/transport.cu  transport / transport_plain: vt refresh,
            advection, sedimentation, subsidence, walls, puddle partials,
            and the target cell of every droplet (or the vt refresh alone);
            with a ``slab`` the unwrapped form a shard of the x-slab mesh
            runs
  kernel D  csrc/merge.cu      rebin_x / rebin_x_plain: each row takes its
            droplets from itself and its eight neighbours (the z and the x
            pass of the re-binning at once); seven planes, or eleven with
            the exact mode's private ambient planes

Dispatch is by device: CPU tensors run the plain version, CUDA tensors
launch the kernel (float32, contiguous, or the wrapper raises), and
``plain=True`` runs the plain version on any device, for comparisons and
timings.  Layout: SD planes (n_cell, cap), row i*nz + k holding cell
(i, k); cell fields (n_cell,).
"""

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


def _rows(cfg, n_cell, like, col0=0):
    """Each row's column (from ``col0``) and level, as (n_cell, 1) planes of
    ``like``'s dtype."""
    r = torch.arange(n_cell, device=like.device)
    return (r // cfg.nz + col0).to(like.dtype)[:, None], \
        (r % cfg.nz).to(like.dtype)[:, None]


def wrap_x(cfg, x):
    """x wrapped into [x0, x1) by the periodic side walls, in kernel C's
    float operations."""
    w = cfg.x1 - cfg.x0
    q = x - cfg.x0
    return cfg.x0 + (q - torch.floor(q / torch.full((), w, dtype=x.dtype,
                                                   device=x.device)) * w)


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


def cond(cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv, rvadv, th0,
         rv0, rhod, dv, lam_D, lam_K, p0, *, plain=False):
    """Kernel B, or its plain version cond_plain (same arguments and
    results)."""
    args = (n, rw2, rd3, kpa, thadv, rvadv, th0, rv0, rhod, dv, lam_D,
            lam_K, p0)
    if _ext.use_plain("cond", n, plain):
        return cond_plain(cfg, sstp_cond, dt, RH_max, *args)
    n_cell, cap = n.shape
    _ext.check_planes("cond", cap, n, rw2, rd3, kpa)
    fields = (thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, p0)
    if any(a.shape != (n_cell,) for a in fields):
        raise ValueError(f"cond: cell fields must be ({n_cell},)")
    cells = torch.stack(fields)
    _ext.check("cond", n, rw2, rd3, kpa, cells)
    if n.numel() >= 2 ** 31:
        raise ValueError("cond: more than 2**31 - 1 SD lanes")
    rw2_out = torch.empty_like(rw2)
    cells_out = torch.empty((6, n_cell), dtype=n.dtype, device=n.device)
    pos, buf = _ext.cond_scratch(n.numel(), n.device)
    order = _ext.longest_first((n > 0).sum(1))
    _ext.COND.launch(
        n.data_ptr(), rw2.data_ptr(), rd3.data_ptr(), kpa.data_ptr(),
        cells.data_ptr(), rw2_out.data_ptr(), cells_out.data_ptr(),
        pos.data_ptr(), buf.data_ptr(), order.data_ptr(), n_cell, cap,
        int(sstp_cond), dt / sstp_cond, float(RH_max), int(cfg.th_dry),
        int(cfg.const_p), int(cfg.RH_formula), _root_iters(n.dtype),
        vt_t(cfg.terminal_velocity).value)
    return (rw2_out,) + tuple(cells_out.unbind(0))


# ---------------------------------------------------------------- kernel C
def transport_plain(cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta,
                    C_l, C_r, C_b, C_a, *, do_adve=True, w_cells=None,
                    slab=None):
    """vt refresh, SD advection, sedimentation, subsidence, walls and
    puddle, then each droplet's target row (pallas_step.py:338-487).
    ``do_adve`` moves the droplets with the courants C_*, ``do_sedi`` by
    their vt, and ``w_cells`` (n_cell,), when given, is the subsidence
    velocity of each row (pallas_step.py:369-370).  Returns (n, x, z, vt,
    tgt, rowinfo): ``tgt`` is the int32 target row (-1 for dead slots; a
    droplet that moved more than one cell on an axis keeps its row and sets
    the row's flag), ``rowinfo`` (n_cell, 8) the per-row puddle partials
    (liquid volume, dry volume, liquid number, particle number) and
    far-mover flag.  A slot dead at load (n == 0) comes out with n = x = z
    = vt = 0 and target -1, as kernel C writes it; the merge reads only the
    slots it takes, so no droplet sees that.  With no transport at all (no
    advection, sedimentation or subsidence) only vt is refreshed: n, x and
    z come back as they went in, and tgt and rowinfo are None.

    With a ``slab`` = (col0, ncol) it is the unwrapped form a shard of the
    x-slab mesh runs (the TPU kernel's x_wrap=False, pallas_step.py:378-382;
    parallel/dense_mesh.py): the rows are the global columns col0 .. col0 +
    n_cell / nz - 1 of ``cfg``'s grid, the first ncol of them the shard's
    own; x stays unwrapped,
    the open side walls do not kill, and a droplet outside the shard's
    columns or outside [x0, x1) gets target -1 and no far flag (the mesh
    moves it).  The targets are local rows; the near test has no x-wrap
    clause."""
    n_cell, cap = n.shape
    col0, ncol = _slab(cfg, n_cell, slab)
    live0 = n > 0
    col = lambda a: a[:, None]
    # divisions by a tensor, not a Python number: on the card PyTorch
    # turns those into multiplications by the reciprocal, which would
    # classify a droplet on a cell face differently from the kernel
    full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)
    i_row, k_row = _rows(cfg, n_cell, x, col0)
    vt = vt_in_kernel(cfg, rw2, col(T), col(p), col(rhod), col(eta))
    if not (do_adve or do_sedi or w_cells is not None):
        if slab is not None:
            raise ValueError("transport: a slab needs some transport")
        return n, x, z, torch.where(live0, vt, 0.0), None, None

    if do_adve:
        dCx = col(C_r - C_l)
        dCz = col(C_a - C_b)
        if as_t(cfg.adve_scheme) == as_t.implicit:
            x = (x + cfg.dx * (col(C_l) - i_row * dCx)) / (1.0 - dCx)
            z = (z + cfg.dz * (col(C_b) - k_row * dCz)) / (1.0 - dCz)
        else:  # euler
            x = x + dCx * (x - cfg.dx * i_row) + cfg.dx * col(C_l)
            z = z + dCz * (z - cfg.dz * k_row) + cfg.dz * col(C_b)
    if do_sedi:
        z = z - dt * vt
    if w_cells is not None:
        z = z - dt * col(w_cells)

    if slab is None:      # else the mesh's re-binning wraps or kills
        if cfg.open_side_walls:
            n = torch.where((x >= cfg.x1) | (x < cfg.x0), 0.0, n)
        else:
            x = wrap_x(cfg, x)
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
        alive = alive & ~((x < cfg.x0) | (x >= cfg.x1) | (i_t < col0)
                          | (i_t >= col0 + ncol))
    near = (torch.abs(dk) <= 1.0) & near_x
    rows = torch.arange(n_cell, device=n.device, dtype=torch.int32)[:, None]
    tgt = torch.where(near, ((i_t - col0) * cfg.nz + k_t).to(torch.int32),
                      rows)
    tgt = torch.where(alive, tgt, -1)
    far = (alive & ~near).any(dim=1).to(n.dtype)
    rowinfo = torch.stack([liq_vol, dry_vol, liq_num, prt_num, far,
                           zero, zero, zero], dim=1)
    n, x, z, vt = (torch.where(live0, a, 0.0) for a in (n, x, z, vt))
    return n, x, z, vt, tgt, rowinfo


def transport(cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta, C_l,
              C_r, C_b, C_a, *, do_adve=True, w_cells=None, slab=None,
              plain=False):
    """Kernel C, or its plain version transport_plain (same arguments and
    results); with a ``slab`` kernel C's unwrapped form, counted as
    _ext.TRANSPORT_UNWRAPPED."""
    kw = dict(do_adve=do_adve, w_cells=w_cells, slab=slab)
    args = (n, rw2, rd3, x, z, T, p, rhod, eta, C_l, C_r, C_b, C_a)
    if _ext.use_plain("transport", n, plain):
        return transport_plain(cfg, dt, do_sedi, *args, **kw)
    n_cell, cap = n.shape
    moves = do_adve or do_sedi or w_cells is not None
    col0, ncol = _slab(cfg, n_cell, slab)
    if not moves and slab is not None:
        raise ValueError("transport: a slab needs some transport")
    _ext.check_planes("transport", cap, n, rw2, *((rd3, x, z) if moves
                                                   else ()))
    if as_t(cfg.adve_scheme) not in (as_t.implicit, as_t.euler):
        raise NotImplementedError(
            f"transport: advection scheme {as_t(cfg.adve_scheme).name} is not "
            "ported (ROADMAP.md, Queue 1)")
    # the subsidence row only where there is subsidence: the kernel reads
    # it with do_subs alone
    cells = torch.stack([T, p, rhod, eta, C_l, C_r, C_b, C_a]
                        + ([w_cells] if w_cells is not None else []))
    if cells.shape[1:] != (n_cell,):
        raise ValueError(f"transport: cell fields must be ({n_cell},)")
    _ext.check("transport", n, rw2, *((rd3, x, z) if moves else ()), cells)
    vt_out = torch.empty_like(n)
    if moves:
        n_out, x_out, z_out = (torch.empty_like(n) for _ in range(3))
        tgt = torch.empty((n_cell, cap), dtype=torch.int32, device=n.device)
        rowinfo = torch.empty((n_cell, 8), dtype=n.dtype, device=n.device)
        ptr = lambda a: a.data_ptr()
    else:
        n_out, x_out, z_out, tgt, rowinfo = n, x, z, None, None
        ptr = lambda a: None
    kernel, extra = (_ext.TRANSPORT, ()) if slab is None else \
        (_ext.TRANSPORT_UNWRAPPED, (col0, ncol))
    kernel.launch(
        n.data_ptr(), rw2.data_ptr(), ptr(rd3), ptr(x), ptr(z),
        cells.data_ptr(), ptr(n_out), ptr(x_out), ptr(z_out),
        vt_out.data_ptr(), ptr(tgt), ptr(rowinfo), n_cell, cap, cfg.nx,
        cfg.nz, cfg.dx, cfg.dz, float(dt), cfg.x0, cfg.x1, cfg.z0, cfg.z1,
        int(as_t(cfg.adve_scheme) == as_t.implicit), int(do_adve),
        int(do_sedi), int(w_cells is not None), int(cfg.open_side_walls),
        int(cfg.periodic_topbot_walls), vt_t(cfg.terminal_velocity).value,
        *extra)
    return n_out, x_out, z_out, vt_out, tgt, rowinfo


def step_resident(cfg, sstp_cond, dt, RH_max, do_sedi, n, rw2, rd3, kpa, x,
                  z, thadv, rvadv, th0, rv0, rhod, dv, lam_D, lam_K, C_l, C_r,
                  C_b, C_a, p0, *, do_cond=True, do_coal=False, do_adve=True,
                  w_cells=None, params=(), sstp_coal=1, rng=(0, 0),
                  coal_pairing="stride", slab=None, closure=None,
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
    the coalescence draws are keyed by the global rows, from col0 * nz."""
    if do_cond:
        rw2, th, rv, T, p, RH, eta = cond(
            cfg, sstp_cond, dt, RH_max, n, rw2, rd3, kpa, thadv, rvadv, th0,
            rv0, rhod, dv, lam_D, lam_K, p0, plain=plain)
    else:
        th, rv = th0, rv0
        T, p, RH, eta = closure if closure is not None \
            else hskpng_Tpr(cfg, th, rv, rhod, p0)
    if do_coal:
        n, rw2, rd3, kpa, x, z, coal_ovf = coal_ops.coal_resident(
            cfg, params, sstp_coal, dt, *rng, n, rw2, rd3, kpa, x, z, T, p,
            rhod, eta, dv, pairing=coal_pairing,
            row0=0 if slab is None else int(slab[0]) * cfg.nz, plain=plain)
    vt = tgt = rowinfo = None
    if do_adve or do_sedi or w_cells is not None or not do_cond:
        n, x, z, vt, tgt, rowinfo = transport(
            cfg, dt, do_sedi, n, rw2, rd3, x, z, T, p, rhod, eta, C_l, C_r,
            C_b, C_a, do_adve=do_adve, w_cells=w_cells, slab=slab,
            plain=plain)
    if do_coal:
        if rowinfo is None:
            rowinfo = torch.zeros((n.shape[0], 8), dtype=n.dtype,
                                  device=n.device)
        rowinfo[:, 6] = coal_ovf.to(rowinfo.dtype)
    return (n, rw2, rd3, kpa, vt, x, z, tgt, th, rv, T, p, RH, eta, rowinfo)


# ---------------------------------------------------------------- kernel D
def _merge_sources(cfg, n_cell, device):
    """(n_cell, 9) source rows of each destination row, in MERGE_SOURCES
    order, and whether each exists (no z neighbour beyond the walls)."""
    r = torch.arange(n_cell, device=device)
    i, k = r // cfg.nz, r % cfg.nz
    src, ok = [], []
    for di, dk in MERGE_SOURCES:
        ks = k + dk
        src.append(torch.remainder(i + di, cfg.nx) * cfg.nz
                   + torch.clamp(ks, 0, cfg.nz - 1))
        ok.append((ks >= 0) & (ks < cfg.nz))
    return torch.stack(src, 1), torch.stack(ok, 1)


def rebin_x_plain(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, *, extra=()):
    """Row r takes, in MERGE_SOURCES order and lane order within each
    source, every droplet of its own and its eight neighbouring rows whose
    target is r, packed alive-first; lanes past the last droplet are zero.
    The planes ``extra`` (the exact mode's four private ambient planes, or
    none) ride with the seven.  Returns (n, rw2, rd3, kpa, vt, x, z,
    *extra, drops) with ``drops`` (n_cell,) the droplets each row could
    not hold."""
    n_cell, cap = n.shape
    src, ok = _merge_sources(cfg, n_cell, n.device)
    rows = torch.arange(n_cell, device=n.device)[:, None, None]
    take = ok[:, :, None] & (tgt[src] == rows)
    flat = lambda a: a.reshape(n_cell, -1)
    outs, count = stable_partition_rows(
        flat(take), tuple(flat(p[src]) for p in (n, rw2, rd3, kpa, vt, x, z)
                          + tuple(extra)))
    keep = torch.arange(cap, device=n.device)[None, :] < count
    outs = tuple(torch.where(keep, o[:, :cap], 0.0) for o in outs)
    drops = torch.clamp(count[:, 0] - cap, min=0).to(n.dtype)
    return outs + (drops,)


def rebin_x(cfg, n, rw2, rd3, kpa, vt, x, z, tgt, *, extra=(), plain=False):
    """Kernel D, or its plain version rebin_x_plain (same arguments and
    results).  It does the work of the z-merge epilogue of
    pallas_step._kernel and of pallas_step._xmerge_kernel together.  With
    four ``extra`` planes (the exact mode's sd_th, sd_rv, sd_rh and sd_p)
    it is D's 11-plane form, counted as _ext.MERGE_EXACT."""
    if cfg.nx < 3:
        raise ValueError("rebin_x: the merge needs nx >= 3 (left, own and "
                         "right columns must differ)")
    if len(extra) not in (0, 4):
        raise ValueError(f"rebin_x: 0 or 4 extra planes, got {len(extra)}")
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
    kernel = _ext.MERGE_EXACT if extra else _ext.MERGE
    kernel.launch(*(p.data_ptr() for p in planes), tgt.data_ptr(),
                  *(o.data_ptr() for o in outs), drops.data_ptr(), n_cell,
                  cap, cfg.nx, cfg.nz)
    return outs + (drops,)
