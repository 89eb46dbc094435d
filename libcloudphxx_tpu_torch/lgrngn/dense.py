"""Dense cell-major SD layout and the fused model step
(libcloudphxx_tpu/lgrngn/dense.py).

The population lives in a dense occupancy matrix of shape (n_cell, cap):
row i*nz + k holds the super-droplets of cell (i, k), and multiplicity
n == 0 marks an empty slot.  Per-cell reductions are row reductions; only
the re-binning after transport moves droplets between rows.

The state is never updated in place: every step returns a new DenseState,
so a caller may keep an old one (a benchmark restores its initial state).
The per-cell closure (the JAX package's dense._Tpr) is hskpng.hskpng_Tpr.
"""

import dataclasses

import torch

from ..common import constants as c
from ..ops.step import rebin_x, step_resident
from .hskpng import hskpng_mfp, ijk_of_xyz
from .state import (N_PUDDLE, OUT_DRY_VOL, OUT_LIQ_NUM, OUT_LIQ_VOL,
                    OUT_PRTCL_NUM, StaticConfig)

ATTRS = ("n", "rw2", "rd3", "kpa", "vt", "x", "z")


@dataclasses.dataclass
class DenseState:
    """Cell-major SD population and per-cell thermodynamics.

    SD planes (n_cell, cap); cell fields (n_cell,); courants in the
    flattened staggered layout ((nx+1)*nz and nx*(nz+1)).  Slot order
    within a row carries no meaning."""

    n: torch.Tensor
    rw2: torch.Tensor
    rd3: torch.Tensor
    kpa: torch.Tensor
    vt: torch.Tensor
    x: torch.Tensor
    z: torch.Tensor
    rhod: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    RH: torch.Tensor
    eta: torch.Tensor
    dv: torch.Tensor
    sstp_tmp_th: torch.Tensor
    sstp_tmp_rv: torch.Tensor
    courant_x: torch.Tensor
    courant_z: torch.Tensor
    puddle: torch.Tensor      # (N_PUDDLE,), slots as state.PUDDLE_KEYS
    overflow: torch.Tensor    # 0-d int64: SDs dropped because a row was full

    @property
    def cap(self):
        return self.n.shape[1]

    @property
    def n_cell(self):
        return self.n.shape[0]


def _distribute(n_cell, cap, cell, vals):
    """Stable-sort flat SD slots by target cell and scatter them into
    (n_cell, cap) planes; cell == n_cell marks slots to drop.  Returns
    (planes, number of SDs that did not fit their row)."""
    cell_s, order = torch.sort(cell, stable=True)
    counts = torch.bincount(cell_s, minlength=n_cell + 1)
    starts = torch.cumsum(counts, 0) - counts
    lane = torch.arange(cell.numel(), device=cell.device) - starts[cell_s]
    in_dom = cell_s < n_cell
    fits = in_dom & (lane < cap)
    # slots that do not land go to one extra dump element, cut off below
    dst = torch.where(fits, cell_s * cap + lane, n_cell * cap)
    planes = []
    for v in vals:
        out = torch.zeros(n_cell * cap + 1, dtype=v.dtype, device=v.device)
        out.scatter_(0, dst, v[order])
        planes.append(out[:-1].reshape(n_cell, cap))
    return planes, torch.sum(in_dom & (lane >= cap))


def pack(cfg: StaticConfig, sd: dict, cells: dict, cap: int) -> DenseState:
    """Flat SD vectors -> DenseState (one stable sort + scatter).  ``sd``
    holds the flat attributes of ATTRS and the cell index ``ijk``; slots
    with n == 0 are dropped.  ``cells`` holds the DenseState cell fields
    and courants."""
    cell = torch.where(sd["n"] > 0, sd["ijk"], cfg.n_cell)
    planes, overflow = _distribute(cfg.n_cell, cap, cell,
                                   [sd[a] for a in ATTRS])
    like = sd["n"]
    return DenseState(
        **dict(zip(ATTRS, planes)), **cells,
        puddle=torch.zeros(N_PUDDLE, dtype=like.dtype, device=like.device),
        overflow=overflow)


def _row_courants(cfg: StaticConfig, d: DenseState):
    """Per-cell left/right/below/above courants (n_cell,) sliced from the
    staggered fields (reference init_grid.ipp:94-155)."""
    cx = d.courant_x.reshape(cfg.nx + 1, cfg.nz)
    cz = d.courant_z.reshape(cfg.nx, cfg.nz + 1)
    return (cx[:-1].reshape(-1), cx[1:].reshape(-1),
            cz[:, :-1].reshape(-1), cz[:, 1:].reshape(-1))


def _rebin_global(cfg: StaticConfig, d: DenseState) -> DenseState:
    """Exact re-bin of every SD to the cell of its position (one global
    sort): the repair after SDs moved more than one cell on an axis."""
    alive = d.n > 0
    tgt = torch.where(alive, ijk_of_xyz(cfg, d.x, d.z), cfg.n_cell)
    planes, overflow = _distribute(
        cfg.n_cell, d.cap, tgt.reshape(-1),
        [getattr(d, a).reshape(-1) for a in ATTRS])
    return dataclasses.replace(d, overflow=d.overflow + overflow,
                               **dict(zip(ATTRS, planes)))


def step_fused(cfg: StaticConfig, d: DenseState, th_adv, rv_adv, dt, RH_max,
               do_coal: bool, do_sedi: bool, *, plain=False):
    """One whole microphysics step: condensation substeps, transport and
    walls (step_resident), the re-binning merge (rebin_x), the puddle fold
    and, when some SD moved more than one cell on an axis, the global
    re-bin.  Same phase order as the reference step_sync + step_async
    (particles_step.ipp:161-494) without coalescence, which is not ported
    yet.  Returns (DenseState, th, rv)."""
    if do_coal:
        raise NotImplementedError(
            "step_fused: coalescence is not ported yet (ROADMAP.md, Queue 2 "
            "item 6); run with coal_switch=False or in spin-up")
    # mean free paths from the previous step's T/p (dense.py:1519)
    lam_D, lam_K = hskpng_mfp(d.T, d.p)
    C_l, C_r, C_b, C_a = _row_courants(cfg, d)
    (n, rw2, rd3, kpa, vt, x, z, tgt, th, rv, T, p, RH, eta,
     rowinfo) = step_resident(
        cfg, cfg.sstp_cond, dt, RH_max, do_sedi, d.n, d.rw2, d.rd3, d.kpa,
        d.x, d.z, th_adv, rv_adv, d.sstp_tmp_th, d.sstp_tmp_rv, d.rhod, d.dv,
        lam_D, lam_K, C_l, C_r, C_b, C_a, d.p, plain=plain)
    info = rowinfo.sum(dim=0).to(d.puddle.dtype)
    fold = torch.zeros_like(d.puddle)
    fold[[OUT_LIQ_VOL, OUT_DRY_VOL, OUT_LIQ_NUM, OUT_PRTCL_NUM]] = info[:4]
    d = dataclasses.replace(
        d, rw2=rw2, T=T, p=p, RH=RH, eta=eta, sstp_tmp_th=th,
        sstp_tmp_rv=rv, puddle=d.puddle + fold)
    if cfg.nx < 3:
        # the merge needs distinct left, own and right columns
        d = dataclasses.replace(d, n=n, rd3=rd3, kpa=kpa, vt=vt, x=x, z=z)
        return _rebin_global(cfg, d), th, rv
    *planes, drops = rebin_x(cfg, n, rw2, rd3, kpa, vt, x, z, tgt,
                             plain=plain)
    d = dataclasses.replace(
        d, overflow=d.overflow + drops.sum().to(d.overflow.dtype),
        **dict(zip(ATTRS, planes)))
    if bool(info[4] > 0):  # one host sync a step: far movers are rare
        d = _rebin_global(cfg, d)
    return d, th, rv


def moment(d: DenseState, rng_lo2, rng_hi2, power, specific=True):
    """Per-cell wet-radius moment over an rw^2 range, a row reduction
    (the dense diag_wet_rng + diag_wet_mom, particles_impl_moms.ipp)."""
    sel = (d.n > 0) & (d.rw2 >= rng_lo2) & (d.rw2 < rng_hi2)
    nf = torch.where(sel, d.n, 0.0)
    if power == 0:
        vals = nf
    else:
        vals = nf * torch.where(sel, d.rw2, 1.0) ** (power / 2.0)
    mom = torch.sum(vals, dim=1)
    if specific:
        mom = mom / (d.dv * d.rhod)
    return mom


def water_dry_totals(d: DenseState, rv):
    """Total water mass [kg] (vapour + liquid + puddle) and dry-aerosol
    volume sum [n*rd^3] with the puddle, in float64 (the bench.py
    conservation checks)."""
    f = lambda a: a.to(torch.float64)
    vap = torch.sum(f(d.rhod) * f(d.dv) * f(rv).reshape(-1))
    alive = d.n > 0
    liq = (4.0 / 3) * c.pi * c.rho_w * torch.sum(
        torch.where(alive, f(d.n) * f(d.rw2) ** 1.5, 0.0))
    liq = liq + c.rho_w * f(d.puddle[OUT_LIQ_VOL])
    dry = torch.sum(torch.where(alive, f(d.n) * f(d.rd3), 0.0)) \
        + f(d.puddle[OUT_DRY_VOL]) / ((4.0 / 3) * c.pi)
    return float(vap + liq), float(dry)
