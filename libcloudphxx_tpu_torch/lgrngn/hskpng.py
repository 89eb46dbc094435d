"""Housekeeping: cell thermodynamics, mean free paths, cell indices and the
per-cell moments of the flat engine (libcloudphxx_tpu/lgrngn/hskpng.py;
reference src/impl/housekeeping/)."""

import dataclasses

import torch

from ..common import const_cp, mean_free_path, moist_air, tetens, theta_dry
from ..common import theta_std
from ..common import vterm as common_vterm
from .enums import RH_formula_t
from .state import StaticConfig


def RH_of(cfg: StaticConfig, p, rv, T):
    """The four RH formulas (reference hskpng_Tpr.ipp:68-105)."""
    f = RH_formula_t(cfg.RH_formula)
    if f == RH_formula_t.pv_cc:
        return moist_air.p_v(p, rv) / const_cp.p_vs(T)
    if f == RH_formula_t.rv_cc:
        return rv / const_cp.r_vs(T, p)
    if f == RH_formula_t.pv_tet:
        return moist_air.p_v(p, rv) / tetens.p_vs(T)
    return rv / tetens.r_vs(T, p)


def T_p(cfg: StaticConfig, th, rv, rhod, p0):
    """hskpng_Tpr's T and p alone, for the callers that need no more."""
    if cfg.th_dry:
        T = theta_dry.T(th, rhod)
    else:
        T = th * theta_std.exner(p0)
    return T, p0 if cfg.const_p else theta_dry.p(rhod, rv, T)


def hskpng_Tpr(cfg: StaticConfig, th, rv, rhod, p0):
    """Per-cell T, p, RH, eta from th, rv, rhod (reference
    hskpng_Tpr.ipp:219-305): th_dry or th_std, variable pressure or the
    prescribed profile ``p0``.  Returns (T, p, RH, eta)."""
    T, p = T_p(cfg, th, rv, rhod, p0)
    return T, p, RH_of(cfg, p, rv, T), common_vterm.visc(T)


def hskpng_Tpr_state(cfg: StaticConfig, state):
    """hskpng_Tpr on a flat State: its T, p, RH and eta from th, rv and
    rhod (and the pressure it holds, for th_std or const_p)."""
    T, p, RH, eta = hskpng_Tpr(cfg, state.th, state.rv, state.rhod, state.p)
    return dataclasses.replace(state, T=T, p=p, RH=RH, eta=eta)


def segment_moment(cfg: StaticConfig, n_filtered, attr, power, ijk, dv,
                   rhod):
    """k-th specific moment of ``attr`` over the selected SDs of each cell,
    divided by the cell volume and the dry-air density (reference
    particles_impl_moms.ipp:276-360)."""
    if power == 0:
        vals = n_filtered
    else:
        vals = n_filtered * torch.where(n_filtered > 0, attr, 1.0) ** power
    mom = torch.zeros(cfg.n_cell, dtype=vals.dtype, device=vals.device)
    mom.index_add_(0, ijk, vals)
    return mom / dv / rhod


def sd_count_per_cell(cfg: StaticConfig, n_filtered, ijk):
    """Number of selected super-droplets per cell (reference
    particles_diag.ipp:196-219)."""
    out = torch.zeros(cfg.n_cell, dtype=n_filtered.dtype,
                      device=n_filtered.device)
    return out.index_add_(0, ijk, (n_filtered > 0).to(n_filtered.dtype))


def hskpng_mfp(T, p):
    """Mean free paths for the transition-regime correction
    (reference hskpng_mfp.ipp:20-50)."""
    return mean_free_path.lambda_D(T), mean_free_path.lambda_K(T, p)


def ijk_of_xyz(cfg: StaticConfig, x, z):
    """2-D position -> ravelled cell index i*nz + k (reference
    hskpng_ijk.ipp:86-253).  The cell grid starts at 0, not at x0 (the
    Lagrangian domain crop only bounds where particles live); the division
    is done in float64 so that no position lands on i == nx."""
    def cell_of(pos, d, n):
        return torch.clamp(
            torch.floor(pos.to(torch.float64) / d).to(torch.int64), 0, n - 1)

    return cell_of(x, cfg.dx, cfg.nx) * cfg.nz + cell_of(z, cfg.dz, cfg.nz)
