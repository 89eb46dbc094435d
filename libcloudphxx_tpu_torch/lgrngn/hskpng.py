"""Housekeeping: cell thermodynamics, mean free paths, cell indices
(libcloudphxx_tpu/lgrngn/hskpng.py; reference src/impl/housekeeping/)."""

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


def hskpng_Tpr(cfg: StaticConfig, th, rv, rhod, p0):
    """Per-cell T, p, RH, eta from th, rv, rhod (reference
    hskpng_Tpr.ipp:219-305): th_dry or th_std, variable pressure or the
    prescribed profile ``p0``.  Returns (T, p, RH, eta)."""
    if cfg.th_dry:
        T = theta_dry.T(th, rhod)
    else:
        T = th * theta_std.exner(p0)
    p = p0 if cfg.const_p else theta_dry.p(rhod, rv, T)
    return T, p, RH_of(cfg, p, rv, T), common_vterm.visc(T)


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
