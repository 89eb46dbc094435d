"""Cell-wise right-hand side of the double-moment bulk scheme
(libcloudphxx_tpu/blk_2m/rhs_cellwise.py; reference
include/libcloudph++/blk_2m/rhs_cellwise.hpp).

The reference's per-cell chain (activation -> cond/evap -> limiters ->
autoconversion -> accretion -> collision N sink) with its sequential
cloud/rain-limiter flags runs over the whole grid: each ``if`` or flag is a
boolean mask threaded through the chain.  Returns the six updated
tendencies.
"""

import torch

from ..common import const_cp, theta_dry, theta_std
from ..common import constants as c
from . import formulae as f
from .options import opts_t


def _T_p(opts, th, rv, rhod, p):
    opts.validate_theta_convention()
    if opts.th_dry:
        T = theta_dry.T(th, rhod)
        p_full = theta_dry.p(rhod, rv, T)
    else:
        T = th * theta_std.exner(p)
        p_full = p
    return T, p_full


def rhs_cellwise(
    opts: opts_t,
    dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr,
    rhod, th, rv, rc, nc, rr, nr,
    dt, p=None,
):
    """Morrison & Grabowski 2007 process chain (reference
    rhs_cellwise.hpp:21-300).  nc/nr are specific concentrations [1/kg].
    Returns (dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr)."""
    T, p_full = _T_p(opts, th, rv, rhod, p)
    r_vs = const_cp.r_vs(T, p_full)

    zero = torch.zeros_like(rv)
    l_rc, l_rr, l_nc, l_nr = zero, zero, zero, zero

    # --- activation (rhs_cellwise.hpp:144-168)
    if opts.acti and opts.dry_distros:
        n_ccn = zero
        for mode in opts.dry_distros:
            n_ccn = n_ccn + f.n_c_p(
                p_full, T, rv, mode.mean_rd, mode.sdev_rd, mode.N_stp,
                mode.chem_b, opts.RH_max,
            )
        act = f.activation_rate(n_ccn, nc, dt)
        act = torch.where(rv > r_vs, act, 0.0)
        l_nc = l_nc + act
        l_rc = l_rc + act * f.ccnmass

    # --- condensation/evaporation (rhs_cellwise.hpp:170-199)
    if opts.cond:
        c_ok = (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc))
        rc_s = torch.where(c_ok, rc, 1e-6)
        nc_s = torch.where(c_ok, nc, 1e6)
        tau_c = f.tau_relax_c(T, p_full, f.r_drop_c(rc_s, nc_s, rhod),
                              rhod * nc_s)
        l_rc = l_rc + torch.where(c_ok, f.cond_evap_rate(T, p_full, rv, tau_c),
                                  0.0)

        r_ok = (rr > f.rr_eps(rr)) & (nr > f.nr_eps(nr))
        rr_s = torch.where(r_ok, rr, 1e-6)
        nr_s = torch.where(r_ok, nr, 1e6)
        tau_r = f.tau_relax_r(T, rhod, rr_s, nr_s)
        evap_r = torch.clamp(f.cond_evap_rate(T, p_full, rv, tau_r), max=0.0)
        l_rr = l_rr + torch.where(r_ok, evap_r, 0.0)
        # evaporation keeps the mean raindrop radius constant
        l_nr = l_nr + torch.where(r_ok, evap_r * nr_s / rr_s, 0.0)

    # --- limiters (rhs_cellwise.hpp:201-219)
    cloud_lim = l_rc <= -rc / dt
    rain_lim = l_rr <= -rr / dt
    l_rc = torch.maximum(l_rc, -rc / dt)
    l_rr = torch.maximum(l_rr, -rr / dt)
    l_nr = torch.maximum(l_nr, -nr / dt)
    l_nc = torch.where(cloud_lim, -nc / dt, l_nc)
    l_nr = torch.where(rain_lim, -nr / dt, l_nr)

    dot_rv = dot_rv - (l_rc + l_rr)
    dot_th = dot_th - (l_rc + l_rr) * theta_dry.d_th_d_rv(T, th)
    dot_rc = dot_rc + l_rc
    dot_rr = dot_rr + l_rr
    dot_nc = dot_nc + l_nc
    dot_nr = dot_nr + l_nr

    # --- collisions, skipped where all cloud water evaporated
    # (rhs_cellwise.hpp:228-299)
    collide = ~cloud_lim
    l_rc, l_rr, l_nc, l_nr = zero, zero, zero, zero

    if opts.acnv:
        a_ok = collide & (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc))
        rate = f.autoconv_rate(
            torch.clamp(rc, min=0.0), torch.where(nc > 0, nc, 1.0), rhod,
            opts.acnv_A, opts.acnv_b, opts.acnv_c,
        )
        acnv_hits_cap = rate >= rc / dt
        rate = torch.where(a_ok, torch.minimum(rate, rc / dt), 0.0)
        l_rc = l_rc - rate
        l_rr = l_rr + rate
        # all fresh drizzle assumed at drizzle_radius (rhs_cellwise.hpp:252-255)
        l_nr = l_nr + rate / (
            4.0 / 3 * c.pi * c.rho_w * f.drizzle_radius**3
        )
        cloud_lim = cloud_lim | (a_ok & acnv_hits_cap)

    if opts.accr:
        k_ok = (
            collide & ~cloud_lim & ~rain_lim
            & (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc)) & (rr > f.rr_eps(rr))
        )
        rate = torch.where(k_ok, f.accretion_rate(torch.clamp(rc, min=0.0),
                                                  torch.clamp(rr, min=0.0)),
                           0.0)
        l_rc_new = l_rc - rate
        accr_hits_cap = l_rc_new <= -rc / dt
        l_rc = torch.maximum(l_rc_new, -rc / dt)
        l_rr = l_rr + rate
        cloud_lim = cloud_lim | (k_ok & accr_hits_cap)

    if opts.acnv or opts.accr:
        # sink of nc combined for autoconversion + accretion
        # (KK2000 eq. 35; rhs_cellwise.hpp:272-295)
        s_ok = collide & ~cloud_lim & (nc > f.nc_eps(nc)) & (l_rr > f.rr_eps(rr))
        rdrop = f.r_drop_c(
            torch.where(s_ok, rc, 1e-6), torch.where(s_ok, nc, 1e6), rhod
        )
        sink = f.collision_sink_rate(l_rr, torch.where(s_ok, rdrop, 1.0))
        sink = torch.minimum(sink, nc / dt)
        l_nc = l_nc - torch.where(s_ok, sink, 0.0)
        # if all cloud water was converted, zero out nc
        l_nc = torch.where(collide & cloud_lim, -nc / dt, l_nc)

    dot_rc = dot_rc + torch.where(collide, l_rc, 0.0)
    dot_rr = dot_rr + torch.where(collide, l_rr, 0.0)
    dot_nc = dot_nc + torch.where(collide, l_nc, 0.0)
    dot_nr = dot_nr + torch.where(collide, l_nr, 0.0)
    return dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr
