"""Saturation adjustment of the single-moment bulk scheme
(libcloudphxx_tpu/blk_1m/adj_cellwise.py; reference
include/libcloudph++/blk_1m/adj_cellwise.hpp).

The reference loops per cell with either a Newton-Raphson iteration
(adj_cellwise.hpp:90-182) or an adaptive RK4 path integration driven by a
per-cell ``while`` (adj_cellwise.hpp:186-319).  Here both run over the
whole grid: Newton-Raphson unrolls its fixed iteration count; RK4 steps
every cell together with a per-cell active mask, in chunks of iterations
with one host test a chunk (adj_cellwise_rk4).

All functions return updated copies of (th, rv, rc[, rr]).
"""

import torch

from ..common import const_cp, constants as c, theta_dry, theta_std
from . import formulae
from .options import opts_t

# RK4 iterations between two host tests of whether any cell is still active
RK4_CHUNK = 16


def _T_p(opts, th, rv, rhod, p):
    """Temperature/pressure from the two supported theta conventions
    (reference adj_cellwise.hpp:60-72)."""
    opts.validate_theta_convention()
    if opts.th_dry:   # variable pressure, dry theta
        T = theta_dry.T(th, rhod)
        p_full = theta_dry.p(rhod, rv, T)
    else:             # constant pressure, standard theta
        T = th * theta_std.exner(p)
        p_full = p
    return T, p_full


def adj_cellwise_nwtrph(opts: opts_t, rhod, p, th, rv, rc, dt):
    """Newton-Raphson saturation adjustment (reference adj_cellwise.hpp:90-182).

    Returns (th, rv, rc) updated; the ``nwtrph_iters`` iterations unroll.
    """
    if not opts.cond:
        return th, rv, rc

    T, p_full = _T_p(opts, th, rv, rhod, p)
    exner = None if opts.th_dry else theta_std.exner(p)
    L0 = const_cp.l_v(T)

    drc = torch.zeros_like(rv)
    rv_tmp = rv
    th_tmp = th
    T_tmp = T
    p_cur = p_full
    for _ in range(opts.nwtrph_iters):
        p_vs = const_cp.p_vs(T_tmp)
        L = const_cp.l_v(T_tmp)
        coeff = L * L0 / (c.c_pd * c.R_v) / (T_tmp * T_tmp) / (1 - p_vs / p_cur)
        r_vs = const_cp.r_vs(T_tmp, p_cur)
        drc = drc + (rv_tmp - r_vs) / (1 + coeff * r_vs)
        rv_tmp = rv - drc
        th_tmp = th + th_tmp / T_tmp * L0 / c.c_pd * drc
        if opts.th_dry:
            T_tmp = theta_dry.T(th_tmp, rhod)
            p_cur = theta_dry.p(rhod, rv_tmp, T_tmp)
        else:
            T_tmp = th_tmp * exner

    # limiting: cannot condense more vapour than present nor evaporate more
    # cloud water than present (adj_cellwise.hpp:171)
    drc = torch.minimum(rv, torch.maximum(-rc, drc))

    rv = rv - drc
    rc = rc + drc
    th = th + th / T * L0 / c.c_pd * drc
    return th, rv, rc


def _dth_drv(opts, th, rv, rhod, p):
    """d(theta)/d(rv) along the condensation path — the ODE rhs of
    reference adj_cellwise.hpp:21-105 (detail::rhs)."""
    T, _ = _T_p(opts, th, rv, rhod, p)
    return theta_dry.d_th_d_rv(T, th)


def _rk4_iteration(opts, rhod, p, state):
    """One iteration of the RK4 adjustment over the grid
    (adj_cellwise.hpp:255-318).  ``state`` = (th, rv, rc, rr, drr_max,
    alive); returns the next state and the cells that were active.  A cell
    that is not active keeps its state bitwise, and so stays inactive."""
    th, rv, rc, rr, drr_max, alive = state
    r_eps = opts.r_eps
    T, p_full = _T_p(opts, th, rv, rhod, p)
    excess = rv - const_cp.r_vs(T, p_full)
    incloud = rc > 0
    evap_on = excess < -r_eps
    if opts.cevp:
        src = incloud
        if opts.revp:
            src = src | ((rr > 0) & (drr_max > 0))
        evap_on = evap_on & src
    else:
        evap_on = torch.zeros_like(incloud)
    active = ((excess > r_eps) | evap_on) & alive

    # step size: at most r_eps/2 towards saturation
    # (adj_cellwise.hpp:276-281)
    drv = -torch.sign(excess) * torch.clamp(0.5 * torch.abs(excess),
                                            max=0.5 * r_eps)
    evap = excess < 0
    drv = torch.where(evap & incloud, torch.minimum(rc, drv), drv)
    drv = torch.where(evap & ~incloud,
                      torch.minimum(drr_max, torch.minimum(rr, drv)), drv)
    drv = torch.where(active, drv, 0.0)

    # one classic RK4 step of d(th)/d(rv) over [rv, rv+drv]
    # (adj_cellwise.hpp:289-295 via boost::odeint::runge_kutta4); an idle
    # cell keeps th even where its k is not finite
    k1 = _dth_drv(opts, th, rv, rhod, p)
    k2 = _dth_drv(opts, th + 0.5 * drv * k1, rv + 0.5 * drv, rhod, p)
    k3 = _dth_drv(opts, th + 0.5 * drv * k2, rv + 0.5 * drv, rhod, p)
    k4 = _dth_drv(opts, th + drv * k3, rv + drv, rhod, p)
    th = torch.where(active, th + drv / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4), th)
    rv = rv + drv

    # attribute the change to cloud or rain water
    # (adj_cellwise.hpp:305-318)
    to_cloud = (excess > 0) | incloud
    rc = torch.where(active & to_cloud, rc - drv, rc)
    rain_evap = active & ~to_cloud
    rr = torch.where(rain_evap, rr - drv, rr)
    drr_max = torch.where(rain_evap, drr_max - drv, drr_max)
    # Kessler cap exhausted -> the cell leaves the loop
    alive = alive & ~(rain_evap & (drr_max <= 0))
    return (th, rv, rc, rr, drr_max, alive), active


def adj_cellwise_rk4(opts: opts_t, rhod, p, th, rv, rc, rr, dt,
                     max_iters=10_000):
    """RK4 path-integrated saturation adjustment
    (reference adj_cellwise.hpp:189-319).

    The reference steps each cell's (th, rv) along the saturation path in
    increments of at most r_eps/2, with cloud-then-rain evaporation limits,
    until |rv - r_vs| <= r_eps.  Here the whole grid iterates together, a
    cell that is done idle; the JAX package's ``lax.while_loop`` runs while
    any cell is alive, at most ``max_iters`` times.  An idle cell's state
    does not change, so it never becomes active again, and the iterations
    after the last active one change nothing: the loop runs RK4_CHUNK
    iterations between two host tests of whether the last one had an
    active cell, and stops there or at exactly ``max_iters``.  The result
    is bitwise that of testing after every iteration.
    Returns (th, rv, rc, rr) updated.
    """
    if not opts.cond:
        return th, rv, rc, rr

    # Kessler rain-evaporation cap, computed once per call
    # (adj_cellwise.hpp:244-251)
    if opts.revp:
        T0, p_full0 = _T_p(opts, th, rv, rhod, p)
        rs0 = const_cp.r_vs(T0, p_full0)
        drr_max = torch.where(
            (rs0 > rv) & (rr > 0),
            dt * formulae.evaporation_rate(rv, rs0, rr, rhod, p_full0), 0.0)
    else:
        drr_max = torch.zeros_like(rv)

    state = (th, rv, rc, rr, drr_max, torch.ones_like(rv, dtype=torch.bool))
    it = 0
    while it < max_iters:
        for _ in range(min(RK4_CHUNK, max_iters - it)):
            state, active = _rk4_iteration(opts, rhod, p, state)
            it += 1
        if not bool(active.any()):
            break
    return state[:4]


def adj_cellwise(opts: opts_t, rhod, p, th, rv, rc, rr, dt):
    """Dispatcher mirroring reference adj_cellwise.hpp:322-340.
    Returns (th, rv, rc, rr) updated."""
    if opts.adj_nwtrph:
        th, rv, rc = adj_cellwise_nwtrph(opts, rhod, p, th, rv, rc, dt)
        return th, rv, rc, rr
    return adj_cellwise_rk4(opts, rhod, p, th, rv, rc, rr, dt)
