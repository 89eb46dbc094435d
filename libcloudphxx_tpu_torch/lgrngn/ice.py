"""The ice phase: singular and time-dependent freezing, melting, and
depositional growth (libcloudphxx_tpu/lgrngn/ice.py; reference
src/impl/ice/particles_impl_ice_nucl_melt.ipp, particles_impl_ice_dep.ipp
and common/ice_nucleation.hpp).

An ice crystal is a spheroid with equatorial and polar semi-axes (ice_a,
ice_c) and an apparent density ice_rho; a frozen SD has rw2 == 0 and
ice_a * ice_c > 0, so the liquid growth of the condensation skips it.

The time-dependent freezing draws its uniforms from Philox (ops/philox.py
FREEZE), keyed by the run's seed and the state's step counter, one a slot;
the JAX package draws them from jax.random, so the two freeze the same SDs
only where they are given the same draws.

ice_dep_substep is the plain reference of the deposition on the flat
State; the condensation's ice branch runs the same arithmetic over the
cell-sorted SDs (dep_rate here, ops/cond.py cond_flat_plain, and kernel
F's ice forms, csrc/cond_cell.cuh IceDep, on the card).
"""

import dataclasses

import torch

from ..common import constants as c
from ..common import const_cp, ice_nucleation, maxwell_mason
from ..common import mean_free_path, moist_air, theta_dry
from ..common import transition_regime, ventil
from ..ops import philox
from . import hskpng
from .state import State, StaticConfig


def ice_mass(ice_a, ice_c, ice_rho):
    """The spheroid's mass 4/3 pi a^2 c rho (reference detail::ice_mass)."""
    return 4.0 / 3 * c.pi * ice_a * ice_a * ice_c * ice_rho


def _liquid_mom3(cfg: StaticConfig, state: State):
    """The specific third wet moment of the liquid SDs of each cell."""
    liquid = (state.rw2 > 0) & (state.n > 0)
    nf = torch.where(liquid, state.n, 0.0)
    rw3 = state.rw2 * torch.sqrt(torch.clamp(state.rw2, min=0.0))
    return hskpng.segment_moment(cfg, nf, rw3, 1.0, state.ijk, state.dv,
                                 state.rhod)


def freeze_u01(state: State):
    """The time-dependent freezing's uniforms in [0, 1), float64, one a
    slot: word 0 of Philox(key=(seed, rng_key), ctr=(rng_step, 0, FREEZE,
    slot)) times 2**-32."""
    bits = philox.draw_substeps(state.rng_seed, state.rng_step, 1,
                                philox.FREEZE, state.n.shape[0],
                                state.n.device, key1=state.rng_key)[0]
    return bits.to(torch.float64) * 2.0 ** -32


def ice_nucl_melt(cfg: StaticConfig, state: State, dt, time_dep: bool,
                  inp_type=ice_nucleation.INP.mineral) -> State:
    """Freezing and melting, with the latent heat of freezing in each cell
    (libcloudphxx_tpu/lgrngn/ice.py:38-87; reference
    ice_nucl_melt.ipp:20-230).  Singular: a liquid SD freezes where its
    T_freeze reaches its cell's T and the cell is saturated; time-dependent
    (``time_dep``): where its uniform (freeze_u01) lies below p_freeze, the
    step counter then advancing by one.  A frozen SD's axes are the
    volume-equivalent sphere's at ice density; a frozen SD above 273.15 K
    melts back to the liquid of its mass."""
    mom3_before = _liquid_mom3(cfg, state)
    rw = torch.sqrt(torch.clamp(state.rw2, min=0.0))
    axis = rw * (c.rho_w / c.rho_i) ** (1.0 / 3)
    T_sd = state.T[state.ijk]
    if time_dep:
        p_fr = ice_nucleation.p_freeze(
            state.rd2_insol, torch.clamp(state.rw2, min=1e-300), T_sd, dt,
            inp_type)
        freeze = (state.rw2 > 0) & (freeze_u01(state) < p_fr.double())
        state = dataclasses.replace(state, rng_step=state.rng_step + 1)
    else:
        freeze = (state.rw2 > 0) & (state.T_freeze >= T_sd) \
            & (state.RH[state.ijk] >= 1.0)
    ice_a = torch.where(freeze, axis, state.ice_a)
    ice_c = torch.where(freeze, axis, state.ice_c)
    ice_rho = torch.where(freeze, c.rho_i, state.ice_rho)
    rw2 = torch.where(freeze, 0.0, state.rw2)

    # melting (ice_nucl_melt.ipp detail::melt)
    melt = (ice_a * ice_c > 0) & (T_sd > 273.15)
    rw2 = torch.where(
        melt, (c.rho_i / c.rho_w * ice_c) ** (2.0 / 3) * ice_a ** (4.0 / 3),
        rw2)
    ice_a = torch.where(melt, 0.0, ice_a)
    ice_c = torch.where(melt, 0.0, ice_c)
    ice_rho = torch.where(melt, 0.0, ice_rho)
    state = dataclasses.replace(state, rw2=rw2, ice_a=ice_a, ice_c=ice_c,
                                ice_rho=ice_rho)

    # the latent heat of freezing from the change of the liquid water
    # (update_th_freezing, particles_impl_update_th_rv.ipp:188-240)
    drw = (_liquid_mom3(cfg, state) - mom3_before) * 4.0 / 3 * c.pi * c.rho_w
    th = state.th + drw * theta_dry.d_th_d_rw_freeze(state.T, state.th)
    return dataclasses.replace(state, th=th)


def dep_rate(x, vt, rhod, rv, T, p, RH_i, eta, lambda_D, lambda_K, RH_max):
    """d(axis)/dt of a spheroid's semi-axis ``x``: 2 rdrdt_i at the
    sphere of radius x, with the liquid growth's transition-regime and
    ventilation corrections (reference cond_common.ipp:332-430,
    advance_ice_ac :432-473), over 2 x (libcloudphxx_tpu/lgrngn/ice.py:
    89-103, 129-133)."""
    r = torch.sqrt(torch.clamp(x * x, min=1e-300))
    Re = ventil.Re(vt, r, rhod, eta)
    Sc = ventil.Sc(eta, rhod, c.D_0)
    Pr = ventil.Pr(eta, c.c_pd, c.K_0)
    D = c.D_0 * transition_regime.beta(lambda_D / r) * (ventil.Sh(Sc, Re) / 2)
    K = c.K_0 * transition_regime.beta(lambda_K / r) * (ventil.Nu(Pr, Re) / 2)
    return 2.0 * maxwell_mason.rdrdt_i(
        D, K, rhod * rv, T, p, torch.clamp(RH_i, max=RH_max)) / (2 * x)


def dep_axes(is_ice, ice_a, ice_c, vt, rhod, rv, T, p, eta, dt_sub, RH_max):
    """One forward-Euler substep of the axes of the SDs that ``is_ice``
    marks, at their cells' values (per SD), each clamped at 1e-9; the
    others keep theirs.  The mean free paths are fresh, from this T and p
    (libcloudphxx_tpu/lgrngn/ice.py:117-137).  Returns (ice_a, ice_c)."""
    # the RH with respect to ice (libcloudphxx_tpu/lgrngn/ice.py:122-123)
    RH_i = moist_air.p_v(p, rv) / const_cp.p_vsi(T)
    lam_D = mean_free_path.lambda_D(T)
    lam_K = mean_free_path.lambda_K(T, p)
    a = torch.where(is_ice, ice_a, 1e-6)
    cc = torch.where(is_ice, ice_c, 1e-6)
    rate = lambda x: dep_rate(x, vt, rhod, rv, T, p, RH_i, eta, lam_D,
                              lam_K, RH_max)
    a_new = torch.clamp(a + dt_sub * rate(a), min=1e-9)
    c_new = torch.clamp(cc + dt_sub * rate(cc), min=1e-9)
    return torch.where(is_ice, a_new, ice_a), torch.where(is_ice, c_new,
                                                          ice_c)


def dep_volume(a, cc, a_new, c_new):
    """(a_new^2 c_new - a^2 c) as da (2a + da) c_new + a^2 dc, without the
    cancellation of the two volumes."""
    da, dc = a_new - a, c_new - cc
    return da * (2.0 * a + da) * c_new + a * a * dc


def ice_dep_substep(cfg: StaticConfig, state: State, dt_sub, RH_max):
    """The depositional growth of one condensation substep on the flat
    State, and its cells' rv and th (libcloudphxx_tpu/lgrngn/ice.py:106-148;
    reference ice_dep.ipp:13-133): each frozen live SD's axes advance at
    its cell's T, p and eta (the substep's closure) and rv; the ice mass
    the cell gains leaves its vapour, and theta takes the heat of
    deposition at the cell's T.  The cell sums are float64 cumulative sums
    in cell order (condensation.cell_sum)."""
    from .condensation import cell_ends, cell_sum
    is_ice = (state.ice_a > 0) & (state.ice_c > 0) & (state.n > 0)
    g = lambda a: a[state.ijk]
    ice_a, ice_c = dep_axes(is_ice, state.ice_a, state.ice_c, state.vt,
                            g(state.rhod), g(state.rv), g(state.T),
                            g(state.p), g(state.eta), dt_sub, RH_max)
    dm = torch.where(is_ice, 4.0 / 3 * c.pi * state.n * state.ice_rho
                     * dep_volume(state.ice_a, state.ice_c, ice_a, ice_c),
                     0.0)
    sijk, order = torch.sort(state.ijk, stable=True)
    d_ice = cell_sum(dm[order], cell_ends(sijk, cfg.n_cell)).to(
        state.th.dtype)
    if cfg.n_dims > 0:
        d_ice = d_ice / state.dv / state.rhod
    return dataclasses.replace(
        state, ice_a=ice_a, ice_c=ice_c, rv=state.rv - d_ice,
        th=state.th - d_ice * theta_dry.d_th_d_rv_dep(state.T, state.th))
