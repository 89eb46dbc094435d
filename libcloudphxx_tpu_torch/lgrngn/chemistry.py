"""Aqueous-phase chemistry of the flat engine
(libcloudphxx_tpu/lgrngn/chemistry.py; reference src/impl/chemistry/ and
src/impl/initialization/particles_impl_init_chem.ipp).

  - ``chem_henry``: the implicit (Warneck eq. 8.22) dissolution of the
    trace gases into each SD, with a mass-transfer timescale and the
    pH-corrected effective Henry constants (particles_impl_chem_henry.ipp:
    66-260), and the closed-system decrement of each cell's gases
    (:330-425);
  - ``chem_dissoc``: each droplet's electroneutral H+ by the batched
    bracketed root find of ops/rootfind.py (44 iterations;
    particles_impl_chem_dissoc.ipp:17-147);
  - ``chem_react``: the S(IV) -> S(VI) oxidation by O3 and H2O2 in one
    fixed RK4 step, then the dry radius grown by the sulfate made
    (particles_impl_chem_react.ipp:221-318);
  - ``chem_flag``: the dilute-droplet gate, ionic strength below 20
    mol/m3 (particles_impl_chem_strength.ipp:14-110);
  - ``sstp_chem_loop``: step_cond's chemistry substeps (particles_step.ipp:
    272-310, particles_impl_sstp_chem.ipp);
  - ``init_chem_aq``: the initial NH4HSO4 aerosol (particles_impl_init_
    chem.ipp:33-225).

No kernel: plain PyTorch over the population, as the JAX package runs it
in XLA.  The per-cell sums (the gases a cell's droplets take up) are
index_add_ sums in the State's dtype, as the JAX package's segment_sum.
"""

import dataclasses

import torch

from ..common import chem as cc
from ..common import constants as c
from ..ops.rootfind import solve_bracketed
from .state import State, StaticConfig

# species order (common/chem.hpp:9-22): gases first, then S_VI and H
HNO3, NH3, CO2, SO2, H2O2, O3, S_VI, H = range(8)

# per-gas property tables in species order [HNO3, NH3, CO2, SO2, H2O2, O3]
_H0 = (cc.H_HNO3, cc.H_NH3, cc.H_CO2, cc.H_SO2, cc.H_H2O2, cc.H_O3)
_DHR = (cc.dHR_HNO3, cc.dHR_NH3, cc.dHR_CO2, cc.dHR_SO2, cc.dHR_H2O2,
        cc.dHR_O3)
_M_GAS = (cc.M_HNO3, cc.M_NH3, cc.M_CO2, cc.M_SO2, cc.M_H2O2, cc.M_O3)
_M_AQ = (cc.M_HNO3, cc.M_NH3_H2O, cc.M_CO2_H2O, cc.M_SO2_H2O, cc.M_H2O2,
         cc.M_O3)
_D_GAS = (cc.D_HNO3, cc.D_NH3, cc.D_CO2, cc.D_SO2, cc.D_H2O2, cc.D_O3)
_AC = (cc.ac_HNO3, cc.ac_NH3, cc.ac_CO2, cc.ac_SO2, cc.ac_H2O2, cc.ac_O3)

# electroneutrality H+ search bracket (chem_dissoc.ipp:118-121):
# concentrations 1e-8..1e1 mol/l -> mol/m3
_CONC_H_MIN = 1e-8 * 1e3
_CONC_H_MAX = 1e1 * 1e3
_DISSOC_ITERS = 44


def _dissoc_consts(T):
    """Temperature-corrected dissociation constants (dissoc.hpp:42-51)."""
    K = cc.dissoc_temp
    return dict(
        CO2=K(T, cc.K_CO2, cc.dKR_CO2),
        HCO3=K(T, cc.K_HCO3, cc.dKR_HCO3),
        SO2=K(T, cc.K_SO2, cc.dKR_SO2),
        HSO3=K(T, cc.K_HSO3, cc.dKR_HSO3),
        NH3=K(T, cc.K_NH3, cc.dKR_NH3),
        HNO3=K(T, cc.K_HNO3, cc.dKR_HNO3),
        HSO4=K(T, cc.K_HSO4, cc.dKR_HSO4),
    )


def _V_of(rw2):
    """Droplet volume (chem_ante.ipp chem_vol_fun)."""
    return 4.0 / 3 * c.pi * rw2 * torch.sqrt(torch.clamp(rw2, min=0.0))


def chem_flag(chem, V, T_sd, rw2):
    """Dilute-droplet gate: ionic strength < 0.02 mol/l == 20 mol/m3
    (reference set_chem_flag, particles_impl_chem_strength.ipp:14-68)."""
    Vs = torch.clamp(V, min=1e-300)
    conc_S_IV = chem[SO2] / cc.M_SO2_H2O / Vs
    conc_C_IV = chem[CO2] / cc.M_CO2_H2O / Vs
    conc_N_V = chem[HNO3] / cc.M_HNO3 / Vs
    conc_N_III = chem[NH3] / cc.M_NH3_H2O / Vs
    conc_S_VI = chem[S_VI] / cc.M_H2SO4 / Vs
    conc_H = torch.clamp(chem[H] / cc.M_H / Vs, min=1e-300)
    K = _dissoc_consts(T_sd)
    strength = 0.5 * (
        conc_H
        + cc.K_H2O / conc_H
        + conc_H * conc_S_VI / (conc_H + K["HSO4"])
        + 4.0 * K["HSO4"] * conc_S_VI / (conc_H + K["HSO4"])
        + K["CO2"] * conc_H * conc_C_IV
        / (conc_H**2 + K["CO2"] * conc_H + K["CO2"] * K["HCO3"])
        + 4.0 * K["CO2"] * K["HCO3"] * conc_C_IV
        / (conc_H**2 + K["CO2"] * conc_H + K["CO2"] * K["HCO3"])
        + K["SO2"] * conc_H * conc_S_IV
        / (conc_H**2 + K["SO2"] * conc_H + K["SO2"] * K["HSO3"])
        + 4.0 * K["SO2"] * K["HSO3"] * conc_S_IV
        / (conc_H**2 + K["SO2"] * conc_H + K["SO2"] * K["HSO3"])
        + K["HNO3"] * conc_N_V / (conc_H + K["HNO3"])
        + K["NH3"] * conc_H * conc_N_III / (cc.K_H2O + K["NH3"] * conc_H)
    )
    return (V > 0) & (strength < 0.02 * 1000)


def _henry_effective(i, T, conc_H, K):
    """pH-corrected effective Henry constant for species i
    (chem_Henry_fun switch, chem_henry.ipp:127-190)."""
    Ht = cc.henry_temp(T, _H0[i], _DHR[i])
    if i == SO2:
        hlp = 1.0 + K["SO2"] / conc_H + K["SO2"] * K["HSO3"] / conc_H**2
    elif i == CO2:
        hlp = 1.0 + K["CO2"] / conc_H + K["CO2"] * K["HCO3"] / conc_H**2
    elif i == HNO3:
        hlp = 1.0 + K["HNO3"] / conc_H
    elif i == NH3:
        hlp = 1.0 + K["NH3"] / cc.K_H2O * conc_H
    else:  # O3, H2O2: physical solubility only
        hlp = 1.0
    return Ht * hlp


def chem_henry(cfg: StaticConfig, state: State, dt, flag) -> State:
    """Gas absorption by Henry's law, implicit in the dissolved mass
    (chem_henry.ipp:192-213 'mass_helper'), and the closed-system ambient
    decrement per cell clamped at zero (:44-63, :330-425)."""
    g = lambda arr: arr[state.ijk]
    T_sd, p_sd, rhod_sd = g(state.T), g(state.p), g(state.rhod)
    V = _V_of(state.rw2)
    conc_H = torch.clamp(
        state.chem[H] / cc.M_H / torch.clamp(V, min=1e-300), min=1e-300)
    K = _dissoc_consts(T_sd)

    chem = state.chem.clone()
    ambient = state.ambient_chem.clone()
    n_w = state.n  # multiplicity weights for the per-cell mass budget
    for i in range(6):
        m_old = chem[i]
        Henry = _henry_effective(i, T_sd, conc_H, K)
        mt = cc.mass_trans(state.rw2, _D_GAS[i], _AC[i], T_sd, _M_GAS[i])
        conc_gas = ambient[i][state.ijk]
        m_new = (
            m_old
            + dt * V * mt * conc_gas * rhod_sd * (_M_AQ[i] / _M_GAS[i])
        ) / (1.0 + dt * mt / torch.clamp(Henry, min=1e-300) / c.kaBoNA
             / torch.clamp(T_sd, min=1.0))
        m_new = torch.where(flag, m_new, m_old)

        # ambient trace gas decremented by the per-cell dissolved-mass change
        # (ambient_chem_calculator, chem_henry.ipp:44-63)
        dm_cell = torch.zeros_like(ambient[i]).index_add_(
            0, state.ijk, n_w * (m_new - m_old))
        new_c = ambient[i] - dm_cell / _M_AQ[i] * _M_GAS[i] / state.dv \
            / state.rhod
        ambient[i] = torch.clamp(new_c, min=0.0)
        chem[i] = torch.clamp(m_new, min=0.0)

    return dataclasses.replace(state, chem=chem, ambient_chem=ambient)


def _electroneutrality_residual(m_H, chem, V, K):
    """-m_H + M_H * (sum of dissociated ion amounts) — the root is the H+
    mass keeping the droplet electroneutral (chem_minfun,
    chem_dissoc.ipp:42-104)."""
    Vs = torch.clamp(V, min=1e-300)
    conc_H = torch.clamp(m_H / cc.M_H / Vs, min=1e-300)
    den_S = 1.0 + K["SO2"] / conc_H + K["SO2"] * K["HSO3"] / conc_H**2
    den_C = 1.0 + K["CO2"] / conc_H + K["CO2"] * K["HCO3"] / conc_H**2
    return -m_H + cc.M_H * (
        cc.K_H2O * cc.M_H * Vs * Vs / torch.clamp(m_H, min=1e-300)
        + chem[SO2] / cc.M_SO2_H2O * K["SO2"] / conc_H / den_S
        + 2.0 * chem[SO2] / cc.M_SO2_H2O * K["SO2"] * K["HSO3"]
        / conc_H**2 / den_S
        + conc_H * chem[S_VI] / cc.M_H2SO4 / (conc_H + K["HSO4"])
        + 2.0 * K["HSO4"] * chem[S_VI] / cc.M_H2SO4 / (conc_H + K["HSO4"])
        + chem[CO2] / cc.M_CO2_H2O * K["CO2"] / conc_H / den_C
        + 2.0 * chem[CO2] / cc.M_CO2_H2O * K["CO2"] * K["HCO3"]
        / conc_H**2 / den_C
        + chem[HNO3] / cc.M_HNO3 * K["HNO3"] / conc_H
        / (1.0 + K["HNO3"] / conc_H)
        - chem[NH3] / cc.M_NH3_H2O * K["NH3"] / cc.K_H2O * conc_H
        / (1.0 + K["NH3"] / cc.K_H2O * conc_H)
    )


def chem_dissoc(cfg: StaticConfig, state: State, flag) -> State:
    """Electroneutral H+ after dissociation (chem_electroneutral,
    chem_dissoc.ipp:106-147): one batched bracketed root solve."""
    g = lambda arr: arr[state.ijk]
    T_sd = g(state.T)
    V = _V_of(state.rw2)
    Vs = torch.clamp(V, min=1e-300)
    K = _dissoc_consts(T_sd)

    lo = _CONC_H_MIN * Vs * cc.M_H
    hi = _CONC_H_MAX * Vs * cc.M_H
    fn = lambda m_H: _electroneutrality_residual(m_H, state.chem, Vs, K)
    m_H = solve_bracketed(fn, lo, hi, iters=_DISSOC_ITERS)
    chem = state.chem.clone()
    chem[H] = torch.where(flag, m_H, state.chem[H])
    return dataclasses.replace(state, chem=chem)


def _oxidation_rates(chem, V, T_sd, dt):
    """Amount rates [mol/s] of the O3 and H2O2 S(IV)->S(VI) paths, each
    limited so one dt cannot consume more oxidant/S_IV than present
    (chem_rhs_helper, chem_react.ipp:18-116)."""
    Vs = torch.clamp(V, min=1e-300)
    conc_H = torch.clamp(chem[H] / cc.M_H / Vs, min=1e-300)
    Kt_SO2 = cc.dissoc_temp(T_sd, cc.K_SO2, cc.dKR_SO2)
    Kt_HSO3 = cc.dissoc_temp(T_sd, cc.K_HSO3, cc.dKR_HSO3)
    R_k0 = cc.react_temp(T_sd, cc.R_S_O3_k0, cc.dER_O3_k0)
    R_k1 = cc.react_temp(T_sd, cc.R_S_O3_k1, cc.dER_O3_k1)
    R_k2 = cc.react_temp(T_sd, cc.R_S_O3_k2, cc.dER_O3_k2)
    R_h = cc.react_temp(T_sd, cc.R_S_H2O2_k, cc.dER_H2O2_k)

    den = 1.0 + Kt_SO2 / conc_H + Kt_SO2 * Kt_HSO3 / conc_H**2
    amt_O3 = chem[O3] / cc.M_O3
    amt_S_IV = chem[SO2] / cc.M_SO2_H2O
    amt_H2O2 = chem[H2O2] / cc.M_H2O2

    O3_react = (
        Vs * (amt_O3 / Vs) * (amt_S_IV / Vs) / den
        * (R_k0 + R_k1 * Kt_SO2 / conc_H + R_k2 * Kt_SO2 * Kt_HSO3 / conc_H**2)
    )
    O3_react = torch.minimum(O3_react, amt_O3 / dt)
    O3_react = torch.minimum(O3_react, amt_S_IV / dt)

    H2O2_react = (
        Vs * R_h * Kt_SO2 * (amt_H2O2 / Vs) * (amt_S_IV / Vs)
        / den / (1.0 + cc.R_S_H2O2_K * conc_H)
    )
    H2O2_react = torch.minimum(H2O2_react, amt_H2O2 / dt)
    # silently gives precedence to the O3 path (chem_react.ipp:92-95)
    H2O2_react = torch.minimum(H2O2_react, amt_S_IV / dt - O3_react)
    H2O2_react = torch.clamp(H2O2_react, min=0.0)
    return O3_react, H2O2_react


def chem_react(cfg: StaticConfig, state: State, dt, flag) -> State:
    """Oxidation via fixed-step RK4 over [SO2, H2O2, O3, S_VI] masses
    (chem_react.ipp:262-306, chem_stepper runge_kutta4), then the dry-radius
    increase from produced H2SO4 (chem_new_rd3, :221-255)."""
    g = lambda arr: arr[state.ijk]
    T_sd = g(state.T)
    V = _V_of(state.rw2)

    def rhs(ch):
        O3_r, H2O2_r = _oxidation_rates(ch, V, T_sd, dt)
        return {
            SO2: -cc.M_SO2_H2O * (O3_r + H2O2_r),
            S_VI: cc.M_H2SO4 * (O3_r + H2O2_r),
            H2O2: -cc.M_H2O2 * H2O2_r,
            O3: -cc.M_O3 * O3_r,
        }

    def apply(ch, deriv, h):
        out = ch.clone()
        for idx, d in deriv.items():
            out[idx] = out[idx] + h * torch.where(flag, d, 0.0)
        return out

    ch0 = state.chem
    k1 = rhs(ch0)
    k2 = rhs(apply(ch0, k1, dt / 2))
    k3 = rhs(apply(ch0, k2, dt / 2))
    k4 = rhs(apply(ch0, k3, dt))
    chem = ch0.clone()
    for idx in (SO2, S_VI, H2O2, O3):
        incr = (k1[idx] + 2 * k2[idx] + 2 * k3[idx] + k4[idx]) / 6.0
        chem[idx] = chem[idx] + dt * torch.where(flag, incr, 0.0)
    chem = torch.clamp(chem, min=0.0)

    # dry radius grows with the created sulfate mass (chem_new_rd3)
    d_S6 = chem[S_VI] - ch0[S_VI]
    rd3_new = state.rd3 + torch.where(
        flag, 0.75 / c.pi / cfg.chem_rho * d_S6, 0.0
    )
    return dataclasses.replace(state, chem=chem, rd3=rd3_new)


def sstp_save_chem(state: State) -> State:
    """Snapshot ambient gases for substepping (sstp_chem.ipp:15-33)."""
    if state.ambient_chem.shape[1] == 0:
        return state
    return dataclasses.replace(state, sstp_tmp_chem=state.ambient_chem)


def sstp_chem_loop(cfg: StaticConfig, state: State, dt,
                   do_dsl: bool, do_dsc: bool, do_rct: bool) -> State:
    """The chemistry branch of step_cond (particles_step.ipp:272-310):
    for each of sstp_chem substeps feed 1/sstp of the advective ambient-gas
    delta (sstp_percell_step_chem), then Henry -> dissociation -> oxidation,
    clamping negatives after each phase (chem_cleanup)."""
    sstp = cfg.sstp_chem
    dt_sub = dt / sstp
    delta = state.ambient_chem - state.sstp_tmp_chem
    # rewind to pre-sync values; increments feed back per substep
    state = dataclasses.replace(state, ambient_chem=state.sstp_tmp_chem)

    for _ in range(sstp):
        st = state
        if do_dsl:
            st = dataclasses.replace(
                st, ambient_chem=st.ambient_chem + delta / sstp
            )
        V = _V_of(st.rw2)
        flag = chem_flag(st.chem, V, st.T[st.ijk], st.rw2) & (st.n > 0)
        if do_dsl:
            st = chem_henry(cfg, st, dt_sub, flag)
        if do_dsc:
            st = chem_dissoc(cfg, st, flag)
        if do_rct:
            st = chem_react(cfg, st, dt_sub, flag)
        state = st
    if not do_dsl:
        # the gas delta was never consumed; restore the synced values
        state = dataclasses.replace(
            state, ambient_chem=state.sstp_tmp_chem + delta
        )
    return sstp_save_chem(state)


def init_chem_aq(rd3, chem_rho):
    """Initial per-SD aqueous masses assuming NH4HSO4 aerosol
    (init_chem.ipp:33-225): the dry mass splits into NH4+(as NH3*H2O),
    H+ and S_VI(as H2SO4); everything else starts at zero."""
    dry_mass = 4.0 / 3 * c.pi * chem_rho * rd3
    denom = cc.M_NH4 + cc.M_HSO4
    chem = rd3.new_zeros((8, rd3.shape[0]))
    chem[NH3] = dry_mass * cc.M_NH3_H2O / denom
    chem[H] = dry_mass * cc.M_H / denom
    chem[S_VI] = dry_mass * cc.M_H2SO4 / denom
    return chem
