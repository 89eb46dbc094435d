"""Single-moment bulk (Kessler) warm-rain and Grabowski-1999 ice formulae
(libcloudphxx_tpu/blk_1m/formulae.py; reference
include/libcloudph++/blk_1m/formulae.hpp).

Elementwise tensor expressions: the reference's per-cell early returns
(``if (x == 0) return 0``) are masks and selects with guarded
denominators, so a whole grid evaluates at once.  Each function keeps the
dtype of its tensor arguments.
"""

import math

import torch

from ..common import constants as c
from ..common import vterm as common_vterm

# Kessler collection constant, eq. 5b in Grabowski & Smolarkiewicz 1996
# (reference formulae.hpp:83)
k_2 = 2.2  # [1/s]

# Kessler/Beard rain terminal-velocity constants (formulae.hpp:124-127)
vterm_A = 36.34   # [m/s]
vterm_B = 1e-3    # [m3/kg]

# Marshall-Palmer intercept for rain (formulae.hpp:153) and ice B
# (formulae.hpp:228), graupel density (formulae.hpp:218)
N_0r = 1e7   # [1/m4]
N_0b = 4e6   # [1/m4]
rho_ib = 400.0  # [kg/m3]

_EPS = 2.220446049250313e-16   # float64 machine epsilon

# 1 - exp(-1): the nucleation relaxation over taunuc = dt
_RELAX = 1 - math.exp(-1.0)


def autoconversion_rate(rc, rc_thresh, k_autoconv):
    """Kessler autoconversion, eq. 5a in Grabowski & Smolarkiewicz 1996
    (reference formulae.hpp:72-79)."""
    return k_autoconv * torch.clamp(rc - rc_thresh, min=0.0)


def collection_rate(rc, rr):
    """Kessler collection, eq. 5b in G&S 1996 (formulae.hpp:85-91)."""
    return k_2 * rc * torch.clamp(rr, min=0.0) ** 0.875


def evaporation_rate(rv, rvs, rr, rhod, p):
    """Kessler rain evaporation, eq. 5c in G&S 1996 (formulae.hpp:95-120)."""
    rho_rr = torch.clamp(1e-3 * rhod * rr, min=0.0)
    return (
        (1 - rv / rvs) / rhod
        * (1.6 + 124.9 * rho_rr ** 0.2046)   # ventilation factor
        * rho_rr ** 0.525
        / (5.4e2 + 2.55e5 / p / rvs)
    )


def v_term(rr, rhod, rhod_0):
    """Kessler/Beard rain terminal velocity, eq. 5d in G&S 1996
    (formulae.hpp:129-143)."""
    return (
        vterm_A
        * torch.clamp(rhod * rr * vterm_B, min=0.0) ** 0.1346
        * torch.sqrt(rhod_0 / rhod)
    )


def lambda_rain(rr, rhod_0):
    """Marshall-Palmer slope for rain, eq. A.1 in Grabowski 1999
    (formulae.hpp:147-155).  Safe at rr == 0 (a huge finite slope)."""
    denom = torch.clamp(rhod_0 * rr, min=1e-300)
    return (c.pi * c.rho_w * N_0r / denom) ** 0.25


def _iwc_partition(ri, rhod_0):
    """Split ice-A water content into small/large populations
    (reference formulae.hpp:166-171, 201-205)."""
    IWC = torch.clamp(rhod_0 * ri, min=1e-9)
    IWCS = torch.clamp(torch.minimum(torch.clamp(IWC, max=1e-3),
                                     2.52e-4 * (IWC / 1e-3) ** 0.837),
                       min=1e-9)
    IWCL = torch.clamp(IWC - IWCS, min=1e-9)
    return IWCS, IWCL


def mass_a(ria, T, rhod_0):
    """Mean mass of an ice A particle, eq. A.7-A.15a in Grabowski 1999
    (formulae.hpp:158-191)."""
    tempc = T - 273.16
    IWCS, IWCL = _iwc_partition(ria, rhod_0)
    # small ice A
    alpha = torch.clamp(4.99e3 - 4.94e4 * torch.log10(IWCS / 1e-3), min=1e3)
    m_as = 6.28 * c.rho_i / alpha**3
    # large ice A: lognormal-fit mass from temperature-dependent mu/sigma
    ami = 5.20 + 1.3e-3 * tempc
    bmi = 0.026 - 1.2e-3 * tempc
    asi = 0.47 + 2.1e-3 * tempc
    bsi = 0.018 - 2.1e-4 * tempc
    alorat = torch.log10(IWCL / 1e-3)
    miu = torch.clamp(ami + bmi * alorat, 4.6, 5.4)
    sig = torch.clamp(asi + bsi * alorat, 0.0, 0.5)
    m_al = 5.24e-19 * c.rho_i * torch.exp(3.0 * miu + 4.5 * sig**2)
    delta = IWCS / (IWCS + IWCL)
    amass = delta * m_as + (1 - delta) * m_al
    return torch.clamp(amass, min=1e-18)


def velocity_iceA(ria, rhod_0):
    """Mean terminal velocity of ice A, eq. A.15b in Grabowski 1999
    (formulae.hpp:195-214)."""
    IWCS, IWCL = _iwc_partition(ria, rhod_0)
    v_as = 0.1
    v_al = 0.9 + 0.1 * torch.log10(1e3 * IWCL)
    delta = IWCS / (IWCS + IWCL)
    return (delta * v_as + (1 - delta) * v_al) / torch.sqrt(rhod_0)


def lambda_ice_b(rib, rhod_0):
    """Marshall-Palmer slope for ice B, eq. A.4 in Grabowski 1999
    (formulae.hpp:222-233)."""
    return (c.pi * rho_ib * N_0b / (rhod_0 * rib + _EPS)) ** 0.25


def mass_b(rib, rhod_0):
    """Mean mass of an ice B particle, eq. A.5 in Grabowski 1999
    (formulae.hpp:237-247)."""
    bmass = c.pi * rho_ib / (6.0 * lambda_ice_b(rib, rhod_0) ** 3)
    return torch.clamp(bmass, min=1e-18)


def velocity_iceB(rib, rhod_0):
    """Mean terminal velocity of ice B, eq. A.6 in Grabowski 1999
    (formulae.hpp:251-261)."""
    return 31.2 * lambda_ice_b(rib, rhod_0) ** (-0.37) / torch.sqrt(rhod_0)


# Koenig 1972 table 2 deposition/riming coefficients, tabulated per degC
# from 0 to -31 C (reference formulae.hpp:265-311)
_ALPHA_TABLE = (
    0.0, 0.7939e-7, 0.7841e-6, 0.3369e-5, 0.4336e-5, 0.5285e-5,
    0.3728e-5, 0.1852e-5, 0.2991e-6, 0.4248e-6, 0.7434e-6, 0.1812e-5,
    0.4394e-5, 0.9145e-5, 0.1725e-4, 0.3348e-4, 0.1725e-4, 0.9175e-5,
    0.4412e-5, 0.2252e-5, 0.9115e-6, 0.4876e-6, 0.3473e-6, 0.4758e-6,
    0.6306e-6, 0.8573e-6, 0.7868e-6, 0.7192e-6, 0.6515e-6, 0.5956e-6,
    0.533e-6, 0.4834e-6,
)
_BETA_TABLE = (
    0.0, 0.4006, 0.4831, 0.5320, 0.5307, 0.5319, 0.5249, 0.4888,
    0.3894, 0.4047, 0.4318, 0.4771, 0.5183, 0.5463, 0.5651, 0.5813,
    0.5655, 0.5478, 0.5203, 0.4906, 0.4447, 0.4126, 0.3960, 0.4149,
    0.4320, 0.4506, 0.4483, 0.4460, 0.4433, 0.4413, 0.4382, 0.4361,
)


def _koenig_interp(table, T):
    """Linear interpolation into a Koenig-1972 per-degree table, a gather
    over the whole grid (reference formulae.hpp:279-286)."""
    tab = torch.tensor(table, dtype=T.dtype, device=T.device)
    ttcoe = torch.clamp(T - 273.16, -31.0, 0.0)
    idx = torch.trunc(-ttcoe).to(torch.int64)
    frac = -ttcoe - idx.to(T.dtype)
    lo = tab[idx]
    hi = tab[torch.clamp(idx + 1, max=len(table) - 1)]
    return (1.0 - frac) * lo + frac * hi


def coeff_alpha(T):
    return _koenig_interp(_ALPHA_TABLE, T)


def coeff_beta(T):
    return _koenig_interp(_BETA_TABLE, T)


def hom_A_nucleation_1(rv, rvs, rvsi, T, dt):
    """Homogeneous ice A nucleation from vapour, eq. A.21a in Grabowski 1999
    (formulae.hpp:315-333).  Active only below -40 C."""
    beta = torch.where(T > 213.16, 0.1 + 0.9 * (T - 213.16) / 20.0, 0.1)
    rv_adj = beta * rvs + (1 - beta) * rvsi
    rate = _RELAX * torch.clamp(rv - rv_adj, min=0.0)  # taunuc = dt
    return torch.where(T < 233.16, rate, 0.0)


def hom_A_nucleation_2(rc, T, dt):
    """Homogeneous ice A nucleation from cloud water, eq. A.21b
    (formulae.hpp:337-348)."""
    return torch.where(T < 233.16, _RELAX * rc, 0.0)


def het_A_nucleation(ria, rc, T, rhod_0, dt):
    """Heterogeneous ice A nucleation, eq. A.19 (formulae.hpp:352-375)."""
    m_a = mass_a(ria, T, rhod_0)
    N_in = torch.clamp(1e-2 * torch.exp(0.6 * (273.16 - T)), max=1e5)
    rate = _RELAX * torch.minimum(
        rc, torch.clamp(N_in * m_a / rhod_0 - ria, min=0.0))
    return torch.where((rc > 0) & (T <= 273.16), rate, 0.0)


def _rain_iceA_collision_rate(rr, ria, T, rhod_0):
    """Raindrop/ice-A collision rate N_ra [1/kg/s] shared by the two
    het-B nucleation pathways (reference formulae.hpp:392-408, 428-441)."""
    lam_r = lambda_rain(rr, rhod_0)
    v_r = 251.0 / torch.sqrt(lam_r * rhod_0)
    R_r = 0.5 / lam_r
    m_a = mass_a(ria, T, rhod_0)
    v_a = velocity_iceA(ria, rhod_0)
    return N_0r / lam_r * torch.abs(v_r - v_a) * c.pi * R_r * R_r * ria / m_a


def _het_B_active(rr, ria, T):
    return (ria > 0) & (rr > 0) & (T <= 273.16)


def het_B_nucleation_1(rr, ria, T, rhod_0):
    """Heterogeneous ice B nucleation rr->rib, eq. A.23 (formulae.hpp:379-411)."""
    lam_r = lambda_rain(rr, rhod_0)
    m_r = c.pi * c.rho_w / (6.0 * lam_r**3)
    rate = _rain_iceA_collision_rate(rr, ria, T, rhod_0) * m_r
    return torch.where(_het_B_active(rr, ria, T), rate, 0.0)


def het_B_nucleation_2(rr, ria, T, rhod_0):
    """Heterogeneous ice B nucleation ria->rib, eq. A.23
    (formulae.hpp:415-444)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = _rain_iceA_collision_rate(rr, ria, T, rhod_0) * m_a
    return torch.where(_het_B_active(rr, ria, T), rate, 0.0)


def melting_A(ria, T, rhod_0, dt):
    """Melting of ice A, eq. A.26 (formulae.hpp:448-475)."""
    m_a = mass_a(ria, T, rhod_0)
    D_a = torch.sqrt(m_a / 0.025)
    v_a = velocity_iceA(ria, rhod_0)
    Re = D_a * v_a * rhod_0 / common_vterm.visc(T)
    F_a = torch.clamp(0.78 + 0.27 * torch.sqrt(Re), min=1.0)
    dma_dt = 9e-7 * D_a / 2.0 * F_a * torch.clamp(T - 273.16, min=0.0)
    rate = torch.minimum(ria / dt, dma_dt * ria / m_a)
    return torch.where((ria > 0) & (T >= 273.16), rate, 0.0)


def melting_B(rib, T, rhod_0, dt):
    """Melting of ice B, eq. A.26 (formulae.hpp:479-508)."""
    lam_b = lambda_ice_b(rib, rhod_0)
    m_b = mass_b(rib, rhod_0)
    D_b = 1.0 / lam_b
    v_b = velocity_iceB(rib, rhod_0)
    Re = D_b * v_b * rhod_0 / common_vterm.visc(T)
    F_b = torch.clamp(0.78 + 0.27 * torch.sqrt(Re), min=1.0)
    dmb_dt = 9e-7 * D_b / 2.0 * F_b * torch.clamp(T - 273.16, min=0.0)
    rate = torch.minimum(rib / dt, dmb_dt * rib / m_b)
    return torch.where((rib > 0) & (T >= 273.16), rate, 0.0)


def _dep_rate_AE(m, rv, rvs, rvsi, T):
    """Koenig-1976 single-particle depositional growth rate dm/dt [kg/s]
    (regime AE; reference formulae.hpp:530-534)."""
    alpha = coeff_alpha(T)
    beta = coeff_beta(T)
    return 1e-3 * (rv - rvsi) / (rvs - rvsi + _EPS) * alpha * (m * 1e3) ** beta


def deposition_A(ria, rv, rvs, rvsi, T, rhod_0):
    """Depositional growth of ice A, eq. A.24a (formulae.hpp:513-536)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = ria / m_a * _dep_rate_AE(m_a, rv, rvs, rvsi, T)
    return torch.where((ria > 0) & (T <= 273.16), rate, 0.0)


def deposition_B(rib, rv, rvs, rvsi, T, rhod_0):
    """Depositional growth of ice B, eq. A.24c (formulae.hpp:592-615)."""
    m_b = mass_b(rib, rhod_0)
    rate = rib / m_b * _dep_rate_AE(m_b, rv, rvs, rvsi, T)
    return torch.where((rib > 0) & (T <= 273.16), rate, 0.0)


def _riming_rate(m, ri, rc, rv, rvs, rvsi, T, rhod_0):
    """Koenig-1976 riming growth (regimes BC/CD minus AE), shared by ice A
    and ice B (reference formulae.hpp:541-588, 620-665)."""
    alpha = coeff_alpha(T)
    beta = coeff_beta(T)
    dm_dt_AE = _dep_rate_AE(m, rv, rvs, rvsi, T)
    rc_safe = torch.clamp(rc, min=1e-300)
    tan_theta = 1.0 + 0.1 * torch.log(rhod_0 * rc_safe * 1e3)
    gamma = alpha * 5e-8**beta
    dm_dt_BC = 1e-3 * gamma * (m / 5e-11) ** tan_theta
    dzeta = gamma * 2e3**tan_theta
    xi = torch.log(rc_safe * rhod_0 * 1e9 / dzeta) / math.log(1e4)
    dm_dt_CD = 1e-3 * dzeta * (m * 1e7) ** xi
    rim = torch.where(
        (m > 5e-11) & (m <= 1e-7),
        torch.clamp(dm_dt_BC - dm_dt_AE, min=0.0) * ri / m,
        0.0,
    )
    return rim + torch.where(
        m > 1e-7, torch.clamp(dm_dt_CD - dm_dt_AE, min=0.0) * ri / m, 0.0)


def riming_A(ria, rc, rv, rvs, rvsi, T, rhod_0):
    """Riming growth of ice A, eq. A.24b (formulae.hpp:541-588)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = _riming_rate(m_a, ria, rc, rv, rvs, rvsi, T, rhod_0)
    return torch.where((ria > 0) & (rc > 0) & (T <= 273.16), rate, 0.0)


def riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0):
    """Riming growth of ice B, eq. A.24d (formulae.hpp:619-665)."""
    m_b = mass_b(rib, rhod_0)
    rate = _riming_rate(m_b, rib, rc, rv, rvs, rvsi, T, rhod_0)
    return torch.where((rib > 0) & (T <= 273.16), rate, 0.0)


def riming_B_1(rib, rc, rr, rv, rvs, rvsi, T, rhod_0):
    """Riming of ice B taking from rc only (formulae.hpp:669-682)."""
    coeff_rc = rc / (rc + rr + 1e-10)
    return coeff_rc * riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0)


def riming_B_2(rib, rc, rr, rv, rvs, rvsi, T, rhod_0):
    """Riming of ice B taking from rr only (formulae.hpp:686-699)."""
    coeff_rc = rc / (rc + rr + 1e-10)
    return (1.0 - coeff_rc) * riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0)
