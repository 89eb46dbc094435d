"""Double-moment (Morrison & Grabowski 2007) bulk formulae
(libcloudphxx_tpu/blk_2m/formulae.py; reference include/libcloudph++/
blk_2m/: common_formulae, activation_formulae, cond_evap_formulae,
autoconversion_formulae, accretion_formulae, collision_sink_formulae,
terminal_vel_formulae).

Elementwise tensor expressions: the piecewise fall-speed regimes are
nested selects, the gamma function exp(lgamma), erf and erfc
torch.special's.  Each function keeps the dtype of its tensor arguments.
"""

import math

import torch
from torch.special import erf, erfc

from ..common import const_cp, constants as c, kelvin
from ..common import vterm as common_vterm
from ..common.moist_air import c_p


# ---- numerical thresholds (reference common_formulae.hpp:22-29), for the
# dtype in use, so that float32 runs get proportionally looser guards
def _eps(x):
    return torch.finfo(x.dtype).eps


def rc_eps(x):
    return 1e-3 * _eps(x)


def rr_eps(x):
    return 1e-4 * _eps(x)


def nc_eps(x):
    return 1e7 * _eps(x)


def nr_eps(x):
    return 1e6 * _eps(x)


def _tgamma(x):
    """exp(lgamma(x)) of a tensor or a number."""
    if torch.is_tensor(x):
        return torch.exp(torch.lgamma(x))
    return math.exp(math.lgamma(x))


# assumed mass-diameter relationship m = c_md * D^d_md
# (reference common_formulae.hpp:41-42)
c_md = c.pi / 6 * c.rho_w
d_md = 3.0


def eta_MG(n_per_vol):
    """Relative dispersion eq. 2 in Morrison & Grabowski 2007
    (reference common_formulae.hpp:32-37); n in [1/m3]."""
    return 0.0005714e-6 * n_per_vol + 0.2714


def miu_c(n_per_vol):
    """Cloud gamma-distribution spectral index (common_formulae.hpp:48-56)."""
    e = eta_MG(n_per_vol)
    return 1.0 / (e * e) - 1.0


def lambda_c(nc, rc, rhod):
    """Cloud gamma-distribution slope [1/m] (common_formulae.hpp:59-74);
    nc in [1/kg], rc dimensionless mixing ratio."""
    miu = miu_c(nc * rhod)
    return (
        c_md * nc * _tgamma(miu + d_md + 1) / (rc * _tgamma(miu + 1))
    ) ** (1.0 / d_md)


def N0_c(nc, rc, rhod):
    """Cloud gamma intercept (common_formulae.hpp:77-92)."""
    miu = miu_c(nc * rhod)
    return nc * lambda_c(nc, rc, rhod) ** (miu + 1) / _tgamma(miu + 1)


def lambda_r(nr, rr):
    """Rain Marshall-Palmer slope [1/m] (common_formulae.hpp:97-109)."""
    return (c_md * nr * _tgamma(d_md + 1) / rr) ** (1.0 / d_md)


def N0_r(nr, rr):
    """Rain exponential intercept (common_formulae.hpp:112-123)."""
    return nr * lambda_r(nr, rr)


def r_drop_c(rc, nc, rhod):
    """Mean cloud-droplet radius (common_formulae.hpp:126-138)."""
    ok = (rc > 0) & (nc > 0)
    rc_s = torch.where(ok, rc, 1.0)
    nc_s = torch.where(ok, nc, 1.0)
    r = (miu_c(nc_s * rhod) + 1.0) / lambda_c(nc_s, rc_s, rhod) / 2.0
    return torch.where(ok, r, 0.0)


def r_drop_r(rr, nr):
    """Mean rain-drop radius (common_formulae.hpp:141-150)."""
    ok = (rr > 0) & (nr > 0)
    rr_s = torch.where(ok, rr, 1.0)
    nr_s = torch.where(ok, nr, 1.0)
    return torch.where(ok, 0.5 / lambda_r(nr_s, rr_s), 0.0)


# ---- activation (reference activation_formulae.hpp) -------------------------

beta_default = 0.5

# all activated droplets assumed 1 um in radius (activation_formulae.hpp:182)
ccnmass = 4.0 / 3 * c.pi * 1e-18 * c.rho_w


def s_0(T, mean_rd, chem_b, beta=beta_default):
    """Mode-critical supersaturation, eq. 11 in Morrison & Grabowski 2007
    (activation_formulae.hpp:186-194)."""
    return mean_rd ** -(1 + beta) * torch.sqrt(
        4.0 * kelvin.A(T) ** 3 / 27.0 / chem_b
    )


def supersaturation(p, T, rv):
    """s = rv/r_vs - 1, eq. 10 (activation_formulae.hpp:197-204)."""
    return rv / const_cp.r_vs(T, p) - 1.0


def sdev_rd_s(sdev_rd, beta=beta_default):
    """Solution-spectrum width, eq. 12 (activation_formulae.hpp:207-213)."""
    return sdev_rd ** (1 + beta)


def u_MG(p, T, rv, mean_rd, sdev_rd, chem_b, RH_max, beta=beta_default):
    """erfc argument, eq. 10 (activation_formulae.hpp:216-231)."""
    s = torch.clamp(supersaturation(p, T, rv), max=RH_max - 1.0)
    return (
        torch.log(s_0(T, mean_rd, chem_b, beta) / s)
        / math.sqrt(2.0)
        / math.log(sdev_rd_s(sdev_rd, beta))
    )


def n_c_p(p, T, rv, mean_rd, sdev_rd, N_stp, chem_b, RH_max, beta=beta_default):
    """Number of activatable CCN per kg, eq. 10 (activation_formulae.hpp:234-247)."""
    return (N_stp / c.rho_stp) / 2.0 * erfc(
        u_MG(p, T, rv, mean_rd, sdev_rd, chem_b, RH_max, beta)
    )


def activation_rate(n_ccn, nc, dt):
    """eq. 13 (activation_formulae.hpp:250-260)."""
    return torch.clamp((n_ccn - nc) / dt, min=0.0)


# ---- condensation / evaporation (reference cond_evap_formulae.hpp) ----------

f1 = 0.78
f2 = 0.308


def tau_relax_c(T, p, r, N_per_vol):
    """Cloud-droplet phase-relaxation time (cond_evap_formulae.hpp:297-305)."""
    return 1.0 / (4.0 * c.pi * c.D_0 * N_per_vol * r)


# Simmel et al. 2002 table-2 fall-speed regime boundaries (terminal_vel
# _formulae.hpp:533-535); diameters in metres
d1 = 134.43e-6
d2 = 1511.64e-6
d3 = 3477.84e-6


def alpha_fall(drop_r):
    """Simmel-2002 fall-speed prefactor, piecewise in diameter
    (terminal_vel_formulae.hpp:537-548)."""
    D = 2.0 * drop_r
    v = lambda x: torch.full_like(D, x)
    return torch.where(
        D == 0.0, 0.0,
        torch.where(D < d1, 4.5795e5,
                    torch.where(D < d2, 4.962e3,
                                torch.where(D < d3, 1.732e3, v(9.17e2)))),
    )


def beta_fall(drop_r):
    """Simmel-2002 fall-speed exponent (terminal_vel_formulae.hpp:550-560)."""
    D = 2.0 * drop_r
    return torch.where(
        D < d1, 2.0 / 3,
        torch.where(D < d2, 1.0 / 3,
                    torch.where(D < d3, 1.0 / 6, torch.zeros_like(D))),
    )


def a_fall(rr, nr):
    """Mass-based Simmel prefactor converted to SI-diameter form
    (cond_evap_formulae.hpp:317-326)."""
    drop_r = r_drop_r(rr, nr)
    b = beta_fall(drop_r)
    return alpha_fall(drop_r) * (c_md * 1000.0) ** b * (1e-6) ** (d_md * b)


def b_fall(rr, nr):
    """(cond_evap_formulae.hpp:328-336)"""
    return d_md * beta_fall(r_drop_r(rr, nr))


def tau_relax_r(T, rhod, rr, nr):
    """Rain phase-relaxation time w/ ventilation, eq. 4 in Morrison 2005
    (cond_evap_formulae.hpp:340-371)."""
    visc = common_vterm.visc(T)
    lbd = lambda_r(nr, rr)
    Sc = visc / rhod / c.D_0
    bf = b_fall(rr, nr)
    return 1.0 / (
        2.0 * c.pi * c.D_0 * rhod * N0_r(nr, rr) * (
            f1 / lbd**2
            + f2
            * torch.sqrt(a_fall(rr, nr) * rhod / visc)
            * Sc ** (1.0 / 3)
            * _tgamma((bf + 5.0) / 2.0)
            * lbd ** (-(bf + 5.0) / 2.0)
        )
    )


def drv_s_dT(T, r_vs):
    """d r_vs/dT from Clausius-Clapeyron (cond_evap_formulae.hpp:375-381)."""
    return const_cp.l_v(T) * r_vs / c.R_v / (T * T)


def cond_evap_rate(T, p, r_v, tau_relax):
    """Relaxation condensation/evaporation rate (cond_evap_formulae.hpp:384-393)."""
    r_vs = const_cp.r_vs(T, p)
    return (r_v - r_vs) / tau_relax / (
        1.0 + drv_s_dT(T, r_vs) * const_cp.l_v(T) / c_p(r_v)
    )


# ---- autoconversion / accretion / collision sink ----------------------------

drizzle_radius = 25e-6  # (autoconversion_formulae.hpp:420)


def autoconv_rate(rc, nc, rhod, acnv_A, acnv_b, acnv_c):
    """Khairoutdinov & Kogan 2000 eq. 29 (autoconversion_formulae.hpp:422-439)."""
    N_c = rhod * nc  # [1/m3]
    return acnv_A * rc**acnv_b * (N_c * 1e-6) ** acnv_c


def accretion_rate(rc, rr):
    """KK2000 accretion, SI form from Wood 2005 table 1
    (accretion_formulae.hpp:464-470)."""
    return 67.0 * (rc * rr) ** 1.15


def collision_sink_rate(drr, r):
    """nc sink per unit rain production (collision_sink_formulae.hpp:495-501)."""
    return drr / (4.0 / 3 * c.pi * r**3 * c.rho_w)


# ---- moment-weighted sedimentation velocities (terminal_vel_formulae.hpp) ---
# The integrals take the slope as a tensor and a regime boundary D as a
# number.

def _mint_1(lbd, D):
    x = lbd * D
    return -lbd**-6.0 * torch.exp(-x) * (
        x**5 + 5 * x**4 + 20 * x**3 + 60 * x**2 + 120 * x + 120
    )


def _mint_2(lbd, D):
    x = lbd * D
    return -lbd**-5.0 * torch.exp(-x) * (x**4 + 4 * x**3 + 12 * x**2 + 24 * x + 24)


def _mint_3(lbd, D):
    x = lbd * D
    return (1.0 / 16) / lbd**4.5 * (
        105 * math.sqrt(math.pi) * erf(torch.sqrt(x))
        - 2 * torch.sqrt(x) * torch.exp(-x) * (8 * x**3 + 28 * x**2 + 70 * x + 105)
    )


def _mint_4(lbd, D):
    x = lbd * D
    return -lbd**-4.0 * torch.exp(-x) * (x**3 + 3 * x**2 + 6 * x + 6)


def _nint_1(lbd, D):
    x = lbd * D
    return lbd**-3.0 * torch.exp(-x) * (-x * (x + 2) - 2)


def _nint_2(lbd, D):
    x = lbd * D
    return -lbd**-2.0 * torch.exp(-x) * (x + 1)


def _nint_3(lbd, D):
    x = lbd * D
    return (
        math.sqrt(math.pi) * erf(torch.sqrt(x)) / 2.0 / lbd**1.5
        - math.sqrt(D) * torch.exp(-x) / lbd
    )


def _nint_4(lbd, D):
    return -torch.exp(-lbd * D) / lbd


def _fall_coeff(drop_r):
    """alpha_fall * (c_md * 1000)^beta_fall at one radius, a number."""
    r = torch.tensor(drop_r, dtype=torch.float64)
    return float(alpha_fall(r) * (c_md * 1000.0) ** beta_fall(r))


# the four regimes' prefactors, at a radius inside each regime
# (terminal_vel_formulae.hpp:679-694)
_FALL_COEFFS = (_fall_coeff(d1 / 4), _fall_coeff((d1 + d2) / 4),
                _fall_coeff((d2 + d3) / 4), float(alpha_fall(
                    torch.tensor(d3, dtype=torch.float64))))


def _piecewise_fall_sum(lbd, int_1, int_2, int_3, int_4):
    """Shared four-regime Simmel-2002 integral sum (eq. A4 in Morrison 2005;
    terminal_vel_formulae.hpp:679-694 and :713-728)."""
    c1, c2, c3, c4 = _FALL_COEFFS
    return (
        c1 * (int_1(lbd, d1) - int_1(lbd, 0.0))
        + c2 * (int_2(lbd, d2) - int_2(lbd, d1))
        + c3 * (int_3(lbd, d3) - int_3(lbd, d2))
        + c4 * (0.0 - int_4(lbd, d3))
    )


def v_term_m(rhod, rr, nr):
    """Mass-weighted rain terminal velocity [m/s]
    (terminal_vel_formulae.hpp:667-699)."""
    ok = (rr >= rr_eps(rr)) & (nr >= nr_eps(nr))
    rr_s = torch.where(ok, rr, 1.0)
    nr_s = torch.where(ok, nr, 1.0)
    lbd = lambda_r(nr_s, rr_s)
    v = (
        c.rho_stp / rhod * lbd**4 / 6.0
        * _piecewise_fall_sum(lbd, _mint_1, _mint_2, _mint_3, _mint_4)
        * 1e-2
    )
    return torch.where(ok, v, 0.0)


def v_term_n(rhod, rr, nr):
    """Number-weighted rain terminal velocity [m/s]
    (terminal_vel_formulae.hpp:701-734)."""
    ok = (rr >= rr_eps(rr)) & (nr >= nr_eps(nr))
    rr_s = torch.where(ok, rr, 1.0)
    nr_s = torch.where(ok, nr, 1.0)
    lbd = lambda_r(nr_s, rr_s)
    v = (
        c.rho_stp / rhod * lbd
        * _piecewise_fall_sum(lbd, _nint_1, _nint_2, _nint_3, _nint_4)
        * 1e-2
    )
    return torch.where(ok, v, 0.0)
