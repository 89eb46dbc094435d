"""Terminal fall velocity formulas (libcloudphxx_tpu/common/vterm.py;
reference vterm.hpp), branchless over the population."""

import torch

from . import constants as c
from . import kelvin


def visc(T):
    """Dynamic viscosity of air [Pa s] (reference vterm.hpp:20-31)."""
    T_over_T_tri = T / c.T_tri
    return 1.72e-5 * (393.0 / (T + 120.0)) * T_over_T_tri * torch.sqrt(T_over_T_tri)


def _polyval_ascending(coeffs, x):
    """sum_i coeffs[i] * x**i (Horner, coefficients in ascending order)."""
    acc = torch.zeros_like(x) + coeffs[-1]
    for coef in coeffs[-2::-1]:
        acc = acc * x + coef
    return acc


# Beard 1977 sea-level polynomial coefficients (reference vterm.hpp:120-122)
BEARD77_SMALL = (0.105035e2, 0.108750e1, -0.133245, -0.659969e-2)
BEARD77_LARGE = (
    0.65639e1, -0.10391e1, -0.14001e1, -0.82736e0,
    -0.34277e0, -0.83072e-1, -0.10583e-1, -0.54208e-3,
)


def vt_beard77_v0(r):
    """Beard 1977 sea-level terminal velocity [m/s] (vterm.hpp:108-135)."""
    x = torch.log(2 * 100 * r)
    y_s = _polyval_ascending(BEARD77_SMALL, x)
    y_l = _polyval_ascending(BEARD77_LARGE, x)
    y = torch.where(r <= 20e-6, y_s, y_l)
    return torch.exp(y) / 100.0


def vt_beard77_fact(r, p, rhoa, eta):
    """Beard 1977 altitude correction factor (vterm.hpp:137-166)."""
    eta_0 = 1.818e-5
    l_0 = 6.62e-8
    l = l_0 * (eta / eta_0) * torch.sqrt(c.p_stp / p * c.rho_stp / rhoa)
    fact_small = (eta_0 / eta) * (1 + 1.255 * (l / r)) / (1 + 1.255 * (l_0 / r))
    eps_s = (eta_0 / eta) - 1
    eps_c = torch.sqrt(c.rho_stp / rhoa) - 1
    fact_large = (
        1.104 * eps_s
        + ((1.058 * eps_c - 1.104 * eps_s) * (5.52 + torch.log(2 * 100 * r)) / 5.01)
        + 1
    )
    return torch.where(r <= 20e-6, fact_small, fact_large)


# Beard 1976 polynomial coefficients (reference vterm.hpp:197,210)
_BEARD76_MID = (
    -0.318657e1, 0.992696, -0.153193e-2, -0.987059e-3,
    -0.578878e-3, 0.855176e-4, -0.327815e-5,
)
_BEARD76_BIG = (
    -0.500015e1, 0.523778e1, -0.204914e1, 0.475294, -0.542819e-1, 0.238449e-2,
)


def vt_beard76(r, T, p, rhoa, eta):
    """Beard 1976 terminal velocity [m/s] (reference vterm.hpp:168-220)."""
    l = 6.62e-8 * (eta / 1.818e-5) * (c.p_stp / p) * torch.sqrt(T / 293.15)
    C_ac = 1.0 + 1.255 * l / r
    v_small = (c.rho_w - rhoa) * c.g / (4.5 * eta) * C_ac * r * r
    log_N_Da = torch.log(torch.clamp(
        (32.0 / 3.0) * r**3 * rhoa * (c.rho_w - rhoa) * c.g / eta**2,
        min=1e-30))
    N_Re_mid = C_ac * torch.exp(_polyval_ascending(_BEARD76_MID, log_N_Da))
    v_mid = eta * N_Re_mid / rhoa / 2.0 / r
    sg = kelvin.sg_surf(T)
    Bo = (16.0 / 3.0) * r * r * (c.rho_w - rhoa) * c.g / sg
    N_p = sg**3 * rhoa**2 / eta**4 / c.g / (c.rho_w - rhoa)
    X = torch.log(torch.clamp(Bo * N_p ** (1.0 / 6.0), min=1e-30))
    N_Re_big = N_p ** (1.0 / 6.0) * torch.exp(_polyval_ascending(_BEARD76_BIG, X))
    v_big = eta * N_Re_big / rhoa / 2.0 / r
    return torch.where(
        r <= 9.5e-6, v_small, torch.where(r <= 5.035e-4, v_mid, v_big))
