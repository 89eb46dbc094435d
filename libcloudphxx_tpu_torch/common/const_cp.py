"""Clausius-Clapeyron saturation formulas with constant specific heats
(libcloudphxx_tpu/common/const_cp.py; reference const_cp.hpp)."""

import torch

from . import constants as c


def p_vs(T):
    """Saturation vapour pressure over liquid water [Pa]
    (reference const_cp.hpp:32-43)."""
    return c.p_tri * torch.exp(
        (c.l_tri + (c.c_pw - c.c_pv) * c.T_tri) / c.R_v * (1.0 / c.T_tri - 1.0 / T)
        - (c.c_pw - c.c_pv) / c.R_v * torch.log(T / c.T_tri)
    )


def p_vsi(T):
    """Saturation vapour pressure over ice [Pa] (const_cp.hpp:47-57)."""
    return c.p_tri * torch.exp(
        (c.ls_tri + (c.c_pi - c.c_pv) * c.T_tri) / c.R_v * (1.0 / c.T_tri - 1.0 / T)
        - (c.c_pi - c.c_pv) / c.R_v * torch.log(T / c.T_tri)
    )


def r_vs(T, p):
    """Saturation vapour mixing ratio over liquid (const_cp.hpp:60-67)."""
    return c.eps / (p / p_vs(T) - 1)


def r_vsi(T, p):
    """Saturation vapour mixing ratio over ice (const_cp.hpp:70-77)."""
    return c.eps / (p / p_vsi(T) - 1)


def l_v(T):
    """Latent heat of evaporation [J/kg] (const_cp.hpp:80-86)."""
    return c.l_tri + (c.c_pv - c.c_pw) * (T - c.T_tri)


def l_s(T):
    """Latent heat of sublimation [J/kg] (const_cp.hpp:89-95)."""
    return c.ls_tri + (c.c_pv - c.c_pi) * (T - c.T_tri)


def l_f(T):
    """Latent heat of freezing [J/kg] (const_cp.hpp:98-104)."""
    return c.lf_tri + (c.c_pw - c.c_pi) * (T - c.T_tri)
