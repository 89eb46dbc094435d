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


def r_vs(T, p):
    """Saturation vapour mixing ratio over liquid (const_cp.hpp:60-67)."""
    return c.eps / (p / p_vs(T) - 1)


def l_v(T):
    """Latent heat of evaporation [J/kg] (const_cp.hpp:80-86)."""
    return c.l_tri + (c.c_pv - c.c_pw) * (T - c.T_tri)
