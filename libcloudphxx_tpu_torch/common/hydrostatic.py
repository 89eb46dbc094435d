"""Hydrostatic pressure profile (libcloudphxx_tpu/common/hydrostatic.py;
reference hydrostatic.hpp)."""

from . import constants as c
from .moist_air import R


def p(z, th_0, r_0, z_0, p_0):
    """Hydrostatic pressure at height z for a constant theta/rv profile
    (reference hydrostatic.hpp:25-39)."""
    return c.p_1000 * (
        (p_0 / c.p_1000) ** (c.R_d / c.c_pd)
        - c.R_d / c.c_pd * c.g / th_0 / R(r_0) * (z - z_0)
    ) ** (c.c_pd / c.R_d)
