"""Moist-air relations (libcloudphxx_tpu/common/moist_air.py; reference
moist_air.hpp)."""

from . import constants as c


def mix(dry, vap, r):
    """Mass-mixing-ratio mixing rule (reference moist_air.hpp:55-62)."""
    return (dry + r * vap) / (1 + r)


def R(r):
    """Gas constant of moist air [J/K/kg] (moist_air.hpp:64-70)."""
    return mix(c.R_d, c.R_v, r)


def p_v(p, r):
    """Water-vapour partial pressure [Pa] (moist_air.hpp:80-88)."""
    return p * r / (r + c.eps)
