"""Standard potential temperature relations
(libcloudphxx_tpu/common/theta_std.py; reference theta_std.hpp)."""

from . import constants as c
from .moist_air import p_v


def rhod(p, th_std, rv):
    """Dry-air density from pressure, standard theta and rv
    (reference theta_std.hpp:22-32)."""
    return (p - p_v(p, rv)) / (
        (p / c.p_1000) ** (c.R_d / c.c_pd) * c.R_d * th_std
    )


def exner(p):
    """Exner pressure (theta_std.hpp:34-41)."""
    return (p / c.p_1000) ** (c.R_d / c.c_pd)


def T(th_std, p):
    """Temperature from standard potential temperature and pressure."""
    return th_std * exner(p)
