"""Dry-air potential temperature relations
(libcloudphxx_tpu/common/theta_dry.py; reference theta_dry.hpp)."""

from . import const_cp
from . import constants as c


def T(th, rhod):
    """Temperature from dry potential temperature and dry-air density
    (reference theta_dry.hpp:22-43)."""
    return T_of_factor(th, rhod_factor(rhod))


def rhod_factor(rhod):
    """T's dry-air density factor (rhod R_d / p_1000)^(R_d / c_pd)."""
    return (rhod * c.R_d / c.p_1000) ** (c.R_d / c.c_pd)


def T_of_factor(th, q):
    """T from th and its density factor ``q`` (rhod_factor): the same
    operations as T, for a caller that evaluates T at one density many
    times."""
    return (th * q) ** (c.c_pd / (c.c_pd - c.R_d))


def p(rhod, r, T):
    """Total pressure from dry-air density, mixing ratio, temperature
    (theta_dry.hpp:45-55)."""
    return rhod * (c.R_d + r * c.R_v) * T


def d_th_d_rv(T, th):
    """Heat of condensation: d(theta)/d(rv) (theta_dry.hpp:57-65)."""
    return -th / T * const_cp.l_v(T) / c.c_pd


def d_th_d_rv_dep(T, th):
    """Heat of deposition (theta_dry.hpp:67-75)."""
    return -th / T * const_cp.l_s(T) / c.c_pd


def d_th_d_rw_freeze(T, th):
    """Heat of freezing (theta_dry.hpp:77-85)."""
    return -th / T * const_cp.l_f(T) / c.c_pd


def std2dry(th_std, r):
    """Standard -> dry potential temperature (theta_dry.hpp:87-100)."""
    return th_std * (1 + r * c.R_v / c.R_d) ** (c.R_d / c.c_pd)


def dry2std(th_dry, r):
    """Dry -> standard potential temperature (theta_dry.hpp:102-115)."""
    return th_dry / (1 + r * c.R_v / c.R_d) ** (c.R_d / c.c_pd)
