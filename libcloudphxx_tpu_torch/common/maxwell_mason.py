"""Maxwell-Mason diffusional growth rate
(libcloudphxx_tpu/common/maxwell_mason.py; reference maxwell-mason.hpp)."""

from . import const_cp
from . import constants as c


def rdrdt(D, K, rho_v, T, p, RH, a_w, klvntrm):
    """r * dr/dt for liquid droplets [m2/s] (reference maxwell-mason.hpp:13-47)."""
    l_v = const_cp.l_v(T)
    return (
        (1.0 - a_w * klvntrm / RH)
        / c.rho_w
        / (1.0 / D / rho_v + l_v / K / RH / T * (l_v / c.R_v / T - 1.0))
    )
