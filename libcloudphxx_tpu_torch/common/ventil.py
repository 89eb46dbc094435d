"""Ventilation coefficients (libcloudphxx_tpu/common/ventil.py; reference
ventil.hpp)."""

import torch

from .fastmath import cbrt_pos, pow_pos


def Re(v_term, r_w, rho, eta):
    """Reynolds number of a droplet at terminal velocity (ventil.hpp:12-24)."""
    return v_term * (2.0 * r_w) * rho / eta


def Nu(Pr, Re):
    """Nusselt number (ventil.hpp:26-44), cbrt/pow in the exp/log form the
    condensation kernel uses."""
    return 1.0 + cbrt_pos(1.0 + Re * Pr) * torch.clamp(
        pow_pos(Re, 0.077), min=1.0)


def Sh(Sc, Re):
    """Sherwood number (ventil.hpp:46-56)."""
    return Nu(Sc, Re)


def Sc(eta, rho, D):
    """Schmidt number (ventil.hpp:58-68)."""
    return eta / rho / D


def Pr(eta, c_p, K):
    """Prandtl number (ventil.hpp:70-80)."""
    return c_p * eta / K
