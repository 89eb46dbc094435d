"""Kelvin (curvature) term (libcloudphxx_tpu/common/kelvin.py; reference
kelvin_term.hpp)."""

import torch

from . import constants as c


def sg_surf(T):
    """Water-air surface tension [N/m] (reference kelvin_term.hpp:23-29)."""
    return 0.07275 * (1.0 - 0.002 * (T - 291.0))


def A(T):
    """Kelvin curvature parameter [m] (kelvin_term.hpp:31-39)."""
    return 2 * sg_surf(T) / c.R_v / T / c.rho_w


def klvntrm(r, T):
    """Kelvin term exp(A/r) (kelvin_term.hpp:41-50)."""
    return torch.exp(A(T) / r)
