"""Grabowski & Abade 2017 SGS turbulence formulas
(libcloudphxx_tpu/common/turbulence.py; reference
include/libcloudph++/common/GA17_turbulence.hpp and SGS_length_scale.hpp).
Each takes tensors (or numbers) and returns tensors of their dtype."""

import math

import torch

C_E = 0.845
C_tau = 1.5
cube_root_of_two_pi = (2 * math.pi) ** (1.0 / 3.0)
a_1 = 3e-4      # [1/m]   (GA17_turbulence.hpp:32)
a_2 = 2.8e-4    # [m2/s]  (GA17_turbulence.hpp:38)


def _cbrt(x):
    """The real cube root of x >= 0 (jnp.cbrt on the non-negative axis)."""
    return torch.pow(x, 1.0 / 3.0)


def tke(diss_rate, L):
    """TKE from the dissipation rate and the length scale
    (GA17_turbulence.hpp:60-69)."""
    return _cbrt(L * diss_rate / C_E) ** 2


def tau(tke_, L):
    """The velocity relaxation timescale (GA17_turbulence.hpp:71-79)."""
    return L / cube_root_of_two_pi * torch.sqrt(C_tau / tke_)


def update_turb_vel(wp, tau_, dt, tke_, r_normal):
    """Ornstein-Uhlenbeck update of an SGS velocity perturbation with the
    standard normal draws ``r_normal`` (GA17_turbulence.hpp:81-95)."""
    e = torch.exp(-dt / tau_)
    return wp * e + torch.sqrt((1.0 - e * e) * (2.0 / 3.0) * tke_) * r_normal


def tau_relax(wet_mom_1_over_vol):
    """The supersaturation relaxation timescale (GA17_turbulence.hpp:
    97-104)."""
    return 1.0 / (a_2 * wet_mom_1_over_vol)


def dot_turb_ss(ssp, wp, tau_rlx):
    """The supersaturation perturbation's tendency (GA17_turbulence.hpp:
    106-114)."""
    return a_1 * wp - ssp / tau_rlx


# the SGS mixing-length choices (SGS_length_scale.hpp)
def length_vertical(*deltas):
    """lambda = dz (the last dimension's spacing), as in SAM and UWLCM."""
    return deltas[-1]


def length_geometric_mean(*deltas):
    """lambda = (dx dy dz)^(1/n)."""
    prod = 1.0
    for d in deltas:
        prod = prod * d
    return prod ** (1.0 / len(deltas))


def length_arithmetic_mean(*deltas):
    """lambda = mean(dx, dy, dz)."""
    return sum(deltas) / len(deltas)
