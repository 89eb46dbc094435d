"""Ice nucleation: singular (Shima et al. 2020) and time-dependent
(Arabas et al. 2025, Koop & Murray 2016) freezing
(libcloudphxx_tpu/common/ice_nucleation.py; reference
include/libcloudph++/common/ice_nucleation.hpp)."""

import enum
import math

import torch

from . import const_cp


class INP(enum.IntEnum):
    """Ice-nucleating-particle types (reference ice_nucleation.hpp:17)."""
    mineral = 0


T_FREEZE_DEFAULT = 235.15  # homogeneous freezing default, -38 C


def T_freeze_CDF_inv(rd2_insol, rand, inp_type=INP.mineral):
    """Inverse CDF of the singular freezing temperature, Shima et al. 2020
    eq. 1 (reference ice_nucleation.hpp:20-45): the INP's temperature where
    it has an insoluble core of area above 1e-20 m2, else the homogeneous
    default."""
    A = 4.0 * math.pi * rd2_insol
    safe_A = torch.where(A > 1e-20, A, 1.0)
    T_mineral = 273.15 + (8.934 - torch.log(-torch.log1p(-rand) / safe_A)) \
        / 0.517
    use = (A > 1e-20) & (inp_type == INP.mineral)
    return torch.where(use, T_mineral, T_FREEZE_DEFAULT)


def _powers(x):
    """x**2 ... x**6 by square-and-multiply (x**6 as x**2 * x**4), the
    products XLA takes for an integer power: p_freeze's polynomial cancels
    terms of 1e4-1e5 to a few, so the last bit of each power shows."""
    x2 = x * x
    x4 = x2 * x2
    return x2, x * x2, x4, x * x4, x2 * x4


def p_freeze(rd2_insol, rw2, T, dt, inp_type=INP.mineral):
    """The probability of freezing within dt: heterogeneous (Arabas et al.
    2025) where an insoluble core is present, homogeneous (Koop & Murray
    2016) otherwise (reference ice_nucleation.hpp:67-117)."""
    A = 4.0 * math.pi * rd2_insol
    d_aw = 1.0 - const_cp.p_vsi(T) / const_cp.p_vs(T)
    J_het = 10.0 ** (-1.35 + 22.62 * d_aw) * 1e4
    p_het = 1.0 - torch.exp(-J_het * A * dt)
    if inp_type != INP.mineral:
        p_het = torch.zeros_like(p_het)

    V = (4.0 / 3.0) * math.pi * rw2 ** 1.5
    dT = T - 273.15
    dT2, dT3, dT4, dT5, dT6 = _powers(dT)
    x = (-3020.684 - 425.921 * dT - 25.9779 * dT2 - 0.868451 * dT3
         - 0.0166203 * dT4 - 0.000171736 * dT5 - 0.000000746953 * dT6)
    J_hom = 10.0 ** x * 1e6
    p_hom = 1.0 - torch.exp(-J_hom * V * dt)
    return torch.where(rd2_insol > 0, p_het, p_hom)
