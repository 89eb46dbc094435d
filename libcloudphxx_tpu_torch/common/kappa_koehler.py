"""kappa-Koehler hygroscopicity (libcloudphxx_tpu/common/kappa_koehler.py;
reference kappa_koehler.hpp), with the batched fixed-iteration root solve
of ops/rootfind."""

import torch

from ..ops.rootfind import solve_bracketed
from . import kelvin


def rw3_eq_nokelvin(rd3, kappa, RH):
    """Equilibrium wet radius cubed, Kelvin term discarded
    (reference kappa_koehler.hpp:29-41)."""
    return rd3 * (1 - RH * (1 - kappa)) / (1 - RH)


def a_w(rw3, rd3, kappa):
    """Water activity in solution (kappa_koehler.hpp:44-54)."""
    return (rw3 - rd3) / (rw3 - rd3 * (1.0 - kappa))


def rw3_eq(rd3, kappa, RH, T, *, iters=32):
    """Equilibrium wet radius cubed with the Kelvin term
    (kappa_koehler.hpp:123-146).  RH must be < 1."""

    def minfun(rw3):
        return RH - a_w(rw3, rd3, kappa) * kelvin.klvntrm(
            torch.pow(rw3, 1.0 / 3.0), T)

    lo = rd3
    hi = rw3_eq_nokelvin(rd3, kappa, RH)
    out = solve_bracketed(minfun, lo, hi, iters=iters)
    # kappa == 0: insoluble, equilibrium at the dry radius
    return torch.where(kappa == 0, rd3, out)


def rw3_cr(rd3, kappa, T, *, iters=48):
    """Critical (Koehler-maximum) wet radius cubed
    (kappa_koehler.hpp:148-169)."""

    def minfun(rw3):
        return (
            kelvin.A(T) * (rd3 - rw3) * ((kappa - 1) * rd3 + rw3)
            + 3 * kappa * rd3 * rw3 * torch.pow(rw3, 1.0 / 3.0)
        )

    return solve_bracketed(minfun, 1e0 * rd3, 1e8 * rd3, iters=iters)


def S_cr(rd3, kappa, T, *, iters=48):
    """Critical supersaturation S(r_cr) (kappa_koehler.hpp:171-191)."""
    rw3 = rw3_cr(rd3, kappa, T, iters=iters)
    return a_w(rw3, rd3, kappa) * kelvin.klvntrm(torch.pow(rw3, 1.0 / 3.0), T)
