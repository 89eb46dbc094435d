"""Implicit per-droplet condensation/evaporation
(libcloudphxx_tpu/lgrngn/condensation.py: drw2_dt, _advance_rw2_core;
reference src/impl/condensation/common/particles_impl_cond_common.ipp).

These are the plain versions of the per-droplet math that the condensation
kernel runs (csrc/physics.cuh drw2_dt / advance_rw2); ops/step.py loops
them over the substeps."""

from functools import partial

import torch

from ..common import constants as c
from ..common import kappa_koehler, kelvin, maxwell_mason
from ..common import transition_regime, ventil
from ..common.fastmath import cbrt_pos
from ..ops.rootfind import solve_bracketed

# reference src/detail/config.hpp:181-205
COND_MLT = 2.0


def _root_iters(dtype):
    """Root-find iterations: 32 at float64 (beyond the reference's 2^-15
    toms748 tolerance), 12 at float32 (the converged float32 noise floor;
    the reference's own float tolerance is 2^-7)."""
    return 32 if dtype == torch.float64 else 12


def drw2_dt(rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lambda_D, lambda_K,
            RH_max):
    """d(rw^2)/dt of a wet droplet (reference cond_common.ipp:122-163):
    Maxwell-Mason growth with the transition-regime beta and Sh/Nu
    ventilation."""
    rw = torch.sqrt(rw2)
    rw3 = rw2 * rw

    Re = ventil.Re(vt, rw, rhod, eta)
    Sc = ventil.Sc(eta, rhod, c.D_0)
    Pr = ventil.Pr(eta, c.c_pd, c.K_0)

    D = c.D_0 * transition_regime.beta(lambda_D / rw) * (ventil.Sh(Sc, Re) / 2)
    K = c.K_0 * transition_regime.beta(lambda_K / rw) * (ventil.Nu(Pr, Re) / 2)

    return 2.0 * maxwell_mason.rdrdt(
        D, K, rhod * rv, T, p,
        torch.clamp(RH, max=RH_max),
        kappa_koehler.a_w(rw3, rd3, kpa),
        kelvin.klvntrm(rw, T),
    )


def _advance_rw2_core(dt, rw2_old, rd3, kpa, vt, rhod, rv, T, p, RH, eta,
                      lambda_D, lambda_K, RH_max):
    """Backward-Euler advance of rw^2 over dt (reference
    cond_common.ipp:187-338): bracket from a cond_mlt-scaled explicit
    guess, fixed-iteration root find where bracketed, explicit-Euler
    fallback otherwise, clamped to the dry radius."""
    grow = partial(
        drw2_dt, rd3=rd3, kpa=kpa, vt=vt, rhod=rhod, rv=rv, T=T, p=p, RH=RH,
        eta=eta, lambda_D=lambda_D, lambda_K=lambda_K, RH_max=RH_max,
    )
    # dead slots (rw2 <= 0) are skipped, as in the reference
    alive = rw2_old > 0
    rw2_safe = torch.where(alive, rw2_old, rd3 ** (2.0 / 3))

    drw2 = dt * grow(rw2_safe)
    rd2 = cbrt_pos(rd3) ** 2

    a = torch.maximum(rd2, rw2_safe + torch.clamp(COND_MLT * drw2, max=0.0))
    b = rw2_safe + torch.clamp(COND_MLT * drw2, min=0.0)

    def minfun(x):
        return rw2_safe + dt * grow(x) - x

    # f(rw2_old) == drw2 by construction (cond_common.ipp:281-293)
    fa = torch.where(drw2 > 0, drw2, minfun(a))
    fb = torch.where(drw2 > 0, minfun(b), drw2)

    bracketed = (fa * fb <= 0) & (a < b) & (drw2 != 0)
    rw2_root = solve_bracketed(
        minfun,
        torch.where(bracketed, a, rw2_safe),
        torch.where(bracketed, b, rw2_safe),
        iters=_root_iters(rw2_old.dtype),
    )
    # explicit Euler where the bracket holds no sign change (:309)
    rw2_new = torch.where(bracketed, rw2_root, rw2_safe + drw2)
    rw2_new = torch.maximum(rw2_new, rd2)  # no evaporation below dry size
    return torch.where(alive & (drw2 != 0), rw2_new, rw2_old)
