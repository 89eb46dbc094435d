"""Implicit per-droplet condensation/evaporation
(libcloudphxx_tpu/lgrngn/condensation.py; reference
src/impl/condensation/common/particles_impl_cond_common.ipp and the
percell substepping, particles_impl_cond.ipp, sstp_percell_step.ipp).

drw2_dt and _advance_rw2_core are the plain versions of the per-droplet
math that kernels B and F run (csrc/cond_cell.cuh); ops/step.py loops them
over the dense engine's substeps, ops/cond.py over the flat engine's
(cond_percell; kernel F on the card)."""

import dataclasses
from functools import partial

import torch

from ..common import constants as c
from ..common import kappa_koehler, kelvin, maxwell_mason
from ..common import transition_regime, ventil
from ..common.fastmath import cbrt_pos
from ..ops import cond as cond_ops
from ..ops.rootfind import solve_bracketed
from . import hskpng
from .state import State, StaticConfig

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


def stale_mfp(state: State):
    """Mean free paths from the cell T/p as they stand before the step's
    thermodynamic refresh: the reference computes hskpng_mfp from the
    previous step's Tpr (particles_step.ipp:190-196)."""
    return hskpng.hskpng_mfp(state.T, state.p)


def cond_percell(cfg: StaticConfig, state: State, dt, RH_max, lam,
                 var_rho: bool = False, *, plain=False) -> State:
    """The per-cell substepped condensation of step_cond, warm
    (reference particles_step.ipp:237-256).  th/rv (and rhod, when the host
    passes it each step: ``var_rho``) rewind to their values at the last
    sstp_save and take the host model's increment back in sstp_cond equal
    parts, each followed by the implicit droplet growth and the latent heat
    of the cell.  ``lam`` is stale_mfp's (lambda_D, lambda_K) of the
    state before the step's closure."""
    if cfg.ice_switch or cfg.exact_sstp_cond:
        raise NotImplementedError(
            "cond_percell: ice and exact substepping are not ported "
            "(ROADMAP.md, Queue 1 items 10 and 11)")
    sstp = cfg.sstp_cond
    delta_th = state.th - state.sstp_tmp_th
    delta_rv = state.rv - state.sstp_tmp_rv
    upd = dict(th=state.sstp_tmp_th, rv=state.sstp_tmp_rv)
    if var_rho and sstp > 1:
        # rhod is substepped too (sstp_percell_step.ipp:17-20)
        delta_rh = state.rhod - state.sstp_tmp_rh
        upd["rhod"] = state.sstp_tmp_rh
    else:
        delta_rh = torch.zeros_like(state.th)
        var_rho = False
    state = dataclasses.replace(state, **upd)
    lambda_D, lambda_K = lam
    wgt_nom = state.n * (4.0 / 3) * c.pi * c.rho_w
    return _cond_percell_sorted(cfg, state, dt / sstp, sstp, RH_max, var_rho,
                                delta_th, delta_rv, delta_rh, lambda_D,
                                lambda_K, wgt_nom, plain)


def cell_ends(sijk, n_cell):
    """The last position of each cell's run in the cell-sorted SD order
    ``sijk`` (-1 for an empty cell before any SD): cell c holds positions
    ends[c-1] + 1 to ends[c]."""
    return torch.searchsorted(
        sijk, torch.arange(1, n_cell + 1, device=sijk.device)) - 1


def _cond_percell_sorted(cfg, state, dt_sub, sstp, RH_max, var_rho,
                         delta_th, delta_rv, delta_rh, lambda_D, lambda_K,
                         wgt_nom, plain):
    """cond_percell's substep loop in cell-sorted SD order
    (libcloudphxx_tpu/lgrngn/condensation.py:312-388): one stable sort by
    cell in, the loop (ops/cond.py cond_flat: kernel F on the card, the
    host loop with float64 cumulative-sum cell sums as its plain version),
    and the new rw2 put back in slot order."""
    sijk, order = torch.sort(state.ijk, stable=True)
    sd = tuple(a[order] for a in (state.rw2, state.rd3, state.kpa, state.vt,
                                  wgt_nom))
    rw2_s, th, rv, rhod = cond_ops.cond_flat(
        cfg, sstp, dt_sub, RH_max, var_rho, sijk, cell_ends(sijk, cfg.n_cell),
        *sd, state.th, state.rv, state.rhod, delta_th, delta_rv, delta_rh,
        state.p, state.dv, lambda_D, lambda_K, plain=plain)
    rw2 = torch.empty_like(rw2_s)
    rw2[order] = rw2_s
    state = dataclasses.replace(state, rw2=rw2, th=th, rv=rv, rhod=rhod)
    return hskpng.hskpng_Tpr_state(cfg, state)


def sstp_save(state: State) -> State:
    """Snapshot th/rv/rhod for the next substepping cycle
    (reference sstp_save.ipp:7-35)."""
    return dataclasses.replace(state, sstp_tmp_th=state.th,
                               sstp_tmp_rv=state.rv,
                               sstp_tmp_rh=state.rhod)
