"""Implicit per-droplet condensation/evaporation
(libcloudphxx_tpu/lgrngn/condensation.py; reference
src/impl/condensation/common/particles_impl_cond_common.ipp, the percell
substepping, particles_impl_cond.ipp, sstp_percell_step.ipp, and the exact
per-particle substepping, src/impl/condensation/perparticle/).

drw2_dt and _advance_rw2_core are the plain versions of the per-droplet
math that kernels B, F and G run (csrc/cond_cell.cuh); ops/step.py loops
them over the dense engine's substeps, ops/cond.py over the flat engine's
(cond_percell; kernel F on the card).  The exact and adaptive
per-particle substepping (cond_perparticle, cond_perparticle_adaptive)
run a whole phase in kernel G's fixed-count or adaptive form on the card
(ops/cond.py perparticle_fixed, perparticle_adaptive, over the SDs in
cell-sorted segments); their plain versions are perparticle_fixed_core
and perparticle_adaptive_core, which call advance_rw2 once a substep.
The cell sums are float64 cumulative sums in cell order (cell_sum), the
same from run to run on either device."""

import dataclasses
from functools import partial

import torch

from ..common import constants as c
from ..common import const_cp, kappa_koehler, kelvin, maxwell_mason
from ..common import theta_dry, theta_std, transition_regime, ventil
from ..common import vterm as common_vterm
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


def exact_route(cfg: StaticConfig):
    """Whether condensation runs the per-particle substepping (fixed or
    adaptive) rather than the per-cell one: exact mode with more than one
    substep (reference particles_step.ipp:199; libcloudphxx_tpu/lgrngn/
    dense.py:310).  Both engines dispatch on it."""
    return bool(cfg.exact_sstp_cond) and (cfg.sstp_cond > 1
                                          or cfg.sstp_cond_act > 1)


def stale_mfp(state: State):
    """Mean free paths from the cell T/p as they stand before the step's
    thermodynamic refresh: the reference computes hskpng_mfp from the
    previous step's Tpr (particles_step.ipp:190-196).  The per-particle
    substepping takes that T and p instead (kernel G computes the mean
    free paths from them)."""
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
    if cfg.ice_switch:
        raise NotImplementedError(
            "cond_percell: ice is not ported (ROADMAP.md, Queue 1, \"The "
            "flat engine's remaining features\")")
    sstp = cfg.sstp_cond
    if cfg.exact_sstp_cond:
        # the snapshot is per droplet; this path runs only at sstp_cond ==
        # 1 (particles_step.ipp:199: the exact branch needs more), where
        # one increment applies the whole change: no rewind
        delta_th = delta_rv = delta_rh = torch.zeros_like(state.th)
        var_rho = False
    else:
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


def cell_sum(vals, ends):
    """The float64 sum of the cell-sorted ``vals`` over each cell's run
    (``ends`` from cell_ends): a cumulative sum differenced at the cell
    ends, in one fixed order on every device and in every run."""
    cs = torch.cumsum(vals, 0, dtype=torch.float64)
    tot = torch.where(ends >= 0, cs[torch.clamp(ends, min=0)], 0.0)
    return torch.diff(tot, prepend=tot.new_zeros(1))


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


def sstp_save(state: State, exact: bool = False) -> State:
    """Snapshot th/rv/rhod for the next substepping cycle
    (reference sstp_save.ipp:7-35).  In exact (per-particle) mode each SD
    keeps its own copy of its cell's values, p included."""
    if exact:
        g = lambda arr: arr[state.ijk]
        return dataclasses.replace(
            state, sstp_tmp_th=g(state.th), sstp_tmp_rv=g(state.rv),
            sstp_tmp_rh=g(state.rhod), sstp_tmp_p=g(state.p))
    return dataclasses.replace(state, sstp_tmp_th=state.th,
                               sstp_tmp_rv=state.rv,
                               sstp_tmp_rh=state.rhod)



def advance_rw2(dt, rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lambda_D,
                lambda_K, RH_max, *, plain=False):
    """The backward-Euler rw^2 advance of every droplet at its own ambient
    conditions (libcloudphxx_tpu/lgrngn/condensation.py:144): kernel G on
    CUDA tensors, its plain version _advance_rw2_core on CPU tensors or
    with ``plain`` (ops/cond.py advance_rw2)."""
    return cond_ops.advance_rw2(dt, rw2, rd3, kpa, vt, rhod, rv, T, p, RH,
                                eta, lambda_D, lambda_K, RH_max, plain=plain)


def apply_drv_to_th_rv(cfg: StaticConfig, th, rv, rhod, p, drv):
    """The cell closure of the nomixing per-particle paths
    (libcloudphxx_tpu/lgrngn/condensation.py:547): the vapour ``drv`` the
    cells' droplets took leaves rv, and theta follows along the drv path
    (dtheta/drv = d_th_d_rv(T(theta), theta), one RK4 stage per cell; the
    reference's update_th_rv takes one linear step).  Returns (th, rv)."""
    if cfg.th_dry:
        q = theta_dry.rhod_factor(torch.clamp(rhod, min=1e-10))
        T = lambda th: theta_dry.T_of_factor(th, q)
    else:
        ex = theta_std.exner(torch.clamp(p, min=1.0))
        T = lambda th: th * ex

    def g(th):
        # -d_th_d_rv(T(th), th).  The RK4 stages with h = -drv and k = -g
        # take h k = drv g, and IEEE arithmetic rounds -x as it rounds x:
        # these are the bits of h = -drv, k = d_th_d_rv, without the
        # negations
        t = T(th)
        return th / t * const_cp.l_v(t) / c.c_pd

    half = 0.5 * drv
    g1 = g(th)
    g2 = g(th + half * g1)
    g3 = g(th + half * g2)
    g4 = g(th + drv * g3)
    return th + (drv / 6.0) * (g1 + 2 * g2 + 2 * g3 + g4), rv - drv


def rw3_of(rw2):
    """rw^3 of each droplet's rw^2, 0 where rw2 <= 0."""
    return rw2 * torch.sqrt(torch.clamp(rw2, min=0.0))


def third_moment(wgt, rw2, live, summer):
    """The float64 sums by ``summer`` of wgt rw^3 over the ``live`` SDs:
    the third moment whose change a nomixing cell closure turns into
    vapour (particles_impl_cond.ipp:105-135)."""
    return summer(torch.where(live, wgt * rw3_of(rw2), 0.0))


def _close_cells(cfg: StaticConfig, before: State, after: State, summer):
    """apply_drv_to_th_rv on the flat State (libcloudphxx_tpu/lgrngn/
    condensation.py:531-566): the vapour the cells' droplets took between
    ``before`` and ``after`` (the change of the cells' specific third
    moment times 4/3 pi rho_w, summed by ``summer`` in float64).  Returns
    ``after`` with the new th and rv."""
    def mom3(st):
        return third_moment(st.n, st.rw2, st.n > 0, summer) / st.dv / st.rhod

    drv = ((mom3(after) - mom3(before)) * (4.0 / 3) * c.pi * c.rho_w).to(
        after.th.dtype)
    th, rv = apply_drv_to_th_rv(cfg, after.th, after.rv, after.rhod,
                                after.p, drv)
    return dataclasses.replace(after, th=th, rv=rv)


def _perparticle_thermo(cfg: StaticConfig, tmp_th, tmp_rv, tmp_rh, tmp_p):
    """Each SD's closure from its private ambient state (reference
    perparticle_nomixing_adaptive_sstp_cond.ipp:93-120): T, p, RH and
    eta.  The mean free paths are the stale cell values (stale_mfp)."""
    if cfg.th_dry:
        Tp = theta_dry.T(tmp_th, torch.clamp(tmp_rh, min=1e-10))
    else:
        Tp = tmp_th * theta_std.exner(torch.clamp(tmp_p, min=1.0))
    pp = tmp_p if cfg.const_p else theta_dry.p(tmp_rh, tmp_rv, Tp)
    RHp = hskpng.RH_of(cfg, torch.clamp(pp, min=1.0), tmp_rv, Tp)
    return Tp, pp, RHp, common_vterm.visc(Tp)


def _segments(cfg: StaticConfig, state: State):
    """The flat SDs' cell-sorted segments, as kernel G's two forms take
    them (ops/cond.py): (sijk, order, ends), the stable sort of the SDs'
    cells, and the function that sums SD arrays in slot order over each
    cell (cell_sum over the segments, float64)."""
    sijk, order = torch.sort(state.ijk, stable=True)
    ends = cell_ends(sijk, cfg.n_cell)
    return (sijk, order, ends), lambda vals: cell_sum(vals[order], ends)


def _private(state: State):
    """The flat SDs as kernel G's two forms take them (ops/cond.py
    SD_NAMES)."""
    return (state.n, state.rw2, state.rd3, state.kpa, state.vt,
            state.sstp_tmp_th, state.sstp_tmp_rv, state.sstp_tmp_rh,
            state.sstp_tmp_p)


def cond_perparticle(cfg: StaticConfig, state: State, dt, RH_max, stale, *,
                     plain=False) -> State:
    """Exact per-particle condensation substepping
    (libcloudphxx_tpu/lgrngn/condensation.py:412-528; reference
    particles_step.ipp:219-232 and src/impl/condensation/perparticle/):
    kernel G's fixed-count form over the SDs in cell-sorted segments
    (ops/cond.py perparticle_fixed; its plain version
    perparticle_fixed_core, with sstp_cond_mix the cell sums in float64
    cumulative sums in cell order).  With mixing the cell then takes its
    SDs' common private state, the largest value among its live SDs:
    values that agree to rounding (the JAX package's scatter keeps one
    writer it does not specify), the same in every run; without it the
    cell closes on the change of its liquid water.  ``stale`` is the (T,
    p) of the cells before the step's closure, whose mean free paths the
    growth takes (stale_mfp)."""
    seg, summer = _segments(cfg, state)
    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p = cond_ops.perparticle_fixed(
        cfg, dt, RH_max, _private(state),
        (state.th, state.rv, state.rhod, state.p, state.dv, *stale), seg,
        plain=plain)
    new = dataclasses.replace(state, rw2=rw2, sstp_tmp_rv=tmp_rv,
                              sstp_tmp_th=tmp_th, sstp_tmp_rh=tmp_rh,
                              sstp_tmp_p=tmp_p)
    if cfg.sstp_cond_mix:
        # the cell takes its SDs' (common) private state
        # (update_state, particles_impl_update_th_rv.ipp:283-297)
        live = state.n > 0
        tgt = state.ijk[live]
        pick = lambda cells, vals: cells.scatter_reduce(
            0, tgt, vals[live], "amax", include_self=False)
        return dataclasses.replace(new, rv=pick(state.rv, tmp_rv),
                                   th=pick(state.th, tmp_th))
    return _close_cells(cfg, state, new, summer)


def perparticle_fixed_core(cfg: StaticConfig, dt, RH_max, *, n, rw2, rd3,
                           kpa, vt, dv_sd, lam_D_sd, lam_K_sd, dlt_rv,
                           dlt_th, dlt_rh, dlt_p, tmp_rv0, tmp_th0, tmp_rh0,
                           tmp_p0, spread, plain=False):
    """The per-SD body of the fixed-count exact substepping
    (libcloudphxx_tpu/lgrngn/condensation.py:446-510, dense.py:348-392):
    the plain version of kernel G's fixed-count form (ops/cond.py
    perparticle_fixed_plain), elementwise over SD arrays of one shape (the
    flat engine's SDs in cell order, the dense engine's (n_cell, cap)
    planes): each of sstp_cond substeps
    adds a share of the deltas to each SD's private th/rv/rhod/p
    (calculate_noncond_perparticle_sstp_delta.ipp), grows the SD there
    (advance_rw2 over the ravelled arrays, G's one-substep entry) and
    feeds the vapour of its own third-moment change and the heat that
    goes with it back (apply_perparticle_drw3_to_perparticle_rv_and_th.
    ipp): with sstp_cond_mix to every SD of its cell, ``spread`` giving
    each SD its cell's sum of a per-SD array (update_pstate), without it
    to itself.  Dead SDs feed nothing back.  Returns (rw2, tmp_rv, tmp_th,
    tmp_rh, tmp_p)."""
    sstp = cfg.sstp_cond
    dt_sub = dt / sstp
    live = n > 0
    flat = lambda a: a.reshape(-1)
    mlt = -(4.0 / 3) * c.pi * c.rho_w
    tmp_rv, tmp_th, tmp_rh, tmp_p = tmp_rv0, tmp_th0, tmp_rh0, tmp_p0
    for _ in range(sstp):
        base_rv = tmp_rv + dlt_rv / sstp
        base_th = tmp_th + dlt_th / sstp
        tmp_rh = tmp_rh + dlt_rh / sstp
        if cfg.const_p:
            tmp_p = tmp_p + dlt_p / sstp
        Tp, pp, RHp, eta_p = _perparticle_thermo(cfg, base_th, base_rv,
                                                 tmp_rh, tmp_p)
        rw2_new = advance_rw2(
            dt_sub, flat(rw2), flat(rd3), flat(kpa), flat(vt), flat(tmp_rh),
            flat(base_rv), flat(Tp), flat(pp), flat(RHp), flat(eta_p),
            flat(lam_D_sd), flat(lam_K_sd), RH_max,
            plain=plain).reshape(rw2.shape)
        drw3 = torch.where(live, rw3_of(rw2_new) - rw3_of(rw2), 0.0)
        drv = mlt * drw3 * n / tmp_rh / dv_sd
        dth = torch.where(live, drv * theta_dry.d_th_d_rv(Tp, base_th), 0.0)
        if cfg.sstp_cond_mix:
            tmp_rv, tmp_th = base_rv + spread(drv), base_th + spread(dth)
        else:
            tmp_rv, tmp_th = base_rv + drv, base_th + dth
        rw2 = rw2_new
    return rw2, tmp_rv, tmp_th, tmp_rh, tmp_p


def cond_perparticle_adaptive(cfg: StaticConfig, state: State, dt, RH_max,
                              stale, *, plain=False) -> State:
    """Adaptive per-SD condensation substepping, no in-cell mixing
    (libcloudphxx_tpu/lgrngn/condensation.py:589-652; reference
    perparticle_nomixing_adaptive_sstp_cond.ipp:8-335): each SD picks its
    own substep count (kernel G's adaptive form over the SDs in
    cell-sorted segments, ops/cond.py perparticle_adaptive; its plain
    version perparticle_adaptive_core), and the cell closes on the change
    of its liquid water.  ``stale`` as cond_perparticle's."""
    seg, summer = _segments(cfg, state)
    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p = cond_ops.perparticle_adaptive(
        cfg, dt, RH_max, _private(state),
        (state.th, state.rv, state.rhod, state.p, state.dv, *stale,
         state.T), seg, plain=plain)
    upd = dict(rw2=rw2, sstp_tmp_rv=tmp_rv, sstp_tmp_th=tmp_th,
               sstp_tmp_rh=tmp_rh)
    if cfg.const_p:
        upd["sstp_tmp_p"] = tmp_p
    return _close_cells(cfg, state, dataclasses.replace(state, **upd),
                       summer)


def adaptive_tries(sstp_cond):
    """The substep counts phase A tries: 1, 2, 4, ... up to sstp_cond."""
    tries = [1]
    while tries[-1] * 2 <= max(int(sstp_cond), 1):
        tries.append(tries[-1] * 2)
    return tries


def perparticle_adaptive_core(cfg: StaticConfig, dt, RH_max, *, n, rw2, rd3,
                              kpa, vt, dv_sd, lam_D_sd, lam_K_sd, dlt_rv,
                              dlt_th, dlt_rh, dlt_p, tmp_rv0, tmp_th0,
                              tmp_rh0, tmp_p0, T_sd, plain=False):
    """The per-SD body of cond_perparticle_adaptive
    (libcloudphxx_tpu/lgrngn/condensation.py:655-795), elementwise over
    the SD arrays: the plain version of kernel G's adaptive form
    (ops/cond.py perparticle_adaptive_plain).  Phase A tries 1, 2, 4, ...
    <= sstp_cond substeps and takes, for each SD, the first count whose
    d(rw^2) agrees with the half-size estimate (one advance_rw2 a try);
    SDs that cross their critical radius this step take sstp_cond_act
    instead.  Phase B runs max(sstp_cond, sstp_cond_act) masked substeps
    (one advance_rw2 each, a dt a droplet), the SDs past their own count
    idle.  Where the adaptation is abandoned the pre-adaptation ambient
    state is restored.  SGS turbulence (turb_cond) is not ported.
    Returns (rw2, tmp_rv, tmp_th, tmp_rh, tmp_p)."""
    sstp_max = max(int(cfg.sstp_cond), 1)
    sstp_act = max(int(cfg.sstp_cond_act), 1)
    eps = cfg.sstp_cond_adapt_drw2_eps
    dmax = cfg.sstp_cond_adapt_drw2_max
    live = n > 0

    def grow(tmp_rv, tmp_th, tmp_rh, tmp_p, rw2_in, dt_sub):
        Tp, pp, RHp, eta_p = _perparticle_thermo(cfg, tmp_th, tmp_rv, tmp_rh,
                                                 tmp_p)
        rw2_new = advance_rw2(dt_sub, rw2_in, rd3, kpa, vt, tmp_rh, tmp_rv,
                              Tp, pp, RHp, eta_p, lam_D_sd, lam_K_sd, RH_max,
                              plain=plain)
        return rw2_new, Tp

    # ---- phase A: pick per-SD substep counts (reference :130-201)
    tmp_rv, tmp_th, tmp_rh, tmp_p = tmp_rv0, tmp_th0, tmp_rh0, tmp_p0
    sstp = torch.full(n.shape, sstp_max, dtype=torch.int32, device=n.device)
    done = torch.zeros_like(live)
    first_done = torch.full_like(done, sstp_max == 1)
    drw2 = torch.zeros_like(tmp_rv)
    for t in adaptive_tries(sstp_max):
        mult = 1.0 if t == 1 else -1.0 / t
        upd = ~done
        tmp_rv = torch.where(upd, tmp_rv + dlt_rv * mult, tmp_rv)
        tmp_th = torch.where(upd, tmp_th + dlt_th * mult, tmp_th)
        tmp_rh = torch.where(upd, tmp_rh + dlt_rh * mult, tmp_rh)
        if cfg.const_p:
            tmp_p = torch.where(upd, tmp_p + dlt_p * mult, tmp_p)
        rw2_t, _ = grow(tmp_rv, tmp_th, tmp_rh, tmp_p, rw2, dt / t)
        drw2_t = rw2_t - rw2
        if t == 1:
            drw2 = drw2_t
            continue
        conv = (torch.abs(drw2_t * 2 - drw2) <= eps * rw2) \
            & (torch.abs(drw2) < dmax * rw2)
        newly = conv & ~done
        sstp = torch.where(newly, t // 2, sstp)
        # revert the last increment: the state after one converged substep
        tmp_rv = torch.where(newly, tmp_rv - dlt_rv * mult, tmp_rv)
        tmp_th = torch.where(newly, tmp_th - dlt_th * mult, tmp_th)
        tmp_rh = torch.where(newly, tmp_rh - dlt_rh * mult, tmp_rh)
        if cfg.const_p:
            tmp_p = torch.where(newly, tmp_p - dlt_p * mult, tmp_p)
        first_done = first_done | newly
        done = done | newly
        drw2 = torch.where(done, drw2, drw2_t)

    # activation/deactivation override (reference :184-195)
    if sstp_act > 1:
        rc2 = kappa_koehler.rw3_cr(
            torch.clamp(rd3, min=1e-300), torch.clamp(kpa, min=1e-10),
            T_sd) ** (2.0 / 3)
        proj = rw2 + sstp * drw2
        crossing = ((rw2 < rc2) & (proj > rc2)) | ((rw2 > rc2) & (proj < rc2))
        sstp = torch.where(crossing, sstp_act, sstp)
        first_done = first_done & ~crossing

    # abandonment: restore the pristine pre-adaptation ambient state
    tmp_rv = torch.where(first_done, tmp_rv, tmp_rv0)
    tmp_th = torch.where(first_done, tmp_th, tmp_th0)
    tmp_rh = torch.where(first_done, tmp_rh, tmp_rh0)
    tmp_p = torch.where(first_done, tmp_p, tmp_p0)

    # ---- phase B: masked substepping (reference :206-263)
    mlt = -(4.0 / 3) * c.pi * c.rho_w
    frac = 1.0 / sstp.to(rw2.dtype)
    dt_sd = dt * frac
    for step in range(max(sstp_max, sstp_act)):
        active = (step < sstp) & live
        reuse = first_done & (step == 0)
        app = active & ~reuse
        tmp_rv_n = torch.where(app, tmp_rv + dlt_rv * frac, tmp_rv)
        tmp_th_n = torch.where(app, tmp_th + dlt_th * frac, tmp_th)
        tmp_rh_n = torch.where(app, tmp_rh + dlt_rh * frac, tmp_rh)
        tmp_p_n = torch.where(app, tmp_p + dlt_p * frac, tmp_p) \
            if cfg.const_p else tmp_p
        rw2_solve, Tp = grow(tmp_rv_n, tmp_th_n, tmp_rh_n, tmp_p_n, rw2,
                             dt_sd)
        rw2_new = torch.where(reuse, rw2 + drw2, rw2_solve)
        rw2_new = torch.where(active, rw2_new, rw2)
        drw3 = torch.where(active, rw3_of(rw2_new) - rw3_of(rw2), 0.0)
        drv = mlt * drw3 * n / tmp_rh_n / dv_sd
        tmp_rv = tmp_rv_n + drv
        tmp_th = tmp_th_n + drv * theta_dry.d_th_d_rv(Tp, tmp_th_n)
        tmp_rh, tmp_p, rw2 = tmp_rh_n, tmp_p_n, rw2_new
    return rw2, tmp_rv, tmp_th, tmp_rh, tmp_p
