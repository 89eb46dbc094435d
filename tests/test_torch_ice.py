"""Port parity: the ice phase (freezing, melting, deposition) against the
JAX package at float64 on the CPU, where the port runs the plain version
of kernel F's ice forms (ops/cond.cond_flat_plain with the ice).

The same inputs, made from a seed with numpy, go through both packages.
Tolerances:

* rdrdt_i, T_freeze_CDF_inv and p_freeze rtol 1e-12 (p_freeze's 1 -
  exp(-x) also atol 2.3e-16, one ulp of 1: PyTorch's and XLA's exp differ
  in the last bit); T_freeze from init to one float64 ulp (their log);
* ice_nucl_melt (singular) rtol 1e-12: rw2, the axes, ice_rho, th;
* time-dependent freezing: the port draws Philox uniforms (ops/philox.py
  FREEZE), JAX jax.random ones, so the port's freeze mask is held to
  (rw2 > 0) & (u01 < JAX's p_freeze) on the port's draws, exactly, and
  the frozen fraction to the mean of p_freeze within five standard
  deviations;
* ice_dep_substep rtol 1e-12;
* one condensation phase with ice (cond_percell's unsorted loop in JAX,
  the port's cell-sorted plain path) on an 8x8 grid and in a parcel, with
  and without turb_cond, and with var_rho in the parcel: th, rv, the ice
  axes and the cells' closure rtol 1e-10, rw2 rtol 1e-10 for 99% of the
  droplets and 1e-6 for all (haze droplets at their activation barrier
  amplify the cell sums' other order, tests/test_torch_perparticle.py);
* the exact per-particle substepping with ice (no deposition, as in the
  JAX package) the same;
* the public API (tests/test_lgrngn_ice.py's four tests, the 500-step
  reference setup over 30 steps): th and rv rtol 1e-10, the axes and rw2
  as above, every ice diagnostic and diag_water rtol 1e-10;
* the sources, the relaxation and the recycling carry the ice attributes
  slot for slot, exactly; convert's round trip is exact.
"""

import dataclasses
from math import exp, log, pi, sqrt

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.common import ice_nucleation as jnuc
from libcloudphxx_tpu.common import maxwell_mason as jmm
from libcloudphxx_tpu.lgrngn import ice as jice
from libcloudphxx_tpu.lgrngn import particles as jparticles
from libcloudphxx_tpu.lgrngn import recycle as jrecycle
from libcloudphxx_tpu_torch import convert
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.common import constants as c
from libcloudphxx_tpu_torch.common import const_cp, theta_dry
from libcloudphxx_tpu_torch.common import ice_nucleation as tnuc
from libcloudphxx_tpu_torch.common import maxwell_mason as tmm
from libcloudphxx_tpu_torch.lgrngn import ice as tice
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles
from libcloudphxx_tpu_torch.lgrngn import recycle as trecycle

F64 = dict(device="cpu", dtype=torch.float64)
ICE_ATTRS = ("ice_a", "ice_c", "ice_rho", "T_freeze", "rd2_insol")


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * exp(-((lnr - log(mean_r)) ** 2) / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


def make_oi(pkg, **kw):
    oi = pkg.opts_init_t()
    oi.dry_distros = {(0.61, 1e-7): lognormal}   # an insoluble core
    oi.coal_switch = False
    oi.sedi_switch = False
    oi.RH_max = 0.999
    oi.dt = 1
    oi.sd_conc = 64
    oi.n_sd_max = 64
    for k, v in kw.items():
        setattr(oi, k, v)
    return oi


def make_opts(pkg, **kw):
    opts = pkg.opts_t()
    opts.adve = opts.sedi = opts.coal = opts.chem_dsl = False
    opts.cond = True
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


def both(oi_kw):
    """(JAX particles_t, port particles_t) of one opts_init."""
    return (jl.factory(jl.backend_t.serial, make_oi(jl, **oi_kw)),
            tl.factory(tl.backend_t.serial, make_oi(tl, **oi_kw), **F64))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _rw2_close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(want, 1e-300)
    assert np.mean(rel <= rtol) >= 0.99
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------- the formulas
def test_rdrdt_i_and_nucleation_formulas():
    rng = np.random.default_rng(0)
    n = 500
    T = rng.uniform(220.0, 272.0, n)
    args = dict(D=rng.uniform(1e-5, 3e-5, n), K=rng.uniform(1e-2, 3e-2, n),
                rho_v=rng.uniform(1e-4, 5e-3, n), T=T,
                p=rng.uniform(5e4, 1e5, n), RH_i=rng.uniform(0.8, 1.4, n))
    np.testing.assert_allclose(
        tmm.rdrdt_i(**{k: torch.tensor(v) for k, v in args.items()}).numpy(),
        np.asarray(jmm.rdrdt_i(**{k: jnp.asarray(v)
                                  for k, v in args.items()})), rtol=1e-12)
    rd2 = np.where(rng.random(n) < 0.3, 0.0,
                   np.exp(rng.uniform(np.log(1e-16), np.log(1e-12), n)))
    u = rng.random(n)
    np.testing.assert_allclose(
        tnuc.T_freeze_CDF_inv(torch.tensor(rd2), torch.tensor(u)).numpy(),
        np.asarray(jnuc.T_freeze_CDF_inv(jnp.asarray(rd2), jnp.asarray(u))),
        rtol=1e-12)
    rw2 = np.exp(rng.uniform(np.log(1e-14), np.log(1e-9), n))
    for dt in (0.1, 1.0):
        np.testing.assert_allclose(
            tnuc.p_freeze(torch.tensor(rd2), torch.tensor(rw2),
                          torch.tensor(T), dt).numpy(),
            np.asarray(jnuc.p_freeze(jnp.asarray(rd2), jnp.asarray(rw2),
                                     jnp.asarray(T), dt)),
            rtol=1e-12, atol=2.3e-16)


# ------------------------------------------------ states from a seed
def _cold_fields(n_cell, seed):
    """Cold cells: T 240-255 K, rhod 0.9-1.1, rv 0.95-1.02 of saturation
    over water; th_dry."""
    rng = np.random.default_rng(seed)
    T = torch.tensor(rng.uniform(240.0, 255.0, n_cell))
    rhod = torch.tensor(rng.uniform(0.9, 1.1, n_cell))
    th = T ** (1.0 - c.R_d / c.c_pd) / theta_dry.rhod_factor(rhod)
    p = theta_dry.p(rhod, torch.tensor(1e-3), T)
    rv = torch.tensor(rng.uniform(0.95, 1.02, n_cell)) * const_cp.r_vs(T, p)
    return th.numpy(), rv.numpy(), rhod.numpy()


GRID = dict(nx=8, nz=8, dx=20.0, dz=20.0, x1=160.0, z1=160.0, sd_conc=8,
            n_sd_max=8 * 64 + 40)
PARCEL = dict(sd_conc=64, n_sd_max=64)


def _frozen(js, seed):
    """The JAX State with about half its live SDs frozen by hand into
    spheroids of their liquid's mass, aspect ratios 0.5-2."""
    rng = np.random.default_rng(seed)
    n = np.asarray(js.n)
    rw2 = np.asarray(js.rw2)
    frz = (n > 0) & (rng.random(n.size) < 0.5)
    axis = np.sqrt(rw2) * (c.rho_w / c.rho_i) ** (1.0 / 3)
    asp = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n.size))
    return dataclasses.replace(
        js, rw2=jnp.asarray(np.where(frz, 0.0, rw2)),
        ice_a=jnp.asarray(np.where(frz, axis / asp ** (1 / 3), 0.0)),
        ice_c=jnp.asarray(np.where(frz, axis * asp ** (2 / 3), 0.0)),
        ice_rho=jnp.asarray(np.where(frz, c.rho_i, 0.0)))


def ice_case(parcel=False, turb=False, var_rho=False, seed=5, **over):
    """(JAX cfg, JAX State, port cfg, port State): the cold population
    after init, half of it frozen, the host model's increment (and a new
    rhod under var_rho, and ssp and dot_ssp under turb) from a seed."""
    kw = dict(PARCEL if parcel else GRID, ice_switch=True, sstp_cond=3,
              turb_cond_switch=turb, **over)
    jp = jl.factory(jl.backend_t.serial, make_oi(jl, **kw))
    th, rv, rhod = _cold_fields(1 if parcel else 64, seed)
    if parcel:
        jp.init(th, rv, rhod)
    else:
        jp.init(th.reshape(8, 8), rv.reshape(8, 8), rhod.reshape(8, 8),
                Cx=np.zeros((9, 8)), Cz=np.zeros((8, 9)))
    cfg, js = jp.cfg, _frozen(jp.state, seed)
    rng = np.random.default_rng(seed + 1)
    n_sd = js.n.shape[0]
    upd = dict(th=js.th + jnp.asarray(rng.normal(0.2, 0.2, cfg.n_cell)),
               rv=js.rv * jnp.asarray(1 + rng.uniform(0.0, 0.04, cfg.n_cell)))
    if var_rho:
        upd["rhod"] = js.rhod * jnp.asarray(
            1 - rng.uniform(0.0, 3e-3, cfg.n_cell))
    if turb:
        upd.update(ssp=jnp.asarray(rng.normal(0.0, 2e-3, n_sd)),
                   dot_ssp=jnp.asarray(rng.normal(0.0, 1e-3, n_sd)))
    js = dataclasses.replace(js, **upd)
    return cfg, js, port_cfg(cfg), port_flat_state(js)


def _phase(cfg, js, pcfg, ps, turb, var_rho, ice_nucl=False):
    want = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, turb, ice_nucl,
                                     True, var_rho)
    got = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0, var_rho=var_rho,
                                    turb_cond=turb, ice_nucl=ice_nucl)
    return want, got


def _check_phase(want, got, cells=True):
    for k in ("th", "rv", "ice_a", "ice_c", "ice_rho") \
            + (("T", "p", "RH", "eta", "dv", "rhod") if cells else ()):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-10,
                                   atol=1e-300, err_msg=k)
    _rw2_close(got.rw2.numpy(), np.asarray(want.rw2))


CASES = {"grid": (False, False, False), "grid_turb": (False, True, False),
         "parcel": (True, False, False), "parcel_turb": (True, True, False),
         "parcel_var_rho": (True, False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_ice_condensation_phase_matches_jax(case):
    """One condensation phase with ice: the liquid growth, then the
    deposition, each substep (JAX's unsorted loop, the port's cell-sorted
    plain path of F's ice form), the cells ending on the last substep's
    closure."""
    parcel, turb, var_rho = CASES[case]
    cfg, js, pcfg, ps = ice_case(parcel, turb, var_rho)
    want, got = _phase(cfg, js, pcfg, ps, turb, var_rho)
    _check_phase(want, got)
    if turb:
        np.testing.assert_allclose(got.ssp.numpy(), np.asarray(want.ssp),
                                   rtol=1e-10, atol=1e-18)
    frozen = ps.ice_a.numpy() > 0
    assert frozen.sum() > 10
    # the ice grew at the water-saturated cells' ice supersaturation, and
    # the frozen SDs took no liquid
    assert (got.ice_a.numpy()[frozen] > ps.ice_a.numpy()[frozen]).all()
    assert (got.rw2.numpy()[frozen] == 0).all()


def test_exact_mode_with_ice_deposits_nothing():
    """The exact per-particle substepping with ice: the JAX package's
    cond_perparticle deposits no ice (only cond_percell calls
    ice_dep_substep), and the port follows it (ROADMAP.md, "Known
    behaviours of the reference")."""
    cfg, js, pcfg, ps = ice_case(exact_sstp_cond=True)
    want, got = _phase(cfg, js, pcfg, ps, False, False)
    _check_phase(want, got, cells=False)
    assert torch.equal(got.ice_a, ps.ice_a)


# ------------------------------------------------ freezing, melting
def test_singular_freezing_matches_jax():
    """ice_nucl_melt, singular: the same SDs freeze (T_freeze from init,
    to one ulp) into the same spheroids, with the same heat of freezing;
    warmed above 0 C they melt back."""
    jp, tp = both(dict(ice_switch=True, n_sd_max=80))
    rhod = np.array([1.2])
    for p_ in (jp, tp):
        p_.init(np.array([240.0]), np.array([0.002]), rhod)
    np.testing.assert_allclose(tp.get_attr("T_freeze"),
                               jp.get_attr("T_freeze"), rtol=2.3e-16)
    np.testing.assert_array_equal(tp.get_attr("rd2_insol"),
                                  jp.get_attr("rd2_insol"))
    jcfg, js = jp.cfg, jparticles._tpr_jit(jp.cfg, jp.state)
    pcfg, ps = port_cfg(jcfg), port_flat_state(js)
    # the port's T_freeze, so that both freeze the same SDs
    js = dataclasses.replace(js, T_freeze=jnp.asarray(ps.T_freeze.numpy()))
    want = jice.ice_nucl_melt(jcfg, js, 1.0, False)
    got = tice.ice_nucl_melt(pcfg, ps, 1.0, False)
    assert (got.ice_a.numpy() > 0).sum() > 0
    for k in ("rw2", "ice_a", "ice_c", "ice_rho", "th"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-12,
                                   err_msg=k)
    warm = dataclasses.replace(got, T=got.T + 80.0)
    jwarm = dataclasses.replace(want, T=want.T + 80.0)
    melted = tice.ice_nucl_melt(pcfg, warm, 1.0, False)
    jmelted = jice.ice_nucl_melt(jcfg, jwarm, 1.0, False)
    np.testing.assert_allclose(melted.rw2.numpy(), np.asarray(jmelted.rw2),
                               rtol=1e-12)
    assert not melted.ice_a.any()


def test_time_dependent_freezing_draws():
    """Time-dependent freezing: the port freezes where its Philox uniform
    lies below JAX's p_freeze, and the frozen fraction agrees with the
    mean probability."""
    jp, tp = both(dict(ice_switch=True, time_dep_ice_nucl=True,
                       sd_conc=1000, n_sd_max=2000))
    rhod = np.array([1.0])
    for p_ in (jp, tp):
        p_.init(np.array([280.0]), np.array([0.002]), rhod)
    assert not tp.state.T_freeze.any()
    jcfg = jp.cfg
    js = jparticles._tpr_jit(jcfg, jp.state)
    # a cell at 225 K over 30 s, where the heterogeneous rate gives
    # probabilities between 0 and 1
    js = dataclasses.replace(js, T=jnp.full_like(js.T, 225.0))
    ps = port_flat_state(js)
    p_fr = np.asarray(jnuc.p_freeze(js.rd2_insol,
                                    jnp.maximum(js.rw2, 1e-300),
                                    js.T[js.ijk], 30.0))
    u = tice.freeze_u01(ps).numpy()
    got = tice.ice_nucl_melt(port_cfg(jcfg), ps, 30.0, True)
    frozen = got.ice_a.numpy() > 0
    np.testing.assert_array_equal(frozen, (ps.rw2.numpy() > 0) & (u < p_fr))
    assert got.rng_step == ps.rng_step + 1
    live = ps.n.numpy() > 0
    mean, var = p_fr[live].mean(), (p_fr[live] * (1 - p_fr[live])).sum()
    assert 0.05 < mean < 0.95
    assert abs(frozen[live].sum() - p_fr[live].sum()) < 5 * np.sqrt(var)


def test_ice_dep_substep_matches_jax():
    cfg, js, pcfg, ps = ice_case()
    js = jparticles._tpr_jit(cfg, js)
    ps = port_flat_state(js)
    want = jice.ice_dep_substep(cfg, js, 0.5, 44.0)
    got = tice.ice_dep_substep(pcfg, ps, 0.5, 44.0)
    for k in ("ice_a", "ice_c", "rv", "th"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-12,
                                   err_msg=k)
    assert _rel(got.rv, ps.rv) > 1e-6


# ---------------------------------------- the public API, four tests
def _run(jp, tp, th, rv, rhod, opts_kw, steps, pass_rhod=True):
    jth, jrv, tth, trv = th.copy(), rv.copy(), th.copy(), rv.copy()
    jp.init(jth, jrv, rhod)
    tp.init(tth, trv, rhod)
    for _ in range(steps):
        for p_, L, a, b in ((jp, jl, jth, jrv), (tp, tl, tth, trv)):
            p_.step_sync(make_opts(L, **opts_kw), a, b,
                         rhod if pass_rhod else None)
            p_.step_async(make_opts(L))
    return (jth, jrv), (tth, trv)


def _ice_diags(p_):
    """Every ice diagnostic and diag_water of ``p_``, as numpy arrays."""
    out = {}
    p_.diag_ice()
    p_.diag_ice_a_mom(1)
    out["ice_a_mom1"] = p_.outbuf()
    p_.diag_ice_c_mom(2)
    out["ice_c_mom2"] = p_.outbuf()
    p_.diag_all()
    p_.diag_ice_mix_ratio()
    out["mix_ratio"] = p_.outbuf()
    p_.diag_ice_a_rng(1e-7, 1e-4)
    p_.diag_ice_c_rng_cons(1e-7, 1e-4)
    p_.diag_sd_conc()
    out["a_c_rng"] = p_.outbuf()
    p_.diag_ice_c_rng(1e-7, 1e-4)
    p_.diag_ice_a_rng_cons(1e-7, 1e-4)
    p_.diag_ice_cons()
    p_.diag_ice_a_mom(0)
    out["c_a_rng"] = p_.outbuf()
    p_.diag_all()
    p_.diag_precip_rate_ice_mass()
    out["precip_ice"] = p_.outbuf()
    p_.diag_water()
    p_.diag_wet_mom(3)
    out["water_mom3"] = p_.outbuf()
    p_.diag_all()
    p_.diag_water_cons()
    p_.diag_wet_mom(0)
    out["water_cons"] = p_.outbuf()
    return out


def test_singular_freezing_and_melting_api():
    """tests/test_lgrngn_ice.py test_singular_freezing_and_melting on
    both packages: freezing at 240 K then melting at 300 K, the port
    against JAX."""
    jp, tp = both(dict(ice_switch=True))
    rhod = np.array([1.2])
    th, rv = np.array([240.0]), np.array([0.002])
    jth, jrv, tth, trv = th.copy(), rv.copy(), th.copy(), rv.copy()
    jp.init(jth, jrv, rhod)
    tp.init(tth, trv, rhod)
    # the port's T_freeze on both sides (they part at one ulp)
    jp.state = dataclasses.replace(
        jp.state, T_freeze=jnp.asarray(tp.get_attr("T_freeze")))
    alive = tp.get_attr("n") > 0
    rw2_before = tp.get_attr("rw2").copy()
    for p_, L, a, b in ((jp, jl, jth, jrv), (tp, tl, tth, trv)):
        p_.step_sync(make_opts(L, cond=False, ice_nucl=True), a, b, rhod)
        p_.step_async(make_opts(L, cond=False))
    frozen = alive & (tp.get_attr("ice_a") > 0)
    ice_a, ice_c = tp.get_attr("ice_a"), tp.get_attr("ice_c")
    assert frozen.sum() > 0
    assert (tp.get_attr("rw2")[frozen] == 0).all()
    np.testing.assert_allclose(
        tp.get_attr("ice_a")[frozen],
        np.sqrt(rw2_before[frozen]) * (1000.0 / 910.0) ** (1.0 / 3),
        rtol=1e-6)
    np.testing.assert_allclose(tth, jth, rtol=1e-12)
    jd, td = _ice_diags(jp), _ice_diags(tp)
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-10, atol=1e-300,
                                   err_msg=k)
    assert td["mix_ratio"][0] > 0
    for a, b in ((jth, tth),):
        a[0] = b[0] = 300.0
    for p_, L, a, b in ((jp, jl, jth, jrv), (tp, tl, tth, trv)):
        p_.step_sync(make_opts(L, cond=False, ice_nucl=True), a, b, rhod)
        p_.step_async(make_opts(L, cond=False))
    assert (tp.get_attr("ice_a")[alive] == 0).all()
    # melting conserves each SD's mass, rho_i V_i = rho_w V_w (the JAX
    # test's np.allclose, with its default atol of 1e-8 against masses of
    # 1e-22, cannot see that; ROADMAP.md, "Known behaviours")
    np.testing.assert_allclose(
        tp.get_attr("rw2")[frozen] ** 1.5 * c.rho_w,
        ice_a[frozen] ** 2 * ice_c[frozen] * c.rho_i, rtol=1e-5)
    np.testing.assert_allclose(tth, jth, rtol=1e-12)


@pytest.mark.parametrize("time_dep", [False, True])
def test_ice_deposition_reference_setup_api(time_dep):
    """tests/test_lgrngn_ice.py's reference setup (243 K, 800 hPa, 100
    SDs, dt 0.1, RH_max 0.95) over 30 of its 500 steps (the full run is
    chip_smoke.py's phase 20 (c)): its gates on the port, and, singular,
    the port against JAX; time-dependent, where the draws differ, the
    gates alone."""
    from libcloudphxx_tpu_torch.common import theta_std
    p0, T0 = torch.tensor(80000.0, dtype=torch.float64), 243.0
    rv = np.array([float(const_cp.r_vs(torch.tensor(T0,
                                                    dtype=torch.float64),
                                       p0))])
    th = np.array([T0 / float(theta_std.exner(p0))])
    rhod = np.array([float(theta_std.rhod(p0, torch.tensor(th[0]),
                                          torch.tensor(rv[0])))])
    jp, tp = both(dict(ice_switch=True, time_dep_ice_nucl=time_dep, dt=0.1,
                       sd_conc=100, n_sd_max=100, RH_max=0.95))
    (jth, jrv), (tth, trv) = _run(jp, tp, th, rv, rhod,
                                  dict(ice_nucl=True), 30)
    tp.diag_all()
    tp.diag_ice_mix_ratio()
    ri = tp.outbuf()[0]
    assert np.isfinite(ri) and ri >= 0
    assert np.isfinite(trv[0]) and trv[0] >= 0
    if not time_dep:
        np.testing.assert_allclose(tth, jth, rtol=1e-10)
        np.testing.assert_allclose(trv, jrv, rtol=1e-10)
        _rw2_close(tp.get_attr("rw2"), jp.get_attr("rw2"))


def test_ice_deposition_aspect_ratio_api():
    """tests/test_lgrngn_ice.py test_ice_deposition_aspect_ratio_evolution
    on both packages: hand-frozen prolate spheroids (c = 3a) at RH_i > 1
    for 20 steps; both axes grow, the aspect ratio relaxes toward 1, rv
    falls and th rises, the port within rtol 1e-10 of JAX."""
    p0, T0 = 80000.0, 250.0
    from libcloudphxx_tpu_torch.common import theta_std
    T0t = torch.tensor(T0, dtype=torch.float64)
    p0t = torch.tensor(p0, dtype=torch.float64)
    rv0 = np.array([1.05 * float(const_cp.r_vs(T0t, p0t))])
    th0 = np.array([T0 / float(theta_std.exner(p0t))])
    rhod = np.array([float(theta_std.rhod(p0t, torch.tensor(th0[0]),
                                          torch.tensor(rv0[0])))])
    jp, tp = both(dict(ice_switch=True, sstp_cond=2))
    jth, jrv, tth, trv = th0.copy(), rv0.copy(), th0.copy(), rv0.copy()
    jp.init(jth, jrv, rhod)
    tp.init(tth, trv, rhod)
    live = tp.get_attr("n") > 0
    a0, c0 = np.where(live, 2e-6, 0.0), np.where(live, 6e-6, 0.0)
    jp.state = dataclasses.replace(
        jp.state, ice_a=jnp.asarray(a0), ice_c=jnp.asarray(c0),
        ice_rho=jnp.where(jnp.asarray(live), 916.8, 0.0),
        rw2=jnp.where(jnp.asarray(live), 0.0, jp.state.rw2))
    tp.state = convert.state_from_numpy(
        {**convert.state_to_numpy(tp.state),
         **{k: np.asarray(getattr(jp.state, k))
            for k in ("ice_a", "ice_c", "ice_rho", "rw2")}}, **F64,
        rng_seed=tp.state.rng_seed)
    for _ in range(20):
        for p_, L, a, b in ((jp, jl, jth, jrv), (tp, tl, tth, trv)):
            p_.step_sync(make_opts(L, ice_nucl=True), a, b)
            p_.step_async(make_opts(L))
    a1, c1 = tp.get_attr("ice_a")[live], tp.get_attr("ice_c")[live]
    assert (a1 > 2e-6).all() and (c1 > 6e-6).all()
    assert ((c1 / a1) < 3.0).all() and ((c1 / a1) > 1.0).all()
    assert trv[0] < rv0[0] and tth[0] > th0[0]
    np.testing.assert_allclose(tth, jth, rtol=1e-10)
    np.testing.assert_allclose(trv, jrv, rtol=1e-10)
    for k in ("ice_a", "ice_c"):
        np.testing.assert_allclose(tp.get_attr(k), jp.get_attr(k),
                                   rtol=1e-10, err_msg=k)


# ------------------------------------------- refusals, get_attr, state
def test_ice_refusals_and_get_attr():
    """The ice diagnostics and attributes refuse without ice_switch, as
    the JAX package's do; with it get_attr returns the ice attributes."""
    tp = tl.factory(tl.backend_t.serial, make_oi(tl), **F64)
    tp.init(np.array([280.0]), np.array([0.005]), np.array([1.0]))
    for name in ICE_ATTRS:
        with pytest.raises(RuntimeError, match="ice_switch off"):
            tp.get_attr(name)
    for diag in ("diag_ice", "diag_ice_cons"):
        with pytest.raises(RuntimeError, match="ice is switched off"):
            getattr(tp, diag)()
    with pytest.raises(RuntimeError, match="ice is switched off"):
        tp.diag_ice_a_rng(0.0, 1.0)
    tp.diag_water()
    tp.diag_wet_mom(0)
    assert tp.outbuf()[0] > 0
    with pytest.raises(RuntimeError, match="chemistry was switched off"):
        tp.diag_chem(0)
    jp, tp = both(dict(ice_switch=True))
    for p_ in (jp, tp):
        p_.init(np.array([250.0]), np.array([0.001]), np.array([1.0]))
    for name in ("ice_a", "ice_c", "ice_rho", "rd2_insol"):
        np.testing.assert_array_equal(tp.get_attr(name), jp.get_attr(name))
    np.testing.assert_allclose(tp.get_attr("T_freeze"),
                               jp.get_attr("T_freeze"), rtol=2.3e-16)


def test_warm_state_with_an_insoluble_core_converts():
    """A warm JAX state made with a (kappa, rd_insol) key keeps rd2_insol
    (libcloudphxx_tpu/lgrngn/init.py:347); the port's init keeps it too,
    and convert carries it (and the ice attributes) both ways."""
    jp, tp = both(dict())
    for p_ in (jp, tp):
        p_.init(np.array([290.0]), np.array([0.008]), np.array([1.0]))
    js = jp.state
    assert np.asarray(js.rd2_insol).max() == pytest.approx(1e-14)
    ps = port_flat_state(js)
    np.testing.assert_array_equal(ps.rd2_insol.numpy(),
                                  np.asarray(js.rd2_insol))
    np.testing.assert_array_equal(tp.state.rd2_insol.numpy(),
                                  np.asarray(js.rd2_insol))
    back = convert.state_to_numpy(ps)
    again = convert.state_from_numpy(back, **F64)
    for k in ICE_ATTRS + ("chem", "ambient_chem", "rw2"):
        assert torch.equal(getattr(again, k), getattr(ps, k)), k
        assert tuple(getattr(ps, k).shape) == np.asarray(
            getattr(js, k)).shape, k


def test_recycling_and_sources_carry_ice_attributes():
    """Recycling copies the donor's ice attributes into the slot, as the
    JAX package's rcyc does; a source's new SDs start with none."""
    cfg, js, pcfg, ps = ice_case()
    rng = np.random.default_rng(3)
    n = np.asarray(js.n).copy()
    n[rng.random(n.size) < 0.2] = 0.0
    js = dataclasses.replace(js, n=jnp.asarray(n),
                             T_freeze=jnp.asarray(rng.uniform(230, 260,
                                                              n.size)))
    ps = port_flat_state(js)
    want = jrecycle.rcyc(cfg, js)
    got = trecycle.rcyc(pcfg, ps)
    for k in ICE_ATTRS + ("n", "rw2"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    from libcloudphxx_tpu_torch.lgrngn import source
    assert set(ICE_ATTRS) <= set(source.migrating_attrs(pcfg))
    eng = source.StateEngine(pcfg, ps)
    dead = np.nonzero(ps.n.numpy() <= 0)[0]
    k = min(5, dead.size)
    added = eng.inject(dict(n=np.full(k, 1e6), rd3=np.full(k, 1e-21),
                            kpa=np.full(k, 0.5), x=np.zeros(k),
                            z=np.zeros(k), ijk=np.zeros(k, np.int64)))
    assert added == k
    for name in ICE_ATTRS:
        assert not getattr(eng.state, name)[dead[:k]].any(), name
