"""Port parity: the parcel (0-D: one cell of 1 kg of dry air, no
transport) through the port's public API on the CPU, where the port runs
the plain versions of kernels F and G's parcel forms.

The tests mirror tests/test_lgrngn_parcel.py one for one (the reference's
lgrngn_cond.py and api_lgrngn.py gates, run on the port; its
test_adaptive_perparticle_substepping is in
tests/test_torch_parcel_rising.py, which runs on another worker), and
test_parcel_condensation also holds the port's end state against the JAX
package's: th, rv and rw2 rtol 1e-10 (the same float64 arithmetic in
other orders of summation).
"""

import functools
import time
from math import exp, log, pi, sqrt

import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.common import constants as c
from libcloudphxx_tpu_torch.common import theta_dry
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles

F64 = dict(device="cpu", dtype=torch.float64)


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * exp(-((lnr - log(mean_r)) ** 2) / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


def make_opts_init(pkg=tl, **kw):
    oi = pkg.opts_init_t()
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.coal_switch = False
    oi.sedi_switch = False
    oi.RH_max = 0.999
    oi.dt = 1
    oi.sd_conc = 100
    oi.n_sd_max = 100
    for k, v in kw.items():
        setattr(oi, k, v)
    return oi


def make_opts(pkg=tl):
    opts = pkg.opts_t()
    opts.adve = opts.sedi = opts.coal = opts.chem_dsl = False
    opts.cond = True
    return opts


def factory(oi, pkg=tl):
    if pkg is tl:
        return tl.factory(tl.backend_t.serial, oi, **F64)
    return jl.factory(jl.backend_t.serial, oi)


# expected end state (reference lgrngn_cond.py:53-57)
EXP_TH = {True: 306.9, False: 307.78}
EXP_RV = {True: 1.628e-2, False: 1.7e-2}


# each parcel runs once a process: test_substepping_improves_th_error
# reads test_parcel_condensation's var-p runs again
@functools.lru_cache(maxsize=None)
def _condense_evaporate(pkg, constp, sstp):
    """The reference's lgrngn_cond.py parcel: 40 steps at 2% vapour, then
    40 at 0.2%.  Returns (prtcls, th, rv, RH before, supersaturation %
    after the condensation leg, condensed, evap start, rv at the end)."""
    oi = make_opts_init(pkg, sstp_cond=sstp)
    opts = make_opts(pkg)
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.02])
    T0 = float(theta_dry.T(torch.tensor(th[0]), torch.tensor(rhod[0])))
    p = np.array([float(theta_dry.p(torch.tensor(rhod[0]),
                                    torch.tensor(rv[0]), torch.tensor(T0)))])
    if constp:
        th[0] = float(theta_dry.dry2std(torch.tensor(th[0]),
                                        torch.tensor(rv[0])))
        oi.const_p = True
        oi.th_dry = False
    prtcls = factory(oi, pkg)
    prtcls.init(th, rv, rhod, p if constp else None)
    prtcls.diag_RH()
    rh0 = prtcls.outbuf()[0]
    for _ in range(40):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    prtcls.diag_RH()
    ss = (prtcls.outbuf()[0] - 1) * 100
    th_c, rv_c = th[0], rv[0]
    condensed = 0.02 - rv[0]
    rv[0] = 0.002
    for _ in range(40):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    return dict(prtcls=prtcls, rh0=rh0, ss=ss, th_c=th_c, rv_c=rv_c,
                condensed=condensed, th=th[0], rv=rv[0])


@pytest.mark.parametrize("constp", [False, True])
@pytest.mark.parametrize("sstp", [1, 10])
def test_parcel_condensation(constp, sstp):
    r = _condense_evaporate(tl, constp, sstp)
    assert type(r["prtcls"]) is tparticles.particles_t
    assert r["rh0"] > 2.0  # strongly supersaturated at t=0
    # reference gates (lgrngn_cond.py:137-179)
    assert abs(r["ss"]) < 4.5e-3
    assert abs(r["th_c"] - EXP_TH[constp]) < 1e-4 * EXP_TH[constp]
    assert abs(r["rv_c"] - EXP_RV[constp]) < 1e-3 * EXP_RV[constp]
    # the evaporation leg: all the condensed water returns to vapour
    # (lgrngn_cond.py:141-160, rv_diff < 1e-9)
    assert abs(r["rv"] - 0.002 - r["condensed"]) < 1e-9
    # and the JAX package's parcel, step for step
    j = _condense_evaporate(jl, constp, sstp)
    for k in ("th_c", "rv_c", "th", "rv", "ss"):
        assert r[k] == pytest.approx(j[k], rel=1e-10, abs=1e-14), k
    np.testing.assert_allclose(r["prtcls"].get_attr("rw2"),
                               j["prtcls"].get_attr("rw2"), rtol=1e-10)


def test_substepping_improves_th_error():
    # more cond substeps -> smaller theta discretization error
    # (reference lgrngn_cond.py:167-170: th_diff shrinks ~1/sstp): the
    # condense+evaporate cycle of test_parcel_condensation's var-p parcel
    errs = {sstp: abs(_condense_evaporate(tl, False, sstp)["th"] - 300.0)
            for sstp in (1, 10)}
    assert errs[1] < 4.2e-2   # reference gate th_diff_1
    assert errs[10] < 4.2e-3  # reference gate th_diff_10


def test_api_state_machine_and_diags():
    # reference api_lgrngn.py:120-152
    oi = make_opts_init()
    opts = make_opts()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.01])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    with pytest.raises(RuntimeError):
        prtcls.init(th, rv, rhod)  # multiple init call
    prtcls.step_sync(opts, th, rv, rhod)
    with pytest.raises(RuntimeError):
        prtcls.step_sync(opts, th, rv, rhod)  # sync/async order mismatch
    prtcls.step_async(opts)
    prtcls.step_sync(opts, th, rv)
    prtcls.diag_dry_rng(0.0, 1.0)
    prtcls.diag_wet_rng(0.0, 1.0)
    prtcls.diag_kappa_rng(0.0, 2.0)
    prtcls.diag_kappa_rng_cons(0.5, 1.5)
    prtcls.diag_dry_mom(1)
    prtcls.diag_wet_mom(1)
    prtcls.diag_kappa_mom(1)
    puddle = prtcls.diag_puddle()
    # the reference's output_t key set (common/output.hpp:8-42)
    assert set(puddle) == {
        "HNO3", "NH3", "CO2", "SO2", "H2O2", "O3", "S_VI", "H",
        "liquid_volume", "dry_volume", "particle_number", "ice_mass",
        "liquid_number", "ice_number",
    }
    prtcls.diag_all()
    prtcls.diag_sd_conc()
    assert prtcls.outbuf()[0] == oi.sd_conc  # parcel set-up, exact
    # the parcel's one cell is 1 kg of dry air, and nothing moves
    assert prtcls.state.dv.numpy() == pytest.approx(1.0 / rhod)
    prtcls.diag_vel_div()
    assert prtcls.outbuf().tolist() == [0.0]


def test_sync_in_step_cond_explicit():
    # reference api_lgrngn.py:255-270
    oi = make_opts_init()
    opts = make_opts()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.01])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    with pytest.raises(RuntimeError):
        prtcls.step_cond(opts, th, rv)  # sync_in/cond order mismatch
    prtcls.sync_in(th, rv, rhod)
    prtcls.step_cond(opts, th, rv)
    prtcls.step_async(opts)
    prtcls.step_sync(opts, th, rv)


def test_dry_sizes_exact_multiplicities():
    # mirrors reference api_lgrngn.py:276-321: two kappas, four sizes,
    # exact SD counts and multiplicities
    kappa1, kappa2 = 0.61, 1.28
    oi = tl.opts_init_t()
    oi.dry_distros = {}
    oi.dry_sizes = {
        (kappa1, 0.0): {1e-6: (30.0 * c.rho_stp, 15),
                        15e-6: (10.0 * c.rho_stp, 5)},
        (kappa2, 0.0): {1.25e-6: (20.0 * c.rho_stp, 10),
                        12.5e-6: (15.0 * c.rho_stp, 5)},
    }
    oi.coal_switch = oi.sedi_switch = False
    oi.dt = 1
    oi.n_sd_max = 64
    prtcls = factory(oi)
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.01])
    prtcls.init(th, rv, rhod)

    prtcls.diag_all()
    prtcls.diag_sd_conc()
    assert prtcls.outbuf()[0] == 35  # 15+5+10+5

    prtcls.diag_all()
    prtcls.diag_wet_mom(0)
    assert prtcls.outbuf()[0] == pytest.approx(75.0)  # 30+10+20+15

    # kappa-filtered counts (wet_mom(0) of a dry-range selection)
    for rng, expect_n, expect_k in (
        ((0.9e-6, 1.1e-6), 30.0, kappa1),
        ((1.2e-6, 1.3e-6), 20.0, kappa2),
        ((12e-6, 13e-6), 15.0, kappa2),
        ((14.9e-6, 15.1e-6), 10.0, kappa1),
    ):
        prtcls.diag_dry_rng(*rng)
        prtcls.diag_wet_mom(0)
        n = prtcls.outbuf()[0]
        prtcls.diag_kappa_mom(1)
        k = prtcls.outbuf()[0]
        assert n == pytest.approx(expect_n)
        assert k == pytest.approx(n * expect_k)


def test_wet_equilibrium_init():
    # initial wet radii at RH<1 must satisfy r_wet > r_dry and be at
    # kappa-Koehler equilibrium (init_wet.ipp:18-77)
    oi = make_opts_init()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.005])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    rd3 = prtcls.get_attr("rd3")
    rw2 = prtcls.get_attr("rw2")
    n = prtcls.get_attr("n")
    alive = n > 0
    assert np.all(rw2[alive] ** 1.5 >= rd3[alive] * 0.999)
    # multiplicity total consistent with the lognormal: ~6e7/kg / rho_stp
    prtcls.diag_all()
    prtcls.diag_dry_mom(0)
    assert prtcls.outbuf()[0] == pytest.approx(60e6 / c.rho_stp, rel=0.01)
    # positions stay at 0: a parcel has no axis
    for k in "xyz":
        assert not prtcls.get_attr(k).any()


def test_extended_diags():
    # diag_rw_ge_rc / diag_RH_ge_Sc / precip rate / max_rw / incloud time
    oi = make_opts_init(diag_incloud_time=True,
                        terminal_velocity=tl.vt_t.beard77fast)
    opts = make_opts()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.02])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    for _ in range(5):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    # strongly supersaturated: most droplets activated
    prtcls.diag_rw_ge_rc()
    prtcls.diag_wet_mom(0)
    n_act = prtcls.outbuf()[0]
    prtcls.diag_all()
    prtcls.diag_wet_mom(0)
    n_all = prtcls.outbuf()[0]
    assert 0 < n_act <= n_all
    assert n_act > 0.5 * n_all  # most of the population activates here
    prtcls.diag_RH_ge_Sc()
    prtcls.diag_wet_mom(0)
    assert prtcls.outbuf()[0] > 0
    # activated droplets carry incloud time
    prtcls.diag_all()
    prtcls.diag_incloud_time_mom(1)
    assert prtcls.outbuf()[0] > 0
    t = prtcls.get_attr("incloud_time")
    # the update runs before condensation each step (reference
    # particles_step.ipp:180), so step 1 sees unactivated droplets
    assert t.max() == pytest.approx(4.0)
    prtcls.diag_all()
    prtcls.diag_precip_rate()
    assert np.isfinite(prtcls.outbuf()).all()
    prtcls.diag_max_rw()
    assert prtcls.outbuf()[0] > 1e-6  # grown droplets
    # diag_incloud_time_mom errors when not enabled
    p2 = factory(make_opts_init())
    p2.init(np.array([1.]), np.array([300.]), np.array([1.]))
    p2.diag_all()
    with pytest.raises(RuntimeError, match="diag_incloud_time"):
        p2.diag_incloud_time_mom(1)


def test_sd_conc_large_tail_adds_sds():
    """opts_init.sd_conc_large_tail extends the population with
    multiplicity-1 SDs from the distribution tail (reference
    init_SD_with_distros_tail.ipp; oracle: api_lgrngn.py:340 asserts the
    tail run has MORE SDs)."""
    def lognormal_np(lnr):
        return (60e6 * np.exp(-(lnr - np.log(0.02e-6)) ** 2
                              / 2 / np.log(1.4) ** 2)
                / np.log(1.4) / np.sqrt(2 * np.pi))

    def build(tail):
        oi = tl.opts_init_t()
        oi.dt = 1.0
        oi.dry_distros = {(0.61, 0.0): lognormal_np}
        oi.sd_conc = 64
        oi.sd_conc_large_tail = tail
        oi.n_sd_max = 512
        oi.terminal_velocity = tl.vt_t.beard76
        prt = factory(oi)
        rhod = np.ones(1)
        prt.init(300.0 * np.ones(1), 0.01 * np.ones(1), rhod)
        prt.diag_all()
        prt.diag_sd_conc()
        return prt.outbuf()[0], prt.get_attr("n")

    sd_plain, _ = build(False)
    sd_tail, n_tail = build(True)
    assert sd_plain == 64
    assert sd_tail > sd_plain
    # the tail SDs carry multiplicity 1 and large dry radii
    assert (n_tail[int(sd_plain):int(sd_tail)] == 1).all()


def test_vectorized_init_large_grid_fast():
    """const_multi / dry_sizes init is vectorized over cells (a per-cell
    Python loop takes minutes at 3-D sizes): 32^3 cells through the
    port's public API."""
    def lognormal_np(lnr):
        return (60e6 * np.exp(-(lnr - np.log(0.02e-6)) ** 2
                              / 2 / np.log(1.4) ** 2)
                / np.log(1.4) / np.sqrt(2 * np.pi))

    nx = ny = nz = 32   # 32k cells
    oi = tl.opts_init_t()
    oi.nx, oi.ny, oi.nz = nx, ny, nz
    oi.dx = oi.dy = oi.dz = 10.0
    oi.x1, oi.y1, oi.z1 = nx * 10.0, ny * 10.0, nz * 10.0
    oi.dt = 1.0
    oi.dry_distros = {(0.61, 0.0): lognormal_np}
    oi.sd_const_multi = int(2e10)
    oi.n_sd_max = 2 ** 21
    oi.terminal_velocity = tl.vt_t.beard76
    oi.dry_sizes = {(0.61, 0.0): {1e-6: (1e4, 2)}}
    prt = factory(oi)
    shape = (nx, ny, nz)
    t0 = time.time()
    prt.init(np.full(shape, 300.0), np.full(shape, 0.01),
             np.full(shape, 1.1))
    elapsed = time.time() - t0
    prt.diag_all()
    prt.diag_sd_conc()
    assert prt.outbuf().min() >= 2  # dry_sizes SDs everywhere
    assert elapsed < 60, f"init took {elapsed:.0f}s: cell loop regression?"


def _flat_substeps(cfg, kw, dtype):
    """cond_flat_plain's phase on ``kw`` (cast to ``dtype``), substep by
    substep: the (rw2, th, rv, rhod) after each."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    kw = {k: v.to(dtype) if isinstance(v, torch.Tensor)
          and v.is_floating_point() else v for k, v in kw.items()}
    s = kw["sstp"]
    k1 = dict(kw, sstp=1, **{d: kw[d] / s for d in
                             ("delta_th", "delta_rv", "delta_rh")})
    out = []
    for _ in range(s):
        o = cond_ops.cond_flat_plain(cfg, RH_max=44.0, var_rho=False, **k1)
        k1.update(rw2=o[0], th=o[1], rv=o[2], rhod=o[3])
        out.append(o)
    return out


def test_cond_flat_parcel_weights_per_kg_of_air():
    """Kernel F's parcel form reads its weights per kg of air (as
    tests/test_torch_cuda.py's card tests give them).  Read so, the
    cell-volume weights of torch_parity.flat_cond_case (dv rhod ~ 440 kg
    of air a cell) put ~0.08 kg of liquid in a kg of air: the first
    substep moves T by over 5 K, rv drops below 0 within the phase, and
    the plain version at float32 parts from itself at float64 by over
    1e-6 in th and rv; per kg, T moves by under 0.1 K, rv stays above 0
    and the two agree within 1e-6."""
    import dataclasses

    from torch_parity import flat_cond_case

    from libcloudphxx_tpu_torch.lgrngn import hskpng
    cfg, kw = flat_cond_case([64, 57, 0, 71, 64, 90, 33, 64])
    cfg = dataclasses.replace(cfg, n_dims=0)
    per_kg = dict(kw, wgt=kw["wgt"] / (kw["dv"] * kw["rhod"])[kw["sijk"]])
    T0 = hskpng.hskpng_Tpr(cfg, kw["th"], kw["rv"], kw["rhod"], kw["p"])[0]
    for k, physical in ((kw, False), (per_kg, True)):
        f64 = _flat_substeps(cfg, k, torch.float64)
        f32 = _flat_substeps(cfg, k, torch.float32)[-1]
        T1 = hskpng.hskpng_Tpr(cfg, *f64[0][1:4], k["p"])[0]
        dT = float((T1 - T0).abs().max())
        rv_pos = all(bool((o[2] > 0).all()) for o in f64)
        rel = max(float(((a.double() - b) / b).abs().max())
                  for a, b in zip(f32[1:3], f64[-1][1:3]))
        if physical:
            assert dT < 0.1 and rv_pos and rel < 1e-6
        else:
            assert dT > 5.0 and not rv_pos and rel > 1e-6

