"""Port parity: the common physics, root finder and housekeeping formulas of
libcloudphxx_tpu_torch against libcloudphxx_tpu, at float64.

Every function takes the same seeded inputs on both sides; the tolerance
is rtol 1e-12 (the two libraries' transcendentals may differ in the last
few ulps), and 1e-10 where a root find stands between input and result.
Plus physics anchors from the literature.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import khvorostyanov_rtol, port_cfg, t

from libcloudphxx_tpu import common as jc
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.lgrngn.enums import RH_formula_t, vt_t
from libcloudphxx_tpu.ops import pallas_coal
from libcloudphxx_tpu.ops import rootfind as jrootfind
from libcloudphxx_tpu_torch import common as tc
from libcloudphxx_tpu_torch.lgrngn import hskpng as thskpng
from libcloudphxx_tpu_torch.lgrngn import vterm as tvterm
from libcloudphxx_tpu_torch.ops import rootfind as trootfind

N = 257


def _inputs():
    rng = np.random.default_rng(20261016)
    u = lambda lo, hi: rng.uniform(lo, hi, N)
    return dict(
        T=u(250.0, 310.0), p=u(7e4, 1.02e5), rv=u(1e-3, 2e-2),
        rhod=u(0.8, 1.25), th=u(280.0, 310.0), z=u(0.0, 3000.0),
        r=np.exp(u(np.log(1e-7), np.log(3e-3))),
        rd3=np.exp(u(np.log(1e-24), np.log(1e-20))),
        kpa=u(0.1, 1.3), RH=u(0.5, 0.99), eta=u(1.6e-5, 1.9e-5),
        D=u(1e-5, 3e-5), K=u(1e-2, 3e-2), aw=u(0.9, 1.0), klv=u(1.0, 1.1),
        Re=u(0.0, 50.0), Pr=u(0.5, 1.0), Kn=u(0.0, 3.0), x=u(0.0, 5.0),
        cp=u(1000.0, 1100.0))


# (name, jax function, port function, argument names)
CASES = [
    ("const_cp.p_vs", jc.const_cp.p_vs, tc.const_cp.p_vs, "T"),
    ("const_cp.r_vs", jc.const_cp.r_vs, tc.const_cp.r_vs, "T p"),
    ("const_cp.l_v", jc.const_cp.l_v, tc.const_cp.l_v, "T"),
    ("moist_air.R", jc.moist_air.R, tc.moist_air.R, "rv"),
    ("moist_air.p_v", jc.moist_air.p_v, tc.moist_air.p_v, "p rv"),
    ("tetens.p_vs", jc.tetens.p_vs, tc.tetens.p_vs, "T"),
    ("tetens.r_vs", jc.tetens.r_vs, tc.tetens.r_vs, "T p"),
    ("theta_dry.T", jc.theta_dry.T, tc.theta_dry.T, "th rhod"),
    ("theta_dry.p", jc.theta_dry.p, tc.theta_dry.p, "rhod rv T"),
    ("theta_dry.d_th_d_rv", jc.theta_dry.d_th_d_rv, tc.theta_dry.d_th_d_rv,
     "T th"),
    ("theta_dry.std2dry", jc.theta_dry.std2dry, tc.theta_dry.std2dry,
     "th rv"),
    ("theta_std.rhod", jc.theta_std.rhod, tc.theta_std.rhod, "p th rv"),
    ("theta_std.exner", jc.theta_std.exner, tc.theta_std.exner, "p"),
    ("hydrostatic.p", lambda z: jc.hydrostatic.p(z, 289.0, 7.5e-3, 0.0,
                                                 101500.0),
     lambda z: tc.hydrostatic.p(z, 289.0, 7.5e-3, 0.0, 101500.0), "z"),
    ("kelvin.sg_surf", jc.kelvin.sg_surf, tc.kelvin.sg_surf, "T"),
    ("kelvin.A", jc.kelvin.A, tc.kelvin.A, "T"),
    ("kelvin.klvntrm", jc.kelvin.klvntrm, tc.kelvin.klvntrm, "r T"),
    ("kappa_koehler.a_w", jc.kappa_koehler.a_w, tc.kappa_koehler.a_w,
     "rd3 rd3 kpa"),
    ("kappa_koehler.rw3_eq_nokelvin", jc.kappa_koehler.rw3_eq_nokelvin,
     tc.kappa_koehler.rw3_eq_nokelvin, "rd3 kpa RH"),
    ("maxwell_mason.rdrdt", jc.maxwell_mason.rdrdt, tc.maxwell_mason.rdrdt,
     "D K rv T p RH aw klv"),
    ("ventil.Re", jc.ventil.Re, tc.ventil.Re, "x r rhod eta"),
    ("ventil.Nu", jc.ventil.Nu, tc.ventil.Nu, "Pr Re"),
    ("ventil.Sh", jc.ventil.Sh, tc.ventil.Sh, "Pr Re"),
    ("ventil.Sc", jc.ventil.Sc, tc.ventil.Sc, "eta rhod D"),
    ("ventil.Pr", jc.ventil.Pr, tc.ventil.Pr, "eta cp K"),
    ("transition_regime.beta", jc.transition_regime.beta,
     tc.transition_regime.beta, "Kn"),
    ("mean_free_path.lambda_D", jc.mean_free_path.lambda_D,
     tc.mean_free_path.lambda_D, "T"),
    ("mean_free_path.lambda_K", jc.mean_free_path.lambda_K,
     tc.mean_free_path.lambda_K, "T p"),
    ("fastmath.cbrt_pos", jnp.cbrt, tc.fastmath.cbrt_pos, "rd3"),
    ("fastmath.pow_pos", lambda a: jnp.power(a, 0.077),
     lambda a: tc.fastmath.pow_pos(a, 0.077), "Re"),
    ("vterm.visc", jc.vterm.visc, tc.vterm.visc, "T"),
    ("vterm.vt_beard77_v0", jc.vterm.vt_beard77_v0, tc.vterm.vt_beard77_v0,
     "r"),
    ("vterm.vt_beard77_fact", jc.vterm.vt_beard77_fact,
     tc.vterm.vt_beard77_fact, "r p rhod eta"),
    ("vterm.vt_beard76", jc.vterm.vt_beard76, tc.vterm.vt_beard76,
     "r T p rhod eta"),
    ("vterm.vt_khvorostyanov_spherical",
     lambda *a: jc.vterm.vt_khvorostyanov(*a, spherical=True),
     lambda *a: tc.vterm.vt_khvorostyanov(*a, spherical=True),
     "r T rhod eta"),
    ("vterm.vt_khvorostyanov_nonspherical",
     lambda *a: jc.vterm.vt_khvorostyanov(*a, spherical=False),
     lambda *a: tc.vterm.vt_khvorostyanov(*a, spherical=False),
     "r T rhod eta"),
]


def _close(got, want, rtol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    bad = np.abs(got - want)[ok] > (rtol * np.abs(want))[ok]
    assert not bad.any(), (np.abs(got - want) / np.abs(want))[ok][bad]


@pytest.mark.parametrize("name,jf,tf,args", CASES, ids=[c[0] for c in CASES])
def test_common_matches_jax(name, jf, tf, args):
    inp = _inputs()
    vals = [inp[a] for a in args.split()]
    want = np.asarray(jf(*(jnp.asarray(v) for v in vals)))
    got = tf(*(t(v) for v in vals)).numpy()
    assert got.dtype == np.float64
    # cbrt/pow: the exp/log forms of the port against JAX's own cbrt/power
    # differ by the ~|log x| ulps of the composition
    rtol = 1e-13 * 64 if name.startswith("fastmath") else 1e-12
    if name.startswith("vterm.vt_khvorostyanov"):
        rtol = khvorostyanov_rtol(inp["r"], inp["rhod"], inp["eta"], 1e-12)
    _close(got, want, np.broadcast_to(rtol, want.shape))


def test_rootfind_matches_jax():
    """Fixed-iteration Anderson-Bjoerck on cubic roots in seeded brackets."""
    rng = np.random.default_rng(7)
    c3 = rng.uniform(1.0, 10.0, N)
    f_j = lambda x: x**3 - jnp.asarray(c3)
    f_t = lambda x: x**3 - t(c3)
    lo, hi = np.zeros(N), np.full(N, 3.0)
    want = np.asarray(jrootfind.solve_bracketed(f_j, jnp.asarray(lo),
                                                jnp.asarray(hi), iters=32))
    got = trootfind.solve_bracketed(f_t, t(lo), t(hi), iters=32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a few brackets stagnate short of the root in 32 steps, alike on both
    np.testing.assert_allclose(got, np.cbrt(c3), rtol=1e-3)


@pytest.mark.parametrize("which", ["rw3_eq", "rw3_cr", "S_cr"])
def test_kappa_koehler_root_solves_match_jax(which):
    """Equilibrium and critical radii: torch.pow(x, 1/3) in the port's
    minimisers against jnp.cbrt, through the root find: rtol 1e-10."""
    inp = _inputs()
    rd3, kpa, RH, T = inp["rd3"], inp["kpa"], inp["RH"], inp["T"]
    if which == "rw3_eq":
        want = jc.kappa_koehler.rw3_eq(*map(jnp.asarray, (rd3, kpa, RH, T)))
        got = tc.kappa_koehler.rw3_eq(*map(t, (rd3, kpa, RH, T)))
    else:
        fj = getattr(jc.kappa_koehler, which)
        ft = getattr(tc.kappa_koehler, which)
        want = fj(*map(jnp.asarray, (rd3, kpa, T)))
        got = ft(*map(t, (rd3, kpa, T)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("formula", list(RH_formula_t), ids=lambda f: f.name)
def test_RH_of_matches_jax(formula):
    from libcloudphxx_tpu.lgrngn.state import StaticConfig
    from libcloudphxx_tpu_torch.lgrngn.opts import opts_init_t
    oi = opts_init_t()
    oi.nx = oi.nz = 4
    oi.RH_formula = formula
    # the JAX StaticConfig reads the same option names
    cfg = StaticConfig.from_opts_init(oi)
    inp = _inputs()
    want = jhskpng.RH_of(cfg, *(jnp.asarray(inp[k]) for k in ("p", "rv", "T")))
    got = thskpng.RH_of(port_cfg(cfg), *(t(inp[k]) for k in ("p", "rv", "T")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def _vt_cfg(formula):
    from libcloudphxx_tpu.lgrngn.state import StaticConfig
    from libcloudphxx_tpu_torch.lgrngn.opts import opts_init_t
    oi = opts_init_t()
    oi.nx = oi.nz = 4
    oi.terminal_velocity = formula
    return StaticConfig.from_opts_init(oi)


def _vt_rtol(formula, inp):
    """rtol 1e-12, with khvorostyanov_rtol for Khvorostyanov's formulas."""
    if "khvorostyanov" in formula.name:
        return khvorostyanov_rtol(inp["r"], inp["rhod"], inp["eta"], 1e-12)
    return np.full(N, 1e-12)


@pytest.mark.parametrize("formula", list(vt_t), ids=lambda f: f.name)
def test_vt_of_matches_jax(formula):
    """The population vt under each formula: beard77fast through the
    binned sea-level table, undefined zeros."""
    cfg = _vt_cfg(formula)
    inp = _inputs()
    rw2 = inp["r"] ** 2
    rw2[::7] = 0.0  # dead slots
    args = (rw2, inp["T"], inp["p"], inp["rhod"], inp["eta"])
    want = jvterm.vt_of(cfg, *map(jnp.asarray, args))
    got = tvterm.vt_of(port_cfg(cfg), *map(t, args))
    _close(got.numpy(), np.asarray(want), _vt_rtol(formula, inp))
    assert (float(got.abs().max()) > 0) == (formula != vt_t.undefined)


@pytest.mark.parametrize("formula", list(vt_t), ids=lambda f: f.name)
def test_vt_in_kernel_matches_jax(formula):
    """The kernels' vt under each formula: beard77fast by the direct
    polynomial, like the TPU kernel (pallas_coal._vt_in_kernel)."""
    cfg = _vt_cfg(formula)
    inp = _inputs()
    rw2 = inp["r"] ** 2
    rw2[::7] = 0.0
    args = (rw2, inp["T"], inp["p"], inp["rhod"], inp["eta"])
    want = pallas_coal._vt_in_kernel(cfg, *map(jnp.asarray, args))
    got = tvterm.vt_in_kernel(port_cfg(cfg), *map(t, args))
    _close(got.numpy(), np.asarray(want), _vt_rtol(formula, inp))
    assert bool((got[torch.from_numpy(rw2 == 0.0)] == 0.0).all())


# float32 vt_in_kernel against pallas_coal._vt_in_kernel, by radius band:
# the rtol of each band of VT_F32_EDGES [m], the largest difference over
# five seeds times 2-4.  Beard: against _vt_in_kernel at float32; the two
# libraries' float32 exp, log and pow differ in their last ulps.  beard77:
# exp of the sea-level polynomial in log(r), whose value reaches ~7
# (2.3e-5 between 10 and 100 um, the large-drop polynomial's 8 terms).
# beard76: powf(eta, 4) and powf(N_p, 1/6) of the large-drop regime
# (1.8e-5 above 1 mm), a few ulps elsewhere.  Khvorostyanov: the port
# evaluates it in float64 (common/vterm.py), so against _vt_in_kernel at
# float64 on the same float32 inputs: the float32 rounding of the result
# (6e-8) and PyTorch's CPU float64 sqrt (an ulp off for some arguments)
# over root - 1 (2e-9 at 3 nm); the band test below shows what float32
# evaluation does to it.
VT_F32_EDGES = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, np.inf)
VT_F32_RTOL = {
    vt_t.beard76: (2e-6, 2e-6, 2e-6, 2e-6, 1e-5, 5e-5),
    vt_t.beard77: (1e-5, 1e-5, 1e-5, 5e-5, 2e-5, 2e-6),
    vt_t.beard77fast: (1e-5, 1e-5, 1e-5, 5e-5, 2e-5, 2e-6),
    vt_t.khvorostyanov_spherical: (2e-7,) * 6,
    vt_t.khvorostyanov_nonspherical: (2e-7,) * 6,
}


def _f32_vt_case(formula, seed=11, n=20000):
    """Seeded float32 (rw2, T, p, rhod, eta) over r 1 nm-5 mm, every ninth
    slot dead, and the radii."""
    rng = np.random.default_rng(seed)
    r = np.exp(rng.uniform(np.log(1e-9), np.log(5e-3), n))
    T = rng.uniform(250.0, 310.0, n)
    args = [a.astype(np.float32) for a in (
        r ** 2, T, rng.uniform(7e4, 1.02e5, n), rng.uniform(0.8, 1.25, n),
        1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5)]
    args[0][::9] = 0.0
    return args, r


@pytest.mark.parametrize("formula", list(vt_t), ids=lambda f: f.name)
def test_vt_in_kernel_float32_matches_jax_by_radius_band(formula):
    cfg = _vt_cfg(formula)
    args, r = _f32_vt_case(formula)
    khv = "khvorostyanov" in formula.name
    ref = [jnp.asarray(a, jnp.float64 if khv else jnp.float32) for a in args]
    want = np.asarray(pallas_coal._vt_in_kernel(cfg, *ref))
    got = tvterm.vt_in_kernel(port_cfg(cfg), *map(torch.from_numpy,
                                                  args)).numpy()
    assert got.dtype == np.float32
    assert not np.isnan(got).any() and not np.isnan(want).any()
    assert (got[args[0] == 0.0] == 0.0).all()
    if formula == vt_t.undefined:
        assert not got.any()
        return
    lo = 0.0
    for hi, rtol in zip(VT_F32_EDGES, VT_F32_RTOL[formula]):
        band = (r >= lo) & (r < hi) & (args[0] > 0)
        assert band.sum() > 100
        np.testing.assert_allclose(got[band], want[band], rtol=rtol,
                                   err_msg=f"r in [{lo:.0e}, {hi:.0e})")
        lo = hi


# float32 evaluation of Khvorostyanov (the JAX package's _vt_in_kernel at
# float32, as its TPU kernel runs it) against the port's float32 result:
# (upper radius [m], the least and the largest error the band shows);
# root - 1 cancels, and under 1.9-2.5 nm it is 0 and b = 0 / 0
KHV_F32_ERROR_BANDS = ((1e-8, 0.1, np.inf), (3e-8, 0.02, 0.5),
                       (1e-7, 2e-3, 0.1), (1e-6, 1e-4, 0.02),
                       (1e-5, 1e-6, 1e-3), (np.inf, 0.0, 2e-5))


@pytest.mark.parametrize("formula", [vt_t.khvorostyanov_spherical,
                                     vt_t.khvorostyanov_nonspherical],
                         ids=lambda f: f.name)
def test_khvorostyanov_float32_evaluation_loses_small_radii(formula):
    """What the port's float64 evaluation avoids: the reference's float32
    evaluation gives NaN for every live droplet under 1.9 nm and for none
    over 2.5 nm (where in between depends on rhod and eta), and its error
    against the port grows as r shrinks."""
    cfg = _vt_cfg(formula)
    args, r = _f32_vt_case(formula)
    ref32 = np.asarray(pallas_coal._vt_in_kernel(cfg, *map(jnp.asarray,
                                                           args)))
    got = tvterm.vt_in_kernel(port_cfg(cfg), *map(torch.from_numpy,
                                                  args)).numpy()
    live = args[0] > 0
    nan = np.isnan(ref32)
    assert nan[live & (r < 1.9e-9)].all() and not nan[r > 2.5e-9].any()
    assert not np.isnan(got).any()
    err = np.abs(ref32 - got) / np.where(live, got, 1.0)
    lo = 0.0
    for hi, least, most in KHV_F32_ERROR_BANDS:
        band = live & (r >= lo) & (r < hi) & ~nan
        assert least <= err[band].max() <= most, (lo, hi, err[band].max())
        lo = hi


def test_Tpr_and_mfp_match_jax():
    """The per-cell closure (th_dry, variable pressure) and mean free paths."""
    from libcloudphxx_tpu.lgrngn import dense as jdense
    cfg = _vt_cfg(vt_t.beard77)
    inp = _inputs()
    th, rv, rhod = inp["th"], inp["rv"], inp["rhod"]
    want = jdense._Tpr(cfg, *map(jnp.asarray, (th, rv, rhod)),
                       jnp.zeros(N))
    got = thskpng.hskpng_Tpr(port_cfg(cfg), *map(t, (th, rv, rhod)),
                             torch.zeros(N, dtype=torch.float64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    for g, w in zip(thskpng.hskpng_mfp(got[0], got[1]),
                    jhskpng.hskpng_mfp(want[0], want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_anchors():
    """Physics anchors: the triple point, Beard 1976 at 0.5 mm, the
    critical supersaturation of a 0.1 um, kappa 0.61 particle."""
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    assert float(tc.const_cp.p_vs(f64(273.16))) == pytest.approx(611.73,
                                                                 rel=1e-12)
    T, p = f64(293.15), f64(101325.0)
    rhoa = p / (tc.constants.R_d * T)
    v = float(tc.vterm.vt_beard76(f64(0.5e-3), T, p, rhoa,
                                  tc.vterm.visc(T)))
    assert 3.8 < v < 4.3
    S = float(tc.kappa_koehler.S_cr(f64(1e-7) ** 3, f64(0.61), f64(293.15)))
    assert S == pytest.approx(1.0006, abs=2e-4)
