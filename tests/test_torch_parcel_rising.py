"""Port parity: the rising parcel (the host lowers rhod every step and
passes it to step_sync: the reference's var_rho, where a parcel's dv =
1/rhod follows rhod through the substeps) through the port's public API
on the CPU at float64, sstp_cond 10, against the JAX package, in the
per-cell, exact (with and without in-cell mixing) and adaptive modes
(the plain versions of kernels F's and G's parcel forms), and with the
SGS supersaturation (their parcel turb_cond forms).

Tolerances: th, rv and every droplet's rw2 rtol 1e-10 (the same float64
arithmetic in other orders of summation), with the condensation root
find run to convergence in both packages (RISE_ITERS); wp 1e-10 and ssp
(~1e-4, crossing zero) atol 1e-14 under turb_cond.  At the packages' own
iteration count the first step's activation solves do not converge:
there th and rv hold at 1e-10, and each droplet's rw2 within 1e-10 plus
the JAX package's own distance from its converged solve.  Beside them,
tests/test_lgrngn_parcel.py's test_adaptive_perparticle_substepping on
the port, with its gates (the rest of that file's mirrors are
tests/test_torch_parcel.py).
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_parcel import factory, make_opts, make_opts_init

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond


def _run_parcel(oi, nsteps=40):
    opts = make_opts()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.02])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    for _ in range(nsteps):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    return prtcls, th, rv


def _run_cycle(oi, half=None):
    # condense for 40 steps, then force evaporation (the substepping stress
    # test of reference lgrngn_cond.py:141-170) and return |th - th_init|;
    # ``half`` gets the state after the condensation leg
    opts = make_opts()
    rhod = np.array([1.0])
    th = np.array([300.0])
    rv = np.array([0.02])
    prtcls = factory(oi)
    prtcls.init(th, rv, rhod)
    th_init = th.copy()
    for _ in range(40):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    if half is not None:
        prtcls.diag_all()
        prtcls.diag_wet_mom(3)
        half.update(prtcls=prtcls, th=th[0], rv=rv[0],
                    mom3=prtcls.outbuf()[0])
    rv[0] = 0.002
    for _ in range(40):
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    return abs(th[0] - th_init[0])


def test_adaptive_perparticle_substepping():
    # adaptive per-SD substepping (reference
    # perparticle_nomixing_adaptive_sstp_cond.ipp): lands close to the
    # fixed exact per-particle max-substep result...
    oi_ref = make_opts_init(sstp_cond=16, exact_sstp_cond=True)
    _, th_ref, rv_ref = _run_parcel(oi_ref)
    oi_ad = make_opts_init(
        sstp_cond=16, exact_sstp_cond=True, adaptive_sstp_cond=True,
        sstp_cond_act=16,
    )
    # the condensation leg of the adaptive cycle is _run_parcel(oi_ad)
    # (the same steps from the same init): its state half way
    half = {}
    err_ad = _run_cycle(oi_ad, half)
    prtcls, th_ad, rv_ad = half["prtcls"], half["th"], half["rv"]
    assert abs(rv_ad - rv_ref[0]) < 2e-5
    assert abs(th_ad - th_ref[0]) < 6e-3

    # ...and cuts the condense+evaporate cycle theta error well below the
    # unsubstepped run's gate (reference lgrngn_cond.py:167-170: 4.2e-2 for
    # sstp=1 vs 4.2e-3 for sstp=10): adaptation engages on the
    # evaporation shock
    err_1 = _run_cycle(make_opts_init(sstp_cond=1))
    assert err_ad < err_1 / 3
    assert err_ad < 1.2e-2

    # closure: vapour lost == liquid gained (the per-cell closure of the
    # nomixing path), after the condensation leg
    liq = half["mom3"] * (4.0 / 3) * np.pi * 1e3
    assert abs((0.02 - rv_ad) - liq) < 1e-6
    assert prtcls.opts_init.adaptive_sstp_cond



RISING_MODES = {
    "percell": {},
    "exact, mixing": dict(exact_sstp_cond=True),
    "exact, no mixing": dict(exact_sstp_cond=True, sstp_cond_mix=False),
    "adaptive": dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                     sstp_cond_act=8),
}
RISE_STEPS, RISE_DRHO = 20, 1e-3
# the root find's iterations at which the rising parcel's solves converge
# in both packages (their own count is 32 at float64): the first step
# activates the droplets, where a bracket up to ~40 times rw2 wide is
# left unconverged after 32 Anderson-Bjoerck steps (the JAX package's rw2
# then moves by up to 3e-8 with more iterations), and the two packages'
# elementwise functions, an ulp apart, steer those steps apart (rw2 by up
# to 5e-7 after the first step, 4e-10 after 20; PERF.md section 6)
RISE_ITERS = 48


@contextlib.contextmanager
def _root_iters(n):
    """Both packages' condensation root find at ``n`` iterations (None:
    their own count).  JAX's compiled functions are dropped on entry and
    on exit, so that none traced at another count is reused."""
    if n is None:
        yield
        return
    real = jcond._root_iters, tcond._root_iters
    jcond._root_iters = tcond._root_iters = lambda dtype: n
    jax.clear_caches()
    try:
        yield
    finally:
        jcond._root_iters, tcond._root_iters = real
        jax.clear_caches()


def _rise(pkg, mode):
    """A parcel lifted through RISE_STEPS steps: the host lowers rhod by
    RISE_DRHO a step (a hydrostatic ascent at ~10 m/s) and passes it to
    step_sync, at sstp_cond 10, starting at RH 1.007 (the wet radii in
    equilibrium at opts_init.RH_max, 0.999).  Returns
    (th, rv, rw2, rv at init, the parcel's dv and rhod at the end)."""
    oi = make_opts_init(pkg, sstp_cond=10, **RISING_MODES[mode])
    opts = make_opts(pkg)
    rhod = np.array([1.1])
    th = np.array([290.0])
    rv = np.array([0.007])
    prtcls = factory(oi, pkg)
    prtcls.init(th, rv, rhod)
    rv0 = rv[0]
    for _ in range(RISE_STEPS):
        rhod = rhod * (1.0 - RISE_DRHO)
        prtcls.step_sync(opts, th, rv, rhod)
        prtcls.step_async(opts)
    st = prtcls.state
    return (th[0], rv[0], np.asarray(prtcls.get_attr("rw2")), rv0,
            float(st.dv[0]), float(st.rhod[0]))


# each rise runs once a process: the default-iteration test reads the
# JAX package's converged rise again
@functools.lru_cache(maxsize=None)
def _rise_at(pkg, mode, iters):
    with _root_iters(iters):
        return _rise(pkg, mode)


@pytest.mark.parametrize("mode", list(RISING_MODES))
def test_rising_parcel_matches_jax(mode):
    """var_rho in a parcel: the per-cell weight's dv follows each
    substep's rhod (kernel F's parcel form), and an SD's private air is
    1 kg (G's parcel forms), as the JAX package's parcel.  The droplets
    take up ~1e-4 of the vapour over the ascent, so a dv held at the
    phase's start, or G's division by rhod dv, moves th and rv far past
    the 1e-10 gate (a fault of 1e-3 in the latent heat of each step)."""
    th, rv, rw2, rv0, dv, rhod = _rise_at(tl, mode, RISE_ITERS)
    jth, jrv, jrw2, *_ = _rise_at(jl, mode, RISE_ITERS)
    assert th == pytest.approx(jth, rel=1e-10)
    assert rv == pytest.approx(jrv, rel=1e-10)
    np.testing.assert_allclose(rw2, jrw2, rtol=1e-10)
    assert (rv0 - rv) / rv0 > 1e-4
    # the parcel's dv is the volume of its 1 kg of dry air at the last rhod
    assert dv == 1.0 / rhod


def test_rising_parcel_default_iterations_matches_jax():
    """The per-cell rising parcel at the packages' own root-find count:
    th and rv rtol 1e-10; each droplet's rw2 within 1e-10 of the JAX
    package's plus that package's own distance from its converged solve
    (RISE_ITERS), which exceeds 1e-10: the first step's activation
    solves are left unconverged."""
    th, rv, rw2, *_ = _rise_at(tl, "percell", None)
    jth, jrv, jrw2, *_ = _rise_at(jl, "percell", None)
    crw2 = _rise_at(jl, "percell", RISE_ITERS)[2]
    assert th == pytest.approx(jth, rel=1e-10)
    assert rv == pytest.approx(jrv, rel=1e-10)
    unconverged = np.abs(jrw2 - crw2)
    assert np.all(np.abs(rw2 - jrw2) <= 1e-10 * jrw2 + unconverged)
    assert np.max(unconverged / crw2) > 1e-10


TURB_MODES = ("percell", "exact, mixing", "adaptive")


@pytest.mark.parametrize("mode", TURB_MODES)
def test_rising_parcel_turb_cond_matches_jax(mode, monkeypatch):
    """The SGS supersaturation in a rising parcel (turb_cond with a
    dissipation rate; kernel F's and G's parcel turb_cond forms on the
    card): 6 steps, the JAX package's async phase fed the port's Philox
    normals (wp alone: turb_cond without turb_adve) and run eagerly, the
    root find at RISE_ITERS; th, rv, wp and rw2 rtol 1e-10, ssp atol
    1e-14."""
    with _root_iters(RISE_ITERS):
        _turb_rise(mode, monkeypatch)


def _turb_rise(mode, monkeypatch):
    from test_torch_les import _fed

    from libcloudphxx_tpu_torch.lgrngn.turbulence import AXES
    from libcloudphxx_tpu_torch.ops import philox
    prts, fields = [], []
    for pkg in (tl, jl):
        oi = make_opts_init(pkg, sstp_cond=10, turb_cond_switch=True,
                            **RISING_MODES[mode])
        prt = factory(oi, pkg)
        prt.init(np.array([290.0]), np.array([0.007]), np.array([1.1]))
        prts.append(prt)
        fields.append((np.array([290.0]), np.array([0.007])))
    (pp, jp), rhod = prts, np.array([1.1])
    diss = np.array([1e-2])
    for _ in range(6):
        rhod = rhod * (1.0 - RISE_DRHO)
        for prt, pkg, (th, rv) in zip(prts, (tl, jl), fields):
            o = make_opts(pkg)
            o.turb_cond = True
            prt.step_sync(o, th, rv, rhod, diss_rate=diss)
        st = pp.state
        nrm = [philox.normal(st.rng_seed, st.rng_step, AXES["wp"],
                             pp.cfg.n_sd_max, torch.float64).numpy()]
        o = make_opts(tl)
        o.turb_cond = True
        pp.step_async(o)
        o = make_opts(jl)
        o.turb_cond = True
        monkeypatch.setattr(jax.random, "normal", _fed(nrm))
        with jax.disable_jit():
            jp.step_async(o)
        monkeypatch.undo()
        assert not nrm
    (th, rv), (jth, jrv) = fields
    assert th[0] == pytest.approx(jth[0], rel=1e-10)
    assert rv[0] == pytest.approx(jrv[0], rel=1e-10)
    st, js = pp.state, jp.state
    np.testing.assert_allclose(st.wp.numpy(), np.asarray(js.wp), rtol=1e-10)
    # ssp (~1e-4, crossing zero) as tests/test_torch_les.py: absolute
    np.testing.assert_allclose(st.ssp.numpy(), np.asarray(js.ssp),
                               atol=1e-14)
    rw2, jrw2 = st.rw2.numpy(), np.asarray(js.rw2)
    np.testing.assert_allclose(rw2, jrw2, rtol=1e-10)
    assert (st.wp != 0).any()
    assert (st.ssp != 0).any() == (mode != "exact, mixing")
