"""Port parity: the LES slice of the flat engine (the SGS supersaturation
in the three condensation modes, and the public API
with turb_adve, turb_cond and turb_coal under the onishi kernel, the
aerosol source and the CCN relaxation) against the JAX package at
float64 on the CPU, where the port runs kernels F's and G's turb_cond
forms' plain versions; and the dense front's routing of the SGS switches.

The populations are the Kinematic2D GMD case's at 8x8 cells; ssp and
dot_ssp, and the host model's increment, come from numpy seeds.
Tolerances:

* one turb_cond condensation phase (step_cond_body against JAX's through
  particles._step_cond_jit with turb_cond) per cell, exact with and
  without mixing, and adaptive: th rtol 1e-12, rv 1e-10, ssp and the
  private copies slot by slot 1e-10, rw2 1e-10 for 99% of the droplets and
  1e-6 for all (the cell sums add in other orders, and a haze droplet at
  its activation barrier amplifies that: test_torch_perparticle.py);
* the public API, configurations (a) and (d) of the LES slice at 8x8 for 5
  steps, the JAX package fed the port's Philox draws (the coalescence
  shuffles and Bernoulli draws, and the turbulence normals) in place of
  its jax.random ones (its steps run eagerly, jax.disable_jit): th and rv
  rtol 1e-9, multiplicities and cells exact, rw2 1e-8 for 99% of the
  droplets and 1e-6 for all (haze droplets at their activation barrier,
  test_torch_particles.py), x, z, up, wp rtol 1e-9, ssp atol 1e-12, the
  in-cloud time and the sources' and the relaxation's SDs slot by slot.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import particles as jparticles
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles
from libcloudphxx_tpu_torch.lgrngn.dense_front import (dense_capable,
                                                       particles_dense_t)
from libcloudphxx_tpu_torch.ops import philox

F64 = dict(device="cpu", dtype=torch.float64)
KW = dict(nx=8, nz=8, sd_conc=8, n_sd_max=8 * 64 + 40)
MODES = {
    "percell": (4, {}),
    "mix": (3, dict(exact_sstp_cond=True)),
    "nomix": (3, dict(exact_sstp_cond=True, sstp_cond_mix=False)),
    "adaptive": (4, dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                         sstp_cond_act=8)),
}
PRIVATE = ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh", "sstp_tmp_p")


def _case(mode, seed=5, **over):
    """(JAX cfg, the JAX State after init with the host model's increment
    synced in and ssp / dot_ssp from a seed, the port's cfg and State of
    the same numbers)."""
    sstp, oi = MODES[mode]
    oi = dict(oi, coal_switch=False, turb_cond_switch=True)
    oi.update(over)
    m = JaxKinematic2D(micro="lgrngn", sstp_cond=sstp, opts_init_kw=oi, **KW)
    cfg, st = m.prtcls.cfg, m.prtcls.state
    rng = np.random.default_rng(seed)
    n_sd = st.n.shape[0]
    th = np.asarray(st.th) + rng.normal(0.3, 0.3, cfg.n_cell)
    rv = np.asarray(st.rv) * (1 + rng.uniform(0.0, 0.06, cfg.n_cell))
    js = dataclasses.replace(
        st, th=jnp.asarray(th), rv=jnp.asarray(rv),
        ssp=jnp.asarray(rng.normal(0.0, 2e-3, n_sd)),
        dot_ssp=jnp.asarray(rng.normal(0.0, 1e-3, n_sd)))
    return cfg, js, port_cfg(cfg), port_flat_state(js)


def _rw2_close(got, want, rtol=1e-10):
    rel = np.abs(got - want) / np.maximum(want, 1e-300)
    assert np.mean(rel <= rtol) >= 0.99
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("mode", list(MODES))
def test_turb_cond_phase_matches_jax(mode):
    """One condensation phase with turb_cond: each SD at its RH plus its
    ssp (advanced each substep per cell, held for the phase by the exact
    fixed count, carried on the tries and substeps and rewound by the
    adaptive mode)."""
    cfg, js, pcfg, ps = _case(mode)
    want = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, True, False, True)
    got = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0, turb_cond=True)
    np.testing.assert_allclose(got.th.numpy(), np.asarray(want.th),
                               rtol=1e-12)
    np.testing.assert_allclose(got.rv.numpy(), np.asarray(want.rv),
                               rtol=1e-10)
    _rw2_close(got.rw2.numpy(), np.asarray(want.rw2))
    keys = ("ssp",) + (PRIVATE if pcfg.exact_sstp_cond else ())
    for k in keys:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-10,
                                   atol=1e-18 if k == "ssp" else 0.0,
                                   err_msg=k)
    # the perturbation changed the growth, and moved where it runs
    plain = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0)
    assert _rel(got.rw2, plain.rw2) > 1e-6
    moved = _rel(got.ssp, ps.ssp) > 1e-6
    assert moved == (mode in ("percell", "adaptive"))


# ------------------------------------------ the public API, (a) and (d)
LES_KW = dict(nx=8, nz=8, sd_conc=8, sstp_cond=3, sstp_coal=3,
              n_sd_max=8 * 64 + 512)
DISS = 1e-3          # m2/s3 in every cell (test_lgrngn_transport.py:181)


def _les_models(case):
    """The port's and the JAX package's Kinematic2D with the LES switches,
    the onishi kernel, and for (d) the simple source in the lowest two
    levels and the relaxation towards the GMD distribution."""
    def kw(pkg, m):
        setup = m.setup
        oi = dict(turb_adve_switch=True, turb_cond_switch=True,
                  turb_coal_switch=True, diag_incloud_time=True,
                  kernel=pkg.kernel_t.onishi_hall, kernel_parameters=[100.0])
        if case == "d":
            oi.update(src_type=pkg.src_t.simple, src_x0=0.0,
                      src_x1=8 * m.dx, src_z0=0.0, src_z1=2 * m.dz,
                      rlx_switch=True, supstp_rlx=2, rlx_bins=16,
                      rlx_sd_per_bin=1, rlx_timescale=10.0,
                      rlx_dry_distros={setup.kappa: (
                          setup.lognormal_lnrd, (0.0, 2.0),
                          (0.0, 8 * m.dz))})
        return oi
    pm = Kinematic2D(**LES_KW, opts_init_kw={}, **F64)
    pm = Kinematic2D(**LES_KW, opts_init_kw=kw(tl, pm), **F64)
    jm = JaxKinematic2D(micro="lgrngn", **LES_KW)
    jm = JaxKinematic2D(micro="lgrngn", opts_init_kw=kw(jl, jm), **LES_KW)
    return pm, jm


def _les_opts(pkg, case, setup):
    """(a): the SGS switches and recycling; (d): the SGS switches, the
    source and the relaxation, without recycling, which would split SDs
    into every dead slot the source needs (rcyc.ipp, as the reference's)."""
    o = pkg.opts_t()
    o.turb_adve = o.turb_cond = o.turb_coal = True
    o.rcyc = case == "a"
    if case == "d":
        o.src = o.rlx = True
        o.src_dry_distros = {(setup.kappa, 0.0): (setup.lognormal_lnrd, 4,
                                                  2)}
    return o


def _fed(queue):
    """A stand-in for jax.random.uniform / normal that hands out the
    arrays of ``queue`` in order."""
    def draw(key, shape=(), dtype=None, *args, **kwargs):
        a = queue.pop(0)
        assert a.shape == tuple(shape)
        return jnp.asarray(a)
    return draw


def _port_draws(prt, sstp, turb_names):
    """The port's draws of its next async phase, in the order the JAX
    package's phase asks for them: each coalescence substep's shuffle
    (bits as uniforms) and Bernoulli draws, then the turbulent velocities'
    normals (the step counter one on)."""
    st = prt.state
    n = prt.cfg.n_sd_max
    sh = philox.draw_substeps(st.rng_seed, st.rng_step, sstp, philox.SHUFFLE,
                              n)
    be = philox.draw_substeps(st.rng_seed, st.rng_step, sstp,
                              philox.BERNOULLI, n)
    uni = []
    for s in range(sstp):
        uni += [sh[s].numpy() * 2.0 ** -32,
                philox.u01(be[s], torch.float64).numpy()]
    from libcloudphxx_tpu_torch.lgrngn.turbulence import AXES
    nrm = [philox.normal(st.rng_seed, st.rng_step + 1, AXES[k], n,
                         torch.float64).numpy() for k in turb_names]
    return uni, nrm


@pytest.mark.parametrize("case", ["a", "d"])
def test_les_public_api_matches_jax(case, monkeypatch):
    """Configurations (a) and (d) of the LES slice at 8x8 for 5 steps:
    step_sync(opts, th, rv, rhod, diss_rate=...) then step_async(opts),
    the JAX package fed the port's draws."""
    pm, jm = _les_models(case)
    po, jo = _les_opts(tl, case, pm.setup), _les_opts(jl, case, jm.setup)
    pp, jp = pm.prtcls, jm.prtcls
    assert type(pp) is tparticles.particles_t
    rhod = pm.rhod.numpy()
    diss = np.full((8, 8), DISS)
    rng = np.random.default_rng(3)
    th0, rv0 = pm.th.numpy(), pm.rv.numpy()
    alive0 = int((pp.state.n > 0).sum())
    for k in range(5):
        th = th0 + rng.normal(0.3, 0.2, th0.shape)
        rv = rv0 * (1 + rng.uniform(0, 0.03, rv0.shape))
        tj, rj = th.copy(), rv.copy()
        pp.step_sync(po, th, rv, rhod, diss_rate=diss)
        jp.step_sync(jo, tj, rj, rhod, diss_rate=diss)
        np.testing.assert_allclose(th, tj, rtol=1e-9)
        np.testing.assert_allclose(rv, rj, rtol=1e-9)
        uni, nrm = _port_draws(pp, pp.opts_init.sstp_coal, ("up", "wp"))
        pp.step_async(po)
        monkeypatch.setattr(jax.random, "uniform", _fed(uni))
        monkeypatch.setattr(jax.random, "normal", _fed(nrm))
        with jax.disable_jit():
            jp.step_async(jo)
        monkeypatch.undo()
        assert not uni and not nrm
    st, js = pp.state, jp.state
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(st.ijk.numpy(), np.asarray(js.ijk))
    _rw2_close(st.rw2.numpy(), np.asarray(js.rw2), rtol=1e-8)
    for k in ("x", "z", "up", "wp", "rd3", "kpa"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(st.ssp.numpy(), np.asarray(js.ssp),
                               atol=1e-12)
    np.testing.assert_array_equal(st.incloud_time.numpy(),
                                  np.asarray(js.incloud_time))
    np.testing.assert_allclose(st.diss_rate.numpy(), np.asarray(js.diss_rate),
                               rtol=1e-14)
    for diag, n in (("diag_up_mom", 2), ("diag_wp_mom", 1),
                    ("diag_vp_mom", 2), ("diag_incloud_time_mom", 1)):
        for prt in (pp, jp):
            prt.diag_all()
            getattr(prt, diag)(n)
        np.testing.assert_allclose(pp.outbuf(), jp.outbuf(), rtol=1e-9,
                                   atol=1e-300, err_msg=diag)
    # the LES physics: |up| of the order of sqrt(2/3 TKE), ssp moved, SDs
    # activated, and for (d) the source's and relaxation's SDs
    live = st.n.numpy() > 0
    tke = float(st.diss_rate[0])
    assert 0.1 < np.abs(st.up.numpy()[live]).mean() / np.sqrt(2 / 3 * tke) \
        < 2.0
    assert np.abs(st.ssp.numpy()[live]).max() > 0
    assert (st.incloud_time.numpy()[live] > 0).any()
    # (a) recycles every dead slot; (d) adds the source's and the
    # relaxation's SDs
    assert live.sum() == (pp.cfg.n_sd_max if case == "a" else live.sum())
    assert (live.sum() > alive0) and (pp._src_ctr, pp._rlx_ctr) == (
        (0, 0) if case == "a" else (5, 5))


# ------------------------------------------- (e): the dense front's route
def _front_pair(coal=True):
    """Configuration (e) at 8x8: turb_adve_switch with the hall kernel, on
    the dense front (engine="dense") and on the flat engine."""
    kw = dict(nx=8, nz=8, sd_conc=8, sstp_cond=3, sstp_coal=3,
              opts_init_kw=dict(turb_adve_switch=True,
                                kernel=tl.kernel_t.hall,
                                coal_switch=coal))
    return (Kinematic2D(**kw, engine="dense", **F64),
            Kinematic2D(**kw, engine="flat", **F64))


def _front_step(m, opts, diss):
    th, rv = m.th.numpy().copy(), m.rv.numpy().copy()
    m.prtcls.step_sync(opts, th, rv, m.rhod.numpy(),
                       diss_rate=np.full((8, 8), diss))
    m.prtcls.step_async(opts)
    return th, rv


def test_turb_adve_on_the_dense_front_matches_the_flat_engine(monkeypatch):
    """(e): the dense front condenses on the dense engine (kernel B's plain
    version here) and hands the async phase, with the SGS block and the
    turbulent displacement, to the flat engine.  From init (the population
    cell-sorted, so the pack keeps every SD's slot and its draws) one step
    equals the flat engine's within the front's known vt difference
    (test_torch_dense_front.py: th 2e-7, rv 3e-6); the velocity
    perturbations bitwise."""
    md, mf = _front_pair()
    assert isinstance(md.prtcls, particles_dense_t)
    assert dense_capable(md.prtcls.cfg)
    calls = []
    real = tdense.step_cond_resident
    monkeypatch.setattr(tdense, "step_cond_resident",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    opts = tl.opts_t()
    opts.turb_adve = True
    got, want = _front_step(md, opts, DISS), _front_step(mf, opts, DISS)
    assert calls == [1] and md.prtcls._loc == "flat"
    np.testing.assert_allclose(got[0], want[0], rtol=2e-7)
    np.testing.assert_allclose(got[1], want[1], rtol=3e-6)
    a, b = md.prtcls.state, mf.prtcls.state
    live = b.n > 0       # unpack pads dead slots with zeros
    assert torch.equal(a.n, b.n) and torch.equal(a.rd3[live], b.rd3[live])
    assert torch.equal(a.up, b.up) and torch.equal(a.wp, b.wp)
    assert a.rng_step == b.rng_step == 2
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=1e-9)
    np.testing.assert_allclose(a.z.numpy(), b.z.numpy(), rtol=1e-6)
    assert (a.up != 0).any() and (a.wp != 0).any()


def test_velocity_perturbations_ride_the_dense_pack():
    """Under turb_adve_switch each SD keeps its up and wp through the
    front's pack and unpack, step after step: with no dissipation (the TKE
    0) an SD's perturbation stays as it was, wherever the packs put it
    (the SDs told apart by their dry radius; coalescence off)."""
    md, _ = _front_pair(coal=False)
    opts = tl.opts_t()
    opts.turb_adve = True
    for _ in range(3):
        _front_step(md, opts, DISS)
    st = md.prtcls.state
    live = st.n > 0
    before = dict(zip(st.rd3[live].tolist(),
                      zip(st.up[live].tolist(), st.wp[live].tolist())))
    assert len(before) == int(live.sum())
    _front_step(md, opts, 0.0)
    st = md.prtcls.state
    live = st.n > 0
    after = dict(zip(st.rd3[live].tolist(),
                     zip(st.up[live].tolist(), st.wp[live].tolist())))
    assert after.keys() == before.keys()
    np.testing.assert_allclose(np.array([after[k] for k in before]),
                               np.array(list(before.values())), rtol=1e-12)
    assert md.prtcls.get_attr("wp").shape == (md.prtcls.cfg.n_sd_max,)


def test_les_switches_and_refusals():
    """The LES switches construct on the flat engine; the dense engine
    refuses turb_cond and diag_incloud_time (the JAX package's
    _supported), with the reason, and runs the turbulent kernels (at
    dissipation rate 0, as the JAX package's dense engine); ice and
    chemistry stay refused; a turb switch an opts_init did not turn on
    raises."""
    base = Kinematic2D(nx=4, nz=4, sd_conc=2, **F64).opts_init

    def oi(**over):
        o = tl.opts_init_t()
        o.__dict__.update(base.__dict__)
        o.__dict__.update(over)
        return o
    for over, why in (({"turb_cond_switch": True}, "SGS"),
                      ({"diag_incloud_time": True}, "diag_incloud_time")):
        prt = tl.factory(tl.backend_t.CUDA, oi(**over), **F64)
        assert type(prt) is tparticles.particles_t
        assert not dense_capable(prt.cfg)
        with pytest.raises(NotImplementedError, match=why):
            tl.factory(tl.backend_t.CUDA, oi(**over), engine="dense", **F64)
    assert dense_capable(tl.factory(tl.backend_t.CUDA, oi(
        turb_adve_switch=True, turb_coal_switch=True), **F64).cfg)
    assert dense_capable(tl.factory(tl.backend_t.CUDA, oi(
        kernel=tl.kernel_t.onishi_hall), **F64).cfg)
    # ice and chemistry run on the flat engine, which the factory gives
    # for them, and the dense engine refuses them, as the JAX package's
    for over in ({"ice_switch": True}, {"chem_switch": True}):
        prt = tl.factory(tl.backend_t.CUDA, oi(**over), **F64)
        assert type(prt) is tparticles.particles_t
        assert not dense_capable(prt.cfg)
        with pytest.raises(NotImplementedError, match="ice/chem"):
            tl.factory(tl.backend_t.CUDA, oi(**over), engine="dense", **F64)
    m = Kinematic2D(nx=4, nz=4, sd_conc=2, **F64)
    for name, switch in (("turb_cond", "turb_cond_switch"),
                         ("turb_coal", "turb_coal_switch")):
        opts = tl.opts_t()
        setattr(opts, name, True)
        with pytest.raises(RuntimeError, match=switch):
            if name == "turb_cond":
                m.prtcls.step_sync(opts, m.th.numpy(), m.rv.numpy())
            else:
                m.prtcls.step_sync(tl.opts_t(), m.th.numpy(), m.rv.numpy())
                m.prtcls.step_async(opts)
    with pytest.raises(RuntimeError, match="diag_incloud_time"):
        m.prtcls.diag_all()
        m.prtcls.diag_incloud_time_mom(0)
