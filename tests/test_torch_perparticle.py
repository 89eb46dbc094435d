"""Port parity: the exact and adaptive per-particle condensation
substepping on the flat engine (libcloudphxx_tpu_torch.lgrngn.condensation
cond_perparticle, cond_perparticle_adaptive, perparticle_adaptive_core,
sstp_save in exact mode, and ops/cond.advance_rw2, kernel G's entry)
against the JAX package at float64 on the CPU, where the port runs kernel
G's plain version.

The population is the JAX Kinematic2D's at 8x8 cells, sd_conc 8, with 40
dead slots after the live ones and exact_sstp_cond on, handed to the port
through convert.state_from_numpy; the host model's increment (warmer,
and up to 6% moister, so that droplets activate) comes from a numpy seed.
Tolerances:

* advance_rw2 at each droplet's own ambient conditions: rtol 1e-12 (32
  root-find iterations on both sides);
* one condensation phase (step_cond_body's exact branch against JAX's
  through particles._step_cond_jit): th rtol 1e-12, rv 1e-9, rw2 and the
  four private copies (sstp_tmp_th/rv/rh/p) slot by slot rtol 1e-9.  The
  in-cell mixing sums vapour and heat over each cell's SDs: the port in a
  float64 cumulative sum in cell order, JAX in a segment sum, which add
  in other orders (~1e-16); the copy back to the cell takes the largest
  of values that agree to rounding, where JAX keeps a writer it does not
  specify;
* the adaptive substep counts: equal droplet for droplet;
* the public API over 4 steps without coalescence: the fields rtol 1e-10,
  rw2 and vt rtol 1e-10 for 99% of the droplets and 1e-6 for all (as in
  test_torch_particles.py: haze droplets at their activation barrier
  amplify the ~1e-16 differences of the cell sums), moments rtol 1e-7
  (a cell whose precipitation moment such a droplet dominates reads
  1.1e-8 in the mixing modes), the private copies rtol 1e-9;
* with coalescence the draws differ (Philox here, jax.random there): the
  checks are bench.py's physics checks, collisions, and exact agreement
  between the port's own paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_cond import _population
from test_torch_particles import _compare, _drive, _opts, _totals
from torch_parity import port_cfg, port_flat_state, t

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu.lgrngn import particles as jparticles
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.convert import state_from_numpy, state_to_numpy
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles
from libcloudphxx_tpu_torch.lgrngn.particles import factory
from libcloudphxx_tpu_torch.ops import cond as cond_ops

F64 = dict(device="cpu", dtype=torch.float64)
KW = dict(nx=8, nz=8, sd_conc=8, sstp_coal=2, n_sd_max=8 * 64 + 40)
# the exact modes: with in-cell mixing (the default), without, adaptive
# (with and without the activation override)
MODES = {
    "mix": (3, dict(exact_sstp_cond=True)),
    "nomix": (3, dict(exact_sstp_cond=True, sstp_cond_mix=False)),
    "adaptive_act1": (4, dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                              sstp_cond_act=1)),
    "adaptive_act8": (4, dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                              sstp_cond_act=8)),
}
PRIVATE = ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh", "sstp_tmp_p")


def _kw(mode, coal=False, **over):
    sstp, oi = MODES[mode]
    oi = dict(oi, coal_switch=False) if not coal else dict(
        oi, kernel_parameters=[1e4])
    oi.update(over)
    return dict(KW, sstp_cond=sstp, opts_init_kw=oi)


def _jax_case(mode, seed=5, **over):
    """(JAX cfg, the JAX State after init with the host model's increment
    synced in, the port's cfg and State of the same numbers)."""
    m = JaxKinematic2D(micro="lgrngn", **_kw(mode, **over))
    cfg, st = m.prtcls.cfg, m.prtcls.state
    rng = np.random.default_rng(seed)
    th = np.asarray(st.th) + rng.normal(0.3, 0.3, cfg.n_cell)
    rv = np.asarray(st.rv) * (1 + rng.uniform(0.0, 0.06, cfg.n_cell))
    js = dataclasses.replace(st, th=jnp.asarray(th), rv=jnp.asarray(rv))
    return cfg, js, port_cfg(cfg), port_flat_state(js)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _check_phase(got, want, st0):
    np.testing.assert_allclose(got.th.numpy(), np.asarray(want.th),
                               rtol=1e-12)
    np.testing.assert_allclose(got.rv.numpy(), np.asarray(want.rv),
                               rtol=1e-9)
    for k in ("rw2",) + PRIVATE:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape == st0.n.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=k)
    # droplets grew, and the cells took their vapour
    assert _rel(got.rw2, st0.rw2) > 1e-3
    assert (got.rv.numpy() < np.asarray(st0.rv)).any()


def _ambient(n, seed=3):
    """_population's droplets at their own ambient conditions (float64),
    with slots of rw2 == 0 and rw2 < 0, and per-droplet dt of 0.1 s that
    is 0 (no growth) for every fifth droplet."""
    a = {k: np.array(v) for k, v in
         _population(n, seed=seed, dtype=jnp.float64).items()}
    a["rw2"][3::11] = -1e-14
    dt = np.full(n, 0.1)
    dt[::5] = 0.0
    return a, dt


@pytest.mark.parametrize("RH_max", [1.01, 44.0])
def test_advance_rw2_matches_jax_f64(RH_max):
    """Kernel G's entry on CPU tensors is its plain version: the JAX core's
    rw2 at each droplet's own T, p, RH, rhod, rv and eta, for a scalar dt
    and a dt a droplet; dead slots, rw2 <= 0 and dt == 0 keep rw2."""
    a, dt = _ambient(1000)
    args = [t(v) for v in a.values()]
    for step in (0.1, dt):
        want = np.asarray(jcond._advance_rw2_core(
            jnp.asarray(step), *map(jnp.asarray, a.values()), RH_max))
        got = cond_ops.advance_rw2(
            t(step) if isinstance(step, np.ndarray) else step, *args, RH_max)
        assert got.dtype == torch.float64 and got.shape == (1000,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        assert torch.equal(got, cond_ops.advance_rw2(
            t(step) if isinstance(step, np.ndarray) else step, *args, RH_max,
            plain=True))
        kept = a["rw2"] <= 0
        if isinstance(step, np.ndarray):
            kept |= dt == 0
        np.testing.assert_array_equal(got.numpy()[kept], a["rw2"][kept])
        d = got.numpy()[~kept] - a["rw2"][~kept]
        assert (d > 0).any() and (d < 0).any()
    # a dt a droplet equal to the scalar gives the scalar's bits
    assert torch.equal(cond_ops.advance_rw2(0.1, *args, RH_max),
                       cond_ops.advance_rw2(torch.full((1000,), 0.1,
                                                       dtype=torch.float64),
                                            *args, RH_max))


def test_advance_rw2_refuses_bad_shapes():
    a, _ = _ambient(16)
    args = [t(v) for v in a.values()]
    for bad in ({2: args[2][:8]}, {0: args[0].reshape(4, 4)}):
        call = list(args)
        for i, v in bad.items():
            call[i] = v
        with pytest.raises(ValueError, match="1-D and of one length"):
            cond_ops.advance_rw2(0.1, *call, 44.0)
    with pytest.raises(ValueError, match="1-D and of one length"):
        cond_ops.advance_rw2(torch.full((8,), 0.1), *args, 44.0)


@pytest.mark.parametrize("mode", ["mix", "nomix"])
def test_cond_perparticle_matches_jax(mode):
    """One exact condensation phase (step_cond_body: the closure,
    cond_perparticle, sstp_save(exact=True)) against JAX's."""
    cfg, js, pcfg, ps = _jax_case(mode)
    assert pcfg.exact_sstp_cond and pcfg.sstp_cond_mix == (mode == "mix")
    assert ps.sstp_tmp_th.shape == ps.n.shape
    want = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, False, False, True)
    got = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0)
    _check_phase(got, want, ps)
    # the snapshot is the cells' new state, droplet by droplet
    for k, c in (("sstp_tmp_th", "th"), ("sstp_tmp_rv", "rv"),
                 ("sstp_tmp_p", "p")):
        assert torch.equal(getattr(got, k), getattr(got, c)[got.ijk])


def _dt_spy(monkeypatch, module):
    """Record the per-droplet dt arrays ``module``'s advance_rw2 gets (the
    adaptive phase B's substeps) as numpy."""
    real, seen = module.advance_rw2, []

    def spy(dt, *args, **kw):
        if not isinstance(dt, (int, float)):
            seen.append(np.asarray(dt))
        return real(dt, *args, **kw)

    monkeypatch.setattr(module, "advance_rw2", spy)
    return seen


@pytest.mark.parametrize("act", [1, 8])
def test_cond_perparticle_adaptive_matches_jax(monkeypatch, act):
    """One adaptive condensation phase against JAX's, and each droplet's
    substep count (read off the dt of the masked phase B substeps: dt /
    count) equal droplet for droplet."""
    mode = f"adaptive_act{act}"
    cfg, js, pcfg, ps = _jax_case(mode)
    want = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, False, False, True)
    got = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0)
    _check_phase(got, want, ps)

    j_dt, p_dt = _dt_spy(monkeypatch, jcond), _dt_spy(monkeypatch, tcond)
    from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
    with jax.disable_jit():         # phase B's loop in Python: concrete dt
        jcond.cond_perparticle_adaptive(cfg, jhskpng.hskpng_Tpr(cfg, js),
                                        1.0, 44.0, lam=jcond.stale_mfp(js))
    st = tcond.hskpng.hskpng_Tpr_state(pcfg, ps)
    tcond.cond_perparticle_adaptive(pcfg, st, 1.0, 44.0, (ps.T, ps.p))
    assert len(j_dt) == len(p_dt) == max(4, act)
    # the port's phase B runs over the SDs sorted by cell (kernel G's
    # layout, ops/cond.py perparticle_adaptive): back to slot order
    order = torch.sort(ps.ijk, stable=True)[1].numpy()
    counts = np.empty(order.size, dtype=int)
    counts[order] = np.rint(1.0 / p_dt[0]).astype(int)
    np.testing.assert_array_equal(counts, np.rint(1.0 / j_dt[0]))
    live = ps.n.numpy() > 0
    # the adaptation picks several counts; the override takes act
    assert len(set(counts[live])) > 1
    assert (counts[live] == 8).any() == (act == 8)


@pytest.mark.parametrize("mode", ["mix", "adaptive_act8"])
def test_exact_mode_at_one_substep_matches_jax(mode):
    """exact_sstp_cond at sstp_cond == 1: the per-cell substepping with the
    exact save (and for the adaptive mode, whose sstp_cond_act > 1, the
    exact branch at one substep)."""
    cfg, js, pcfg, ps = _jax_case(mode, sstp_cond=1)
    want = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, False, False, True)
    got = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0)
    _check_phase(got, want, ps)


def test_sstp_save_exact_and_convert_round_trip():
    """sstp_save(exact=True) gathers each SD's cell values, p included, as
    JAX's does; an exact-mode JAX State converts to the port and back
    unchanged, and the port's own arrays convert back into a State that
    steps to the same result."""
    cfg, js, pcfg, ps = _jax_case("mix")
    want = jcond.sstp_save(js, exact=True)
    got = tcond.sstp_save(ps, exact=True)
    for k in PRIVATE:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    back = state_to_numpy(got)
    assert (int(back.pop("rng_seed")), int(back.pop("rng_step"))) == (44, 0)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)),
                                      err_msg=k)
    again = state_from_numpy(state_to_numpy(got), "cpu", torch.float64)
    a = tparticles.step_cond_body(pcfg, got, 1.0, 44.0)
    b = tparticles.step_cond_body(pcfg, again, 1.0, 44.0)
    for k in ("th", "rv", "rw2") + PRIVATE:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    # a per-cell snapshot stays per cell, with no sstp_tmp_p
    flat = tparticles.particles_t(tl.backend_t.serial, Kinematic2D(
        nx=4, nz=4, sd_conc=2, **F64).opts_init, **F64)
    assert flat.state.sstp_tmp_th.shape == (16,)
    assert flat.state.sstp_tmp_p.shape == (0,)


@pytest.fixture(scope="module", params=list(MODES))
def stepped(request):
    """JAX's and the port's particles_t (Kinematic2D's init) after 4
    coalescence-free steps of host fields through the public API."""
    mode = request.param
    jm = JaxKinematic2D(micro="lgrngn", **_kw(mode))
    pm = Kinematic2D(**_kw(mode), **F64)
    assert type(pm.prtcls) is tparticles.particles_t
    rhod = np.asarray(jm.rhod)
    j = _drive(jm.prtcls, rhod, _opts(jl), 4)
    p = _drive(pm.prtcls, rhod, _opts(tl), 4, tensors=True)
    return mode, jm, pm, j, p


def test_public_api_matches_jax(stepped):
    mode, jm, pm, j, p = stepped
    for (jth, jrv), (pth, prv) in zip(j, p):
        np.testing.assert_allclose(pth, jth, rtol=1e-10)
        np.testing.assert_allclose(prv, jrv, rtol=1e-10)
    _compare(jm.prtcls, pm.prtcls, 1e-7)
    for k in PRIVATE:
        np.testing.assert_allclose(
            getattr(pm.prtcls.state, k).numpy(),
            np.asarray(getattr(jm.prtcls.state, k)), rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_slice_run_matches_run_device_and_jax(mode):
    """Kinematic2D.run() (the public API) against JAX's run() without
    coalescence, and against run_device_lgrngn(engine="flat") bitwise."""
    jm = JaxKinematic2D(micro="lgrngn", **_kw(mode))
    pm, pd = (Kinematic2D(**_kw(mode), **F64) for _ in range(2))
    jm.run(4, spinup=2)
    pm.run(4, spinup=2)
    pd.run_device_lgrngn(4, spinup=2)
    np.testing.assert_allclose(pm.th.numpy(), jm.th, rtol=1e-10)
    np.testing.assert_allclose(pm.rv.numpy(), jm.rv, rtol=1e-10)
    assert torch.equal(pm.th, pd.th) and torch.equal(pm.rv, pd.rv)
    for k in ("n", "rw2", "x", "z", "ijk") + PRIVATE:
        assert torch.equal(getattr(pm.prtcls.state, k),
                           getattr(pd.prtcls.state, k)), k


@pytest.mark.parametrize("mode", ["mix", "adaptive_act8"])
def test_coal_slice_physics_and_paths_agree(mode):
    """With coalescence: bench.py's checks through the public API,
    collisions, and run_device_lgrngn(engine="flat") equal to the stepwise
    run() from the same state."""
    m = Kinematic2D(**_kw(mode, coal=True), **F64)
    water0, dry0 = _totals(m.prtcls, m.rv)
    n0 = float(m.prtcls.state.n.sum())
    m.run(2, spinup=2)
    start = (m.prtcls.state, m.th, m.rv)
    m.run(2)
    st = m.prtcls.state
    water, dry = _totals(m.prtcls, m.rv)
    assert abs(water - water0) / water0 < 1e-3
    assert abs(dry - dry0) / dry0 < 1e-4
    fell = m.prtcls.diag_puddle()["particle_number"]
    assert n0 - float(st.n.sum()) - fell > 0          # collisions
    assert ((m.th > 250) & (m.th < 350)).all() and (m.rv > 0).all()
    m.prtcls.state, m.th, m.rv = start
    m.run_device_lgrngn(2)
    dev = m.prtcls.state
    for k in ("n", "rw2", "rd3", "x", "z", "ijk", "th", "rv") + PRIVATE:
        assert torch.equal(getattr(dev, k), getattr(st, k)), k


def test_save_load_keeps_the_private_state(tmp_path):
    m = Kinematic2D(**_kw("mix"), **F64)
    m.run(1, spinup=1)
    path = tmp_path / "exact.npz"
    m.prtcls.save(path)
    b = Kinematic2D(**_kw("mix"), **F64)
    b.prtcls.load(path)
    for k in PRIVATE:
        assert torch.equal(getattr(b.prtcls.state, k),
                           getattr(m.prtcls.state, k)), k
        assert getattr(b.prtcls.state, k).shape == m.prtcls.state.n.shape


def test_exact_modes_construct_and_refusals():
    """exact and adaptive substepping construct on both engines: the
    factory gives the flat particles_t on the CPU and, as the dense engine
    runs them (dense_capable), the dense front on the card or when asked
    for; the dense x-slab mesh refuses them, and the dense engine the SGS
    supersaturation (turb_cond runs on the flat engine)."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import (dense_capable,
                                                           particles_dense_t)
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    oi = Kinematic2D(**_kw("adaptive_act8"), **F64).opts_init
    cfg = tl.StaticConfig.from_opts_init(oi)
    assert dense_capable(cfg)
    for engine in ("auto", "flat"):
        prt = factory(tl.backend_t.CUDA, oi, engine=engine, **F64)
        assert type(prt) is tparticles.particles_t
    assert isinstance(factory(tl.backend_t.CUDA, oi, engine="dense", **F64),
                      particles_dense_t)
    m = Kinematic2D(**_kw("mix"), engine="dense", **F64)
    assert isinstance(m.prtcls, particles_dense_t)
    d = tdense.pack(m.cfg, m.prtcls.state, 16)
    assert d.sd_th.shape == d.n.shape
    with pytest.raises(NotImplementedError, match="exact substepping"):
        MeshRunner(m, 2).run(1)
    with pytest.raises(NotImplementedError, match="SGS"):
        Kinematic2D(**_kw("mix", turb_cond_switch=True), engine="dense",
                    **F64)
    assert type(Kinematic2D(**_kw("mix", turb_cond_switch=True),
                            **F64).prtcls) is tparticles.particles_t
