"""Port parity: the dense engine behind the public API
(libcloudphxx_tpu_torch/lgrngn/dense_front.py, particles_dense_t) against
the JAX package's particles_dense_t (LIBCLOUD_ENGINE=dense, set inside the
test only) and against the port's own flat engine, at float64 on the CPU,
on the 6x5 case of tests/test_dense_public.py: 5 steps of step_sync /
step_async with advection, condensation and sedimentation.

Tolerances, coalescence off:
* The port's dense engine rebuilds each droplet's vt from its current cell
  before condensation, as the TPU kernel does; the JAX dense front on the
  CPU (its XLA pipeline) and both flat engines carry vt from the previous
  step (ROADMAP.md, known differences).  With courant 0.2 droplets change
  cells every few steps, and the growth rate's 1/(S-1) sensitivity near
  saturation carries that to th rtol 2e-7, rv 3e-6, RH and the third wet
  moment 1e-5, and the puddle's liquid volume 3e-6 within 5 steps;
  sd_conc, the zeroth moment and the puddle's counts are exact.
* With the port's condensation made to read the carried vt instead
  (patched inside the test), the port's dense front matches the JAX dense
  front and the port's flat engine at the JAX package's own gates between
  its two engines (tests/test_dense_public.py): th 1e-12, rv 1e-10, RH
  1e-10, moments 1e-9, puddle 1e-9.
With coalescence the random streams differ (Philox here, jax.random
there): the JAX test's statistical gates, and the port's front bitwise
against its own Kinematic2D.run_device_lgrngn(engine="dense"), which
runs the same kernels (plain versions here) on the same inputs.
"""

import os
from math import log, pi, sqrt

import numpy as np
import pytest
import torch
from torch_parity import multiset

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.dense_front import (dense_capable,
                                                       particles_dense_t)
from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM
from libcloudphxx_tpu_torch.ops import step as tstep

NX, NZ = 6, 5
F64 = dict(device="cpu", dtype=torch.float64)


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * np.exp(-((np.asarray(lnr) - log(mean_r)) ** 2)
                           / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


def _setup(L, do_coal, sd_conc=20):
    """tests/test_dense_public.py's case for the package ``L``."""
    oi = L.opts_init_t()
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.coal_switch = do_coal
    if do_coal:
        oi.kernel = L.kernel_t.geometric
    oi.terminal_velocity = L.vt_t.beard77
    oi.sedi_switch = True
    oi.dt = 1
    oi.nx, oi.nz = NX, NZ
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = NX * 100.0, NZ * 100.0
    oi.sd_conc = sd_conc
    oi.n_sd_max = sd_conc * NX * NZ
    oi.sstp_cond = 3
    oi.sstp_coal = 2
    opts = L.opts_t()
    opts.adve = opts.cond = opts.sedi = True
    opts.coal = do_coal
    opts.chem_dsl = False
    return oi, opts


def _fields():
    return (289.0 * np.ones((NX, NZ)), 7.5e-3 * np.ones((NX, NZ)),
            np.ones((NX, NZ)))


def _drive(p, opts, steps=5):
    th, rv, rhod = _fields()
    p.init(th, rv, rhod, Cx=0.2 * np.ones((NX + 1, NZ)),
           Cz=-0.1 * np.ones((NX, NZ + 1)))
    for _ in range(steps):
        p.step_sync(opts, th, rv, rhod)
        p.step_async(opts)
    out = dict(th=th, rv=rv)
    for k, power in (("sd", None), ("m0", 0), ("m3", 3)):
        p.diag_all()
        if power is None:
            p.diag_sd_conc()
        else:
            p.diag_wet_mom(power)
        out[k] = p.outbuf().copy()
    p.diag_RH()
    out["RH"] = p.outbuf().copy()
    out["puddle"] = p.diag_puddle()
    out["cls"] = type(p).__name__
    return out


def _port(engine, do_coal):
    oi, opts = _setup(tl, do_coal)
    return _drive(tl.factory(tl.backend_t.serial, oi, engine=engine, **F64),
                  opts)


def _jax(engine, do_coal):
    os.environ["LIBCLOUD_ENGINE"] = engine
    try:
        oi, opts = _setup(jl, do_coal)
        return _drive(jl.factory(jl.backend_t.serial, oi), opts)
    finally:
        os.environ.pop("LIBCLOUD_ENGINE", None)


@pytest.fixture(scope="module")
def jax_dense():
    return _jax("dense", False)


def _carried_vt(monkeypatch):
    """Make the port's condensation read the vt plane the state carries
    (the XLA pipelines' convention) instead of rebuilding it: cond_plain
    asks vt_in_kernel once, for that plane."""
    seen = {}
    real_step = tdense.step_cond_resident
    real_cond = tstep.cond_plain

    def step(cfg, d, *args, **kw):
        seen["vt"] = d.vt
        return real_step(cfg, d, *args, **kw)

    def cond(*args):
        real_vt = tstep.vt_in_kernel
        tstep.vt_in_kernel = lambda *a: seen["vt"]
        try:
            return real_cond(*args)
        finally:
            tstep.vt_in_kernel = real_vt

    monkeypatch.setattr(tdense, "step_cond_resident", step)
    monkeypatch.setattr(tstep, "cond_plain", cond)


TOL_KERNEL_VT = dict(th=2e-7, rv=3e-6, RH=1e-5, m0=1e-12, m3=1e-5)
TOL_CARRIED_VT = dict(th=1e-12, rv=1e-10, RH=1e-10, m0=1e-9, m3=1e-9)


def _compare(got, want, tol, pud_rel):
    for k, rtol in tol.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    np.testing.assert_array_equal(got["sd"], want["sd"])
    for k, v in want["puddle"].items():
        rel = pud_rel if k == "liquid_volume" else 1e-12
        assert got["puddle"][k] == pytest.approx(v, rel=rel, abs=1e-300), k
    assert want["puddle"]["particle_number"] > 0      # rain reached it


@pytest.mark.parametrize("vt", ["kernel", "carried"])
@pytest.mark.parametrize("ref", ["jax_dense", "port_flat"])
def test_dense_front_no_coal(monkeypatch, jax_dense, ref, vt):
    if vt == "carried":
        _carried_vt(monkeypatch)
    got = _port("dense", False)
    assert got["cls"] == "particles_dense_t"
    want = jax_dense if ref == "jax_dense" else _port("flat", False)
    assert want["cls"] == ("particles_dense_t" if ref == "jax_dense"
                           else "particles_t")
    if vt == "kernel":
        _compare(got, want, TOL_KERNEL_VT, 3e-6)
    else:
        _compare(got, want, TOL_CARRIED_VT, 1e-9)


def test_dense_front_with_coal_statistical():
    """The JAX test's gates between its engines, here between the two
    packages' dense fronts (independent random streams)."""
    d, j = _port("dense", True), _jax("dense", True)
    np.testing.assert_allclose(d["th"], j["th"], rtol=1e-5)
    np.testing.assert_allclose(d["rv"], j["rv"], rtol=1e-3)
    np.testing.assert_array_equal(d["sd"], j["sd"])
    np.testing.assert_allclose(d["m3"].sum(), j["m3"].sum(), rtol=1e-3)
    assert d["m0"].sum() < 20 * NX * NZ * 1e9


@pytest.mark.parametrize("pairing", ["stride", "sort"])
def test_dense_front_equals_run_device_lgrngn(pairing):
    """Kinematic2D.run() through the dense front equals
    run_device_lgrngn(engine="dense") from the same state, bitwise: th,
    rv and every plane lane by lane, with coalescence that collides."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, terminal_velocity=tl.vt_t.beard77,
              coal_pairing=pairing,
              opts_init_kw={"kernel_parameters": [100.0]}, **F64)
    front = Kinematic2D(engine="dense", **kw)
    fused = Kinematic2D(engine="flat", **kw)
    assert isinstance(front.prtcls, particles_dense_t)
    assert front.prtcls.coal_pairing == pairing
    n0 = float(front.prtcls.state.n.sum())
    front.run(6, spinup=3)
    fused.run_device_lgrngn(6, spinup=3, engine="dense")
    assert torch.equal(front.th, fused.th) and torch.equal(front.rv,
                                                           fused.rv)
    a, b = front.dense_state, fused.dense_state
    assert a is front.prtcls._d
    for k in tdense.ATTRS + ("puddle", "T", "p", "RH", "eta"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.rng_step == b.rng_step == 3
    # multiplicity lost to collisions, what fell into the puddle aside
    assert n0 - float(a.n.sum()) - float(a.puddle[OUT_PRTCL_NUM]) > 0.0


@pytest.mark.parametrize("engine,cls", [("auto", "particles_t"),
                                        ("dense", "particles_dense_t"),
                                        ("flat", "particles_t")])
def test_factory_engine_choice_on_the_cpu(engine, cls):
    oi, _ = _setup(tl, False)
    p = tl.factory(tl.backend_t.serial, oi, engine=engine, **F64)
    assert type(p).__name__ == cls


def test_factory_refusals_and_capability():
    oi, _ = _setup(tl, True)
    assert dense_capable(tl.particles_t(tl.backend_t.serial, oi, **F64).cfg)
    # the onishi kernels run on the dense engine (at dissipation rate 0,
    # as JAX's); diag_incloud_time goes to the flat engine in both
    oi.kernel = tl.kernel_t.onishi_hall
    oi.kernel_parameters = [100.0]
    assert dense_capable(tl.particles_t(tl.backend_t.serial, oi, **F64).cfg)
    oi.diag_incloud_time = True
    cfg = tl.particles_t(tl.backend_t.serial, oi, **F64).cfg
    assert not dense_capable(cfg)
    with pytest.raises(NotImplementedError, match="diag_incloud_time"):
        tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    with pytest.raises(ValueError, match="engine"):
        tl.factory(tl.backend_t.serial, oi, engine="xla", **F64)


def test_interleaved_diag_and_attrs():
    """Diagnostics mid-run sync the flat layout; carried get_attr works,
    the rest fails loudly instead of reading a stale order."""
    oi, opts = _setup(tl, False, sd_conc=8)
    opts.sedi = False
    p = tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    th, rv, rhod = _fields()
    p.init(th, rv, rhod, Cx=0.1 * np.ones((NX + 1, NZ)),
           Cz=np.zeros((NX, NZ + 1)))
    n0 = p.get_attr("n")
    total0 = n0[n0 > 0].sum()
    for _ in range(4):
        p.step_sync(opts, th, rv, rhod)
        p.step_async(opts)
        assert p._loc == "dense"
        p.diag_all()
        assert p._loc == "flat"
        p.diag_sd_conc()
        assert p.outbuf().sum() == pytest.approx(8 * NX * NZ)
    n1 = p.get_attr("n")
    assert n1[n1 > 0].sum() == pytest.approx(total0)
    assert np.isfinite(p.get_attr("x")).all()
    with pytest.raises(RuntimeError, match="not carried"):
        p.get_attr("up")


def test_save_load_roundtrip(tmp_path):
    oi, opts = _setup(tl, True)
    p = tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    th, rv, rhod = _fields()
    p.init(th, rv, rhod, Cx=0.2 * np.ones((NX + 1, NZ)),
           Cz=-0.1 * np.ones((NX, NZ + 1)))

    def steps(k):
        for _ in range(k):
            p.step_sync(opts, th, rv, rhod)
            p.step_async(opts)

    steps(2)
    path = tmp_path / "front.npz"
    p.save(path)
    saved = th.copy(), rv.copy()
    steps(2)
    first = {a: p.get_attr(a) for a in ("n", "rw2", "x", "z")}
    first_th = th.copy()
    p.load(path)
    assert p._loc == "flat" and p._d is None
    th[:], rv[:] = saved
    steps(2)
    np.testing.assert_array_equal(th, first_th)
    for a, v in first.items():
        np.testing.assert_array_equal(p.get_attr(a), v, a)


def test_a_changed_density_runs_that_step_flat():
    """A density other than the last one sends that step's condensation
    and transport to the flat engine (the substepped density); the same
    tensor handle or equal values keep the dense engine."""
    oi, opts = _setup(tl, False)
    p = tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    th, rv, rhod = _fields()
    p.init(th, rv, rhod, Cx=0.2 * np.ones((NX + 1, NZ)),
           Cz=-0.1 * np.ones((NX, NZ + 1)))
    total0 = p.get_attr("n").sum()
    rhod_t = torch.ones(NX * NZ, dtype=torch.float64)
    for r, loc in ((rhod, "dense"), (rhod_t, "dense"), (rhod_t, "dense"),
                   (rhod * 1.01, "flat"), (rhod * 1.01, "dense")):
        p.step_sync(opts, th, rv, r)
        assert p._loc == loc
        p.step_async(opts)
    # nothing lost across the switches: what fell is in the puddle
    fell = p.diag_puddle()["particle_number"]
    assert fell > 0
    assert p.get_attr("n").sum() + fell == pytest.approx(total0, rel=1e-12)


def test_model_hands_the_front_population_to_both_engines():
    """Kinematic2D over the dense front: dense_state is the front's own
    copy, a dense run continues from it, and a flat run first syncs the
    front's population to the flat layout."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
              terminal_velocity=tl.vt_t.beard77, engine="dense", **F64)
    a, b = Kinematic2D(**kw), Kinematic2D(**kw)
    a.run(3, spinup=1)
    a.run_device_lgrngn(2, engine="dense")
    b.run(5, spinup=1)
    assert torch.equal(a.th, b.th) and torch.equal(a.rv, b.rv)
    for k in tdense.ATTRS:
        assert torch.equal(getattr(a.dense_state, k),
                           getattr(b.dense_state, k)), k
    d = a.dense_state
    moved = multiset(d.n, (d.rd3, d.x, d.z))
    a.run_device_lgrngn(0, engine="flat")
    st = a.prtcls.state
    assert a.prtcls._loc == "flat"
    live = st.n > 0
    flat = np.stack(sorted(zip(st.ijk[live].tolist(), st.n[live].tolist(),
                               st.rd3[live].tolist(), st.x[live].tolist(),
                               st.z[live].tolist())))
    np.testing.assert_array_equal(flat, moved)
    a.run_device_lgrngn(2, engine="flat")
    assert int((a.prtcls.state.n > 0).sum()) == 24 * 64
