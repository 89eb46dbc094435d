"""Port parity: exact and adaptive per-particle condensation on the dense
engine as a slice, through Kinematic2D.run_device_lgrngn(engine="dense")
and the public API's dense front, against the JAX package at float64 on
the CPU and against the port's own flat exact engine (the pieces:
tests/test_torch_dense_exact.py, whose case this file shares: 8x8 cells,
sd_conc 8, sstp_cond 3, beard77, coalescence off, 3 steps of which 1
spin-up).  Tolerances:

* against JAX's own run_device_lgrngn(engine="dense"): in exact mode
  both read the vt each droplet carries (JAX's XLA step_cond and the
  port's G), so the vt convention of the per-cell mode does not arise:
  th and rv rtol 1e-10, moments 0 and 3 rtol 1e-9, the per-cell counts
  exact;
* against the port's flat exact engine: th and rv rtol 1e-12, per cell
  positions rtol 1e-12, rw2 rtol 1e-10 for 99% of the droplets and 1e-6
  for all (test_torch_particles.py's rule);
* the dense front against run_device_lgrngn(engine="dense") and against
  the fused step: bitwise, save/load included; with const_p (th_std, a
  pressure profile) through the public API against the JAX dense front:
  th rtol 1e-12, rv 1e-10, moments 1e-9, the JAX package's own gates
  between its engines.
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_dense_exact import CAP, MODES, PLANES, SD_PLANES, _kw, _pop
from torch_parity import multiset, t

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import vt_t
from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t

F64 = dict(device="cpu", dtype=torch.float64)
NT, SPINUP = 3, 1


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def dense_run():
    m = Kinematic2D(terminal_velocity=vt_t.beard77, engine="dense",
                    **_kw("mix"), **F64)
    assert isinstance(m.prtcls, particles_dense_t)
    init = m.dense_state
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    return m, init


def test_slice_matches_jax_run_device_lgrngn(dense_run):
    m, _ = dense_run
    jm = JaxKinematic2D(micro="lgrngn", terminal_velocity=jl.vt_t.beard77,
                        **_kw("mix"))
    jm.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    jd = jax.jit(jdense.pack, static_argnums=(0, 2))(
        jm.prtcls.cfg, jm.prtcls.state, CAP)
    d = m.dense_state
    np.testing.assert_allclose(m.th.numpy(), np.asarray(jm.th), rtol=1e-10)
    np.testing.assert_allclose(m.rv.numpy(), np.asarray(jm.rv), rtol=1e-10)
    np.testing.assert_array_equal((d.n > 0).sum(1).numpy(),
                                  np.asarray((jd.n > 0).sum(1)))
    for k in (0, 3):
        np.testing.assert_allclose(
            tdense.moment(d, 0.0, 1.0, k).numpy(),
            np.asarray(jdense.moment(jd, 0.0, 1.0, k)), rtol=1e-9)
    # the flat snapshot the JAX engine keeps is the planes', SD for SD
    a = multiset(d.n, (d.rd3,) + tuple(getattr(d, k) for k in SD_PLANES))
    b = multiset(jd.n, (jd.rd3,) + tuple(getattr(jd, k) for k in SD_PLANES))
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_slice_matches_the_flat_exact_engine(dense_run):
    m, init = dense_run
    f = Kinematic2D(terminal_velocity=vt_t.beard77, engine="flat",
                    **_kw("mix"), **F64)
    assert type(f.prtcls).__name__ == "particles_t"
    f.run_device_lgrngn(NT, spinup=SPINUP)
    np.testing.assert_allclose(m.th.numpy(), f.th.numpy(), rtol=1e-12)
    np.testing.assert_allclose(m.rv.numpy(), f.rv.numpy(), rtol=1e-12)
    d, fd = m.dense_state, f.dense_state
    a, b = _pop(d.n, d), _pop(fd.n, fd)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])       # cell n rd3
    cols = {k: i + 2 for i, k in enumerate(PLANES)}
    for k in ("kpa", "x", "z") + SD_PLANES:
        np.testing.assert_allclose(a[:, cols[k]], b[:, cols[k]], rtol=1e-12,
                                   err_msg=k)
    for k in ("rw2", "vt"):
        got, want = a[:, cols[k]], b[:, cols[k]]
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert np.mean(rel <= 1e-10) >= 0.99, k
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
    # the droplets moved and grew
    assert not np.array_equal(_pop(init.n, init, ("rd3", "x"))[:, 3],
                              _pop(d.n, d, ("rd3", "x"))[:, 3])


@pytest.mark.parametrize("mode", list(MODES))
def test_front_is_bitwise_run_device_lgrngn(mode):
    """The public API's stepwise loop on the dense front and
    run_device_lgrngn(engine="dense") run the same phases on the same
    inputs."""
    kw = dict(terminal_velocity=vt_t.beard77, engine="dense", **_kw(mode),
              **F64)
    a, b = Kinematic2D(**kw), Kinematic2D(**kw)
    a.run(NT, spinup=SPINUP)
    b.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    assert a.prtcls._loc == "dense"
    assert torch.equal(a.th, b.th) and torch.equal(a.rv, b.rv)
    da, db = a.dense_state, b.dense_state
    planes = tdense.attrs_of(a.cfg)[1:]
    np.testing.assert_array_equal(_pop(da.n, da, planes),
                                  _pop(db.n, db, planes))
    # an unpack hands the flat State the private state per SD
    a.prtcls._ensure_flat()
    st = a.prtcls.state
    assert st.sstp_tmp_p.shape == st.n.shape
    live = st.n > 0
    flat = np.stack([st.ijk[live].numpy()] + [
        getattr(st, k)[live].numpy() for k in (
            "n", "rd3", "sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh",
            "sstp_tmp_p")], 1)
    flat = flat[np.lexsort(flat.T[::-1])]
    np.testing.assert_array_equal(flat, _pop(da.n, da, ("rd3",) + SD_PLANES))


def test_front_save_load_keeps_the_private_state(tmp_path):
    """save() unpacks the private planes into the flat State's per-SD
    snapshot, load() restores it, and the next step packs it again: a
    restored front steps on bitwise as the original."""
    kw = dict(terminal_velocity=vt_t.beard77, engine="dense", **_kw("mix"),
              **F64)
    a, b = Kinematic2D(**kw), Kinematic2D(**kw)
    a.run(2, spinup=1)
    a.prtcls.save(tmp_path / "exact.npz")
    b.prtcls.load(tmp_path / "exact.npz")
    b.th, b.rv = a.th.clone(), a.rv.clone()
    for k in ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh", "sstp_tmp_p"):
        got, want = getattr(b.prtcls.state, k), getattr(a.prtcls.state, k)
        assert got.shape == a.prtcls.state.n.shape and torch.equal(got, want)
    a.run(1)
    b.run(1)
    assert torch.equal(a.th, b.th) and torch.equal(a.rv, b.rv)
    da, db = a.dense_state, b.dense_state
    planes = tdense.attrs_of(a.cfg)[1:]
    np.testing.assert_array_equal(_pop(da.n, da, planes),
                                  _pop(db.n, db, planes))


# ------------------------------------------------ const_p through the front
NXF, NZF = 6, 5


def _front_setup(L):
    oi = L.opts_init_t()
    oi.dry_distros = {(0.61, 0.0): lambda lnr: 60e6 * np.exp(
        -((np.asarray(lnr) - np.log(0.02e-6)) ** 2) / 2 / np.log(1.4) ** 2)
        / np.log(1.4) / np.sqrt(2 * np.pi)}
    oi.coal_switch = False
    oi.terminal_velocity = L.vt_t.beard77
    oi.sedi_switch = True
    oi.th_dry, oi.const_p = False, True
    oi.exact_sstp_cond = True
    oi.dt = 1
    oi.nx, oi.nz = NXF, NZF
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = NXF * 100.0, NZF * 100.0
    oi.sd_conc = 12
    oi.n_sd_max = 12 * NXF * NZF
    oi.sstp_cond = 3
    opts = L.opts_t()
    opts.adve = opts.cond = opts.sedi = True
    opts.coal = False
    opts.chem_dsl = False
    return oi, opts


def _front_fields():
    k = np.arange(NZF)[None, :]
    p = np.broadcast_to(1e5 - 1000.0 * k, (NXF, NZF)).copy()
    th = 289.0 + 0.5 * k + 0.1 * np.arange(NXF)[:, None]
    return th, 9e-3 * np.ones((NXF, NZF)), np.ones((NXF, NZF)), p


def _front_drive(p, opts, steps=4):
    th, rv, rhod, pres = _front_fields()
    p.init(th, rv, rhod, pres, Cx=0.2 * np.ones((NXF + 1, NZF)),
           Cz=-0.1 * np.ones((NXF, NZF + 1)))
    for _ in range(steps):
        p.step_sync(opts, th, rv)
        p.step_async(opts)
    p.diag_all()
    p.diag_wet_mom(3)
    return th, rv, p.outbuf().copy()


def test_const_p_front_matches_jax_front_and_the_fused_step():
    oi, opts = _front_setup(tl)
    front = tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    assert isinstance(front, particles_dense_t)
    th, rv, m3 = _front_drive(front, opts)

    os.environ["LIBCLOUD_ENGINE"] = "dense"
    try:
        joi, jopts = _front_setup(jl)
        jth, jrv, jm3 = _front_drive(jl.factory(jl.backend_t.serial, joi),
                                     jopts)
    finally:
        os.environ.pop("LIBCLOUD_ENGINE", None)
    np.testing.assert_allclose(th, jth, rtol=1e-12)
    np.testing.assert_allclose(rv, jrv, rtol=1e-10)
    np.testing.assert_allclose(m3, jm3, rtol=1e-9)

    # the fused step (run_device_lgrngn's) from the same initial state
    ref = tl.factory(tl.backend_t.serial, oi, engine="dense", **F64)
    th0, rv0, rhod, pres = _front_fields()
    ref.init(th0, rv0, rhod, pres, Cx=0.2 * np.ones((NXF + 1, NZF)),
             Cz=-0.1 * np.ones((NXF, NZF + 1)))
    d = tdense.pack(ref.cfg, ref.state, front._cap)
    fth, frv = t(th0).reshape(-1), t(rv0).reshape(-1)
    for _ in range(4):
        d, fth, frv = tdense.step_fused(ref.cfg, d, fth, frv, (), 1.0, 44.0,
                                        1, False, True)
    assert torch.equal(fth, t(th).reshape(-1))
    assert torch.equal(frv, t(rv).reshape(-1))
    front._ensure_dense()
    planes = tdense.attrs_of(ref.cfg)[1:]
    np.testing.assert_array_equal(_pop(front._d.n, front._d, planes),
                                  _pop(d.n, d, planes))
    # movers took their old row's pressure along into the next substeps
    assert bool(((d.sd_p != d.p[:, None]) & (d.n > 0)).any())
