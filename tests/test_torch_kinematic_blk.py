"""Port parity: the kinematic model's bulk path and its node-centred grid
(libcloudphxx_tpu_torch/models/kinematic_2d.py) against the JAX package's
Kinematic2D at float64 on the CPU.

* make_gc_node against JAX's, and divergence-free; the model's courant and
  density fields on both grids.
* Kinematic2D(micro="blk_1m" | "blk_2m", grid="node", fct=True) on 16x16
  cells, both packages started from one state through convert (JAX's after
  ante_loop and three spin-up steps), then 30 steps across a spin-up
  boundary at 15 through run() and through run_device(): every field rel
  1e-9 (measured: at most 8.3e-11, rc of blk_2m, where the cloud's edge
  makes small values; th, rv 1e-14), puddle_flux rel 1e-9.  The port's
  run() and run_device() give the same fields bitwise (the same
  functions; only the flux sums add up differently, on the host and on the
  device, as in JAX).
* relax_th_rv with JAX's test_relax_th_rv setup (tests/test_host_model.py):
  the same fields (rel 1e-12) and the relaxation pulling th back.
* lgrngn on the node grid (the SD domain cropped to [dx/2, (nx-.5)dx)),
  8x8 cells, 10 spin-up steps of run_device_lgrngn: the flat engine
  against JAX's flat engine, th and rv rel 1e-10, the cloud water of
  diag_lgrngn rel 1e-10 and the SD count a cell exact (measured: th 0,
  rv 1e-16, rc 8e-14); the dense engine, which bins the cropped domain as
  JAX's does, against JAX's dense engine at test_torch_kinematic.py's
  tolerances for it (th 1e-9, rv 2e-8, moment 3 rel 1e-6, SDs a cell
  exact; measured 8e-12, 1.3e-10, 4.6e-7: JAX carries a droplet's vt from
  the previous step, the port rebuilds it).
"""

import jax
import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models.kinematic_2d import Setup as JaxSetup
from libcloudphxx_tpu.models.kinematic_2d import make_gc_node as jmake_gc_node
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.convert import (bulk_fields_from_numpy,
                                            bulk_fields_to_numpy)
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import vt_t
from libcloudphxx_tpu_torch.models.kinematic_2d import (BULK_FIELDS, Setup,
                                                        make_gc_node)

torch.set_num_threads(2)

F64 = dict(device="cpu", dtype=torch.float64)
BLK = dict(nx=16, nz=16, grid="node", fct=True)
NT, SPINUP = 30, 15


@pytest.mark.parametrize("nx,nz", [(16, 16), (10, 13)])
def test_make_gc_node_matches_jax_and_is_divergence_free(nx, nz):
    s, js = Setup(), JaxSetup()
    dx, dz = s.X / (nx - 1), s.Z / (nz - 1)
    gx, gz = make_gc_node(s, nx, nz, dx, dz)
    jgx, jgz = jmake_gc_node(js, nx, nz, dx, dz)
    np.testing.assert_array_equal(gx, jgx)
    np.testing.assert_array_equal(gz, jgz)
    assert gx.shape == (nx + 1, nz) and gz.shape == (nx, nz + 1)
    div = (gx[1:] - gx[:-1]) + (gz[:, 1:] - gz[:, :-1])
    assert np.abs(div).max() < 1e-12
    # periodic in x: the first and last x faces carry the same flux
    np.testing.assert_allclose(gx[0], gx[-1], atol=1e-15)


@pytest.mark.parametrize("grid", ["node", "cell"])
def test_grid_fields_match_jax(grid):
    p = Kinematic2D(nx=12, nz=10, micro="blk_1m", grid=grid, **F64)
    j = JaxKinematic2D(nx=12, nz=10, micro="blk_1m", grid=grid)
    assert (p.dx, p.dz) == (j.dx, j.dz)
    for k in ("gc_x", "gc_z", "G", "rhod", "C_x", "C_z", "th", "rv"):
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=1e-13,
                                   atol=1e-300, err_msg=k)


def _start(micro):
    """A JAX model after ante_loop and 3 spin-up steps, and a port model
    started from its state through convert."""
    j = JaxKinematic2D(micro=micro, **BLK)
    j.ante_loop()
    j.run(3, spinup=3)
    p = Kinematic2D(micro=micro, **BLK, **F64)
    arrays = {k: getattr(j, k) for k in BULK_FIELDS[micro]}
    for k, v in bulk_fields_from_numpy(dict(arrays, puddle_flux=j.puddle_flux),
                                       **F64).items():
        setattr(p, k, v)
    p.t = j.t
    return j, p


def _compare_fields(p, j, rtol=1e-9):
    for k in BULK_FIELDS[p.micro]:
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=rtol,
                                   atol=1e-300, err_msg=k)


@pytest.mark.parametrize("how", ["run", "run_device"])
@pytest.mark.parametrize("micro", ["blk_1m", "blk_2m"])
def test_bulk_model_matches_jax(micro, how):
    j, p = _start(micro)
    getattr(j, how)(NT, spinup=SPINUP)
    getattr(p, how)(NT, spinup=SPINUP)
    _compare_fields(p, j)
    assert p.puddle_flux == pytest.approx(j.puddle_flux, rel=1e-9)
    assert p.t == j.t
    # clouds formed and rain started after the spin-up
    assert float(p.rc.max()) > 1e-4 and float(p.rr.max()) > 0


def test_ante_loop_matches_jax():
    j = JaxKinematic2D(micro="blk_1m", **BLK)
    p = Kinematic2D(micro="blk_1m", **BLK, **F64)
    j.ante_loop()
    p.ante_loop()
    _compare_fields(p, j, rtol=1e-12)
    assert float(p.rc.max()) > 0            # cloud water aloft at t = 0
    q = Kinematic2D(micro="blk_2m", **BLK, **F64)
    before = bulk_fields_to_numpy(q)
    q.ante_loop()                           # blk_2m: nothing
    for k, v in bulk_fields_to_numpy(q).items():
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("micro", ["blk_1m", "blk_2m"])
def test_run_and_run_device_agree_bitwise(micro):
    a = Kinematic2D(micro=micro, **BLK, **F64)
    b = Kinematic2D(micro=micro, **BLK, **F64)
    a.ante_loop()
    b.ante_loop()
    a.run(20, spinup=10)
    b.run_device(20, spinup=10)
    for k in BULK_FIELDS[micro]:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert b.puddle_flux == pytest.approx(a.puddle_flux, rel=1e-12)
    assert a.t == b.t == 20.0


def test_relax_th_rv_matches_jax():
    """JAX's test_relax_th_rv (tests/test_host_model.py) on both
    packages."""
    kw = dict(nx=10, nz=10, micro="blk_1m", grid="node", fct=True,
              relax_th_rv=True)
    j, p = JaxKinematic2D(**kw), Kinematic2D(**kw, **F64)
    j.run(4, spinup=2)
    p.run(4, spinup=2)
    _compare_fields(p, j, rtol=1e-12)
    assert p._th_eq.shape == (10,)
    np.testing.assert_allclose(p._th_eq.numpy(), j._th_eq, rtol=1e-12)
    np.testing.assert_allclose(p._rv_eq.numpy(), j._rv_eq, rtol=1e-12)
    # perturb th strongly; the relaxation pulls it back toward th_eq
    j.th = np.broadcast_to(j._th_eq[None, :] + 5.0, j.th.shape).copy()
    p.th = p._th_eq[None, :].expand(10, 10) + 5.0
    before = float((p.th - p._th_eq[None, :]).abs().mean())
    j.step(spinup=False)
    p.step(spinup=False)
    _compare_fields(p, j, rtol=1e-12)
    assert float((p.th - p._th_eq[None, :]).abs().mean()) < before
    with pytest.raises(NotImplementedError, match="relax_th_rv"):
        p.run_device(1)


def test_bulk_fields_convert_both_ways():
    j, p = _start("blk_2m")
    back = bulk_fields_to_numpy(p)
    assert set(back) == set(BULK_FIELDS["blk_2m"]) | {"puddle_flux"}
    for k in BULK_FIELDS["blk_2m"]:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(j, k)))
    assert back["puddle_flux"] == j.puddle_flux
    assert set(bulk_fields_from_numpy({"th": back["th"]}, **F64)) == {"th"}


LG = dict(nx=8, nz=8, sd_conc=16, sstp_cond=2, grid="node", fct=True)


@pytest.fixture(scope="module")
def lgrngn_pair():
    """The JAX and port lgrngn models on the node grid, each engine."""
    def make():
        return (JaxKinematic2D(micro="lgrngn",
                               terminal_velocity=jl.vt_t.beard77, **LG),
                Kinematic2D(micro="lgrngn", terminal_velocity=vt_t.beard77,
                            **LG, **F64))
    return make


def test_lgrngn_node_flat_engine_matches_jax(lgrngn_pair):
    j, p = lgrngn_pair()
    oi = p.opts_init
    assert (oi.x0, oi.z0) == (p.dx / 2, p.dz / 2)
    assert (oi.x1, oi.z1) == (7.5 * p.dx, 7.5 * p.dz)
    assert type(p.prtcls).__name__ == "particles_t"
    j.run_device_lgrngn(10, spinup=10)
    p.run_device_lgrngn(10, spinup=10)
    np.testing.assert_allclose(p.th.numpy(), np.asarray(j.th), rtol=1e-10)
    np.testing.assert_allclose(p.rv.numpy(), np.asarray(j.rv), rtol=1e-10)
    np.testing.assert_allclose(p.diag_lgrngn("rc"), j.diag_lgrngn("rc"),
                               rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(p.diag_lgrngn("rr"), j.diag_lgrngn("rr"),
                               rtol=1e-10, atol=1e-300)
    sd = p.diag_lgrngn("sd_conc")
    np.testing.assert_array_equal(sd, j.diag_lgrngn("sd_conc"))
    assert sd.sum() == 16 * 64 and float(p.diag_lgrngn("rc").max()) > 0
    # the SDs stay in the cropped domain
    st = p.prtcls.state
    live = st.n > 0
    assert bool(((st.x[live] >= oi.x0) & (st.x[live] < oi.x1)).all())
    assert bool(((st.z[live] >= oi.z0) & (st.z[live] < oi.z1)).all())


def test_lgrngn_node_dense_engine_matches_jax(lgrngn_pair):
    j, p = lgrngn_pair()
    tdense.supported(p.cfg)            # the dense engine takes the crop
    j.run_device_lgrngn(10, spinup=10, engine="dense")
    p.run_device_lgrngn(10, spinup=10, engine="dense")
    np.testing.assert_allclose(p.th.numpy(), np.asarray(j.th), rtol=1e-9)
    np.testing.assert_allclose(p.rv.numpy(), np.asarray(j.rv), rtol=2e-8)
    cfg = j.prtcls.cfg
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, j.prtcls.state, 32)
    s = p.dense_state
    np.testing.assert_array_equal((s.n > 0).sum(1).numpy(),
                                  np.asarray((d.n > 0).sum(1)))
    np.testing.assert_allclose(tdense.moment(s, 0.0, 1.0, 3).numpy(),
                               np.asarray(jdense.moment(d, 0.0, 1.0, 3)),
                               rtol=1e-6)
    np.testing.assert_array_equal(p.diag_lgrngn("sd_conc"),
                                  j.diag_lgrngn("sd_conc"))


def test_refusals():
    with pytest.raises(NotImplementedError,
                       match="lgrngn_chem runs in the stepwise loop"):
        Kinematic2D(nx=4, nz=4, sd_conc=2, micro="lgrngn_chem",
                    **F64).run_device_lgrngn(1)
    with pytest.raises(ValueError, match="unknown micro"):
        Kinematic2D(nx=4, nz=4, micro="blk_3m", **F64)
    with pytest.raises(ValueError, match="unknown grid"):
        Kinematic2D(nx=4, nz=4, micro="blk_1m", grid="staggered", **F64)
    m = Kinematic2D(nx=4, nz=4, micro="blk_2m", **F64)
    with pytest.raises(ValueError, match="run_device"):
        m.run_device_lgrngn(1)
    m = Kinematic2D(nx=4, nz=4, sd_conc=2, **F64)
    with pytest.raises(ValueError, match="run_device_lgrngn"):
        m.run_device(1)
    # the default device is the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Kinematic2D(nx=4, nz=4, micro="blk_1m")
