"""Port parity: the whole slice, Kinematic2D.run_device_lgrngn on the dense
engine, against the JAX package at float64 on the CPU.

8x8 cells, sd_conc 24, sstp_cond 3, 4 steps of which 2 spin-up, then
sedimentation on and coal_switch=False; terminal_velocity=beard77 (the
port's kernels compute it by the direct polynomial, as the JAX XLA path
does for beard77).  The port packs at row capacity 64 (a power of two),
JAX on the CPU at 48; per-cell multisets do not depend on capacity.

Two references:

* JAX's own run_device_lgrngn.  Its XLA path carries each droplet's vt
  from the previous step (zero at init), while the port, like the TPU
  kernel it follows (pallas_step.py:203-210), rebuilds it from the
  droplet's current cell.  After a droplet changes cells the two
  ventilation factors differ slightly, and the growth rate's 1/(S-1)
  sensitivity near saturation carries that into th/rv at ~1e-9 and into
  the third moment at ~1e-7 within these 4 steps: th rtol 1e-9, rv 2e-8,
  moment 3 rtol 1e-6.
* The same JAX XLA functions stepped with the kernel's vt convention (vt
  rebuilt from the saved cell state before each condensation): th/rv rtol
  1e-10, moments 0 and 3 rtol 1e-9, puddle rtol 1e-9.

Per-cell SD counts are exact against both.  Under beard76 and
Khvorostyanov's two formulas the same run is held against the second
reference at its tolerances.

With coalescence (sstp_coal 3, stride and sort pairing) the reference is
the second one with the coalescence phase inserted between condensation and
transport, built from the JAX pair functions and fed the port's shuffles
and Bernoulli draws in the port's lane order (torch_parity.jax_coal_loop):
the same tolerances, and collisions must happen.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_coal_loop, multiset, port_cfg, port_state

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.common import theta_dry as jtheta_dry
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models import mpdata as jmpdata
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.convert import (dense_state_to_numpy,
                                            static_config_from_numpy)
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import kernel_t, vt_t
from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM
from libcloudphxx_tpu_torch.models.kinematic_2d import dense_capacity

KW = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
          opts_init_kw={"coal_switch": False})
NT, SPINUP = 4, 2


@pytest.fixture(scope="module")
def port():
    m = Kinematic2D(terminal_velocity=vt_t.beard77, device="cpu",
                    dtype=torch.float64, **KW)
    init = m.dense_state
    water0 = tdense.water_dry_totals(m.dense_state, m.rv)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    return m, init, water0


@pytest.fixture(scope="module")
def jax_model():
    return JaxKinematic2D(micro="lgrngn", terminal_velocity=lgrngn.vt_t.beard77,
                          **KW)


@pytest.fixture(scope="module")
def jax_init(jax_model):
    cfg = jax_model.prtcls.cfg
    return jax.jit(jdense.pack, static_argnums=(0, 2))(
        cfg, jax_model.prtcls.state, 48)


@pytest.fixture(scope="module")
def jax_run(jax_model, jax_init):
    """JAX's run_device_lgrngn; returns the final state packed at cap 48."""
    jax_model.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(
        jax_model.prtcls.cfg, jax_model.prtcls.state, 48)
    return d, np.asarray(jax_model.th), np.asarray(jax_model.rv)


def _xla_loop(jax_model, d, coal_phase=None):
    """The JAX XLA dense step (the dense path of _lgrngn_step_fn_dense) with
    vt rebuilt from the saved cell state before each condensation, from the
    model's initial fields and the packed population ``d``.  With
    ``coal_phase(i, d) -> d`` the coalescence phase of main step i runs
    between condensation and transport, as in the resident kernel."""
    m, cfg = jax_model, jax_model.prtcls.cfg
    c = lambda a: a[:, None]

    @jax.jit
    def cond(d, th, rv, RH_max):
        tha, rva = jmpdata.advect2(th, rv, m.gc_x, m.gc_z, m.G, n_iters=2,
                                   fct=False)
        T0, p0, _, eta0 = jdense._Tpr(cfg, d.sstp_tmp_th, d.sstp_tmp_rv,
                                      d.rhod, d.p)
        d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(T0), c(p0),
                                                   c(d.rhod), c(eta0)))
        return jdense.step_cond(cfg, d, tha.reshape(-1), rva.reshape(-1), 1.0,
                                RH_max)

    # the model's initial fields (jax_run may have advanced the model)
    th = jnp.full((8, 8), float(jtheta_dry.std2dry(m.setup.th_0,
                                                    m.setup.rv_0)))
    rv = jnp.full((8, 8), m.setup.rv_0)
    params = jnp.zeros((0,))
    for i in range(NT):
        sp = i < SPINUP
        d, th, rv = cond(d, th.reshape(8, 8), rv.reshape(8, 8),
                         1.01 if sp else 44.0)
        if coal_phase is not None and not sp:
            d = coal_phase(i, d)
        d = jdense.step_async(cfg, d, params, 1.0, 1, False, not sp)
    return d, np.asarray(th).reshape(8, 8), np.asarray(rv).reshape(8, 8)


@pytest.fixture(scope="module")
def jax_loop(jax_model, jax_init):
    return _xla_loop(jax_model, jax_init)


def _moments(d):
    return [np.asarray(jdense.moment(d, 0.0, 1.0, k)) for k in (0, 3)]


def test_initial_population_matches_jax(port, jax_init):
    _, init, _ = port
    d = jax_init
    a = multiset(init.n, (init.rd3, init.kpa, init.x, init.z, init.rw2))
    b = multiset(d.n, (d.rd3, d.kpa, d.x, d.z, d.rw2))
    assert a.shape == b.shape == (24 * 64, 7)
    np.testing.assert_array_equal(a[:, :6], b[:, :6])  # cell n rd3 kpa x z
    np.testing.assert_allclose(a[:, 6], b[:, 6], rtol=1e-12)  # rw2
    assert init.cap == 64 and int(init.overflow) == 0


def _compare(port_model, d, th, rv, rtol_th, rtol_rv, rtol_m3):
    s = port_model.dense_state
    np.testing.assert_allclose(port_model.th.numpy(), th, rtol=rtol_th)
    np.testing.assert_allclose(port_model.rv.numpy(), rv, rtol=rtol_rv)
    np.testing.assert_array_equal((s.n > 0).sum(1).numpy(),
                                  np.asarray((d.n > 0).sum(1)))
    m0, m3 = _moments(d)
    np.testing.assert_allclose(tdense.moment(s, 0.0, 1.0, 0).numpy(), m0,
                               rtol=1e-9)
    np.testing.assert_allclose(tdense.moment(s, 0.0, 1.0, 3).numpy(), m3,
                               rtol=rtol_m3)
    np.testing.assert_allclose(s.puddle.numpy(), np.asarray(d.puddle),
                               rtol=1e-9)


def test_slice_matches_jax_run_device_lgrngn(port, jax_run):
    m, _, _ = port
    _compare(m, *jax_run, rtol_th=1e-9, rtol_rv=2e-8, rtol_m3=1e-6)


def test_slice_matches_jax_with_kernel_vt(port, jax_loop):
    m, _, _ = port
    _compare(m, *jax_loop, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)


def _bench_checks(m, water0, dry0):
    """bench.py:45-96 on the port's final state."""
    d, th, rv = m.dense_state, m.th, m.rv
    alive = d.n > 0
    assert torch.isfinite(th).all() and torch.isfinite(rv).all()
    assert ((th > 250) & (th < 350)).all() and ((rv > 0) & (rv < 0.03)).all()
    rw2, rd3 = d.rw2[alive], d.rd3[alive]
    assert torch.isfinite(rw2).all() and (rw2 > 0).all()
    assert float(rw2.max()) < (5e-3) ** 2 and (rd3 > 0).all()
    water, dry = tdense.water_dry_totals(d, rv)
    assert abs(water - water0) / water0 < 1e-3
    assert abs(dry - dry0) / dry0 < 1e-4
    assert int(d.overflow) == 0


def test_slice_passes_bench_physics_checks(port):
    m, _, (water0, dry0) = port
    _bench_checks(m, water0, dry0)


# ---- the slice under the formulas the main path does not use: the same
# run, against the XLA loop with the kernel's vt convention, tolerances as
# test_slice_matches_jax_with_kernel_vt
@pytest.fixture(scope="module", params=[
    vt_t.beard76, vt_t.khvorostyanov_spherical,
    vt_t.khvorostyanov_nonspherical], ids=lambda f: f.name)
def formula_runs(request):
    formula = request.param
    m = Kinematic2D(terminal_velocity=formula, device="cpu",
                    dtype=torch.float64, **KW)
    assert m.cfg.terminal_velocity == formula.value
    water0 = tdense.water_dry_totals(m.dense_state, m.rv)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    jm = JaxKinematic2D(micro="lgrngn",
                        terminal_velocity=lgrngn.vt_t[formula.name], **KW)
    d0 = jax.jit(jdense.pack, static_argnums=(0, 2))(jm.prtcls.cfg,
                                                      jm.prtcls.state, 48)
    return m, water0, _xla_loop(jm, d0)


def test_slice_under_formula_matches_jax_with_kernel_vt(formula_runs):
    m, (water0, dry0), ref = formula_runs
    _compare(m, *ref, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)
    _bench_checks(m, water0, dry0)
    d = m.dense_state
    assert float(d.vt[d.n > 0].min()) > 0


# ---- the slice with coalescence: sstp_coal 3 and the geometric kernel
# times 100 (opts_init.kernel_parameters), so that droplets collide within
# the two main steps
KW_COAL = dict(KW, sstp_coal=3, opts_init_kw={"kernel_parameters": [100.0]})
PLANES = ("n", "rw2", "rd3", "kpa", "x", "z")


@pytest.fixture(scope="module", params=["stride", "sort"])
def coal_port(request):
    """The port with coalescence after spin-up, run step by step; returns
    the model, its state before each step and the initial totals."""
    m = Kinematic2D(terminal_velocity=vt_t.beard77, device="cpu",
                    dtype=torch.float64, coal_pairing=request.param,
                    **KW_COAL)
    totals = tdense.water_dry_totals(m.dense_state, m.rv)
    before = []
    for i in range(NT):
        before.append(m.dense_state)
        m.run_device_lgrngn(1, spinup=int(i < SPINUP), engine="dense")
    return m, before, totals


def _port_order(d, s):
    """Gather index that puts the SDs of every row of the JAX state ``d``
    in the lane order of the port state ``s`` (an SD is known by its rd3,
    which no two SDs of a row share)."""
    n_j, rd3_j = np.asarray(d.n), np.asarray(d.rd3)
    n_p, rd3_p = s.n.numpy(), s.rd3.numpy()
    perm = np.empty(n_j.shape, dtype=np.int64)
    for r in range(n_j.shape[0]):
        live_j = np.flatnonzero(n_j[r] > 0)
        lane = dict(zip(rd3_j[r, live_j], live_j))
        live_p = n_p[r] > 0
        perm[r, live_p] = [lane[v] for v in rd3_p[r, live_p]]
        perm[r, ~live_p] = np.flatnonzero(n_j[r] <= 0)
    return perm


@pytest.fixture(scope="module")
def coal_ref(coal_port):
    """The XLA loop with the coalescence phase built from the JAX pair
    functions on the port's draws and lane order (torch_parity.
    jax_coal_loop), at the port's row capacity."""
    m_port, before, _ = coal_port
    jm = JaxKinematic2D(micro="lgrngn", terminal_velocity=lgrngn.vt_t.beard77,
                        **KW_COAL)
    cfg, oi = jm.prtcls.cfg, jm.prtcls.opts_init
    d0 = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, jm.prtcls.state,
                                                      before[0].cap)

    def coal_phase(i, d):
        perm = _port_order(d, before[i])
        planes = tuple(np.take_along_axis(np.asarray(getattr(d, a)), perm, 1)
                       for a in PLANES)
        cells = tuple(np.asarray(getattr(d, a))
                      for a in ("T", "p", "rhod", "eta", "dv"))
        out = jax_coal_loop(cfg, oi.kernel_parameters, oi.sstp_coal, 1.0,
                            oi.rng_seed, i - SPINUP, planes, cells,
                            m_port.coal_pairing)
        return dataclasses.replace(
            d, **{a: jnp.asarray(v) for a, v in zip(PLANES, out)})

    return _xla_loop(jm, d0, coal_phase)


def test_coal_slice_matches_jax_on_port_draws(coal_port, coal_ref):
    m, _, _ = coal_port
    _compare(m, *coal_ref, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)


def test_coal_slice_collides_and_passes_bench_physics_checks(coal_port):
    m, before, (water0, dry0) = coal_port
    # multiplicity lost in the main steps, less what fell into the puddle
    lost = float(before[SPINUP].n.sum() - m.dense_state.n.sum()
                 - m.dense_state.puddle[OUT_PRTCL_NUM])
    assert lost > 0.0
    assert m.dense_state.rng_step == NT - SPINUP
    _bench_checks(m, water0, dry0)


def test_import_leaves_jax_out():
    """Importing the port loads neither jax nor the JAX package."""
    code = ("import sys; before = set(sys.modules); "
            "import libcloudphxx_tpu_torch, libcloudphxx_tpu_torch.convert; "
            "new = set(sys.modules) - before; "
            "bad = [m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libcloudphxx_tpu')]; "
            "assert 'jax' not in sys.modules and not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_convert_roundtrip(jax_init, jax_model):
    cfg = jax_model.prtcls.cfg
    assert dataclasses.asdict(port_cfg(cfg)) == dataclasses.asdict(cfg)
    back = dense_state_to_numpy(port_state(jax_init))
    # the JAX key does not carry over: the port's draws start at step 0
    assert (int(back.pop("rng_seed")), int(back.pop("rng_step"))) == (44, 0)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jax_init, k)),
                                      err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        static_config_from_numpy({"nx": 8})


@pytest.mark.parametrize("what", ["coalescence", "engine", "multi_device",
                                  "micro", "grid"])
def test_unported_paths_raise(what, port):
    m, _, _ = port
    if what == "coalescence":
        # coalescence runs (test_coal_slice_*), with the turbulent kernels
        # too (tests/test_torch_dense_onishi.py), on the x-slab mesh as well
        # (tests/test_torch_dense_mesh_options.py); what the mesh refuses
        # is the 3-D grid, which the JAX package's mesh does not run either
        from libcloudphxx_tpu_torch.parallel import (MeshRunner,
                                                     dense_step_sharded)
        m2 = Kinematic2D(nx=8, nz=4, sd_conc=2, device="cpu",
                         dtype=torch.float64,
                         opts_init_kw={"kernel": kernel_t.onishi_hall,
                                       "kernel_parameters": [100.0]})
        MeshRunner(m2, 2).run(1)
        cfg3 = dataclasses.replace(m2.cfg, n_dims=3)
        with pytest.raises(NotImplementedError, match="3-D grid"):
            dense_step_sharded(cfg3, [], 1, 1, True, True, 44.0)
        return
    if what == "grid":
        # the cell and node grids run (test_torch_kinematic_blk.py); an
        # unknown grid is refused
        with pytest.raises(ValueError, match="unknown grid"):
            Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu",
                        grid="staggered")
        return
    with pytest.raises(NotImplementedError):
        if what == "engine":
            # the dense engine runs every advection scheme, const-multi,
            # vohl (test_torch_dense_options.py) and the turbulent kernels
            # (test_torch_dense_onishi.py), but not diag_incloud_time,
            # which the factory then refuses
            Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu", engine="dense",
                        opts_init_kw={"diag_incloud_time": True})
        elif what == "multi_device":
            # the multi-device front steps through run()
            # (tests/test_torch_multi.py), not through run_device_lgrngn,
            # which JAX's cannot step it with either (ROADMAP.md, "Known
            # behaviours of the reference"); the repack policy runs
            # (test_torch_repack.py)
            Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu",
                        opts_init_kw={"dev_count": 2}).run_device_lgrngn(1)
        else:
            # the bulk schemes run (test_torch_kinematic_blk.py), and
            # lgrngn_chem in the stepwise loop (test_torch_chem.py), not
            # through run_device_lgrngn
            Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu",
                        micro="lgrngn_chem").run_device_lgrngn(1)


@pytest.mark.parametrize("max_count,cap", [(24, 64), (64, 128), (3, 8)])
def test_dense_capacity_is_a_power_of_two(max_count, cap):
    assert dense_capacity(max_count) == cap
