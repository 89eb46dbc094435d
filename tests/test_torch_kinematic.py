"""Port parity: the whole slice, Kinematic2D.run_device_lgrngn on the dense
engine without coalescence, against the JAX package at float64 on the CPU.

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

Per-cell SD counts are exact against both.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import multiset, port_cfg, port_state

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
from libcloudphxx_tpu_torch.lgrngn import vt_t
from libcloudphxx_tpu_torch.models.kinematic_2d import dense_capacity

KW = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
          opts_init_kw={"coal_switch": False})
NT, SPINUP = 4, 2


@pytest.fixture(scope="module")
def port():
    m = Kinematic2D(terminal_velocity=vt_t.beard77, device="cpu",
                    dtype=torch.float64, **KW)
    init = m.state
    water0 = tdense.water_dry_totals(m.state, m.rv)
    m.run_device_lgrngn(NT, spinup=SPINUP)
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


@pytest.fixture(scope="module")
def jax_loop(jax_model, jax_init):
    """The JAX XLA dense step (the dense path of _lgrngn_step_fn_dense) with
    vt rebuilt from the saved cell state before each condensation."""
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

    d = jax_init
    # the model's initial fields (jax_run may have advanced the model)
    th = jnp.full((8, 8), float(jtheta_dry.std2dry(m.setup.th_0,
                                                    m.setup.rv_0)))
    rv = jnp.full((8, 8), m.setup.rv_0)
    params = jnp.zeros((0,))
    for i in range(NT):
        sp = i < SPINUP
        d, th, rv = cond(d, th.reshape(8, 8), rv.reshape(8, 8),
                         1.01 if sp else 44.0)
        d = jdense.step_async(cfg, d, params, 1.0, 1, False, not sp)
    return d, np.asarray(th).reshape(8, 8), np.asarray(rv).reshape(8, 8)


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
    s = port_model.state
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


def test_slice_passes_bench_physics_checks(port):
    """bench.py:45-96 on the port's final state."""
    m, _, (water0, dry0) = port
    d, th, rv = m.state, m.th, m.rv
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
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jax_init, k)),
                                      err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        static_config_from_numpy({"nx": 8})


@pytest.mark.parametrize("what", ["coalescence", "engine", "repack",
                                  "micro", "grid"])
def test_unported_paths_raise(what, port):
    m, _, _ = port
    if what == "coalescence":
        m2 = Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu",
                         dtype=torch.float64)
        with pytest.raises(NotImplementedError, match="coalescence"):
            m2.run_device_lgrngn(2, spinup=1)
        return
    with pytest.raises(NotImplementedError):
        if what == "engine":
            m.run_device_lgrngn(1, engine="flat")
        elif what == "repack":
            m.run_device_lgrngn(1, repack_every=10)
        else:
            Kinematic2D(nx=4, nz=4, sd_conc=2, device="cpu",
                        **{what: "blk_1m" if what == "micro" else "node"})


@pytest.mark.parametrize("max_count,cap", [(24, 64), (64, 128), (3, 8)])
def test_dense_capacity_is_a_power_of_two(max_count, cap):
    assert dense_capacity(max_count) == cap
