"""Port parity at float32 under the terminal velocity formulas that the
main path does not use (beard76, khvorostyanov_spherical and
khvorostyanov_nonspherical): one fused microphysics step of the port (its
plain versions on the CPU) against the JAX package's resident Pallas step
kernel, dense.step_fused run in TPU interpret mode, on the 8x8 case's
cloud with 1 mm drops in place of the lowest row's droplets, in its lowest
20 m, some of which sediment into the puddle.  The formula enters the step
in the rebuilt stale vt of condensation and in the transport's vt refresh
and sedimentation (pallas_step.py:210, :342); the step runs without
coalescence, whose random draws the two packages do not share
(tests/test_torch_coal.py holds the coalescence substeps under each
formula with the draws injected).

Under Khvorostyanov the JAX kernel's float32 formula is NaN for the haze
droplets under ~2.5 nm that the population holds, and so are rw2, th and
rv of their cells and the puddle's liquid volume; the port evaluates the
formula in float64 and stays finite.  The test asserts exactly that and
compares the other cells.

Kept in a file of its own: interpret-mode kernels in one process with the
rest of the suite have crashed it before (ROADMAP.md, Queue 3).

Tolerances: those of tests/test_torch_step_interpret.py (th rtol 2e-6,
rv 2e-5, rw2 5e-5; cells, multiplicities and dry radii exact, per cell
as multisets; x 1e-6; the puddle 1e-5).  z moves by dt * vt, and vt of a
1 mm drop differs by up to 1.8e-5 between the libraries' float32
(beard76's powf(eta, 4) and powf(N_p, 1/6); tests/test_torch_common.py
VT_F32_RTOL), so z, up to 20 m, takes an absolute tolerance of
dt * vt * 5e-5, and vt itself rtol 5e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import multiset, port_cfg, port_state, t

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.state import OUT_LIQ_VOL, OUT_PRTCL_NUM

FORMULAS = [lgrngn.vt_t.beard76, lgrngn.vt_t.khvorostyanov_spherical,
            lgrngn.vt_t.khvorostyanov_nonspherical]


def _setup(formula):
    m = Kinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                    sstp_coal=2, n_sd_max=24 * 8 * 8,
                    terminal_velocity=formula)
    cfg = m.prtcls.cfg
    assert cfg.terminal_velocity == formula.value
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, 32)
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d = jax.tree.map(f32, d)
    # the lowest row's droplets become rain in its lowest 20 m, so that
    # none leaves its column's bottom cell but through the floor
    rain = (d.n > 0) & (d.z < cfg.z0 + cfg.dz)
    d = dataclasses.replace(
        d, n=jnp.where(rain, 2.0, d.n),
        rw2=jnp.where(rain, (1e-3) ** 2, d.rw2),
        z=jnp.where(rain, cfg.z0 + 20.0 * ((d.z - cfg.z0) / cfg.dz), d.z))
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    th = jnp.asarray(m.th, jnp.float32).reshape(-1)
    rv = jnp.asarray(m.rv, jnp.float32).reshape(-1)
    return m, cfg, d, th, rv


@pytest.mark.parametrize("formula", FORMULAS, ids=lambda f: f.name)
def test_step_fused_matches_pallas_kernel_under_formula(formula):
    m, cfg, d, th, rv = _setup(formula)
    dt = float(m.setup.dt)
    with pltpu.force_tpu_interpret_mode():
        d_k, th_k, rv_k = jdense.step_fused(
            cfg, d, th, rv, jnp.zeros((0,), jnp.float32), dt, 44.0, 2, False,
            True)
    f32 = torch.float32
    d_t, th_t, rv_t = tdense.step_fused(port_cfg(cfg), port_state(d, f32),
                                        t(th, f32), t(rv, f32), (), dt,
                                        44.0, 2, False, True)
    # The JAX kernel evaluates Khvorostyanov in float32, NaN for the haze
    # droplets under ~2.5 nm that the population holds: NaN rw2, th and
    # rv in exactly their cells (tests/test_torch_common.py
    # test_khvorostyanov_float32_evaluation_loses_small_radii).  The port
    # evaluates it in float64 and stays finite; the other cells compare.
    n0 = np.asarray(d.n)
    nan_sd = (n0 > 0) & np.isnan(np.asarray(d.vt))
    bad = nan_sd.any(1)
    assert bad.any() == ("khvorostyanov" in formula.name)
    np.testing.assert_array_equal(np.isnan(np.asarray(th_k)), bad)
    assert bool(torch.isfinite(th_t).all() and torch.isfinite(rv_t).all())
    ok = ~bad
    np.testing.assert_allclose(th_t.numpy()[ok], np.asarray(th_k)[ok],
                               rtol=2e-6)
    np.testing.assert_allclose(rv_t.numpy()[ok], np.asarray(rv_k)[ok],
                               rtol=2e-5)
    keep = lambda ms: ms[ok[ms[:, 0].astype(int)]]
    a = keep(multiset(d_t.n, (d_t.rd3, d_t.rw2, d_t.x, d_t.z, d_t.vt)))
    b = keep(multiset(d_k.n, (d_k.rd3, d_k.rw2, d_k.x, d_k.z, d_k.vt)))
    assert a.shape == b.shape
    n_rain = int((n0 == 2.0).sum())
    assert 0 < int((np.asarray(d_k.n) == 2.0).sum()) < n_rain  # some fell
    np.testing.assert_array_equal(a[:, :3], b[:, :3])   # cell, n, rd3
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=5e-5)   # rw2
    np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=1e-6)   # x
    vt_max = float(np.nanmax(np.asarray(d.vt)))
    assert 3.0 < vt_max < 10.0                          # 1 mm drops
    np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0.0,
                               atol=dt * vt_max * 5e-5)   # z
    # vt of the step's end, refreshed by transport: the drops over 10 um
    # at the formulas' float32 tolerance there (tests/test_torch_common.py
    # VT_F32_RTOL); under Khvorostyanov the smaller droplets' float32 vt
    # of the JAX kernel is off by up to 70% (see above), beard76's by 2e-6
    big = a[:, 3] > (10e-6) ** 2
    assert big.sum() > 0
    sel = slice(None) if formula == lgrngn.vt_t.beard76 else big
    np.testing.assert_allclose(a[sel, 6], b[sel, 6], rtol=5e-5)
    # the puddle: the JAX kernel's liquid volume takes the NaN rw2 of the
    # cells above in its masked sum
    pud_k = np.asarray(d_k.puddle)
    fin = np.isfinite(pud_k)
    assert set(np.flatnonzero(~fin)) <= {OUT_LIQ_VOL}
    assert bool(torch.isfinite(d_t.puddle).all())
    np.testing.assert_allclose(d_t.puddle.numpy()[fin], pud_k[fin],
                               rtol=1e-5)
    assert float(d_t.puddle[OUT_PRTCL_NUM]) > 0
    assert int(d_t.overflow) == int(d_k.overflow) == 0
