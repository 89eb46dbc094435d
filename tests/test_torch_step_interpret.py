"""Port parity at float32: one fused microphysics step of the port (its
plain versions on the CPU) against the JAX package's resident Pallas step
kernel itself, dense.step_fused run in TPU interpret mode, as the JAX
package's own tests run it (tests/test_pallas_step.py).

Kept in a file of its own: interpret-mode kernels in one process with the
rest of the suite have crashed it before (ROADMAP.md, Queue 3).

Tolerances: th rtol 2e-6 and rv 2e-5 (the latent-heat row sums: the
JAX kernel sums in float32, the port in float64); rw2 rtol 5e-5: the two
libraries' float32 exp/log (XLA's CPU approximations, PyTorch's) differ in
the last ulps, which the 12-iteration float32 root find and the growth
rate's 1/(S-1) sensitivity near saturation carry to ~3e-5 on some
droplets; the same root find summed in another order agrees bitwise on the
card (chip_smoke.py, kernel B).  x/z rtol 1e-6; cells and multiplicities
exact, per cell as multisets.
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


def _setup(rain):
    m = Kinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                    sstp_coal=2, n_sd_max=24 * 8 * 8,
                    terminal_velocity=lgrngn.vt_t.beard77)
    cfg = m.prtcls.cfg
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, 32)
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d = jax.tree.map(f32, d)
    if rain:
        d = dataclasses.replace(
            d, n=jnp.where(d.n > 0, 2.0, 0.0),
            rw2=jnp.where(d.n > 0, (1e-3) ** 2, 0.0),
            z=jnp.where(d.n > 0, cfg.z0 + 5.0 * (d.z / cfg.z1), d.z))
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    th = jnp.asarray(m.th, jnp.float32).reshape(-1)
    rv = jnp.asarray(m.rv, jnp.float32).reshape(-1)
    return m, cfg, d, th, rv


@pytest.mark.parametrize("rain", [False, True])
def test_step_fused_matches_pallas_kernel(rain):
    m, cfg, d, th, rv = _setup(rain)
    dt = float(m.setup.dt)
    with pltpu.force_tpu_interpret_mode():
        d_k, th_k, rv_k = jdense.step_fused(
            cfg, d, th, rv, jnp.zeros((0,), jnp.float32), dt, 44.0, 2, False,
            True)
    f32 = torch.float32
    d_t, th_t, rv_t = tdense.step_fused(port_cfg(cfg), port_state(d, f32),
                                        t(th, f32), t(rv, f32), dt, 44.0,
                                        False, True)
    assert th_t.dtype == f32
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_k), rtol=2e-6)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(rv_k), rtol=2e-5)
    a = multiset(d_t.n, (d_t.rd3, d_t.rw2, d_t.x, d_t.z))
    b = multiset(d_k.n, (d_k.rd3, d_k.rw2, d_k.x, d_k.z))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])   # cell, n, rd3
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=5e-5)   # rw2
    np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=1e-6)   # x, z
    np.testing.assert_allclose(d_t.puddle.numpy(), np.asarray(d_k.puddle),
                               rtol=1e-5)
    assert int(d_t.overflow) == int(d_k.overflow) == 0
