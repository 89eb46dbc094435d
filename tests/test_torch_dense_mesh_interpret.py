"""Port parity at float32: kernel C's unwrapped form, the transport phase
of a shard of the dense x-slab mesh, against the JAX package's resident
Pallas kernel with x_wrap=False (lgrngn/dense._shard_phase with
do_cond=False, do_adve=True, interpret=True: the plain Pallas interpreter,
as the JAX mesh's CPU branch runs it), on one shard: the 8x8 GMD case at
row capacity 32, the courants times 8 so that droplets leave the domain
through x = 0 and x = x1, with and without rain that fills the puddle.

Neither side re-bins, so the slots compare lane by lane: n exact, x and
z rtol 1e-6 (tests/test_torch_step_interpret.py's position tolerance),
the puddle 1e-5 (its), and vt rtol 5e-5 (tests/test_torch_vterm_interpret
.py's: the two libraries' float32 log/exp differ in the last ulps of
beard77, up to 5e-5 by radius band, tests/test_torch_common.py
VT_F32_RTOL).  The port's targets have no JAX
counterpart here (the JAX mesh re-bins from positions): every droplet that
left the domain has target -1.

Kept in a file of its own, as the other interpret-mode files are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_state

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D
from libcloudphxx_tpu.parallel import dense_mesh as jmesh
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_Tpr
from libcloudphxx_tpu_torch.ops import step as tstep

F32 = torch.float32


def _setup(rain):
    m = Kinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                    sstp_coal=2, n_sd_max=24 * 8 * 8,
                    terminal_velocity=lgrngn.vt_t.beard77)
    cfg = m.prtcls.cfg
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, 32)
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d = jax.tree.map(f32, d)
    d = dataclasses.replace(d, courant_x=8.0 * d.courant_x,
                            courant_z=8.0 * d.courant_z)
    if rain:
        d = dataclasses.replace(
            d, n=jnp.where(d.n > 0, 2.0, 0.0),
            rw2=jnp.where(d.n > 0, (1e-3) ** 2, 0.0),
            z=jnp.where(d.n > 0, cfg.z0 + 5.0 * (d.z / cfg.z1), d.z))
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    # one shard: the JAX mesh's layout of the whole grid
    d = jmesh.scatter_dense(cfg, d, 1)
    return cfg, d


@pytest.mark.parametrize("rain", [False, True])
def test_unwrapped_transport_matches_pallas_kernel(rain):
    cfg, d = _setup(rain)
    th, rv = d.sstp_tmp_th, d.sstp_tmp_rv
    d_k, _, _ = jdense._shard_phase(
        cfg, d, th, rv, jnp.zeros((0,), jnp.float32), 1.0, 44.0, 1,
        do_cond=False, do_coal=False, do_adve=True, do_sedi=True,
        interpret=True)

    pcfg, pd = port_cfg(cfg), port_state(d, F32)
    T, p, _RH, eta = hskpng_Tpr(pcfg, pd.sstp_tmp_th, pd.sstp_tmp_rv,
                                pd.rhod, pd.p)
    n, x, z, vt, tgt, info = tstep.transport(
        pcfg, 1.0, True, pd.n, pd.rw2, pd.rd3, pd.x, pd.z, T, p, pd.rhod,
        eta, *tdense._row_courants(pcfg, pd), slab=(0, pcfg.nx))

    np.testing.assert_array_equal(n.numpy(), np.asarray(d_k.n))
    live = n.numpy() > 0
    for a, b, rtol in ((x, d_k.x, 1e-6), (z, d_k.z, 1e-6),
                       (vt, d_k.vt, 5e-5)):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live],
                                   rtol=rtol)
    out = (x < pcfg.x0) | (x >= pcfg.x1)
    assert bool((out & (n > 0)).any())        # x left unwrapped on both
    assert bool((tgt[out & (n > 0)] == -1).all())
    puddle = torch.zeros(np.asarray(d_k.puddle).size)
    puddle[[tdense.OUT_LIQ_VOL, tdense.OUT_DRY_VOL, tdense.OUT_LIQ_NUM,
            tdense.OUT_PRTCL_NUM]] = info.sum(0)[:4]
    np.testing.assert_allclose(puddle.numpy(), np.asarray(d_k.puddle),
                               rtol=1e-5)
    if rain:
        assert float(info[:, 3].sum()) > 0                 # the puddle filled
