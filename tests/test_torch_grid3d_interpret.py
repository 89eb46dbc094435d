"""Port parity at float32 on the 3-D grid: one per-cell condensation phase,
the port's plain path (kernel F's plain version, ops/cond.cond_flat_plain)
against the JAX package's cond_percell through the TPU kernel it replaces
(libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas, LIBCLOUD_PALLAS=1:
interpret mode on the CPU).

The population is the GMD aerosol at 16 SDs a cell on 4x4x4 cells of 100
m (tests/test_torch_grid3d.py's 3-D case) after init, with the host
model's increment from a seed, cast to float32 on both sides.
Tolerances: the float32 cross-library bounds of ROADMAP.md, Queue 3 (as
tests/test_torch_les_interpret.py): rw2 rtol 1e-4 for 98% of the live
droplets and 5e-3 for all, th rtol 1e-6, rv 1e-4.  This file runs JAX
Pallas kernels in interpret mode, so it stands apart from the other port
tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_grid3d import _courants, _fields3d, _oi
from torch_parity import port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import hskpng as thskpng


def test_3d_percell_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LIBCLOUD_PALLAS", "1")
    oi = _oi(jl, 3, sstp_cond=4, n_sd_max=16 * 64)
    prt = jl.factory(jl.backend_t.serial, oi)
    th, rv, rhod = _fields3d()
    prt.init(th, rv, rhod, **_courants())
    cfg, js = prt.cfg, prt.state
    rng = np.random.default_rng(5)
    js = dataclasses.replace(
        js, th=js.th + jnp.asarray(rng.normal(0.3, 0.3, cfg.n_cell)),
        rv=js.rv * jnp.asarray(1 + rng.uniform(0.2, 0.4, cfg.n_cell)))
    js = dataclasses.replace(js, **{
        f.name: getattr(js, f.name).astype(jnp.float32)
        for f in dataclasses.fields(js)
        if getattr(js, f.name).dtype == jnp.float64})
    ps = port_flat_state(js, torch.float32)
    pcfg = port_cfg(cfg)
    assert pcfg.n_dims == 3 and pcfg.n_cell == 64
    want = jcond.cond_percell(cfg, jhskpng.hskpng_Tpr(cfg, js), 1.0, 44.0,
                              lam=jcond.stale_mfp(js))
    got = tcond.cond_percell(pcfg, thskpng.hskpng_Tpr_state(pcfg, ps), 1.0,
                             44.0, tcond.stale_mfp(ps))
    assert got.rw2.dtype == torch.float32
    live = ps.n.numpy() > 0
    w0 = ps.rw2.numpy()
    g, w = got.rw2.numpy(), np.asarray(want.rw2)
    rel = np.abs(g[live] - w[live]) / w[live]
    assert np.mean(rel <= 1e-4) >= 0.98
    np.testing.assert_allclose(g[live], w[live], rtol=5e-3)
    np.testing.assert_allclose(got.th.numpy(), np.asarray(want.th),
                               rtol=1e-6)
    np.testing.assert_allclose(got.rv.numpy(), np.asarray(want.rv),
                               rtol=1e-4)
    # the cells were supersaturated: the droplets grew and took vapour
    assert (g[live] > w0[live]).mean() > 0.5
    assert (got.rv.numpy() < ps.rv.numpy()).all()
