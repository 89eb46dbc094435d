"""Port parity at float32 with ice: one per-cell condensation phase, the
port's plain path (kernel F's ice forms' plain version, ops/cond.py
cond_flat_plain with the ice) against the JAX package's cond_percell
through the TPU kernel it replaces at the ice caller
(libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas inside the unsorted
substep loop of lgrngn/condensation.py:248-305, LIBCLOUD_PALLAS=1:
interpret mode on the CPU), with the deposition after each call.

The population is tests/test_torch_ice.py's cold 8x8 grid, half of it
frozen, with the host model's increment from a seed, cast to float32 on
both sides.  Tolerances: the float32 cross-library bounds of ROADMAP.md,
Queue 3 (as tests/test_torch_grid3d_interpret.py): rw2 rtol 1e-4 for 98%
of the live droplets and 5e-3 for all, th rtol 1e-6, rv 1e-4; the ice
axes rtol 1e-4, as rv (forward Euler, no root find: they part by the
cells' rv, where the JAX package's float32 deposition differences two
cell sums of the ice mass, before and after, and the port sums each SD's
difference).  This file runs JAX Pallas kernels in interpret mode,
so it stands apart from the other port tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_ice import ice_case
from torch_parity import port_flat_state

from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import hskpng as thskpng


def test_ice_percell_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LIBCLOUD_PALLAS", "1")
    cfg, js, pcfg, _ = ice_case(seed=9)
    js = dataclasses.replace(js, **{
        f.name: getattr(js, f.name).astype(jnp.float32)
        for f in dataclasses.fields(js)
        if getattr(js, f.name).dtype == jnp.float64})
    ps = port_flat_state(js, torch.float32)
    want = jcond.cond_percell(cfg, jhskpng.hskpng_Tpr(cfg, js), 1.0, 44.0,
                              lam=jcond.stale_mfp(js))
    got = tcond.cond_percell(pcfg, thskpng.hskpng_Tpr_state(pcfg, ps), 1.0,
                             44.0, tcond.stale_mfp(ps))
    assert got.rw2.dtype == torch.float32
    live = ps.n.numpy() > 0
    frozen = live & (ps.ice_a.numpy() > 0)
    liquid = live & ~frozen
    g, w = got.rw2.numpy(), np.asarray(want.rw2)
    rel = np.abs(g[liquid] - w[liquid]) / w[liquid]
    assert np.mean(rel <= 1e-4) >= 0.98
    np.testing.assert_allclose(g[liquid], w[liquid], rtol=5e-3)
    assert (g[frozen] == 0).all() and (w[frozen] == 0).all()
    np.testing.assert_allclose(got.th.numpy(), np.asarray(want.th),
                               rtol=1e-6)
    np.testing.assert_allclose(got.rv.numpy(), np.asarray(want.rv),
                               rtol=1e-4)
    for k in ("ice_a", "ice_c"):
        np.testing.assert_allclose(getattr(got, k).numpy()[frozen],
                                   np.asarray(getattr(want, k))[frozen],
                                   rtol=1e-4, err_msg=k)
    # the ice grew and took vapour
    assert (got.ice_a.numpy()[frozen] > ps.ice_a.numpy()[frozen]).all()
    assert (got.rv.numpy() < ps.rv.numpy()).any()
