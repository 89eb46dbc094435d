"""Port parity at float32: one per-cell condensation phase with the SGS
supersaturation (turb_cond: each droplet at its cell's RH plus its ssp,
ssp advanced each substep), the port's plain path (kernel F's turb_cond
form's plain version, ops/cond.cond_flat_plain) against the JAX package's
cond_percell through the TPU kernel it replaces
(libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas, LIBCLOUD_PALLAS=1:
interpret mode on the CPU).

The population is the Kinematic2D GMD case's at 8x8 cells with the host
model's increment and ssp / dot_ssp from a seed, cast to float32 on both
sides.  Tolerances: the float32 cross-library bounds of ROADMAP.md,
Queue 3 ("float32 across libraries": XLA's and PyTorch's float32
transcendentals differ in the last ulps, and the 12-iteration root find
and the growth rate's 1/(S-1) near activation carry that to rw2): rw2
rtol 1e-4 for 98% of the live droplets and 5e-3 for all (this population,
up to 6% supersaturated, reads 2.4e-4 at most with turb_cond, and 1.6e-3
without it and without the Pallas kernel: the libraries' float32, not the
form), th rtol 1e-6, rv 1e-4, ssp rtol 1e-6 (the same float32 sums).  This file runs JAX Pallas kernels in interpret
mode, so it stands apart from the other port tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_les import _case
from torch_parity import port_flat_state

from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import hskpng as thskpng


def _f32(js):
    return dataclasses.replace(js, **{
        f.name: getattr(js, f.name).astype(jnp.float32)
        for f in dataclasses.fields(js)
        if getattr(js, f.name).dtype == jnp.float64})


def test_turb_cond_percell_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LIBCLOUD_PALLAS", "1")
    cfg, js, pcfg, _ = _case("percell")
    js = _f32(js)
    ps = port_flat_state(js, torch.float32)
    lam = jcond.stale_mfp(js)
    want = jcond.cond_percell(cfg, jhskpng.hskpng_Tpr(cfg, js), 1.0, 44.0,
                              turb_cond=True, lam=lam)
    got = tcond.cond_percell(pcfg, thskpng.hskpng_Tpr_state(pcfg, ps), 1.0,
                             44.0, tcond.stale_mfp(ps), turb_cond=True)
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
    np.testing.assert_allclose(got.ssp.numpy(), np.asarray(want.ssp),
                               rtol=1e-6, atol=1e-12)
    assert (g[live] != w0[live]).any()
