"""Port parity at float32: the port's dense front (particles_dense_t, its
plain versions on the CPU) against the JAX package's dense front running
the resident Pallas kernel itself in TPU interpret mode
(LIBCLOUD_ENGINE=dense, LIBCLOUD_RESIDENT=interpret, LIBCLOUD_DENSE_F32=1,
set inside the test only, as tests/test_dense_public.py runs it), on its
8x8 case with coalescence off, 4 steps through step_sync / step_async.

Kept in a file of its own: interpret runs are slow, and interpret-mode
kernels in one process with the rest of the suite have crashed it before
(ROADMAP.md, Queue 3).

Both sides rebuild vt from the current cell (the kernel's convention).
Tolerances, those of tests/test_torch_step_interpret.py: th rtol 2e-6, rv
2e-5 (the latent-heat row sums: the JAX kernel sums in float32, the port
in float64; and the two libraries' float32 exp/log differ in the last
ulps, which the root find carries on); the moments and RH, which sum or
divide those, 5e-5; the puddle 1e-5; sd_conc exact.  The JAX front runs
its first step on its flat engine at float64 (it counts the first density
it is given as changed), the port's on its dense engine at float32.
"""

import os
from math import log, pi, sqrt

import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu_torch import lgrngn as tl

N = 8


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * np.exp(-((np.asarray(lnr) - log(mean_r)) ** 2)
                           / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


def _run(L, factory_kw):
    oi = L.opts_init_t()
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.coal_switch = False
    oi.terminal_velocity = L.vt_t.beard77
    oi.sedi_switch = True
    oi.dt = 1
    oi.nx = oi.nz = N
    oi.dx = oi.dz = 100.0
    oi.x1 = oi.z1 = N * 100.0
    oi.sd_conc = 24
    oi.n_sd_max = 24 * N * N
    oi.sstp_cond = 3
    opts = L.opts_t()
    opts.adve = opts.cond = opts.sedi = True
    opts.coal = opts.chem_dsl = False
    th, rv, rhod = (289.0 * np.ones((N, N)), 7.5e-3 * np.ones((N, N)),
                    np.ones((N, N)))
    p = L.factory(L.backend_t.serial, oi, **factory_kw)
    assert type(p).__name__ == "particles_dense_t"
    p.init(th, rv, rhod, Cx=0.2 * np.ones((N + 1, N)),
           Cz=-0.1 * np.ones((N, N + 1)))
    for _ in range(4):
        p.step_sync(opts, th, rv, rhod)
        p.step_async(opts)
    out = dict(th=th, rv=rv)
    for k, power in (("sd", None), ("m0", 0), ("m3", 3)):
        p.diag_all()
        if power is None:
            p.diag_sd_conc()
        else:
            p.diag_wet_mom(power)
        out[k] = p.outbuf().copy()
    p.diag_RH()
    out["RH"] = p.outbuf().copy()
    out["puddle"] = p.diag_puddle()
    return out


def test_dense_front_matches_resident_kernel():
    env = dict(LIBCLOUD_ENGINE="dense", LIBCLOUD_DENSE_F32="1",
               LIBCLOUD_RESIDENT="interpret")
    os.environ.update(env)
    try:
        j = _run(jl, {})
    finally:
        for k in env:
            os.environ.pop(k, None)
    t = _run(tl, dict(engine="dense", device="cpu", dtype=torch.float32))
    for k, rtol in (("th", 2e-6), ("rv", 2e-5), ("m0", 5e-5), ("m3", 5e-5),
                    ("RH", 5e-5)):
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=k)
    np.testing.assert_array_equal(t["sd"], j["sd"])
    assert j["puddle"]["particle_number"] > 0
    for k, v in j["puddle"].items():
        assert t["puddle"][k] == pytest.approx(v, rel=1e-5, abs=1e-300), k
