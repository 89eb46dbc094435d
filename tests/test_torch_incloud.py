"""Port parity: diag_incloud_time (lgrngn/condensation.update_incloud_time,
particles_t.diag_incloud_time_mom) against the JAX package at float64 on
the CPU: the in-cloud time of the Kinematic2D GMD case's SDs at 8x8
cells over three condensation phases, and tests/test_incloud_time.py's
case (the reference's diag_incloud_time.py) on one 2-D cell through the
public API.

Tolerances: the in-cloud time slot by slot exact (the same critical
radius to rtol ~1e-15, compared with rw2 at 1e-10 of each other: no
droplet sits that close to it); the mean in-cloud times of the filtered
selections rtol 1e-12.
"""

import numpy as np
import pytest
from test_torch_les import F64, _case

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import particles as jparticles
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles


def test_incloud_time_matches_jax():
    """diag_incloud_time over 3 condensation phases (the critical radius of
    each SD at its cell's T, update_incloud_time), and its moments."""
    cfg, js, pcfg, ps = _case("percell", diag_incloud_time=True,
                              turb_cond_switch=False)
    for _ in range(3):
        js = jparticles._step_cond_jit(cfg, js, 1.0, 44.0, False, False,
                                       True)
        ps = tparticles.step_cond_body(pcfg, ps, 1.0, 44.0)
    want = np.asarray(js.incloud_time)
    np.testing.assert_array_equal(ps.incloud_time.numpy(), want)
    assert (want > 0).any() and (want == 0.0).any()


def _incloud_parcel(pkg, **kw):
    """tests/test_incloud_time.py's case on one 2-D cell: two CCN kinds
    pushed slowly into supersaturation."""
    from math import exp, log, pi, sqrt

    def lognormal(lnr):
        return (60e6 * exp(-((lnr - log(0.02e-6)) ** 2) / 2 / log(1.4) ** 2)
                / log(1.4) / sqrt(2 * pi))
    oi = pkg.opts_init_t()
    oi.nx = oi.nz = 1
    oi.dx = oi.dz = 1.0
    oi.x1 = oi.z1 = 1.0
    oi.dry_distros = {(0.61, 0.0): lognormal, (1.28, 0.0): lognormal}
    oi.coal_switch = oi.sedi_switch = False
    oi.RH_max = 0.999
    oi.dt = 0.1
    oi.sd_conc = 100
    oi.n_sd_max = 200
    oi.diag_incloud_time = True
    opts = pkg.opts_t()
    opts.adve = opts.sedi = opts.coal = opts.chem_dsl = False
    opts.cond = True
    prt = pkg.factory(pkg.backend_t.serial, oi, **kw)
    rhod, th = np.ones((1, 1)), np.full((1, 1), 300.0)
    rv = np.full((1, 1), 0.009 - 0.00005)
    prt.init(th, rv, rhod)
    for _ in range(400):
        rv[0, 0] += 0.00001 * oi.dt
        prt.sync_in(th=th, rv=rv, rhod=rhod)
        prt.step_cond(opts, th, rv)
        prt.step_async(opts)
    out = {}
    for sel, args in (("all", None), ("small", (0, 0.02e-6)),
                      ("big", (0.02e-6, 1)), ("big_kgt1", (1, 10)),
                      ("big_klt1", (0, 1))):
        if sel == "all":
            prt.diag_all()
        else:
            prt.diag_dry_rng(*(args if sel in ("small", "big")
                               else (0.02e-6, 1)))
            if sel.startswith("big_"):
                prt.diag_kappa_rng_cons(*args)
        prt.diag_incloud_time_mom(1)
        m1 = prt.outbuf()[0]
        prt.diag_incloud_time_mom(0)
        out[sel] = m1 / prt.outbuf()[0]
    return out


def test_incloud_time_filtered_moments():
    """tests/test_incloud_time.py's assertion chain (reference
    diag_incloud_time.py:105-108) through the port's public API, and the
    mean in-cloud times equal the JAX package's."""
    got = _incloud_parcel(tl, **F64)
    assert got["small"] < got["all"] < got["big"] < got["big_kgt1"]
    assert got["big_klt1"] < got["big"]
    want = _incloud_parcel(jl)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
