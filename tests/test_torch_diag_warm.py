"""Port parity: the public API's warm diagnostics of this slice
(libcloudphxx_tpu_torch/lgrngn/particles.py: diag_kappa_rng,
diag_kappa_mom, diag_{dry,wet,kappa}_rng_cons, diag_rw_ge_rc,
diag_RH_ge_Sc, diag_vel_div, diag_wet_mass_dens) against the JAX
package's particles_t at float64 on the CPU, on one state.

The state: two aerosol modes of kappa 0.61 and 1.28 on 8x8 cells, 16 SDs
a cell, initialised by both packages alike, then wet radii grown by a
seeded factor of 1-400 and a seeded rv of 90-103% of the initial, so
that cells are sub- and supersaturated and droplets lie on both sides of
their critical radius.  Tolerance: rtol 1e-12 (the selections are exact:
the critical radii and saturations of the two libraries' root finds lie
far from every droplet's), and the dense front gives the flat engine's
numbers bit for bit (it unpacks before every diagnostic).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.models.kinematic_2d import Setup as JSetup
from libcloudphxx_tpu.models.kinematic_2d import make_gc as jmake_gc
from libcloudphxx_tpu_torch import lgrngn as tl

F64 = dict(device="cpu", dtype=torch.float64)
NX = NZ = 8
X = 1500.0


def _broad(lnr):
    from libcloudphxx_tpu_torch.common import lognormal
    return lognormal.n_e(0.1e-6, 1.8, 3e7, torch.as_tensor(lnr)).numpy()


def _oi(pkg):
    oi = pkg.opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz, oi.x1, oi.z1, oi.dt = \
        NX, NZ, X / NX, X / NZ, X, X, 1.0
    oi.dry_distros = {(0.61, 0.0): JSetup().lognormal_lnrd,
                      (1.28, 0.0): _broad}
    oi.sd_conc = 16
    oi.n_sd_max = 16 * NX * NZ
    oi.kernel = pkg.kernel_t.geometric
    oi.terminal_velocity = pkg.vt_t.beard77
    return oi


def _fields():
    s = JSetup()
    gc_x, gc_z = jmake_gc(s, NX, NZ, X / NX, X / NZ)
    rhod = np.full((NX, NZ), 1.1) - 0.01 * np.arange(NZ)[None, :]
    return (np.full((NX, NZ), 290.0), np.full((NX, NZ), 8.5e-3), rhod,
            gc_x / 1.1, gc_z / 1.1)


@pytest.fixture(scope="module")
def case():
    th, rv, rhod, cx, cz = _fields()
    jp = jl.factory(jl.backend_t.serial, _oi(jl))
    jp.init(th, rv, rhod, Cx=cx, Cz=cz)
    rng = np.random.default_rng(11)
    js = jp.state
    grow = rng.uniform(1.0, 400.0, js.rw2.shape) ** 2
    rv_new = np.asarray(js.rv) * rng.uniform(0.9, 1.03, js.rv.shape)
    js = dataclasses.replace(js, rw2=js.rw2 * jnp.asarray(grow),
                             rv=jnp.asarray(rv_new))
    jp.state = js
    tp = tl.factory(tl.backend_t.serial, _oi(tl), engine="flat", **F64)
    tp.init(th, rv, rhod, Cx=cx, Cz=cz)
    tp.state = dataclasses.replace(
        port_flat_state(js), rng_seed=tp.state.rng_seed, rng_step=0)
    return jp, tp


OUTPUTS = ("diag_kappa_mom", "diag_wet_mom", "diag_sd_conc", "diag_vel_div",
           "diag_wet_mass_dens", "diag_dry_mom")


def _run(p, calls):
    """(name, outbuf) after each call of ``calls`` that fills the
    outbuf."""
    out = []
    for name, *args in calls:
        getattr(p, name)(*args)
        if name in OUTPUTS:
            out.append((name, np.array(p.outbuf())))
    return out


SEQUENCES = {
    "kappa": [("diag_kappa_rng", 1.0, 2.0), ("diag_kappa_mom", 0),
              ("diag_kappa_mom", 1), ("diag_all",), ("diag_kappa_mom", 2),
              ("diag_kappa_rng", 0.5, 1.0), ("diag_sd_conc",)],
    "cons": [("diag_dry_rng", 0.03e-6, 1e-6), ("diag_wet_rng_cons", 1e-6,
                                                 1.0),
             ("diag_kappa_rng_cons", 0.0, 1.0), ("diag_sd_conc",),
             ("diag_wet_mom", 3), ("diag_wet_rng", 0.5e-6, 1.0),
             ("diag_dry_rng_cons", 0.05e-6, 1.0), ("diag_dry_mom", 3),
             ("diag_all",), ("diag_kappa_rng_cons", 1.0, 2.0),
             ("diag_wet_mom", 0)],
    "activated": [("diag_rw_ge_rc",), ("diag_sd_conc",), ("diag_wet_mom", 3),
                  ("diag_RH_ge_Sc",), ("diag_sd_conc",), ("diag_wet_mom", 0),
                  ("diag_rw_ge_rc",), ("diag_kappa_rng_cons", 1.0, 2.0),
                  ("diag_sd_conc",)],
    "vel_div": [("diag_vel_div",)],
    "mass_dens": [("diag_all",), ("diag_wet_mass_dens", 1e-6, 0.6),
                  ("diag_wet_mass_dens", 12e-6, 0.3),
                  ("diag_rw_ge_rc",), ("diag_wet_mass_dens", 5e-6, 0.62)],
}


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_diagnostics_match_jax(case, seq):
    jp, tp = case
    want, got = _run(jp, SEQUENCES[seq]), _run(tp, SEQUENCES[seq])
    assert len(got) == len(want)
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0.0, err_msg=name)
        if name == "diag_sd_conc":
            # each selection holds some SDs and leaves some out
            assert 0 < g.sum() < 16 * NX * NZ


def test_vel_div_is_the_courant_divergence(case):
    """The flow of the kinematic case is divergence-free in its
    G-weighted courants; with the plain ones divided by one density the
    divergence vanishes to rounding."""
    _, tp = case
    tp.diag_vel_div()
    assert np.abs(tp.outbuf()).max() < 1e-14


def test_consecutive_filter_needs_a_selection():
    th, rv, rhod, cx, cz = _fields()
    for pkg, kw in ((tl, F64), (jl, {})):
        p = pkg.factory(pkg.backend_t.serial, _oi(pkg), **kw)
        p.init(th, rv, rhod, Cx=cx, Cz=cz)
        with pytest.raises(RuntimeError, match="consecutive filter"):
            p.diag_kappa_rng_cons(0.0, 1.0)


def test_dense_front_inherits_the_diagnostics(case):
    """The dense front after a dense step: every diagnostic unpacks the
    population first and gives the flat engine's numbers on that state."""
    th, rv, rhod, cx, cz = _fields()
    d = tl.factory(tl.backend_t.serial, _oi(tl), engine="dense", **F64)
    d.init(th, rv, rhod, Cx=cx, Cz=cz)
    opts = tl.opts_t()
    opts.coal = False
    d.step_sync(opts, th, rv)
    d.step_async(opts)
    assert d._loc == "dense"
    calls = [c for seq in SEQUENCES.values() for c in seq]
    got = _run(d, calls)
    assert d._loc == "flat"
    f = tl.factory(tl.backend_t.serial, _oi(tl), engine="flat", **F64)
    f.init(th, rv, rhod, Cx=cx, Cz=cz)
    f.state = d.state
    for (name, g), (_, w) in zip(got, _run(f, calls)):
        np.testing.assert_array_equal(g, w, err_msg=name)
