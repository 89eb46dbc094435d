"""Port parity: the flat engine on the 1-D and 3-D grids, and SD init on
the parcel, 1-D and 3-D grids, against the JAX package's flat engine on
the CPU at float64 (the port's plain path).

* init_SD and init_SD_reference in 0-D, 1-D and 3-D: every field slot for
  slot, bitwise (the same numpy / mt19937 draws in the same order).
* 3-D, 4x4x4 cells (tests/test_dense_public.py:218-280's case), coalescence
  off, through the public API with each SD advection scheme (implicit,
  euler, pred_corr): th and rv rtol 1e-10, the wet moments 1e-10, the SD
  counts and cells exact, positions 1e-10 (sorted y as the JAX test's),
  and diag_vel_div.
* 3-D with coalescence, and 3-D turb_adve: the JAX package's async phase
  fed the port's Philox draws (tests/test_torch_les.py _port_draws, run
  eagerly): multiplicities and cells exact, the rest 1e-9.
* The source box in y (tests/test_lgrngn_transport.py:358
  test_source_y_bounds_3d), slot for slot against JAX.
* 1-D advection, periodic and open side walls, against JAX.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_les import _fed, _port_draws

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import init as jinit
from libcloudphxx_tpu.lgrngn import refinit as jrefinit
from libcloudphxx_tpu.lgrngn.state import StaticConfig as JCfg
from libcloudphxx_tpu.lgrngn.state import empty_state
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import init as tinit
from libcloudphxx_tpu_torch.lgrngn import particles as tparticles
from libcloudphxx_tpu_torch.lgrngn import refinit as trefinit
from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig as TCfg
from libcloudphxx_tpu_torch.lgrngn.turbulence import AXES
from libcloudphxx_tpu_torch.ops import philox

F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("n", "rd3", "kpa", "x", "y", "z", "ijk")


def lognormal(lnr):
    lnr = np.asarray(lnr)
    return (60e6 * np.exp(-(lnr - np.log(0.04e-6 / 2)) ** 2 / 2
                          / np.log(1.4) ** 2) / np.log(1.4)
            / np.sqrt(2 * np.pi))


def lognormal_f32(lnr):
    """lognormal in float32, the reference's real_t = float functor."""
    return np.float32(lognormal(np.float32(lnr)))


def _grid(oi, n_dims, n=4, d=100.0):
    """Set ``oi``'s grid: the parcel (no axis), x alone, or x, y, z, n
    cells of d metres on each axis."""
    axes = {0: "", 1: "x", 3: "xyz"}[n_dims]
    for a in axes:
        setattr(oi, "n" + a, n)
        setattr(oi, "d" + a, d)
        setattr(oi, a + "1", n * d)
    return oi


def _oi(pkg, n_dims=3, **over):
    oi = _grid(pkg.opts_init_t(), n_dims)
    oi.dt = 1.0
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.sd_conc = 16
    oi.n_sd_max = 16 * 64 * 2
    oi.coal_switch = oi.sedi_switch = False
    for k, v in over.items():
        setattr(oi, k, v)
    return oi


INIT_MODES = {
    "sd_conc": dict(),
    "large_tail": dict(sd_conc=32, sd_conc_large_tail=True),
    # about 8 SDs a cell: the GMD concentration times a cell's volume (1 kg
    # of air in a parcel, 100 m^3 on the 1-D grid, 1e6 m^3 on the 3-D)
    "const_multi": dict(sd_conc=0, sd_const_multi={0: 6e6, 1: 6e8,
                                                   3: 6e12}),
    "dry_sizes": dict(sd_conc=0, dry_distros={}, dry_sizes={
        (0.61, 0.0): {0.05e-6: (60e6, 3)}, (1.28, 0.0): {0.1e-6: (3e7, 1)}}),
}


@pytest.mark.parametrize("mode", list(INIT_MODES))
@pytest.mark.parametrize("n_dims", [0, 1, 3])
def test_init_matches_jax_on_every_grid(n_dims, mode):
    """init_SD on the parcel (1 kg of dry air), the 1-D and the 3-D grid:
    the JAX package's population slot for slot, bitwise."""
    kw = {k: v[n_dims] if k == "sd_const_multi" else v
          for k, v in INIT_MODES[mode].items()}
    toi, joi = _oi(tl, n_dims, **kw), _oi(jl, n_dims, **kw)
    tcfg, jcfg = TCfg.from_opts_init(toi), JCfg.from_opts_init(joi)
    assert tcfg.n_dims == n_dims
    rhod = np.random.default_rng(3).uniform(0.9, 1.2, tcfg.n_cell)
    got = tinit.init_SD(tcfg, toi, np.random.default_rng(7), rhod)
    st = jinit.init_SD(jcfg, joi, empty_state(jcfg),
                       np.random.default_rng(7), rhod)
    k = got["n"].size
    assert k > 0 and not np.asarray(st.n)[k:].any()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(st, f))[:k],
                                      err_msg=f)
    # positions inside each SD's cell, on the grid's axes only
    for a in "xyz":
        if a in {0: "", 1: "x", 3: "xyz"}[n_dims]:
            assert np.ptp(got[a]) > 0
        else:
            assert not got[a].any()


@pytest.mark.parametrize("n_dims", [0, 1, 3])
def test_reference_init_matches_jax_on_every_grid(n_dims):
    """init_SD_reference (the mt19937 draws, float32) on each grid, the
    parcel's dv 1/rhod: bitwise the JAX package's."""
    toi = _oi(tl, n_dims, dry_distros={(0.61, 0.0): lognormal_f32})
    joi = _oi(jl, n_dims, dry_distros={(0.61, 0.0): lognormal_f32})
    tcfg, jcfg = TCfg.from_opts_init(toi), JCfg.from_opts_init(joi)
    rhod = np.random.default_rng(3).uniform(0.9, 1.2, tcfg.n_cell)
    dv = 1.0 / rhod if n_dims == 0 else tinit.cell_dv(tcfg)
    got = trefinit.init_SD_reference(tcfg, toi, 44, rhod, dv)
    st = jrefinit.init_SD_reference(jcfg, joi, empty_state(jcfg), 44, rhod,
                                    dv)
    k = got["n"].size
    assert k == 16 * tcfg.n_cell
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(st, f))[:k],
                                      err_msg=f)


# ----------------------------------------------------- 3-D, public API
N = 4


def _fields3d(n=N):
    return (289.0 * np.ones((n, n, n)), 7.5e-3 * np.ones((n, n, n)),
            np.ones((n, n, n)))


def _courants(n=N):
    return dict(Cx=0.2 * np.ones((n + 1, n, n)),
                Cy=-0.15 * np.ones((n, n + 1, n)),
                Cz=-0.1 * np.ones((n, n, n + 1)))


def _pair(**over):
    """The port's and the JAX package's particles_t on test_dense_public's
    3-D case (4x4x4 cells of 100 m, 16 SDs a cell, sedimentation,
    sstp_cond = sstp_coal = 2)."""
    out = []
    for pkg in (tl, jl):
        oi = _oi(pkg, 3, terminal_velocity=pkg.vt_t.beard77,
                 sedi_switch=True, sstp_cond=2, sstp_coal=2,
                 n_sd_max=16 * N ** 3)
        for k, v in over.items():
            setattr(oi, k, v(pkg) if callable(v) else v)
        if pkg is tl:
            prt = tl.factory(tl.backend_t.serial, oi, **F64)
            assert type(prt) is tparticles.particles_t
        else:
            prt = jl.factory(jl.backend_t.serial, oi)
        out.append(prt)
    return out


def _opts(pkg, coal=False, turb=False):
    o = pkg.opts_t()
    o.adve = o.cond = o.sedi = True
    o.coal = coal
    o.chem_dsl = False
    o.turb_adve = turb
    return o


def _init_both(pp, jp):
    th, rv, rhod = _fields3d()
    for p in (pp, jp):
        p.init(th.copy(), rv.copy(), rhod, **_courants())
    return rhod


def _diags(p):
    out = {}
    for name, call in (("sd", lambda: p.diag_sd_conc()),
                       ("m0", lambda: p.diag_wet_mom(0)),
                       ("m3", lambda: p.diag_wet_mom(3))):
        p.diag_all()
        call()
        out[name] = p.outbuf().copy()
    p.diag_vel_div()
    out["div"] = p.outbuf().copy()
    return out


def _assert_same(pp, jp, rtol=1e-10):
    st, js = pp.state, jp.state
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(st.ijk.numpy(), np.asarray(js.ijk))
    for k in ("x", "y", "z", "rw2", "rd3"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=rtol,
                                   err_msg=k)
    a, b = _diags(pp), _diags(jp)
    np.testing.assert_array_equal(a["sd"], b["sd"])
    for k in ("m0", "m3", "div"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-300,
                                   err_msg=k)
    return a


@pytest.mark.parametrize("scheme", ["implicit", "euler", "pred_corr"])
def test_3d_matches_jax(scheme):
    """Coalescence off, 4 steps of step_sync / step_async with the
    staggered courants of all three axes."""
    pp, jp = _pair(adve_scheme=lambda pkg: getattr(pkg.as_t, scheme))
    rhod = _init_both(pp, jp)
    ths = [a.copy() for a in _fields3d()[:2]]
    thj = [a.copy() for a in _fields3d()[:2]]
    for _ in range(4):
        pp.step_sync(_opts(tl), *ths, rhod)
        pp.step_async(_opts(tl))
        jp.step_sync(_opts(jl), *thj, rhod)
        jp.step_async(_opts(jl))
    np.testing.assert_allclose(ths[0], thj[0], rtol=1e-10)
    np.testing.assert_allclose(ths[1], thj[1], rtol=1e-10)
    d = _assert_same(pp, jp)
    y = pp.get_attr("y")[pp.get_attr("n") > 0]
    np.testing.assert_allclose(
        np.sort(y), np.sort(np.asarray(jp.get_attr("y"))[
            np.asarray(jp.get_attr("n")) > 0]), rtol=1e-10)
    # y advection moved the SDs, across the periodic y walls too
    assert np.unique(np.round(y, 6)).size > N
    # the flow is non-divergent: -0.15 + 0.15 on y, the rest alike
    np.testing.assert_allclose(d["div"], 0.0, atol=1e-15)


def test_3d_divergence_reads_every_face():
    """diag_vel_div sums the x, y and z faces (reference
    particles_diag.ipp:501-556): a divergent courant_y shows."""
    pp, jp = _pair()
    th, rv, rhod = _fields3d()
    rng = np.random.default_rng(11)
    C = {k: rng.uniform(-0.3, 0.3, v.shape) for k, v in _courants().items()}
    for p in (pp, jp):
        p.init(th.copy(), rv.copy(), rhod, **C)
        p.diag_vel_div()
    np.testing.assert_allclose(pp.outbuf(), jp.outbuf(), rtol=1e-12)
    dy = (C["Cy"][:, 1:, :] - C["Cy"][:, :-1, :]).ravel()
    dx = (C["Cx"][1:] - C["Cx"][:-1]).ravel()
    dz = (C["Cz"][:, :, 1:] - C["Cz"][:, :, :-1]).ravel()
    np.testing.assert_allclose(pp.outbuf(), dx + dy + dz, rtol=1e-12)


def _fed_async(monkeypatch, pp, jp, opts_t, opts_j, names):
    """One async phase on both, JAX fed the port's draws (the turbulent
    velocities' normals at the step counter as it stands when no
    coalescence ran before them)."""
    if opts_t.coal:
        uni, nrm = _port_draws(pp, pp.opts_init.sstp_coal, names)
    else:
        st = pp.state
        uni = []
        nrm = [philox.normal(st.rng_seed, st.rng_step, AXES[k],
                             pp.cfg.n_sd_max, torch.float64).numpy()
               for k in names]
    pp.step_async(opts_t)
    monkeypatch.setattr(jax.random, "uniform", _fed(uni))
    monkeypatch.setattr(jax.random, "normal", _fed(nrm))
    with jax.disable_jit():
        jp.step_async(opts_j)
    monkeypatch.undo()
    assert not uni and not nrm


def test_3d_coalescence_matches_jax(monkeypatch):
    """Coalescence on (the geometric kernel, scaled so that 4 steps
    collide), 3 steps, the JAX async phase fed the port's draws."""
    pp, jp = _pair(coal_switch=True, kernel=lambda pkg: pkg.kernel_t.geometric,
                   kernel_parameters=[1e4])
    rhod = _init_both(pp, jp)
    ths = [a.copy() for a in _fields3d()[:2]]
    thj = [a.copy() for a in _fields3d()[:2]]
    n0 = pp.get_attr("n").sum()
    for _ in range(3):
        pp.step_sync(_opts(tl, coal=True), *ths, rhod)
        jp.step_sync(_opts(jl, coal=True), *thj, rhod)
        _fed_async(monkeypatch, pp, jp, _opts(tl, coal=True),
                   _opts(jl, coal=True), ())
    np.testing.assert_allclose(ths[0], thj[0], rtol=1e-9)
    np.testing.assert_allclose(ths[1], thj[1], rtol=1e-9)
    _assert_same(pp, jp, rtol=1e-9)
    assert pp.get_attr("n").sum() < n0   # droplets collided


def test_3d_turb_adve_matches_jax(monkeypatch):
    """turb_adve on the 3-D grid: up, wp and vp drawn (the port's Philox
    normals, one axis key each, fed into JAX) and x, z and y displaced."""
    pp, jp = _pair(turb_adve_switch=True)
    rhod = _init_both(pp, jp)
    ths = [a.copy() for a in _fields3d()[:2]]
    thj = [a.copy() for a in _fields3d()[:2]]
    diss = np.full((N, N, N), 1e-2)
    for _ in range(2):
        pp.step_sync(_opts(tl, turb=True), *ths, rhod, diss_rate=diss)
        jp.step_sync(_opts(jl, turb=True), *thj, rhod, diss_rate=diss)
        _fed_async(monkeypatch, pp, jp, _opts(tl, turb=True),
                   _opts(jl, turb=True), ("up", "wp", "vp"))
    st, js = pp.state, jp.state
    for k in ("up", "wp", "vp"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-12,
                                   err_msg=k)
        assert (getattr(st, k) != 0).any()
    _assert_same(pp, jp, rtol=1e-9)


# ------------------------------------------------- the source box in y
def _source_case(pkg):
    """tests/test_lgrngn_transport.py:358 test_source_y_bounds_3d's case:
    2x2x2 cells, the simple source over the first y slab only."""
    from math import exp, log, sqrt
    from math import pi as PI

    def lognormal_src(lnr):
        return 60e4 * exp(-(lnr - log(0.05e-6)) ** 2 / 2 / log(1.4) ** 2) \
            / log(1.4) / sqrt(2 * PI)

    def lognormal_s(lnr):
        return float(lognormal(lnr))

    n = 2
    oi = pkg.opts_init_t()
    oi.dt = 1
    oi.nx = oi.ny = oi.nz = n
    oi.dx = oi.dy = oi.dz = 1.0
    oi.x1 = oi.y1 = oi.z1 = float(n)
    oi.coal_switch = oi.sedi_switch = False
    oi.dry_distros = {(0.61, 0.0): lognormal_s}
    oi.sd_conc = 32
    oi.n_sd_max = 32 * n ** 3 + 16 * n ** 3
    oi.src_type = pkg.src_t.simple
    oi.src_x0, oi.src_x1 = 0.0, float(n)
    oi.src_z0, oi.src_z1 = 0.0, float(n)
    oi.src_y0, oi.src_y1 = 0.0, 1.0          # first y slab only
    opts = pkg.opts_t()
    opts.adve = opts.sedi = opts.coal = opts.cond = opts.chem_dsl = False
    opts.src = True
    opts.src_dry_distros = {(0.61, 0.0): (lognormal_src, 8, 1)}
    prt = tl.factory(tl.backend_t.serial, oi, **F64) if pkg is tl \
        else jl.factory(jl.backend_t.serial, oi)
    rhod = np.ones((n, n, n))
    th = 300.0 * np.ones((n, n, n))
    rv = 0.01 * np.ones((n, n, n))
    prt.init(th, rv, rhod)
    prt.step_sync(opts, th, rv, rhod)
    prt.step_async(opts)
    return prt


def test_source_y_bounds_3d():
    """src_y0/src_y1 bound the source box along y in 3-D (reference
    opts_init.hpp:158): the new SDs only in the j == 0 cells, each with a
    y in its cell, slot for slot the JAX package's."""
    pp, jp = _source_case(tl), _source_case(jl)
    pp.diag_all()
    pp.diag_sd_conc()
    sd = pp.outbuf().reshape(2, 2, 2)
    assert np.all(sd[:, 0, :] == 32 + 8)
    assert np.all(sd[:, 1, :] == 32)
    st, js = pp.state, jp.state
    np.testing.assert_array_equal(st.ijk.numpy(), np.asarray(js.ijk))
    for k in ("n", "rd3", "x", "y", "z"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(st.rw2.numpy(), np.asarray(js.rw2),
                               rtol=1e-12)
    new = slice(32 * 8, 32 * 8 + 8 * 4)
    y = st.y.numpy()[new]
    assert ((y >= 0) & (y < 1)).all() and np.ptp(y) > 0


# ------------------------------------------------------------ 1-D
@pytest.mark.parametrize("open_walls", [False, True])
def test_1d_advection_and_walls(open_walls):
    """x alone, 8 cells, a uniform courant_x of 0.2 (periodic: the SDs wrap
    and none is lost; open side walls: those that cross x1 are removed),
    sedimentation and subsidence off as on every grid without z, 6 steps
    against JAX."""
    out = []
    for pkg in (tl, jl):
        oi = _oi(pkg, 1, open_side_walls=open_walls, n_sd_max=16 * 8,
                 terminal_velocity=pkg.vt_t.beard77, sedi_switch=True)
        _grid(oi, 1, n=8)
        prt = tl.factory(tl.backend_t.serial, oi, **F64) if pkg is tl \
            else jl.factory(jl.backend_t.serial, oi)
        th, rv, rhod = (np.full(8, v) for v in (289.0, 7.5e-3, 1.0))
        prt.init(th, rv, rhod, Cx=np.full(9, 0.2))
        o = _opts(pkg)
        o.subs = True
        for _ in range(6):
            prt.step_sync(o, th, rv, rhod)
            prt.step_async(o)
        out.append((prt, th, rv))
    (pp, th, rv), (jp, jth, jrv) = out
    np.testing.assert_allclose(th, jth, rtol=1e-10)
    np.testing.assert_allclose(rv, jrv, rtol=1e-10)
    st, js = pp.state, jp.state
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(st.ijk.numpy(), np.asarray(js.ijk))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(js.x), rtol=1e-10)
    np.testing.assert_allclose(st.z.numpy(), np.asarray(js.z), rtol=1e-10)
    live = st.n.numpy() > 0
    if open_walls:
        assert 0 < live.sum() < 16 * 8
    else:
        assert live.sum() == 16 * 8
        assert (st.ijk.numpy() == np.floor(st.x.numpy() / 100.0)).all()
    assert not st.y.any()
