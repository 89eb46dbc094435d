"""Port parity: the dense engine on the 3-D grid (libcloudphxx_tpu_torch/
lgrngn/dense.py with the y plane, ops/step.py kernel C's and D's plain
versions with y, ops/coal.py carrying y) against the JAX package's XLA
dense functions at float64 on the CPU, where the port runs the plain
version of every kernel.

The case: 4x4x4 cells of 100 m (tests/test_dense_public.py:218's grid),
16 SDs a cell, row capacity 64, random staggered courants below 0.3 from a
seed; a quarter of the SDs of the edge columns and rows of columns put
within 0.5 m of the periodic side walls, so that droplets wrap in x and in
y; for the far movers a few droplets grown to 1 mm and stepped at dt 40 s,
so that they fall more than one cell.

* pack and unpack: the JAX package's pack, cell by cell (multisets of n,
  rd3, kpa, x, y, z), and back to the flat population.
* adve_sedi_bcnd (implicit, euler and pred_corr; periodic and open side
  walls; periodic top/bottom walls): kernel C's plain version slot for
  slot, x, y, z rtol 1e-10, n and the puddle's counts exact, its volumes
  1e-10, and every near target the cell of JAX's position.
* rebin: the merge (kernel D's 3-D form's plain version) and the far-mover
  repair against JAX's rebin as per-cell multisets; a y-wrapping mover
  lands in the merge (the port wraps y as it wraps x; JAX re-bins it
  globally, dense.py:1170-1173, ROADMAP.md "Known differences"), so
  DenseState.rebins counts only the far movers.
* step_fused, coalescence off, 5 steps (implicit, pred_corr, and the exact
  mode with D's 12-plane form's plain version): JAX's step_cond and
  step_async with the kernel's vt convention (vt rebuilt from the saved
  cell state before each condensation, as tests/test_torch_step.py's
  reference), th and rv rtol 1e-10, per-cell multisets of n and rd3
  exact and of x, y, z rtol 1e-10.
* with coalescence (stride and sort pairing; the geometric kernel, and
  onishi_hall at dissipation rate 0): the y plane rides the shuffles,
  against the JAX pair functions fed the port's draws
  (torch_parity.jax_coal_loop).
* the public API: tests/test_dense_public.py::test_dense_public_3d's three
  cases, the port's dense front (engine="dense") against its flat engine,
  at the JAX test's gates with the port's condensation reading the
  carried vt (tests/test_torch_dense_front.py's patch).
"""

import dataclasses
import os
from math import log, pi, sqrt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_front import _carried_vt
from test_torch_kinematic import _port_order
from torch_parity import (jax_coal_loop, multiset, port_cfg,
                          port_flat_state, port_state, t)

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.dense_front import dense_capable
from libcloudphxx_tpu_torch.lgrngn.state import (OUT_DRY_VOL, OUT_LIQ_NUM,
                                                 OUT_LIQ_VOL, OUT_PRTCL_NUM)
from libcloudphxx_tpu_torch.ops import step as tstep

N = 4
CAP = 64
F64 = dict(device="cpu", dtype=torch.float64)
POS = ("x", "y", "z")
# the puddle slots of kernel C's row partials, in rowinfo's order
PUDDLE_SLOTS = [OUT_LIQ_VOL, OUT_DRY_VOL, OUT_LIQ_NUM, OUT_PRTCL_NUM]


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * np.exp(-((np.asarray(lnr) - log(mean_r)) ** 2)
                           / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


def _oi(pkg, **over):
    oi = pkg.opts_init_t()
    for a in "xyz":
        setattr(oi, "n" + a, N)
        setattr(oi, "d" + a, 100.0)
        setattr(oi, a + "1", N * 100.0)
    oi.dt = 1.0
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.sd_conc = 16
    oi.n_sd_max = 16 * N ** 3
    oi.sstp_cond = 2
    oi.sstp_coal = 2
    oi.coal_switch = False
    oi.sedi_switch = True
    oi.terminal_velocity = pkg.vt_t.beard77
    for k, v in over.items():
        setattr(oi, k, v(pkg) if callable(v) else v)
    return oi


def _courants(seed=5):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s)
    return dict(Cx=u(N + 1, N, N), Cy=u(N, N + 1, N), Cz=u(N, N, N + 1))


def _fields():
    return (289.0 * np.ones((N, N, N)), 7.5e-3 * np.ones((N, N, N)),
            np.ones((N, N, N)))


def _edges(js, seed=3):
    """The JAX flat state ``js`` with a quarter of the SDs of the edge
    columns (x) and of the edge rows of columns (y) moved within 0.5 m of
    the periodic side walls."""
    rng = np.random.default_rng(seed)
    st = {a: np.array(getattr(js, a)) for a in ("n", "ijk", "x", "y")}
    i, j = st["ijk"] // (N * N), (st["ijk"] // N) % N
    for a, idx in (("x", i), ("y", j)):
        pick = (st["n"] > 0) & ((idx == 0) | (idx == N - 1)) \
            & (rng.random(idx.size) < 0.25)
        u = rng.uniform(1e-3, 0.5, idx.size)
        st[a] = np.where(pick & (idx == 0), u, st[a])
        st[a] = np.where(pick & (idx == N - 1), N * 100.0 - u, st[a])
    return dataclasses.replace(js, x=jnp.asarray(st["x"]),
                               y=jnp.asarray(st["y"]))


def _jax_state(**over):
    """The JAX package's flat 3-D population (particles_t.init), edges
    populated, and its config."""
    p = jl.particles_t(jl.backend_t.serial, _oi(jl, **over))
    p.init(*_fields(), **_courants())
    return p.cfg, _edges(p.state)


def _pack(cfg, js, cap=CAP):
    return jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, js, cap)


def _with_vt(cfg, d):
    c = lambda a: a[:, None]
    return dataclasses.replace(d, vt=jvterm.vt_of(
        cfg, d.rw2, c(d.T), c(d.p), c(d.rhod), c(d.eta)))


def _rain(d, k=6):
    """d with the first live SD of each of k rows grown to a 1 mm drop."""
    n = np.asarray(d.n)
    rows = np.flatnonzero((n > 0).any(1))[:k]
    lane = np.argmax(n[rows] > 0, axis=1)
    rw2 = np.array(d.rw2)
    rw2[rows, lane] = 1e-6
    return dataclasses.replace(d, rw2=jnp.asarray(rw2))


def _ms(d):
    """Per-cell multisets of (n, rd3, x, y, z) of a dense state."""
    return multiset(d.n, (d.rd3,) + tuple(getattr(d, a) for a in POS))


def _same_cells(a, b, rtol=1e-10):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])     # cell, n, rd3
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=rtol)


# ------------------------------------------------------------ pack, unpack
def test_pack_and_unpack_carry_y():
    cfg, js = _jax_state()
    pcfg = port_cfg(cfg)
    assert pcfg.n_dims == 3 and dense_capable(pcfg)
    assert tdense.attrs_of(pcfg) == tdense.ATTRS + ("y",)
    st = port_flat_state(js)
    d = tdense.pack(pcfg, st, CAP)
    jd = _pack(cfg, js)
    assert int(d.overflow) == int(jd.overflow) == 0
    assert d.courant_y.shape == (N * (N + 1) * N,)
    np.testing.assert_array_equal(d.courant_y.numpy(),
                                  np.asarray(jd.courant_y))
    _same_cells(_ms(d), _ms(jd), rtol=0)
    back = tdense.unpack(pcfg, d, st)
    live = np.asarray(js.n) > 0
    want = np.sort(np.stack([np.asarray(getattr(js, a))[live]
                             for a in ("rd3", "x", "y", "z")]), axis=1)
    alive = back.n.numpy() > 0
    got = np.sort(np.stack([getattr(back, a).numpy()[alive]
                            for a in ("rd3", "x", "y", "z")]), axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        back.ijk.numpy()[alive],
        np.asarray(jhskpng.ijk_of_xyz(cfg, jnp.asarray(back.x.numpy()),
                                      jnp.asarray(back.y.numpy()),
                                      jnp.asarray(back.z.numpy())))[alive])


# ---------------------------------------------------------- transport
TRANSPORT_CASES = {
    "implicit": {},
    "euler": {"adve_scheme": lambda L: L.as_t.euler},
    "pred_corr": {"adve_scheme": lambda L: L.as_t.pred_corr},
    "implicit-open": {"open_side_walls": True},
    "pred_corr-open": {"adve_scheme": lambda L: L.as_t.pred_corr,
                       "open_side_walls": True},
    "euler-periodic_topbot": {"adve_scheme": lambda L: L.as_t.euler,
                              "periodic_topbot_walls": True},
}


def _port_transport(pcfg, pd, dt):
    return tstep.transport_plain(
        pcfg, dt, True, pd.n, pd.rw2, pd.rd3, pd.x, pd.z, pd.T, pd.p,
        pd.rhod, pd.eta, *tdense._row_courants(pcfg, pd),
        courants=(pd.courant_x, pd.courant_z, pd.courant_y),
        y3=tdense._y_axis(pcfg, pd))


@pytest.mark.parametrize("case", list(TRANSPORT_CASES))
def test_transport_matches_adve_sedi_bcnd(case):
    cfg, js = _jax_state(**TRANSPORT_CASES[case])
    dt = 40.0        # the 1 mm drops fall more than a cell
    d = _with_vt(cfg, _rain(_pack(cfg, js)))
    want = jdense.adve_sedi_bcnd(cfg, d, dt, True)
    pcfg, pd = port_cfg(cfg), port_state(d)
    n, x, z, vt, tgt, rowinfo, y = _port_transport(pcfg, pd, dt)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want.n))
    live = n.numpy() > 0
    for got, a in ((x, "x"), (y, "y"), (z, "z")):
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(getattr(want, a))[live],
                                   rtol=1e-10, err_msg=a)
    np.testing.assert_allclose(vt.numpy()[live], np.asarray(d.vt)[live],
                               rtol=1e-12)
    pud = (np.asarray(want.puddle) - np.asarray(d.puddle))[PUDDLE_SLOTS]
    info = rowinfo.sum(0).numpy()
    np.testing.assert_allclose(info[:2], pud[:2], rtol=1e-10)
    np.testing.assert_array_equal(info[2:4], pud[2:4])
    # a live droplet's target is the cell of its position, or its own row
    # with the row's far flag
    cell = np.asarray(jhskpng.ijk_of_xyz(cfg, want.x, want.y, want.z))
    rows = np.broadcast_to(np.arange(pcfg.n_cell)[:, None], live.shape)
    tg = tgt.numpy()
    near = tg == cell
    assert np.all(near[live] | ((tg == rows) & (rowinfo[:, 4:5].numpy() > 0)
                                )[live])
    assert np.all(tg[~live] == -1)
    if not pcfg.open_side_walls:
        assert info[4] > 0                           # far movers flagged


@pytest.mark.parametrize("case", ["ywrap", "far"])
def test_rebin_matches_jax_per_cell(case):
    """The merge (D's 3-D form's plain version) and the far-mover repair
    against JAX's rebin, per cell; the y-wrapping movers of the edge rows
    go through the merge, so without far movers no global re-bin runs."""
    cfg, js = _jax_state()
    d = _with_vt(cfg, _pack(cfg, js))
    dt = 1.0
    if case == "far":
        d, dt = _with_vt(cfg, _rain(d)), 40.0
    moved = jdense.adve_sedi_bcnd(cfg, d, dt, True)
    want = jdense.rebin(cfg, moved)
    pcfg, pd = port_cfg(cfg), port_state(d)
    n, x, z, vt, tgt, rowinfo, y = _port_transport(pcfg, pd, dt)
    pd = dataclasses.replace(pd, n=n, x=x, z=z, vt=vt, y=y)
    got = tdense.merge(pcfg, pd, tgt)
    far = bool(rowinfo[:, 4].sum() > 0)
    if far:
        got = tdense._rebin_global(pcfg, got)
    assert far == (case == "far") and got.rebins == int(far)
    _same_cells(_ms(got), _ms(want))
    assert int(got.overflow) == 0
    # droplets wrapped in y (known by rd3): they moved by most of the domain
    live0, live1 = np.asarray(d.n) > 0, got.n.numpy() > 0
    y0 = dict(zip(np.asarray(d.rd3)[live0], np.asarray(d.y)[live0]))
    wrapped = [abs(b - y0[r]) > N * 50.0 for r, b in
               zip(got.rd3.numpy()[live1], got.y.numpy()[live1])]
    assert sum(wrapped) >= 2


def test_rebin_x_plain_takes_27_neighbours_in_order(monkeypatch):
    """D's 3-D plain version on hand-made targets: each droplet lands in
    its target row, the own row's first, then MERGE_SOURCES_3D's order
    (x and y periodic, none beyond the z walls); the y plane rides; the
    destination rows taken in blocks of a few rows (as a full-width grid
    needs) give the same planes."""
    cfg = port_cfg(_jax_state()[0])
    n_cell, cap = cfg.n_cell, 64       # room for every row's droplets
    rng = np.random.default_rng(1)
    src, ok = (a.numpy() for a in tstep._merge_sources(cfg, n_cell, "cpu",
                                                       True))
    assert src.shape == (n_cell, 27)
    assert (src[:, 0] == np.arange(n_cell)).all()
    assert all(len(set(s[o])) == o.sum() for s, o in zip(src, ok))
    # two droplets a row to a neighbour (or the row itself), the rest dead
    tgt = np.full((n_cell, cap), -1, np.int32)
    for r in range(n_cell):
        tgt[r, :2] = rng.choice(src[r][ok[r]], 2)
    planes = [torch.tensor(rng.uniform(1, 2, (n_cell, cap)))
              for _ in range(7)]
    planes[0][torch.tensor(tgt) < 0] = 0.0
    y = torch.tensor(rng.uniform(0, 400, (n_cell, cap)))
    *out, drops = tstep.rebin_x_plain(cfg, *planes, torch.tensor(tgt),
                                      extra=(y,))
    assert not drops.any()
    monkeypatch.setattr(tstep, "MERGE_BLOCK", 5 * 27 * cap)
    blocks = tstep.rebin_x_plain(cfg, *planes, torch.tensor(tgt), extra=(y,))
    assert all(torch.equal(a, b) for a, b in zip(blocks, (*out, drops)))
    for r in range(n_cell):
        taken = [(a, b) for a in src[r][ok[r]] for b in range(cap)
                 if tgt[a, b] == r]
        k = len(taken)
        for got, plane in ((out[0], planes[0]), (out[7], y)):
            np.testing.assert_array_equal(
                got[r].numpy(), [plane[a, b].item() for a, b in taken]
                + [0.0] * (cap - k))


# ------------------------------------------------------- the whole step
def _xla_steps(cfg, d, th, rv, nt, dt=1.0, coal_phase=None):
    """The JAX XLA dense step, vt rebuilt from the saved cell state before
    each condensation (the kernel's convention; exact mode reads the vt
    each droplet carries, as the port's)."""
    c = lambda a: a[:, None]

    @jax.jit
    def cond(d, th, rv):
        if not cfg.exact_sstp_cond:
            T0, p0, _, eta0 = jdense._Tpr(cfg, d.sstp_tmp_th, d.sstp_tmp_rv,
                                          d.rhod, d.p)
            d = dataclasses.replace(d, vt=jvterm.vt_of(
                cfg, d.rw2, c(T0), c(p0), c(d.rhod), c(eta0)))
        return jdense.step_cond(cfg, d, th, rv, dt, 44.0)

    transport = jax.jit(lambda d: jdense.step_async(
        cfg, d, jnp.zeros((0,)), dt, 1, False, True))
    for s in range(nt):
        d, th, rv = cond(d, th, rv)
        if coal_phase is not None:
            d = coal_phase(s, d)
        d = transport(d)
    return d, th, rv


STEP_CASES = {
    "implicit": {},
    "pred_corr": {"adve_scheme": lambda L: L.as_t.pred_corr},
    "exact": {"exact_sstp_cond": True},
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_fused_matches_jax_xla(case):
    cfg, js = _jax_state(**STEP_CASES[case])
    d0 = _with_vt(cfg, _pack(cfg, js))
    th = jnp.full(cfg.n_cell, 289.0 * 1.01)      # supersaturating
    rv = jnp.full(cfg.n_cell, 7.5e-3)
    want, th_j, rv_j = _xla_steps(cfg, d0, th, rv, 5)
    pcfg, pd = port_cfg(cfg), port_state(d0)
    th_t, rv_t = t(th), t(rv)
    for _ in range(5):
        pd, th_t, rv_t = tdense.step_fused(pcfg, pd, th_t, rv_t, (), 1.0,
                                           44.0, 1, False, True)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-10)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(rv_j), rtol=1e-10)
    _same_cells(_ms(pd), _ms(want))
    if case == "exact":
        assert tdense.attrs_of(pcfg)[-5:] == ("y",) + tdense.EXACT_ATTRS
        assert pd.sd_th.shape == pd.n.shape
    assert pd.rebins == 0 and int(pd.overflow) == 0


@pytest.mark.parametrize("kernel,pairing", [
    ("geometric", "stride"), ("geometric", "sort"), ("onishi_hall", "stride")])
def test_coalescence_carries_y(kernel, pairing):
    """Two coalescing steps (radii x10; the geometric kernel x100, or
    onishi_hall at kernel_parameters [100] and dissipation rate 0, radii
    x30): the y plane rides kernel E's plain version's shuffles, against
    the JAX pair functions fed the port's draws in the port's lane
    order."""
    cfg, js = _jax_state(coal_switch=True,
                         kernel=lambda L: L.kernel_t[kernel],
                         kernel_parameters=[100.0])
    grow = 30.0 if kernel == "onishi_hall" else 10.0
    js = dataclasses.replace(js, rw2=js.rw2 * grow ** 2)
    d0 = _with_vt(cfg, _pack(cfg, js))
    pcfg, pd = port_cfg(cfg), port_state(d0)
    th = jnp.full(cfg.n_cell, 289.0)
    rv = jnp.full(cfg.n_cell, 7.5e-3)
    th_t, rv_t = t(th), t(rv)
    before = []
    for _ in range(2):
        before.append(pd)
        pd, th_t, rv_t = tdense.step_fused(pcfg, pd, th_t, rv_t, [100.0],
                                           1.0, 44.0, 2, True, True,
                                           coal_pairing=pairing)
    planes = ("n", "rw2", "rd3", "kpa", "x", "z", "y")

    eff = jcoal.load_efficiency_table(jl.kernel_t[kernel])

    def coal_phase(s, d):
        perm = _port_order(d, before[s])
        out = jax_coal_loop(
            cfg, [100.0], 2, 1.0, pd.rng_seed, s,
            tuple(np.take_along_axis(np.asarray(getattr(d, a)), perm, 1)
                  for a in planes),
            tuple(np.asarray(getattr(d, a))
                  for a in ("T", "p", "rhod", "eta", "dv")), pairing,
            eff_table=eff[0], r_max_um=eff[1])
        return dataclasses.replace(
            d, **{a: jnp.asarray(v) for a, v in zip(planes, out)})

    want, th_j, rv_j = _xla_steps(cfg, d0, th, rv, 2, coal_phase=coal_phase)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-10)
    _same_cells(_ms(pd), _ms(want))
    lost = float(d0.n.sum()) - float(pd.n.sum()) \
        - float(pd.puddle[OUT_PRTCL_NUM])
    assert lost > 0.0                                 # droplets collided


# ------------------------------------------------------ the public API
def _public(engine, do_coal, scheme):
    oi = _oi(tl, coal_switch=do_coal, sstp_cond=2, sstp_coal=2)
    if scheme == "pred_corr":
        oi.adve_scheme = tl.as_t.pred_corr
    if do_coal:
        oi.kernel = tl.kernel_t.geometric
    opts = tl.opts_t()
    opts.adve = opts.cond = opts.sedi = True
    opts.coal = do_coal
    opts.chem_dsl = False
    th, rv, rhod = _fields()
    p = tl.factory(tl.backend_t.serial, oi, engine=engine, **F64)
    p.init(th, rv, rhod, Cx=0.2 * np.ones((N + 1, N, N)),
           Cy=-0.15 * np.ones((N, N + 1, N)),
           Cz=-0.1 * np.ones((N, N, N + 1)))
    assert type(p).__name__ == ("particles_dense_t" if engine == "dense"
                                else "particles_t")
    for _ in range(4):
        p.step_sync(opts, th, rv, rhod)
        p.step_async(opts)
    out = dict(th=th, rv=rv)
    for k, power in (("sd", None), ("m0", 0), ("m3", 3)):
        p.diag_all()
        p.diag_sd_conc() if power is None else p.diag_wet_mom(power)
        out[k] = p.outbuf().copy()
    n, y = p.get_attr("n"), p.get_attr("y")
    out["tot"], out["y"] = n[n > 0].sum(), y[n > 0]
    return out


@pytest.mark.parametrize("do_coal,scheme", [
    (False, "implicit"), (True, "implicit"), (False, "pred_corr")])
def test_dense_public_3d(monkeypatch, do_coal, scheme):
    """tests/test_dense_public.py::test_dense_public_3d in the port: its
    dense front runs 3-D through the public factory and matches its flat
    engine, exactly with coalescence off (with the carried vt, see the
    module docstring), conservatively with it on (the JAX test's gates,
    th's at 1e-4)."""
    if not do_coal:
        _carried_vt(monkeypatch)
    d, f = _public("dense", do_coal, scheme), _public("flat", do_coal,
                                                      scheme)
    if not do_coal:
        np.testing.assert_allclose(d["th"], f["th"], rtol=1e-12)
        np.testing.assert_allclose(d["rv"], f["rv"], rtol=1e-10)
        np.testing.assert_allclose(d["m0"], f["m0"], rtol=1e-9)
        np.testing.assert_allclose(d["m3"], f["m3"], rtol=1e-9)
        np.testing.assert_array_equal(d["sd"], f["sd"])
        np.testing.assert_allclose(np.sort(d["y"]), np.sort(f["y"]),
                                   rtol=1e-12)
    else:
        # the engines draw other pairs (the flat engine shuffles a cell's
        # slots of the flat layout, the dense one a row), so th parts at
        # 2.3e-5 in one cell in 4 steps, where the JAX test's engines stay
        # within its 1e-5
        np.testing.assert_allclose(d["th"], f["th"], rtol=1e-4)
        assert d["tot"] == pytest.approx(f["tot"], rel=5e-2)
        np.testing.assert_allclose(d["m3"].sum(), f["m3"].sum(), rtol=1e-2)
    # y advection really moved SDs off the injection values
    assert np.unique(np.round(d["y"], 6)).size > N


def test_factory_gives_the_dense_front_in_3d():
    """JAX's factory picks the dense front for the 3-D grid on its
    accelerator, and so does the port's on a CUDA device (dense_capable);
    on the CPU "auto" is the flat engine and "dense" the front."""
    jcfg = jl.particles_t(jl.backend_t.serial, _oi(jl)).cfg
    jdense._supported(jcfg)
    oi = _oi(tl)
    assert dense_capable(tl.particles_t(tl.backend_t.serial, oi, **F64).cfg)
    assert type(tl.factory(tl.backend_t.serial, oi, **F64)).__name__ \
        == "particles_t"
    assert type(tl.factory(tl.backend_t.serial, oi, engine="dense",
                           **F64)).__name__ == "particles_dense_t"


def test_mesh_refuses_3d():
    """The x-slab mesh is 2-D, as the JAX package's (its y plane and
    courant_y empty, its re-binning 2-D: parallel/dense_mesh.py)."""
    from libcloudphxx_tpu_torch.parallel import dense_mesh
    cfg = tl.particles_t(tl.backend_t.serial, _oi(tl), **F64).cfg
    with pytest.raises(NotImplementedError, match="3-D.*serial dense"):
        dense_mesh.dense_step_sharded(cfg, [], 1, 1, False, True, 44.0)
