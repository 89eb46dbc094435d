"""Port parity: the dense engine on the x-slab mesh
(libcloudphxx_tpu_torch/parallel: decomp, dense_mesh) on the CPU at
float64, against the port's serial dense engine and against the JAX
package's mesh (dense_mesh.dense_step_sharded under shard_map on the 8
virtual CPU devices of conftest.py).

The case is the JAX mesh test's (tests/test_dense_mesh.py): 19x10 cells,
sd_conc 24, sstp_cond 3, sstp_coal 2, beard77, 8 shards of 3,3,3,2,2,2,2,2
columns, 6 steps with sedimentation, RH_max 44.

Tolerances:
* Mesh against the port's serial engine, coalescence off: the JAX test's
  mesh-vs-serial gates (test_dense_mesh.py:146-155): th rtol 1e-12, rv
  1e-10, the per-cell multiset rtol 1e-9, the puddle 1e-9.  The port keeps
  x in global coordinates on the shards, so positions agree exactly.
* With coalescence (the geometric kernel times 100, so that droplets
  collide in the first step): the shards draw as the serial step's rows
  (kernel E's row0), so the first step is equal per cell at the same
  gates; the mesh's re-binning takes each row's droplets in the serial
  kernel D's order (the halo columns of dense_mesh.rebin_sharded), so the
  lane orders, and with them the pairings, stay the serial engine's:
  after 6 steps n, rd3, kappa and x lane for lane equal, rw2, vt and z at
  rtol 1e-12 (on the CPU a shard's shorter tensors take PyTorch's other
  exp/log path for some elements: the last ulp), th and rv 1e-12.
* Slabs of two and of one column (10 and 19 shards: every shard re-binned
  globally) against the serial engine at the same gates, and two-column
  slabs (16 columns over 8 shards) against the JAX mesh as below, with
  the third moment at rtol 1e-5 there (one cell reads 3.6e-6).
* Against the JAX mesh: the JAX mesh runs its XLA dense pipeline here,
  which carries each droplet's vt from the previous step, while the port
  rebuilds it from the droplet's cell as the TPU kernel does; the
  tolerances tests/test_torch_kinematic.py states for that difference
  (:18-22): th rtol 1e-9, rv 2e-8, the third moment 1e-6, the zeroth
  moment and the puddle 1e-9, per-cell SD counts exact.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_parity import multiset, port_cfg, port_state, transport_case

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models import mpdata as jmpdata
from libcloudphxx_tpu.parallel import decomp as jdecomp
from libcloudphxx_tpu.parallel import dense_mesh as jmesh
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import vt_t
from libcloudphxx_tpu_torch.ops import coal as tcoal
from libcloudphxx_tpu_torch.ops import philox
from libcloudphxx_tpu_torch.ops import step as tstep
from libcloudphxx_tpu_torch.parallel import (MeshRunner, dense_mesh, decomp,
                                             dense_step_sharded, gather_dense,
                                             gather_state, make_mesh,
                                             pad_cell_field, scatter_dense,
                                             shard_domains, unpad_cell_field)

N_SHARDS, NX, NZ, SD_CONC, NT = 8, 19, 10, 24, 6
WIDTHS = [3, 3, 3, 2, 2, 2, 2, 2]


def _model(coal=False, nx=NX, **oi_kw):
    kw = {"coal_switch": coal, **oi_kw}
    if coal:
        kw.setdefault("kernel_parameters", [100.0])
    return Kinematic2D(nx=nx, nz=NZ, sd_conc=SD_CONC, sstp_cond=3,
                       sstp_coal=2, n_sd_max=SD_CONC * nx * NZ,
                       terminal_velocity=vt_t.beard77, opts_init_kw=kw,
                       device="cpu", dtype=torch.float64)


def _pop(d):
    """The per-cell multiset (cell, n, rd3, kpa, x, z, rw2, vt)."""
    return multiset(d.n, (d.rd3, d.kpa, d.x, d.z, d.rw2, d.vt))


def _serial(coal=False, nt=NT, **oi_kw):
    m = _model(coal, **oi_kw)
    m.run_device_lgrngn(nt, engine="dense")
    return m


def _mesh(coal=False, nt=NT, n_shards=N_SHARDS, **kw):
    oi_kw = kw.pop("oi_kw", {})
    m = _model(coal, **oi_kw)
    r = MeshRunner(m, n_shards, **kw)
    n0 = int((m.dense_state.n > 0).sum())
    r.run(nt)
    return m, r, n0


def _assert_same(r, mesh_model, serial_model):
    """The JAX test's mesh-vs-serial gates."""
    d_m, d_s = r.state(), serial_model.dense_state
    np.testing.assert_allclose(mesh_model.th.numpy(), serial_model.th.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(mesh_model.rv.numpy(), serial_model.rv.numpy(),
                               rtol=1e-10)
    a, b = _pop(d_m), _pop(d_s)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :6], b[:, :6])   # cell n rd3 kpa x z
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(d_m.puddle.numpy(), d_s.puddle.numpy(),
                               rtol=1e-9)
    assert int(d_m.overflow) == int(d_s.overflow) == 0


@pytest.fixture(scope="module")
def serial_run():
    return _serial()


@pytest.fixture(scope="module")
def mesh_run():
    return _mesh()


def test_mesh_matches_serial_without_coalescence(mesh_run, serial_run):
    m, r, _ = mesh_run
    _assert_same(r, m, serial_run)
    assert int(r.crossed) > 0


def test_one_shard_mesh_matches_serial_periodic_run(serial_run):
    """One shard is the ring to itself: the periodic wrap rides it."""
    m, r, _ = _mesh(n_shards=1)
    _assert_same(r, m, serial_run)
    assert int(r.crossed) > 0           # wrapped across x = 0 / x1


@pytest.mark.parametrize("n_shards,nx_pad", [(10, 2), (19, 1)])
def test_mesh_on_narrow_slabs_matches_serial(serial_run, n_shards, nx_pad):
    """Slabs of one and two columns: rebin_sharded re-bins every shard
    globally (no merge, dense._rebin_global on each shard's rows), and the
    mesh still equals the serial engine."""
    assert max(decomp.slab_widths(NX, n_shards)) == nx_pad
    calls = []
    real = tdense._rebin_global

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    tdense._rebin_global = spy
    try:
        m, r, _ = _mesh(n_shards=n_shards)
    finally:
        tdense._rebin_global = real
    assert len(calls) == n_shards * NT
    _assert_same(r, m, serial_run)
    assert int(r.crossed) > 0


def test_open_side_walls_kill_only_at_the_global_edges():
    """Under open side walls droplets leaving the domain die at x0 and x1
    only; those crossing an inner slab edge move on: the mesh equals the
    serial engine, which kills at the walls and moves the rest."""
    kw = {"open_side_walls": True}
    serial = _serial(**kw)
    m, r, n0 = _mesh(oi_kw=kw)
    _assert_same(r, m, serial)
    assert int((r.state().n > 0).sum()) < n0     # some left the domain
    assert int(r.crossed) > 0


def test_mesh_with_coalescence():
    """The first step equals the serial one per cell (the shards draw as
    the serial rows); over 6 steps the population stays the serial
    engine's lane for lane (the module docstring), where the JAX test
    holds conservation and th to 2e-2 and 1e-4."""
    m1, r1, _ = _mesh(coal=True, nt=1)
    s1 = _serial(coal=True, nt=1)
    _assert_same(r1, m1, s1)
    d0 = _model(coal=True).dense_state
    assert float(s1.dense_state.n.sum()) < float(d0.n.sum())   # collided

    m, r, _ = _mesh(coal=True)
    s = _serial(coal=True)
    d_m, d_s = r.state(), s.dense_state
    assert int(d_m.overflow) == 0
    for a in tdense.ATTRS:
        got, want = getattr(d_m, a).numpy(), getattr(d_s, a).numpy()
        if a in ("n", "rd3", "kpa", "x"):
            np.testing.assert_array_equal(got, want, err_msg=a)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300,
                                       err_msg=a)
    np.testing.assert_allclose(m.th.numpy(), s.th.numpy(), rtol=1e-12)
    np.testing.assert_allclose(m.rv.numpy(), s.rv.numpy(), rtol=1e-12)


def test_crossers_are_counted():
    """``crossed`` is the number of SDs that changed slab in the step,
    found by each SD's dry volume (unique here)."""
    m = _model()
    r = MeshRunner(m, N_SHARDS)
    slab = np.repeat(np.arange(N_SHARDS), WIDTHS)

    def slab_of():
        d = r.state()
        alive = (d.n > 0).numpy()
        cell = np.broadcast_to(np.arange(d.n_cell)[:, None], alive.shape)
        return dict(zip(d.rd3.numpy()[alive], slab[cell[alive] // NZ]))

    before = slab_of()
    assert len(before) == int((m.dense_state.n > 0).sum())    # unique rd3
    crossed = 0
    for _ in range(3):
        r.crossed.zero_()
        r.step()
        after = slab_of()
        moved = sum(before[k] != after[k] for k in after)
        assert int(r.crossed) == moved
        crossed += moved
        before = after
    assert crossed > 0


def test_a_small_buffer_counts_overflow():
    """Movers that do not fit the buffer are dropped and counted, never
    lost silently (the flow sped up tenfold, 4 movers a buffer)."""
    m = _model()
    d = m.dense_state
    n0 = int((d.n > 0).sum())
    r = MeshRunner(m, N_SHARDS, buf=4)
    r.load(dataclasses.replace(d, courant_x=10.0 * d.courant_x), m.th, m.rv)
    r.run(2)
    d = r.state()
    ovf = int(d.overflow)
    assert ovf > 0 and int(r.crossed) > 0
    assert int((d.n > 0).sum()) + ovf == n0


def test_scatter_gather_round_trip():
    m = _model()
    d = dataclasses.replace(m.dense_state,
                            puddle=torch.arange(16, dtype=torch.float64))
    doms = shard_domains(m.cfg, make_mesh(N_SHARDS, "cpu"))
    shards = scatter_dense(m.cfg, d, doms)
    assert [len(s.n) for s in shards] == [3 * NZ] * N_SHARDS
    g = gather_state(m.cfg, shards, doms)
    for f in tdense.ATTRS + ("rhod", "p", "T", "RH", "eta", "dv",
                             "sstp_tmp_th", "sstp_tmp_rv", "courant_x",
                             "courant_z", "puddle", "overflow"):
        assert torch.equal(getattr(g, f), getattr(d, f)), f
    th = torch.rand(NX * NZ, dtype=torch.float64)
    assert torch.equal(unpad_cell_field(m.cfg, pad_cell_field(m.cfg, th,
                                                              doms), doms),
                       th)


def test_layout_matches_jax(jax_case):
    """slab_widths, the padded cell fields, the domains and gather_dense
    against the JAX package's on the same state (the JAX domains are
    slab-local, the port's global)."""
    jm, jcfg, jd0 = jax_case
    cfg = port_cfg(jcfg)
    assert decomp.slab_widths(NX, N_SHARDS) == WIDTHS \
        == jdecomp.slab_widths(NX, N_SHARDS)
    assert dataclasses.asdict(decomp.local_config(cfg, N_SHARDS)) \
        == dataclasses.asdict(port_cfg(jdecomp.local_config(jcfg, N_SHARDS)))
    _lo, _hi, w = jdecomp.shard_domains(jcfg, N_SHARDS)
    doms = shard_domains(cfg, make_mesh(N_SHARDS, "cpu"))
    assert [dd.col0 for dd in doms] == list(np.cumsum([0] + list(w[:-1])))
    assert [dd.nxl for dd in doms] == list(w)
    th = np.asarray(jm.th).reshape(-1) + np.arange(NX * NZ)
    np.testing.assert_array_equal(
        torch.cat(pad_cell_field(cfg, torch.tensor(th), doms)).numpy(),
        np.asarray(jmesh.pad_cell_field(jcfg, th, N_SHARDS)))
    res_j = jmesh.gather_dense(jcfg, jmesh.scatter_dense(jcfg, jd0, N_SHARDS),
                               N_SHARDS)
    res_t = gather_dense(cfg, scatter_dense(cfg, port_state(jd0), doms), doms)
    cols = lambda r: [r[k] for k in ("cell", "n", "rd3", "kpa", "x", "z",
                                     "rw2")]
    a, b = (_sorted_rows(cols(r)) for r in (res_t, res_j))
    np.testing.assert_allclose(a, b, rtol=1e-12)


def _sorted_rows(cols):
    """The columns ``cols`` as rows, sorted lexicographically."""
    order = np.lexsort([np.asarray(c) for c in cols[::-1]])
    return np.stack([np.asarray(c)[order] for c in cols], 1)


@pytest.mark.parametrize("nxl,n_edge,rows", [
    (3, 1, [0, 2]), (2, 1, [0, 1]), (1, 1, [0]), (4, 2, [0, 1, 2, 3]),
    (3, 2, [0, 1, 2]), (2, 2, [0, 1]), (5, 2, [0, 1, 3, 4])])
def test_edge_rows_stay_disjoint(nxl, n_edge, rows):
    """The two edge blocks never hold a row twice, on slabs narrower than
    both (JAX's dynamic_slice would clamp the second onto the first on a
    one-column slab)."""
    nz, nx_pad = 2, max(nxl, 3)
    mat = torch.arange(nx_pad * nz)[:, None]
    got = dense_mesh._edge_rows(mat, nz, nxl, n_edge)[:, 0].tolist()
    want = [c * nz + k for c in rows for k in range(nz)]
    assert [g for g in got if g < nxl * nz] == want
    assert len(set(got)) == len(got)


# ---------------------------------------------------------------- JAX mesh
def _jax_case(nx):
    jm = JaxKinematic2D(nx=nx, nz=NZ, micro="lgrngn", sd_conc=SD_CONC,
                        sstp_cond=3, sstp_coal=2,
                        n_sd_max=SD_CONC * nx * NZ,
                        terminal_velocity=jl.vt_t.beard77)
    jcfg = jm.prtcls.cfg
    d0 = jax.jit(jdense.pack, static_argnums=(0, 2))(jcfg, jm.prtcls.state,
                                                      64)
    c = lambda a: a[:, None]
    d0 = dataclasses.replace(d0, vt=jvterm.vt_of(jcfg, d0.rw2, c(d0.T),
                                                 c(d0.p), c(d0.rhod),
                                                 c(d0.eta)))
    return jm, jcfg, d0


@pytest.fixture(scope="module")
def jax_case():
    return _jax_case(NX)


def _jax_mesh_run(jm, jcfg, d0, nt):
    """tests/test_dense_mesh.py's _mesh_runner, coalescence off."""
    nx = jcfg.nx
    widths = jdecomp.slab_widths(nx, N_SHARDS)
    cfg_l = dataclasses.replace(jcfg, nx=max(widths),
                                n_cell=max(widths) * NZ, x0=0.0,
                                x1=max(widths) * jcfg.dx)
    mesh = jdecomp.make_mesh(N_SHARDS)
    dom = jdecomp.device_put_domains(jcfg, mesh, widths)
    params = jnp.zeros((0,))
    step = jmesh.dense_step_sharded(cfg_l, 2, 64, False, True, 44.0)
    spec = jmesh.dense_specs()
    dom_spec = jdecomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    shstep = jax.jit(jax.shard_map(
        lambda d, th, rv, dom_: step(d, th, rv, dom_, params, 1.0),
        mesh=mesh, in_specs=(spec, P("x"), P("x"), dom_spec),
        out_specs=(spec, P("x"), P("x")), check_vma=False))
    dm = jax.device_put(jmesh.scatter_dense(jcfg, d0, N_SHARDS, widths),
                        jax.tree_util.tree_map(
                            lambda s: NamedSharding(mesh, s), spec))
    th, rv = jnp.asarray(jm.th), jnp.asarray(jm.rv)
    adv = partial(jmpdata.advect, gc_x=jm.gc_x, gc_z=jm.gc_z, G=jm.G,
                  n_iters=2, fct=jm.fct)
    pad = lambda a: jmesh.pad_cell_field(jcfg, np.asarray(a).reshape(-1),
                                         N_SHARDS, widths)
    unpad = lambda a: jnp.asarray(jmesh.unpad_cell_field(
        jcfg, a, N_SHARDS, widths)).reshape(nx, NZ)
    for _ in range(nt):
        dm, th_s, rv_s = shstep(dm, pad(adv(th)), pad(adv(rv)), dom)
        th, rv = unpad(th_s), unpad(rv_s)
    return jmesh.gather_dense(jcfg, dm, N_SHARDS, widths), np.asarray(th), \
        np.asarray(rv)


def _check_against_jax_mesh(jm, jcfg, d0, rtol_m3=1e-6):
    res, th_j, rv_j = _jax_mesh_run(jm, jcfg, d0, NT)
    m = _model(nx=jcfg.nx)
    r = MeshRunner(m, N_SHARDS)
    r.load(port_state(d0), *(torch.tensor(np.asarray(a)) for a in (jm.th,
                                                                   jm.rv)))
    r.run(NT)
    d = r.state()
    np.testing.assert_allclose(m.th.numpy(), th_j, rtol=1e-9)
    np.testing.assert_allclose(m.rv.numpy(), rv_j, rtol=2e-8)
    n_cell = jcfg.n_cell
    counts = np.bincount(res["cell"], minlength=n_cell)
    np.testing.assert_array_equal((d.n > 0).sum(1).numpy(), counts)
    rhod_dv = (d.rhod * d.dv).numpy()
    for k, rtol in ((0, 1e-9), (3, rtol_m3)):
        mom_j = np.bincount(res["cell"], res["n"] * res["rw2"] ** (k / 2),
                            minlength=n_cell) / rhod_dv
        np.testing.assert_allclose(tdense.moment(d, 0.0, 1.0, k).numpy(),
                                   mom_j, rtol=rtol)
    np.testing.assert_allclose(d.puddle.numpy(), res["puddle"], rtol=1e-9)
    assert res["overflow"] == float(d.overflow) == 0.0
    assert int(r.crossed) > 0
    return m, r


def test_mesh_matches_jax_mesh(jax_case):
    _check_against_jax_mesh(*jax_case)


def test_two_column_slabs_match_jax_mesh():
    """nx_pad 2 against the JAX mesh: 16 columns over the 8 virtual
    devices (the JAX mesh presents a one-column slab's edge row twice, so
    nx_pad 1 is compared with the serial engine only).  The vt convention
    (module docstring) reaches one cell's third moment at 3.6e-6 here: the
    port's mesh equals its serial engine bitwise on the same grid, so the
    difference is the engines', not the mesh's; moment 3 rtol 1e-5."""
    assert max(decomp.slab_widths(16, N_SHARDS)) == 2
    jm, jcfg, d0 = _jax_case(16)
    m, r = _check_against_jax_mesh(jm, jcfg, d0, rtol_m3=1e-5)
    s = _model(nx=16)
    s.dense_state = port_state(d0)
    s.th, s.rv = (torch.tensor(np.asarray(a)) for a in (jm.th, jm.rv))
    s.run_device_lgrngn(NT, engine="dense")
    _assert_same(r, m, s)


# ------------------------------------------------------- the pieces alone
@pytest.mark.parametrize("col0,ncol", [(0, 2), (3, 2), (5, 3)])
def test_transport_unwrapped_form(col0, ncol):
    """Kernel C's unwrapped form (plain version) on the rows of one slab
    of 3 columns, ncol of them the shard's own, against the wrapped form
    on the whole grid: z, vt, n and the puddle partials alike (the open
    side walls are off, so nobody dies at them), x not wrapped; a droplet
    outside the shard's columns or the domain gets target -1 and no far
    flag; the others' targets are local, by the near test without its
    x-wrap clause, and a far mover keeps its row and flags it."""
    cfg, planes, cells = transport_case(8, 6, 32)
    n, rw2, rd3, kpa, x, z = planes
    C = tuple(8.0 * c for c in cells[4:])       # some cross two faces
    nz, nx_pad = 6, 3
    rows = slice(col0 * nz, (col0 + nx_pad) * nz)
    sl = lambda a: a[rows]
    wrapped = tstep.transport(cfg, 1.0, True, n, rw2, rd3, x, z,
                              *cells[:4], *C)
    n_u, x_u, z_u, vt_u, tgt_u, info_u = tstep.transport(
        cfg, 1.0, True, *map(sl, (n, rw2, rd3, x, z)),
        *map(sl, cells[:4] + C), slab=(col0, ncol))
    n_w, x_w, z_w, vt_w, _, info_w = (a[rows] for a in wrapped)
    for a, b in ((n_u, n_w), (z_u, z_w), (vt_u, vt_w),
                 (info_u[:, :4], info_w[:, :4])):
        assert torch.equal(a, b)
    live = n_u > 0
    out = (x_u < cfg.x0) | (x_u >= cfg.x1)
    assert torch.equal(torch.where(out, tstep.wrap_x(cfg, x_u), x_u)[live],
                       x_w[live])
    i_t, k_t = tstep.column_of(cfg, x_u), tstep.level_of(cfg, z_u)
    leaves = live & (out | (i_t < col0) | (i_t >= col0 + ncol))
    assert bool(leaves.any()) and bool((tgt_u[leaves] == -1).all())
    r = torch.arange(nx_pad * nz)[:, None]
    near = (torch.abs(i_t - (col0 + r // nz)) <= 1) \
        & (torch.abs(k_t - r % nz) <= 1)
    want = torch.where(near, (i_t - col0) * nz + k_t, r.double()).int()
    stay = live & ~leaves
    assert torch.equal(tgt_u[stay], want[stay])
    assert torch.equal(info_u[:, 4] > 0, (stay & ~near).any(1))
    assert bool((stay & ~near).any())
    assert bool((tgt_u[~live] == -1).all())
    with pytest.raises(ValueError, match="needs some transport"):
        tstep.transport(cfg, 1.0, False, n, rw2, rd3, x, z, *cells,
                        do_adve=False, slab=(0, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tstep.transport(cfg, 1.0, True, n, rw2, rd3, x, z, *cells,
                        slab=(0, 9))


def test_coalescence_draws_keyed_by_the_global_row():
    """philox.draw and kernel E's plain version with row0: rows r0.. of a
    slice draw, and collide, as the same rows of the whole grid."""
    bits = philox.draw(7, 3, 1, philox.SHUFFLE, 40, 16)
    assert torch.equal(philox.draw(7, 3, 1, philox.SHUFFLE, 10, 16,
                                   row0=25), bits[25:35])
    m = _model(coal=True)
    d, cfg = m.dense_state, m.cfg
    cells = (d.T, d.p, d.rhod, d.eta, d.dv)
    planes = (d.n, d.rw2 * 100.0, d.rd3, d.kpa, d.x, d.z)
    params = m.opts_init.kernel_parameters
    for pairing in ("stride", "sort"):
        full = tcoal.coal_resident(cfg, params, 4, 1.0, 44, 5, *planes,
                                   *cells, pairing=pairing)
        part = tcoal.coal_resident(cfg, params, 4, 1.0, 44, 5,
                                   *(p[60:100] for p in planes),
                                   *(c[60:100] for c in cells),
                                   pairing=pairing, row0=60)
        for a, b in zip(full, part):
            assert torch.equal(a[60:100], b)
        assert float(full[0].sum()) < float(d.n.sum())        # collided


def test_refusals():
    m = _model()
    doms = shard_domains(m.cfg, make_mesh(N_SHARDS, "cpu"))
    exact = dataclasses.replace(m.cfg, exact_sstp_cond=True)
    with pytest.raises(NotImplementedError, match="exact substepping"):
        dense_step_sharded(exact, doms, 2, 64, False, True, 44.0)
    ice = dataclasses.replace(m.cfg, ice_switch=True)
    with pytest.raises(NotImplementedError, match="ice"):
        dense_step_sharded(ice, doms, 2, 64, False, True, 44.0)
    with pytest.raises(ValueError, match="buf"):
        dense_step_sharded(m.cfg, doms, 2, 0, False, True, 44.0)
    with pytest.raises(ValueError, match="cover"):
        shard_domains(m.cfg, make_mesh(20, "cpu"))        # empty slabs
    with pytest.raises(ValueError, match="n_shards"):
        make_mesh(0)
    with pytest.raises(ValueError, match="n_sd_max"):
        decomp.local_config(m.cfg, 7)
    assert make_mesh(4, ["cpu", "meta"]) == [torch.device("cpu")] * 2 \
        + [torch.device("meta")] * 2
