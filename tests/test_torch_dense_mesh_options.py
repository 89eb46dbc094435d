"""Port parity: the dense x-slab mesh (libcloudphxx_tpu_torch/parallel/
dense_mesh.py) under the options it took last: the turbulent (onishi)
kernels, pred_corr SD advection, a const-multi population's coalescence
(its sstp_coal growth) and the exact mode at one substep, on the CPU in
float64.

The case: 16x8 cells, sd_conc 8 (const-multi 1e11), sstp_cond =
sstp_coal = 2, beard77, n_sd_max 6144 (it splits over 2, 4, 6, 8 and 16
shards), the model's courants x50 (up to 0.15, so that droplets cross
slab edges every step) and radii x30 (so that droplets collide, as in
tests/test_torch_dense_onishi.py), 4 steps of which 1 is a spin-up.

Tolerances:
* Mesh against the port's serial dense engine: lane for lane, n, rd3,
  kappa and x equal, and so is each step's sstp_coal growth; rw2, vt, z
  (sedimentation moves it by vt), the exact mode's private planes, th, rv
  and the puddle at rtol 1e-12.  The mesh's re-binning takes a
  row's droplets in the serial kernel D's order (the halo columns of
  dense_mesh.rebin_sharded), so the coalescence pairings are the serial
  engine's too; on the card every plane is bitwise (chip_smoke.py phase
  14).  On the CPU PyTorch's float exp/log take a vector or a scalar path
  by an element's place in a tensor, and a shard's tensors are shorter
  than the grid's: rw2 parts in the last ulp (ROADMAP.md, "PyTorch's CPU
  float32 by element place"; 1e-24 absolute measured, and z an ulp),
  hence 1e-12.
* Against the JAX mesh (dense_mesh.dense_step_sharded under shard_map on
  conftest.py's 8 virtual devices), coalescence off (the JAX mesh's
  draws cannot be fed the port's): tests/test_torch_dense_mesh.py's gates
  (th rtol 1e-9, rv 2e-8, the zeroth moment and the puddle 1e-9, the third
  1e-6, per-cell SD counts exact).  The JAX mesh's XLA pipeline carries
  each droplet's vt from the previous step where the port rebuilds it
  from the droplet's cell (ROADMAP.md, "vt of droplets that changed
  cells"); at courant 0.15 that reached th at 2.1e-9 in one cell after 4
  steps, so these runs take 2.  Under pred_corr the JAX mesh runs its
  predictor in slab-local x unwrapped and clamps the predictor's cell to
  the slab's own columns (hskpng.ijk_of_xyz on the slab's config), so a
  droplet whose predictor leaves its slab reads the slab's edge (or
  padded, zero) courants there (ROADMAP.md, "Known behaviours of the
  reference"): one step is held droplet by droplet, x rtol 1e-12 and z
  1e-9 away from those droplets, which are counted and shown to follow
  the clamped corrector (rtol 1e-12).
* Kernel E's onishi form keyed by the global rows: a slice of rows with
  row0 equals the same rows of the whole grid bitwise, and the JAX pair
  functions fed the port's draws keyed alike (torch_parity.jax_coal_loop)
  give n and rd3 equal, rw2 and kappa rtol 1e-12 (tests/test_torch_coal.py
  gates).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_parity import jax_coal_loop, port_cfg, port_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models import mpdata as jmpdata
from libcloudphxx_tpu.parallel import decomp as jdecomp
from libcloudphxx_tpu.parallel import dense_mesh as jmesh
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.state import (OUT_COAL_OVERFLOW,
                                                 OUT_PRTCL_NUM)
from libcloudphxx_tpu_torch.ops import coal as tcoal
from libcloudphxx_tpu_torch.ops import step as tstep
from libcloudphxx_tpu_torch.parallel import (MeshRunner, decomp,
                                             dense_step_sharded, make_mesh,
                                             scatter_dense, shard_domains)

F64 = dict(device="cpu", dtype=torch.float64)
NX, NZ, SD_CONC, N_SD_MAX = 16, 8, 8, 6144
SCALE, NT, SPINUP = 50.0, 4, 1
N_JAX = 8                      # conftest.py's virtual devices
# steps against the JAX mesh (the vt convention, module docstring)
NT_JAX = 2
LAYOUTS = {"2": 2, "4": 4, "uneven": 6}     # 6: slabs 3,3,3,3,2,2
ONISHI = ("onishi_hall", "onishi_hall_davis_no_waals")
CONFIGS = ONISHI + ("pred_corr", "const_multi")
# the planes held equal on the CPU (the others at rtol 1e-12)
EXACT = ("n", "rd3", "kpa", "x")


def _opts(pkg, name, coal=True):
    """opts_init keywords of configuration ``name`` in ``pkg`` (the port's
    lgrngn or the JAX package's)."""
    oi = {"kernel_parameters": [100.0], "coal_switch": coal}
    if name in ONISHI:
        oi["kernel"] = pkg.kernel_t[name]
    elif name == "pred_corr":
        oi["adve_scheme"] = pkg.as_t.pred_corr
    elif name == "const_multi":
        oi.update(sd_const_multi=1e11, kernel_parameters=[1e8])
    elif name == "exact":
        oi["exact_sstp_cond"] = True
    return oi


def _kw(pkg, name, nx=NX, coal=True):
    return dict(nx=nx, nz=NZ, sd_conc=0 if name == "const_multi" else SD_CONC,
                sstp_cond=1 if name == "exact" else 2, sstp_coal=2,
                n_sd_max=N_SD_MAX, terminal_velocity=pkg.vt_t.beard77,
                opts_init_kw=_opts(pkg, name, coal))


def _model(name, **kw):
    return Kinematic2D(**_kw(tl, name, **kw), **F64)


def _scaled(d):
    """The case's start: courants x SCALE, radii x30."""
    return dataclasses.replace(d, courant_x=SCALE * d.courant_x,
                               courant_z=SCALE * d.courant_z,
                               rw2=900.0 * d.rw2)


_SERIAL = {}


def _serial(name):
    """The serial dense engine's run of ``name`` from the scaled courants:
    (state, th, rv, the sstp_coal growth after each step)."""
    if name not in _SERIAL:
        s = _model(name)
        s.dense_state = _scaled(s.dense_state)
        extra = []
        for i in range(NT):
            s.run_device_lgrngn(1, spinup=int(i < SPINUP), engine="dense")
            extra.append(s.prtcls._sstp_coal_extra)
        _SERIAL[name] = (s.dense_state, s.th, s.rv, extra)
    return _SERIAL[name]


def _mesh(name, n_shards):
    m = _model(name)
    r = MeshRunner(m, n_shards)
    r.load(_scaled(m.dense_state), m.th, m.rv)
    extra = []
    for i in range(NT):
        r.step(i < SPINUP)
        extra.append(m.prtcls._sstp_coal_extra)
    return m, r, extra


def _assert_lane_for_lane(r, m, serial, attrs=tdense.ATTRS):
    d_s, th_s, rv_s, _ = serial
    d_m = r.state()
    assert d_m.cap == d_s.cap
    for a in attrs:
        got, want = getattr(d_m, a), getattr(d_s, a)
        if a in EXACT:
            assert torch.equal(got, want), a
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                       atol=1e-300, err_msg=a)
    for got, want in ((m.th, th_s), (m.rv, rv_s), (d_m.puddle, d_s.puddle)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    assert int(d_m.overflow) == int(d_s.overflow) == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_matches_serial(name, layout):
    """Each configuration on 2, 4 and 6 uneven slabs: the serial engine's
    population lane for lane, SDs crossing slab edges every step, the
    droplets colliding, and the same sstp_coal growth step by step (a
    const-multi population grows it on both)."""
    serial = _serial(name)
    m, r, extra = _mesh(name, LAYOUTS[layout])
    if layout == "uneven":
        assert [dom.nxl for dom in r.doms] == [3, 3, 3, 3, 2, 2]
    _assert_lane_for_lane(r, m, serial)
    assert int(r.crossed) > 10 * NT
    assert extra == serial[3]
    assert (extra[-1] > 0) == (name == "const_multi")
    d0, d = _scaled(_model(name).dense_state), serial[0]
    lost = float(d0.n.sum() - d.n.sum() - d.puddle[OUT_PRTCL_NUM])
    assert lost > 0.0                                         # collided


def test_const_multi_growth_matches_serial():
    """sstp_coal grows by the requests of every shard's coalescence, read
    in the step's one host transfer and cleared from the puddles as the
    serial engine clears its own: on one shard and on four, step by step,
    as the serial engine's run_device_lgrngn."""
    serial = _serial("const_multi")
    for n_shards in (1, 4):
        m, r, extra = _mesh("const_multi", n_shards)
        assert extra == serial[3] and extra[-1] >= 2
        assert float(r.state().puddle[OUT_COAL_OVERFLOW]) == 0.0
        _assert_lane_for_lane(r, m, serial)


def test_exact_mode_at_one_substep_matches_serial():
    """exact_sstp_cond at sstp_cond = sstp_cond_act = 1 (kernel B, the
    private ambient planes refreshed from the cells and riding the
    re-binning and the ring): every plane, the private ones too, equals
    the serial engine's; with more substeps the mesh refuses, as the JAX
    mesh does."""
    serial = _serial("exact")
    m, r, _ = _mesh("exact", 6)
    _assert_lane_for_lane(r, m, serial, tdense.attrs_of(m.cfg))
    assert r.state().sd_th.shape == r.state().n.shape
    doms = shard_domains(m.cfg, make_mesh(2, "cpu"))
    for over in ({"sstp_cond": 2}, {"sstp_cond_act": 2}):
        cfg = dataclasses.replace(m.cfg, **over)
        with pytest.raises(NotImplementedError,
                           match="exact substepping with sstp_cond or "
                                 "sstp_cond_act > 1.*JAX mesh refuses"):
            dense_step_sharded(cfg, doms, 2, 64, False, True, 44.0)


def test_pred_corr_refused_on_one_column_slabs():
    """The halo-2 courant exchange reads two columns of every slab."""
    m = _model("pred_corr")
    with pytest.raises(NotImplementedError, match="at least 2 columns"):
        MeshRunner(m, NX)
    doms = shard_domains(m.cfg, make_mesh(NX, "cpu"))
    with pytest.raises(NotImplementedError, match="at least 2 columns"):
        dense_step_sharded(m.cfg, doms, 2, 64, False, True, 44.0)
    MeshRunner(m, NX // 2).run(1)               # slabs of two columns run


@pytest.mark.parametrize("name", ONISHI)
def test_onishi_draws_keyed_by_the_global_row(name):
    """Kernel E's onishi form (its plain version) with row0: rows r0.. of
    a slice draw, and collide, as the same rows of the whole grid, and as
    the JAX pair functions fed the port's draws keyed by those rows."""
    jm = JaxKinematic2D(micro="lgrngn", **_kw(jl, name))
    jcfg, oi = jm.prtcls.cfg, jm.prtcls.opts_init
    jd = jax.jit(jdense.pack, static_argnums=(0, 2))(jcfg, jm.prtcls.state,
                                                      64)
    d = port_state(jd)
    cfg = port_cfg(jcfg)
    names = ("n", "rw2", "rd3", "kpa", "x", "z")
    grown = dict(rw2=d.rw2 * 900.0)          # radii x30: droplets collide
    planes = tuple(grown.get(a, getattr(d, a)) for a in names)
    cells = tuple(getattr(d, a) for a in ("T", "p", "rhod", "eta", "dv"))
    params = list(oi.kernel_parameters)
    r0, r1 = 3 * NZ, 6 * NZ                 # the slab of columns 3-5
    for pairing in ("stride", "sort"):
        full = tcoal.coal_resident(cfg, params, 4, 1.0, 44, 5, *planes,
                                   *cells, pairing=pairing)
        part = tcoal.coal_resident(cfg, params, 4, 1.0, 44, 5,
                                   *(p[r0:r1] for p in planes),
                                   *(c[r0:r1] for c in cells),
                                   pairing=pairing, row0=r0)
        for a, b in zip(full, part):
            assert torch.equal(a[r0:r1], b)
        assert float(full[0].sum()) < float(d.n.sum())        # collided
        eff = jcoal.load_efficiency_table(jl.kernel_t[name])
        ref = jax_coal_loop(jcfg, oi.kernel_parameters, 4, 1.0, 44, 5,
                            tuple(p[r0:r1].numpy() for p in planes),
                            tuple(c[r0:r1].numpy() for c in cells), pairing,
                            eff_table=eff[0], r_max_um=eff[1], row0=r0)
        for a, got, want in zip(names, part, ref):
            if a in ("rw2", "kpa"):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                           err_msg=a)
            else:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=a)


# ---------------------------------------------------------------- JAX mesh
def _jax_case(name, nx=NX):
    """The JAX model of ``name`` without coalescence and its packed state
    with vt and the courants x SCALE."""
    jm = JaxKinematic2D(micro="lgrngn", **_kw(jl, name, nx, coal=False))
    jcfg = jm.prtcls.cfg
    d0 = jax.jit(jdense.pack, static_argnums=(0, 2))(jcfg, jm.prtcls.state,
                                                      64)
    c = lambda a: a[:, None]
    d0 = dataclasses.replace(
        d0, vt=jvterm.vt_of(jcfg, d0.rw2, c(d0.T), c(d0.p), c(d0.rhod),
                            c(d0.eta)),
        courant_x=SCALE * d0.courant_x, courant_z=SCALE * d0.courant_z)
    if jcfg.exact_sstp_cond:
        # JAX's pack keeps the flat State's per-SD snapshot in the cell
        # fields sstp_tmp_th/rv (dense.py:219-236); both meshes' per-cell
        # step reads the cells' (the port's pack puts the State's th, rv)
        d0 = dataclasses.replace(d0, sstp_tmp_th=jnp.asarray(jm.th).ravel(),
                                 sstp_tmp_rv=jnp.asarray(jm.rv).ravel())
    return jm, jcfg, d0


def _cfg_l(jcfg, widths):
    nx_pad = max(widths)
    return dataclasses.replace(jcfg, nx=nx_pad, n_cell=nx_pad * jcfg.nz,
                               x0=0.0, x1=nx_pad * jcfg.dx)


def _jax_mesh_run(jm, jcfg, d0, nt):
    """tests/test_dense_mesh.py's _mesh_runner on N_JAX shards,
    coalescence off: (gather_dense's result, th, rv)."""
    nx, nz = jcfg.nx, jcfg.nz
    widths = jdecomp.slab_widths(nx, N_JAX)
    mesh = jdecomp.make_mesh(N_JAX)
    dom = jdecomp.device_put_domains(jcfg, mesh, widths)
    step = jmesh.dense_step_sharded(_cfg_l(jcfg, widths), 2, 64, False, True,
                                    44.0)
    spec = jmesh.dense_specs()
    dom_spec = jdecomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    params = jnp.zeros((0,))
    shstep = jax.jit(jax.shard_map(
        lambda d, th, rv, dom_: step(d, th, rv, dom_, params, 1.0),
        mesh=mesh, in_specs=(spec, P("x"), P("x"), dom_spec),
        out_specs=(spec, P("x"), P("x")), check_vma=False))
    dm = jax.device_put(jmesh.scatter_dense(jcfg, d0, N_JAX, widths),
                        jax.tree_util.tree_map(
                            lambda s: NamedSharding(mesh, s), spec))
    th, rv = jnp.asarray(jm.th), jnp.asarray(jm.rv)
    adv = partial(jmpdata.advect, gc_x=jm.gc_x, gc_z=jm.gc_z, G=jm.G,
                  n_iters=2, fct=jm.fct)
    pad = lambda a: jmesh.pad_cell_field(jcfg, np.asarray(a).reshape(-1),
                                         N_JAX, widths)
    unpad = lambda a: jnp.asarray(jmesh.unpad_cell_field(
        jcfg, a, N_JAX, widths)).reshape(nx, nz)
    for _ in range(nt):
        dm, th_s, rv_s = shstep(dm, pad(adv(th)), pad(adv(rv)), dom)
        th, rv = unpad(th_s), unpad(rv_s)
    return jmesh.gather_dense(jcfg, dm, N_JAX, widths), np.asarray(th), \
        np.asarray(rv)


def _port_mesh_run(name, jm, d0, nt):
    m = Kinematic2D(**_kw(tl, name, jm.nx, coal=False), **F64)
    r = MeshRunner(m, N_JAX)
    r.load(port_state(d0), *(torch.tensor(np.asarray(a))
                             for a in (jm.th, jm.rv)))
    r.run(nt)
    return m, r


@pytest.mark.parametrize("name", CONFIGS[:2] + ("const_multi", "exact"))
def test_mesh_matches_jax_mesh(name):
    """The onishi, const-multi and exact configurations on the port's
    mesh and the JAX mesh, coalescence off, over NT_JAX steps."""
    jm, jcfg, d0 = _jax_case(name)
    res, th_j, rv_j = _jax_mesh_run(jm, jcfg, d0, NT_JAX)
    m, r = _port_mesh_run(name, jm, d0, NT_JAX)
    d = r.state()
    np.testing.assert_allclose(m.th.numpy(), th_j, rtol=1e-9)
    np.testing.assert_allclose(m.rv.numpy(), rv_j, rtol=2e-8)
    counts = np.bincount(res["cell"], minlength=jcfg.n_cell)
    np.testing.assert_array_equal((d.n > 0).sum(1).numpy(), counts)
    rhod_dv = (d.rhod * d.dv).numpy()
    for k, rtol in ((0, 1e-9), (3, 1e-6)):
        mom_j = np.bincount(res["cell"], res["n"] * res["rw2"] ** (k / 2),
                            minlength=jcfg.n_cell) / rhod_dv
        np.testing.assert_allclose(tdense.moment(d, 0.0, 1.0, k).numpy(),
                                   mom_j, rtol=rtol)
    np.testing.assert_allclose(d.puddle.numpy(), res["puddle"], rtol=1e-9)
    assert res["overflow"] == float(d.overflow) == 0.0
    assert int(r.crossed) > 0


def _predictor_leaves(cfg, d, widths):
    """Per live slot of the global DenseState ``d`` (rows in cell order):
    whether the euler predictor of pred_corr takes the droplet out of its
    slab's columns (no wrap, as the JAX mesh runs it)."""
    rows = torch.arange(d.n_cell)
    i_row = (rows // cfg.nz).double()[:, None]
    C_l, C_r = (c[:, None] for c in tdense._row_courants(cfg, d)[:2])
    x_p = d.x + (C_r - C_l) * (d.x - cfg.dx * i_row) + cfg.dx * C_l
    col = torch.floor(x_p / cfg.dx)
    slab = torch.tensor(np.repeat(np.arange(len(widths)), widths))[
        rows // cfg.nz]
    col0 = torch.tensor(np.cumsum([0] + widths[:-1]))[slab][:, None]
    nxl = torch.tensor(widths)[slab][:, None]
    return (d.n > 0) & ((col < col0) | (col >= col0 + nxl))


def test_pred_corr_mesh_matches_jax_mesh_away_from_parting_droplets():
    """One pred_corr step on both meshes, droplet by droplet (rd3 is
    unique): equal away from the droplets whose predictor leaves their
    slab, where the JAX mesh reads its own slab's courants (the module
    docstring); those are counted, and some of them part."""
    jm, jcfg, d0 = _jax_case("pred_corr")
    res, th_j, rv_j = _jax_mesh_run(jm, jcfg, d0, 1)
    m, r = _port_mesh_run("pred_corr", jm, d0, 1)
    cfg, d = m.cfg, r.state()
    np.testing.assert_allclose(m.th.numpy(), th_j, rtol=1e-9)
    np.testing.assert_allclose(m.rv.numpy(), rv_j, rtol=2e-8)
    d_init = port_state(d0)
    widths = decomp.slab_widths(NX, N_JAX)
    leaves = _predictor_leaves(cfg, d_init, widths)
    parting = set(d_init.rd3[leaves].tolist())
    live = (d.n > 0).numpy()
    port = dict(zip(d.rd3.numpy()[live], zip(d.x.numpy()[live],
                                             d.z.numpy()[live])))
    assert len(port) == len(res["rd3"]) == int(live.sum())    # unique rd3
    near, apart = 0, 0
    for rd3, x_j, z_j in zip(res["rd3"], res["x"], res["z"]):
        x_t, z_t = port[rd3]
        if rd3 in parting:
            apart += not np.isclose(x_t, x_j, rtol=1e-12, atol=0.0)
            continue
        np.testing.assert_allclose(x_t, x_j, rtol=1e-12)
        np.testing.assert_allclose(z_t, z_j, rtol=1e-9)
        near += 1
    assert len(parting) > 10 and apart > 0 and near > 10 * len(parting)
    assert int(r.crossed) > 0


def _jax_shard(dm, s, n_shards):
    """Shard ``s`` of the JAX mesh's concatenated DenseState."""
    def cut(a):
        a = np.asarray(a)
        if a.ndim and a.shape[0] and a.shape[0] % n_shards == 0:
            return jnp.asarray(a.reshape(n_shards, -1, *a.shape[1:])[s])
        return jnp.asarray(a)
    return jdense.DenseState(**{f.name: cut(getattr(dm, f.name))
                                for f in dataclasses.fields(dm)})


def test_pred_corr_transport_on_shards_matches_jax():
    """Kernel C's pred_corr form on a slab (its plain version, with the
    shards' halo-2 courants) against the JAX mesh's unwrapped pred_corr
    (dense.adve_sedi_bcnd with x_wrap=False) on every shard of 19 columns
    over 8 (slabs of 3 and of 2, padded to 3), lane for lane: x (the
    JAX's slab-local x plus the slab's start) rtol 1e-12, z 1e-12, away
    from the droplets whose predictor leaves the slab; there the JAX mesh
    is the corrector with its cell clamped to the slab's padded columns
    (the module docstring), which this test computes, and the port reads
    the neighbour's courants."""
    nx = 19
    jm, jcfg, d0 = _jax_case("pred_corr", nx)
    widths = jdecomp.slab_widths(nx, N_JAX)
    nx_pad, nz = max(widths), jcfg.nz
    cfg_l = _cfg_l(jcfg, widths)
    dm = jmesh.scatter_dense(jcfg, d0, N_JAX, widths)
    cfg = port_cfg(jcfg)
    doms = shard_domains(cfg, make_mesh(N_JAX, "cpu"))
    shards = scatter_dense(cfg, port_state(d0), doms)
    leaves = _predictor_leaves(cfg, port_state(d0), widths)
    n_apart, n_near = 0, 0
    for s, (dom, sh) in enumerate(zip(doms, shards)):
        js = _jax_shard(dm, s, N_JAX)
        jout = jdense.adve_sedi_bcnd(cfg_l, js, 1.0, False, x_wrap=False)
        n, x, z, *_ = tstep.transport_plain(
            cfg, 1.0, False, sh.n, sh.rw2, sh.rd3, sh.x, sh.z, sh.T, sh.p,
            sh.rhod, sh.eta, *tdense._row_courants(cfg, sh),
            slab=(dom.col0, dom.nxl), courants=(sh.halo_cx, sh.halo_cz))
        rows = slice(dom.col0 * nz, (dom.col0 + dom.nxl) * nz)
        own = slice(0, dom.nxl * nz)
        live = (n[own] > 0).numpy()
        part = leaves[rows].numpy() & live
        away = live & ~part
        x_j = np.asarray(jout.x)[own] + dom.col0 * cfg.dx
        z_j = np.asarray(jout.z)[own]
        np.testing.assert_allclose(x[own].numpy()[away], x_j[away],
                                   rtol=1e-12)
        np.testing.assert_allclose(z[own].numpy()[away], z_j[away],
                                   rtol=1e-12)
        # the JAX mesh's corrector: the predictor's cell clamped to the
        # slab's padded columns, read from its own courants
        x0 = np.asarray(js.x)[own]
        z0 = np.asarray(js.z)[own]
        cx = np.asarray(js.courant_x).reshape(nx_pad + 1, nz)
        cz = np.asarray(js.courant_z).reshape(nx_pad, nz + 1)
        i_r = (np.arange(dom.nxl * nz) // nz)[:, None]
        k_r = (np.arange(dom.nxl * nz) % nz)[:, None]
        x_p = x0 + (cx[i_r + 1, k_r] - cx[i_r, k_r]) * (x0 - cfg.dx * i_r) \
            + cfg.dx * cx[i_r, k_r]
        z_p = z0 + (cz[i_r, k_r + 1] - cz[i_r, k_r]) * (z0 - cfg.dz * k_r) \
            + cfg.dz * cz[i_r, k_r]
        z_p = np.clip(z_p, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
        i_m = np.clip(np.floor(x_p / cfg.dx), 0, nx_pad - 1).astype(int)
        k_m = np.clip(np.floor(z_p / cfg.dz), 0, nz - 1).astype(int)
        x_c = (x_p + x0 + (cx[i_m + 1, k_m] - cx[i_m, k_m])
               * (x_p - cfg.dx * i_m) + cfg.dx * cx[i_m, k_m]) / 2.0
        np.testing.assert_allclose(x_c[part], x_j[part] - dom.col0 * cfg.dx,
                                   rtol=1e-12)
        n_apart += int((~np.isclose(x[own].numpy()[part], x_j[part],
                                    rtol=1e-12, atol=0.0)).sum())
        n_near += int(away.sum())
    assert n_apart > 0 and n_near > 0
