"""The port's multi-device front (libcloudphxx_tpu_torch/parallel/multi.py
particles_multi_t over decomp's slabs, courant halos and ring migration)
against the port's serial flat engine and against the JAX package's
particles_multi_t, on the CPU in float64.

Every case of tests/test_parallel.py and the two multichip cases of
tests/test_host_model.py, with their tolerances (th atol 1e-9, rv atol
1e-12, the population rtol 1e-9): the port's shards sit on the CPU, the
JAX front's on conftest's 8 virtual devices.  The JAX front steps from its
own initial state, converted into the port's shards
(convert.shard_states_from_numpy), which the test first holds against
the port's own initial shards.  Coalescence stays off, as in the JAX
tests: each shard draws its own numbers (ops/philox.shard_key).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_parity import port_cfg

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu import parallel as jparallel
from libcloudphxx_tpu.common.chem import chem_species_t as jcs
from libcloudphxx_tpu.lgrngn.state import StaticConfig as JStaticConfig
from libcloudphxx_tpu.lgrngn.state import empty_state as jempty_state
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch import parallel as tparallel
from libcloudphxx_tpu_torch.common.chem import chem_species_t as tcs
from libcloudphxx_tpu_torch.convert import shard_states_from_numpy
from libcloudphxx_tpu_torch.lgrngn.state import (OUT_MIGRATION_OVERFLOW,
                                                 TENSOR_FIELDS)
from libcloudphxx_tpu_torch.lgrngn.state import empty_state as tempty_state
from libcloudphxx_tpu_torch.ops import philox
from libcloudphxx_tpu_torch.parallel import decomp

F64 = dict(device="cpu", dtype=torch.float64)


def lognormal(lnr):
    return (60e6 * np.exp(-(lnr - np.log(0.02e-6)) ** 2
                          / 2 / np.log(1.4) ** 2)
            / np.log(1.4) / np.sqrt(2 * np.pi))


def make_cfg(nx=16, nz=4, n_sd=256):
    """test_parallel.make_cfg: the JAX StaticConfig and the port's."""
    oi = jl.opts_init_t()
    oi.nx, oi.nz = nx, nz
    oi.dx = oi.dz = 1.0
    oi.x1, oi.z1 = float(nx), float(nz)
    oi.dt = 1.0
    oi.n_sd_max = n_sd
    oi.sd_conc = 1
    oi.kernel = jl.kernel_t.geometric
    oi.terminal_velocity = jl.vt_t.beard77fast
    oi.coal_switch = False
    jcfg = JStaticConfig.from_opts_init(oi)
    return jcfg, port_cfg(jcfg)


def test_slab_widths_uneven():
    for nx, s, want in ((16, 8, [2] * 8), (14, 4, [4, 4, 3, 3])):
        assert tparallel.slab_widths(nx, s) == want \
            == jparallel.slab_widths(nx, s)
    assert sum(tparallel.slab_widths(61, 8)) == 61


def test_local_config_split():
    jcfg, cfg = make_cfg()
    cfg_l = tparallel.local_config(cfg, 8)
    assert cfg_l.nx == cfg.nx // 8 and cfg_l.n_sd_max == cfg.n_sd_max // 8
    assert cfg_l.x0 == 0.0 and cfg_l.x1 == pytest.approx(cfg_l.nx * cfg.dx)
    for widths in (None, [5, 3, 4, 4]):
        n = 8 if widths is None else 4
        assert dataclasses.asdict(tparallel.local_config(cfg, n, widths)) \
            == dataclasses.asdict(port_cfg(jparallel.local_config(
                jcfg, n, widths)))
    # the Lagrangian domains of a cropped domain, as JAX's
    crop = dataclasses.replace(cfg, x0=0.5, x1=15.25)
    jcrop = dataclasses.replace(jcfg, x0=0.5, x1=15.25)
    doms = tparallel.shard_domains(crop, tparallel.make_mesh(4, "cpu"))
    lo, hi, w = jparallel.shard_domains(jcrop, 4)
    np.testing.assert_array_equal([d.lo for d in doms], lo)
    np.testing.assert_array_equal([d.hi for d in doms], hi)
    assert [d.nxl for d in doms] == list(w)


def _hand(cfg_l, n_live, x, z, ids):
    """test_parallel._hand_state's arrays."""
    n = np.zeros(cfg_l.n_sd_max)
    n[:n_live] = ids
    xs, zs = np.zeros(cfg_l.n_sd_max), np.zeros(cfg_l.n_sd_max)
    xs[:n_live], zs[:n_live] = x, z
    ijk = (xs / cfg_l.dx).astype(np.int64) * cfg_l.nz \
        + (zs / cfg_l.dz).astype(np.int64)
    return dict(n=n, x=xs, z=zs, ijk=np.where(n > 0, ijk, 0),
                rd3=np.full(cfg_l.n_sd_max, 1e-21),
                rw2=np.full(cfg_l.n_sd_max, 1e-12),
                kpa=np.full(cfg_l.n_sd_max, 0.61),
                th=np.full(cfg_l.n_cell, 290.0),
                rv=np.full(cfg_l.n_cell, 7e-3), rhod=np.ones(cfg_l.n_cell),
                dv=np.full(cfg_l.n_cell, cfg_l.dx * cfg_l.dy * cfg_l.dz))


def _both_migrate(jcfg, widths, hands, shift, buf):
    """Shift the live SDs' x by ``shift`` and migrate, in the JAX package
    (under shard_map on the virtual devices) and in the port: both
    results as (n, x) of shape (shards, slots)."""
    S = len(widths)
    jcfg_l = jparallel.local_config(jcfg, S, widths)
    states = [dataclasses.replace(jempty_state(jcfg_l), **{
        k: jnp.asarray(v, jnp.int32 if k == "ijk" else None)
        for k, v in h.items()}) for h in hands]
    mesh = jparallel.make_mesh(S)
    state = jparallel.replicate_state_for_mesh(
        jcfg, mesh, lambda s, c: states[s], widths)
    dom = jparallel.device_put_domains(jcfg, mesh, widths)

    def fn(st, dom):
        st = dataclasses.replace(st, x=jnp.where(st.n > 0, st.x + shift,
                                                 st.x))
        return jparallel.migrate(jcfg_l, st, dom, buf=buf)

    dom_spec = jparallel.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    out = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(jparallel.state_specs(), dom_spec),
        out_specs=jparallel.state_specs()))(state, dom)
    j = tuple(np.asarray(getattr(out, k)).reshape(S, -1)
              for k in ("n", "x", "puddle"))

    cfg = port_cfg(jcfg)
    devs = tparallel.make_mesh(S, "cpu")

    def build(s, cfg_l):
        st = tempty_state(cfg_l, torch.float64, "cpu")
        return dataclasses.replace(st, **{
            k: torch.tensor(v, dtype=torch.int64 if k == "ijk"
                            else torch.float64)
            for k, v in hands[s].items()})

    shards = tparallel.replicate_state_for_mesh(cfg, devs, build, widths)
    doms = tparallel.device_put_domains(cfg, devs, widths)
    shards = [dataclasses.replace(st, x=torch.where(st.n > 0, st.x + shift,
                                                    st.x)) for st in shards]
    out_t = tparallel.migrate(decomp.local_config(cfg, S, widths), shards,
                              doms, buf)
    t = tuple(torch.stack([getattr(st, k) for st in out_t]).numpy()
              for k in ("n", "x", "puddle"))
    return j, t


@pytest.mark.parametrize("direction", [+1, -1])
def test_migration_uneven_widths_conserves(direction):
    """mpi_adve_test's uneven slabs (widths s + 2), every SD drifted by
    0.7 dx and migrated: the multiset of (id, global x) is the port's and
    the JAX package's alike, and the drifted, wrapped positions; every SD
    inside its slab."""
    widths = [2, 3, 4, 5]
    nx = sum(widths)
    jcfg, cfg = make_cfg(nx=nx, nz=4, n_sd=4 * 16)
    cfg_l0 = decomp.local_config(cfg, 4, widths)
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    rng = np.random.default_rng(1)
    hands, glob_x = [], []
    for s in range(4):
        x = rng.uniform(0, widths[s] * cfg.dx, 6)
        z = rng.uniform(0.5, cfg.nz - 0.5, 6)
        hands.append(_hand(cfg_l0, 6, x, z, s * 100 + np.arange(1, 7)))
        glob_x.append(x + offs[s] * cfg.dx)
    drift = direction * 0.7 * cfg.dx
    (jn, jx, _), (tn, tx, _) = _both_migrate(jcfg, widths, hands, drift, 8)

    def rows(n, x):
        live = n > 0
        g, n = (x + (offs * cfg.dx)[:, None])[live], n[live]
        order = np.lexsort((g, n))
        return n[order], g[order]

    (tn_, tg), (jn_, jg) = rows(tn, tx), rows(jn, jx)
    np.testing.assert_array_equal(tn_, jn_)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        tn_, np.sort(np.concatenate([h["n"][h["n"] > 0] for h in hands])))
    want = np.sort(np.mod(np.concatenate(glob_x) + drift, nx * cfg.dx))
    np.testing.assert_allclose(np.sort(tg), want, rtol=0, atol=1e-12)
    for s in range(4):
        live = tn[s] > 0
        assert (tx[s][live] >= 0).all()
        assert (tx[s][live] < widths[s] * cfg.dx).all()


def test_migration_overflow_is_loud():
    """10 SDs moving right through a buffer of 2: 8 counted, in the port
    as in the JAX package."""
    widths = [2, 2]
    jcfg, cfg = make_cfg(nx=4, nz=4, n_sd=2 * 16)
    cfg_l0 = decomp.local_config(cfg, 2, widths)
    hands = [_hand(cfg_l0, 10, np.full(10, 1.6), np.full(10, 1.5),
                   np.arange(1, 11)),
             _hand(cfg_l0, 0, np.zeros(0), np.zeros(0), np.zeros(0))]
    (_, _, jp), (tn, _, tp) = _both_migrate(jcfg, widths, hands, 0.5, 2)
    assert tp[:, OUT_MIGRATION_OVERFLOW].sum() == 8 \
        == jp[:, OUT_MIGRATION_OVERFLOW].sum()
    assert int((tn > 0).sum()) == 2


# ---------------------------------------------------------------------------
# the public API: the multi-device front against the serial flat engine and
# against the JAX front
# ---------------------------------------------------------------------------

def _oi(lg, spec, dev_count):
    oi = lg.opts_init_t()
    for k, v in spec(lg).items():
        setattr(oi, k, v)
    oi.dev_count = dev_count
    return oi


def _fronts(spec, fields, dev_count, *, jax_too=True):
    """The port's serial front, its multi-device front of ``dev_count``
    shards and (with ``jax_too``) the JAX multi-device front, each
    initialised with fields(lg); the port's initial shards are held
    against the JAX front's converted, then replaced by them.  Returns
    {name: (front, th, rv, host fields)}."""
    out = {}
    for name, lg, n in (("serial", tl, 1), ("multi", tl, dev_count),
                        ("jax", jl, dev_count)):
        if name == "jax" and not jax_too:
            continue
        backend = lg.backend_t.multi_CUDA if n > 1 else lg.backend_t.serial
        kw = F64 if lg is tl else {}
        prt = lg.factory(backend, _oi(lg, spec, n), **kw)
        f = fields(lg)
        prt.init(**f["init"])
        out[name] = (prt, f["init"]["th"], f["init"]["rv"], f)
    if jax_too:
        jm, pm = out["jax"][0], out["multi"][0]
        assert type(jm).__name__ == type(pm).__name__ == "particles_multi_t"
        arrays = {k: np.asarray(getattr(jm.state, k))
                  for k in TENSOR_FIELDS + ("key",)}
        conv = shard_states_from_numpy(arrays, pm.n_shards, "cpu",
                                       torch.float64,
                                       rng_seed=pm.opts_init.rng_seed)
        for a, b in zip(pm.state, conv):
            assert a.rng_key == b.rng_key
            for k in TENSOR_FIELDS:
                np.testing.assert_allclose(getattr(a, k).numpy(),
                                           getattr(b, k).numpy(), rtol=1e-12,
                                           atol=0, err_msg=k)
        pm.state = conv
    return out


def _step(fronts, opts_of, n):
    for _ in range(n):
        for name, (prt, th, rv, f) in fronts.items():
            lg = jl if name == "jax" else tl
            opts = opts_of(lg)
            kw = {"ambient_chem": f["init"]["ambient_chem"]} \
                if "ambient_chem" in f["init"] else {}
            prt.step_sync(opts, th, rv, **kw)
            prt.step_async(opts)


def _popul(prt, names=("x", "z", "n", "rw2")):
    n = prt.get_attr("n")
    live = n > 0
    cols = np.stack([n[live] if k == "n" else prt.get_attr(k)[live]
                     for k in names])
    return cols[:, np.lexsort(cols)]


def _agree(fronts, names=("x", "z", "n", "rw2"), rv_tol=1e-12, sd_conc=True):
    """JAX's tolerances, the multi front against the serial front and
    against the JAX front: th, rv, the SD count a cell, the population."""
    _, th_m, rv_m, _ = fronts["multi"]
    for other in ("serial", "jax"):
        if other not in fronts:
            continue
        prt, th, rv, _ = fronts[other]
        np.testing.assert_allclose(th_m, th, rtol=0, atol=1e-9)
        np.testing.assert_allclose(rv_m, rv, rtol=0, atol=rv_tol)
        if sd_conc:
            counts = []
            for p in (fronts["multi"][0], prt):
                p.diag_all()
                p.diag_sd_conc()
                counts.append(p.outbuf().copy())
            np.testing.assert_array_equal(*counts)
        a, b = _popul(fronts["multi"][0], names), _popul(prt, names)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    assert fronts["multi"][0].migration_overflow() == 0


def _api_spec(nx=14, nz=6, adve_scheme=None):
    def spec(lg):
        d = dict(nx=nx, nz=nz, dx=25.0, dz=25.0, x1=nx * 25.0, z1=nz * 25.0,
                 dt=1.0, sd_conc=24, n_sd_max=nx * nz * 24 * 2,
                 dry_distros={(0.61, 0.0): lognormal},
                 terminal_velocity=lg.vt_t.beard77fast,
                 kernel=lg.kernel_t.geometric)
        if adve_scheme is not None:
            d["adve_scheme"] = getattr(lg.as_t, adve_scheme)
        return d

    def fields(lg):
        x_f = np.arange(nx + 1)[:, None]
        return {"init": dict(
            th=np.full((nx, nz), 289.99), rv=np.full((nx, nz), 7.5e-3),
            rhod=np.full((nx, nz), 1.12),
            Cx=0.4 * np.cos(2 * np.pi * x_f / nx) + np.zeros((1, nz)),
            Cz=0.08 * np.ones((nx, nz + 1)))}

    return spec, fields


def _no_coal(**off):
    def opts(lg):
        o = lg.opts_t()
        o.coal = False
        for k, v in off.items():
            setattr(o, k, v)
        return o
    return opts


def test_multichip_equals_serial_full_process():
    """6 full steps (condensation, advection, sedimentation) on the 4
    uneven slabs [4, 4, 3, 3]: fields, SD count a cell, population,
    puddle and the wet third moment as the serial front's and as the JAX
    front's."""
    fronts = _fronts(*_api_spec(), 4)
    assert fronts["multi"][0].widths == [4, 4, 3, 3]
    _step(fronts, _no_coal(), 6)
    _agree(fronts)
    pud = {k: p.diag_puddle() for k, (p, *_) in fronts.items()}
    for other in ("serial", "jax"):
        for k in pud[other]:
            assert pud["multi"][k] == pytest.approx(pud[other][k], rel=1e-9,
                                                    abs=1e-30)
    for p, *_ in fronts.values():
        p.diag_all()
        p.diag_wet_mom(3)
    for other in ("serial", "jax"):
        np.testing.assert_allclose(fronts["multi"][0].outbuf(),
                                   fronts[other][0].outbuf(), rtol=1e-8,
                                   atol=1e-40)


def test_multichip_pred_corr_equals_serial():
    """pred_corr advection through the halo-2 courant exchange: the
    midpoint courants of SDs crossing slab edges come from the
    neighbours."""
    fronts = _fronts(*_api_spec(adve_scheme="pred_corr"), 4)
    _step(fronts, _no_coal(), 6)
    _agree(fronts, sd_conc=False)


def test_multichip_courant_halo_matters():
    """Advection alone: an SD in a slab's last cell moves with the face
    its right neighbour owns."""
    fronts = _fronts(*_api_spec(), 4)
    _step(fronts, _no_coal(cond=False, sedi=False), 3)
    xs = {k: np.sort(p.get_attr("x")[p.get_attr("n") > 0])
          for k, (p, *_) in fronts.items()}
    for other in ("serial", "jax"):
        np.testing.assert_allclose(xs["multi"], xs[other], rtol=0,
                                   atol=1e-10)


def test_multichip_equals_serial_3d():
    """The 3-D grid on 3 slabs of 3 columns: courant_y and the y wrap."""
    nx, ny, nz = 9, 4, 5

    def spec(lg):
        return dict(nx=nx, ny=ny, nz=nz, dx=20.0, dy=20.0, dz=20.0,
                    x1=nx * 20.0, y1=ny * 20.0, z1=nz * 20.0, dt=1.0,
                    sd_conc=8, n_sd_max=nx * ny * nz * 8 * 2,
                    dry_distros={(0.61, 0.0): lognormal},
                    terminal_velocity=lg.vt_t.beard77fast,
                    kernel=lg.kernel_t.geometric)

    def fields(lg):
        s = (nx, ny, nz)
        return {"init": dict(
            th=np.full(s, 290.0), rv=np.full(s, 7.5e-3),
            rhod=np.full(s, 1.1), Cx=np.full((nx + 1, ny, nz), 0.3),
            Cy=np.full((nx, ny + 1, nz), 0.1),
            Cz=np.full((nx, ny, nz + 1), 0.05))}

    fronts = _fronts(spec, fields, 3)
    assert fronts["multi"][0].widths == [3, 3, 3]
    _step(fronts, _no_coal(), 5)
    _agree(fronts, names=("x", "y", "z", "n"))


def _src_spec(nx=10, nz=4, extra=None):
    def spec(lg):
        d = dict(nx=nx, nz=nz, dx=25.0, dz=25.0, x1=nx * 25.0,
                 z1=nz * 25.0, dt=1.0, sd_conc=16, n_sd_max=nx * nz * 16 * 4,
                 dry_distros={(0.61, 0.0): lognormal},
                 terminal_velocity=lg.vt_t.beard77fast,
                 kernel=lg.kernel_t.geometric)
        d.update(extra(lg) if extra else {})
        return d
    return spec


def _flow(nx, nz, cx, rv=7.5e-3, th=290.0, rhod=1.1, **more):
    def fields(lg):
        return {"init": dict(
            th=np.full((nx, nz), th), rv=np.full((nx, nz), rv),
            rhod=np.full((nx, nz), rhod), Cx=np.full((nx + 1, nz), cx),
            Cz=np.zeros((nx, nz + 1)), **{k: v(lg) for k, v in
                                          more.items()})}
    return fields


def lognormal_src(lnr):
    return (60e4 * np.exp(-(lnr - np.log(0.05e-6)) ** 2
                          / 2 / np.log(1.4) ** 2)
            / np.log(1.4) / np.sqrt(2 * np.pi))


def test_multichip_src_equals_serial():
    """The simple source over a box across two slabs: the serial
    engine's candidates, injected into their owner shards."""
    spec = _src_spec(extra=lambda lg: dict(
        src_type=lg.src_t.simple, src_x0=50.0, src_x1=200.0, src_z0=0.0,
        src_z1=50.0))

    def opts(lg):
        o = _no_coal()(lg)
        o.src = True
        o.src_dry_distros = {(0.61, 0.0): (lognormal_src, 8, 2)}
        return o

    fronts = _fronts(spec, _flow(10, 4, 0.2), 3)
    _step(fronts, opts, 4)
    _agree(fronts, names=("x", "z", "n", "rd3"))
    p = fronts["serial"][0]
    p.diag_all()
    p.diag_sd_conc()
    assert p.outbuf().max() > 16          # the source made SDs


def test_multichip_rlx_equals_serial():
    """The CCN relaxation: the horizontal counts summed over the shards,
    the new SDs in their owner shards."""
    def lognormal_rlx(lnr):
        return 2.0 * lognormal(lnr)

    def extra(lg):
        return dict(aerosol_independent_of_rhod=True, rlx_switch=True,
                    supstp_rlx=2, rlx_bins=32, rlx_sd_per_bin=1,
                    rlx_timescale=1.0, dx=30.0, dz=30.0, x1=270.0, z1=90.0,
                    n_sd_max=9 * 3 * 16 * 4,
                    rlx_dry_distros={0.61: (lognormal_rlx, (0.0, 2.0),
                                            (0.0, 30.0))})

    def opts(lg):
        o = _no_coal()(lg)
        o.rlx = True
        return o

    fronts = _fronts(_src_spec(9, 3, extra), _flow(9, 3, 0.15), 3)
    _step(fronts, opts, 4)
    _agree(fronts, names=("x", "z", "n", "rd3"))
    for p, *_ in fronts.values():
        p.diag_all()
        p.diag_wet_mom(0)
    for other in ("serial", "jax"):
        np.testing.assert_allclose(fronts["multi"][0].outbuf(),
                                   fronts[other][0].outbuf(), rtol=1e-9)
    assert int((fronts["serial"][0].get_attr("n") > 0).sum()) > 9 * 3 * 16


def test_multichip_chem_equals_serial():
    """The aqueous chemistry: the trace gases a slab, the dissolved masses
    riding the migration."""
    def extra(lg):
        return dict(chem_switch=True, chem_rho=1.8e3, sstp_chem=2,
                    n_sd_max=9 * 3 * 16 * 2, dx=25.0, dz=25.0, x1=225.0,
                    z1=75.0, dry_distros={(0.61, 0.0): lambda lnr: (
                        60e6 * np.exp(-(lnr - np.log(0.04e-6)) ** 2
                                      / 2 / np.log(1.4) ** 2)
                        / np.log(1.4) / np.sqrt(2 * np.pi))})

    def gases(lg):
        cs = jcs if lg is jl else tcs
        s = (9, 3)
        return {cs.SO2: np.full(s, 2e-10), cs.O3: np.full(s, 5e-8),
                cs.H2O2: np.full(s, 5e-10),
                cs.CO2: np.full(s, 360e-6 * 44.0 / 29.0),
                cs.NH3: np.full(s, 1e-10), cs.HNO3: np.full(s, 1e-11)}

    def opts(lg):
        o = _no_coal()(lg)
        o.chem_dsl = o.chem_dsc = o.chem_rct = True
        return o

    fronts = _fronts(_src_spec(9, 3, extra),
                     _flow(9, 3, 0.25, rv=0.02, th=300.0, rhod=1.0,
                           ambient_chem=gases), 3)
    so2 = fronts["multi"][3]["init"]["ambient_chem"][tcs.SO2].copy()
    _step(fronts, opts, 4)
    _agree(fronts, names=("x", "z", "n", "rw2"))
    g_m = fronts["multi"][3]["init"]["ambient_chem"]
    for other in ("serial", "jax"):
        g_o = fronts[other][3]["init"]["ambient_chem"]
        for sp in g_m:
            np.testing.assert_allclose(g_m[sp], g_o[int(sp)], rtol=1e-9,
                                       atol=0)
    assert (g_m[tcs.SO2] < so2).all()
    for sp in (tcs.S_VI, tcs.SO2, tcs.H):
        for p, *_ in fronts.values():
            p.diag_all()
            p.diag_chem(sp)
        for other in ("serial", "jax"):
            np.testing.assert_allclose(fronts["multi"][0].outbuf(),
                                       fronts[other][0].outbuf(), rtol=1e-8)
    assert fronts["serial"][0].outbuf().max() > 0


def test_multichip_exact_sstp_cond():
    """test_host_model's exact per-particle substepping on 4 slabs: the
    SDs' private ambient state rides the migration (G on every shard)."""
    def spec(lg):
        return dict(nx=12, nz=6, dx=25.0, dz=25.0, x1=300.0, z1=150.0,
                    dt=1.0, sd_conc=16, n_sd_max=12 * 6 * 16 * 2,
                    sstp_cond=4, exact_sstp_cond=True,
                    dry_distros={(0.61, 0.0): lognormal},
                    terminal_velocity=lg.vt_t.beard77fast,
                    kernel=lg.kernel_t.geometric)

    def fields(lg):
        return {"init": dict(th=np.full((12, 6), 289.99),
                             rv=np.full((12, 6), 7.5e-3),
                             rhod=np.full((12, 6), 1.12),
                             Cx=np.full((13, 6), 0.3),
                             Cz=np.full((12, 7), 0.05))}

    fronts = _fronts(spec, fields, 4)
    _step(fronts, _no_coal(), 4)
    _agree(fronts)


def test_multichip_open_side_walls():
    """test_host_model's open x walls: SDs leaving the global domain die
    instead of riding the ring."""
    def spec(lg):
        return dict(nx=8, nz=4, dx=10.0, dz=10.0, x1=80.0, z1=40.0, dt=1.0,
                    sd_conc=8, n_sd_max=8 * 4 * 8 * 2, open_side_walls=True,
                    dry_distros={(0.61, 0.0): lognormal},
                    terminal_velocity=lg.vt_t.beard77fast,
                    kernel=lg.kernel_t.geometric)

    def fields(lg):
        return {"init": dict(th=np.full((8, 4), 289.99),
                             rv=np.full((8, 4), 7.5e-3),
                             rhod=np.full((8, 4), 1.12),
                             Cx=np.full((9, 4), 0.5),
                             Cz=np.full((8, 5), 0.0))}

    fronts = _fronts(spec, fields, 4)
    _step(fronts, _no_coal(cond=False, sedi=False), 4)
    _agree(fronts, names=("x", "z", "n"))
    p = fronts["serial"][0]
    p.diag_all()
    p.diag_sd_conc()
    assert p.outbuf().sum() < 8 * 4 * 8      # SDs left


def test_multichip_save_load_round_trip(tmp_path):
    """save and load through the multi-device front: the restored shards
    step on as the uninterrupted run does, bit for bit, coalescence on
    (each shard's own draws)."""
    spec, fields = _api_spec()

    def opts(lg):
        o = lg.opts_t()
        return o

    a = _fronts(spec, fields, 4, jax_too=False)["multi"]
    _step({"multi": a}, opts, 2)
    a[0].save(tmp_path / "ck.npz")
    b = _fronts(spec, fields, 4, jax_too=False)["multi"]
    b[0].load(tmp_path / "ck.npz")
    b = (b[0], a[1].copy(), a[2].copy(), b[3])
    _step({"multi": a}, opts, 2)
    _step({"multi": b}, opts, 2)
    assert [st.rng_key for st in b[0].state] == [philox.shard_key(s)
                                                 for s in range(4)]
    for sa, sb in zip(a[0].state, b[0].state):
        assert sa.rng_step == sb.rng_step == 4
        for k in TENSOR_FIELDS:
            assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    np.testing.assert_array_equal(a[1], b[1])


def test_shards_draw_their_own_numbers():
    """The per-shard key word: a shard's coalescence draws are not the
    serial engine's or another shard's."""
    draws = [philox.draw_substeps(44, 3, 1, philox.SHUFFLE, 64,
                                  key1=k)[0] for k in
             (0, philox.shard_key(0), philox.shard_key(1))]
    for i in range(3):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    assert torch.equal(draws[0], philox.draw(44, 3, 0, philox.SHUFFLE, 1,
                                             64)[0])


def test_build_multichip_step_is_the_fronts_step():
    """decomp.build_multichip_step's whole step (the courant halos, the
    shards' condensation, their transport and the ring) on the front's
    initial shards gives what the front's step_sync and step_async give,
    bit for bit."""
    spec, fields = _api_spec()
    prt, th, rv, _ = _fronts(lambda lg: dict(spec(lg), coal_switch=False),
                             fields, 4, jax_too=False)["multi"]
    shards = prt.state
    step, cfg_l = tparallel.build_multichip_step(
        [d.device for d in prt.doms], prt.cfg_global, sstp_coal=1)
    assert cfg_l == prt.cfg_l
    params, w_LS = prt.async_consts()
    out = step(shards, prt.doms, params, w_LS, prt.sgs_mix_len(), 1.0, 44.0)
    opts = tl.opts_t()
    opts.RH_max = 44.0
    prt.step_sync(opts, th, rv)
    prt.step_async(opts)
    for a, b in zip(out, prt.state):
        for k in TENSOR_FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_shards_gather_to_the_serial_state():
    """The front's initial shards gathered back into one global State
    (decomp.gather_flat) hold the serial front's population (every SD's
    attributes and cell in global coordinates), cells, courants and
    puddle; scattered again (decomp.shard_state) they are the shards."""
    spec, fields = _api_spec()
    fr = _fronts(spec, fields, 4, jax_too=False)
    prt = fr["multi"][0]
    g, s = prt._gather_state(), fr["serial"][0].state
    cols = lambda st: np.stack([getattr(st, k)[st.n > 0].double().numpy()
                                for k in ("ijk", "x", "z", "n", "rd3", "rw2",
                                          "kpa")])
    a, b = cols(g), cols(s)
    np.testing.assert_array_equal(a[:, np.lexsort(a)], b[:, np.lexsort(b)])
    for k in ("th", "rv", "rhod", "p", "T", "RH", "dv", "courant_x",
              "courant_z", "sstp_tmp_th", "puddle"):
        assert torch.equal(getattr(g, k), getattr(s, k)), k
    again = prt._shard_state(g)
    for x, y in zip(again, prt.state):
        for k in TENSOR_FIELDS:
            assert torch.equal(getattr(x, k), getattr(y, k)), k
