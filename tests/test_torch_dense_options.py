"""Port parity: the dense engine's options of this slice, a const-multi
population (with its sstp_coal growth), the vohl_davis_no_waals kernel
and pred_corr SD advection (libcloudphxx_tpu_torch/lgrngn/dense.py,
ops/step.py pred_corr, ops/coal.py), through
Kinematic2D.run_device_lgrngn(engine="dense") against the JAX package at
float64 on the CPU, where the port runs the plain version of every kernel.

The cases, on 8x8 cells with sstp_cond 3, beard77:
  const_multi  sd_conc 0, sd_const_multi 1e11 (2,080 SDs, 22-43 a cell)
  pred_corr    sd_conc 8 with sd_conc_large_tail, pred_corr advection; a
               quarter of the SDs of the edge columns put within 0.5 m of
               the periodic side walls, so that droplets cross them
  vohl         sd_conc 8, the vohl_davis_no_waals kernel
Each JAX path runs from a fresh model (a JAX model that ran
run_device_lgrngn(engine="dense") on a const-multi population cannot go
on with run(): ROADMAP.md, "Known behaviours of the reference").

Without coalescence the slice is deterministic.  4 steps, 2 of them
spin-up, against (1) the JAX XLA dense functions stepped with the
kernel's vt convention (vt rebuilt from the saved cell state before each
condensation, as tests/test_torch_kinematic.py's reference): th and rv
rtol 1e-10, moments 0 and 3 rtol 1e-9 (1e-10 for 0), the puddle rtol
1e-9, per-cell counts exact; (2) JAX's own run_device_lgrngn(engine=
"dense"), which carries each droplet's vt into the next condensation:
th rtol 1e-9, rv 2e-8, moment 3 1e-6 (test_torch_kinematic.py's bounds for
that known difference).

With coalescence the draws differ (Philox here, jax.random there), so the
coalescence phase of the reference is built from the JAX pair functions
fed the port's draws in the port's lane order (torch_parity.
jax_coal_loop), with radii grown x10 and the multiplier 3000 (const_multi)
or x100 (vohl: to 0.6 mm, where its table lies past index 126) so that
droplets collide: the same tolerances,
collisions happen, in the const-multi case SDs die (equal
multiplicities) and leave their rows, and a pair's request for more than
one collision grows sstp_coal for the next step (the reference's
coalescence phase runs with the port's substep count of each step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kinematic import _port_order
from torch_parity import jax_coal_loop, multiset, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.common import theta_dry as jtheta_dry
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models import mpdata as jmpdata
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.dense_front import dense_capable
from libcloudphxx_tpu_torch.lgrngn.state import (OUT_COAL_OVERFLOW,
                                                 OUT_PRTCL_NUM)
from libcloudphxx_tpu_torch.ops import coal as tcoal

F64 = dict(device="cpu", dtype=torch.float64)
NX = NZ = 8
NT, SPINUP = 4, 2
NT_COAL = 5          # the coalescing runs: 3 main steps
PLANES = ("n", "rw2", "rd3", "kpa", "x", "z")


def _kw(pkg, case, coal=False):
    """Kinematic2D keywords of ``case`` for the package ``pkg``."""
    oi = {"coal_switch": coal}
    kw = dict(nx=NX, nz=NZ, sstp_cond=3, sstp_coal=3,
              terminal_velocity=pkg.vt_t.beard77)
    if case == "const_multi":
        kw.update(sd_conc=0, n_sd_max=8192)
        oi.update(sd_const_multi=1e11)
        if coal:
            oi.update(kernel_parameters=[3000.0])
    else:
        kw.update(sd_conc=8, n_sd_max=1024)
        if case == "pred_corr":
            oi.update(adve_scheme=pkg.as_t.pred_corr, sd_conc_large_tail=True)
        else:
            oi.update(kernel=pkg.kernel_t.vohl_davis_no_waals)
    return dict(kw, opts_init_kw=oi)


def _edge_state(js, seed=3):
    """The JAX flat state ``js`` with a quarter of the SDs of the first
    and the last column moved within 0.5 m of the periodic side walls."""
    rng = np.random.default_rng(seed)
    x, ijk, n = (np.array(getattr(js, k)) for k in ("x", "ijk", "n"))
    col = ijk // NZ
    dx = 1500.0 / NX
    pick = (n > 0) & ((col == 0) | (col == NX - 1)) \
        & (rng.random(x.size) < 0.25)
    u = rng.uniform(1e-3, 0.5, x.size)
    x = np.where(pick & (col == 0), u, x)
    x = np.where(pick & (col == NX - 1), NX * dx - u, x)
    return dataclasses.replace(js, x=jnp.asarray(x))


def _grow(js, factor):
    return dataclasses.replace(js, rw2=js.rw2 * factor ** 2)


def _models(case, coal=False, prep=None):
    """The port's and the JAX package's models of ``case``, their flat
    states made equal by ``prep`` (a function of the JAX State)."""
    m = Kinematic2D(**_kw(tl, case, coal), **F64)
    jm = JaxKinematic2D(micro="lgrngn", **_kw(jl, case, coal))
    if prep is not None:
        js = prep(jm.prtcls.state)
        jm.prtcls.state = js
        m.prtcls.state = dataclasses.replace(
            port_flat_state(js), rng_seed=m.prtcls.state.rng_seed, rng_step=0)
    return m, jm


def _xla_loop(jm, d, coal_phase=None, nt=NT):
    """The JAX XLA dense step with vt rebuilt from the saved cell state
    before each condensation (test_torch_kinematic.py's reference) from
    the model's initial fields; ``coal_phase(i, d) -> d`` runs between
    condensation and transport in main step i."""
    cfg = jm.prtcls.cfg
    c = lambda a: a[:, None]

    @jax.jit
    def cond(d, th, rv, RH_max):
        tha, rva = jmpdata.advect2(th, rv, jm.gc_x, jm.gc_z, jm.G, n_iters=2,
                                   fct=False)
        T0, p0, _, eta0 = jdense._Tpr(cfg, d.sstp_tmp_th, d.sstp_tmp_rv,
                                      d.rhod, d.p)
        d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(T0), c(p0),
                                                   c(d.rhod), c(eta0)))
        return jdense.step_cond(cfg, d, tha.reshape(-1), rva.reshape(-1), 1.0,
                                RH_max)

    th = jnp.full((NX, NZ), float(jtheta_dry.std2dry(jm.setup.th_0,
                                                      jm.setup.rv_0)))
    rv = jnp.full((NX, NZ), jm.setup.rv_0)
    for i in range(nt):
        sp = i < SPINUP
        d, th, rv = cond(d, th.reshape(NX, NZ), rv.reshape(NX, NZ),
                         1.01 if sp else 44.0)
        if coal_phase is not None and not sp:
            d = coal_phase(i, d)
        d = jdense.step_async(cfg, d, jnp.zeros((0,)), 1.0, 1, False, not sp)
    return d, np.asarray(th).reshape(NX, NZ), np.asarray(rv).reshape(NX, NZ)


def _pack(jm, cap):
    return jax.jit(jdense.pack, static_argnums=(0, 2))(
        jm.prtcls.cfg, jm.prtcls.state, cap)


def _compare(m, d, th, rv, rtol_th, rtol_rv, rtol_m3):
    s = m.dense_state
    np.testing.assert_allclose(m.th.numpy(), th, rtol=rtol_th)
    np.testing.assert_allclose(m.rv.numpy(), rv, rtol=rtol_rv)
    np.testing.assert_array_equal((s.n > 0).sum(1).numpy(),
                                  np.asarray((d.n > 0).sum(1)))
    for k, rtol in ((0, 1e-10), (3, rtol_m3)):
        np.testing.assert_allclose(
            tdense.moment(s, 0.0, 1.0, k).numpy(),
            np.asarray(jdense.moment(d, 0.0, 1.0, k)), rtol=rtol)
    # the port folds the coalescence overflow flag whatever the population
    # (ROADMAP.md, "Bookkeeping"); the reference's coalescence phase here
    # does not fold it
    keep = np.arange(s.puddle.numel()) != OUT_COAL_OVERFLOW
    np.testing.assert_allclose(s.puddle.numpy()[keep],
                               np.asarray(d.puddle)[keep], rtol=1e-9)


PREP = {"const_multi": None, "pred_corr": _edge_state, "vohl": None}


@pytest.fixture(scope="module", params=list(PREP))
def slice_run(request):
    case = request.param
    m, jm = _models(case, prep=PREP[case])
    assert dense_capable(m.cfg)      # the factory's pick on the card
    init = m.dense_state
    water0 = tdense.water_dry_totals(init, m.rv)
    d0 = _pack(jm, init.cap)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    return case, m, jm, init, d0, water0


def test_initial_population_matches_jax(slice_run):
    _, _, _, init, d0, _ = slice_run
    a = multiset(init.n, (init.rd3, init.kpa, init.x, init.z))
    b = multiset(d0.n, (d0.rd3, d0.kpa, d0.x, d0.z))
    np.testing.assert_array_equal(a, b)


def test_slice_matches_jax_with_kernel_vt(slice_run):
    case, m, jm, _, d0, _ = slice_run
    ref = _xla_loop(jm, d0)
    _compare(m, *ref, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)
    s = m.dense_state
    a = multiset(s.n, (s.rd3, s.x, s.z))
    b = multiset(ref[0].n, (ref[0].rd3, ref[0].x, ref[0].z))
    np.testing.assert_array_equal(a[:, :3], b[:, :3])      # cell n rd3
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-12)
    if case == "pred_corr":
        # droplets crossed the periodic side walls (an SD is known by its
        # rd3)
        live = np.asarray(d0.n) > 0
        x0 = dict(zip(np.asarray(d0.rd3)[live], np.asarray(d0.x)[live]))
        crossed = [abs(x - x0[r]) > 750.0 for r, x in zip(a[:, 2], a[:, 3])]
        assert sum(crossed) >= 2


def test_slice_matches_jax_run_device_lgrngn(slice_run):
    case, m, _, _, _, _ = slice_run
    jm = _models(case, prep=PREP[case])[1]     # a fresh JAX model
    jm.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    d = _pack(jm, m.dense_state.cap)
    _compare(m, d, np.asarray(jm.th), np.asarray(jm.rv), rtol_th=1e-9,
             rtol_rv=2e-8, rtol_m3=1e-6)


def test_slice_passes_bench_physics_checks(slice_run):
    _, m, _, _, _, (water0, dry0) = slice_run
    d, th, rv = m.dense_state, m.th, m.rv
    alive = d.n > 0
    assert torch.isfinite(th).all() and torch.isfinite(rv).all()
    assert (d.rw2[alive] > 0).all() and (d.rd3[alive] > 0).all()
    water, dry = tdense.water_dry_totals(d, rv)
    assert abs(water - water0) / water0 < 1e-3
    assert abs(dry - dry0) / dry0 < 1e-4
    assert int(d.overflow) == 0


# ------------------------------------------------------- with coalescence
COAL_PREP = {"const_multi": lambda js: _grow(js, 10.0),
             "vohl": lambda js: _grow(js, 100.0)}


@pytest.fixture(scope="module",
                params=[(c, p) for c in COAL_PREP for p in ("stride", "sort")],
                ids=lambda cp: f"{cp[0]}-{cp[1]}")
def coal_run(request):
    case, pairing = request.param
    m, jm = _models(case, coal=True, prep=COAL_PREP[case])
    m.coal_pairing = pairing
    totals = tdense.water_dry_totals(m.dense_state, m.rv)
    before, sstp = [], []
    for i in range(NT_COAL):
        before.append(m.dense_state)
        sstp.append(m.cfg.sstp_coal + m.prtcls._sstp_coal_extra)
        m.run_device_lgrngn(1, spinup=int(i < SPINUP), engine="dense")
    cfg, oi = jm.prtcls.cfg, jm.prtcls.opts_init
    eff = ((jcoal.load_efficiency_table(jl.kernel_t(cfg.kernel)))
           if case == "vohl" else (None, 0.0))

    def coal_phase(i, d):
        perm = _port_order(d, before[i])
        planes = tuple(np.take_along_axis(np.asarray(getattr(d, a)), perm, 1)
                       for a in PLANES)
        cells = tuple(np.asarray(getattr(d, a))
                      for a in ("T", "p", "rhod", "eta", "dv"))
        out = jax_coal_loop(cfg, oi.kernel_parameters, sstp[i], 1.0,
                            oi.rng_seed, i - SPINUP, planes, cells, pairing,
                            eff_table=eff[0], r_max_um=eff[1])
        return dataclasses.replace(
            d, **{a: jnp.asarray(v) for a, v in zip(PLANES, out)})

    ref = _xla_loop(jm, _pack(jm, before[0].cap), coal_phase, NT_COAL)
    return case, m, before, totals, ref, sstp


def test_coal_slice_matches_jax_on_port_draws(coal_run):
    case, m, before, _, ref, sstp = coal_run
    _compare(m, *ref, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)
    # a const-multi pair asked for more than one collision: the steps
    # after it ran more substeps (the reference with them), and the flag
    # was consumed; an sd_conc population's flag is folded but grows
    # nothing
    if case == "const_multi":
        assert sstp[-1] > m.cfg.sstp_coal
        assert float(m.dense_state.puddle[OUT_COAL_OVERFLOW]) == 0.0
    else:
        assert m.prtcls._sstp_coal_extra == 0


def test_coal_slice_collides(coal_run):
    case, m, before, (water0, dry0), _, _ = coal_run
    d = m.dense_state
    lost = float(before[SPINUP].n.sum() - d.n.sum()
                 - d.puddle[OUT_PRTCL_NUM])
    assert lost > 0.0
    water, dry = tdense.water_dry_totals(d, m.rv)
    assert abs(water - water0) / water0 < 1e-3
    assert abs(dry - dry0) / dry0 < 1e-4
    if case == "const_multi":
        # equal multiplicities: a collision empties the larger-n SD of the
        # pair, and the re-binning drops its slot
        sds = lambda s: int((s.n > 0).sum())
        assert sds(d) < sds(before[SPINUP])
        assert torch.all(d.n[d.n > 0] == 1e11)
        dead = d.n == 0
        assert not d.rw2[dead].any() and not d.x[dead].any()


def test_vohl_reads_the_wide_table():
    """vohl's table saturates past index 126: the port reads it as a
    (K + 2)-square block at K = 150 (kernel E's wide form), whose
    lookups are the full table's; the hall family keeps its 128 block."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence as tc
    tab, _, K = tc.clamped_efficiency_table(tl.kernel_t.vohl_davis_no_waals)
    assert K == 150 and tab.shape == (152, 152)
    assert tc.clamped_efficiency_table(tl.kernel_t.hall)[0].shape == (128,
                                                                      128)
    cfg = tl.particles_t(tl.backend_t.serial, Kinematic2D(
        **_kw(tl, "vohl"), **F64).opts_init, **F64).cfg
    assert tcoal.wide_table(cfg)
    full, r_full = jcoal.load_efficiency_table(
        jl.kernel_t.vohl_davis_no_waals)
    rng = np.random.default_rng(2)
    ra, rb = (np.exp(rng.uniform(np.log(1e-7), np.log(3e-3), 5000))
              for _ in range(2))
    eff = tc.efficiency(tl.kernel_t.vohl_davis_no_waals, torch.float64, "cpu")
    got = tc.interpolated_efficiency(eff, torch.tensor(ra), torch.tensor(rb))
    want = jcoal.interpolated_efficiency(full, r_full, ra, rb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------- the sstp_coal growth
def _box(pkg):
    """A const-multi box: 4x4 cells, a multiplier 1e15 on the geometric
    kernel, so that some pair asks for more than one collision every
    step."""
    oi = pkg.opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz, oi.x1, oi.z1, oi.dt = 4, 4, 100.0, 100.0, \
        400.0, 400.0, 1.0
    oi.dry_distros = {(0.61, 0.0): lambda lnr: 1e8 * np.exp(
        -(np.asarray(lnr) + 16.0) ** 2 / 2.0)}
    oi.sd_const_multi = 1e11
    oi.n_sd_max = 4096
    oi.sstp_coal = 2
    oi.kernel = pkg.kernel_t.geometric
    oi.kernel_parameters = [1e15]
    oi.terminal_velocity = pkg.vt_t.beard77
    return oi


def _drive_box(p, pkg, steps):
    th, rv = np.full(16, 290.0), np.full(16, 8e-3)
    rhod = np.full(16, 1.1)
    p.init(th, rv, rhod, Cx=np.zeros(20), Cz=np.zeros(20))
    o = pkg.opts_t()
    o.sedi = o.adve = False
    for _ in range(steps):
        p.step_sync(o, th, rv, rhod)
        p.step_async(o)
    return p


@pytest.mark.parametrize("engine", ["flat", "dense"])
def test_sstp_coal_growth_counts_as_jax(engine):
    """Every step some pair asks for more than one collision: JAX's
    particles_t grows sstp_coal once a step, and so do the port's flat
    engine, its dense front (the flag cleared in its dense copy too) and
    run_device_lgrngn on either engine."""
    steps = 2      # by then one SD a cell is left
    jp = _drive_box(jl.factory(jl.backend_t.serial, _box(jl)), jl, steps)
    assert jp._sstp_coal_extra == steps
    tp = _drive_box(tl.factory(tl.backend_t.serial, _box(tl),
                               engine=engine, **F64), tl, steps)
    assert tp._sstp_coal_extra == jp._sstp_coal_extra
    assert float(tp.state.puddle[OUT_COAL_OVERFLOW]) == 0.0
    if engine == "dense":
        assert tp._loc == "dense"
        assert float(tp._d.puddle[OUT_COAL_OVERFLOW]) == 0.0
    # run_device_lgrngn grows it too, from where the public API left it
    m = Kinematic2D(nx=8, nz=8, sd_conc=0, n_sd_max=8192, sstp_coal=2,
                    engine=engine, opts_init_kw=dict(
                        sd_const_multi=1e11, kernel_parameters=[1e8]), **F64)
    m.run_device_lgrngn(2, spinup=0, engine=engine)
    assert m.prtcls._sstp_coal_extra == 2


def test_onishi_stays_refused():
    """The x-slab mesh refuses the turbulent kernels (ROADMAP.md, Queue 1,
    "The dense mesh in 3-D and with the onishi kernels"); the serial dense
    engine runs them, as the JAX package's dense engine does
    (tests/test_torch_dense_onishi.py), and so does the flat engine
    (tests/test_torch_les.py)."""
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    for kern in (tl.kernel_t.onishi_hall,
                 tl.kernel_t.onishi_hall_davis_no_waals):
        kw = dict(nx=8, nz=4, sd_conc=2, opts_init_kw={
            "kernel": kern, "kernel_parameters": [100.0]}, **F64)
        with pytest.raises(NotImplementedError,
                           match=f"{kern.name}.*serial dense engine"):
            MeshRunner(Kinematic2D(**kw), 2).run(1)
        for engine in ("flat", "dense"):
            m = Kinematic2D(engine=engine, **kw)
            m.run_device_lgrngn(2, spinup=1, engine=engine)
            assert torch.isfinite(m.th).all()


def test_mesh_refuses_pred_corr_and_const_multi():
    """The x-slab mesh keeps refusing what it cannot run: pred_corr (the
    corrector reads courants a shard does not hold) and a const-multi
    population's coalescence (its sstp_coal growth); vohl runs there (E's
    wide form keyed by the shard's global rows)."""
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    for oi, match in (({"adve_scheme": tl.as_t.pred_corr}, "pred_corr"),
                      ({"sd_const_multi": 1e11}, "const-multi")):
        m = Kinematic2D(nx=8, nz=4, sd_conc=0 if "sd_const_multi" in oi
                        else 4, n_sd_max=4096, opts_init_kw=oi, **F64)
        with pytest.raises(NotImplementedError, match=match):
            MeshRunner(m, 2).run(1)
    m = Kinematic2D(nx=8, nz=4, sd_conc=4, n_sd_max=4096, opts_init_kw={
        "kernel": tl.kernel_t.vohl_davis_no_waals}, **F64)
    r = MeshRunner(m, 2)
    r.run(2)
    assert int(r.state().overflow) == 0
