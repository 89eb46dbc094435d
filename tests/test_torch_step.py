"""Port parity: one fused microphysics step (libcloudphxx_tpu_torch.lgrngn.
dense.step_fused, coalescence off) against the JAX package's XLA dense
pipeline at float64 on the CPU.

The JAX side runs step_cond -> vt_of -> adve_sedi_bcnd -> rebin, the
pipeline its resident TPU kernel is held against (tests/test_pallas_step.py),
with terminal_velocity=beard77 (the port's kernels compute beard77fast by
the direct polynomial too) and the stale vt set from the cell state, as the
kernel rebuilds it.  8x8 cells, sd_conc 24, row capacity 32.  The rain
case puts mm drops near the ground, so the puddle fills and droplets move
more than one cell (the global re-bin); with periodic top/bottom walls the
drops of the bottom row wrap to the top row instead.  Variants: implicit and euler
advection, open side walls, periodic top/bottom walls, and the th_std /
prescribed-pressure closure.

Tolerances: th/rv, rw2/x/z and the puddle rtol 1e-12 (summation order);
cells and multiplicities exact, compared per cell as multisets (lane order
within a row is free).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import multiset, port_cfg, port_state, t, transport_case

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.lgrngn.state import OUT_PRTCL_NUM
from libcloudphxx_tpu.models import Kinematic2D
from libcloudphxx_tpu_torch import Kinematic2D as TKinematic2D
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import vt_t as tvt_t
from libcloudphxx_tpu_torch.ops import step as tstep


def _setup(rain, opts_init_kw=None, cap=32):
    """rain: False, "all" (every SD becomes a 1 mm drop within 5 m of the
    ground) or "bottom" (only the SDs of the bottom row do)."""
    m = Kinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                    sstp_coal=2, n_sd_max=24 * 8 * 8,
                    terminal_velocity=lgrngn.vt_t.beard77,
                    opts_init_kw=opts_init_kw)
    cfg = m.prtcls.cfg
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, cap)
    if rain:
        drop = d.n > 0
        if rain == "bottom":
            drop = drop & (jnp.arange(cfg.n_cell) % cfg.nz == 0)[:, None]
        d = dataclasses.replace(
            d, n=jnp.where(drop, 2.0, d.n),
            rw2=jnp.where(drop, (1e-3) ** 2, d.rw2),
            z=jnp.where(drop, cfg.z0 + 5.0 * (d.z / cfg.z1), d.z))
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    return m, cfg, d


VARIANTS = {
    "implicit": None,
    "euler": {"adve_scheme": lgrngn.as_t.euler},
    "open_side_walls": {"open_side_walls": True},
    "periodic_topbot_walls": {"periodic_topbot_walls": True},
}


@pytest.mark.parametrize("variant,rain", [
    ("implicit", False), ("implicit", "all"), ("euler", False),
    ("open_side_walls", False), ("periodic_topbot_walls", "bottom")])
def test_step_fused_matches_jax_xla(variant, rain):
    # with periodic top/bottom walls the bottom row's drops fall through
    # z0 and reappear in the top row, which then holds up to two rows'
    # SDs: capacity 64 keeps every SD, so that no choice of which to drop
    # enters the comparison
    cap = 64 if rain == "bottom" else 32
    m, cfg, d = _setup(rain, VARIANTS[variant], cap)
    th = jnp.asarray(m.th).reshape(-1)
    rv = jnp.asarray(m.rv).reshape(-1)
    _check_step(cfg, d, th, rv, float(m.setup.dt),
                expect_puddle=rain == "all")


def _check_step(cfg, d, th, rv, dt, expect_puddle):
    c = lambda a: a[:, None]
    d_x, th_x, rv_x = jdense.step_cond(cfg, d, th, rv, dt, 44.0)
    d_x = dataclasses.replace(
        d_x, vt=jvterm.vt_of(cfg, d_x.rw2, c(d_x.T), c(d_x.p), c(d_x.rhod),
                             c(d_x.eta)))
    d_x = jdense.adve_sedi_bcnd(cfg, d_x, dt, True)
    d_x = jdense.rebin(cfg, d_x)

    d_t, th_t, rv_t = tdense.step_fused(port_cfg(cfg), port_state(d), t(th),
                                        t(rv), (), dt, 44.0, 1, False, True)

    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_x), rtol=1e-12)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(rv_x), rtol=1e-12)
    a = multiset(d_t.n, (d_t.rd3, d_t.rw2, d_t.x, d_t.z))
    b = multiset(d_x.n, (d_x.rd3, d_x.rw2, d_x.x, d_x.z))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])   # cell, n, rd3
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-12)
    np.testing.assert_allclose(d_t.puddle.numpy(), np.asarray(d_x.puddle),
                               rtol=1e-12)
    assert int(d_t.overflow) == int(d_x.overflow) == 0
    if expect_puddle:
        assert float(d_t.puddle[OUT_PRTCL_NUM]) > 0.0


def test_step_fused_th_std_const_p_matches_jax_xla():
    """The th_std / prescribed-pressure closure (the p0 profile enters
    as the cell pressure), on the JAX package's own setup of that case
    (tests/test_pallas_step.py)."""
    from math import log, pi, sqrt
    NX = NZ = 8
    oi = lgrngn.opts_init_t()

    def lognorm(lnr):
        mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
        return (n_tot * np.exp(-((lnr - log(mean_r)) ** 2)
                               / 2 / log(stdev) ** 2)
                / log(stdev) / sqrt(2 * pi))

    oi.dry_distros = {(0.61, 0.0): lognorm}
    oi.coal_switch = False
    oi.terminal_velocity = lgrngn.vt_t.beard77
    oi.dt = 1
    oi.nx, oi.nz = NX, NZ
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = NX * 100.0, NZ * 100.0
    oi.sd_conc = 16
    oi.n_sd_max = 16 * NX * NZ
    oi.sstp_cond = 2
    oi.th_dry = False
    oi.const_p = True
    th = (289.0 * (100000.0 / 90000.0) ** (287.0 / 1005.0)) * np.ones((NX, NZ))
    rv = 7.5e-3 * np.ones((NX, NZ))
    prt = lgrngn.factory(lgrngn.backend_t.serial, oi)
    prt.init(th, rv, np.ones((NX, NZ)), 90000.0 * np.ones((NX, NZ)),
             Cx=0.2 * np.ones((NX + 1, NZ)), Cz=-0.1 * np.ones((NX, NZ + 1)))
    cfg = prt.cfg
    assert not cfg.th_dry and cfg.const_p
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, prt.state, 32)
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    _check_step(cfg, d, jnp.asarray(th).reshape(-1),
                jnp.asarray(rv).reshape(-1), 1.0, expect_puddle=False)


def test_step_fused_refuses_coalescence():
    """Coalescence runs, a const-multi population's too (the
    increase_sstp_coal flag in the puddle), except where it is not ported:
    the turbulent kernels."""
    m, cfg, d = _setup(False)
    th, rv = t(m.th).reshape(-1), t(m.rv).reshape(-1)
    for kern in (lgrngn.kernel_t.onishi_hall,
                 lgrngn.kernel_t.onishi_hall_davis_no_waals):
        with pytest.raises(NotImplementedError, match=kern.name):
            tdense.step_fused(dataclasses.replace(port_cfg(cfg),
                                                  kernel=kern.value),
                              port_state(d), th, rv, (), 1.0, 44.0, 2, True,
                              True)
    out, _, _ = tdense.step_fused(
        dataclasses.replace(port_cfg(cfg), pure_const_multi=True),
        port_state(d), th, rv, (), 1.0, 44.0, 2, True, True)
    assert out.rng_step == 1


def test_rebin_x_plain_takes_neighbours_in_order():
    """The merge on a hand-made 3x3 grid: every SD lands in its target row,
    own row first then the MERGE_SOURCES order, the rest of the row zero,
    and a row that cannot hold its SDs counts the drops."""
    from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig
    cfg = StaticConfig(n_dims=2, nx=3, ny=1, nz=3, n_cell=9, n_sd_max=18,
                       dx=1.0, dy=1.0, dz=1.0, x0=0.0, x1=3.0, y0=0.0, y1=1.0,
                       z0=0.0, z1=3.0, dt=1.0, sstp_cond=1, sstp_coal=1,
                       th_dry=True, const_p=False, RH_formula=0,
                       adve_scheme=0, terminal_velocity=2, kernel=0,
                       exact_sstp_cond=False, variable_dt=False,
                       sedi_switch=True, coal_switch=False,
                       turb_cond_switch=False, open_side_walls=False,
                       periodic_topbot_walls=False)
    cap = 2
    tgt = torch.full((9, cap), -1, dtype=torch.int32)
    tgt[4, 0] = 4       # stays in the centre cell (1, 1)
    tgt[3, 1] = 4       # from below (1, 0)
    tgt[1, 0] = 4       # from the left column (0, 1): dropped, row full
    tgt[0, 0] = 6       # (0, 0) -> (2, 0) across the periodic x edge
    ids = torch.arange(18, dtype=torch.float64).reshape(9, cap) + 1.0
    n = torch.where(tgt >= 0, ids, 0.0)
    outs = tstep.rebin_x(cfg, *(n,) * 7, tgt)
    got, drops = outs[0], outs[7]
    assert got[4].tolist() == [ids[4, 0].item(), ids[3, 1].item()]
    assert got[6].tolist() == [ids[0, 0].item(), 0.0]
    assert float(got.sum()) == float(got[4].sum() + got[6].sum())
    assert drops.tolist() == [0, 0, 0, 0, 1, 0, 0, 0, 0]


# -------------------------------------------- kernel C's dead slots, kernel D
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nx,nz", [(3, 4), (8, 6)], ids=["nx3", "8x6"])
def test_transport_plain_zeroes_the_slots_dead_at_load(nx, nz, dtype):
    """A slot dead at load (n == 0) comes out of transport_plain with n = x
    = z = vt = 0 and target -1, as kernel C writes it, whatever it held;
    what a dead slot holds reaches no other output."""
    cfg, planes, cells = transport_case(nx, nz, 16, dtype=dtype)
    n, rw2, rd3, kpa, x, z = planes
    dead = n == 0
    assert bool(dead.any()) and bool((~dead).any())
    out = tstep.transport(cfg, 1.0, True, n, rw2, rd3, x, z, *cells)
    for a in out[:4]:                                   # n, x, z, vt
        assert a.dtype == dtype and bool((a[dead] == 0).all())
    assert bool((out[4][dead] == -1).all())
    assert bool((out[0][~dead] > 0).any())
    rng = np.random.default_rng(1)
    junk = lambda a: torch.where(dead, torch.as_tensor(
        rng.uniform(1e-12, 1e3, a.shape), dtype=dtype), a)
    again = tstep.transport(cfg, 1.0, True, n, junk(rw2), junk(rd3),
                            junk(x), junk(z), *cells, plain=True)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rain", [False, True], ids=["cloud", "rain"])
def test_dead_slot_contract_leaves_the_merge_unchanged(rain):
    """The merge after transport_plain takes the same droplets to the same
    lanes whether the slots dead at load carry zeros (kernel C's contract)
    or, as before it, the x, z and vt computed from what they held: on the
    8x8 GMD case with the courants scaled up so that droplets cross faces,
    and with mm drops near the ground (the puddle fills)."""
    m = TKinematic2D(nx=8, nz=8, sd_conc=24, sstp_cond=3,
                     n_sd_max=24 * 64, terminal_velocity=tvt_t.beard77,
                     device="cpu", dtype=torch.float64)
    cfg, d = m.cfg, m.dense_state
    n, rw2, z = d.n, d.rw2, d.z
    if rain:
        live = n > 0
        n = torch.where(live, 2.0, 0.0)
        rw2 = torch.where(live, 1e-6, 0.0)
        z = torch.where(live, cfg.z0 + 20.0 * (z / cfg.z1), z)
    C = tuple(4.0 * c for c in tdense._row_courants(cfg, d))
    cells = (d.T, d.p, d.rhod, d.eta) + C
    out = tstep.transport(cfg, 1.0, True, n, rw2, d.rd3, d.x, z, *cells)
    # the x, z and vt of every slot as computed regardless of n
    every = tstep.transport(cfg, 1.0, True, torch.ones_like(n), rw2, d.rd3,
                            d.x, z, *cells)
    dead = n == 0
    assert bool(dead.any())
    before = [torch.where(dead, b, a) for a, b in zip(out[1:4], every[1:4])]
    merge = lambda x, z, vt: tstep.rebin_x(cfg, out[0], rw2, d.rd3, d.kpa,
                                           vt, x, z, out[4])
    now, then = merge(*out[1:4]), merge(*before)
    for a, b in zip(now, then):
        assert torch.equal(a, b)
    ms = lambda o: multiset(o[0], (o[2], o[3], o[1], o[5], o[6]))
    np.testing.assert_array_equal(ms(now), ms(then))
    assert ms(now).shape[0] > 0
    if rain:
        assert float(out[5][:, 3].sum()) > 0


@pytest.mark.parametrize("cap", [3, 5])
def test_rebin_x_plain_order_with_drops(cap):
    """At a row capacity that is not a multiple of 4, a crowded row takes
    its own droplets first, then the MERGE_SOURCES order (below, above,
    left, ...), slot order within each source, and counts the droplets
    that do not fit; the rows that lost droplets are packed from lane 0."""
    from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig
    cfg = StaticConfig(n_dims=2, nx=3, ny=1, nz=3, n_cell=9, n_sd_max=9 * cap,
                       dx=1.0, dy=1.0, dz=1.0, x0=0.0, x1=3.0, y0=0.0, y1=1.0,
                       z0=0.0, z1=3.0, dt=1.0, sstp_cond=1, sstp_coal=1,
                       th_dry=True, const_p=False, RH_formula=0,
                       adve_scheme=0, terminal_velocity=2, kernel=0,
                       exact_sstp_cond=False, variable_dt=False,
                       sedi_switch=True, coal_switch=False,
                       turb_cond_switch=False, open_side_walls=False,
                       periodic_topbot_walls=False)
    tgt = torch.full((9, cap), -1, dtype=torch.int32)
    # row 4 is cell (1, 1); its sources in order: 4 (own), 3 (below),
    # 5 (above), 1 (left), 0, 2, 7 (right), 6, 8
    sends = [(1, cap - 1), (7, 0), (5, 1), (3, 0), (3, cap - 1), (4, 1),
             (4, 2)]
    for row, lane in sends:
        tgt[row, lane] = 4
    tgt[0, 0] = 0                                   # stays: row 0 keeps it
    ids = torch.arange(9 * cap, dtype=torch.float64).reshape(9, cap) + 1.0
    n = torch.where(tgt >= 0, ids, 0.0)
    out = tstep.rebin_x(cfg, *(n,) * 7, tgt)
    order = [(4, 1), (4, 2), (3, 0), (3, cap - 1), (5, 1), (1, cap - 1),
             (7, 0)]
    want = [float(ids[r, l]) for r, l in order]
    for plane in out[:7]:
        assert plane[4].tolist() == want[:cap]
        assert plane[0].tolist() == [1.0] + [0.0] * (cap - 1)
        assert float(plane.sum()) == float(plane[4].sum() + plane[0].sum())
    assert out[7].tolist() == [0.0] * 4 + [len(want) - cap] + [0.0] * 4
