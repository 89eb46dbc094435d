"""Port parity of the coalescence phase against the JAX package, at float64
on the CPU (float32 where noted): the collision kernels and efficiency
tables (lgrngn/coalescence.py), the pair math (lgrngn/dense.py), the Philox
draws (ops/philox.py) and the plain versions of kernel E (ops/coal.py).

(a) kernel_value for golovin, geometric (with and without a multiplier),
    long and two hall-family tables: rtol 1e-13.  The hall lookup at
    float32 equals the JAX package's interpolated_efficiency and its TPU
    kernel's interpolated_efficiency_sweep bitwise.
(b) pair_and_collide, pair_and_collide_stride (strides 1, 2, 8, 32) and
    pair_and_collide_partners against the JAX functions, fed the same
    uniforms, with dead lanes inside the rows: n, rd3 and each row's
    overflow flag exact, rw2 and kpa rtol 1e-12.
(c) stride 1 is the adjacent pairing on compacted rows (bitwise, as
    tests/test_coal_stride.py:54 holds it for the JAX package).
(d) the whole loops, coal_resident_plain (stride and sort) and
    coal_standalone_plain, against loops built from the JAX functions that
    are fed the port's shuffle permutations and Bernoulli planes: the same
    tolerances as (b), x and z exact; and each under beard76,
    Khvorostyanov's two formulas and undefined (the vt refresh).
(e) the Golovin box gate of tests/test_pallas_coal_golovin.py on the plain
    version at float32, stride and sort: spectrum RMSD < 3.5e-5, third
    moment rel < 5e-5, total multiplicity < 0.6 x initial.
(f) Philox 4x32-10 against the Random123 known-answer vectors, and the
    torch bits against a numpy implementation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_coal_golovin import (B_GOLOVIN, CAP, N_BOX, SIM_TIME,
                                      _golovin_population, _spectrum_err)
from torch_parity import jax_coal_loop, port_cfg, port_shuffle, port_u01

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn.state import StaticConfig
from libcloudphxx_tpu.ops.pallas_coal import _vt_in_kernel
from libcloudphxx_tpu_torch.lgrngn import coalescence as tcoal
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import kernel_t
from libcloudphxx_tpu_torch.lgrngn.state import N_PUDDLE, OUT_COAL_OVERFLOW
from libcloudphxx_tpu_torch.ops import coal as tops
from libcloudphxx_tpu_torch.ops import philox

f64 = torch.float64


def _cfg(kernel, params=()):
    oi = lgrngn.opts_init_t()
    oi.dt = 1.0
    oi.n_sd_max = 1
    oi.kernel = lgrngn.kernel_t[kernel.name]
    oi.kernel_parameters = list(params)
    oi.terminal_velocity = lgrngn.vt_t.beard77
    return StaticConfig.from_opts_init(oi)


def _tables(kernel):
    """(JAX table, r_max, the port's Efficiency) of a kernel at float64."""
    if kernel not in tcoal.TABULATED:
        return None, 0.0, None
    table, r_max = jcoal.load_efficiency_table(lgrngn.kernel_t[kernel.name])
    return table, r_max, tcoal.efficiency(kernel, f64, "cpu")


def _population(rng, rows, cap, compact=False, dead=0.3):
    """SD planes with droplets of 2-300 um (both sides of the tables'
    100 um step and of the long kernel's 50 um) and dead lanes."""
    alive = rng.random((rows, cap)) >= dead
    if compact:
        alive = np.sort(alive, axis=1)[:, ::-1]
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, (rows, cap))), 0.0)
    rw = np.exp(rng.uniform(np.log(2e-6), np.log(3e-4), (rows, cap)))
    rw2 = np.where(alive, rw ** 2, 0.0)
    rd3 = np.where(alive, (rw * rng.uniform(1e-3, 1e-1, (rows, cap))) ** 3,
                   0.0)
    kpa = np.where(alive, rng.uniform(0.1, 1.2, (rows, cap)), 0.0)
    vt = np.where(alive, rng.uniform(0.0, 3.0, (rows, cap)), 0.0)
    return n, rw2, rd3, kpa, vt


def _cells(rng, rows):
    """T, p, rhod, eta, dv as (rows,) arrays of a cloudy column."""
    T = rng.uniform(280.0, 295.0, rows)
    return (T, rng.uniform(8.5e4, 1.0e5, rows), rng.uniform(1.0, 1.2, rows),
            1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5,
            rng.uniform(0.8e4, 1.2e4, rows))


KERNELS = {
    "golovin": (kernel_t.golovin, (1500.0,)),
    "geometric": (kernel_t.geometric, ()),
    "geometric_x3.5": (kernel_t.geometric, (3.5,)),
    "long": (kernel_t.long, ()),
    "hall": (kernel_t.hall, ()),
    "hall_pinsky_stratocumulus": (kernel_t.hall_pinsky_stratocumulus, ()),
}


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_value_matches_jax(name):
    kernel, params = KERNELS[name]
    cfg = _cfg(kernel, params)
    rng = np.random.default_rng(1)
    a = _population(rng, 8, 64, dead=0.0)
    b = _population(rng, 8, 64, dead=0.0)
    jt, r_max, eff = _tables(kernel)
    ref = jcoal.kernel_value(
        cfg, jnp.asarray(params, jnp.float64), *(jnp.asarray(v) for v in (
            a[0], b[0], a[1], b[1], a[4], b[4], a[2], b[2])),
        eff_table=jt, r_max_um=r_max)
    got = tcoal.kernel_value(
        port_cfg(cfg), params, *(torch.tensor(v) for v in (
            a[0], b[0], a[1], b[1], a[4], b[4], a[2], b[2])), eff=eff)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=0.0)
    assert float(got.abs().max()) > 0.0


def test_hall_efficiency_float32_is_bitwise():
    """The port's lookup at float32 in the clamped 128x128 block (the one
    kernel E reads) against the JAX lookup in the full table and its TPU
    kernel's sweep form."""
    rng = np.random.default_rng(2)
    shape = (8, 128)
    rw_a, rw_b = (np.exp(rng.uniform(np.log(1e-6), np.log(4e-3), shape))
                  .astype(np.float32) for _ in range(2))
    full, r_max = jcoal.load_efficiency_table(lgrngn.kernel_t.hall)
    t128, r_max_c, clamp = jcoal.clamped_efficiency_table(lgrngn.kernel_t.hall)
    ja, jb = jnp.asarray(rw_a), jnp.asarray(rw_b)
    ref = np.asarray(jcoal.interpolated_efficiency(
        jnp.asarray(full, jnp.float32), r_max, ja, jb))
    sweep = np.asarray(jcoal.interpolated_efficiency_sweep(
        clamp, jnp.asarray(t128), r_max_c, ja, jb))
    np.testing.assert_array_equal(ref, sweep)
    eff = tcoal.efficiency(kernel_t.hall, torch.float32, "cpu")
    np.testing.assert_array_equal(eff.table.numpy(), t128)
    assert (eff.r_max_um, eff.clamp) == (r_max_c, clamp)
    got = tcoal.interpolated_efficiency(eff, torch.tensor(rw_a),
                                        torch.tensor(rw_b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unported_kernels_raise():
    """undefined is no collision kernel; the turbulent (onishi) kernels run
    on the flat engine only (tests/test_torch_turbulence.py): their value
    needs the pairs' cells, and the dense engine's kernel E refuses them."""
    one = torch.ones(2, 2, dtype=f64)
    cfg = dataclasses.replace(port_cfg(_cfg(kernel_t.geometric)),
                              kernel=kernel_t.undefined.value)
    with pytest.raises(NotImplementedError, match="undefined"):
        tcoal.kernel_value(cfg, (), *(one,) * 8)
    for kern in (kernel_t.onishi_hall_davis_no_waals, kernel_t.onishi_hall):
        cfg = dataclasses.replace(cfg, kernel=kern.value)
        with pytest.raises(ValueError, match="turb"):
            tcoal.kernel_value(cfg, (100.0,), *(one,) * 8)
        with pytest.raises(NotImplementedError, match=kern.name):
            tcoal.require_resident(kern)


# ------------------------------------------------------------------ (b)
def _pair_inputs(seed, kernel=kernel_t.geometric, rows=16, cap=64,
                 compact=False):
    rng = np.random.default_rng(seed)
    vals = _population(rng, rows, cap, compact=compact)
    T, p, rhod, eta, dv = _cells(rng, rows)
    dv[::2] *= 1e5      # the even rows collide without overflow
    u01 = rng.random((rows, cap))
    return vals, (dv[:, None], rhod[:, None], eta[:, None]), u01


def _check_pair(got, ref_rows, n0):
    """``ref_rows`` the JAX results of each row on its own: (n, rw2, rd3,
    kpa, overflow) per row; ``n0`` the multiplicities before."""
    ref = [np.concatenate([np.asarray(r[k]) for r in ref_rows])
           for k in range(4)]
    np.testing.assert_array_equal(got[0].numpy(), ref[0])     # n
    np.testing.assert_array_equal(got[2].numpy(), ref[2])     # rd3
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-12)
    np.testing.assert_allclose(got[3].numpy(), ref[3], rtol=1e-12)
    np.testing.assert_array_equal(got[4].numpy(),
                                  [bool(r[4]) for r in ref_rows])
    # collisions happened, and some rows but not all asked for more
    assert not np.array_equal(got[0].numpy(), n0)
    assert 0 < int(got[4].sum()) < got[4].numel()


def _per_row(fn, planes, rows):
    return [fn(tuple(jnp.asarray(p[r:r + 1]) for p in planes))
            for r in range(rows)]


DT = 400.0   # [s]: most pairs collide, some more than once


@pytest.mark.parametrize("name", ["geometric", "golovin", "hall"])
def test_pair_and_collide_matches_jax(name):
    kernel, params = KERNELS[name]
    cfg = _cfg(kernel, params)
    vals, (dv, rhod, eta), u01 = _pair_inputs(3, kernel)
    count = (vals[0] > 0).sum(1, keepdims=True).astype(float)
    jt, r_max, eff = _tables(kernel)
    jp = jnp.asarray(params, jnp.float64)
    rows = vals[0].shape[0]

    def ref(planes):
        *v, c, d, rh, e, u = planes
        return jdense.pair_and_collide(cfg, jp, tuple(v), c, d, rh, e, DT, u,
                                       eff_table=jt, r_max_um=r_max)

    ref_rows = _per_row(ref, vals + (count, dv, rhod, eta, u01), rows)
    T = lambda a: torch.tensor(a)
    got = tdense.pair_and_collide(
        port_cfg(cfg), params, tuple(map(T, vals)), T(count), T(dv), T(rhod),
        T(eta), DT, T(u01), eff)
    _check_pair(got, ref_rows, vals[0])


@pytest.mark.parametrize("stride", [1, 2, 8, 32])
def test_pair_and_collide_stride_matches_jax(stride):
    cfg = _cfg(kernel_t.geometric)
    vals, (dv, rhod, eta), u01 = _pair_inputs(10 + stride)
    jp = jnp.zeros((0,))

    def ref(planes):
        *v, d, rh, e, u = planes
        return jdense.pair_and_collide_stride(cfg, jp, tuple(v), stride, d,
                                              rh, e, DT, u)

    ref_rows = _per_row(ref, vals + (dv, rhod, eta, u01), vals[0].shape[0])
    T = lambda a: torch.tensor(a)
    got = tdense.pair_and_collide_stride(
        port_cfg(cfg), (), tuple(map(T, vals)), stride, T(dv), T(rhod),
        T(eta), DT, T(u01))
    _check_pair(got, ref_rows, vals[0])


def test_pair_and_collide_partners_matches_jax():
    """Partners from a random perfect matching of each row's lanes."""
    cfg = _cfg(kernel_t.geometric)
    vals, (dv, rhod, eta), u01 = _pair_inputs(20)
    rows, cap = vals[0].shape
    rng = np.random.default_rng(21)
    partner = np.empty((rows, cap), int)
    is_a = np.zeros((rows, cap), bool)
    for r in range(rows):
        lanes = rng.permutation(cap).reshape(-1, 2)
        partner[r, lanes[:, 0]], partner[r, lanes[:, 1]] = lanes[:, 1], \
            lanes[:, 0]
        is_a[r, lanes[:, 0]] = True
    parts = tuple(np.take_along_axis(v, partner, 1) for v in vals)
    u_b = np.take_along_axis(u01, partner, 1)
    jp = jnp.zeros((0,))

    def ref(planes):
        v, q = tuple(planes[:5]), tuple(planes[5:10])
        return jdense.pair_and_collide_partners(
            cfg, jp, v, q, planes[10], *planes[11:14], DT, planes[14],
            planes[15])

    ref_rows = _per_row(ref, vals + parts + (is_a, dv, rhod, eta, u01, u_b),
                        rows)
    T = lambda a: torch.tensor(a)
    got = tdense.pair_and_collide_partners(
        port_cfg(cfg), (), tuple(map(T, vals)), tuple(map(T, parts)),
        T(is_a), T(dv), T(rhod), T(eta), DT, T(u01), T(u_b))
    _check_pair(got, ref_rows, vals[0])


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("name", ["golovin", "geometric"])
def test_stride1_equals_adjacent_pairing(name):
    kernel, params = KERNELS[name]
    cfg = port_cfg(_cfg(kernel, params))
    vals, cells, u01 = _pair_inputs(30, kernel, compact=True)
    T = lambda a: torch.tensor(a)
    vals, cells, u01 = tuple(map(T, vals)), tuple(map(T, cells)), T(u01)
    count = (vals[0] > 0).sum(1, keepdim=True).to(f64)
    ref = tdense.pair_and_collide(cfg, params, vals, count, *cells, DT, u01)
    got = tdense.pair_and_collide_stride(cfg, params, vals, 1, *cells, DT,
                                         u01)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert not torch.equal(ref[0], vals[0])


# ------------------------------------------------------------------ (d)
SEED, STEP = 1234, 7
SSTP, DT_LOOP = 7, 70.0


def _loop_inputs(name, seed):
    kernel, params = KERNELS[name]
    cfg = _cfg(kernel, params)
    rng = np.random.default_rng(seed)
    rows, cap = 16, 64
    n, rw2, rd3, kpa, _ = _population(rng, rows, cap)
    x = rng.uniform(0.0, 100.0, (rows, cap))
    z = rng.uniform(0.0, 100.0, (rows, cap))
    cells = _cells(rng, rows)
    return cfg, params, (n, rw2, rd3, kpa, x, z), cells


def _check_loop(got, ref):
    n, rw2, rd3, kpa, x, z = ref
    np.testing.assert_array_equal(got[0].numpy(), n)
    np.testing.assert_array_equal(got[2].numpy(), rd3)
    np.testing.assert_allclose(got[1].numpy(), rw2, rtol=1e-12)
    np.testing.assert_allclose(got[3].numpy(), kpa, rtol=1e-12)
    np.testing.assert_array_equal(got[4].numpy(), x)
    np.testing.assert_array_equal(got[5].numpy(), z)


@pytest.mark.parametrize("pairing", ["stride", "sort"])
@pytest.mark.parametrize("name", ["geometric", "hall"])
def test_coal_resident_plain_matches_jax_loop(name, pairing):
    cfg, params, planes, cells = _loop_inputs(name, 40)
    jt, r_max, _ = _tables(KERNELS[name][0])
    ref = jax_coal_loop(cfg, params, SSTP, DT_LOOP, SEED, STEP, planes,
                        cells, pairing, jt, r_max)
    got = tops.coal_resident(
        port_cfg(cfg), params, SSTP, DT_LOOP, SEED, STEP,
        *(torch.tensor(a) for a in planes + cells), pairing=pairing)
    _check_loop(got, ref)
    assert float(got[0].sum()) < planes[0].sum()       # collisions happened
    assert tops.n_strides_of(64) == 5                  # two stride cycles


def _emptying_rows(rows=8, cap=64, seed=60):
    """Rows in which every pair collides at once and the big SD's
    multiplicity is an exact multiple of the small one's, so a collision
    leaves it at n == 0 in the middle of a stride cycle: equal
    multiplicities (ratio 1) in the even rows, powers of two in the odd
    ones, dead lanes among the droplets, and a tiny cell volume."""
    rng = np.random.default_rng(seed)
    n, rw2, rd3, kpa, _ = _population(rng, rows, cap, dead=0.2)
    alive = n > 0
    n[0::2] = np.where(alive[0::2], 1000.0, 0.0)
    n[1::2] = np.where(alive[1::2],
                       1000.0 * 2.0 ** rng.integers(0, 3, (rows // 2, cap)),
                       0.0)
    x = rng.uniform(0.0, 100.0, (rows, cap))
    z = rng.uniform(0.0, 100.0, (rows, cap))
    T, p, rhod, eta, dv = _cells(rng, rows)
    return (n, rw2, rd3, kpa, x, z), (T, p, rhod, eta, dv * 1e-12)


@pytest.mark.parametrize("pairing", ["stride", "sort"])
def test_coal_plain_where_collisions_empty_an_sd(pairing):
    """A collision that leaves the big SD at n == 0 before the next
    shuffle: later strides of the cycle pair live SDs with the dead one,
    so the live SDs no longer come first.  The plain loop against the
    loop built from the JAX functions (pair_and_collide_partners through
    pair_and_collide_stride), fed the same draws."""
    cfg = _cfg(kernel_t.geometric)
    planes, cells = _emptying_rows()
    ref = jax_coal_loop(cfg, (), SSTP, DT_LOOP, SEED, STEP, planes, cells,
                        pairing)
    got = tops.coal_resident(
        port_cfg(cfg), (), SSTP, DT_LOOP, SEED, STEP,
        *(torch.tensor(a) for a in planes + cells), pairing=pairing)
    _check_loop(got, ref)
    n0 = planes[0]
    emptied = (n0 > 0) & (got[0].numpy() == 0)
    assert emptied.sum(1).min() > 0            # every row lost SDs to n == 0
    assert bool(got[6].all())                  # every row asked for more


def _jax_standalone_loop(cfg, planes, cells):
    """The loop of the TPU's standalone kernel (pallas_coal.py:122-143)
    built from the JAX functions, fed the port's shuffles and Bernoulli
    planes: (n, rw2, rd3, kpa, x, z) and the final vt."""
    jp = jnp.zeros((0,))
    T, p, rhod, eta, dv = (jnp.asarray(a)[:, None] for a in cells)
    vt_of = lambda rw2: np.asarray(_vt_in_kernel(cfg, jnp.asarray(rw2), T,
                                                 p, rhod, eta))
    dt_sub = DT_LOOP / SSTP
    n, rw2, rd3, kpa, x, z = planes
    for s in range(SSTP):
        vt = vt_of(rw2)
        perm = port_shuffle(SEED, STEP, s, n)
        n, rw2, rd3, kpa, vt, x, z = (
            np.take_along_axis(np.asarray(a), perm, 1)
            for a in (n, rw2, rd3, kpa, vt, x, z))
        count = (n > 0).sum(1, keepdims=True).astype(float)
        n, rw2, rd3, kpa, _ = jdense.pair_and_collide(
            cfg, jp, (n, rw2, rd3, kpa, vt), count, dv, rhod, eta, dt_sub,
            port_u01(SEED, STEP, s, n.shape))
    return (n, rw2, rd3, kpa, x, z), vt_of(rw2)


def test_coal_standalone_plain_matches_jax_loop():
    """The loop of the TPU's standalone kernel (pallas_coal.py:122-143),
    and dense.coal around it: the puddle's overflow flag and the step
    counter."""
    cfg, params, planes, cells = _loop_inputs("geometric", 50)
    (n, rw2, rd3, kpa, x, z), vt = _jax_standalone_loop(cfg, planes, cells)
    got = tops.coal_standalone(
        port_cfg(cfg), params, SSTP, DT_LOOP, SEED, STEP,
        *(torch.tensor(a) for a in planes + cells))
    _check_loop(got[:4] + got[5:7], (n, rw2, rd3, kpa, x, z))
    np.testing.assert_allclose(got[4].numpy(), vt, rtol=1e-12)

    # dense.coal: the same loop on a DenseState at its step counter
    t = lambda a: torch.tensor(a)
    state = tdense.DenseState(
        *(t(a) for a in planes[:4]), torch.zeros_like(t(x)), t(planes[4]),
        t(planes[5]), rhod=t(cells[2]), p=t(cells[1]), T=t(cells[0]), RH=None,
        eta=t(cells[3]), dv=t(cells[4]), sstp_tmp_th=None, sstp_tmp_rv=None,
        courant_x=None, courant_z=None,
        puddle=torch.zeros(N_PUDDLE, dtype=f64),
        overflow=torch.zeros((), dtype=torch.int64), rng_seed=SEED,
        rng_step=STEP)
    d = tdense.coal(port_cfg(cfg), state, params, DT_LOOP, SSTP)
    assert torch.equal(d.n, got[0]) and d.rng_step == STEP + 1
    assert float(d.puddle[OUT_COAL_OVERFLOW]) == float(got[7].any())


# the formulas the main path does not use (it runs beard77fast, which the
# kernels compute as beard77, as in the tests above)
OTHER_VT = [lgrngn.vt_t.beard76, lgrngn.vt_t.khvorostyanov_spherical,
            lgrngn.vt_t.khvorostyanov_nonspherical, lgrngn.vt_t.undefined]


@pytest.mark.parametrize("form", ["stride", "sort", "standalone"])
@pytest.mark.parametrize("formula", OTHER_VT, ids=lambda f: f.name)
def test_coal_loops_refresh_vt_by_each_formula(formula, form):
    """The coalescence substeps' vt refresh under each formula
    (pallas_step.py:276, :317; pallas_coal.py:125, :144): the plain loops
    against the loops built from the JAX functions (pair_and_collide_stride
    and pair_and_collide with _vt_in_kernel), fed the port's draws, with
    the geometric kernel, whose value is vt's difference; the tolerances
    of (b).  Under undefined vt is 0 and nothing collides."""
    cfg, params, planes, cells = _loop_inputs("geometric", 70)
    cfg = dataclasses.replace(cfg, terminal_velocity=formula.value)
    run = tops.coal_standalone if form == "standalone" else \
        lambda *a: tops.coal_resident(*a, pairing=form)
    got = run(port_cfg(cfg), params, SSTP, DT_LOOP, SEED, STEP,
              *(torch.tensor(a) for a in planes + cells))
    if form == "standalone":
        ref, vt = _jax_standalone_loop(cfg, planes, cells)
        np.testing.assert_allclose(got[4].numpy(), vt, rtol=1e-12)
        got = got[:4] + got[5:7]
    else:
        ref = jax_coal_loop(cfg, params, SSTP, DT_LOOP, SEED, STEP, planes,
                            cells, form)
    _check_loop(got, ref)
    lost = planes[0].sum() - float(got[0].sum())
    assert (lost > 0) == (formula != lgrngn.vt_t.undefined)


# ------------------------------------------------------------------ (e)
@pytest.mark.parametrize("pairing", ["stride", "sort"])
def test_golovin_box_gate_plain(pairing):
    """The population and gates of the TPU kernel's Golovin test
    (tests/test_pallas_coal_golovin.py): 128 boxes of 256 SDs at row
    capacity 256, 100 substeps over 800 s, b = 1500, at float32."""
    n, rw2, rd3 = _golovin_population()
    kpa = np.where(n > 0, 1e-10, 0.0)
    cfg = port_cfg(_cfg(kernel_t.golovin, (B_GOLOVIN,)))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    ones = torch.ones(N_BOX, dtype=torch.float32)
    out = tops.coal_resident(
        cfg, (B_GOLOVIN,), 100, SIM_TIME, 1234, 0, f32(n), f32(rw2),
        f32(rd3), f32(kpa), f32(n * 0), f32(n * 0), ones * 300.0,
        ones * 1e5, ones, ones * 1.8e-5, ones, pairing=pairing)
    n1, rw2_1 = out[0].double().numpy(), out[1].double().numpy()
    assert n1.shape == (N_BOX, CAP)
    m3_0, m3_1 = (n * rw2 ** 1.5).sum(), (n1 * rw2_1 ** 1.5).sum()
    assert abs(m3_1 - m3_0) / m3_0 < 5e-5
    assert n1.sum() < 0.6 * n.sum()
    err = _spectrum_err(n, rw2, n1, rw2_1)
    assert err < 3.5e-5, err


# ------------------------------------------------------------------ (f)
def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in philox.philox4x32(ctr, key)) == want


def _philox_numpy(ctr, key):
    """Philox 4x32-10 in numpy uint64 arithmetic."""
    m32 = np.uint64(0xFFFFFFFF)
    c = [np.asarray(v, np.uint64) for v in ctr]
    k = [np.asarray(v, np.uint64) for v in key]
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & m32,
                 (k[1] + np.uint64(0xBB67AE85)) & m32]
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & m32]
    return c


def test_philox_bits_match_numpy():
    rng = np.random.default_rng(6)
    for seed, step, sub, kind in [(0, 0, 0, 0), (44, 3, 9, 1),
                                  (2**32 - 1, 2**31, 99, 0)]:
        got = philox.draw(seed, step, sub, kind, 37, 128).numpy()
        rows = np.arange(37, dtype=np.uint64)[:, None]
        lanes = np.arange(128, dtype=np.uint64)[None, :]
        want = _philox_numpy((step, sub, kind, lanes), (seed, rows))[0]
        np.testing.assert_array_equal(got, want.astype(np.int64))
    # the uniforms: 23-bit steps in [0, 1), bitwise in float32 and float64
    bits = torch.tensor(rng.integers(0, 2**32, 4096), dtype=torch.int64)
    u32, u64 = philox.u01(bits, torch.float32), philox.u01(bits, f64)
    assert float(u32.min()) >= 0.0 and float(u32.max()) < 1.0
    assert torch.equal(u32.double(), u64)
    mant = (bits.numpy() >> 9).astype(np.uint32) | np.uint32(0x3F800000)
    np.testing.assert_array_equal(
        u32.numpy(), mant.view(np.float32) - np.float32(1.0))
