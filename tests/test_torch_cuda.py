"""The port's CUDA kernels on an NVIDIA GPU, each against its plain PyTorch
version on the same card.

chip_smoke.py checks the kernels at the GMD case's shapes (76x76 cells,
row capacity 128).  These tests take the shapes and options that case does
not reach: row capacity 32 (fewer lanes than a block has threads) and 256
(more), an MPDATA grid that is not square, one field and n_iters 1, the
euler scheme, open side walls and periodic top/bottom walls, and rain that
fills the puddle.  Kernel E (coalescence) runs at row
capacity 32, 128 and 256 in its three forms (stride and sort pairing,
standalone) with the golovin, geometric, long and hall kernels, on rows
that are full, half empty, all dead or hold one droplet.  Kernel F (the
flat engine's condensation root find) runs at lengths 1, 127 and 32,773
with dead slots, and the flat slice runs through the public API with the
kernels and with the plain versions.  They also check that the wrappers
refuse what the kernels do not take, and count one launch per call.

Marked ``cuda``; without a card they skip.  The machine with the card has
no JAX, so there run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels follow their plain versions operation for
operation (built with -fmad=false), and at the GMD case they agree
bitwise; the bounds are those chip_smoke.py states (MPDATA rtol 1e-5;
condensation th 2e-6, rv 2e-5, rw2 1e-5; cells, multiplicities, targets
and overflow exact, rw2/x/z 1e-6, puddle 1e-5; coalescence: per cell the
multiset of (n, rd3, kpa) and the overflow flags exact, rw2 rel 1e-6;
kernel F: live droplets rw2 rel 1e-5, dead slots exact).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import multiset

from libcloudphxx_tpu_torch import Kinematic2D, _ext
from libcloudphxx_tpu_torch.lgrngn import as_t, dense, kernel_t, vt_t
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
from libcloudphxx_tpu_torch.models import mpdata
from libcloudphxx_tpu_torch.models.kinematic_2d import Setup, make_gc
from libcloudphxx_tpu_torch.ops import coal, step
from libcloudphxx_tpu_torch.ops import cond as cond_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((torch.abs(a - b) / torch.clamp(torch.abs(b), min=1e-300))
                 .max())


def _launches(kernel, fn):
    """fn()'s result, after checking that it launched ``kernel`` once."""
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.fixture(scope="module", params=[16, 128], ids=["cap32", "cap256"])
def model(dev, request):
    """An 8x8 GMD case on the card; sd_conc 16 packs at row capacity 32,
    sd_conc 128 at 256."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=request.param, sstp_cond=3,
                    n_sd_max=request.param * 64,
                    opts_init_kw={"coal_switch": False}, device=dev)
    assert m.dense_state.cap == {16: 32, 128: 256}[request.param]
    return m


@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_mpdata_kernel_matches_plain(dev, n_iters, fct):
    nx, nz = 12, 10
    s = Setup()
    gc_x, gc_z = make_gc(s, nx, nz, s.X / nx, s.Z / nz)
    rng = np.random.default_rng(3)
    # make_gc's gc_z is a transposed view; the kernel takes contiguous
    # tensors only
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    gc_x, gc_z = f32(gc_x), f32(gc_z)
    G = f32(rng.uniform(0.9, 1.1, (nx, nz)))
    th = f32(rng.uniform(285.0, 300.0, (nx, nz)))
    rv = f32(rng.uniform(5e-3, 9e-3, (nx, nz)))
    args = (gc_x, gc_z, G, n_iters, fct)
    one = _launches(_ext.MPDATA, lambda: mpdata.advect(th, *args))
    assert _rel(one, mpdata.advect(th, *args, plain=True)) <= 1e-5
    two = _launches(_ext.MPDATA, lambda: mpdata.advect2(th, rv, *args))
    for k, p in zip(two, mpdata.advect2(th, rv, *args, plain=True)):
        assert _rel(k, p) <= 1e-5


def _cond_args(m, RH_max):
    d = m.dense_state
    tha, rva = mpdata.advect2(m.th, m.rv, m.gc_x, m.gc_z, m.G, plain=True)
    lam_D, lam_K = hskpng_mfp(d.T, d.p)
    return (m.cfg, m.cfg.sstp_cond, 1.0, RH_max, d.n, d.rw2, d.rd3, d.kpa,
            tha.reshape(-1), rva.reshape(-1), d.sstp_tmp_th, d.sstp_tmp_rv,
            d.rhod, d.dv, lam_D, lam_K, d.p)


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
def test_cond_kernel_matches_plain(model, RH_max):
    args = _cond_args(model, RH_max)
    k = _launches(_ext.COND, lambda: step.cond(*args))
    p = step.cond(*args, plain=True)
    alive = model.dense_state.n > 0
    assert _rel(k[1], p[1]) <= 2e-6          # th
    assert _rel(k[2], p[2]) <= 2e-5          # rv
    assert _rel(k[0][alive], p[0][alive]) <= 1e-5
    assert torch.equal(k[0][~alive], p[0][~alive])
    for a, b in zip(k[3:], p[3:]):           # T, p, RH, eta
        assert _rel(a, b) <= 2e-6


VARIANTS = {
    "cloud": ({}, False),
    "rain": ({}, True),
    "euler": ({"adve_scheme": as_t.euler.value}, False),
    "open_side_walls": ({"open_side_walls": True}, False),
    "periodic_topbot_rain": ({"periodic_topbot_walls": True}, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transport_and_merge_kernels_match_plain(model, variant):
    """Kernel C, then kernel D on C's output, against the plain versions:
    the same targets, far-mover flags and puddle partials, and per cell the
    same multiset of droplets (lane order is free but fixed)."""
    over, rain = VARIANTS[variant]
    cfg = dataclasses.replace(model.cfg, **over)
    d = model.dense_state
    n, rw2, z = d.n, d.rw2, d.z
    if rain:  # 1 mm drops in the lowest 20 m: the puddle fills
        alive = n > 0
        n = torch.where(alive, 2.0, 0.0)
        rw2 = torch.where(alive, 1e-6, 0.0)
        z = torch.where(alive, cfg.z0 + 20.0 * (z / cfg.z1), z)
    # the courants scaled up so that droplets cross cell faces
    C = tuple(4.0 * c for c in dense._row_courants(cfg, d))
    args = (cfg, 1.0, True, n, rw2, d.rd3, d.x, z, d.T, d.p, d.rhod,
            d.eta) + C
    kc = _launches(_ext.TRANSPORT, lambda: step.transport(*args))
    pc = step.transport(*args, plain=True)
    assert torch.equal(kc[0], pc[0])         # n after the walls
    assert torch.equal(kc[4], pc[4])         # target rows
    for a, b in zip(kc[1:4], pc[1:4]):       # x, z, vt
        assert float(torch.abs(a - b).max()) <= 1e-6 * float(b.abs().max())
    info_k, info_p = kc[5].sum(0), pc[5].sum(0)
    assert float(info_k[4]) == float(info_p[4])       # far-mover rows
    assert torch.allclose(info_k[:4], info_p[:4], rtol=1e-5, atol=0.0)
    if rain and not cfg.periodic_topbot_walls:
        assert float(info_p[3]) > 0                   # the puddle filled

    planes = lambda c: (c[0], rw2, d.rd3, d.kpa, c[3], c[1], c[2], c[4])
    kd = _launches(_ext.MERGE, lambda: step.rebin_x(cfg, *planes(kc)))
    pd = step.rebin_x(cfg, *planes(pc), plain=True)
    cpu = lambda o: tuple(t.cpu() for t in (o[2], o[3], o[1], o[5], o[6]))
    mk, mp = multiset(kd[0].cpu(), cpu(kd)), multiset(pd[0].cpu(), cpu(pd))
    assert mk.shape == mp.shape and mk.shape[0] > 0
    np.testing.assert_array_equal(mk[:, :4], mp[:, :4])  # cell, n, rd3, kpa
    np.testing.assert_allclose(mk[:, 4:], mp[:, 4:], rtol=1e-6)
    assert torch.equal(kd[7], pd[7])         # drops per row
    # lanes past each row's last droplet are zero in every plane
    dead = kd[0] == 0
    assert all(float(p[dead].abs().sum()) == 0.0 for p in kd[1:7])


def test_slice_kernels_match_plain(dev):
    """Two spin-up and two sedimenting steps of the 8x8 case through the
    kernels and through the plain versions, on the card: every kernel runs
    once a step, and the fields and the population agree."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
              opts_init_kw={"coal_switch": False}, device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    step_kernels = (_ext.MPDATA, _ext.COND, _ext.TRANSPORT, _ext.MERGE)
    before = {k.name: k.launches for k in _ext.KERNELS}
    mk.run_device_lgrngn(4, spinup=2, engine="dense")
    torch.cuda.synchronize()
    assert all(k.launches == before[k.name] + 4 for k in step_kernels)
    assert _ext.COAL.launches == before["coal"]       # coalescence off
    mp.run_device_lgrngn(4, spinup=2, engine="dense", plain=True)
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5
    dk, dp = mk.dense_state, mp.dense_state
    assert torch.equal((dk.n > 0).sum(1), (dp.n > 0).sum(1))
    assert int(dk.overflow) == int(dp.overflow) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(model):
    args = list(_cond_args(model, 44.0))
    args[4:8] = [a.double() for a in args[4:8]]      # float64 SD planes
    with pytest.raises(TypeError, match="float32"):
        step.cond(*args)
    m = model
    gc_x_strided = m.gc_x.t().contiguous().t()       # same values, strided
    with pytest.raises(ValueError, match="contiguous"):
        mpdata.advect(m.th, gc_x_strided, m.gc_z, m.G)
    with pytest.raises(ValueError, match="do not fit"):
        mpdata.advect(m.th[:-1].contiguous(), m.gc_x, m.gc_z, m.G[:-1])
    d = m.dense_state
    tgt = torch.zeros((d.n_cell, d.cap // 2), dtype=torch.int32,
                      device=d.n.device)
    with pytest.raises(ValueError, match="SD planes"):
        step.rebin_x(m.cfg, d.n, d.rw2, d.rd3, d.kpa, d.vt, d.x, d.z, tgt)


# ---------------------------------------------------------------- kernel E
def _coal_rows(dev, cap, rows=48, seed=0):
    """SD planes with full, half-empty, all-dead and one-droplet rows,
    droplets of 2-300 um, and the cell fields of a cloudy column."""
    rng = np.random.default_rng(seed + cap)
    occ = rng.uniform(0.0, 1.0, rows)
    occ[:4] = (1.0, 0.5, 0.0, 0.0)
    alive = rng.random((rows, cap)) < occ[:, None]
    alive[3, :] = False
    alive[3, cap // 3] = True                      # one droplet
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, (rows, cap))), 0.0)
    rw = np.exp(rng.uniform(np.log(2e-6), np.log(3e-4), (rows, cap)))
    rw2 = np.where(alive, rw ** 2, 0.0)
    rd3 = np.where(alive, (rw * rng.uniform(1e-3, 1e-1, (rows, cap))) ** 3,
                   0.0)
    kpa = np.where(alive, rng.uniform(0.1, 1.2, (rows, cap)), 0.0)
    x = rng.uniform(0.0, 1500.0, (rows, cap))
    z = rng.uniform(0.0, 1500.0, (rows, cap))
    T = rng.uniform(280.0, 295.0, rows)
    cells = (T, rng.uniform(8.5e4, 1e5, rows), rng.uniform(1.0, 1.2, rows),
             1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5,
             rng.uniform(0.8e4, 1.2e4, rows) * 10.0 ** rng.integers(0, 3,
                                                                   rows))
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    return tuple(map(f32, (n, rw2, rd3, kpa, x, z))), tuple(map(f32, cells))


@pytest.fixture(scope="module")
def coal_model(dev):
    return Kinematic2D(nx=8, nz=8, sd_conc=4, n_sd_max=4 * 64, device=dev)


def _coal_cfg(model, kernel):
    return dataclasses.replace(model.cfg, kernel=kernel.value)


COAL_KERNELS = {"golovin": (kernel_t.golovin, (1500.0,)),
                "geometric": (kernel_t.geometric, (2.0,)),
                "long": (kernel_t.long, ()),
                "hall": (kernel_t.hall, ())}


@pytest.mark.parametrize("name", list(COAL_KERNELS))
@pytest.mark.parametrize("form", ["stride", "sort", "standalone"])
@pytest.mark.parametrize("cap", [32, 128, 256])
def test_coal_kernel_matches_plain(coal_model, cap, form, name):
    model = coal_model
    kernel, params = COAL_KERNELS[name]
    cfg = _coal_cfg(model, kernel)
    planes, cells = _coal_rows(model.device, cap)
    args = (cfg, params, 10, 100.0, 44, 3) + planes + cells
    if form == "standalone":
        run = lambda plain: coal.coal_standalone(*args, plain=plain)
        k = _launches(_ext.COAL_STANDALONE, lambda: run(False))
        p = run(True)
        order = (0, 2, 3, 1, 5, 6, 4)      # n rd3 kpa rw2 x z vt
    else:
        run = lambda plain: coal.coal_resident(*args, pairing=form,
                                               plain=plain)
        k = _launches(_ext.COAL, lambda: run(False))
        p = run(True)
        order = (0, 2, 3, 1, 4, 5)         # n rd3 kpa rw2 x z
    cpu = lambda o: tuple(o[i].cpu() for i in order)
    mk, mp = multiset(k[0].cpu(), cpu(k)[1:]), multiset(p[0].cpu(), cpu(p)[1:])
    assert mk.shape == mp.shape
    np.testing.assert_array_equal(mk[:, :4], mp[:, :4])   # cell n rd3 kpa
    np.testing.assert_allclose(mk[:, 4:], mp[:, 4:], rtol=1e-6)
    assert torch.equal(k[-1], p[-1])                      # overflow flags
    n0 = planes[0]
    assert float(p[0].sum()) < float(n0.sum())            # collisions
    for r in (2, 3):                                      # dead, one SD
        assert torch.equal(torch.sort(p[0][r]).values,
                           torch.sort(n0[r]).values)
        assert not bool(p[-1][r])
    if form == "sort":                # the unsort restores x and z
        assert torch.equal(k[4], planes[4]) and torch.equal(k[5], planes[5])


def test_coal_wrappers_refuse_what_the_kernel_does_not_take(coal_model):
    model = coal_model
    cfg = _coal_cfg(model, kernel_t.geometric)
    planes, cells = _coal_rows(model.device, 128, rows=8)
    call = lambda cfg, planes, cells=cells, fn=coal.coal_resident: fn(
        cfg, (), 2, 1.0, 44, 0, *planes, *cells)
    wide, _ = _coal_rows(model.device, 1024, rows=8)
    for bad in (tuple(a[:, :96].contiguous() for a in planes), wide):
        with pytest.raises(ValueError, match="power of two"):
            call(cfg, bad)
    with pytest.raises(TypeError, match="float32"):
        call(cfg, tuple(a.double() for a in planes))
    strided = planes[:1] + (planes[1].t().contiguous().t(),) + planes[2:]
    with pytest.raises(ValueError, match="contiguous"):
        call(cfg, strided)
    for kern in (kernel_t.onishi_hall, kernel_t.vohl_davis_no_waals):
        with pytest.raises(NotImplementedError, match=kern.name):
            call(_coal_cfg(model, kern), planes, fn=coal.coal_standalone)
    with pytest.raises(NotImplementedError, match="beard76"):
        call(dataclasses.replace(cfg, terminal_velocity=vt_t.beard76.value),
             planes)
    with pytest.raises(ValueError, match="pairing"):
        coal.coal_resident(cfg, (), 2, 1.0, 44, 0, *planes, *cells,
                           pairing="xor")


def test_coal_slice_kernels_match_plain(dev):
    """Two spin-up and two coalescing steps of the 8x8 case (geometric
    kernel times 100) through the kernels and the plain versions."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw={"kernel_parameters": [100.0]},
              device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    before = _ext.COAL.launches
    mk.run_device_lgrngn(4, spinup=2, engine="dense")
    torch.cuda.synchronize()
    assert _ext.COAL.launches == before + 2
    mp.run_device_lgrngn(4, spinup=2, engine="dense", plain=True)
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5
    dk, dp = mk.dense_state, mp.dense_state
    assert torch.equal((dk.n > 0).sum(1), (dp.n > 0).sum(1))
    assert float(dk.n.sum()) == float(dp.n.sum())


# ---------------------------------------------------------------- kernel F
def _cond_sd_arrays(dev, n, seed=0):
    """The 12 flat arrays of kernel F for ``n`` droplets of 0.01-30 um
    (a tenth of them dead slots, rw2 = 0) in cells near saturation."""
    rng = np.random.default_rng(seed + n)
    rw = np.exp(rng.uniform(np.log(1e-8), np.log(3e-5), n))
    rw2 = np.where(rng.random(n) < 0.1, 0.0, rw ** 2)
    rd3 = (rw * rng.uniform(0.05, 0.9, n)) ** 3
    T = rng.uniform(280.0, 292.0, n)
    arrays = (rw2, rd3, rng.uniform(0.1, 1.2, n), rng.uniform(0.0, 0.05, n),
              rng.uniform(1.0, 1.2, n), rng.uniform(6e-3, 9e-3, n), T,
              rng.uniform(8.5e4, 1e5, n), rng.uniform(0.95, 1.02, n),
              1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5,
              rng.uniform(6e-8, 7e-8, n), rng.uniform(9e-8, 1.1e-7, n))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
@pytest.mark.parametrize("n", [1, 127, 32773])
def test_cond_sd_kernel_matches_plain(dev, n, RH_max):
    """Kernel F against its plain version at lengths that fill no block,
    one ragged block and many: live droplets to rtol 1e-5 (the bound
    chip_smoke.py states; at the GMD case they agree bitwise), dead slots
    unchanged."""
    arrays = _cond_sd_arrays(dev, n)
    k = _launches(_ext.COND_SD,
                  lambda: cond_ops.advance_rw2(0.1, *arrays, RH_max))
    p = cond_ops.advance_rw2(0.1, *arrays, RH_max, plain=True)
    live = arrays[0] > 0
    if bool(live.any()):
        assert _rel(k[live], p[live]) <= 1e-5
    assert torch.equal(k[~live], arrays[0][~live])


def test_cond_sd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    arrays = _cond_sd_arrays(dev, 64)
    call = lambda a: cond_ops.advance_rw2(0.1, *a, 44.0)
    with pytest.raises(TypeError, match="float32"):
        call(tuple(a.double() for a in arrays))
    strided = (arrays[0][::2],) + tuple(a[:32] for a in arrays[1:])
    with pytest.raises(ValueError, match="contiguous"):
        call(strided)
    with pytest.raises(ValueError, match="one length"):
        call(arrays[:1] + tuple(a[:32] for a in arrays[1:]))
    with pytest.raises(ValueError, match="one length"):
        call(tuple(a.reshape(8, 8) for a in arrays))


def test_flat_slice_kernels_match_plain(dev):
    """Two spin-up and two coalescing steps of the 8x8 case on the flat
    engine through the public API, kernels against plain versions: kernel
    F runs sstp_cond times a step and kernel A twice, and the fields, the
    population and the draws agree."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw={"kernel_parameters": [100.0]},
              device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    before = {k.name: k.launches for k in _ext.KERNELS}
    mk.run(4, spinup=2)
    torch.cuda.synchronize()
    assert _ext.COND_SD.launches == before["cond_sd"] + 4 * 3
    assert _ext.MPDATA.launches == before["mpdata"] + 4 * 2
    mp.run(4, spinup=2, plain=True)
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5
    sk, sp = mk.prtcls.state, mp.prtcls.state
    assert torch.equal(sk.n, sp.n) and torch.equal(sk.ijk, sp.ijk)
    assert _rel(sk.rw2[sk.n > 0], sp.rw2[sp.n > 0]) <= 1e-5
