"""The port's CUDA kernels on an NVIDIA GPU, each against its plain PyTorch
version on the same card.

chip_smoke.py checks the kernels at the GMD case's shapes (76x76 cells,
row capacity 128).  These tests take the shapes and options that case does
not reach: row capacity 32 (fewer lanes than a block has threads) and 256
(more), one field and n_iters 1, the euler scheme, open side walls and
periodic top/bottom walls, and rain that fills the puddle.  Kernel A
(MPDATA, a thread-block cluster a field) runs on a grid that is not square,
on grids narrower than a full cluster (3 and 5 columns), with a last slab
shorter than the others (77 columns) and at the GMD case's 76x76, with FCT
on and off and n_iters 1-3, bitwise equal to its plain version.  Kernel B
(condensation) runs at row capacity 32, 128 and 256 (one to eight chunks
of 32 droplets a warp) on rows full, half empty, all dead or holding one
droplet, with the dead lanes after the droplets or among them.  Kernel E
(coalescence, a warp a row) runs at row capacity 2 to 512 in its three
forms (stride and sort pairing, standalone) with the golovin, geometric,
long and hall kernels, on rows that are full, half empty, all dead or hold
one droplet, and on rows where collisions leave SDs at n == 0 between
shuffles, bitwise equal to its plain version lane by lane.  Kernels B, C
and E also run under the terminal velocity formulas the main path does
not use (beard76, Khvorostyanov's two, undefined; C's vt also on radii of
1 nm to 5 mm), against their plain versions.  Kernel F (the
flat engine's condensation substep loop) runs on cell-sorted segments with
an empty cell, a cell of 700 droplets and a cell 0 holding 5,000 dead
slots, under the th_dry, th_std and const_p closures and with rhod
substepped, and the flat slice runs through the public API with the
kernels and with the plain versions.  Kernels B and F give the same bits
whatever order the cells go to the warps in.  They also check that the
wrappers refuse what the kernels do not take, and count one launch per
call.  Kernels C (transport) and D (merge, a warp a row each) run at row
capacity 2 to 512 in their scalar-slot and 16-byte forms, on a 3-column
grid and an 8x6 one with all-dead rows, far movers, the puddle and rows
that receive more droplets than they hold, bitwise equal to their plain
versions in every slot, and C also in its subsidence, no-advection and
vt-only forms.  Kernel G (the per-droplet root find at each droplet's own
ambient conditions) runs on 1 to 369,664 droplets (ragged warps), on
haze, activating and evaporating droplets, dead and rw2 <= 0 slots, for
a scalar dt and a dt a droplet, bitwise equal to its plain version, and
on the ravelled dense planes (dead slots included).  Its two forms, each
a whole per-particle condensation phase a launch, run on dense rows of
capacity 128 and 512 with dead tails and holes, and on flat cell-sorted
segments of more than 32 live SDs, of 1 and of 0, with dead slots in
cell 0: the fixed-count form with and without in-cell mixing and under
const_p, the adaptive form with sstp_cond_act 1 and above sstp_cond;
without mixing rw2 and the live SDs' private state are bitwise their
plain versions', with mixing within B's gates.  The exact and adaptive
per-particle slices run through the public API with them, bitwise equal
to their plain paths, on the flat engine and on the dense front;
there D runs in its 11-plane form (the exact mode's private planes),
bitwise equal to its plain version.  Kernel C's unwrapped form
(a shard of the x-slab mesh) runs at row capacity 2 to 512 in both
layouts on the first, an inner and the last slab, with droplets leaving
on both sides, and kernel E keyed by a shard's global rows (row0), both
bitwise equal to their plain versions; the 8-shard mesh matches the
serial dense engine on the card.  The dense front
(particles_dense_t) steps through the kernels and equals the fused dense
run bitwise; dense.repack and the
repack policy run on the card as on the CPU, and the policy refuses a
row that needs more than kernel E's 512 slots.  Kernel A advects the bulk
schemes' 4 and 6 fields in one launch on the 76x76 node grid, each field
bitwise one advect of it, and a short blk_1m and blk_2m run through it
equals the plain path and run() bitwise.  The turb_cond forms of F and of
G's two forms (each SD at its RH plus its SGS supersaturation ssp) run
on the same inputs with ssp and dot_ssp from a seed, bitwise equal to
their plain versions as their forms without turb_cond are, and with ssp
and dot_ssp zero bitwise equal to those forms; the flat LES slice runs
through the public API with them.  The parcel forms of F and G's two
forms (and their turb_cond forms) run on the same inputs with the cells
taken for parcels of 1 kg of dry air, within the same bounds of their
plain versions; a rising parcel through the public API in each mode, and
the 3-D grid at 6x6x6, run the kernel path against the plain path.
Kernel C's 3-D forms (implicit, euler, pred_corr; periodic and open side
walls) and D's (eight and twelve planes) run on a 6x5x4 grid at row
capacity 2 to 512, both layouts, with movers across the x and y walls,
far movers, the puddle and rows that receive more droplets than they
hold; kernel E's y forms (the formula kernels, the hall family, vohl)
and its onishi form (onishi_hall and onishi_hall_davis_no_waals on each
side of Wang's 2.5e-2, with and without the y plane) at row capacity 2
to 512; each bitwise equal to its plain version; and the dense front on
the 3-D grid at 6x6x6 (the factory's pick on the card) and with the
onishi kernel at 8x8 equals its plain path bitwise.  The flat engine's
multi-device front (3 and 8 shards of a 19x10 grid on the card) matches
the serial flat engine away from the cells where slab-local x rounds an
SD across a face, and F and G's fixed-count form on a shard's padded
slab match their plain versions.  Kernel B's merge-prologue form (the
deferred re-binning, then the condensation of the merged rows) runs under
each terminal velocity formula at row capacity 32 and 256 on a deferred
step of the 8x8 case, and at 2 to 512 on kernel C's crowded synthetic
rows, its merged planes and drops bitwise and its condensation within
B's gates against its plain version; kernel D's MPDATA-epilogue form runs
at row capacity 32 and 128 with FCT off and on and n_iters 1-3, its
planes bitwise D's and its advected th and rv bitwise kernel A's and the
plain version's; and the dense run with both switches equals the default
run on the card bitwise.

Marked ``cuda``; without a card they skip.  The machine with the card has
no JAX, so there run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels follow their plain versions operation for
operation (built with -fmad=false); the bounds are those chip_smoke.py
states (MPDATA and coalescence bitwise, and for coalescence also per
cell the multiset of (n, rd3, kpa) and the overflow flags exact, rw2 rel
1e-6; condensation th 2e-6, rv 2e-5, rw2 1e-5, as the kernels' cell sums
add in another order than the plain versions'; kernel G bitwise;
transport and merge
bitwise in every slot, far flags and drops exact, the puddle partials
1e-5 as they add in another order; the condensation kernels copy dead
slots through).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (ambient_population, dense3d_case, flat_cond_case,
                          ice_cond_case, multiset, perparticle_case,
                          transport_case)

from libcloudphxx_tpu_torch import Kinematic2D, _ext
from libcloudphxx_tpu_torch.lgrngn import as_t, dense, kernel_t, vt_t
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
from libcloudphxx_tpu_torch.models import mpdata
from libcloudphxx_tpu_torch.models.kinematic_2d import (BULK_FIELDS, Setup,
                                                        make_gc, make_gc_node)
from libcloudphxx_tpu_torch.ops import coal, step
from libcloudphxx_tpu_torch.ops import cond as cond_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _rel(a, b):
    if a.numel() == 0 and b.numel() == 0:    # nothing to differ
        return 0.0
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


def _mpdata_case(dev, nx, nz, seed=3):
    """The GMD-2015 courants of an nx x nz grid, a random G and th, rv
    fields, as contiguous float32 tensors on the card."""
    s = Setup()
    gc_x, gc_z = make_gc(s, nx, nz, s.X / nx, s.Z / nz)
    rng = np.random.default_rng(seed)
    # make_gc's gc_z is a transposed view; the kernel takes contiguous
    # tensors only
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    return (f32(gc_x), f32(gc_z), f32(rng.uniform(0.9, 1.1, (nx, nz))),
            f32(rng.uniform(285.0, 300.0, (nx, nz))),
            f32(rng.uniform(5e-3, 9e-3, (nx, nz))))


def _check_mpdata(gc_x, gc_z, G, th, rv, n_iters, fct):
    """Kernel A on one field and on two, bitwise equal to the plain
    version, one launch a call."""
    args = (gc_x, gc_z, G, n_iters, fct)
    one = _launches(_ext.MPDATA, lambda: mpdata.advect(th, *args))
    assert torch.equal(one, mpdata.advect(th, *args, plain=True))
    two = _launches(_ext.MPDATA, lambda: mpdata.advect2(th, rv, *args))
    for k, p in zip(two, mpdata.advect2(th, rv, *args, plain=True)):
        assert torch.equal(k, p)


@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_mpdata_kernel_matches_plain(dev, n_iters, fct):
    _check_mpdata(*_mpdata_case(dev, 12, 10), n_iters, fct)


@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
@pytest.mark.parametrize("nx,nz", [(3, 10), (5, 7), (77, 76), (76, 76)],
                         ids=["nx3", "nx5", "nx77", "gmd76"])
def test_mpdata_kernel_on_cluster_grids(dev, nx, nz, n_iters, fct):
    """Kernel A on grids narrower than a full cluster (3 and 5 CTAs of one
    column), with a last slab shorter than the others (77 columns in 16
    CTAs of 5), and the GMD case's 76x76 (15 slabs of 5, one of 1)."""
    plan = mpdata.launch_plan(nx, nz, fct)
    assert plan.ctas == min(nx, 16)
    _check_mpdata(*_mpdata_case(dev, nx, nz), n_iters, fct)


@pytest.mark.parametrize("nfields", [4, 6])
@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_mpdata_advect_n_is_bitwise_one_advect_a_field(dev, nfields, fct,
                                                       n_iters):
    """Kernel A on the bulk schemes' 4 and 6 fields of the 76x76 node grid
    in one launch: each field bitwise equal to the plain version and to a
    lone advect of it; the mixing ratios hold exact zeros (clear air)."""
    s, nx, nz = Setup(), 76, 76
    gc_x, gc_z = make_gc_node(s, nx, nz, s.X / (nx - 1), s.Z / (nz - 1))
    rng = np.random.default_rng(nfields)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    fields = (f32(rng.uniform(285.0, 300.0, (nx, nz))),
              f32(rng.uniform(5e-3, 9e-3, (nx, nz)))) + tuple(
        f32(np.where(rng.uniform(size=(nx, nz)) < 0.5, 0.0,
                     rng.uniform(0.0, 1e-3, (nx, nz))) * 10.0 ** (3 * i))
        for i in range(nfields - 2))
    args = (f32(gc_x), f32(gc_z), f32(rng.uniform(0.9, 1.2, (nx, nz))),
            n_iters, fct)
    out = _launches(_ext.MPDATA, lambda: mpdata.advect_n(fields, *args))
    plain = mpdata.advect_n(fields, *args, plain=True)
    assert len(out) == nfields
    for f, k, p in zip(fields, out, plain):
        assert torch.equal(k, p)
        assert torch.equal(k, mpdata.advect(f, *args))


@pytest.mark.parametrize("micro", ["blk_1m", "blk_2m"])
def test_bulk_run_kernel_path_matches_plain(dev, micro):
    """A short bulk run on the 16x16 node grid with FCT across a spin-up
    boundary: kernel A once a step, the kernel path bitwise equal to the
    plain path, run() bitwise equal to run_device()."""
    kw = dict(nx=16, nz=16, micro=micro, grid="node", fct=True, device=dev)
    a, b, c = (Kinematic2D(**kw) for _ in range(3))
    for m in (a, b, c):
        m.ante_loop()
    before = _ext.MPDATA.launches
    a.run_device(20, spinup=10)
    torch.cuda.synchronize()
    assert _ext.MPDATA.launches == before + 20
    b.run_device(20, spinup=10, plain=True)
    c.run(20, spinup=10)
    for k in BULK_FIELDS[micro]:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
        assert torch.equal(getattr(a, k), getattr(c, k)), k
        assert bool(torch.isfinite(getattr(a, k)).all()), k
    assert float(a.rc.max()) > 0


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


def _cond_rows(dev, cap, shuffled, rows=24, seed=0):
    """Kernel B's inputs on synthetic rows at row capacity ``cap``: rows
    full, half empty, all dead, holding one droplet, and at random
    occupancy; ``shuffled`` scatters each row's dead lanes among its
    droplets (as the sort pairing leaves them), else the droplets come
    first.  Haze to cloud droplets in cells from sub- to supersaturated,
    with a host-model increment of th and rv."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_dry
    rng = np.random.default_rng(seed + cap)
    occ = rng.uniform(0.0, 1.0, rows)
    occ[:4] = (1.0, 0.5, 0.0, 1.0 / cap)
    count = np.round(occ * cap).astype(int)
    alive = np.arange(cap)[None, :] < count[:, None]
    if shuffled:
        alive = np.stack([rng.permutation(a) for a in alive])
    rw = np.exp(rng.uniform(np.log(2e-8), np.log(3e-5), (rows, cap)))
    n = np.where(alive, np.floor(10.0 ** rng.uniform(7, 9, (rows, cap))), 0.0)
    rw2 = np.where(alive, rw ** 2, 0.0)
    rd3 = np.where(alive, (rw * rng.uniform(0.05, 0.9, (rows, cap))) ** 3,
                   0.0)
    kpa = np.where(alive, rng.uniform(0.1, 1.2, (rows, cap)), 0.0)
    th0 = rng.uniform(289.0, 300.0, rows)
    rhod = rng.uniform(1.0, 1.15, rows)
    T = theta_dry.T(torch.tensor(th0), torch.tensor(rhod))
    p = theta_dry.p(torch.tensor(rhod), torch.tensor(8e-3), T)
    rv0 = rng.uniform(0.95, 1.02, rows) * const_cp.r_vs(T, p).numpy()
    lam_D, lam_K = hskpng_mfp(T, p)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    planes = tuple(map(f32, (n, rw2, rd3, kpa)))
    cells = tuple(map(f32, (th0 + rng.normal(0.0, 0.05, rows),
                            rv0 * (1.0 + rng.uniform(-2e-3, 4e-3, rows)),
                            th0, rv0, rhod, np.full(rows, 400.0),
                            lam_D.numpy(), lam_K.numpy(), p.numpy())))
    return planes, cells


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
@pytest.mark.parametrize("shuffled", [False, True], ids=["packed", "shuffled"])
@pytest.mark.parametrize("cap", [32, 128, 256])
def test_cond_kernel_matches_plain_on_rows(model, cap, shuffled, RH_max):
    """Kernel B at row capacity 32, 128 and 256 (one to eight chunks of 32
    droplets a warp), on rows full, empty, half empty and with one droplet,
    with the dead lanes after the droplets or among them; dead lanes are
    copied through."""
    planes, cells = _cond_rows(model.device, cap, shuffled)
    args = (model.cfg, 5, 1.0, RH_max) + planes + cells
    k = _launches(_ext.COND, lambda: step.cond(*args))
    p = step.cond(*args, plain=True)
    alive = planes[0] > 0
    assert _rel(k[1], p[1]) <= 2e-6          # th
    assert _rel(k[2], p[2]) <= 2e-5          # rv
    assert _rel(k[0][alive], p[0][alive]) <= 1e-5
    assert torch.equal(k[0][~alive], planes[1][~alive])
    for a, b in zip(k[3:], p[3:]):           # T, p, RH, eta
        assert _rel(a, b) <= 2e-6
    assert _rel(k[0][alive], planes[1][alive]) > 1e-3   # droplets grew


@pytest.mark.parametrize("order", ["again", "in_order", "reversed"])
def test_cond_kernels_repeat_in_any_cell_order(model, monkeypatch, order):
    """Kernels B and F give the same bits when called again and whatever
    order the cells go to the warps in (longest first, their own order,
    reversed): a warp's cell sum does not depend on the other warps."""
    planes, cells = _cond_rows(model.device, 256, True)
    b_args = (model.cfg, 5, 1.0, 44.0) + planes + cells
    cfg, kw = _flat_case(model.device, "long_cell", "var_rho")
    f_call = lambda: cond_ops.cond_flat(cfg, RH_max=44.0, **kw)
    ref_b, ref_f = step.cond(*b_args), f_call()
    def cell_order(counts):
        r = torch.arange(counts.numel(), dtype=torch.int32,
                         device=counts.device)
        return r.flip(0) if order == "reversed" else r

    if order != "again":
        monkeypatch.setattr(_ext, "longest_first", cell_order)
    for got, ref in ((step.cond(*b_args), ref_b), (f_call(), ref_f)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


VARIANTS = {
    "cloud": ({}, False),
    "rain": ({}, True),
    "euler": ({"adve_scheme": as_t.euler.value}, False),
    "open_side_walls": ({"open_side_walls": True}, False),
    "periodic_topbot_rain": ({"periodic_topbot_walls": True}, True),
}


def _check_transport_merge(cfg, n, rw2, rd3, kpa, x, z, cells):
    """Kernel C, then kernel D on C's output, against the plain versions:
    n, x, z, vt and the targets of every slot bitwise, the far-mover flag
    of every row exact and its puddle partials rel 1e-5 (summed in another
    order); then the seven merged planes lane by lane and the drops of
    every row bitwise.  Returns the plain versions' (C, D) results."""
    args = (cfg, 1.0, True, n, rw2, rd3, x, z) + tuple(cells)
    kc = _launches(_ext.TRANSPORT, lambda: step.transport(*args))
    pc = step.transport(*args, plain=True)
    for a, b in zip(kc[:5], pc[:5]):         # n x z vt targets
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])          # far-mover rows
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    planes = lambda c: (c[0], rw2, rd3, kpa, c[3], c[1], c[2], c[4])
    kd = _launches(_ext.MERGE, lambda: step.rebin_x(cfg, *planes(kc)))
    pd = step.rebin_x(cfg, *planes(pc), plain=True)
    for a, b in zip(kd, pd):                 # seven planes, then the drops
        assert torch.equal(a, b)
    # lanes past each row's last droplet are zero in every plane
    dead = kd[0] == 0
    assert all(float(p[dead].abs().sum()) == 0.0 for p in kd[1:7])
    return pc, pd


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transport_and_merge_kernels_match_plain(model, variant):
    """Kernels C and D on the 8x8 GMD case at row capacity 32 and 256, with
    the courants scaled up so that droplets cross cell faces, under each
    scheme and wall option, bitwise equal to their plain versions."""
    over, rain = VARIANTS[variant]
    cfg = dataclasses.replace(model.cfg, **over)
    d = model.dense_state
    n, rw2, z = d.n, d.rw2, d.z
    if rain:  # 1 mm drops in the lowest 20 m: the puddle fills
        alive = n > 0
        n = torch.where(alive, 2.0, 0.0)
        rw2 = torch.where(alive, 1e-6, 0.0)
        z = torch.where(alive, cfg.z0 + 20.0 * (z / cfg.z1), z)
    C = tuple(4.0 * c for c in dense._row_courants(cfg, d))
    pc, pd = _check_transport_merge(cfg, n, rw2, d.rd3, d.kpa, d.x, z,
                                    (d.T, d.p, d.rhod, d.eta) + C)
    assert int((pd[0] > 0).sum()) > 0
    if rain and not cfg.periodic_topbot_walls:
        assert float(pc[5][:, 3].sum()) > 0               # the puddle filled


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("nx,nz", [(3, 4), (8, 6)], ids=["nx3", "8x6"])
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 256, 512])
def test_transport_and_merge_kernels_on_synthetic_rows(dev, cap, nx, nz,
                                                      misaligned):
    """Kernels C and D at row capacity 2 to 512 (the scalar-slot form below
    128 and at 100, the 16-byte form at 128, 256 and 512, and the scalar
    form again where a plane is not 16-byte aligned), on a 3-column grid
    and an 8x6 one: rows all dead, full, half empty, with dead slots among
    the droplets, far movers, droplets falling into the puddle, and rows
    receiving more droplets than they hold (drops > 0); bitwise equal to
    their plain versions."""
    cfg, planes, cells = transport_case(nx, nz, cap, device=dev,
                                        dtype=torch.float32)
    if misaligned:  # the same values 4 bytes past a 16-byte boundary
        buf = torch.empty(planes[1].numel() + 1, dtype=torch.float32,
                          device=dev)
        rw2 = buf[1:].view(planes[1].shape)
        rw2.copy_(planes[1])
        planes = planes[:1] + (rw2,) + planes[2:]
    pc, pd = _check_transport_merge(cfg, *planes, cells)
    assert not bool((planes[0][0] > 0).any())              # an all-dead row
    assert float(pd[7].sum()) > 0                           # drops
    assert float(pc[5][:, 3].sum()) > 0                     # the puddle
    if nz >= 4 and cap >= 32:
        assert float(pc[5][:, 4].sum()) > 0                 # far movers


# kernel C's forms: subsidence (here beside sedimentation), no advection,
# and the vt refresh alone (nothing moves)
C_FORMS = {"subsidence": dict(do_sedi=True, do_adve=True, subs=True),
           "no_advection": dict(do_sedi=True, do_adve=False, subs=False),
           "subsidence_no_advection": dict(do_sedi=False, do_adve=False,
                                           subs=True),
           "vt_only": dict(do_sedi=False, do_adve=False, subs=False)}


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("form", list(C_FORMS))
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 512])
def test_transport_kernel_forms_match_plain(dev, cap, form, misaligned):
    """Kernel C's subsidence, no-advection and vt-only forms at row
    capacity 2 to 512, in the scalar-slot and the 16-byte layout, bitwise
    equal to transport_plain in every slot (the far flags exact, the
    puddle partials rel 1e-5); the vt-only form writes vt alone."""
    cfg, planes, cells = transport_case(8, 6, cap, device=dev,
                                        dtype=torch.float32)
    if misaligned:  # the same values 4 bytes past a 16-byte boundary
        buf = torch.empty(planes[1].numel() + 1, dtype=torch.float32,
                          device=dev)
        rw2 = buf[1:].view(planes[1].shape)
        rw2.copy_(planes[1])
        planes = planes[:1] + (rw2,) + planes[2:]
    n, rw2, rd3, kpa, x, z = planes
    f = C_FORMS[form]
    k_row = torch.arange(cfg.n_cell, device=dev) % cfg.nz
    w = torch.linspace(30.0, -5.0, cfg.nz, device=dev)[k_row] \
        if f["subs"] else None
    args = (cfg, 1.0, f["do_sedi"], n, rw2, rd3, x, z) + tuple(cells)
    kw = dict(do_adve=f["do_adve"], w_cells=w)
    kc = _launches(_ext.TRANSPORT, lambda: step.transport(*args, **kw))
    pc = step.transport(*args, **kw, plain=True)
    assert torch.equal(kc[3], pc[3])                      # vt
    if form == "vt_only":
        assert kc[4] is None and kc[5] is None
        assert kc[0] is n and kc[1] is x and kc[2] is z
        assert bool((kc[3][n > 0] > 0).all()) and bool((kc[3][n == 0] == 0)
                                                       .all())
        return
    for a, b in zip(kc[:5], pc[:5]):                      # n x z vt targets
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    assert float(pc[5][:, 3].sum()) > 0                   # the puddle
    live = n > 0
    if not f["do_adve"]:   # only the walls move x
        assert torch.equal(kc[1][live], x[live])


def test_dense_front_on_the_card(dev):
    """Kinematic2D over the dense front (the factory's choice on the card):
    its stepwise run launches kernels A (a field a call), B, C, D and E
    and equals run_device_lgrngn(engine="dense") bitwise; against its plain
    run th rel 2e-6, rv 2e-5, the same SDs in every row."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw={"kernel_parameters": [100.0]},
              device=dev)
    front, fused, plain = (Kinematic2D(**kw) for _ in range(3))
    assert isinstance(front.prtcls, particles_dense_t)
    before = {k.name: k.launches for k in _ext.KERNELS}
    front.run(4, spinup=2)
    torch.cuda.synchronize()
    got = {k.name: k.launches - before[k.name] for k in _ext.KERNELS}
    none = {k.name: 0 for k in _ext.KERNELS}
    assert got == dict(none, mpdata=8, cond=4, transport=4, merge=4, coal=2)
    fused.run_device_lgrngn(4, spinup=2, engine="dense")
    plain.run(4, spinup=2, plain=True)
    assert torch.equal(front.th, fused.th) and torch.equal(front.rv, fused.rv)
    a, b, p = front.dense_state, fused.dense_state, plain.dense_state
    for k in dense.ATTRS:
        ma = multiset(a.n.cpu(), (getattr(a, k).cpu(),))
        mb = multiset(b.n.cpu(), (getattr(b, k).cpu(),))
        assert np.array_equal(ma, mb), k
    assert _rel(front.th, plain.th) <= 2e-6
    assert _rel(front.rv, plain.rv) <= 2e-5
    assert torch.equal((a.n > 0).sum(1), (p.n > 0).sum(1))
    assert int(a.overflow) == 0


def test_repack_and_policy_on_the_card(dev):
    """dense.repack on the card equals its run on the CPU lane by lane; the
    repack policy on the card (powers of two) with the kernels against its
    plain run: the same chunk log, th rel 2e-6, rv 2e-5."""
    kw = dict(nx=8, nz=8, sd_conc=30, sstp_cond=3, n_sd_max=30 * 64,
              opts_init_kw={"coal_switch": False}, device=dev)
    m = Kinematic2D(**kw)
    d = m.dense_state
    cpu = dataclasses.replace(d, **{a: getattr(d, a).cpu()
                                    for a in dense.ATTRS},
                              overflow=d.overflow.cpu())
    for cap in (32, 128, 16):
        g, c = dense.repack(m.cfg, d, cap), dense.repack(m.cfg, cpu, cap)
        for a in dense.ATTRS:
            assert torch.equal(getattr(g, a).cpu(), getattr(c, a)), a
        assert int(g.overflow) == int(c.overflow)
    assert int(dense.repack(m.cfg, d, 16).overflow) > 0
    logs = [], []
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    mk.dense_state = dense.repack(mk.cfg, mk.dense_state, 32)
    mp.dense_state = dense.repack(mp.cfg, mp.dense_state, 32)
    mk.run_device_lgrngn(8, spinup=2, engine="dense", repack_every=2,
                         chunk_log=logs[0])
    mp.run_device_lgrngn(8, spinup=2, engine="dense", repack_every=2,
                         chunk_log=logs[1], plain=True)
    key = lambda log: [(e["occ"], e["cap"], e["redo"]) for e in log]
    assert key(logs[0]) == key(logs[1])
    # ~30 SDs at capacity 32: less than 10% headroom (or a row
    # overflowed and the chunk ran again), so the policy grows to 64
    assert logs[0][0]["cap"] == 64
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5


def test_repack_policy_refuses_past_512_on_the_card(dev):
    """A densest row that needs more than kernel E's 512 slots raises, with
    the occupancy in the message, and drops no SD."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=420, sstp_cond=2, n_sd_max=420 * 64,
                    opts_init_kw={"coal_switch": False}, device=dev)
    m.dense_state = dense.repack(m.cfg, m.dense_state, 512)
    with pytest.raises(RuntimeError, match="SDs, which needs capacity 1024"):
        m.run_device_lgrngn(4, spinup=4, engine="dense", repack_every=2)


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
    args = list(_cond_args(model, 44.0))
    args[5] = args[5].t().contiguous().t()           # strided rw2 plane
    with pytest.raises(ValueError, match="contiguous"):
        step.cond(*args)
    args = list(_cond_args(model, 44.0))
    args[5] = args[5][:, :-1].contiguous()           # rw2 plane too narrow
    with pytest.raises(ValueError, match="SD planes"):
        step.cond(*args)
    args[5] = _cond_args(model, 44.0)[5]
    args[8] = args[8][:-1]                           # one cell short
    with pytest.raises(ValueError, match="cell fields"):
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


def _coal_run(form, args):
    """Kernel E in ``form`` and its plain version on ``args``: (kernel
    out, plain out, the order (n rd3 kpa rw2 x z [vt]) of their planes)."""
    if form == "standalone":
        run = lambda plain: coal.coal_standalone(*args, plain=plain)
        k = _launches(_ext.COAL_STANDALONE, lambda: run(False))
        return k, run(True), (0, 2, 3, 1, 5, 6, 4)   # n rd3 kpa rw2 x z vt
    run = lambda plain: coal.coal_resident(*args, pairing=form, plain=plain)
    kernel = coal.resident_kernel(args[0], args[6].shape[1])
    k = _launches(kernel, lambda: run(False))
    return k, run(True), (0, 2, 3, 1, 4, 5)          # n rd3 kpa rw2 x z


@pytest.mark.parametrize("name", list(COAL_KERNELS))
@pytest.mark.parametrize("form", ["stride", "sort", "standalone"])
@pytest.mark.parametrize("cap", [2, 8, 32, 64, 128, 256, 512])
def test_coal_kernel_matches_plain(coal_model, cap, form, name):
    """Kernel E at row capacity 2 to 512 (one register slot a lane, some
    lanes holding no slot, up to 16 register slots), bitwise equal to its
    plain version lane by lane."""
    model = coal_model
    kernel, params = COAL_KERNELS[name]
    cfg = _coal_cfg(model, kernel)
    planes, cells = _coal_rows(model.device, cap, rows=max(48, 1024 // cap))
    args = (cfg, params, 10, 100.0, 44, 3) + planes + cells
    k, p, order = _coal_run(form, args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
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


@pytest.mark.parametrize("form", ["stride", "sort", "standalone"])
@pytest.mark.parametrize("cap", [32, 128])
def test_coal_kernel_where_collisions_empty_an_sd(coal_model, cap, form):
    """Every pair collides at once, and the big SD's multiplicity is an
    exact multiple of the small one's (equal in half the rows, powers of
    two in the others), so collisions leave SDs at n == 0 between shuffles:
    the kernel may not take the live SDs to come first.  Bitwise equal to
    the plain version lane by lane."""
    model = coal_model
    planes, cells = _coal_rows(model.device, cap, rows=16, seed=5)
    n = planes[0]
    mult = torch.where(torch.arange(16, device=n.device)[:, None] % 2 == 0,
                       1000.0, 1000.0 * 2.0 ** (torch.arange(
                           cap, device=n.device) % 3).float())
    n = torch.where(n > 0, mult, 0.0)
    cells = cells[:4] + (cells[4] * 1e-12,)
    args = (_coal_cfg(model, kernel_t.geometric), (), 6, 100.0, 44, 3, n) \
        + planes[1:] + cells
    k, p, _ = _coal_run(form, args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int(((n > 0) & (k[0] == 0)).sum()) > 0     # SDs were emptied


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
    with pytest.raises(ValueError, match="pairing"):
        coal.coal_resident(cfg, (), 2, 1.0, 44, 0, *planes, *cells,
                           pairing="xor")


# ------------------------------------------- the formulas off the main path
# (the main path runs beard77fast, which the kernels compute as beard77)
OTHER_VT = [vt_t.beard76, vt_t.khvorostyanov_spherical,
            vt_t.khvorostyanov_nonspherical, vt_t.undefined]


def _with_vt(cfg, formula):
    return dataclasses.replace(cfg, terminal_velocity=formula.value)


@pytest.mark.parametrize("formula", OTHER_VT, ids=lambda f: f.name)
def test_vt_kernel_matches_plain_at_every_radius(dev, formula):
    """Kernel C's vt-only form on radii of 1 nm to 5 mm (every regime of
    beard76, Khvorostyanov's float64 evaluation where float32 cancels)
    and dead slots, in four cells of different T, p, rhod and eta: bitwise
    equal to vt_in_kernel, finite, positive where alive."""
    cfg, planes, cells = transport_case(8, 6, 128, device=dev,
                                        dtype=torch.float32)
    n, rw2 = planes[0], planes[1]
    rng = np.random.default_rng(5)
    rw = np.exp(rng.uniform(np.log(1e-9), np.log(5e-3), tuple(rw2.shape)))
    rw2 = torch.as_tensor(rw ** 2, dtype=torch.float32, device=dev)
    args = (_with_vt(cfg, formula), 1.0, False, n, rw2, planes[2],
            planes[4], planes[5]) + tuple(cells)
    kc = _launches(_ext.TRANSPORT,
                   lambda: step.transport(*args, do_adve=False))
    pc = step.transport(*args, do_adve=False, plain=True)
    assert torch.equal(kc[3], pc[3])
    assert bool(torch.isfinite(kc[3]).all())
    live = n > 0
    if formula == vt_t.undefined:
        assert not bool(kc[3].any())
    else:
        assert bool((kc[3][live] > 0).all())
    assert not bool(kc[3][~live].any())


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
@pytest.mark.parametrize("formula", OTHER_VT, ids=lambda f: f.name)
def test_cond_kernel_under_formula_matches_plain(model, formula, RH_max):
    """Kernel B with the stale vt rebuilt by each formula: the gates of
    test_cond_kernel_matches_plain."""
    args = list(_cond_args(model, RH_max))
    args[0] = _with_vt(args[0], formula)
    k = _launches(_ext.COND, lambda: step.cond(*args))
    p = step.cond(*args, plain=True)
    alive = model.dense_state.n > 0
    assert _rel(k[1], p[1]) <= 2e-6
    assert _rel(k[2], p[2]) <= 2e-5
    assert _rel(k[0][alive], p[0][alive]) <= 1e-5
    assert torch.equal(k[0][~alive], p[0][~alive])
    assert bool(torch.isfinite(k[0]).all())


@pytest.mark.parametrize("form", ["full", "subsidence", "vt_only"])
@pytest.mark.parametrize("formula", OTHER_VT, ids=lambda f: f.name)
def test_transport_kernel_under_formula_matches_plain(dev, formula, form):
    """Kernel C under each formula, with the walls, the puddle and far
    movers of transport_case, and in its subsidence and vt-only forms:
    bitwise equal to transport_plain in every slot, far flags exact, the
    puddle partials rel 1e-5; kernel D after the full form, lane by
    lane."""
    cfg, planes, cells = transport_case(8, 6, 128, device=dev,
                                        dtype=torch.float32)
    cfg = _with_vt(cfg, formula)
    if form == "full":
        _check_transport_merge(cfg, *planes, cells)
        return
    n, rw2, rd3, kpa, x, z = planes
    w = torch.linspace(30.0, -5.0, cfg.nz, device=dev)[
        torch.arange(cfg.n_cell, device=dev) % cfg.nz]
    f = dict(do_adve=True, w_cells=w) if form == "subsidence" else \
        dict(do_adve=False)
    args = (cfg, 1.0, form == "subsidence", n, rw2, rd3, x, z) + tuple(cells)
    kc = _launches(_ext.TRANSPORT, lambda: step.transport(*args, **f))
    pc = step.transport(*args, **f, plain=True)
    for a, b in zip(kc[:5], pc[:5]):
        assert (a is None and b is None) or torch.equal(a, b)
    if form == "subsidence":
        assert torch.equal(kc[5][:, 4], pc[5][:, 4])
        assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5,
                              atol=0.0)


@pytest.mark.parametrize("form", ["stride", "sort", "standalone"])
@pytest.mark.parametrize("cap", [32, 128, 512])
@pytest.mark.parametrize("formula", OTHER_VT, ids=lambda f: f.name)
def test_coal_kernel_under_formula_matches_plain(coal_model, formula, cap,
                                                 form):
    """Kernel E under each formula (vt at load, after each collision, and
    the standalone form's output), geometric kernel: bitwise equal to its
    plain version lane by lane, the overflow flags exact; collisions
    happen but under undefined, where every vt is 0."""
    model = coal_model
    cfg = _with_vt(_coal_cfg(model, kernel_t.geometric), formula)
    planes, cells = _coal_rows(model.device, cap, rows=max(48, 1024 // cap))
    args = (cfg, (2.0,), 10, 100.0, 44, 3) + planes + cells
    k, p, _ = _coal_run(form, args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    lost = float(planes[0].double().sum() - p[0].double().sum())
    assert (lost > 0) == (formula != vt_t.undefined)


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
# cell sizes (live droplets) and cell 0's dead slots: the GMD case's ~64 a
# cell with an empty cell; a cell of 700, many chunks of 32 droplets a
# warp; cell 0 holding thousands of dead slots
FLAT_CASES = {
    "gmd": ([64, 57, 0, 71, 64, 90, 33, 64], 0),
    "long_cell": ([64, 0, 700, 64, 5, 64, 64, 64], 0),
    "dead_cell0": ([64, 64, 0, 64, 70, 64, 58, 64], 5000),
}
FLAT_CONFIGS = {
    "th_dry": dict(), "var_rho": dict(var_rho=True),
    "th_std": dict(th_dry=False), "const_p": dict(const_p=True),
}


def _flat_case(dev, case, config, seed=0):
    sizes, dead0 = FLAT_CASES[case]
    over = dict(FLAT_CONFIGS[config])
    var_rho = over.pop("var_rho", False)
    cfg, kw = flat_cond_case(sizes, dead0, seed, dev, torch.float32, **over)
    return cfg, dict(kw, var_rho=var_rho)


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
@pytest.mark.parametrize("config", list(FLAT_CONFIGS))
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_cond_flat_kernel_matches_plain(dev, case, config, RH_max):
    """Kernel F against its plain version (the host substep loop) on
    cell-sorted segments with an empty cell, a cell longer than a warp's
    slots and cell 0 full of dead slots, under each closure and with rhod
    substepped: live droplets rw2 rel 1e-5, th 2e-6, rv 2e-5 (the cell
    sums add in another order), dead slots copied through."""
    cfg, kw = _flat_case(dev, case, config)
    k = _launches(_ext.COND_FLAT,
                  lambda: cond_ops.cond_flat(cfg, RH_max=RH_max, **kw))
    p = cond_ops.cond_flat(cfg, RH_max=RH_max, plain=True, **kw)
    live = kw["wgt"] > 0
    assert _rel(k[0][live], p[0][live]) <= 1e-5
    assert torch.equal(k[0][~live], kw["rw2"][~live])
    assert _rel(k[1], p[1]) <= 2e-6          # th
    assert _rel(k[2], p[2]) <= 2e-5          # rv
    assert _rel(k[3], p[3]) <= 1e-7          # rhod
    assert _rel(k[0][live], kw["rw2"][live]) > 1e-3   # droplets grew
    empty = kw["ends"] == torch.cat([kw["ends"].new_full((1,), -1),
                                     kw["ends"][:-1]])
    if bool(empty.any()):                    # no latent heat in empty cells
        assert torch.equal(k[1][empty], p[1][empty])


def test_cond_flat_wrapper_refuses_what_the_kernel_does_not_take(dev):
    cfg, kw = _flat_case(dev, "gmd", "th_dry")
    call = lambda **over: cond_ops.cond_flat(cfg, RH_max=44.0,
                                             **dict(kw, **over))
    with pytest.raises(TypeError, match="float32"):
        call(rw2=kw["rw2"].double())
    with pytest.raises(TypeError, match="float32"):
        call(th=kw["th"].double())
    with pytest.raises(TypeError, match="int64"):
        call(ends=kw["ends"].int())
    strided = torch.stack([kw["rd3"], kw["rd3"]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        call(rd3=strided)
    with pytest.raises(ValueError, match="one length"):
        call(kpa=kw["kpa"][:-1])
    with pytest.raises(ValueError, match="cell fields"):
        call(dv=kw["dv"][:-1])


def test_flat_slice_kernels_match_plain(dev):
    """Two spin-up and two coalescing steps of the 8x8 case on the flat
    engine through the public API, kernels against plain versions: kernel
    F runs once a step and kernel A twice, and the fields, the population
    and the draws agree."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw={"kernel_parameters": [100.0]},
              engine="flat", device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    before = {k.name: k.launches for k in _ext.KERNELS}
    mk.run(4, spinup=2)
    torch.cuda.synchronize()
    assert _ext.COND_FLAT.launches == before["cond_flat"] + 4
    assert _ext.MPDATA.launches == before["mpdata"] + 4 * 2
    mp.run(4, spinup=2, plain=True)
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5
    sk, sp = mk.prtcls.state, mp.prtcls.state
    assert torch.equal(sk.n, sp.n) and torch.equal(sk.ijk, sp.ijk)
    assert _rel(sk.rw2[sk.n > 0], sp.rw2[sp.n > 0]) <= 1e-5


# ---------------------------------------------------------------- kernel G
def _g_args(pop):
    return [pop[k] for k in ("rw2", "rd3", "kpa", "vt", "rhod", "rv", "T",
                             "p", "RH", "eta", "lam_D", "lam_K")]


def _check_g(args, dt, RH_max):
    """Kernel G against its plain version on ``args``: bitwise in every
    slot; slots with rw2 <= 0 keep it.  Returns the kernel's rw2."""
    k = _launches(_ext.COND_SD,
                  lambda: cond_ops.advance_rw2(dt, *args, RH_max))
    p = cond_ops.advance_rw2(dt, *args, RH_max, plain=True)
    assert torch.equal(k, p)
    kept = args[0] <= 0
    assert torch.equal(k[kept], args[0][kept])
    return k


@pytest.mark.parametrize("RH_max", [1.01, 44.0], ids=["spinup", "main"])
@pytest.mark.parametrize("kind", ["mixed", "activating", "evaporating"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 32773, 369664])
def test_cond_sd_kernel_matches_plain(dev, n, kind, RH_max):
    """Kernel G (one thread a droplet, grid-stride, whole warps) bitwise
    equal to its plain version on lengths up to the GMD case's 369,664
    droplets, ragged warps included, for a scalar dt and a dt a droplet
    (the adaptive phase B's form), on haze in sub- and supersaturated air,
    activating and evaporating droplets; the droplets change."""
    pop = ambient_population(n, kind, seed=n, device=dev)
    args = _g_args(pop)
    k = _check_g(args, 0.1, RH_max)
    dt = torch.full((n,), 0.1, device=dev)
    dt[::3] = 1.0 / 7
    _check_g(args, dt, RH_max)
    live = args[0] > 0
    if n > 32:
        d = k[live] - args[0][live]
        if kind == "evaporating":
            assert bool((d < 0).all())
        elif kind == "activating":
            assert bool((d > 0).any())
        else:
            assert bool((d > 0).any()) and bool((d < 0).any())


def test_cond_sd_kernel_on_dead_and_nonpositive_slots(dev):
    """All slots dead (rw2 = 0), rw2 < 0, and dead slots with zeroed
    ambient fields beside live droplets: kept as they are, bitwise equal
    to the plain version; n = 0 launches nothing."""
    n = 65536
    pop = ambient_population(n, "mixed", seed=4, device=dev)
    args = _g_args(pop)
    _check_g([torch.zeros_like(args[0])] + args[1:], 0.1, 44.0)
    _check_g([torch.full_like(args[0], -1e-14)] + args[1:], 0.1, 44.0)
    dead = torch.arange(n, device=dev) % 3 == 0
    zeroed = [torch.where(dead, 0.0, a) for a in args]
    k = _check_g(zeroed, 0.1, 1.01)
    assert bool(torch.isfinite(k).all())
    empty = [a[:0] for a in args]
    before = _ext.COND_SD.launches
    out = cond_ops.advance_rw2(0.1, *empty, 44.0)
    assert out.shape == (0,) and _ext.COND_SD.launches == before


def test_cond_sd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    args = _g_args(ambient_population(64, device=dev))
    call = lambda i, v, dt=0.1: cond_ops.advance_rw2(
        dt, *(v if j == i else a for j, a in enumerate(args)), 44.0)
    with pytest.raises(TypeError, match="float32"):
        call(0, args[0].double())
    with pytest.raises(TypeError, match="float32"):
        call(-1, None, dt=torch.full((64,), 0.1, device=dev,
                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        call(3, torch.stack([args[3], args[3]], 1)[:, 0])
    with pytest.raises(ValueError, match="one length"):
        call(5, args[5][:-1])
    with pytest.raises(ValueError, match="one CUDA device"):
        call(6, args[6].cpu())


EXACT_MODES = {
    "mix": (3, dict(exact_sstp_cond=True)),
    "nomix": (3, dict(exact_sstp_cond=True, sstp_cond_mix=False)),
    "adaptive": (4, dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                         sstp_cond_act=8)),
}


@pytest.mark.parametrize("mode", list(EXACT_MODES))
def test_exact_slice_kernels_match_plain(dev, mode):
    """Two spin-up and two coalescence-free steps of the 8x8 case with
    exact per-particle substepping, through the public API on the card's
    flat engine (engine="flat"; the factory's own pick there is the dense
    front, test_dense_exact_kernels_match_plain):
    kernel G's fixed-count or adaptive form runs once a step, its
    one-substep entry and kernels F and B never, and the kernel path
    equals the plain path bitwise (G's forms are bitwise their plain
    versions; with in-cell mixing the kernel's float64 butterfly sums
    round to the float32 bits of the plain path's float64 cumulative
    sums)."""
    sstp, oi = EXACT_MODES[mode]
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=sstp, sstp_coal=3,
              n_sd_max=24 * 64 + 100,
              opts_init_kw=dict(oi, coal_switch=False), engine="flat",
              device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    assert type(mk.prtcls).__name__ == "particles_t"
    rw0 = mk.prtcls.state.rw2
    before = {k.name: k.launches for k in _ext.KERNELS}
    mk.run(4, spinup=2)
    torch.cuda.synchronize()
    form = _ext.COND_SD_ADAPTIVE if mode == "adaptive" else _ext.COND_SD_FIXED
    assert form.launches == before[form.name] + 4
    for k in (_ext.COND_SD, _ext.COND_FLAT, _ext.COND):
        assert k.launches == before[k.name], k.name
    mp.run(4, spinup=2, plain=True)
    sk, sp = mk.prtcls.state, mp.prtcls.state
    assert torch.equal(mk.th, mp.th) and torch.equal(mk.rv, mp.rv)
    for k in ("n", "rw2", "ijk", "sstp_tmp_th", "sstp_tmp_rv",
              "sstp_tmp_rh", "sstp_tmp_p"):
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
    assert _rel(sk.rw2[sk.n > 0], rw0[sk.n > 0]) > 1e-3   # droplets grew


@pytest.mark.parametrize("mode", list(EXACT_MODES))
def test_dense_exact_kernels_match_plain(dev, mode):
    """The same case on the dense engine, the factory's pick on the card:
    the dense front's stepwise run launches G's fixed-count or adaptive
    form and D's 11-plane form once a step, and B, F, D's 7-plane form and
    G's one-substep entry never; it equals run_device_lgrngn(engine=
    "dense") bitwise, and that equals its plain path bitwise (G's forms
    and D bitwise; with in-cell mixing the kernel's float64 butterfly
    sums round to the float32 bits of the plain path's float64 row
    sums)."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    sstp, oi = EXACT_MODES[mode]
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=sstp, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw=dict(oi, coal_switch=False),
              device=dev)
    front, fused, plain = (Kinematic2D(**kw) for _ in range(3))
    assert isinstance(front.prtcls, particles_dense_t)
    rw0 = front.dense_state.rw2
    before = {k.name: k.launches for k in _ext.KERNELS}
    front.run(4, spinup=2)
    torch.cuda.synchronize()
    got = {k.name: k.launches - before[k.name] for k in _ext.KERNELS}
    adaptive = mode == "adaptive"
    none = {k.name: 0 for k in _ext.KERNELS}
    assert got == dict(none, mpdata=8, transport=4, merge_exact=4,
                       cond_sd_fixed=0 if adaptive else 4,
                       cond_sd_adaptive=4 if adaptive else 0)
    fused.run_device_lgrngn(4, spinup=2, engine="dense")
    plain.run_device_lgrngn(4, spinup=2, engine="dense", plain=True)
    for m in (fused, plain):
        assert torch.equal(front.th, m.th) and torch.equal(front.rv, m.rv)
    a, b, p = front.dense_state, fused.dense_state, plain.dense_state
    for k in dense.attrs_of(front.cfg):
        ma = multiset(a.n.cpu(), (a.rd3.cpu(), getattr(a, k).cpu()))
        assert np.array_equal(ma, multiset(b.n.cpu(), (
            b.rd3.cpu(), getattr(b, k).cpu()))), k
        assert np.array_equal(ma, multiset(p.n.cpu(), (
            p.rd3.cpu(), getattr(p, k).cpu()))), k
    assert _rel(a.rw2[a.n > 0], rw0[a.n > 0]) > 1e-3     # droplets grew
    assert int(a.overflow) == 0


def test_cond_sd_kernel_on_dense_planes(dev):
    """G's one-substep entry on the ravelled planes of a dense exact
    state's first substep (the dead slots of every row included, rw2 ==
    0), as the plain path's fixed-count form calls it, bitwise equal to
    its plain version; the dead slots keep their rw2."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
                    opts_init_kw={"exact_sstp_cond": True,
                                  "coal_switch": False}, device=dev)
    seen = []
    real = cond_ops.advance_rw2

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    cond_ops.advance_rw2 = spy
    try:
        m.run_device_lgrngn(1, engine="dense", plain=True)
    finally:
        cond_ops.advance_rw2 = real
    args, kw = seen[0]
    kw = {k: v for k, v in kw.items() if k != "plain"}
    assert args[1].numel() == m.dense_state.n.numel()
    out = _launches(_ext.COND_SD, lambda: cond_ops.advance_rw2(*args, **kw))
    assert torch.equal(out, cond_ops.advance_rw2(*args, **kw, plain=True))
    dead = args[1] <= 0
    assert bool(dead.any()) and torch.equal(out[dead], args[1][dead])


# ------------------------------------------------- kernel G's two forms
# cells of more than 32, exactly 32, 1 and 0 live SDs, and full rows
def _g_counts(cap, n_cell=96, seed=0):
    rng = np.random.default_rng(seed)
    base = [0, 1, 31, 32, 33, 64] + ([cap // 2, cap] if cap else [70, 140])
    return base + list(rng.integers(0, cap or 100, n_cell - len(base)))


def _check_form(kernel, f, cfg, sd, cells, seg, **kw):
    """One of G's forms against its plain version on the card: rw2 in
    every slot and the live SDs' private state bitwise, with in-cell
    mixing (the butterfly sums add in another order) B's and F's gates:
    th rel 2e-6, rv 2e-5, rw2 1e-5, and the slots it does not advance
    (n <= 0 and rw2 <= 0) bitwise.  A dead slot's private values are
    not compared: the kernel keeps them, where the plain version may
    leave them non-finite (0 * 0 / 0).  Returns the kernel's results."""
    k = _launches(kernel, lambda: f(cfg, 1.0, 44.0, sd, cells, seg, **kw))
    p = f(cfg, 1.0, 44.0, sd, cells, seg, plain=True, **kw)
    live = sd[0] > 0
    if kernel in (_ext.COND_SD_FIXED, _ext.COND_SD_FIXED_TURB,
                  _ext.COND_SD_FIXED_PARCEL, _ext.COND_SD_FIXED_PARCEL_TURB) \
            and cfg.sstp_cond_mix:
        kept = ~live & (sd[1] <= 0)
        assert torch.equal(k[0][kept], p[0][kept])
        assert _rel(k[0][live], p[0][live]) <= 1e-5
        assert _rel(k[2][live], p[2][live]) <= 2e-6     # th
        assert _rel(k[1][live], p[1][live]) <= 2e-5     # rv
        assert torch.equal(k[3][live], p[3][live])      # rhod
        assert torch.equal(k[4][live], p[4][live])      # p
    else:
        assert torch.equal(k[0], p[0])
        for a, b in zip(k[1:], p[1:]):
            assert torch.equal(a[live], b[live])
    assert bool(torch.isfinite(k[0]).all())
    if bool(live.any()):
        assert bool((k[0] != sd[1])[live].any())        # droplets grew
    return k


FIXED_MODES = {"mix": {}, "nomix": dict(sstp_cond_mix=False),
               "mix_const_p": dict(const_p=True, th_dry=False),
               "nomix_const_p": dict(sstp_cond_mix=False, const_p=True,
                                     th_dry=False)}


@pytest.mark.parametrize("mode", list(FIXED_MODES))
@pytest.mark.parametrize("cap", [128, 512])
def test_cond_sd_fixed_on_dense_rows(dev, cap, mode):
    """G's fixed-count form on dense rows of capacity 128 and 512: rows of
    0 to cap live SDs, a hole (n == 0, rw2 kept) in each, dead tails."""
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=cap), cap=cap, seed=1, device=dev,
        dtype=torch.float32, sstp_cond=10, **FIXED_MODES[mode])
    _check_form(_ext.COND_SD_FIXED, cond_ops.perparticle_fixed, cfg, sd,
                cells[:7], seg)


@pytest.mark.parametrize("mode", list(FIXED_MODES))
def test_cond_sd_fixed_on_flat_segments(dev, mode):
    """G's fixed-count form on the flat engine's cell-sorted segments of 0
    to 140 live SDs (in a shuffled slot order), cell 0 also holding 300
    dead slots, half with the rw2 they died with."""
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(None), dead0=300, seed=2, device=dev, dtype=torch.float32,
        sstp_cond=10, **FIXED_MODES[mode])
    _check_form(_ext.COND_SD_FIXED, cond_ops.perparticle_fixed, cfg, sd,
                cells[:7], seg)


ADAPTIVE_MODES = {"act1": dict(sstp_cond_act=1),
                  "act16": dict(sstp_cond_act=16),
                  "act16_const_p": dict(sstp_cond_act=16, const_p=True,
                                        th_dry=False)}


@pytest.mark.parametrize("mode", list(ADAPTIVE_MODES))
@pytest.mark.parametrize("layout", ["cap128", "cap512", "flat"])
def test_cond_sd_adaptive_matches_plain(dev, layout, mode):
    """G's adaptive form on dense rows of capacity 128 and 512 and on
    flat segments, with sstp_cond_act 1 and 16 (above sstp_cond 10):
    bitwise equal to its plain version."""
    cap = None if layout == "flat" else int(layout[3:])
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=cap or 0), cap=cap, dead0=300, seed=3,
        device=dev, dtype=torch.float32, sstp_cond=10,
        adaptive_sstp_cond=True, **ADAPTIVE_MODES[mode])
    _check_form(_ext.COND_SD_ADAPTIVE, cond_ops.perparticle_adaptive, cfg,
                sd, cells, seg)


def test_cond_sd_forms_refuse_what_the_kernels_do_not_take(dev):
    cfg, sd, cells, _ = perparticle_case([3, 40], cap=64, seed=4,
                                         device=dev, dtype=torch.float32)
    _, sd_f, cells_f, seg = perparticle_case([3, 40], seed=4, device=dev,
                                             dtype=torch.float32)

    def fixed(sd=sd, cells=cells[:7], seg=None):
        return cond_ops.perparticle_fixed(cfg, 1.0, 44.0, sd, cells, seg)

    with pytest.raises(TypeError, match="float32"):
        fixed(sd=(sd[0].double(),) + sd[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fixed(sd=sd[:2] + (sd[2].t().contiguous().t(),) + sd[3:])
    with pytest.raises(ValueError, match="one CUDA device"):
        fixed(cells=(cells[0].cpu(),) + cells[1:7])
    with pytest.raises(ValueError, match="dense rows must be"):
        fixed(sd=tuple(a[:1] for a in sd))
    with pytest.raises(TypeError, match="int64"):
        fixed(sd=sd_f, cells=cells_f[:7],
              seg=(seg[0], seg[1].int(), seg[2]))
    with pytest.raises(ValueError, match="cell arrays"):
        cond_ops.perparticle_adaptive(cfg, 1.0, 44.0, sd, cells[:7])
    # a cell-sorted layout without SDs launches and returns empty arrays
    empty = tuple(a[:0] for a in sd_f)
    none = torch.full_like(seg[2], -1)
    out = _launches(_ext.COND_SD_FIXED, lambda: cond_ops.perparticle_fixed(
        cfg, 1.0, 44.0, empty, cells_f[:7], (seg[0][:0], seg[1][:0], none)))
    assert all(a.shape == (0,) for a in out)


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 256, 512])
def test_merge_kernel_with_eleven_planes(dev, cap, misaligned):
    """D's 11-plane form (the exact mode's private planes riding) on
    transport_case's rows at capacity 2 to 512 in both layouts, bitwise
    equal to its plain version, and its first seven planes bitwise equal
    to the 7-plane form's."""
    cfg, planes, cells = transport_case(8, 6, cap, device=dev,
                                        dtype=torch.float32)
    pc = step.transport(cfg, 1.0, True, *planes[:3], *planes[4:], *cells,
                        plain=True)
    rng = np.random.default_rng(cap)
    extra = tuple(torch.as_tensor(rng.uniform(lo, hi, planes[0].shape),
                                  dtype=torch.float32, device=dev)
                  for lo, hi in ((285.0, 300.0), (5e-3, 9e-3), (0.9, 1.2),
                                 (8.5e4, 1e5)))
    if misaligned:  # sd_rv 4 bytes past a 16-byte boundary
        buf = torch.empty(extra[1].numel() + 1, dtype=torch.float32,
                          device=dev)
        rv = buf[1:].view(extra[1].shape)
        rv.copy_(extra[1])
        extra = (extra[0], rv) + extra[2:]
    seven = (pc[0], planes[1], planes[2], planes[3], pc[3], pc[1], pc[2],
             pc[4])
    kd = _launches(_ext.MERGE_EXACT, lambda: step.rebin_x(cfg, *seven,
                                                          extra=extra))
    pd = step.rebin_x(cfg, *seven, extra=extra, plain=True)
    assert len(kd) == 12
    for a, b in zip(kd, pd):                 # eleven planes, the drops
        assert torch.equal(a, b)
    k7 = _launches(_ext.MERGE, lambda: step.rebin_x(cfg, *seven))
    for a, b in zip(k7, kd[:7] + kd[11:]):
        assert torch.equal(a, b)
    assert float(pd[11].sum()) > 0                          # drops
    with pytest.raises(ValueError, match="0 or 4 extra planes"):
        step.rebin_x(cfg, *seven, extra=extra[:2])


# ------------------------------------------------------- the x-slab mesh
# (col0, ncol) of a shard's three columns on transport_case's 8-column grid:
# the first slab (movers past x = 0), an inner one, and the last (x1)
MESH_SLABS = {"first": (0, 2), "inner": (3, 2), "last": (5, 3)}


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("slab", list(MESH_SLABS))
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 256, 512])
def test_transport_unwrapped_kernel_matches_plain(dev, cap, slab, misaligned):
    """Kernel C's unwrapped form (a shard of the x-slab mesh) at row
    capacity 2 to 512, in the 16-byte and the scalar-slot layout, on the
    rows of a slab of three columns with the courants times 8, so that
    droplets leave the slab on both sides and the domain at x = 0 and x1:
    n, x, z, vt and the targets bitwise equal to transport_plain in every
    slot, the far flags exact, the puddle partials rel 1e-5, one launch
    counted as TRANSPORT_UNWRAPPED."""
    col0, ncol = MESH_SLABS[slab]
    cfg, planes, cells = transport_case(8, 6, cap, device=dev,
                                        dtype=torch.float32)
    rows = slice(col0 * 6, (col0 + 3) * 6)
    n, rw2, rd3, kpa, x, z = (p[rows].contiguous() for p in planes)
    # a droplet 5 m past each side of the slab in its edge column's rows
    n[:6, 0], x[:6, 0] = 1e6, col0 * 20.0 - 5.0
    n[(ncol - 1) * 6:ncol * 6, 0] = 1e6
    x[(ncol - 1) * 6:ncol * 6, 0] = (col0 + ncol) * 20.0 + 5.0
    if misaligned:  # the same values 4 bytes past a 16-byte boundary
        buf = torch.empty(rw2.numel() + 1, dtype=torch.float32, device=dev)
        buf[1:].view(rw2.shape).copy_(rw2)
        rw2 = buf[1:].view(rw2.shape)
    cc = tuple(c[rows].contiguous() for c in cells[:4]) \
        + tuple(8.0 * c[rows] for c in cells[4:])
    args = (cfg, 1.0, True, n, rw2, rd3, x, z) + cc
    kw = dict(slab=(col0, ncol))
    before = _ext.TRANSPORT.launches
    kc = _launches(_ext.TRANSPORT_UNWRAPPED,
                   lambda: step.transport(*args, **kw))
    assert _ext.TRANSPORT.launches == before
    pc = step.transport(*args, **kw, plain=True)
    for a, b in zip(kc[:5], pc[:5]):         # n x z vt targets
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    live, x_out = pc[0] > 0, pc[1]
    col = step.column_of(cfg, x_out)
    left = live & ((col < col0) | (x_out < cfg.x0))
    right = live & ((col >= col0 + ncol) | (x_out >= cfg.x1))
    assert bool((pc[4][left | right] == -1).all())
    assert bool(left.any()) and bool(right.any())


@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [32, 128, 512])
def test_coal_kernel_with_row0_matches_plain(coal_model, cap, form):
    """Kernel E keyed by the global row (row0 of a mesh shard) bitwise
    equal to its plain version lane by lane, and equal to the same rows of
    a call on the grid they are part of."""
    cfg = _coal_cfg(coal_model, kernel_t.geometric)
    planes, cells = _coal_rows(coal_model.device, cap, rows=48, seed=2)
    base = (cfg, (2.0,), 10, 100.0, 44, 3)
    part = lambda plain: coal.coal_resident(
        *base, *(p[16:40] for p in planes), *(c[16:40] for c in cells),
        pairing=form, row0=16, plain=plain)
    k = _launches(coal.resident_kernel(cfg, cap), lambda: part(False))
    p = part(True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    whole = coal.coal_resident(*base, *planes, *cells, pairing=form)
    assert all(torch.equal(a[16:40], b) for a, b in zip(whole, k))
    assert float(k[0].sum()) < float(planes[0][16:40].sum())   # collided


@pytest.mark.parametrize("coal_on", [False, True], ids=["no_coal", "coal"])
def test_mesh_matches_serial_on_the_card(dev, coal_on):
    """The 8-shard mesh (slabs of 3,3,3,2,2,2,2,2 columns) on the card
    against the serial dense engine from the same state, 19x10 cells:
    without coalescence over 6 steps, with it the first step; per cell the
    SDs' cell, n, rd3, kappa and x exact, z, rw2 and vt within kernel B's
    gates (rel 1e-5), th and rv within them (2e-6, 2e-5); kernels B, E (on
    coalescence), C's unwrapped form and D launched on every shard and
    kernel A on the global fields; SDs crossed slab edges."""
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    kw = dict(nx=19, nz=10, sd_conc=24, sstp_cond=3, sstp_coal=2,
              n_sd_max=24 * 190, device=dev,
              opts_init_kw={"coal_switch": coal_on,
                            "kernel_parameters": [100.0]})
    nt = 1 if coal_on else 6
    serial = Kinematic2D(**kw)
    mesh = Kinematic2D(**kw)
    r = MeshRunner(mesh, 8)
    for k in _ext.KERNELS:
        k.launches = 0
    r.run(nt)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _ext.KERNELS}
    serial.run_device_lgrngn(nt, engine="dense")
    assert launches["transport"] == 0
    want = dict(mpdata=nt, cond=8 * nt, transport_unwrapped=8 * nt,
                merge=8 * nt, coal=8 * nt if coal_on else 0)
    assert {k: launches[k] for k in want} == want
    assert int(r.crossed) > 0
    pop = lambda d: multiset(d.n.cpu(), tuple(
        getattr(d, f).cpu() for f in ("rd3", "kpa", "x", "z", "rw2", "vt")))
    a, b = pop(r.state()), pop(serial.dense_state)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :5], b[:, :5])   # cell n rd3 kpa x
    np.testing.assert_allclose(a[:, 5:], b[:, 5:], rtol=1e-5)
    assert _rel(mesh.th, serial.th) <= 2e-6
    assert _rel(mesh.rv, serial.rv) <= 2e-5
    assert int(r.state().overflow) == 0


@pytest.mark.parametrize("case", ["onishi_hall", "pred_corr",
                                  "const_multi"])
def test_mesh_options_match_serial_on_the_card(dev, case):
    """The 8-shard mesh (slabs of 3,3,3,2,2,2,2,2 columns) under the
    onishi kernel, pred_corr advection and a const-multi population's
    coalescence, 19x10 cells, the courants x20 and the radii x30: 4 steps
    (1 spin-up) every plane lane for lane bitwise the serial dense
    engine's, th and rv too, and the same sstp_coal growth; E's onishi
    form and C's pred_corr form on a slab launched on every shard."""
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    oi = {"onishi_hall": dict(kernel=kernel_t.onishi_hall,
                              kernel_parameters=[100.0]),
          "pred_corr": dict(adve_scheme=as_t.pred_corr,
                            kernel_parameters=[100.0]),
          "const_multi": dict(sd_const_multi=1e11,
                              kernel_parameters=[1e8])}[case]
    kw = dict(nx=19, nz=10, sd_conc=0 if case == "const_multi" else 24,
              sstp_cond=3, sstp_coal=2, n_sd_max=24 * 190, device=dev,
              opts_init_kw=oi)
    serial, mesh = Kinematic2D(**kw), Kinematic2D(**kw)
    d0 = serial.dense_state
    d0 = dataclasses.replace(d0, courant_x=20.0 * d0.courant_x,
                             courant_z=20.0 * d0.courant_z,
                             rw2=900.0 * d0.rw2)
    r = MeshRunner(mesh, 8)
    r.load(d0, mesh.th, mesh.rv)
    for k in _ext.KERNELS:
        k.launches = 0
    r.run(4, spinup=1)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _ext.KERNELS}
    serial.dense_state = d0
    serial.run_device_lgrngn(4, spinup=1, engine="dense")
    want = {"onishi_hall": dict(coal_onishi=8 * 3, transport_unwrapped=32),
            "pred_corr": dict(coal=8 * 3, transport_pred_corr_unwrapped=32),
            "const_multi": dict(coal=8 * 3, transport_unwrapped=32)}[case]
    assert {k: launches[k] for k in want} == want
    assert int(r.crossed) > 0
    d_m, d_s = r.state(), serial.dense_state
    for a in dense.ATTRS:
        assert torch.equal(getattr(d_m, a), getattr(d_s, a)), a
    assert torch.equal(mesh.th, serial.th) and torch.equal(mesh.rv, serial.rv)
    assert mesh.prtcls._sstp_coal_extra == serial.prtcls._sstp_coal_extra
    assert int(d_m.overflow) == 0


@pytest.mark.parametrize("name", ["onishi_hall-eps100",
                                  "onishi_hall_davis_no_waals"])
@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [2, 32, 128, 256, 512])
def test_coal_onishi_kernel_with_row0_matches_plain(coal_model, cap, form,
                                                    name):
    """Kernel E's onishi form keyed by the global row (row0 of a mesh
    shard) bitwise equal to its plain version lane by lane (a row over
    one warp to cap 128, over 2 and 4 at 256 and 512), the same bits from
    launch to launch, and equal to the same rows of a call on the grid
    they are part of."""
    kernel, params = COAL_Y_KERNELS[name]
    cfg = _coal_cfg(coal_model, kernel)
    planes, cells = _coal_rows(coal_model.device, cap, rows=48, seed=4)
    if cap < 32:        # radii x10: a row of two droplets collides
        planes = (planes[0], planes[1] * 100.0) + planes[2:]
    base = (cfg, params, 10, 100.0, 44, 3)
    part = lambda plain: coal.coal_resident(
        *base, *(p[16:40] for p in planes), *(c[16:40] for c in cells),
        pairing=form, row0=16, plain=plain)
    k = _launches(_ext.COAL_ONISHI, lambda: part(False))
    again = _launches(_ext.COAL_ONISHI, lambda: part(False))
    p = part(True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    whole = coal.coal_resident(*base, *planes, *cells, pairing=form)
    assert all(torch.equal(a[16:40], b) for a, b in zip(whole, k))
    assert float(k[0].sum()) < float(planes[0][16:40].sum())   # collided


# ------------------------------------------- E's vohl form, C's pred_corr
@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [2, 32, 128, 256, 512])
def test_coal_vohl_kernel_matches_plain(coal_model, cap, form):
    """Kernel E's wide-table form (vohl_davis_no_waals, its table K + 2 =
    152 wide) on droplets of 10 um to 1.5 mm (table indices past 126),
    bitwise equal to its plain version lane by lane, and launched as
    _ext.COAL_VOHL (above capacity 128 as _ext.COAL_VOHL_WARP_ROWS); keyed
    by a mesh shard's global rows too."""
    cfg = _coal_cfg(coal_model, kernel_t.vohl_davis_no_waals)
    planes, cells = _coal_rows(coal_model.device, cap,
                               rows=max(48, 1024 // cap), seed=4)
    planes = (planes[0], planes[1] * 25.0) + planes[2:]
    assert float(planes[1].max()) > (1.1e-3) ** 2
    args = (cfg, (), 10, 100.0, 44, 3) + planes + cells
    run = lambda plain, **kw: coal.coal_resident(*args, pairing=form,
                                                 plain=plain, **kw)
    kernel = coal.resident_kernel(cfg, cap)
    assert kernel is (_ext.COAL_VOHL_WARP_ROWS if cap > 128
                      else _ext.COAL_VOHL)
    before = _ext.COAL.launches, _ext.COAL_WARP_ROWS.launches
    k = _launches(kernel, lambda: run(False))
    assert (_ext.COAL.launches, _ext.COAL_WARP_ROWS.launches) == before
    p = run(True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert float(p[0].sum()) < float(planes[0].sum())     # collisions
    rows = slice(8, 24)
    part = lambda plain: coal.coal_resident(
        cfg, (), 10, 100.0, 44, 3, *(a[rows] for a in planes),
        *(c[rows] for c in cells), pairing=form, row0=8, plain=plain)
    ks = _launches(kernel, lambda: part(False))
    assert all(torch.equal(a, b) for a, b in zip(ks, part(True)))
    assert all(torch.equal(a[rows], b) for a, b in zip(k, ks))


@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [32, 128])
def test_coal_const_multi_flag_matches_plain(coal_model, cap, form):
    """A const-multi population (every multiplicity 1e9): kernel E's
    overflow flag row by row equal to its plain version's, some rows
    flagged and some not, and the SDs emptied by collisions of equal
    multiplicities equal lane by lane."""
    cfg = dataclasses.replace(_coal_cfg(coal_model, kernel_t.geometric),
                              pure_const_multi=True)
    planes, cells = _coal_rows(coal_model.device, cap, rows=64, seed=6)
    n = torch.where(planes[0] > 0, 1e9, 0.0)
    dv = cells[4] * torch.logspace(-6, 2, 64, device=n.device)
    args = (cfg, (1.0,), 10, 100.0, 44, 3, n) + planes[1:] + cells[:4] \
        + (dv,)
    k, p, _ = _coal_run(form, args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    flags = k[-1]
    assert 0 < int(flags.sum()) < int((n > 0).any(1).sum())
    assert int(((n > 0) & (k[0] == 0)).sum()) > 0


def _pred_corr_case(dev, cap, nx=8, nz=6, seed=0):
    """transport_case's rows under pred_corr with staggered courants to
    match (courant_x (nx+1)*nz, courant_z nx*(nz+1), up to 0.6 so that
    predictors leave their cells), a quarter of the first and the last
    column's droplets within 0.5 m of the periodic side walls."""
    cfg, planes, cells = transport_case(nx, nz, cap, seed=seed, device=dev,
                                        dtype=torch.float32)
    cfg = dataclasses.replace(cfg, adve_scheme=as_t.pred_corr.value)
    rng = np.random.default_rng(seed + 77)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    cx = f32(rng.uniform(-0.6, 0.6, (nx + 1) * nz))
    cz = f32(rng.uniform(-0.6, 0.6, nx * (nz + 1)))
    cxx, czz = cx.view(nx + 1, nz), cz.view(nx, nz + 1)
    rows = (cxx[:-1].reshape(-1), cxx[1:].reshape(-1),
            czz[:, :-1].reshape(-1), czz[:, 1:].reshape(-1))
    n, rw2, rd3, kpa, x, z = planes
    col = (torch.arange(cfg.n_cell, device=dev) // nz)[:, None].expand(
        n.shape)
    u = f32(rng.uniform(1e-3, 0.5, n.shape))
    edge = f32(rng.random(n.shape)) < 0.25
    x = torch.where(edge & (col == 0), u, x)
    x = torch.where(edge & (col == nx - 1), cfg.x1 - u, x)
    return cfg, (n, rw2, rd3, kpa, x.contiguous(), z), \
        tuple(cells[:4]) + rows, (cx, cz)


@pytest.mark.parametrize("rain", [False, True], ids=["cloud", "rain"])
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 512])
def test_transport_pred_corr_kernel_matches_plain(dev, cap, misaligned,
                                                  rain):
    """Kernel C's pred_corr form at row capacity 2 to 512, in the
    scalar-slot and the 16-byte layout, on cloud droplets and on drizzle
    (radii x20, sedimenting), bitwise equal to transport_plain in every
    slot (the far flags exact, the puddle partials rel 1e-5); droplets
    crossed the periodic side walls and left their cells."""
    cfg, planes, cells, courants = _pred_corr_case(dev, cap)
    n, rw2, rd3, kpa, x, z = planes
    if rain:
        rw2 = rw2 * 400.0
    if misaligned:
        buf = torch.empty(rw2.numel() + 1, dtype=torch.float32, device=dev)
        rw2 = buf[1:].view(rw2.shape)
        rw2.copy_(planes[1] * (400.0 if rain else 1.0))
    args = (cfg, 1.0, rain, n, rw2, rd3, x, z) + cells
    kc = _launches(_ext.TRANSPORT_PRED_CORR,
                   lambda: step.transport(*args, courants=courants))
    pc = step.transport(*args, courants=courants, plain=True)
    for a, b in zip(kc[:5], pc[:5]):                      # n x z vt targets
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    live = (n > 0) & (kc[0] > 0)
    if cap >= 32:
        assert bool((torch.abs(kc[1] - x)[live] > 0.5 * cfg.x1).any())
        own = (torch.arange(cfg.n_cell, device=dev, dtype=torch.int32)
               [:, None].expand(n.shape))
        assert bool((kc[4][live] != own[live]).any())


# (col0, ncol) of the pred_corr form's slabs of _pred_corr_case's 8-column
# grid: MESH_SLABS', and the whole grid as one shard, the ring to itself
# (a move across the periodic wrap leaves it)
PC_SLABS = dict(MESH_SLABS, whole=(0, 8))


def _halo2(cx, cz, nx, nz, col0, nx_pad):
    """A grid's staggered courants as a shard's halo-2 layout
    (parallel/decomp.xchng_courants_pc): x faces -2 .. nx_pad + 3 and z
    columns -2 .. nx_pad + 1 from col0, the grid's taken round the
    periodic ring."""
    at = lambda lo, hi: torch.remainder(
        torch.arange(col0 + lo, col0 + hi, device=cx.device), nx)
    return (cx.view(nx + 1, nz)[at(-2, nx_pad + 4)].reshape(-1).contiguous(),
            cz.view(nx, nz + 1)[at(-2, nx_pad + 2)].reshape(-1).contiguous())


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("slab", list(PC_SLABS))
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 512])
def test_transport_pred_corr_unwrapped_kernel_matches_plain(dev, cap, slab,
                                                            misaligned):
    """Kernel C's pred_corr form on a shard of the x-slab mesh at row
    capacity 2 to 512, in both layouts, on the first, an inner and the
    last slab of three columns and on the whole grid as one shard, with
    sedimentation: n, x, z, vt and the targets bitwise equal to
    transport_plain in every slot, the far flags exact, the puddle
    partials rel 1e-5, one launch counted as
    TRANSPORT_PRED_CORR_UNWRAPPED; droplets leave the slab (across the
    periodic wrap on the whole grid)."""
    col0, ncol = PC_SLABS[slab]
    nx_pad = 8 if slab == "whole" else 3
    cfg, planes, cells, courants = _pred_corr_case(dev, cap)
    rows = slice(col0 * 6, (col0 + nx_pad) * 6)
    n, rw2, rd3, kpa, x, z = (p[rows].contiguous() for p in planes)
    if misaligned:
        buf = torch.empty(rw2.numel() + 1, dtype=torch.float32, device=dev)
        buf[1:].view(rw2.shape).copy_(rw2)
        rw2 = buf[1:].view(rw2.shape)
    args = (cfg, 1.0, True, n, rw2, rd3, x, z) \
        + tuple(c[rows].contiguous() for c in cells)
    kw = dict(slab=(col0, ncol), courants=_halo2(*courants, 8, 6, col0,
                                                  nx_pad))
    before = _ext.TRANSPORT_PRED_CORR.launches
    kc = _launches(_ext.TRANSPORT_PRED_CORR_UNWRAPPED,
                   lambda: step.transport(*args, **kw))
    assert _ext.TRANSPORT_PRED_CORR.launches == before
    pc = step.transport(*args, **kw, plain=True)
    for a, b in zip(kc[:5], pc[:5]):                      # n x z vt targets
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    if cap >= 32:
        assert bool(((pc[0] > 0) & (pc[4] == -1)).any())
    with pytest.raises(ValueError, match="halo-2"):
        step.transport(*args, slab=(col0, ncol), courants=courants)


def test_transport_pred_corr_refusals(dev):
    cfg, planes, cells, courants = _pred_corr_case(dev, 32)
    args = (cfg, 1.0, False) + planes[:3] + planes[4:] + cells
    with pytest.raises(ValueError, match="courants"):
        step.transport(*args)
    with pytest.raises(ValueError, match="courants"):
        step.transport(*args, courants=(courants[0][:-1], courants[1]))


@pytest.mark.parametrize("case", ["const_multi", "vohl", "pred_corr"])
def test_dense_option_slices_match_plain(dev, case):
    """Two spin-up and two coalescing steps of the 8x8 case of each
    option through the kernels and the plain versions: E's forms and C's
    launched once a step (E's vohl form under vohl, C's pred_corr form
    under pred_corr), the fields within kernel B's gates and the
    population's counts equal."""
    oi = {"const_multi": dict(sd_const_multi=1e11,
                              kernel_parameters=[3000.0]),
          "vohl": dict(kernel=kernel_t.vohl_davis_no_waals),
          "pred_corr": dict(adve_scheme=as_t.pred_corr,
                            kernel_parameters=[100.0])}[case]
    kw = dict(nx=8, nz=8, sd_conc=0 if case == "const_multi" else 24,
              sstp_cond=3, sstp_coal=3, n_sd_max=8192, opts_init_kw=oi,
              device=dev)
    mk, mp = Kinematic2D(**kw), Kinematic2D(**kw)
    coal_k = _ext.COAL_VOHL if case == "vohl" else _ext.COAL
    trans_k = _ext.TRANSPORT_PRED_CORR if case == "pred_corr" \
        else _ext.TRANSPORT
    before = {k.name: k.launches for k in _ext.KERNELS}
    mk.run_device_lgrngn(4, spinup=2, engine="dense")
    torch.cuda.synchronize()
    assert coal_k.launches == before[coal_k.name] + 2
    assert trans_k.launches == before[trans_k.name] + 4
    mp.run_device_lgrngn(4, spinup=2, engine="dense", plain=True)
    assert _rel(mk.th, mp.th) <= 2e-6
    assert _rel(mk.rv, mp.rv) <= 2e-5
    dk, dp = mk.dense_state, mp.dense_state
    assert torch.equal((dk.n > 0).sum(1), (dp.n > 0).sum(1))
    assert mk.prtcls._sstp_coal_extra == mp.prtcls._sstp_coal_extra


# ------------------------------------------------ the turb_cond forms
def _sgs(n, seed, dev, zero=False):
    """ssp and dot_ssp of ``n`` SDs (float32): N(0, 2e-3) and N(0, 1e-3)."""
    rng = np.random.default_rng(seed)
    a = [rng.normal(0.0, 2e-3, n), rng.normal(0.0, 1e-3, n)]
    return tuple(torch.tensor(v * (not zero), dtype=torch.float32,
                              device=dev) for v in a)


@pytest.mark.parametrize("zero", [False, True], ids=["ssp", "ssp0"])
@pytest.mark.parametrize("config", ["th_dry", "var_rho"])
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_cond_flat_turb_kernel_matches_plain(dev, case, config, zero):
    """Kernel F's turb_cond form against its plain version: the live
    droplets' rw2 and ssp within F's gates (rw2 rel 1e-5, th 2e-6, rv
    2e-5: the cell sums add in another order), dead slots' rw2 and ssp
    copied through; with ssp and dot_ssp zero, bitwise F's form without
    turb_cond."""
    cfg, kw = _flat_case(dev, case, config)
    ssp, dssp = _sgs(kw["rw2"].shape[0], 7, dev, zero)
    k = _launches(_ext.COND_FLAT_TURB, lambda: cond_ops.cond_flat(
        cfg, RH_max=44.0, ssp=ssp, dot_ssp=dssp, **kw))
    p = cond_ops.cond_flat(cfg, RH_max=44.0, ssp=ssp, dot_ssp=dssp,
                           plain=True, **kw)
    live = kw["wgt"] > 0
    assert _rel(k[0][live], p[0][live]) <= 1e-5
    assert _rel(k[1], p[1]) <= 2e-6 and _rel(k[2], p[2]) <= 2e-5
    assert torch.equal(k[4][live], p[4][live])
    assert torch.equal(k[0][~live], kw["rw2"][~live])
    assert torch.equal(k[4][~live], ssp[~live])
    if zero:
        base = cond_ops.cond_flat(cfg, RH_max=44.0, **kw)
        for a, b in zip(k[:4], base):
            assert torch.equal(a, b)


@pytest.mark.parametrize("zero", [False, True], ids=["ssp", "ssp0"])
@pytest.mark.parametrize("mode", ["mix", "nomix"])
@pytest.mark.parametrize("layout", ["cap128", "flat"])
def test_cond_sd_fixed_turb_matches_plain(dev, layout, mode, zero):
    """G's fixed-count turb_cond form (ssp held for the phase) against its
    plain version, as _check_form holds the form without it; with ssp zero
    bitwise that form."""
    cap = None if layout == "flat" else 128
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=5), cap=cap, dead0=300, seed=6, device=dev,
        dtype=torch.float32, sstp_cond=10, **FIXED_MODES[mode])
    ssp, _ = _sgs(sd[0].numel(), 8, dev, zero)
    ssp = ssp.reshape(sd[0].shape)
    k = _check_form(_ext.COND_SD_FIXED_TURB, cond_ops.perparticle_fixed,
                    cfg, sd, cells[:7], seg, ssp=ssp)
    if zero:
        base = cond_ops.perparticle_fixed(cfg, 1.0, 44.0, sd, cells[:7], seg)
        for a, b in zip(k, base):
            assert torch.equal(a, b)


@pytest.mark.parametrize("zero", [False, True], ids=["ssp", "ssp0"])
@pytest.mark.parametrize("mode", list(ADAPTIVE_MODES))
@pytest.mark.parametrize("layout", ["cap128", "flat"])
def test_cond_sd_adaptive_turb_matches_plain(dev, layout, mode, zero):
    """G's adaptive turb_cond form (ssp on the tries and the substeps,
    rewound with the state) against its plain version, bitwise, ssp
    included for the live SDs and copied through for the others; with ssp
    and dot_ssp zero bitwise the form without turb_cond."""
    cap = None if layout == "flat" else 128
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=9), cap=cap, dead0=300, seed=10, device=dev,
        dtype=torch.float32, sstp_cond=10, adaptive_sstp_cond=True,
        **ADAPTIVE_MODES[mode])
    ssp, dssp = (a.reshape(sd[0].shape)
                 for a in _sgs(sd[0].numel(), 11, dev, zero))
    k = _check_form(_ext.COND_SD_ADAPTIVE_TURB, cond_ops.perparticle_adaptive,
                    cfg, sd, cells, seg, ssp=ssp, dot_ssp=dssp)
    live = sd[0] > 0
    assert torch.equal(k[5][~live], ssp[~live])
    if zero:
        base = cond_ops.perparticle_adaptive(cfg, 1.0, 44.0, sd, cells, seg)
        for a, b in zip(k[:5], base):
            assert torch.equal(a, b)
    else:
        assert bool((k[5] != ssp)[live].any())


def test_les_slice_kernels_match_plain(dev):
    """The flat LES slice (turb_adve, turb_cond, turb_coal with onishi_hall,
    diag_incloud_time, rcyc) through the public API at 8x8: F's turb_cond
    form once a step, the kernel path bitwise its plain path's th and rv
    within F's gates."""
    kw = dict(nx=8, nz=8, sd_conc=16, sstp_cond=3, sstp_coal=3,
              opts_init_kw=dict(turb_adve_switch=True, turb_cond_switch=True,
                                turb_coal_switch=True, diag_incloud_time=True,
                                kernel=kernel_t.onishi_hall,
                                kernel_parameters=[100.0]), device=dev)
    ms = [Kinematic2D(**kw) for _ in range(2)]
    opts = ms[0].opts
    opts.turb_adve = opts.turb_cond = opts.turb_coal = opts.rcyc = True
    diss = torch.full((8, 8), 1e-3, device=dev)
    before = _ext.COND_FLAT_TURB.launches
    for m, plain in zip(ms, (False, True)):
        for _ in range(3):
            m.advect_scalars()
            th, rv = m.prtcls.step_sync(opts, m.th, m.rv, diss_rate=diss,
                                        plain=plain)
            m.th, m.rv = th.reshape(8, 8), rv.reshape(8, 8)
            m.prtcls.step_async(opts, plain=plain)
    torch.cuda.synchronize()
    assert _ext.COND_FLAT_TURB.launches == before + 3
    assert _rel(ms[0].th, ms[1].th) <= 2e-6
    assert _rel(ms[0].rv, ms[1].rv) <= 2e-5
    st = ms[0].prtcls.state
    assert bool(torch.isfinite(st.ssp).all()) and bool((st.ssp != 0).any())


# ----------------------------------------- the parcel forms, the 3-D grid
def _parcel(cfg):
    """``cfg`` with its cells taken for parcels, 1 kg of dry air each
    (n_dims 0): what selects the parcel forms."""
    return dataclasses.replace(cfg, n_dims=0)


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("config", ["th_dry", "var_rho", "const_p"])
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_cond_flat_parcel_kernel_matches_plain(dev, case, config, turb):
    """Kernel F's parcel forms (a droplet weighs wgt / (dv rhod) with dv =
    1 / rhod at each substep) against their plain version within F's
    gates, dead slots (and their ssp) copied through; they differ from
    the grid form, whose dv is the cell volume.  The weights are per kg
    of air, as a parcel holds them: read per kg, the cell-volume weights
    of _flat_case put ~0.08 kg of liquid in a kg of air, where a substep
    moves T by 10-100 K and rv drops below 0, and there the plain version
    parts from itself at float64 (tests/test_torch_parcel.py
    test_cond_flat_parcel_weights_per_kg_of_air)."""
    cfg, kw = _flat_case(dev, case, config)
    pcfg = _parcel(cfg)
    kw["wgt"] = kw["wgt"] / (kw["dv"] * kw["rhod"])[kw["sijk"]]
    sgs = dict(zip(("ssp", "dot_ssp"), _sgs(kw["rw2"].shape[0], 7, dev))) \
        if turb else {}
    kernel = _ext.COND_FLAT_PARCEL_TURB if turb else _ext.COND_FLAT_PARCEL
    k = _launches(kernel, lambda: cond_ops.cond_flat(pcfg, RH_max=44.0,
                                                     **kw, **sgs))
    p = cond_ops.cond_flat(pcfg, RH_max=44.0, plain=True, **kw, **sgs)
    live = kw["wgt"] > 0
    assert _rel(k[0][live], p[0][live]) <= 1e-5
    assert _rel(k[1], p[1]) <= 2e-6 and _rel(k[2], p[2]) <= 2e-5
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0][~live], kw["rw2"][~live])
    if turb:
        assert torch.equal(k[4][live], p[4][live])
        assert torch.equal(k[4][~live], sgs["ssp"][~live])
    grid = cond_ops.cond_flat(cfg, RH_max=44.0, **kw, **sgs)
    assert _rel(k[1], grid[1]) > 1e-6


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("mode", list(FIXED_MODES))
@pytest.mark.parametrize("layout", ["cap128", "flat"])
def test_cond_sd_fixed_parcel_matches_plain(dev, layout, mode, turb):
    """G's fixed-count parcel forms (an SD's private air 1 kg: its vapour
    undivided) against their plain version, as _check_form holds the grid
    forms."""
    cap = None if layout == "flat" else 128
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=5), cap=cap, dead0=300, seed=6, device=dev,
        dtype=torch.float32, sstp_cond=10, **FIXED_MODES[mode])
    kw = {"ssp": _sgs(sd[0].numel(), 8, dev)[0].reshape(sd[0].shape)} \
        if turb else {}
    kernel = _ext.COND_SD_FIXED_PARCEL_TURB if turb \
        else _ext.COND_SD_FIXED_PARCEL
    k = _check_form(kernel, cond_ops.perparticle_fixed, _parcel(cfg), sd,
                    cells[:7], seg, **kw)
    grid = cond_ops.perparticle_fixed(cfg, 1.0, 44.0, sd, cells[:7], seg,
                                      **kw)
    live = sd[0] > 0
    assert not torch.equal(k[1][live], grid[1][live])


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("mode", list(ADAPTIVE_MODES))
@pytest.mark.parametrize("layout", ["cap128", "flat"])
def test_cond_sd_adaptive_parcel_matches_plain(dev, layout, mode, turb):
    """G's adaptive parcel forms against their plain version, bitwise."""
    cap = None if layout == "flat" else 128
    cfg, sd, cells, seg = perparticle_case(
        _g_counts(cap, seed=9), cap=cap, dead0=300, seed=10, device=dev,
        dtype=torch.float32, sstp_cond=10, adaptive_sstp_cond=True,
        **ADAPTIVE_MODES[mode])
    kw = dict(zip(("ssp", "dot_ssp"), (
        a.reshape(sd[0].shape) for a in _sgs(sd[0].numel(), 11, dev)))) \
        if turb else {}
    kernel = _ext.COND_SD_ADAPTIVE_PARCEL_TURB if turb \
        else _ext.COND_SD_ADAPTIVE_PARCEL
    k = _check_form(kernel, cond_ops.perparticle_adaptive, _parcel(cfg), sd,
                    cells, seg, **kw)
    grid = cond_ops.perparticle_adaptive(cfg, 1.0, 44.0, sd, cells, seg,
                                         **kw)
    live = sd[0] > 0
    assert not torch.equal(k[1][live], grid[1][live])


# one parcel of these many live SDs, dead slots mixed in: empty, one SD,
# less than a warp, a warp and one, a thread a slot of the 16-CTA cluster,
# one more, 8 slots a thread
PARCEL_SIZES = [0, 1, 31, 33, 4096, 4097, 65536]


def _parcel_flat(dev, n, config, turb):
    """One parcel of ``n`` live droplets and n // 8 + 5 dead slots mixed
    in, for kernel F's parcel forms: the weights per kg of air, scaled to
    the liquid of _flat_case's 64-droplet cells (more would move T by
    tens of K a substep); with ``turb`` ssp and dot_ssp."""
    cfg, kw = flat_cond_case([n], n // 8 + 5, 11, dev, torch.float32,
                             **{k: v for k, v in FLAT_CONFIGS[config].items()
                                if k != "var_rho"})
    kw["var_rho"] = config == "var_rho"
    kw["wgt"] = kw["wgt"] / (kw["dv"] * kw["rhod"])[kw["sijk"]] \
        * (64.0 / max(n, 64))
    sgs = dict(zip(("ssp", "dot_ssp"), _sgs(kw["rw2"].shape[0], 7, dev))) \
        if turb else {}
    return _parcel(cfg), dict(kw, **sgs)


def _check_flat_parcel(pcfg, kw):
    """F's parcel form (one launch, twice the same bits) against its plain
    version within F's gates: live rw2 1e-5, th 2e-6, rv 2e-5; rhod, the
    live droplets' ssp and the dead slots (rw2, ssp) bitwise."""
    turb = "ssp" in kw
    kernel = _ext.COND_FLAT_PARCEL_TURB if turb else _ext.COND_FLAT_PARCEL
    k = _launches(kernel, lambda: cond_ops.cond_flat(pcfg, RH_max=44.0,
                                                     **kw))
    again = cond_ops.cond_flat(pcfg, RH_max=44.0, **kw)
    p = cond_ops.cond_flat(pcfg, RH_max=44.0, plain=True, **kw)
    for a, b in zip(k, again):
        assert torch.equal(a, b)
    live = kw["wgt"] > 0
    if bool(live.any()):
        assert _rel(k[0][live], p[0][live]) <= 1e-5
        assert _rel(k[0][live], kw["rw2"][live]) > 1e-3     # they grew
    assert _rel(k[1], p[1]) <= 2e-6 and _rel(k[2], p[2]) <= 2e-5
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0][~live], kw["rw2"][~live])
    if turb:
        assert torch.equal(k[4][live], p[4][live])
        assert torch.equal(k[4][~live], kw["ssp"][~live])
    return k


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("config", ["th_dry", "var_rho", "const_p"])
@pytest.mark.parametrize("n", PARCEL_SIZES)
def test_cond_flat_parcel_cluster_matches_plain(dev, n, config, turb):
    """Kernel F's parcel forms on one parcel of 0 to 65,536 droplets (a
    cluster of up to 16 CTAs; one slot a thread up to 8,192 droplets,
    several beyond), under each closure and with rhod substepped, against
    their plain version within F's gates, and bitwise from launch to
    launch."""
    pcfg, kw = _parcel_flat(dev, n, config, turb)
    plan = cond_ops.card_parcel_plan(
        _ext.COND_FLAT_PARCEL_TURB if turb else _ext.COND_FLAT_PARCEL,
        kw["rw2"].shape[0])
    assert plan == cond_ops.parcel_plan(kw["rw2"].shape[0]) or plan.ctas == 8
    _check_flat_parcel(pcfg, kw)


def _parcel_sd(dev, n, layout, mode, turb):
    """One parcel of ``n`` live SDs for G-fixed's parcel forms: flat
    segments with n // 8 + 5 dead slots mixed in, or a dense row of
    capacity n + n // 8 + 5 (a hole and a dead tail); the weights scaled
    to the vapour of _g_counts' cells of 64; with ``turb`` each SD's
    ssp."""
    cap = None if layout == "flat" else n + n // 8 + 5
    cfg, sd, cells, seg = perparticle_case(
        [n], cap=cap, dead0=n // 8 + 5, seed=12, device=dev,
        dtype=torch.float32, sstp_cond=10, **FIXED_MODES[mode])
    sd = (sd[0] * (64.0 / max(n, 64)),) + sd[1:]
    kw = {"ssp": _sgs(sd[0].numel(), 8, dev)[0].reshape(sd[0].shape)} \
        if turb else {}
    return _parcel(cfg), sd, cells[:7], seg, kw


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("mode", ["mix", "nomix"])
@pytest.mark.parametrize("layout", ["cap", "flat"])
@pytest.mark.parametrize("n", PARCEL_SIZES)
def test_cond_sd_fixed_parcel_cluster_matches_plain(dev, n, layout, mode,
                                                    turb):
    """G-fixed's parcel forms on one parcel of 0 to 65,536 SDs, as a dense
    row and as flat segments, with and without mixing (a cluster barrier
    a substep, or none), against their plain version as _check_form holds
    them, and bitwise from launch to launch."""
    pcfg, sd, cells, seg, kw = _parcel_sd(dev, n, layout, mode, turb)
    kernel = _ext.COND_SD_FIXED_PARCEL_TURB if kw \
        else _ext.COND_SD_FIXED_PARCEL
    k = _check_form(kernel, cond_ops.perparticle_fixed, pcfg, sd, cells,
                    seg, **kw)
    again = cond_ops.perparticle_fixed(pcfg, 1.0, 44.0, sd, cells, seg,
                                       **kw)
    for a, b in zip(k, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [33, 4097, 65536])
def test_parcel_forms_on_the_portable_cluster(dev, monkeypatch, n):
    """F's and G-fixed's parcel forms (and their turb_cond forms) with the
    plan held to the portable cluster of 8 CTAs through the plan
    function: the same gates, where 4,097 droplets already give a thread
    two slots."""
    monkeypatch.setattr(cond_ops, "PARCEL_MAX_CLUSTER", 8)
    for turb in (False, True):
        pcfg, kw = _parcel_flat(dev, n, "var_rho", turb)
        kernel = _ext.COND_FLAT_PARCEL_TURB if turb \
            else _ext.COND_FLAT_PARCEL
        plan = cond_ops.card_parcel_plan(kernel, kw["rw2"].shape[0])
        assert plan == cond_ops.parcel_plan(kw["rw2"].shape[0], 8)
        assert plan.ctas <= 8
        _check_flat_parcel(pcfg, kw)
        for layout, mode in (("flat", "mix"), ("cap", "nomix")):
            pcfg, sd, cells, seg, kw_g = _parcel_sd(dev, n, layout, mode,
                                                    turb)
            kernel = _ext.COND_SD_FIXED_PARCEL_TURB if turb \
                else _ext.COND_SD_FIXED_PARCEL
            assert cond_ops.card_parcel_plan(kernel, n).ctas <= 8
            _check_form(kernel, cond_ops.perparticle_fixed, pcfg, sd, cells,
                        seg, **kw_g)


PARCEL_MODES = {
    "percell": ({}, "COND_FLAT_PARCEL"),
    "mix": (dict(exact_sstp_cond=True), "COND_SD_FIXED_PARCEL"),
    "nomix": (dict(exact_sstp_cond=True, sstp_cond_mix=False),
              "COND_SD_FIXED_PARCEL"),
    "adaptive": (dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                      sstp_cond_act=8), "COND_SD_ADAPTIVE_PARCEL"),
}


@pytest.mark.parametrize("mode", list(PARCEL_MODES))
def test_rising_parcel_kernels_match_plain(dev, mode):
    """A rising parcel through the public API (rhod lowered and passed
    every step: var_rho), 30 steps from RH 0.999 at sstp_cond 10: its
    parcel form once a step, the kernel path against the plain path
    within F's gates (th 2e-6, rv 2e-5), rw2 1e-4."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    over, kname = PARCEL_MODES[mode]
    out = []
    for plain in (False, True):
        oi = tl.opts_init_t()
        oi.dry_distros = {(0.61, 0.0): Setup().lognormal_lnrd}
        oi.dt, oi.sd_conc, oi.n_sd_max, oi.sstp_cond = 1.0, 256, 256, 10
        for k, v in over.items():
            setattr(oi, k, v)
        prt = tl.factory(tl.backend_t.CUDA, oi, device=dev)
        full = lambda v: torch.full((1,), v, device=dev)
        th, rv = full(289.0), full(0.0101)
        prt.init(th, rv, full(1.15))
        opts = tl.opts_t()
        opts.coal = False
        before = getattr(_ext, kname).launches
        for s in range(30):
            th, rv = prt.step_sync(opts, th, rv, full(1.15 - 1e-4 * (s + 1)),
                                   plain=plain)
            prt.step_async(opts)
        torch.cuda.synchronize()
        out.append((th, rv, prt.state.rw2,
                    getattr(_ext, kname).launches - before))
    (tk, rk, wk, nk), (tp, rp, wp, npl) = out
    assert (nk, npl) == (30, 0)
    assert _rel(tk, tp) <= 2e-6 and _rel(rk, rp) <= 2e-5
    assert _rel(wk, wp) <= 1e-4


def test_3d_grid_kernels_match_plain(dev):
    """The 3-D grid at 6x6x6 cells through the public API on the flat
    engine (engine="flat"; the factory's pick on the card is the dense
    front, test_dense_front_3d_matches_plain), 4 steps with coalescence,
    sedimentation and the courants of all three axes: kernel F once a
    step, the kernel path's th and rv within F's gates of the plain
    path's, the population the same."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.particles import particles_t
    n, out = 6, []
    for plain in (False, True):
        oi = tl.opts_init_t()
        oi.dry_distros = {(0.61, 0.0): Setup().lognormal_lnrd}
        oi.nx = oi.ny = oi.nz = n
        oi.dx = oi.dy = oi.dz = 20.0
        oi.x1 = oi.y1 = oi.z1 = n * 20.0
        oi.dt, oi.sd_conc, oi.n_sd_max = 1.0, 16, 16 * n ** 3
        oi.sstp_cond = oi.sstp_coal = 3
        oi.kernel, oi.kernel_parameters = kernel_t.geometric, [1e4]
        oi.terminal_velocity = vt_t.beard77fast
        prt = tl.factory(tl.backend_t.CUDA, oi, device=dev, engine="flat")
        assert type(prt) is particles_t
        full = lambda v, *s: torch.full(s or (n, n, n), v, device=dev)
        th, rv, rhod = full(289.0), full(7.5e-3), full(1.15)
        C = dict(courant_x=full(0.2, n + 1, n, n),
                 courant_y=full(0.1, n, n + 1, n),
                 courant_z=full(-0.05, n, n, n + 1))
        prt.init(th, rv, rhod, **C)
        opts = tl.opts_t()
        before = _ext.COND_FLAT.launches
        for _ in range(4):
            th, rv = prt.step_sync(opts, th, rv, rhod, plain=plain, **C)
            prt.step_async(opts)
        torch.cuda.synchronize()
        out.append((th, rv, prt.state, _ext.COND_FLAT.launches - before))
    (tk, rk, sk, nk), (tp, rp, sp, npl) = out
    assert (nk, npl) == (4, 0)
    assert _rel(tk, tp) <= 2e-6 and _rel(rk, rp) <= 2e-5
    assert torch.equal(sk.n, sp.n) and torch.equal(sk.ijk, sp.ijk)
    assert bool((sk.y != 0).any())


# ------------------------------------------------------ F's ice forms
def _ice_case(dev, case, config, parcel):
    """ice_cond_case on FLAT_CASES' cells under ``config``; in a parcel
    with the weights per kg of air, as a parcel holds them."""
    sizes, dead0 = FLAT_CASES[case]
    over = dict(FLAT_CONFIGS[config])
    var_rho = over.pop("var_rho", False)
    cfg, kw = ice_cond_case(sizes, dead0, 3, dev, torch.float32, **over)
    if parcel:
        cfg = _parcel(cfg)
        kw["wgt"] = kw["wgt"] / (kw["dv"] * kw["rhod"])[kw["sijk"]]
    return cfg, dict(kw, var_rho=var_rho)


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("parcel", [False, True], ids=["grid", "parcel"])
@pytest.mark.parametrize("config", ["th_dry", "var_rho", "const_p"])
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_cond_flat_ice_kernel_matches_plain(dev, case, config, parcel,
                                            turb):
    """Kernel F's four ice forms (the deposition after each substep's
    liquid growth) against their plain version on cold cells where half
    the live SDs are frozen: the live droplets' rw2 rel 1e-5, th 2e-6 and
    rv 2e-5 (F's gates: the cell sums add in another order), the frozen
    SDs' axes rel 1e-5, the last closure's th and rv within the th and rv
    gates; frozen SDs keep rw2 0, dead slots keep their rw2 and axes, and
    the ice grew."""
    cfg, kw = _ice_case(dev, case, config, parcel)
    sgs = dict(zip(("ssp", "dot_ssp"), _sgs(kw["rw2"].shape[0], 7, dev))) \
        if turb else {}
    kernel = cond_ops.form_kernel("cond_flat", parcel, turb, ice=True)
    k = _launches(kernel, lambda: cond_ops.cond_flat(cfg, RH_max=44.0, **kw,
                                                     **sgs))
    p = cond_ops.cond_flat(cfg, RH_max=44.0, plain=True, **kw, **sgs)
    assert len(k) == len(p) == 8 + turb
    live = kw["wgt"] > 0
    ia, ic, _ = kw["ice"]
    frozen = live & (ia > 0) & (ic > 0)
    liquid = live & ~frozen
    assert _rel(k[0][liquid], p[0][liquid]) <= 1e-5
    assert torch.equal(k[0][frozen], kw["rw2"][frozen])
    assert torch.equal(k[0][~live], kw["rw2"][~live])
    assert _rel(k[1], p[1]) <= 2e-6 and _rel(k[2], p[2]) <= 2e-5
    assert torch.equal(k[3], p[3])
    a_k, c_k, th_c, rv_c = k[-4:]
    a_p, c_p, th_cp, rv_cp = p[-4:]
    assert _rel(a_k[frozen], a_p[frozen]) <= 1e-5
    assert _rel(c_k[frozen], c_p[frozen]) <= 1e-5
    assert torch.equal(a_k[~frozen], ia[~frozen])
    assert torch.equal(c_k[~frozen], ic[~frozen])
    assert _rel(th_c, th_cp) <= 2e-6 and _rel(rv_c, rv_cp) <= 2e-5
    assert bool((a_k[frozen] > ia[frozen]).any())
    if turb:
        assert torch.equal(k[4][live], p[4][live])
        assert torch.equal(k[4][~live], sgs["ssp"][~live])
    # the deposition moved the cells: the warm form on the same SDs differs
    warm = cond_ops.cond_flat(dataclasses.replace(cfg, ice_switch=False),
                              RH_max=44.0, **{k_: v for k_, v in kw.items()
                                              if k_ != "ice"}, **sgs)
    assert _rel(k[2], warm[2]) > 1e-5


def test_cond_flat_ice_without_frozen_sds_is_the_warm_form(dev):
    """With no SD frozen, F's ice form gives the warm form's rw2, th and rv
    bitwise: the deposition adds nothing, and the liquid growth is the
    warm form's."""
    cfg, kw = _ice_case(dev, "gmd", "th_dry", False)
    kw["ice"] = tuple(torch.zeros_like(a) for a in kw["ice"])
    k = cond_ops.cond_flat(cfg, RH_max=44.0, **kw)
    warm = cond_ops.cond_flat(dataclasses.replace(cfg, ice_switch=False),
                              RH_max=44.0, **{k_: v for k_, v in kw.items()
                                              if k_ != "ice"})
    for a, b in zip(k[:4], warm):
        assert torch.equal(a, b)


# -------------------------------------- the 3-D forms and the onishi form
SCHEMES_3D = {"implicit": as_t.implicit, "euler": as_t.euler,
              "pred_corr": as_t.pred_corr}


def _case3d(dev, cap, scheme="implicit", **oi_kw):
    cfg, d = dense3d_case(6, 5, 4, cap, seed=cap, device=dev,
                          dtype=torch.float32, **oi_kw)
    return dataclasses.replace(
        cfg, adve_scheme=SCHEMES_3D[scheme].value), d


def _transport3d(cfg, d, rain, plain=False):
    rw2 = d.rw2 * (400.0 if rain else 1.0)
    return step.transport(
        cfg, 1.0, rain, d.n, rw2, d.rd3, d.x, d.z, d.T, d.p, d.rhod, d.eta,
        *dense._row_courants(cfg, d),
        courants=(d.courant_x, d.courant_z, d.courant_y),
        y3=dense._y_axis(cfg, d), plain=plain)


@pytest.mark.parametrize("open_walls", [False, True], ids=["periodic",
                                                           "open"])
@pytest.mark.parametrize("scheme", list(SCHEMES_3D))
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 512])
def test_transport_3d_kernel_matches_plain(dev, cap, scheme, open_walls):
    """Kernel C's 3-D forms at row capacity 2 to 512 (the scalar-slot
    layout at 2 and 100), on cloud droplets and drizzle, bitwise equal to
    transport_plain in every slot and in y (the far flags exact, the
    puddle partials rel 1e-5); droplets crossed the x and the y walls."""
    cfg, d = _case3d(dev, cap, scheme, open_side_walls=open_walls)
    kernel = _ext.TRANSPORT_3D_PRED_CORR if scheme == "pred_corr" \
        else _ext.TRANSPORT_3D
    for rain in (False, True):
        kc = _launches(kernel, lambda: _transport3d(cfg, d, rain))
        pc = _transport3d(cfg, d, rain, plain=True)
        for a, b in zip(kc[:5] + kc[6:], pc[:5] + pc[6:]):
            assert torch.equal(a, b)
        assert torch.equal(kc[5][:, 4], pc[5][:, 4])
        assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5,
                              atol=0.0)
        live = (d.n > 0) & (kc[0] > 0)
        if cap >= 32 and not open_walls:
            for new, old, w in ((kc[1], d.x, cfg.x1), (kc[6], d.y, cfg.y1)):
                assert bool((torch.abs(new - old)[live] > 0.5 * w).any())
        if cap >= 32:
            assert int(kc[5][:, 4].sum()) > 0              # far movers


def _merge3d_check(cfg, planes, tgt, exact, seed):
    """Kernel D's 3-D form (twelve planes with ``exact``) on ``planes``
    (n rw2 rd3 kpa vt x z y) and ``tgt`` against rebin_x_plain, bitwise in
    every slot and plane, the drops exact, and a second launch on the same
    input the same bits.  Returns the kernel's results."""
    rng = np.random.default_rng(seed)
    n = planes[0]
    extra = (planes[7],) + tuple(
        torch.as_tensor(rng.uniform(0.5, 1.5, n.shape), dtype=torch.float32,
                        device=n.device) for _ in range(4 if exact else 0))
    args = (cfg, *planes[:7], tgt)
    kernel = _ext.MERGE_3D_EXACT if exact else _ext.MERGE_3D
    k = _launches(kernel, lambda: step.rebin_x(*args, extra=extra))
    again = _launches(kernel, lambda: step.rebin_x(*args, extra=extra))
    p = step.rebin_x(*args, extra=extra, plain=True)
    assert len(k) == len(p) == 8 + len(extra)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    return k


@pytest.mark.parametrize("exact", [False, True], ids=["8", "12"])
@pytest.mark.parametrize("cap", [2, 32, 100, 128, 256, 512])
def test_merge_3d_kernel_matches_plain(dev, cap, exact):
    """Kernel D's 3-D forms (eight planes, twelve with the exact mode's
    private planes) at row capacity 2 to 512 on kernel C's targets, at
    merge3d_plan's bricks, bitwise equal to rebin_x_plain in every slot,
    the drops exact, and the same bits from launch to launch; rows
    received more droplets than they hold."""
    cfg, d = _case3d(dev, cap, exact_sstp_cond=exact)
    n, x, z, vt, tgt, _, y = _transport3d(cfg, d, False)
    k = _merge3d_check(cfg, (n, d.rw2, d.rd3, d.kpa, vt, x, z, y), tgt,
                       exact, cap)
    if cap < 128:
        assert float(k[-1].sum()) > 0


@pytest.mark.parametrize("exact", [False, True], ids=["8", "12"])
@pytest.mark.parametrize("brick", range(1, step.MERGE3D_MAX_BRICK + 1))
@pytest.mark.parametrize("grid,cap", [((6, 5, 4), 32), ((3, 3, 7), 128),
                                      ((4, 3, 17), 100)],
                         ids=["6x5x4", "3x3x7", "4x3x17"])
def test_merge_3d_bricks_match_plain(dev, monkeypatch, grid, cap, brick,
                                     exact):
    """Kernel D's 3-D forms at every brick height merge3d_plan takes
    (forced through the plan function rebin_x calls): nz below one brick
    (4), not a multiple of it (7, 17), nx and ny at 3; bitwise
    rebin_x_plain's."""
    plan = step.merge3d_plan
    monkeypatch.setattr(step, "merge3d_plan",
                        lambda cap_, nz: plan(cap_, nz, brick))
    assert step.merge3d_plan(cap, grid[2]).brick == brick
    cfg, d = dense3d_case(*grid, cap, seed=brick, device=dev,
                          dtype=torch.float32, exact_sstp_cond=exact)
    n, x, z, vt, tgt, _, y = _transport3d(cfg, d, False)
    _merge3d_check(cfg, (n, d.rw2, d.rd3, d.kpa, vt, x, z, y), tgt, exact,
                   brick)


def _merge3d_targets(cfg, d, case):
    """Targets for kernel D's edge cases on ``d``'s live droplets: every
    droplet to the neighbour (+1, +1, +1) of its row (x and y wrapping, z
    clipped at the top: there it stays), every other one a far mover (-1),
    or every droplet of the 27 rows around row (1, 1, 1) to that row."""
    n_cell, cap = d.n.shape
    r = torch.arange(n_cell, device=d.n.device)
    ny, nz = cfg.ny, cfg.nz
    i, j, k = r // (ny * nz), (r // nz) % ny, r % nz
    own = r[:, None].expand(n_cell, cap)
    if case == "leave":
        t = (((i + 1) % cfg.nx) * ny + (j + 1) % ny) * nz \
            + torch.clamp(k + 1, max=nz - 1)
        t = t[:, None].expand(n_cell, cap)
    elif case == "far":
        lane = torch.arange(cap, device=r.device)[None, :]
        t = torch.where(lane % 2 == 0, own, -1)
    else:
        hub = (1 * ny + 1) * nz + 1
        near = ((i - 1).abs() <= 1) & ((j - 1).abs() <= 1) \
            & ((k - 1).abs() <= 1)
        t = torch.where(near[:, None], hub, own)
    return torch.where(d.n > 0, t, -1).to(torch.int32).contiguous()


@pytest.mark.parametrize("exact", [False, True], ids=["8", "12"])
@pytest.mark.parametrize("case", ["leave", "far", "overflow"])
@pytest.mark.parametrize("cap", [2, 32, 128, 256, 512])
def test_merge_3d_kernel_edge_rows_match_plain(dev, cap, case, exact):
    """Kernel D's 3-D forms where every droplet leaves its row, where
    every other one is a far mover (target -1), and where the 27 rows
    around one row all send it their droplets (it overflows): bitwise
    rebin_x_plain's, the drops exact."""
    cfg, d = _case3d(dev, cap, exact_sstp_cond=exact)
    tgt = _merge3d_targets(cfg, d, case)
    k = _merge3d_check(cfg, (d.n, d.rw2, d.rd3, d.kpa, d.vt, d.x, d.z, d.y),
                       tgt, exact, cap + 1)
    live = int((d.n > 0).sum())
    placed = int((k[0] > 0).sum())
    if case == "far":
        assert placed < live
    if case == "overflow" and cap >= 32:
        assert float(k[-1].sum()) > 0
    if case == "leave":
        assert placed + float(k[-1].sum()) == live


def test_merge_3d_resources(dev):
    """Kernel D's 3-D forms' kernels at the 76^3 plan (capacity 128):
    within the launch bounds' 64 registers, no local memory, two blocks
    of 16 warps an SM or more, in both layouts."""
    plan = step.merge3d_plan(128, 76)
    assert plan.brick == 16
    for kernel in (_ext.MERGE_3D, _ext.MERGE_3D_EXACT):
        for vec in (0, 1):
            a = _ext.attributes(kernel.symbol + "_attrs", vec, plan.brick,
                                128)
            assert a["registers"] <= 64 and a["local"] == 0, a
            assert a["blocks_per_sm"] >= 2 and a["threads"] == 512, a
            assert a["dynamic_shared"] == plan.smem, a


COAL_Y_KERNELS = {"geometric": (kernel_t.geometric, (2.0,)),
                  "hall": (kernel_t.hall, ()),
                  "vohl": (kernel_t.vohl_davis_no_waals, ()),
                  "onishi_hall-eps0.01": (kernel_t.onishi_hall, (1e-2,)),
                  "onishi_hall-eps100": (kernel_t.onishi_hall, (100.0,)),
                  "onishi_hall_davis_no_waals": (
                      kernel_t.onishi_hall_davis_no_waals, (100.0,))}


# (kernel, with the y plane): the 2-D forms of the others are
# test_coal_kernel_matches_plain's
COAL_Y_CASES = [(name, with_y) for name in COAL_Y_KERNELS
                for with_y in (True, False)
                if with_y or name.startswith("onishi")]


@pytest.mark.parametrize("name,with_y", COAL_Y_CASES,
                         ids=[f"{n}-{'3d' if y else '2d'}"
                              for n, y in COAL_Y_CASES])
@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [2, 32, 128, 256, 512])
def test_coal_y_and_onishi_kernels_match_plain(coal_model, cap, form, name,
                                              with_y):
    """Kernel E's y forms (3-D: the y plane rides) and its onishi form
    (with and without the y plane) at row capacity 2 to 512, bitwise equal
    to coal_resident_plain lane by lane, the y plane and the overflow
    flags included; rows collide."""
    kernel, params = COAL_Y_KERNELS[name]
    onishi = name.startswith("onishi")
    cfg = _coal_cfg(coal_model, kernel)
    planes, cells = _coal_rows(coal_model.device, cap,
                               rows=max(48, 1024 // cap), seed=9)
    rng = np.random.default_rng(cap)
    y = torch.as_tensor(rng.uniform(0.0, 1500.0, planes[0].shape),
                        dtype=torch.float32, device=planes[0].device) \
        if with_y else None
    want = _ext.COAL_ONISHI if onishi else (
        _ext.COAL_VOHL_3D if name == "vohl" else _ext.COAL_3D)
    run = lambda plain: coal.coal_resident(
        cfg, params, 10, 100.0, 44, 3, *planes, *cells, pairing=form, y=y,
        plain=plain)
    k = _launches(want, lambda: run(False))
    again = _launches(want, lambda: run(False))
    p = run(True)
    assert len(k) == len(p) == 7 + int(with_y)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    assert not torch.equal(k[0], planes[0])               # collisions


def _warp_rows(dev, cap, seed):
    """_coal_rows' planes at ``cap`` with rows 4-8 laid across the warps
    of coal_y_plan's row: droplets only in the slots around each warp
    boundary (128 m - 5 .. 128 m + 4), cap - 1 droplets, one droplet in
    the last slot, 129 (an odd count over two warps), one at slot 7 of
    each of the first three warps; rows 9 and 10 with 64 and 127 droplets
    in their first 128 slots (above cap 128 the one-warp pass's); the
    others as _coal_rows makes them."""
    planes, cells = _coal_rows(dev, cap, rows=48, seed=seed)
    planes = tuple(a.clone() for a in planes)
    rng = np.random.default_rng(seed)
    rw = np.exp(rng.uniform(np.log(2e-6), np.log(3e-4), cap))
    vals = (np.floor(10.0 ** rng.uniform(5, 9, cap)), rw ** 2,
            (rw * rng.uniform(1e-3, 1e-1, cap)) ** 3,
            rng.uniform(0.1, 1.2, cap))
    lane = np.arange(cap)
    edge = np.zeros(cap, dtype=bool)
    for m in range(1, cap // 128):
        edge |= (lane >= 128 * m - 5) & (lane < 128 * m + 4)
    rows = (edge if edge.any() else lane % 3 == 0, lane != cap // 2,
            lane == cap - 1, lane < min(129, cap - 1),
            (lane % 128 == 7) & (lane < 384), (lane < 128) & (lane % 2 == 0),
            lane < min(127, cap - 1))
    for r, alive in enumerate(rows, start=4):
        for plane, v in zip(planes[:4], vals):
            plane[r] = torch.as_tensor(np.where(alive, v, 0.0),
                                       dtype=torch.float32, device=dev)
    return planes, cells


@pytest.mark.parametrize("name", ["geometric", "vohl", "onishi_hall-eps100"])
@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [2, 32, 64, 128, 256, 512])
def test_coal_y_rows_across_warps_match_plain(coal_model, cap, form, name):
    """Kernel E's y and onishi forms on rows whose droplets straddle the
    boundaries of the row's warps (coal_y_plan: one warp up to cap 128,
    cap / 128 above), rows of an odd live count, of one droplet in the
    last warp and of one a warp: bitwise coal_resident_plain's lane by
    lane, the same bits from launch to launch (above cap 128 both passes:
    rows 4-8 hold droplets past slot 127, the others run on one warp
    first); the kernel's rows are the plan's (warps a row, register slots
    a lane: the card's attributes of the wide form and of the one-warp
    pass), within their launch bounds (three blocks of 8 warps an SM)."""
    from libcloudphxx_tpu_torch.lgrngn.enums import vt_t as vt_enum
    kernel, params = COAL_Y_KERNELS[name]
    cfg = _coal_cfg(coal_model, kernel)
    planes, cells = _warp_rows(coal_model.device, cap, seed=cap + 5)
    planes = (planes[0], planes[1] * 100.0) + planes[2:]
    assert (planes[0] > 0).sum(1)[5:8].tolist() == [
        cap - 1, 1, min(129, cap - 1)]
    y = torch.as_tensor(np.random.default_rng(cap).uniform(
        0.0, 1500.0, planes[0].shape), dtype=torch.float32,
        device=planes[0].device)
    want = _ext.COAL_ONISHI if name.startswith("onishi") else (
        _ext.COAL_VOHL_3D if name == "vohl" else _ext.COAL_3D)
    run = lambda plain: coal.coal_resident(
        cfg, params, 10, 100.0, 44, 3, *planes, *cells, pairing=form, y=y,
        plain=plain)
    k = _launches(want, lambda: run(False))
    again = _launches(want, lambda: run(False))
    p = run(True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    assert not torch.equal(k[0], planes[0])               # collisions
    for narrow in (0, 1):
        a = _ext.attributes("lcp_coal_y_attrs",
                            vt_enum(cfg.terminal_velocity).value,
                            int(form == "sort"), cap, narrow)
        plan = coal.coal_y_plan(min(cap, 128) if narrow else cap)
        assert (a["warps_a_row"], a["slots_a_lane"]) == plan, a
        assert a["blocks_per_sm"] >= 3 and a["threads"] == 256, a


def test_dense_front_3d_matches_plain(dev):
    """The dense front on the 3-D grid at 6x6x6 (the factory's pick on the
    card), 4 steps with coalescence and sedimentation: kernels B, E's y
    form, C's 3-D form and D's 3-D form once a step, the kernel path
    bitwise equal to the plain path (th, rv, every plane as a per-cell
    multiset)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    n, out = 6, []
    names = ("cond", "coal_3d", "transport_3d", "merge_3d")
    for plain in (False, True):
        oi = tl.opts_init_t()
        oi.dry_distros = {(0.61, 0.0): Setup().lognormal_lnrd}
        oi.nx = oi.ny = oi.nz = n
        oi.dx = oi.dy = oi.dz = 20.0
        oi.x1 = oi.y1 = oi.z1 = n * 20.0
        oi.dt, oi.sd_conc, oi.n_sd_max = 1.0, 16, 16 * n ** 3
        oi.sstp_cond = oi.sstp_coal = 3
        oi.kernel, oi.kernel_parameters = kernel_t.geometric, [1e4]
        oi.terminal_velocity = vt_t.beard77fast
        prt = tl.factory(tl.backend_t.CUDA, oi, device=dev)
        assert type(prt) is particles_dense_t
        full = lambda v, *s: torch.full(s or (n, n, n), v, device=dev)
        th, rv, rhod = full(289.0), full(7.5e-3), full(1.15)
        C = dict(courant_x=full(0.2, n + 1, n, n),
                 courant_y=full(0.1, n, n + 1, n),
                 courant_z=full(-0.05, n, n, n + 1))
        prt.init(th, rv, rhod, **C)
        opts = tl.opts_t()
        before = {k: getattr(_ext, k.upper()).launches for k in names}
        for _ in range(4):
            th, rv = prt.step_sync(opts, th, rv, rhod, plain=plain, **C)
            prt.step_async(opts, plain=plain)
        torch.cuda.synchronize()
        d = prt._d
        out.append((th, rv, multiset(d.n.cpu(), tuple(
            getattr(d, a).cpu() for a in ("rd3", "rw2", "kpa", "x", "y",
                                          "z"))),
            {k: getattr(_ext, k.upper()).launches - before[k]
             for k in names}))
    (tk, rk, mk, nk), (tp, rp, mp, npl) = out
    assert nk == dict.fromkeys(names, 4) and npl == dict.fromkeys(names, 0)
    assert torch.equal(tk, tp) and torch.equal(rk, rp)
    np.testing.assert_array_equal(mk, mp)


def test_onishi_run_matches_plain(dev):
    """run_device_lgrngn(engine="dense") with onishi_hall at 8x8, radii
    x30: E's onishi form once a coalescing step, the kernel path bitwise
    equal to the plain path, and the dense front equal to it; droplets
    collided."""
    kw = dict(nx=8, nz=8, sd_conc=16, n_sd_max=16 * 64, sstp_cond=3,
              sstp_coal=3, opts_init_kw=dict(kernel=kernel_t.onishi_hall,
                                             kernel_parameters=[100.0]),
              device=dev)
    res = []
    for plain in (False, True):
        m = Kinematic2D(**kw)
        m.prtcls.state = dataclasses.replace(
            m.prtcls.state, rw2=m.prtcls.state.rw2 * 900.0)
        n0 = float(m.prtcls.state.n.sum())
        before = _ext.COAL_ONISHI.launches
        m.run_device_lgrngn(5, spinup=2, engine="dense", plain=plain)
        torch.cuda.synchronize()
        res.append((m, _ext.COAL_ONISHI.launches - before, n0))
    (mk, nk, n0), (mp, npl, _) = res
    assert (nk, npl) == (3, 0)
    assert torch.equal(mk.th, mp.th) and torch.equal(mk.rv, mp.rv)
    for a in dense.ATTRS:
        assert torch.equal(getattr(mk.dense_state, a),
                           getattr(mp.dense_state, a)), a
    from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM
    d = mk.dense_state
    assert n0 - float(d.n.sum()) - float(d.puddle[OUT_PRTCL_NUM]) > 0.0


# ---------------------------------------- the multi-device front (flat)
def _near_face(prt, ulps=4):
    """The (nx, nz) cells beside a face that an SD of ``prt`` lies within
    ``ulps`` float32 ulps of the domain's size of: slab-local x rounds
    otherwise than the serial engine's global x there."""
    cfg = prt.cfg
    n = prt.get_attr("n")
    out = np.zeros((cfg.nx, cfg.nz), bool)
    x, z = (prt.get_attr(k).astype(np.float64)[n > 0] for k in ("x", "z"))
    eps = float(np.finfo(np.float32).eps) * ulps
    for pos, d, m, other, od, om, axis in (
            (x, cfg.dx, cfg.nx, z, cfg.dz, cfg.nz, 0),
            (z, cfg.dz, cfg.nz, x, cfg.dx, cfg.nx, 1)):
        r = pos / d
        face = np.rint(r).astype(int)
        near = np.abs(r - face) * d <= eps * m * d
        o = np.clip(np.floor(other / od).astype(int), 0, om - 1)[near]
        for side in (face[near] - 1, face[near]):
            side = side % m if axis == 0 else np.clip(side, 0, m - 1)
            if axis == 0:
                out[side, o] = True
            else:
                out[o, side] = True
    return out


@pytest.mark.parametrize("shards", [3, 8])
def test_multi_front_matches_serial_on_the_card(dev, shards):
    """The flat multi-device front (slabs of 19 columns over 3 or 8
    shards) against the serial flat engine from the same init, 4 steps
    without coalescence through run(): F once a shard a step and A twice a
    step; th and rv within F's cell-sum gates, the SD count and wet
    moment 3 a cell alike away from the cells beside an SD that lay
    within an ulp of a face after a step (slab-local x rounds
    otherwise)."""
    kw = dict(nx=19, nz=10, sd_conc=24, sstp_cond=3, sstp_coal=2,
              device=dev)
    serial = Kinematic2D(opts_init_kw={"coal_switch": False},
                         engine="flat", **kw)
    multi = Kinematic2D(opts_init_kw={"coal_switch": False,
                                      "dev_count": shards}, **kw)
    assert type(multi.prtcls).__name__ == "particles_multi_t"
    near = np.zeros((19, 10), bool)
    got = {}
    for _ in range(4):
        # an SD near a face after a step may condense in either cell
        near |= _near_face(multi.prtcls) | _near_face(serial.prtcls)
        for k in _ext.KERNELS:
            k.launches = 0
        multi.run(1)
        torch.cuda.synchronize()
        for k in _ext.KERNELS:
            if k.launches:
                got[k.name] = got.get(k.name, 0) + k.launches
        serial.run(1)
    assert got == {"mpdata": 8, "cond_flat": 4 * shards}
    assert multi.prtcls.migration_overflow() == 0
    near |= _near_face(multi.prtcls) | _near_face(serial.prtcls)
    far = torch.as_tensor(~near, device=dev)
    assert _rel(multi.th[far], serial.th[far]) <= 2e-6
    assert _rel(multi.rv[far], serial.rv[far]) <= 2e-5
    counts = [m.diag_lgrngn("sd_conc") for m in (multi, serial)]
    np.testing.assert_array_equal(counts[0][~near], counts[1][~near])
    m3 = []
    for m in (multi, serial):
        m.prtcls.diag_all()
        m.prtcls.diag_wet_mom(3)
        m3.append(m.prtcls.outbuf().reshape(19, 10))
    ok = ~near & (m3[1] > 0)
    np.testing.assert_allclose(m3[0][ok], m3[1][ok], rtol=1e-5)


@pytest.mark.parametrize("variant", ["percell", "exact", "exact_no_mixing"])
def test_multi_shard_forms_match_plain(dev, variant):
    """F (per cell) and G's fixed-count form (exact, with and without
    in-cell mixing) on what a step of the 8-shard front gives the last
    shard (2 live columns of the 3 its slab is padded to) against their
    plain versions: F within its cell-sum gates and bitwise in the padded
    cells, where no SD lives; G bitwise without mixing, within B's rw2
    gate with it."""
    import inspect
    oi = {"coal_switch": False, "dev_count": 8}
    fname = "cond_flat"
    if variant != "percell":
        fname = "perparticle_fixed"
        oi.update(exact_sstp_cond=True,
                  sstp_cond_mix=variant == "exact")
    m = Kinematic2D(nx=19, nz=10, sd_conc=24, sstp_cond=3, opts_init_kw=oi,
                    device=dev)
    real, seen = getattr(cond_ops, fname), []

    def spy(*a, **k):
        seen.append(inspect.signature(real).bind(*a, **k).arguments)
        return real(*a, **k)

    setattr(cond_ops, fname, spy)
    try:
        m.run(1)
    finally:
        setattr(cond_ops, fname, real)
    assert len(seen) == 8
    kw = dict(seen[-1])
    kw.pop("plain", None)
    k, pl = real(**kw), real(**kw, plain=True)
    if fname == "cond_flat":
        live = kw["wgt"] > 0
        assert _rel(k[0][live], pl[0][live]) <= 1e-5
        assert _rel(k[1], pl[1]) <= 2e-6 and _rel(k[2], pl[2]) <= 2e-5
        pad = torch.arange(kw["th"].numel(), device=dev) \
            >= m.prtcls.doms[-1].nxl * 10
        assert int(pad.sum()) == 10
        assert not bool(live[pad[kw["sijk"]]].any())
        assert torch.equal(k[1][pad], pl[1][pad])
        assert torch.equal(k[2][pad], pl[2][pad])
    else:
        live = kw["sd"][0] > 0
        if variant == "exact":
            assert _rel(k[0][live], pl[0][live]) <= 1e-5
        else:
            assert torch.equal(k[0], pl[0])
            for a, b in zip(k[1:], pl[1:]):
                assert torch.equal(a[live], b[live])


def _merged_case(m, formula=None):
    """A deferred step's pending state of model ``m`` on the card (the
    plain path) and kernel B's merge-prologue arguments on it: (cfg, args,
    kw) for step.cond, the condensation of the next step from the step's
    th and rv."""
    cfg = m.cfg if formula is None else _with_vt(m.cfg, formula)
    d = m.dense_state
    d, th, rv = dense.step_fused(cfg, d, m.th.reshape(-1), m.rv.reshape(-1),
                                 (), 1.0, 44.0, 1, False, True, defer=True,
                                 plain=True)
    assert d.pending_tgt.shape == d.n.shape
    lam_D, lam_K = hskpng_mfp(d.T, d.p)
    args = (cfg, cfg.sstp_cond, 1.0, 44.0, d.n, d.rw2, d.rd3, d.kpa,
            th * 1.0001, rv * 1.002, d.sstp_tmp_th, d.sstp_tmp_rv, d.rhod,
            d.dv, lam_D, lam_K, d.p)
    return args, dict(pending_tgt=d.pending_tgt, vt=d.vt, x=d.x, z=d.z)


def _check_cond_merged(args, kw):
    """Kernel B's merge-prologue form against its plain version: the merged
    planes and the drops bitwise, the condensation within B's gates, the
    merged rows' dead lanes copied through.  Returns the plain results."""
    k = _launches(_ext.COND_MERGED, lambda: step.cond(*args, **kw))
    p = step.cond(*args, **kw, plain=True)
    assert len(k) == len(p) == 15
    for a, b in zip(k[7:], p[7:]):           # merged n..z, the drops
        assert torch.equal(a, b)
    alive = p[7] > 0
    assert _rel(k[1], p[1]) <= 2e-6          # th
    assert _rel(k[2], p[2]) <= 2e-5          # rv
    assert _rel(k[0][alive], p[0][alive]) <= 1e-5
    assert torch.equal(k[0][~alive], p[8][~alive])
    for a, b in zip(k[3:7], p[3:7]):         # T, p, RH, eta
        assert _rel(a, b) <= 2e-6
    return p


@pytest.mark.parametrize("formula", [None] + OTHER_VT,
                         ids=lambda f: "beard77" if f is None else f.name)
def test_cond_merged_kernel_matches_plain(model, formula):
    """Kernel B's merge-prologue form on a deferred step of the 8x8 case
    at row capacity 32 (D's scalar slots) and 256 (its 16-byte slots),
    under each formula it is instantiated for."""
    p = _check_cond_merged(*_merged_case(model, formula))
    assert bool((p[7] > 0).any())


@pytest.mark.parametrize("cap", [2, 32, 100, 128, 512])
def test_cond_merged_kernel_on_synthetic_rows(dev, cap):
    """Kernel B's merge-prologue form on kernel C's targets of the crowded
    synthetic rows (transport_case: far movers, the puddle, rows that
    receive more droplets than they hold) at row capacity 2 to 512, with
    B's synthetic cells."""
    cfg, (n, rw2, rd3, kpa, x, z), cells = transport_case(
        8, 6, cap, device=dev, dtype=torch.float32)
    n, x, z, vt, tgt, _ = step.transport(cfg, 1.0, True, n, rw2, rd3, x, z,
                                         *cells, plain=True)
    _, cond_cells = _cond_rows(dev, cap, False, rows=cfg.n_cell)
    args = (cfg, 5, 1.0, 44.0, n, rw2, rd3, kpa) + tuple(cond_cells)
    p = _check_cond_merged(args, dict(pending_tgt=tgt, vt=vt, x=x, z=z))
    assert float(p[14].sum()) > 0            # drops
    # the merged planes are kernel D's on the same inputs
    d = step.rebin_x(cfg, n, rw2, rd3, kpa, vt, x, z, tgt)
    for a, b in zip(p[7:], d):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
@pytest.mark.parametrize("cap", [32, 128])
def test_merge_mpdata_kernel_matches_plain(dev, cap, n_iters, fct):
    """Kernel D's MPDATA-epilogue form on kernel C's targets of the
    synthetic rows and the GMD courants of the same 8x6 grid: the planes
    and drops bitwise kernel D's and the plain version's, th and rv
    advected bitwise kernel A's and the plain version's."""
    cfg, (n, rw2, rd3, kpa, x, z), cells = transport_case(
        8, 6, cap, device=dev, dtype=torch.float32)
    n, x, z, vt, tgt, _ = step.transport(cfg, 1.0, True, n, rw2, rd3, x, z,
                                         *cells, plain=True)
    gc_x, gc_z, G, th, rv = _mpdata_case(dev, 8, 6)
    planes = (cfg, n, rw2, rd3, kpa, vt, x, z, tgt)
    mp = (th.reshape(-1), rv.reshape(-1), gc_x, gc_z, G, n_iters, fct)
    k = _launches(_ext.MERGE_MPDATA, lambda: step.rebin_x(*planes,
                                                          mpdata=mp))
    p = step.rebin_x(*planes, mpdata=mp, plain=True)
    d = step.rebin_x(*planes)
    a = mpdata.advect2(th, rv, gc_x, gc_z, G, n_iters=n_iters, fct=fct)
    assert len(k) == len(p) == 10
    for x_k, x_p, x_d in zip(k[:8], p[:8], d):
        assert torch.equal(x_k, x_p) and torch.equal(x_k, x_d)
    for x_k, x_p, x_a in zip(k[8:], p[8:], a):
        assert torch.equal(x_k, x_p) and torch.equal(x_k, x_a)


def test_switched_dense_runs_on_the_card(dev):
    """run_device_lgrngn(engine="dense") with defer_x, mpdata_fuse and both
    on the card, bitwise the default run (every plane, th, rv, the
    overflow); the deferred run launches B's merge-prologue form in every
    step but the first and D once, at the flush; the fused run D's MPDATA
    form every step and kernel A at each phase's first step."""
    kw = dict(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
              n_sd_max=24 * 64, opts_init_kw={"kernel_parameters": [100.0]},
              device=dev)
    m = Kinematic2D(**kw)
    start = (m.dense_state, m.th, m.rv)
    m.run_device_lgrngn(6, spinup=2, engine="dense")
    want = (m.dense_state, m.th, m.rv)
    kernels = (_ext.MPDATA, _ext.MERGE, _ext.COND, _ext.COND_MERGED,
               _ext.MERGE_MPDATA)
    expect = {(True, False): (6, 1, 1, 5, 0), (False, True): (2, 0, 6, 0, 6),
              (True, True): (8, 1, 1, 5, 0)}
    for (defer, fuse), counts in expect.items():
        m.dense_state, m.th, m.rv = start
        before = [k.launches for k in kernels]
        m.run_device_lgrngn(6, spinup=2, engine="dense", defer_x=defer,
                            mpdata_fuse=fuse)
        torch.cuda.synchronize()
        got = tuple(k.launches - b for k, b in zip(kernels, before))
        assert got == counts, (defer, fuse, got)
        assert torch.equal(m.th, want[1]) and torch.equal(m.rv, want[2])
        for f in dataclasses.fields(want[0]):
            a, b = getattr(m.dense_state, f.name), getattr(want[0], f.name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), f.name



# ---------------------- C's 3-D streaming kernel, E's 2-D warp rows (cap > 128)
def _transport3d_forms(cfg, d, moves, sedi, subs, plain=False):
    """transport on dense3d_case's state: with ``moves`` (advection by the
    cfg's scheme) or the vt-only call, sedimentation on drizzle, and a
    subsidence row."""
    w = torch.linspace(-0.4, 0.4, d.n.shape[0], device=d.n.device) \
        if subs else None
    return step.transport(
        cfg, 1.0, sedi and moves, d.n, d.rw2 * (400.0 if sedi else 1.0),
        d.rd3, d.x, d.z, d.T, d.p, d.rhod, d.eta,
        *dense._row_courants(cfg, d), do_adve=moves, w_cells=w,
        courants=(d.courant_x, d.courant_z, d.courant_y),
        y3=dense._y_axis(cfg, d), plain=plain)


@pytest.mark.parametrize("formula", [vt_t.beard77, vt_t.beard76],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("motion", ["sedi", "subs", "sedi+subs", "none"])
@pytest.mark.parametrize("open_walls", [False, True], ids=["periodic",
                                                           "open"])
@pytest.mark.parametrize("scheme", list(SCHEMES_3D))
@pytest.mark.parametrize("cap", [128, 256, 512])
def test_transport_3d_stream_matches_plain(dev, cap, scheme, open_walls,
                                           motion, formula):
    """Kernel C's 3-D streaming kernel (capacities that are multiples of
    128) under each scheme, side wall, sedimentation and subsidence and
    two formulas, on dense3d_case's rows (dead slots among the odd rows'
    droplets, an all-dead and a full row, droplets into the puddle):
    every slot, y and the far flags bitwise transport_plain's, the puddle
    partials rel 1e-5, and a second launch the same bits (the partials
    too); the vt-only call writes vt alone, bitwise."""
    cfg, d = _case3d(dev, cap, scheme, open_side_walls=open_walls)
    cfg = _with_vt(cfg, formula)
    sedi, subs = "sedi" in motion, "subs" in motion
    kernel = _ext.TRANSPORT_3D_PRED_CORR if scheme == "pred_corr" \
        else _ext.TRANSPORT_3D
    kc = _launches(kernel, lambda: _transport3d_forms(cfg, d, True, sedi,
                                                      subs))
    again = _launches(kernel, lambda: _transport3d_forms(cfg, d, True, sedi,
                                                         subs))
    pc = _transport3d_forms(cfg, d, True, sedi, subs, plain=True)
    for a, b in zip(kc[:5] + kc[6:], pc[:5] + pc[6:]):
        assert torch.equal(a, b)
    assert torch.equal(kc[5][:, 4], pc[5][:, 4])
    assert torch.allclose(kc[5][:, :4], pc[5][:, :4], rtol=1e-5, atol=0.0)
    assert all(torch.equal(a, b) for a, b in zip(kc, again))
    assert int(kc[5][:, 4].sum()) > 0                     # far movers
    if sedi and not cfg.periodic_topbot_walls:
        assert float(kc[5][:, 3].sum()) > 0               # the puddle
    if scheme != "pred_corr":
        kv = _launches(_ext.TRANSPORT_3D, lambda: _transport3d_forms(
            cfg, d, False, False, False))
        pv = _transport3d_forms(cfg, d, False, False, False, plain=True)
        assert kv[4] is None and torch.equal(kv[3], pv[3])


@pytest.mark.parametrize("resident", [1, 2, 7])
@pytest.mark.parametrize("cap", [128, 512])
def test_transport_3d_stream_on_few_blocks_matches_plain(dev, monkeypatch,
                                                         cap, resident):
    """The persistent blocks each walk many bricks (the card's resident
    blocks forced down to 1, 2 and 7): the same bits as the plain
    version, the puddle partials and far flags as a full grid's."""
    cfg, d = _case3d(dev, cap, "implicit")
    full = _launches(_ext.TRANSPORT_3D, lambda: _transport3d_forms(
        cfg, d, True, True, False))
    monkeypatch.setattr(step, "card_transport3d",
                        lambda pc, vt, c: resident)
    k = _launches(_ext.TRANSPORT_3D, lambda: _transport3d_forms(
        cfg, d, True, True, False))
    p = _transport3d_forms(cfg, d, True, True, False, plain=True)
    for a, b in zip(k[:5] + k[6:], p[:5] + p[6:]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(k, full))


@pytest.mark.parametrize("pc", [False, True], ids=["implicit", "pred_corr"])
@pytest.mark.parametrize("cap", [128, 256, 512])
def test_transport_3d_stream_resources(dev, cap, pc):
    """The streaming kernel's attributes on the card: the plan's shared
    memory, no local memory (no spill), at least the launch bounds'
    blocks an SM, 256 threads a block; the plan's blocks what the card
    holds at once."""
    a = _ext.attributes("lcp_transport_3d_attrs", vt_t.beard77.value,
                        int(pc), cap)
    assert a["dynamic_shared"] == step.transport3d_smem(cap)
    assert a["threads"] == 256 and a["local"] == 0, a
    assert a["blocks_per_sm"] >= step.C3D_MIN_BLOCKS, a
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert step.card_transport3d(pc, vt_t.beard77.value, cap) \
        == a["blocks_per_sm"] * sms


@pytest.mark.parametrize("row0", [0, 4], ids=["grid", "shard"])
@pytest.mark.parametrize("name", ["geometric", "hall", "vohl"])
@pytest.mark.parametrize("form", ["stride", "sort"])
@pytest.mark.parametrize("cap", [256, 512])
def test_coal_warp_rows_2d_match_plain(coal_model, cap, form, name, row0):
    """Kernel E's 2-D rows above capacity 128 (no y plane) on coal_y.cuh's
    warp rows, with the narrow table, the formula kernel and vohl's wide
    one, on the grid's rows and keyed by a shard's row0: rows under and
    over 128 droplets (both launches run), bitwise coal_resident_plain's
    lane by lane, the same bits launch to launch, launched as
    COAL_WARP_ROWS or COAL_VOHL_WARP_ROWS (not the one-warp row); a
    shard's rows are the whole grid's."""
    kernel, params = COAL_Y_KERNELS[name]
    cfg = _coal_cfg(coal_model, kernel)
    planes, cells = _warp_rows(coal_model.device, cap, seed=cap + 9)
    planes = (planes[0], planes[1] * 100.0) + planes[2:]
    want = coal.resident_kernel(cfg, cap)
    assert want is (_ext.COAL_VOHL_WARP_ROWS if name == "vohl"
                    else _ext.COAL_WARP_ROWS)
    rows = slice(row0, row0 + 24)             # rows 9, 10: the one-warp pass
    live = (planes[0][rows] > 0).sum(1)
    past = (planes[0][rows][:, 128:] > 0).any(1)
    assert bool(past.any()) and bool((~past & (live > 0)).any())
    run = lambda plain: coal.coal_resident(
        cfg, params, 10, 100.0, 44, 3, *(a[rows] for a in planes),
        *(c[rows] for c in cells), pairing=form, row0=row0, plain=plain)
    before = (_ext.COAL.launches, _ext.COAL_VOHL.launches)
    k = _launches(want, lambda: run(False))
    again = _launches(want, lambda: run(False))
    assert (_ext.COAL.launches, _ext.COAL_VOHL.launches) == before
    p = run(True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    whole = coal.coal_resident(cfg, params, 10, 100.0, 44, 3, *planes,
                               *cells, pairing=form)
    assert all(torch.equal(a[rows], b) for a, b in zip(whole, k))
    assert not torch.equal(k[0], planes[0][rows])          # collisions
