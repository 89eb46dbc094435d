"""Kernel D's 3-D forms and kernel E's y and onishi forms on the CPU: their
launch plans (ops/step.py merge3d_plan, ops/coal.py coal_y_plan), the
kernels' walk of those plans written out in numpy, and the C entry points
the wrappers call.

D's model follows csrc/merge3d.cuh step by step: a block stages the one-
byte codes of its brick's 9 columns x (brick + 2) levels, each warp scans
its row's 27 sources against them into a list of taken slots, then
gathers the list; on kernel C's targets it must give rebin_x_plain's bits.
E's plan is checked against the plain version's pairings: no stride or
sort pair of any substep crosses a warp of the row.  The kernels
themselves run on the card only (tests/test_torch_cuda.py, chip_smoke.py
phase 22).
"""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import c_params, dense3d_case

from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.lgrngn import dense
from libcloudphxx_tpu_torch.ops import coal, step

CAPS = [1, 2, 3, 32, 100, 128, 256, 512]
NZS = [1, 2, 3, 4, 7, 15, 16, 17, 33, 76, 200]
SOURCE_DK = (0, -1, 1)      # csrc/merge.cuh source_dk, MERGE_SOURCES' order


def _column_row(i, j, c, nx, ny, nz):
    """merge3d.cuh column_row: column c's first row around (i, j)."""
    return (((i + SOURCE_DK[c // 3]) % nx) * ny
            + (j + SOURCE_DK[c % 3]) % ny) * nz


def _walk(plan, nx, ny, nz):
    """The destination rows of every block and warp, and each row's
    sources as the kernel scans them: {row: [(source row, staged column,
    staged level), ...]}, and the rows in the order blocks and warps take
    them."""
    rows, order = {}, []
    for b in range(nx * ny * plan.bricks):
        col, k0 = b // plan.bricks, (b % plan.bricks) * plan.brick
        i, j = col // ny, col % ny
        for kk in range(plan.brick):
            k = k0 + kk
            if k >= nz:
                continue
            r = col * nz + k
            order.append(r)
            rows[r] = [(_column_row(i, j, c, nx, ny, nz) + k + dk, c,
                        kk + 1 + dk)
                       for c in range(9) for dk in SOURCE_DK
                       if 0 <= k + dk < nz]
    return rows, order


@pytest.mark.parametrize("brick", [None, 1, 3, 5, 16])
@pytest.mark.parametrize("nz", [1, 2, 4, 7, 16, 17])
@pytest.mark.parametrize("nx,ny", [(3, 3), (4, 3), (3, 5)])
def test_merge3d_plan_covers_every_row_once(nx, ny, nz, brick):
    """Every destination row of the grid goes to one warp of one block and
    no row to two; a row's sources, as the brick walks them (x and y
    wrapping), are the plain version's 27 in MERGE_SOURCES_3D order, each
    inside the staged (brick + 2) levels."""
    plan = step.merge3d_plan(128, nz, brick)
    rows, order = _walk(plan, nx, ny, nz)
    n_cell = nx * ny * nz
    assert sorted(order) == list(range(n_cell))
    assert (plan.bricks - 1) * plan.brick < nz <= plan.bricks * plan.brick
    cfg = SimpleNamespace(nx=nx, ny=ny, nz=nz)
    src, ok = step._merge_sources(cfg, n_cell, "cpu", True)
    for r in range(n_cell):
        want = [int(s) for s, o in zip(src[r], ok[r]) if o]
        assert [s for s, _, _ in rows[r]] == want
        assert all(0 <= lvl < plan.brick + 2 for _, _, lvl in rows[r])
        assert len(set(want)) == len(want)      # 27 distinct rows at nx, ny >= 3


@pytest.mark.parametrize("nz", NZS)
@pytest.mark.parametrize("cap", CAPS)
def test_merge3d_plan_fits_the_card(cap, nz):
    """The plan's brick: at most MERGE3D_MAX_BRICK rows and no more than
    nz, its shared memory merge3d.cuh's brick_smem and within a block's
    232,448 bytes, two blocks to an SM's 233,472; every height a test may
    force fits a block too."""
    plan = step.merge3d_plan(cap, nz)
    assert 1 <= plan.brick <= min(nz, step.MERGE3D_MAX_BRICK)
    assert plan.smem == step.merge3d_smem(plan.brick, cap)
    stride = -(-cap // 128) * 128
    assert plan.smem == 9 * (plan.brick + 2) * stride + 4 * plan.brick * cap
    assert plan.smem <= step.BLOCK_SHARED == 232_448
    assert 2 * (plan.smem + step.BLOCK_RESERVED) <= step.SM_SHARED
    for b in range(1, step.MERGE3D_MAX_BRICK + 1):
        assert step.merge3d_plan(cap, nz, b).smem <= step.BLOCK_SHARED


@pytest.mark.parametrize("brick", [0, 17, -1])
def test_merge3d_plan_refuses_a_brick_no_block_holds(brick):
    with pytest.raises(ValueError, match="brick"):
        step.merge3d_plan(128, 76, brick)


def test_merge3d_constants_match_the_kernel():
    """The plan's limits are merge3d.cuh's: kMaxBrick rows a block, the
    byte codes' 128-slot row stride."""
    text = (_ext.CSRC / "merge3d.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxBrick = (\d+);",
                         text).group(1)) == step.MERGE3D_MAX_BRICK
    assert "__launch_bounds__(kMaxBrick * 32, 2)" in \
        (_ext.CSRC / "merge3d.cu").read_text()


def _brick_model(cfg, planes, tgt, plan):
    """merge3d.cuh merge_brick in numpy over every block of ``plan``:
    (planes out, drops)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n_cell, cap = tgt.shape
    stride = -(-cap // 128) * 128
    flat = [p.reshape(-1) for p in planes]
    out = [np.zeros_like(p) for p in planes]
    drops = np.zeros(n_cell, dtype=planes[0].dtype)
    for b in range(nx * ny * plan.bricks):
        col, k0 = b // plan.bricks, (b % plan.bricks) * plan.brick
        i, j = col // ny, col % ny
        base = col * nz + k0
        codes = np.full((9, plan.brick + 2, stride), 0xFF, dtype=np.uint8)
        for c in range(9):
            for lvl in range(plan.brick + 2):
                k = k0 - 1 + lvl
                if 0 <= k < nz:
                    d = tgt[_column_row(i, j, c, nx, ny, nz) + k] - base
                    codes[c, lvl, :cap] = np.where(
                        (d >= 0) & (d < plan.brick), d, 0xFF)
        for kk in range(plan.brick):
            k = k0 + kk
            if k >= nz:
                continue
            r, taken = base + kk, []
            for c in range(9):
                for dk in SOURCE_DK:
                    if 0 <= k + dk < nz:
                        src = _column_row(i, j, c, nx, ny, nz) + k + dk
                        slots = np.nonzero(codes[c, kk + 1 + dk] == kk)[0]
                        taken += [src * cap + int(s) for s in slots]
            placed = min(len(taken), cap)
            for o, f in zip(out, flat):
                o[r, :placed] = f[taken[:placed]]
            drops[r] = max(len(taken) - cap, 0)
    return out, drops


@pytest.mark.parametrize("brick", [None, 1, 2, 3, 16])
@pytest.mark.parametrize("cap", [2, 8, 32, 100, 128])
@pytest.mark.parametrize("grid", [(6, 5, 4), (3, 3, 7)])
def test_merge3d_brick_walk_gives_the_plain_bits(grid, cap, brick):
    """The kernel's walk (staged byte codes, the scan into a list, the
    gather) on kernel C's targets of a synthetic 3-D population (movers
    across the x and y walls, far movers, rows that receive more than
    they hold) gives rebin_x_plain's planes and drops bitwise."""
    cfg, d = dense3d_case(*grid, cap, seed=cap, dtype=torch.float32)
    n, x, z, vt, tgt, _, y = step.transport(
        cfg, 1.0, False, d.n, d.rw2, d.rd3, d.x, d.z, d.T, d.p, d.rhod,
        d.eta, *dense._row_courants(cfg, d),
        courants=(d.courant_x, d.courant_z, d.courant_y),
        y3=dense._y_axis(cfg, d))
    planes = (n, d.rw2, d.rd3, d.kpa, vt, x, z, y)
    want = step.rebin_x_plain(cfg, *planes[:7], tgt, extra=(y,))
    plan = step.merge3d_plan(cap, cfg.nz, brick)
    got, drops = _brick_model(cfg, [p.numpy() for p in planes], tgt.numpy(),
                              plan)
    for a, b in zip(got, want[:-1]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(drops, want[-1].numpy())
    moved = (tgt >= 0) & (tgt != torch.arange(tgt.shape[0])[:, None])
    assert bool(moved.any())
    if cap < 128:
        assert float(want[-1].sum()) > 0          # rows overflowed


def test_rebin_x_3d_on_the_cpu_takes_no_plan(monkeypatch):
    """CPU tensors on the 3-D grid go to rebin_x_plain bitwise, without
    the plan's card query or a launch."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the card")
    monkeypatch.setattr(_ext, "attributes", refuse)
    monkeypatch.setattr(_ext, "load", refuse)
    cfg, d = dense3d_case(4, 3, 5, 32, seed=2, dtype=torch.float32)
    tgt = torch.arange(d.n.shape[0], dtype=torch.int32)[:, None].expand(
        d.n.shape).contiguous()
    tgt = torch.where(d.n > 0, tgt, -1)
    args = (cfg, d.n, d.rw2, d.rd3, d.kpa, d.vt, d.x, d.z, tgt)
    before = _ext.MERGE_3D.launches
    got = step.rebin_x(*args, extra=(d.y,))
    want = step.rebin_x_plain(*args, extra=(d.y,))
    assert _ext.MERGE_3D.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------- kernel E
POW2 = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512]


def _warp_of(j, plan):
    """coal_y.cuh: row slot j's warp, lane and register slot."""
    return j // 128, j % 32, (j % 128) // 32


@pytest.mark.parametrize("cap", POW2)
def test_coal_y_plan_lays_out_every_slot(cap):
    """W warps of S <= 4 register slots a lane hold the row's cap slots,
    each slot in one (warp, lane, register slot); one warp up to cap 128
    (E's one-warp row), cap / 128 above."""
    plan = coal.coal_y_plan(cap)
    assert plan.slots <= 4 and plan.warps * plan.slots * 32 >= cap
    assert plan.warps * 128 >= cap
    assert plan.warps == (1 if cap <= 128 else cap // 128)
    places = {_warp_of(j, plan) for j in range(cap)}
    assert len(places) == cap
    assert all(w < plan.warps and c < plan.slots for w, _, c in places)


@pytest.mark.parametrize("cap", POW2)
def test_coal_y_pairs_never_cross_a_warp(cap):
    """Every substep's pairs lie in one warp of the row: the stride
    partners of the plain version (dense._xor_partner at stride 2**(s %
    n_strides)) and the sort pairing's adjacent (2i, 2i + 1)."""
    plan = coal.coal_y_plan(cap)
    lane = torch.arange(cap)[None, :]
    for s in range(2 * coal.n_strides_of(cap)):
        stride = 1 << (s % coal.n_strides_of(cap))
        if stride >= cap:
            continue
        partner = dense._xor_partner(lane, stride, lane)[0]
        assert torch.equal(partner, lane[0] ^ stride)
        for j, p in enumerate(partner.tolist()):
            assert _warp_of(j, plan)[0] == _warp_of(p, plan)[0]
    for i in range(cap // 2):
        assert _warp_of(2 * i, plan)[0] == _warp_of(2 * i + 1, plan)[0]


def test_coal_y_plan_is_the_kernels():
    """coal_y.cuh with_y_form picks, by capacity, the (S, W) the plan
    gives, in at most 5 shapes a pairing (10 instantiations a formula)."""
    text = (_ext.CSRC / "coal_y.cuh").read_text()
    body = text[text.index("auto with_y_form"):]
    body = body[:body.index("\n}\n")]
    forms = re.findall(r"(?:cap (<=|==) (\d+)\s*\?\s*)?fn\(coal_y_kernel<"
                       r"MODE, (\d+), (\d+), VT>, (\d+), (\d+)\)", body)
    assert len(forms) == 5
    for cmp, bound, s, w, s2, w2 in forms:
        assert (s, w) == (s2, w2)
        caps = [c for c in POW2 if (c <= int(bound) if cmp == "<=" else
                                   c == int(bound))] if cmp else [512]
        for c in caps:
            assert coal.coal_y_plan(c) == (int(w), int(s))


@pytest.mark.parametrize("cap", [0, 3, 1024])
def test_coal_y_plan_refuses(cap):
    with pytest.raises(ValueError, match="power of two"):
        coal.coal_y_plan(cap)


# ------------------------------------------------------ the C entries
@pytest.mark.parametrize("kernel", [_ext.MERGE_3D, _ext.MERGE_3D_EXACT,
                                    _ext.COAL_3D, _ext.COAL_VOHL_3D,
                                    _ext.COAL_ONISHI],
                         ids=lambda k: k.name)
def test_entry_signatures_match_the_wrappers(kernel):
    """_ext's argtypes are the C entry's parameters one for one (the
    merge's brick height last before the stream)."""
    source = kernel.source.rsplit("/", 1)[1]
    assert c_params(source, kernel.symbol) == kernel.argtypes
    if kernel in (_ext.MERGE_3D, _ext.MERGE_3D_EXACT):
        assert kernel.argtypes[-7:-1] == [ctypes.c_int] * 6
    else:       # the y plane in and out, the queue's scratch, the stream
        assert kernel.argtypes[-4:] == [ctypes.c_void_p] * 4


@pytest.mark.parametrize("source,symbol", [
    ("merge3d.cu", "lcp_merge_3d_attrs"),
    ("merge3d_exact.cu", "lcp_merge_3d_exact_attrs"),
    ("coal.cu", "lcp_coal_y_attrs")])
def test_attribute_queries_match_the_wrapper(source, symbol):
    """The queries _ext.attributes calls: three ints (E's four: the
    one-warp pass or the wide form), then the int array of _ext.ATTRS."""
    ints = 4 if symbol == "lcp_coal_y_attrs" else 3
    assert c_params(source, symbol) == [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    assert len(_ext.ATTRS) == 8


@pytest.fixture(scope="module")
def coal_cfg():
    from libcloudphxx_tpu_torch import Kinematic2D
    return Kinematic2D(nx=8, nz=8, sd_conc=4, n_sd_max=4 * 64,
                       device="cpu", dtype=torch.float32).cfg


def _narrow_rows(cap, rows, seed):
    """Rows of ``cap`` slots whose droplets (2-300 um, a random number,
    odd and even, at random places) all lie in the first 128, and the
    cells of a cloudy column."""
    rng = np.random.default_rng(seed)
    alive = np.zeros((rows, cap), dtype=bool)
    for r in range(rows):
        k = int(rng.integers(0, 129))
        alive[r, rng.permutation(128)[:k]] = True
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, (rows, cap))), 0)
    rw = np.exp(rng.uniform(np.log(2e-6), np.log(3e-4), (rows, cap))) * 10
    T = rng.uniform(280.0, 295.0, rows)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32)
    planes = (n, np.where(alive, rw ** 2, 0.0),
              np.where(alive, (rw * 1e-2) ** 3, 0.0),
              np.where(alive, rng.uniform(0.1, 1.2, (rows, cap)), 0.0),
              rng.uniform(0, 1500, (rows, cap)),
              rng.uniform(0, 1500, (rows, cap)),
              rng.uniform(0, 1500, (rows, cap)))
    cells = (T, rng.uniform(8.5e4, 1e5, rows), rng.uniform(1.0, 1.2, rows),
             1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5,
             rng.uniform(0.8e4, 1.2e4, rows))
    return tuple(map(f32, planes)), tuple(map(f32, cells))


@pytest.mark.parametrize("pairing", ["stride", "sort"])
@pytest.mark.parametrize("cap", [256, 512])
def test_coal_y_one_warp_pass_gives_the_wide_rows_bits(coal_cfg, cap,
                                                       pairing):
    """coal_y.cuh's one-warp pass above cap 128: on rows whose droplets all
    lie in their first 128 slots, coal_resident_plain over the first 128
    slots alone gives the full rows' bits there, and the full rows' slots
    past 128 are the input's (dead slots never move); rows collide."""
    import dataclasses
    from libcloudphxx_tpu_torch.lgrngn.enums import kernel_t
    cfg = dataclasses.replace(coal_cfg, kernel=kernel_t.hall.value)
    (n, rw2, rd3, kpa, x, z, y), cells = _narrow_rows(cap, 24, cap)
    base = (cfg, (), 10, 100.0, 44, 3)
    full = coal.coal_resident_plain(*base, n, rw2, rd3, kpa, x, z, *cells,
                                    pairing=pairing, y=y)
    cut = lambda a: a[:, :128].contiguous()
    narrow = coal.coal_resident_plain(
        *base, *map(cut, (n, rw2, rd3, kpa, x, z)), *cells, pairing=pairing,
        y=cut(y))
    for a, b, inp in zip(full[:-1], narrow[:-1], (n, rw2, rd3, kpa, x, z, y)):
        assert torch.equal(a[:, :128], b)
        assert torch.equal(a[:, 128:], inp[:, 128:])
    assert torch.equal(full[-1], narrow[-1])
    assert not torch.equal(full[0], n)                    # collisions
