"""Kernel C's 3-D forms in their streaming design (csrc/transport3d.cuh) on
the CPU: the launch plan (ops/step.py transport3d_plan), the kernel's walk
of it written out in numpy, and the C entry points the wrapper calls.

The model follows transport3d.cuh step by step: the persistent blocks walk
their bricks, each warp its rows of a brick; a row's n (every tile)
arrives first, four ballots a 128-slot tile give the list of its live
slots in slot order and the dead slots are written at once (16 bytes where
a lane's four slots are all dead), then the lanes take the live droplets
by list rank, their planes loaded and their results written; the puddle
partials are summed in the old row layout's order and the fixed
butterfly.  The droplets' arithmetic is transport_plain's (the kernel's
droplet3d is the row kernel's per-droplet body); the walk must write every
slot once and give transport_plain's bits.  The kernel itself runs on the
card only (tests/test_torch_cuda.py, chip_smoke.py phase 22).
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from torch_parity import c_params, dense3d_case

from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.lgrngn import dense
from libcloudphxx_tpu_torch.ops import step

TILE = 128


def _rows_of(plan, n_cell):
    """{(block, warp): [rows in the order the warp takes them]}:
    transport3d.cuh row_of, the first row past n_cell ending a warp."""
    per_warp = plan.brick // step.C3D_WARPS
    walk = {}
    for b in range(plan.blocks):
        for w in range(step.C3D_WARPS):
            rows, i = [], 0
            while True:
                brick = b + (i // per_warp) * plan.blocks
                r = brick * plan.brick + (i % per_warp) * step.C3D_WARPS + w
                if r >= n_cell:
                    break
                rows.append(r)
                i += 1
            walk[b, w] = rows
    return walk


@pytest.mark.parametrize("resident", [None, 1, 2, 5, 396])
@pytest.mark.parametrize("n_cell", [1, 7, 8, 33, 60, 438])
@pytest.mark.parametrize("cap", [128, 256, 384, 512, 1024])
def test_transport3d_plan_takes_every_row_once(cap, n_cell, resident):
    """Every row goes to one warp of one block and no row to two; a
    warp's rows grow (so the first past n_cell ends its walk); the rows
    of a brick are one contiguous span, a block's warps on consecutive
    rows; no more blocks than bricks."""
    plan = step.transport3d_plan(cap, n_cell, resident)
    walk = _rows_of(plan, n_cell)
    rows = sorted(r for rs in walk.values() for r in rs)
    assert rows == list(range(n_cell))
    for rs in walk.values():
        assert rs == sorted(rs)
    bricks = -(-n_cell // plan.brick)
    assert 1 <= plan.blocks <= bricks
    if resident is not None:
        assert plan.blocks == min(bricks, resident)
    for (b, w), rs in walk.items():
        for r in rs:
            brick = r // plan.brick
            assert brick % plan.blocks == b
            assert r % step.C3D_WARPS == w


@pytest.mark.parametrize("cap", [128, 256, 384, 512, 1024, 2048])
def test_transport3d_plan_fits_the_card(cap):
    """The plan's brick: 8 warps of max(1, 512 / cap) rows (32 rows at cap
    128, 8 from 512); its shared memory transport3d.cuh's c3_smem, within
    a block's 232,448 bytes; on the H100 by default 132 SMs times the
    blocks an SM holds by shared memory, at most the launch bounds' 3."""
    plan = step.transport3d_plan(cap, 438_976)
    assert plan.brick == 8 * max(1, 512 // cap)
    assert plan.smem == step.transport3d_smem(cap) \
        == 8 * (3 * (cap + 16) * 4 + 2 * cap)
    assert plan.smem <= step.BLOCK_SHARED == 232_448
    per_sm = min(3, step.SM_SHARED // (plan.smem + step.BLOCK_RESERVED))
    assert plan.blocks == 132 * per_sm
    if cap <= 512:
        assert plan.blocks == 396        # the launch bounds' 3 blocks an SM


@pytest.mark.parametrize("cap", [0, 64, 100, 129, 2176, 4096])
def test_transport3d_plan_refuses_a_shape_no_block_holds(cap):
    with pytest.raises(ValueError, match="streaming plan"):
        step.transport3d_plan(cap, 100)
    with pytest.raises(ValueError, match="streaming plan"):
        step.transport3d_plan(128, 0)


def test_transport3d_constants_match_the_kernel():
    """The plan's constants are transport3d.cuh's: warps a block, the
    prefetch's depth, a row's fields in its ring slot, the slots of a
    warp's rows in a brick, the launch bounds' blocks an SM, and the
    shared memory's expression."""
    text = (_ext.CSRC / "transport3d.cuh").read_text()
    const = lambda name: int(re.search(
        r"constexpr int " + name + r" = (\d+);", text).group(1))
    assert (const("kC3Warps"), const("kC3Ahead"), const("kC3Fields"),
            const("kC3Slots"), const("kC3MinBlocks")) == (
        step.C3D_WARPS, step.C3D_AHEAD, step.C3D_FIELDS, step.C3D_SLOTS,
        step.C3D_MIN_BLOCKS)
    assert const("kC3Chunk") == 2
    assert "__launch_bounds__(kC3Warps * 32, kC3MinBlocks)" in text
    assert "* ((kC3Ahead + 1) * (cap + kC3Fields) * 4 + 2 * cap)" in text
    assert "return cap >= kC3Slots ? 1 : kC3Slots / cap;" in text


def _row_walk(n_row, moves):
    """transport3d.cuh's handling of one row's n: (the list of live slots
    in the order the ballots place them, the slots written as dead, the
    dead writes that are 16-byte stores)."""
    cap = n_row.shape[0]
    lst = np.full(cap, -1)
    total, dead, vec = 0, [], []
    for t in range(cap // TILE):
        live = (n_row[t * TILE:(t + 1) * TILE] > 0).reshape(32, 4)
        for lane in range(32):
            pos = total + int(live[:lane].sum())
            for q in range(4):
                if live[lane, q]:
                    lst[pos] = t * TILE + 4 * lane + q
                    pos += 1
            slots = [t * TILE + 4 * lane + q for q in range(4)
                     if not live[lane, q]]
            dead += slots
            if len(slots) == 4:
                vec.append(t * TILE + 4 * lane)
        total += int(live.sum())
    return lst[:total], dead, vec


def _butterfly(v):
    """transport.cuh warp_sum on 32 float32 lanes: every lane's bits."""
    v = v.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ off]
    return v


def _walk_model(n, plain, plan, moves=True):
    """The kernel's outputs assembled by the walk of ``plan``: dead slots
    from the dead writes, live ones from the droplets' results (the plain
    version's per-droplet arithmetic, ``plain``), the far flags.  Returns
    (planes n x z vt tgt y, the far flags, the times each slot was
    written, the slots whose planes were loaded)."""
    n_cell, cap = n.shape
    pn, px, pz, pvt, ptgt, pinfo, py = (
        a.numpy() if a is not None else None for a in plain)
    nan = lambda: np.full((n_cell, cap), np.nan, dtype=np.float32)
    outs = [nan() for _ in range(4)] + [
        np.full((n_cell, cap), -7, dtype=np.int32), nan()]
    written = np.zeros((n_cell, cap), dtype=np.int32)
    loaded = np.zeros((n_cell, cap), dtype=bool)
    far = np.zeros(n_cell, dtype=np.float32)
    n0 = n.numpy()
    rows = [r for rs in _rows_of(plan, n_cell).values() for r in rs]
    for r in rows:
        lst, dead, vec = _row_walk(n0[r], moves)
        assert all(s % 4 == 0 for s in vec)
        for s in dead:
            outs[3][r, s] = 0.0
            if moves:
                for o in (0, 1, 2, 5):
                    outs[o][r, s] = 0.0
                outs[4][r, s] = -1
            written[r, s] += 1
        for c0 in range(0, len(lst), 32 * 2):          # kC3Chunk a lane
            for c in range(2):
                for lane in range(32):
                    k = c0 + 32 * c + lane
                    if k >= len(lst):
                        continue
                    s = lst[k]
                    loaded[r, s] = True
                    outs[3][r, s] = pvt[r, s]
                    if moves:
                        outs[0][r, s], outs[1][r, s] = pn[r, s], px[r, s]
                        outs[2][r, s], outs[5][r, s] = pz[r, s], py[r, s]
                        outs[4][r, s] = ptgt[r, s]
                    written[r, s] += 1
        if moves:   # a ballot of the droplets' flags
            far[r] = pinfo[r, 4]
    return outs, far, written, loaded


def _case(cap, seed, scheme="implicit", **kw):
    import dataclasses

    from libcloudphxx_tpu_torch.lgrngn import as_t
    cfg, d = dense3d_case(4, 3, 5, cap, seed=seed, dtype=torch.float32, **kw)
    return dataclasses.replace(cfg, adve_scheme=as_t[scheme].value), d


def _transport(cfg, d, moves=True):
    return step.transport(
        cfg, 1.0, moves, d.n, d.rw2, d.rd3, d.x, d.z, d.T, d.p, d.rhod,
        d.eta, *dense._row_courants(cfg, d), do_adve=moves,
        courants=(d.courant_x, d.courant_z, d.courant_y),
        y3=dense._y_axis(cfg, d))


@pytest.mark.parametrize("resident", [1, 3])
@pytest.mark.parametrize("cap", [128, 256, 512])
@pytest.mark.parametrize("scheme", ["implicit", "euler", "pred_corr"])
def test_transport3d_walk_gives_the_plain_bits(scheme, cap, resident):
    """The walk over dense3d_case's rows (the odd rows' dead slots among
    their droplets, the even rows' droplets first, an all-dead and a full
    row; movers across the x and y walls, far movers, droplets into the
    puddle) writes every slot once, loads the planes of the live slots
    only, and gives transport_plain's n, x, z, vt, targets and y bitwise
    and its far flags."""
    cfg, d = _case(cap, cap + resident, scheme)
    plain = _transport(cfg, d)
    plan = step.transport3d_plan(cap, d.n.shape[0], resident)
    outs, far, written, loaded = _walk_model(d.n, plain, plan)
    assert (written == 1).all()
    assert np.array_equal(loaded, d.n.numpy() > 0)
    for got, want in zip(outs, plain[:5] + plain[6:]):
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(far, plain[5][:, 4].numpy())
    live = d.n.numpy() > 0
    count = live.sum(1)
    mid = [r for r in range(len(count)) if not live[r][:count[r]].all()]
    first = [r for r in range(len(count))
             if 0 < count[r] < cap and live[r][:count[r]].all()]
    assert mid and first                  # both kinds of row are walked
    assert float(plain[5][:, 4].sum()) > 0                  # far movers


@pytest.mark.parametrize("cap", [128, 512])
def test_transport3d_walk_of_the_vt_only_call(cap):
    """With no transport the walk writes vt alone: 0 in every dead slot
    (16 bytes where a lane's four are dead), the formula's in the live
    ones, each slot once."""
    cfg, d = _case(cap, 7)
    plain = _transport(cfg, d, moves=False)
    assert plain[4] is None
    plan = step.transport3d_plan(cap, d.n.shape[0], 2)
    outs, _, written, loaded = _walk_model(d.n, plain, plan, moves=False)
    assert (written == 1).all()
    assert np.array_equal(loaded, d.n.numpy() > 0)
    np.testing.assert_array_equal(outs[3], plain[3].numpy())


@pytest.mark.parametrize("cap", [128, 256])
def test_transport3d_puddle_sums_in_the_old_order(cap):
    """The rows where droplets fell: the kernel sums each lane's slots 4 j
    .. 4 j + 3 of every tile in order, then the fixed butterfly (every
    lane the same bits), as the old row kernel did; in float32 that is
    transport_plain's partials within 1e-5 (its torch.sum adds in another
    order)."""
    cfg, d = _case(cap, 11)
    assert not cfg.periodic_topbot_walls and not cfg.open_side_walls
    plain = _transport(cfg, d)
    n0, nk, zk = d.n.numpy(), plain[0].numpy(), plain[2].numpy()
    rw2, rd3 = d.rw2.numpy(), d.rd3.numpy()
    fell = (n0 > 0) & (nk == 0) & (zk < cfg.z0)
    assert fell.any()
    vol = np.float32((4.0 / 3) * np.pi)
    zero = np.float32(0.0)
    for r in range(n0.shape[0]):
        acc = np.zeros((4, 32), dtype=np.float32)
        for lane in range(32):
            for t in range(cap // TILE):
                for q in range(4):
                    s = t * TILE + 4 * lane + q
                    if not fell[r, s]:
                        continue
                    m, w = np.float32(n0[r, s]), np.float32(rw2[r, s])
                    acc[0, lane] += vol * m * w * np.sqrt(max(w, zero))
                    acc[1, lane] += vol * m * np.float32(rd3[r, s])
                    acc[2, lane] += m if w > 0 else zero
                    acc[3, lane] += m
        sums = [_butterfly(a) for a in acc]
        assert all(len(set(v.tolist())) == 1 for v in sums)
        np.testing.assert_allclose([v[0] for v in sums],
                                   plain[5][r, :4].numpy(), rtol=1e-5,
                                   atol=0)


def test_transport_3d_wrapper_passes_the_plan(monkeypatch):
    """On a CUDA tensor the wrapper hands kernel C's 3-D forms the plan
    transport3d_plan gives for the card's resident blocks (brick, blocks)
    after the y axis, as many arguments as the entry takes; in the scalar
    layout a placeholder plan the entry ignores."""
    seen = {}

    def launch(kernel):
        def go(*args):
            seen[kernel.name] = args
        return go

    monkeypatch.setattr(_ext, "use_plain", lambda *a: False)
    monkeypatch.setattr(_ext, "check", lambda *a, **k: None)
    monkeypatch.setattr(step, "card_transport3d", lambda pc, vt, cap: 5)
    for k in (_ext.TRANSPORT_3D, _ext.TRANSPORT_3D_PRED_CORR):
        monkeypatch.setattr(k, "launch", launch(k))
    for cap in (100, 128, 256):
        for scheme in ("implicit", "pred_corr"):
            cfg, d = _case(cap, 3, scheme)
            _transport(cfg, d)
            k = _ext.TRANSPORT_3D_PRED_CORR if scheme == "pred_corr" \
                else _ext.TRANSPORT_3D
            args = seen.pop(k.name)
            assert len(args) == len(k.argtypes) - 1     # the stream last
            at = len(_ext.TRANSPORT.argtypes) - 1 + 6
            want = step.transport3d_plan(cap, 60, 5)[:2] if cap % 128 == 0 \
                else (step.C3D_WARPS, 1)
            assert tuple(args[at:at + 2]) == tuple(want)
            assert k.argtypes[at:at + 2] == [ctypes.c_int] * 2


@pytest.mark.parametrize("kernel", [_ext.TRANSPORT_3D,
                                    _ext.TRANSPORT_3D_PRED_CORR],
                         ids=lambda k: k.name)
def test_transport_3d_entries_match_the_wrapper(kernel):
    """_ext's argtypes are the C entry's parameters one for one, and the
    attribute query takes (vt, pred_corr, cap) and the int array."""
    assert c_params("transport3d.cu", kernel.symbol) == kernel.argtypes
    assert c_params("transport3d.cu", "lcp_transport_3d_attrs") == \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
