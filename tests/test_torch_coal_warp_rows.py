"""Kernel E's 2-D rows above capacity 128 on the y forms' warp rows
(csrc/coal_y.cuh, no y plane) on the CPU: which kernel coal_resident
launches at each capacity, with each table and with a mesh shard's row0;
the arguments it hands the C entries; that coal_y.cuh numbers a row's
slots, pairs them and keys their draws as coal.cuh's one-warp row did (so
the bits are the old kernel's); and the one-warp pass's equivalence on
2-D rows with a row0 and vohl's wide table.  The kernels themselves run on
the card only (tests/test_torch_cuda.py, chip_smoke.py phases 12, 17)."""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch_parity import c_params

from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.lgrngn.enums import kernel_t
from libcloudphxx_tpu_torch.ops import coal

POW2 = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512]
TABLES = {"geometric": kernel_t.geometric, "hall": kernel_t.hall,
          "vohl": kernel_t.vohl_davis_no_waals,
          "onishi": kernel_t.onishi_hall}


@pytest.fixture(scope="module")
def base_cfg():
    from libcloudphxx_tpu_torch import Kinematic2D
    return Kinematic2D(nx=8, nz=8, sd_conc=4, n_sd_max=4 * 64,
                       device="cpu", dtype=torch.float32).cfg


def _cfg(base_cfg, name):
    return dataclasses.replace(base_cfg, kernel=TABLES[name].value)


@pytest.mark.parametrize("three", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("cap", POW2)
def test_resident_kernel_routes_by_capacity(base_cfg, cap, name, three):
    """Up to capacity 128 the 2-D rows keep E's one-warp row (COAL, or
    COAL_VOHL with vohl's table); above it they take the warp rows
    (COAL_WARP_ROWS, COAL_VOHL_WARP_ROWS); the 3-D grid its y forms and
    the turbulent kernels the onishi form at every capacity."""
    cfg = _cfg(base_cfg, name)
    wide = name == "vohl"
    want = (_ext.COAL_ONISHI if name == "onishi"
            else (_ext.COAL_VOHL_3D if wide else _ext.COAL_3D) if three
            else (_ext.COAL_VOHL_WARP_ROWS if wide else _ext.COAL_WARP_ROWS)
            if cap > 128 else (_ext.COAL_VOHL if wide else _ext.COAL))
    assert coal.resident_kernel(cfg, cap, three=three) is want
    assert coal.wide_table(cfg) == wide


def _rows(cap, rows, seed, past=True):
    """SD planes of ``rows`` rows at capacity ``cap`` (droplets at random
    places; with ``past`` some past slot 128) and the cells."""
    rng = np.random.default_rng(seed)
    alive = rng.random((rows, cap)) < 0.3
    if not past:
        alive[:, 128:] = False
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, (rows, cap))), 0)
    rw = np.exp(rng.uniform(np.log(2e-6), np.log(3e-4), (rows, cap))) * 10
    T = rng.uniform(280.0, 295.0, rows)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32)
    planes = (n, np.where(alive, rw ** 2, 0.0),
              np.where(alive, (rw * 1e-2) ** 3, 0.0),
              np.where(alive, rng.uniform(0.1, 1.2, (rows, cap)), 0.0),
              rng.uniform(0, 1500, (rows, cap)),
              rng.uniform(0, 1500, (rows, cap)))
    cells = (T, rng.uniform(8.5e4, 1e5, rows), rng.uniform(1.0, 1.2, rows),
             1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5,
             rng.uniform(0.8e4, 1.2e4, rows))
    return tuple(map(f32, planes)), tuple(map(f32, cells))


@pytest.mark.parametrize("row0", [0, 9])
@pytest.mark.parametrize("pairing", ["stride", "sort"])
@pytest.mark.parametrize("name", ["geometric", "hall", "vohl", "onishi"])
@pytest.mark.parametrize("cap", [64, 128, 256, 512])
def test_coal_resident_launches_the_route(monkeypatch, base_cfg, cap, name,
                                          pairing, row0):
    """On a CUDA tensor coal_resident launches resident_kernel's pick and
    hands it as many arguments as its C entry takes: the pairing and row0
    (the y forms none), the y plane in and out where the entry takes one
    (null off the 3-D grid), the queue's scratch above capacity 128."""
    seen = []

    def launch(kernel):
        def go(*args):
            seen.append((kernel, args))
        return go

    monkeypatch.setattr(_ext, "use_plain", lambda *a: False)
    monkeypatch.setattr(_ext, "check", lambda *a, **k: None)
    for k in (_ext.COAL, _ext.COAL_VOHL, _ext.COAL_WARP_ROWS,
              _ext.COAL_VOHL_WARP_ROWS, _ext.COAL_ONISHI):
        monkeypatch.setattr(k, "launch", launch(k))
    cfg = _cfg(base_cfg, name)
    planes, cells = _rows(cap, 16, cap)
    out = coal.coal_resident(cfg, (2.0,), 10, 100.0, 44, 3, *planes, *cells,
                             pairing=pairing, row0=row0)
    assert len(out) == 7
    (kernel, args), = seen
    assert kernel is coal.resident_kernel(cfg, cap)
    assert len(args) == len(kernel.argtypes) - 1          # the stream last
    tail = len(_ext.COAL.argtypes) - 3                    # the pairing
    assert args[tail:tail + 2] == (int(pairing == "sort"), row0)
    rest = args[tail + 2:]
    if kernel is _ext.COAL_ONISHI:
        assert rest[:2] == (None, None)
        rest = rest[2:]
    if kernel in (_ext.COAL, _ext.COAL_VOHL):
        assert rest == ()
    else:
        assert (rest[0] is None) == (cap <= 128)


@pytest.mark.parametrize("kernel", [_ext.COAL_WARP_ROWS,
                                    _ext.COAL_VOHL_WARP_ROWS],
                         ids=lambda k: k.name)
def test_warp_rows_entries_match_the_wrapper(kernel):
    """_ext's argtypes are the C entry's one for one: lcp_coal's (row0
    last), then the queue's scratch and the stream."""
    assert c_params("coal.cu", kernel.symbol) == kernel.argtypes
    assert kernel.argtypes[:-2] == _ext.COAL.argtypes[:-1]
    assert kernel.argtypes[-2:] == [ctypes.c_void_p] * 2


def test_resident_rows_above_128_have_no_one_warp_instantiation():
    """coal.cuh's resident forms stop at 4 register slots a lane (cap 128);
    only the standalone form keeps 8 and 16."""
    text = (_ext.CSRC / "coal.cuh").read_text()
    body = text[text.index("int launch_mode(const CoalArgs& a"):]
    body = body[:body.index("\n}\n")]
    resident, standalone = body.split("} else {")
    assert "if (a.cap > 128) return" in resident
    assert re.findall(r"launch_rows<MODE, (\d+), VT, R>", resident) == \
        ["1", "2", "4"]
    assert re.findall(r"launch_rows<MODE, (\d+), VT, R>", standalone) == \
        ["1", "2", "4", "8", "16"]


def _one_warp_row(cap, lane, c):
    """coal.cuh: a warp of S = cap / 32 register slots, slot (c << 5) |
    lane."""
    return (c << 5) | lane


def _warp_rows(w, lane, c):
    """coal_y.cuh RowWarps::slot: slot (w << 7) | (c << 5) | lane."""
    return (w << 7) | (c << 5) | lane


@pytest.mark.parametrize("cap", [256, 512])
def test_warp_rows_number_pair_and_draw_as_the_one_warp_row(cap):
    """coal_y.cuh's (W = cap / 128 warps of 4 register slots) and coal.cuh's
    (one warp of cap / 32) number a row's slots alike, so every substep
    pairs the same slots and keys the same Philox words: each stride's
    partner (the lane's shuffle under 32, register slot c ^ 1 at 32), the
    slot a pair's Bernoulli word is keyed by (the a-slot), the sort
    pairing's (2i, 2i + 1) and each slot's shuffle word.  The shuffle's
    keys cannot tie, so any sorting network gives the same permutation."""
    s_old, w_new = cap // 32, cap // 128
    old = {(0, lane, c): _one_warp_row(cap, lane, c)
           for lane in range(32) for c in range(s_old)}
    new = {(w, lane, c): _warp_rows(w, lane, c)
           for w in range(w_new) for lane in range(32) for c in range(4)}
    assert sorted(old.values()) == sorted(new.values()) == list(range(cap))

    def pairs(layout, slots_a_lane, stride):
        """{slot: (partner, the slot the pair's word is keyed by)} as the
        kernels' stride_substep computes them at ``stride``."""
        out = {}
        for (w, lane, c), j in layout.items():
            if stride >= 32:                  # register slot c ^ 1
                cp = c ^ 1
                p = layout[w, lane, cp]
                key = layout[w, lane, c & ~1]     # the even slot draws
            else:                             # the lane ^ stride
                p = layout[w, lane ^ stride, c]
                key = j if (lane & stride) == 0 else p
            out[j] = (p, key)
        return out

    for k in range(coal.n_strides_of(cap)):
        stride = 1 << k
        a, b = pairs(old, s_old, stride), pairs(new, 4, stride)
        assert a == b
        assert all(p == j ^ stride for j, (p, _) in a.items())
    for layout in (old, new):       # the sort pairing's pairs in one warp
        where = {j: (w, lane) for (w, lane, c), j in layout.items()}
        for i in range(cap // 2):
            (w0, l0), (w1, l1) = where[2 * i], where[2 * i + 1]
            assert w0 == w1 and l1 == l0 ^ 1


@pytest.mark.parametrize("row0", [0, 7])
@pytest.mark.parametrize("pairing", ["stride", "sort"])
@pytest.mark.parametrize("name", ["hall", "vohl"])
@pytest.mark.parametrize("cap", [256, 512])
def test_warp_rows_one_warp_pass_gives_the_2d_rows_bits(base_cfg, cap, name,
                                                        pairing, row0):
    """The one-warp pass on 2-D rows (no y plane) keyed by a shard's row0,
    with the hall family's and vohl's tables: on rows whose droplets all
    lie in their first 128 slots, coal_resident_plain over those 128
    slots alone gives the full rows' bits there, the slots past 128 are
    the input's, the flags the same; droplets past vohl's index 126
    collide."""
    cfg = _cfg(base_cfg, name)
    planes, cells = _rows(cap, 24, cap + row0, past=False)
    planes = (planes[0], planes[1] * 25.0) + planes[2:]
    base = (cfg, (), 10, 100.0, 44, 3)
    full = coal.coal_resident_plain(*base, *planes, *cells, pairing=pairing,
                                    row0=row0)
    cut = lambda a: a[:, :128].contiguous()
    narrow = coal.coal_resident_plain(*base, *map(cut, planes), *cells,
                                      pairing=pairing, row0=row0)
    for a, b, inp in zip(full[:-1], narrow[:-1], planes):
        assert torch.equal(a[:, :128], b)
        assert torch.equal(a[:, 128:], inp[:, 128:])
    assert torch.equal(full[-1], narrow[-1])
    assert not torch.equal(full[0], planes[0])            # collisions
    if name == "vohl":
        assert float(planes[1].max()) > (1.1e-3) ** 2
