"""Kernel F's and G-fixed's parcel forms on the CPU: the launch plan that
spreads a parcel's cell over a thread-block cluster (ops/cond.py
parcel_plan), the wrappers' dispatch of a parcel's CPU tensors to the
plain versions, and the C entry points the plan's cluster query calls.

The plan is checked as the kernels walk it (csrc/cond_cluster.cuh
ClusterLane: thread t of a cluster of ctas * threads takes the slots t,
t + ctas * threads, ... of its cell's segment): every slot of every
segment once.  The forms themselves run on the card only
(tests/test_torch_cuda.py, chip_smoke.py phase 19 (b)).
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch_parity import flat_cond_case, perparticle_case

from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.ops import cond as cond_ops

# the most slots a cell of the plan holds: empty, one, a warp and around
# it, a cluster's threads at one slot each and around them, many slots a
# thread
LONGEST = [0, 1, 31, 32, 33, 100, 4095, 4096, 4097, 8192, 8193, 65536,
           100_003]


def _slots(plan, begin, end):
    """The slots each thread of a cluster takes from [begin, end), as
    ClusterLane walks them: {thread: [slot, ...]}."""
    stride = plan.ctas * plan.threads
    n_chunk = -(-(end - begin) // stride)
    return {t: [q for q in (begin + t + ch * stride for ch in range(n_chunk))
                if q < end] for t in range(stride)}


@pytest.mark.parametrize("max_cluster", [16, 8], ids=["wide", "portable"])
@pytest.mark.parametrize("longest", LONGEST)
def test_parcel_plan_covers_every_slot_once(longest, max_cluster):
    """Every slot of segments up to ``longest`` long goes to one thread of
    the cluster and no slot to two; at most ``max_cluster`` CTAs (16 at
    most), threads a CTA a multiple of 32 up to 512; a thread holds one
    slot while the segment fits the cluster's threads, several past it."""
    plan = cond_ops.parcel_plan(longest, max_cluster)
    assert 1 <= plan.ctas <= max_cluster <= 16
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= cond_ops.PARCEL_MAX_THREADS <= 1024
    stride = plan.ctas * plan.threads
    for begin, n in ((0, longest), (7, longest // 2), (longest, 1),
                     (3, 0)):
        taken = _slots(plan, begin, begin + n)
        flat = sorted(q for qs in taken.values() for q in qs)
        assert flat == list(range(begin, begin + n))
        most = max(len(qs) for qs in taken.values())
        assert most == -(-n // stride)
    if longest <= max_cluster * cond_ops.PARCEL_MAX_THREADS:
        assert stride >= longest          # a slot a thread, in registers
    else:
        assert stride == max_cluster * cond_ops.PARCEL_MAX_THREADS
        assert -(-longest // stride) > 1  # several slots a thread


@pytest.mark.parametrize("longest", [1, 33, 4096, 65536])
def test_parcel_plan_uses_no_idle_cta(longest):
    """No CTA of the plan's cluster is without a slot of the longest
    segment, and the cluster spreads a warp a 32 slots over as many CTAs
    as it may take before a CTA takes more than one warp."""
    plan = cond_ops.parcel_plan(longest)
    assert (plan.ctas - 1) * plan.threads < longest
    warps = -(-longest // 32)
    assert plan.ctas == min(16, warps)


def test_parcel_constants_match_the_kernels():
    """The plan's limits are the ones the kernels are built for
    (csrc/cond_cluster.cuh: the shared memory of the cell sums holds
    kParcelThreads / 32 warps, the launch refuses more CTAs than
    kParcelCluster)."""
    text = (_ext.CSRC / "cond_cluster.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(const["kParcelCluster"]) == cond_ops.PARCEL_MAX_CLUSTER
    assert int(const["kParcelThreads"]) == cond_ops.PARCEL_MAX_THREADS
    assert cond_ops.PARCEL_PORTABLE_CLUSTER == 8


@pytest.mark.parametrize("kernel", [_ext.COND_FLAT_PARCEL,
                                    _ext.COND_FLAT_PARCEL_TURB,
                                    _ext.COND_SD_FIXED_PARCEL,
                                    _ext.COND_SD_FIXED_PARCEL_TURB],
                         ids=lambda k: k.name)
def test_cluster_query_entry_points(kernel):
    """Each cluster form has the query _ext.max_clusters calls,
    ``<entry>_clusters(int ctas, int threads, int* count)``, and its entry
    ends with the plan's two ints before the stream."""
    text = (_ext.CSRC / kernel.source.rsplit("/", 1)[1]).read_text()
    m = re.search(r'extern "C" int ' + kernel.symbol
                  + r"_clusters\((.*?)\)\s*\{", text, re.S)
    assert m, f"{kernel.symbol}_clusters not found"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert params == ["int ctas", "int threads", "int* count"]
    assert kernel.argtypes[-3:] == [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def _no_card(monkeypatch):
    """Make any launch or cluster query fail: the CPU path takes neither."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the card")
    monkeypatch.setattr(_ext, "max_clusters", refuse)
    monkeypatch.setattr(_ext, "load", refuse)


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("n", [0, 1, 33, 300])
def test_cond_flat_parcel_runs_the_plain_loop_on_the_cpu(monkeypatch, n,
                                                         turb):
    """A parcel's CPU tensors go to cond_flat_plain (bitwise, with or
    without ``plain``), with no launch, no plan and no cluster query."""
    _no_card(monkeypatch)
    cfg, kw = flat_cond_case([n], n // 8 + 5, 3, "cpu", torch.float32,
                             sstp=10)
    pcfg = dataclasses.replace(cfg, n_dims=0)
    # the weights per kg of air, scaled to a 64-droplet cell's liquid
    wgt = kw["wgt"] / (kw["dv"] * kw["rhod"])[kw["sijk"]] * (64 / max(n, 64))
    kw = dict(kw, wgt=wgt, var_rho=True, RH_max=44.0)
    if turb:
        rng = np.random.default_rng(4)
        m = kw["rw2"].shape[0]
        kw["ssp"] = torch.tensor(rng.normal(0, 2e-3, m), dtype=torch.float32)
        kw["dot_ssp"] = torch.tensor(rng.normal(0, 1e-3, m),
                                     dtype=torch.float32)
    kernel = _ext.COND_FLAT_PARCEL_TURB if turb else _ext.COND_FLAT_PARCEL
    before = kernel.launches
    got = cond_ops.cond_flat(pcfg, **kw)
    want = cond_ops.cond_flat_plain(pcfg, **kw)
    again = cond_ops.cond_flat(pcfg, **kw, plain=True)
    assert kernel.launches == before
    assert len(got) == (5 if turb else 4)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool(torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all())


@pytest.mark.parametrize("turb", [False, True], ids=["", "turb"])
@pytest.mark.parametrize("mix", [True, False], ids=["mix", "nomix"])
@pytest.mark.parametrize("layout", ["cap", "flat"])
def test_perparticle_fixed_parcel_runs_the_plain_loop_on_the_cpu(
        monkeypatch, layout, mix, turb):
    """A parcel's CPU tensors go to perparticle_fixed_plain (bitwise, with
    or without ``plain``), with no launch, no plan and no cluster query,
    on both layouts."""
    _no_card(monkeypatch)
    cap = 48 if layout == "cap" else None
    cfg, sd, cells, seg = perparticle_case(
        [40], cap=cap, dead0=6, seed=5, dtype=torch.float32, sstp_cond=10,
        sstp_cond_mix=mix)
    pcfg = dataclasses.replace(cfg, n_dims=0)
    kw = {}
    if turb:
        rng = np.random.default_rng(6)
        kw["ssp"] = torch.tensor(rng.normal(0, 2e-3, sd[0].numel()),
                                 dtype=torch.float32).reshape(sd[0].shape)
    kernel = _ext.COND_SD_FIXED_PARCEL_TURB if turb \
        else _ext.COND_SD_FIXED_PARCEL
    before = kernel.launches
    got = cond_ops.perparticle_fixed(pcfg, 1.0, 44.0, sd, cells[:7], seg,
                                     **kw)
    want = cond_ops.perparticle_fixed_plain(pcfg, 1.0, 44.0, sd, cells[:7],
                                            seg, **kw)
    again = cond_ops.perparticle_fixed(pcfg, 1.0, 44.0, sd, cells[:7], seg,
                                       plain=True, **kw)
    assert kernel.launches == before
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    live = sd[0] > 0
    assert bool((got[0] != sd[1])[live].any())


@pytest.mark.parametrize("n_cell", [1, 3])
def test_longest_segment(n_cell):
    """The plan's segment length: a single cell's without reading the
    card (all its slots), else the longest of the cells."""
    sizes = [5, 0, 9][:n_cell] if n_cell > 1 else [7]
    ends = torch.tensor(np.cumsum(sizes) - 1)
    assert cond_ops._longest(ends, int(sum(sizes))) == max(sizes)
