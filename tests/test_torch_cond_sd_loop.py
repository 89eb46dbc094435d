"""Kernel G's two forms on the CPU: the layouts the kernel takes
(libcloudphxx_tpu_torch/ops/cond.py perparticle_fixed and
perparticle_adaptive, whose plain versions run here) against the
per-particle substepping as it ran before them, at float64.

On the dense (n_cell, cap) rows the wrappers' plain versions are the
engine's former calls of condensation.perparticle_fixed_core and
perparticle_adaptive_core (the cells broadcast over the rows, the mixing
sums over a row): bitwise equal.  On the flat engine's cell-sorted
segments they sort the SDs by cell, run the core there (the mixing sums
the float64 cumulative sums of condensation.cell_sum over the segments)
and put the results back in slot order: bitwise the core's on the SDs
sorted by the test and put back by it (the mixing sums to 1e-15), and
within rtol 1e-12 of the core's on the unsorted SDs, as the flat engine
ran it before: PyTorch's CPU vector and scalar paths of exp and log give
different last bits by an element's position in a tensor, and the root
find carries such a bit to ~1e-13 of rw2.  The inputs (torch_parity
perparticle_case) hold cells of 0, 1 and more than 32 live SDs, dead
tails, holes that keep their rw2, and dead slots in cell 0.  The phase
against the JAX package: test_torch_perparticle.py (the flat engine),
test_torch_dense_exact.py (the dense one).
"""

import pytest
import torch
from torch_parity import perparticle_case

from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
from libcloudphxx_tpu_torch.ops import cond as cond_ops

COUNTS = [40, 1, 0, 70, 5, 33]
FIXED = {"mix": {}, "nomix": dict(sstp_cond_mix=False),
         "mix_const_p": dict(const_p=True, th_dry=False)}
ADAPTIVE = {"act1": dict(sstp_cond_act=1), "act8": dict(sstp_cond_act=8),
            "act8_const_p": dict(sstp_cond_act=8, const_p=True,
                                 th_dry=False)}


def _assert_equal(got, want, mix=False):
    """Bitwise (a NaN, which the adaptive phase B leaves in a dead slot's
    private values as 0 * 0 / 0, equal to a NaN), the mixing sums'
    results to 1e-15."""
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-15 if mix else 0.0,
                                   atol=0.0, equal_nan=True)


def _fixed_core(cfg, sd, cells, g, full, spread):
    n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0 = sd
    th, rv, rhod, p, dv = cells[:5]
    lam_D, lam_K = hskpng_mfp(*cells[5:7])
    return tcond.perparticle_fixed_core(
        cfg, 1.0, 44.0, n=n, rw2=rw2, rd3=rd3, kpa=kpa, vt=vt, dv_sd=g(dv),
        lam_D_sd=full(lam_D), lam_K_sd=full(lam_K), dlt_rv=g(rv) - rv0,
        dlt_th=g(th) - th0, dlt_rh=g(rhod) - rh0, dlt_p=g(p) - p0,
        tmp_rv0=rv0, tmp_th0=th0, tmp_rh0=rh0, tmp_p0=p0, spread=spread)


def _adaptive_core(cfg, sd, cells, g):
    """perparticle_adaptive_core as the engines called it: the private p
    zeros without const_p."""
    n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0 = (a.reshape(-1) for a in sd)
    if not cfg.const_p:
        p0 = torch.zeros_like(p0)
    lam_D, lam_K = hskpng_mfp(*cells[5:7])
    th, rv, rhod, p, dv, T = (g(a) for a in cells[:5] + cells[7:])
    lam_D, lam_K = g(lam_D), g(lam_K)
    return tcond.perparticle_adaptive_core(
        cfg, 1.0, 44.0, n=n, rw2=rw2, rd3=rd3, kpa=kpa, vt=vt, dv_sd=dv,
        lam_D_sd=lam_D, lam_K_sd=lam_K, dlt_rv=rv - rv0, dlt_th=th - th0,
        dlt_rh=rhod - rh0, dlt_p=p - p0 if cfg.const_p else 0.0,
        tmp_rv0=rv0, tmp_th0=th0, tmp_rh0=rh0, tmp_p0=p0, T_sd=T)


def _slot_cells(seg):
    """The cell of each slot, from the flat layout."""
    sijk, order, _ = seg
    ijk = torch.empty_like(sijk)
    ijk[order] = sijk
    return ijk


@pytest.mark.parametrize("mode", list(FIXED))
def test_fixed_form_on_dense_rows_is_the_core(mode):
    cfg, sd, cells, _ = perparticle_case(COUNTS, cap=128, seed=2,
                                         **FIXED[mode])
    cells = cells[:7]
    got = cond_ops.perparticle_fixed(cfg, 1.0, 44.0, sd, cells)
    shape = sd[0].shape
    want = _fixed_core(
        cfg, sd, cells, lambda a: a[:, None],
        lambda a: a[:, None].expand(shape).contiguous(),
        lambda a: torch.sum(a, dim=1, keepdim=True,
                            dtype=torch.float64).to(a.dtype))
    _assert_equal(got, want)
    live = sd[0] > 0
    assert bool((got[0] != sd[1])[live].any())
    assert torch.equal(got[0][sd[1] == 0], sd[1][sd[1] == 0])


def _unsort(outs, order):
    """Results over the sorted SDs back in slot order."""
    back = []
    for a in outs:
        b = torch.empty_like(a)
        b[order] = a
        back.append(b)
    return back


def _close(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0,
                                   equal_nan=True)


@pytest.mark.parametrize("mode", ["mix", "nomix"])
def test_fixed_form_on_flat_segments_is_the_core(mode):
    cfg, sd, cells, seg = perparticle_case(COUNTS, dead0=9, seed=3,
                                           **FIXED[mode])
    cells = cells[:7]
    got = cond_ops.perparticle_fixed(cfg, 1.0, 44.0, sd, cells, seg)
    sijk, order, ends = seg
    g = lambda a: a[sijk]
    want = _fixed_core(
        cfg, tuple(a[order] for a in sd), cells, g, g,
        lambda a: tcond.cell_sum(a, ends).to(a.dtype)[sijk])
    _assert_equal(got, _unsort(want, order), mix=mode == "mix")
    ijk = _slot_cells(seg)
    g = lambda a: a[ijk]
    _close(got, _fixed_core(
        cfg, sd, cells, g, g,
        lambda a: tcond.cell_sum(a[order], ends).to(a.dtype)[ijk]))
    assert bool((got[0] != sd[1])[sd[0] > 0].any())


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("mode", list(ADAPTIVE))
def test_adaptive_form_is_the_core(mode, layout):
    cap = 128 if layout == "dense" else None
    cfg, sd, cells, seg = perparticle_case(
        COUNTS, cap=cap, dead0=9, seed=4, adaptive_sstp_cond=True,
        **ADAPTIVE[mode])
    got = cond_ops.perparticle_adaptive(cfg, 1.0, 44.0, sd, cells, seg)
    if layout == "dense":
        shape = sd[0].shape
        want = _adaptive_core(cfg, sd, cells, lambda a: a[:, None].expand(
            shape).reshape(-1))
        want = tuple(a.reshape(shape) for a in want)
    else:
        sijk, order, _ = seg
        want = _unsort(_adaptive_core(cfg, tuple(a[order] for a in sd),
                                      cells, lambda a: a[sijk]), order)
        ijk = _slot_cells(seg)
        _close(got, _adaptive_core(cfg, sd, cells, lambda a: a[ijk]))
    _assert_equal(got, want)
    assert bool((got[0] != sd[1])[sd[0] > 0].any())


def test_two_forms_refuse_what_they_do_not_take():
    cfg, sd, cells, _ = perparticle_case([3, 4], cap=8, seed=5)
    _, sd_f, _, seg = perparticle_case([3, 4], seed=5)
    fixed = lambda sd, cells, seg=None: cond_ops.perparticle_fixed(
        cfg, 1.0, 44.0, sd, cells, seg)
    adaptive = lambda sd, cells, seg=None: cond_ops.perparticle_adaptive(
        cfg, 1.0, 44.0, sd, cells, seg)
    with pytest.raises(ValueError, match="expected the SD arrays"):
        fixed(sd[:8], cells[:7])
    with pytest.raises(ValueError, match="expected the SD arrays"):
        adaptive(sd, cells[:7])
    with pytest.raises(ValueError, match="cell arrays must be 1-D"):
        fixed(sd, cells[:6] + (cells[6][:1],))
    with pytest.raises(ValueError, match="of one shape"):
        fixed(sd[:4] + (sd[4][:, :4],) + sd[5:], cells[:7])
    with pytest.raises(ValueError, match="dense rows must be"):
        fixed(tuple(a[:1] for a in sd), cells[:7])
    with pytest.raises(ValueError, match="flat SDs must be 1-D"):
        fixed(sd_f, cells[:7], (seg[0][:-1], seg[1], seg[2]))
    with pytest.raises(ValueError, match="flat SDs must be 1-D"):
        adaptive(sd_f, cells, (seg[0], seg[1], seg[2][:1]))
    with pytest.raises(TypeError, match="int64"):
        fixed(sd_f, cells[:7], (seg[0], seg[1].to(torch.int32), seg[2]))


@pytest.mark.parametrize("form", ["fixed", "adaptive"])
def test_two_forms_raise_on_a_device_without_a_kernel(form):
    """Only CPU tensors take the plain version; a tensor on a device with
    no kernel raises (CUDA tensors launch the kernel: test_torch_cuda)."""
    cfg, sd, cells, _ = perparticle_case([3, 4], cap=8, seed=6,
                                         adaptive_sstp_cond=form != "fixed")
    meta = lambda arrays: tuple(a.to("meta") for a in arrays)
    f = cond_ops.perparticle_fixed if form == "fixed" \
        else cond_ops.perparticle_adaptive
    with pytest.raises(ValueError, match="no kernel for device meta"):
        f(cfg, 1.0, 44.0, meta(sd), meta(cells[:7] if form == "fixed"
                                          else cells))


def test_flat_layout_round_trips_the_slot_order():
    """The flat plain version's sort and scatter back: with sstp_cond 1
    and no growth anywhere (dt 0) every SD keeps its rw2 and takes its
    private increment, slot by slot."""
    cfg, sd, cells, seg = perparticle_case(COUNTS, dead0=9, seed=7,
                                           sstp_cond=1,
                                           sstp_cond_mix=False)
    rw2, rv, th, rh, p = cond_ops.perparticle_fixed(cfg, 0.0, 44.0, sd,
                                                    cells[:7], seg)
    ijk = _slot_cells(seg)
    assert torch.equal(rw2, sd[1])
    assert torch.equal(th, sd[5] + (cells[0][ijk] - sd[5]))
    assert torch.equal(rv, sd[6] + (cells[1][ijk] - sd[6]))
    assert torch.equal(rh, sd[7] + (cells[2][ijk] - sd[7]))
    assert torch.equal(p, sd[8])
