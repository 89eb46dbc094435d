"""The deferred re-binning (the JAX package's LIBCLOUD_DEFER_X) on the
port's plain path at float64: Kinematic2D.run_device_lgrngn(engine="dense",
defer_x=True) and dense.step_fused(..., defer=True) against the default.

A deferred step leaves its merge pending (DenseState.pending_tgt: kernel
C's targets) and the next step's condensation merges the rows first (kernel
B's merge-prologue form, plain version ops/step.cond_merged_plain); the
merge's inputs are the immediate path's, so the deferred run, once flushed,
is the default run bitwise (torch.equal): every plane, th, rv, the
overflow, the draws' step counter and the global re-bins, with coalescence
on 12x10 cells of sd_conc 24 at row capacity 32 (kernel_parameters [100]
so that droplets collide within a few steps), a far mover repaired while a
merge is pending, and the repack policy's chunk boundaries falling on
pending merges.
"""

import dataclasses

import pytest
import torch

from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.convert import dense_state_to_numpy
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import as_t, kernel_t
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
from libcloudphxx_tpu_torch.ops import step as tstep

NX, NZ, CAP = 12, 10, 32
NT, SPINUP = 6, 2
KW = dict(nx=NX, nz=NZ, sd_conc=24, sstp_cond=3, sstp_coal=3,
          n_sd_max=24 * NX * NZ, device="cpu", dtype=torch.float64)


def _model(**oi):
    m = Kinematic2D(opts_init_kw={"kernel_parameters": [100.0], **oi}, **KW)
    m.dense_state = tdense.repack(m.cfg, m.dense_state, CAP)
    return m


def _start(m):
    return m.dense_state, m.th, m.rv


def _restore(m, start):
    m.dense_state, m.th, m.rv = start


def _same(a, b):
    """Two DenseStates bitwise: every plane and cell field, the overflow,
    the draws' step counter and the global re-bins."""
    for f in dataclasses.fields(tdense.DenseState):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.fixture(scope="module")
def case():
    m = _model()
    return m, _start(m)


def _counted(monkeypatch):
    """Count the merges (kernel D: dense.rebin_x) and B's merge-prologue
    form (its plain version) a run makes."""
    calls = {"rebin_x": 0, "cond_merged": 0}
    rebin_x, merged = tdense.rebin_x, tstep.cond_merged_plain

    def count_rebin(*a, **k):
        calls["rebin_x"] += 1
        return rebin_x(*a, **k)

    def count_merged(*a, **k):
        calls["cond_merged"] += 1
        return merged(*a, **k)

    monkeypatch.setattr(tdense, "rebin_x", count_rebin)
    monkeypatch.setattr(tstep, "cond_merged_plain", count_merged)
    return calls


def test_deferred_run_is_the_default_run(case, monkeypatch):
    m, start = case
    _restore(m, start)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    want = (m.dense_state, m.th, m.rv)
    n0 = float(start[0].n.sum())
    assert float(want[0].n.sum()) < n0          # droplets collided
    assert want[0].rng_step == NT - SPINUP
    calls = _counted(monkeypatch)
    _restore(m, start)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense", defer_x=True)
    # every step but the first merged in its prologue, the run's end
    # flushed the last step's merge: one launch of D in all
    assert calls == {"cond_merged": NT - 1, "rebin_x": 1}
    assert torch.equal(m.th, want[1]) and torch.equal(m.rv, want[2])
    _same(m.dense_state, want[0])
    assert m.dense_state.pending_tgt.numel() == 0


def _steps(m, d, th, rv, k, defer):
    """k coalescing dense.step_fused calls, th and rv fed back."""
    for _ in range(k):
        d, th, rv = tdense.step_fused(
            m.cfg, d, th, rv, m.opts_init.kernel_parameters, m.setup.dt,
            44.0, 3, True, True, defer=defer)
    return d, th, rv


def _far(cfg, d, rd3):
    """``d`` with the droplet of dry volume ``rd3`` moved three columns to
    the right (x-periodic): more than a cell from its row."""
    x = torch.remainder(d.x + 3 * cfg.dx, cfg.x1)
    return dataclasses.replace(d, x=torch.where(d.rd3 == rd3, x, d.x))


def test_far_mover_while_a_merge_is_pending(case):
    """A droplet that moved more than a cell, in the step after a deferred
    one: the step merges in its prologue, C flags the far mover, and the
    repair flushes and re-bins at once (the JAX package's fix,
    lgrngn/dense.py:1581-1594), as the default step re-bins after its
    merge."""
    m, (d0, th0, rv0) = case
    th0, rv0 = th0.reshape(-1), rv0.reshape(-1)
    dd, thd, rvd = _steps(m, d0, th0, rv0, 2, True)
    dn, thn, rvn = _steps(m, d0, th0, rv0, 2, False)
    assert dd.pending_tgt.shape == dd.n.shape
    _same(tdense.flush_merge(m.cfg, dd), dn)
    rd3 = dn.rd3[dn.n > 0][7]
    dd, thd, rvd = _steps(m, _far(m.cfg, dd, rd3), thd, rvd, 1, True)
    dn, thn, rvn = _steps(m, _far(m.cfg, dn, rd3), thn, rvn, 1, False)
    assert dd.pending_tgt.numel() == 0          # the repair flushed
    assert dd.rebins == dn.rebins == 1
    _same(dd, dn)
    assert torch.equal(thd, thn) and torch.equal(rvd, rvn)
    # and the steps after it
    dd, thd, rvd = _steps(m, dd, thd, rvd, 2, True)
    dn, thn, rvn = _steps(m, dn, thn, rvn, 2, False)
    _same(tdense.flush_merge(m.cfg, dd), dn)
    assert torch.equal(thd, thn) and torch.equal(rvd, rvn)


def test_repack_chunks_end_on_pending_merges(case):
    """The repack policy every 2 steps from capacity 64 (it shrinks):
    each chunk ends on a deferred step, whose merge the run flushes before
    the policy reads the occupancy and the overflow; the chunk logs and
    the states are the default run's."""
    m, start = case
    logs = []
    for defer in (False, True):
        _restore(m, start)
        m.dense_state = tdense.repack(m.cfg, start[0], 64)
        log = []
        m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense",
                            repack_every=2, repack_margin=2.0, chunk_log=log,
                            defer_x=defer)
        logs.append(([{k: v for k, v in e.items() if k != "seconds"}
                      for e in log], m.dense_state, m.th, m.rv))
    (log_a, d_a, th_a, rv_a), (log_b, d_b, th_b, rv_b) = logs
    assert log_a == log_b
    assert any(e["cap"] != 64 for e in log_a)    # a repack happened
    _same(d_b, d_a)
    assert torch.equal(th_a, th_b) and torch.equal(rv_a, rv_b)


def test_flush_merge_is_a_noop_without_a_pending_merge(case):
    m, (d0, _, _) = case
    assert tdense.flush_merge(m.cfg, d0) is d0


def test_a_pending_state_flushes_or_refuses(case):
    """unpack and repack flush first (the JAX package's repack flushes its
    x pass, lgrngn/dense.py:245-258); dense_state_to_numpy and moment
    refuse a pending state, naming flush_merge."""
    m, (d0, th0, rv0) = case
    dd, _, _ = _steps(m, d0, th0.reshape(-1), rv0.reshape(-1), 1, True)
    flushed = tdense.flush_merge(m.cfg, dd)
    assert dd.pending_tgt.numel() and not flushed.pending_tgt.numel()
    st = m.prtcls.state
    a, b = tdense.unpack(m.cfg, dd, st), tdense.unpack(m.cfg, flushed, st)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                else va == vb), f.name
    r = tdense.repack(m.cfg, dd, 48)
    assert r.pending_tgt.numel() == 0
    _same(r, tdense.repack(m.cfg, flushed, 48))
    with pytest.raises(ValueError, match="flush_merge"):
        dense_state_to_numpy(dd)
    with pytest.raises(ValueError, match="flush_merge"):
        tdense.moment(dd, 0.0, 1.0, 0)
    assert set(dense_state_to_numpy(flushed))


def test_prologue_plain_is_the_merge_then_cond(case):
    """B's merge-prologue form's plain version is rebin_x_plain followed by
    cond_plain, and step_resident goes on from the merged rows, with the
    merge's drops in rowinfo's lane 5."""
    m, (d0, th0, rv0) = case
    cfg = m.cfg
    dd, th, rv = _steps(m, d0, th0.reshape(-1), rv0.reshape(-1), 1, True)
    tgt = dd.pending_tgt
    planes = [getattr(dd, a) for a in tdense.ATTRS]
    merged = tstep.rebin_x_plain(cfg, *planes, tgt)
    lam = hskpng_mfp(dd.T, dd.p)
    cells = (th, rv, dd.sstp_tmp_th, dd.sstp_tmp_rv, dd.rhod, dd.dv, *lam,
             dd.p)
    want = tstep.cond_plain(cfg, 3, 1.0, 44.0, *merged[:4], *cells)
    got = tstep.cond(cfg, 3, 1.0, 44.0, dd.n, dd.rw2, dd.rd3, dd.kpa,
                     *cells, pending_tgt=tgt, vt=dd.vt, x=dd.x, z=dd.z)
    assert len(got) == 15
    for a, b in zip(got, want + merged):
        assert torch.equal(a, b)
    # step_resident with the pending merge, against the merged rows
    flushed = tdense.flush_merge(cfg, dd)
    for a in tdense.ATTRS:
        assert torch.equal(getattr(flushed, a), merged[tdense.ATTRS.index(a)])
    C = tdense._row_courants(cfg, dd)
    kw = dict(do_coal=False, courants=(dd.courant_x, dd.courant_z))
    args = (cfg, 3, 1.0, 44.0, True)
    cell_args = cells[:-1] + C + (dd.p,)
    got = tstep.step_resident(*args, dd.n, dd.rw2, dd.rd3, dd.kpa, dd.x,
                              dd.z, *cell_args, pending_tgt=tgt, vt=dd.vt,
                              **kw)
    want = tstep.step_resident(*args, *(merged[i] for i in (0, 1, 2, 3, 5,
                                                             6)),
                               *cell_args, **kw)
    for a, b in zip(got[:14], want[:14]):
        assert torch.equal(a, b)
    assert torch.equal(got[14][:, 5], merged[7])
    assert torch.equal(got[14][:, :5], want[14][:, :5])


@pytest.mark.parametrize("oi, ok", [
    ({}, True),
    ({"kernel": kernel_t.hall}, True),
    ({"kernel": kernel_t.vohl_davis_no_waals}, False),
    ({"kernel": kernel_t.onishi_hall}, False),
    ({"adve_scheme": as_t.pred_corr}, False),
    ({"exact_sstp_cond": True}, False),
])
def test_defer_only_where_the_jax_package_defers(oi, ok):
    """dense.defer_ok follows the JAX package's resident_static_ok
    (lgrngn/dense.py:1209); where it does not hold, defer=True runs the
    ordinary step (no pending merge)."""
    m = _model(**oi)
    assert tdense.defer_ok(m.cfg) == ok
    d, th, rv = _start(m)
    out = tdense.step_fused(m.cfg, d, th.reshape(-1), rv.reshape(-1),
                            m.opts_init.kernel_parameters, m.setup.dt, 44.0,
                            1, False, True, defer=True)
    assert bool(out[0].pending_tgt.numel()) == ok
