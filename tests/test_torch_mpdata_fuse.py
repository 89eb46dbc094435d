"""The MPDATA epilogue of the re-binning (the JAX package's
LIBCLOUD_MPDATA_FUSE): dense.step_fused(..., mp=) and
Kinematic2D.run_device_lgrngn(engine="dense", mpdata_fuse=True).

* The port's step_fused(..., mp=) against the JAX package's, whose x-merge
  kernel advects th and rv in its grid step 0 (ops/pallas_step.py:740-757),
  run in TPU interpret mode at float32, as tests/test_torch_step_interpret.py
  runs the step: the advected pair at rtol 1e-6 (FCT off and on).
* At float64 on the plain path, the fused model run (kernel D's
  MPDATA-epilogue form a step, kernel A at each chunk's first step) is
  the default run bitwise over 5 steps across the spin-up switch, and so
  is the run with both switches (the deferred step has no D launch: its
  pair comes from kernel A, _mp_apply).
* Each switch (defer_x, mpdata_fuse, both) from a state with a far mover
  and under the repack policy: bitwise the default run, the same global
  re-bins and chunk logs.
* rebin_x's MPDATA form's plain version is rebin_x_plain and one
  _advect_body a field; it rides the seven-plane 2-D form only, and the
  exact mode's step advects with kernel A.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import port_cfg, port_state, t

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.models import mpdata as tmpdata
from libcloudphxx_tpu_torch.ops import step as tstep

NX, NZ, CAP = 12, 10, 32
NT, SPINUP = 5, 2
KW = dict(nx=NX, nz=NZ, sd_conc=24, sstp_cond=3, sstp_coal=3,
          n_sd_max=24 * NX * NZ, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("fct", [False, True])
def test_step_fused_mp_matches_the_pallas_epilogue(fct):
    m = JaxKinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                       sstp_coal=2, n_sd_max=24 * 8 * 8,
                       terminal_velocity=lgrngn.vt_t.beard77)
    cfg = m.prtcls.cfg
    d = jdense.pack(cfg, m.prtcls.state, 32)
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d = dataclasses.replace(d, **{f.name: f32(getattr(d, f.name))
                                  for f in dataclasses.fields(d)
                                  if f.name != "key"})
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    th = jnp.asarray(m.th, jnp.float32).reshape(-1)
    rv = jnp.asarray(m.rv, jnp.float32).reshape(-1)
    mp = tuple(jnp.asarray(a, jnp.float32) for a in (m.gc_x, m.gc_z, m.G))
    dt = float(m.setup.dt)
    with pltpu.force_tpu_interpret_mode():
        jout = jdense.step_fused(cfg, d, th, rv, jnp.zeros((0,), jnp.float32),
                                 dt, 44.0, 2, False, True,
                                 mp=mp + (2, fct))
    assert len(jout) == 5
    f32 = torch.float32
    tout = tdense.step_fused(port_cfg(cfg), port_state(d, f32), t(th, f32),
                             t(rv, f32), (), dt, 44.0, 2, False, True,
                             tuple(t(a, f32) for a in mp) + (2, fct))
    assert len(tout) == 5 and tout[3].shape == (8, 8)
    for a, b in zip(tout[3:], jout[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _model(**oi):
    m = Kinematic2D(opts_init_kw={"kernel_parameters": [100.0], **oi}, **KW)
    m.dense_state = tdense.repack(m.cfg, m.dense_state, CAP)
    return m


@pytest.fixture(scope="module")
def case():
    m = _model()
    start = (m.dense_state, m.th, m.rv)
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense")
    want = (m.dense_state, m.th, m.rv)
    assert float(want[0].n.sum()) < float(start[0].n.sum())  # collisions
    return m, start, want


def _counted(monkeypatch):
    calls = {"advect2": 0, "merge_mpdata": 0, "cond_merged": 0}
    for mod, name, key in ((tmpdata, "advect2", "advect2"),
                           (tstep, "rebin_x_mpdata_plain", "merge_mpdata"),
                           (tstep, "cond_merged_plain", "cond_merged")):
        real = getattr(mod, name)

        def count(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, count)
    return calls


@pytest.mark.parametrize("defer, want_calls", [
    # kernel A at each phase's first step, D's MPDATA form every step
    (False, {"advect2": 2, "merge_mpdata": NT, "cond_merged": 0}),
    # with the deferral no D: kernel A every step after each prologue
    (True, {"advect2": 2 + NT, "merge_mpdata": 0, "cond_merged": NT - 1}),
])
def test_fused_run_is_the_default_run(case, monkeypatch, defer, want_calls):
    m, start, (d_w, th_w, rv_w) = case
    calls = _counted(monkeypatch)
    m.dense_state, m.th, m.rv = start
    m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense", mpdata_fuse=True,
                        defer_x=defer)
    assert calls == want_calls
    assert torch.equal(m.th, th_w) and torch.equal(m.rv, rv_w)
    d = m.dense_state
    for f in dataclasses.fields(d):
        a, b = getattr(d, f.name), getattr(d_w, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


@pytest.mark.parametrize("switches", [
    dict(defer_x=True), dict(mpdata_fuse=True),
    dict(defer_x=True, mpdata_fuse=True)], ids=["defer", "fuse", "both"])
def test_switched_runs_with_a_far_mover_and_repacks(case, switches):
    """Each switch, from a state with a droplet moved three columns (the
    first step repairs it with the global re-bin) at capacity 64, with the
    repack policy every 2 steps (a shrink): bitwise the default run, the
    same re-bins and chunk logs."""
    m, (d0, th0, rv0), _ = case
    live = d0.n > 0
    far = torch.zeros_like(live)
    far.view(-1)[int(torch.nonzero(live.view(-1))[5])] = True
    x = torch.where(far, torch.remainder(d0.x + 3 * m.cfg.dx, m.cfg.x1),
                    d0.x)
    start = tdense.repack(m.cfg, dataclasses.replace(d0, x=x), 64)
    runs = []
    for kw in ({}, switches):
        m.dense_state, m.th, m.rv = start, th0, rv0
        log = []
        m.run_device_lgrngn(NT + 1, spinup=SPINUP, engine="dense",
                            repack_every=2, repack_margin=2.0,
                            chunk_log=log, **kw)
        runs.append(([{k: v for k, v in e.items() if k != "seconds"}
                      for e in log], m.dense_state, m.th, m.rv))
    (log_a, d_a, th_a, rv_a), (log_b, d_b, th_b, rv_b) = runs
    assert d_a.rebins == d_b.rebins == 1
    assert log_a == log_b and any(e["cap"] != 64 for e in log_a)
    assert torch.equal(th_a, th_b) and torch.equal(rv_a, rv_b)
    for f in dataclasses.fields(d_a):
        a, b = getattr(d_a, f.name), getattr(d_b, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


def test_rebin_x_mpdata_plain_is_the_merge_then_advect(case):
    """D's MPDATA form's plain version: rebin_x_plain and _advect_body a
    field (FCT on, three iterations), kernel A's plain version bitwise; the
    form refuses the exact mode's planes."""
    m, start, _ = case
    cfg, d = m.cfg, start[0]
    rng = np.random.default_rng(3)
    tgt = torch.where(d.n > 0, torch.tensor(rng.integers(
        0, cfg.n_cell, d.n.shape)), -1).to(torch.int32)
    tgt = torch.where(tgt >= 0, torch.arange(cfg.n_cell)[:, None], tgt)
    planes = [getattr(d, a) for a in tdense.ATTRS]
    th, rv = m.th.reshape(-1), m.rv.reshape(-1) * 1.01
    mp = (m.gc_x, m.gc_z, m.G, 3, True)
    got = tstep.rebin_x(cfg, *planes, tgt, mpdata=(th, rv) + mp)
    want = tstep.rebin_x_plain(cfg, *planes, tgt) + tmpdata.advect2(
        th.reshape(NX, NZ), rv.reshape(NX, NZ), *mp[:3], n_iters=3,
        fct=True)
    assert len(got) == 10
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seven-plane"):
        tstep.rebin_x(cfg, *planes, tgt, extra=(d.n,) * 4,
                      mpdata=(th, rv) + mp)


def test_exact_step_advects_with_kernel_a():
    """In exact mode the step's D is the 11-plane form, which carries no
    epilogue: step_fused's pair is kernel A's on the step's th and rv."""
    m = _model(exact_sstp_cond=True)
    d, th, rv = m.dense_state, m.th.reshape(-1), m.rv.reshape(-1)
    mp = (m.gc_x, m.gc_z, m.G, 2, False)
    out = tdense.step_fused(m.cfg, d, th, rv, m.opts_init.kernel_parameters,
                            m.setup.dt, 44.0, 3, True, True, mp)
    base = tdense.step_fused(m.cfg, d, th, rv, m.opts_init.kernel_parameters,
                             m.setup.dt, 44.0, 3, True, True)
    assert torch.equal(out[1], base[1]) and torch.equal(out[2], base[2])
    adv = tmpdata.advect2(out[1].reshape(NX, NZ), out[2].reshape(NX, NZ),
                          *mp[:3], n_iters=2, fct=False)
    assert torch.equal(out[3], adv[0]) and torch.equal(out[4], adv[1])
