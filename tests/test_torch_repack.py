"""Port parity: the repack, the repack policy of long dense runs, the
phase-split resident step and kernel C's new forms (subsidence, no
advection, the vt refresh alone), against the JAX package at float64 on the
CPU.

* dense.repack against the JAX package's on one population: lane by lane
  (both are one stable sort by row and a scatter), through a grow and a
  shrink, and the droplets a row cannot hold counted in ``overflow``.
* The repack policy, Kinematic2D.run_device_lgrngn(engine="dense",
  repack_every=2), against the JAX package's on the 8x8 GMD case with
  coalescence and sedimentation off, so that both runs are deterministic:
  the chunk logs' occupancies and capacities step for step, exact.  The
  initial capacity is set on both sides (dense_capacity) to force a chunk
  that overflows and is run again, a grow and a shrink; off the kernels'
  device both take 8-lane aligned capacities.  With the repack made to
  keep the old capacity, both raise after 3 retargets.  th rtol 1e-9, rv
  2e-8, as tests/test_torch_kinematic.py: the port rebuilds vt from the
  current cell (ROADMAP.md, known differences).
* The cond phase then the async phase (dense.step_cond_resident,
  step_async_resident) equal to dense.step_fused, bitwise, on the plain
  path, with and without coalescence and on a rain population.
* transport_plain's subsidence and no-advection forms against the JAX dense
  path's adve_sedi_bcnd, and its vt-only form against vt_of: n exact,
  x/z/vt rtol 1e-13, the puddle rtol 1e-12 (summed per row first); and the
  async phase with subsidence against the JAX package's XLA step_async:
  per cell as multisets, rtol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import multiset, port_cfg, port_state, t

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.lgrngn.state import (OUT_DRY_VOL, OUT_LIQ_NUM,
                                           OUT_LIQ_VOL, OUT_PRTCL_NUM)
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import vt_t
from libcloudphxx_tpu_torch.models import kinematic_2d as tkin
from libcloudphxx_tpu_torch.ops import step as tstep

ATTRS = ("n", "rw2", "rd3", "kpa", "vt", "x", "z")


def _jax_packed(cap, sd_conc=24, opts_init_kw=None, rain=False):
    m = JaxKinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=sd_conc,
                       sstp_cond=3, sstp_coal=2, n_sd_max=sd_conc * 64,
                       terminal_velocity=lgrngn.vt_t.beard77,
                       opts_init_kw=opts_init_kw)
    cfg = m.prtcls.cfg
    d = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, cap)
    if rain:  # 1 mm drops within 5 m of the ground
        alive = d.n > 0
        d = dataclasses.replace(
            d, n=jnp.where(alive, 2.0, d.n),
            rw2=jnp.where(alive, (1e-3) ** 2, d.rw2),
            z=jnp.where(alive, cfg.z0 + 5.0 * (d.z / cfg.z1), d.z))
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    return m, cfg, d


# ------------------------------------------------------------------ repack
def test_repack_roundtrip_grow_and_shrink_matches_jax():
    _, cfg, d = _jax_packed(32)
    pcfg, pd = port_cfg(cfg), port_state(d)
    occ = int(np.max(np.sum(np.asarray(d.n) > 0, axis=1)))
    ref = multiset(pd.n, tuple(getattr(pd, a) for a in ATTRS[1:]))
    for cap in (64, max(8, -(-occ // 8) * 8)):
        up_j = jdense.repack(cfg, d, cap)
        up_t = tdense.repack(pcfg, pd, cap)
        assert up_t.cap == cap and int(up_t.overflow) == 0
        for a in ATTRS:  # lane by lane, as the JAX package's
            np.testing.assert_array_equal(getattr(up_t, a).numpy(),
                                          np.asarray(getattr(up_j, a)), a)
        np.testing.assert_array_equal(
            ref, multiset(up_t.n, tuple(getattr(up_t, a)
                                        for a in ATTRS[1:])))
        d, pd = up_j, up_t
    # a capacity below the densest row counts what it cannot hold
    lossy_t, lossy_j = tdense.repack(pcfg, pd, 8), jdense.repack(cfg, d, 8)
    assert int(lossy_t.overflow) == int(lossy_j.overflow) > 0
    kept = int((lossy_t.n > 0).sum())
    assert kept + int(lossy_t.overflow) == ref.shape[0]


POLICY_KW = dict(nx=8, nz=8, sd_conc=24, sstp_cond=2, n_sd_max=24 * 64,
                 opts_init_kw={"coal_switch": False, "sedi_switch": False})
NT, SPINUP, EVERY = 10, 2, 2
# initial capacity, margin, what the first chunk's end must show: the
# densest initial row holds 24 SDs and gains one within the first chunk
POLICIES = {
    "redo": (24, 1.25),      # overflows in the first chunk: run again at 56
    "grow": (26, 1.25),      # less than 10% headroom: 26 -> 32
    "shrink": (64, 2.0),     # 64 holds 1.5 x the occupancy: 64 -> 56
}


def _policy_runs(monkeypatch, cap, margin):
    monkeypatch.setattr(JaxKinematic2D, "dense_capacity", lambda self: cap)
    monkeypatch.setattr(tkin, "dense_capacity", lambda max_count: cap)
    jm = JaxKinematic2D(micro="lgrngn", terminal_velocity=lgrngn.vt_t.beard77,
                        **POLICY_KW)
    tm = Kinematic2D(terminal_velocity=vt_t.beard77, device="cpu",
                     dtype=torch.float64, **POLICY_KW)
    return jm, tm


@pytest.mark.parametrize("policy", list(POLICIES))
def test_repack_policy_matches_jax(monkeypatch, policy):
    cap, margin = POLICIES[policy]
    jm, tm = _policy_runs(monkeypatch, cap, margin)
    logs = [], []
    for m, log in zip((jm, tm), logs):
        m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense",
                            repack_every=EVERY, repack_margin=margin,
                            chunk_log=log)
    j_log, t_log = logs
    assert [(e["spinup"], e["steps"], e["occ"], e["cap"]) for e in t_log] \
        == [(e["spinup"], e["steps"], e["occ"], e["cap"]) for e in j_log]
    assert len(t_log) == NT // EVERY - 1
    first = t_log[0]
    assert first["cap"] == {"redo": 56, "grow": 32, "shrink": 56}[policy]
    assert first["redo"] == int(policy == "redo")
    np.testing.assert_allclose(tm.th.numpy(), np.asarray(jm.th), rtol=1e-9)
    np.testing.assert_allclose(tm.rv.numpy(), np.asarray(jm.rv), rtol=2e-8)
    d = tm.dense_state
    assert d.cap == t_log[-1]["cap"] and int(d.overflow) == 0
    assert int((d.n > 0).sum()) == 24 * 64


def test_repack_policy_raises_after_three_retargets(monkeypatch):
    """With the repack made to keep the old capacity, the first chunk
    overflows again after each retarget: both packages raise after 3."""
    jm, tm = _policy_runs(monkeypatch, *POLICIES["redo"])
    j_repack, t_repack = jdense.repack, tdense.repack
    monkeypatch.setattr(jdense, "repack",
                        lambda cfg, d, cap: j_repack(cfg, d, d.n.shape[1]))
    monkeypatch.setattr(tdense, "repack",
                        lambda cfg, d, cap: t_repack(cfg, d, d.cap))
    for m in (jm, tm):
        with pytest.raises(RuntimeError, match="capacity retargets"):
            m.run_device_lgrngn(NT, spinup=SPINUP, engine="dense",
                                repack_every=EVERY, repack_margin=1.25)


@pytest.mark.parametrize("device,occ,want", [
    ("cpu", 24, 32), ("cpu", 400, 504), ("cuda", 24, 32), ("cuda", 60, 128),
    ("cuda", 409, 512)])
def test_admissible_cap(device, occ, want):
    """8-lane aligned; on a CUDA device (no card needed to ask) a power of
    two up to kernel E's 512, and past it a loud refusal."""
    assert tkin.admissible_cap(occ, 1.25, device) == want


def test_admissible_cap_refuses_past_512():
    assert tkin.admissible_cap(410, 1.25, "cuda") == 512
    with pytest.raises(RuntimeError, match="411 SDs.*at most 512"):
        tkin.admissible_cap(411, 1.25, "cuda")


# -------------------------------------------------------- phase-split step
@pytest.mark.parametrize("case", ["cond_transport", "coal_stride",
                                  "coal_sort", "rain"])
def test_phase_split_equals_step_fused(case):
    """The cond phase, then the async phase from its saved cell values,
    gives step_fused's result bitwise: the same functions on the same
    inputs."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=24, sstp_cond=3, sstp_coal=3,
                    n_sd_max=24 * 64, terminal_velocity=vt_t.beard77,
                    coal_pairing="sort" if case == "coal_sort" else "stride",
                    device="cpu", dtype=torch.float64)
    cfg, d = m.cfg, m.dense_state
    do_coal = case.startswith("coal")
    if do_coal:  # drizzle: radii x10, so that droplets collide
        d = dataclasses.replace(d, rw2=d.rw2 * 100.0)
    if case == "rain":
        alive = d.n > 0
        d = dataclasses.replace(
            d, n=torch.where(alive, 2.0, d.n),
            rw2=torch.where(alive, 1e-6, d.rw2),
            z=torch.where(alive, cfg.z0 + 5.0 * (d.z / cfg.z1), d.z))
    pairing = m.coal_pairing
    th, rv = m.th.reshape(-1) + 0.3, m.rv.reshape(-1) * 1.01
    args = ((100.0,), 1.0, 44.0, 3, do_coal, True)
    fused, th_f, rv_f = tdense.step_fused(cfg, d, th, rv, *args,
                                          coal_pairing=pairing)
    half, th_c, rv_c = tdense.step_cond_resident(cfg, d, th, rv, 1.0, 44.0)
    assert half.vt is d.vt and torch.equal(half.x, d.x)   # stale vt kept
    split = tdense.step_async_resident(cfg, half, (100.0,), 1.0, 3, do_coal,
                                       True, coal_pairing=pairing)
    assert torch.equal(th_c, th_f) and torch.equal(rv_c, rv_f)
    for a in ATTRS + ("T", "p", "RH", "eta", "sstp_tmp_th", "sstp_tmp_rv",
                      "puddle", "overflow"):
        assert torch.equal(getattr(split, a), getattr(fused, a)), a
    assert split.rng_step == fused.rng_step == d.rng_step + int(do_coal)
    if do_coal:
        assert float(fused.n.sum()) < float(d.n.sum())   # collisions
    if case == "rain":
        assert float(fused.puddle[OUT_PRTCL_NUM]) > 0


def test_async_phase_without_transport_refreshes_vt_alone():
    """No advection, sedimentation or subsidence: positions and the
    puddle stay, vt is refreshed from the saved cell state (kernel C's
    vt-only form), no re-bin."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=24, sstp_cond=3, n_sd_max=24 * 64,
                    terminal_velocity=vt_t.beard77, device="cpu",
                    dtype=torch.float64)
    cfg, d = m.cfg, m.dense_state
    d = dataclasses.replace(d, vt=torch.zeros_like(d.vt))
    out = tdense.step_async_resident(cfg, d, (), 1.0, 1, False, False,
                                     do_adve=False)
    for a in ("n", "rw2", "x", "z", "puddle"):
        assert torch.equal(getattr(out, a), getattr(d, a)), a
    live = d.n > 0
    assert bool((out.vt[live] > 0).all()) and bool((out.vt[~live] == 0).all())


# -------------------------------------------------- kernel C's new forms
@pytest.mark.parametrize("form", ["subsidence", "no_advection",
                                  "subsidence_no_advection"])
@pytest.mark.parametrize("rain", [False, True], ids=["cloud", "rain"])
def test_transport_plain_forms_match_jax_adve_sedi_bcnd(form, rain):
    _, cfg, d = _jax_packed(32, rain=rain)
    pcfg, pd = port_cfg(cfg), port_state(d)
    do_adve = form == "subsidence"
    do_subs = form != "no_advection"
    do_sedi = not do_subs
    # a positive-downwards profile by level, strong enough to push the rain
    # through the floor
    w_LS = np.linspace(8.0, -2.0, cfg.nz)
    out_j = jdense.adve_sedi_bcnd(cfg, d, 1.0, do_sedi, do_adve, do_subs,
                                  jnp.asarray(w_LS))
    k = np.arange(cfg.n_cell) % cfg.nz
    n, x, z, vt, tgt, rowinfo = tstep.transport_plain(
        pcfg, 1.0, do_sedi, pd.n, pd.rw2, pd.rd3, pd.x, pd.z, pd.T, pd.p,
        pd.rhod, pd.eta, *tdense._row_courants(pcfg, pd), do_adve=do_adve,
        w_cells=t(w_LS[k]) if do_subs else None)
    live = pd.n.numpy() > 0
    np.testing.assert_array_equal(n.numpy()[live], np.asarray(out_j.n)[live])
    for got, want in ((x, out_j.x), (z, out_j.z), (vt, d.vt)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   rtol=1e-13)
    info = rowinfo.sum(0).numpy()
    pud = np.asarray(out_j.puddle)
    for lane, slot in enumerate((OUT_LIQ_VOL, OUT_DRY_VOL, OUT_LIQ_NUM,
                                 OUT_PRTCL_NUM)):
        np.testing.assert_allclose(info[lane], pud[slot], rtol=1e-12)
    assert info[3] > 0 or not rain
    if not do_adve:  # x moved by nothing
        np.testing.assert_array_equal(x.numpy()[live], pd.x.numpy()[live])


def test_transport_plain_vt_only_matches_jax_vt_of():
    _, cfg, d = _jax_packed(32)
    pcfg, pd = port_cfg(cfg), port_state(d)
    C = tdense._row_courants(pcfg, pd)
    n, x, z, vt, tgt, rowinfo = tstep.transport(
        pcfg, 1.0, False, pd.n, pd.rw2, pd.rd3, pd.x, pd.z, pd.T, pd.p,
        pd.rhod, pd.eta, *C, do_adve=False)
    assert tgt is None and rowinfo is None
    assert n is pd.n and x is pd.x and z is pd.z
    live = pd.n.numpy() > 0
    np.testing.assert_allclose(vt.numpy()[live], np.asarray(d.vt)[live],
                               rtol=1e-13)
    assert bool((vt[~torch.as_tensor(live)] == 0).all())


@pytest.mark.parametrize("do_adve", [True, False], ids=["adve", "no_adve"])
def test_async_phase_with_subsidence_matches_jax_step_async(do_adve):
    """step_async_resident with subsidence (and sedimentation) against the
    JAX package's XLA step_async: vt refresh, transport, walls, re-bin."""
    _, cfg, d = _jax_packed(32)
    w_LS = np.linspace(3.0, 0.5, cfg.nz)
    out_j = jdense.step_async(cfg, d, jnp.zeros((0,)), 1.0, 1, False, True,
                              do_adve, True, jnp.asarray(w_LS))
    out_t = tdense.step_async_resident(
        port_cfg(cfg), port_state(d), (), 1.0, 1, False, True, do_adve,
        True, t(w_LS))
    a = multiset(out_t.n, (out_t.rd3, out_t.rw2, out_t.x, out_t.z, out_t.vt))
    b = multiset(out_j.n, (out_j.rd3, out_j.rw2, out_j.x, out_j.z, out_j.vt))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])   # cell, n, rd3
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-12)
    np.testing.assert_allclose(out_t.puddle.numpy(), np.asarray(out_j.puddle),
                               rtol=1e-12)
    assert int(out_t.overflow) == int(out_j.overflow) == 0
