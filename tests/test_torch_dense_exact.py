"""Port parity: exact and adaptive per-particle condensation on the dense
engine, its pieces (libcloudphxx_tpu_torch/lgrngn/dense.py: the private
ambient planes sd_th, sd_rv, sd_rh and sd_p, pack / unpack / repack /
_rebin_global and the merge carrying them, step_cond_exact,
step_cond_adaptive and the exact mode at one substep) against the JAX
package at float64 on the CPU, where the port runs the plain version of
every kernel (G, D's 11-plane form, B).  The slice and the dense front:
tests/test_torch_dense_exact_slice.py.

The population is the JAX Kinematic2D's at 8x8 cells, sd_conc 8,
sstp_cond 3, beard77, packed at row capacity 16 (half the slots dead).
Its private snapshot is made not row-constant, as after moves: a third of
the SDs carry a neighbouring cell's th, rv, rhod and p (a numpy seed).
The host model's increment (warmer, up to 6% moister) comes from a seed
too.  Tolerances:

* the layout functions move data only: per-cell multisets equal exactly;
* one condensation phase against JAX's dense.step_cond: th and rv rtol
  1e-12, the cell closure rtol 1e-12; rw2 rtol 1e-10 for 99% of the live
  droplets and 1e-7 for all: a haze droplet at its activation barrier
  amplifies the ~1e-16 differences of the two libraries' thermodynamics
  over the substeps (ROADMAP.md, "Cell sums in other orders"; here one
  droplet of rd 80 nm reads 3.3e-8 in all three modes, the rest under
  1e-12, and the first substep's root find alone agrees to 8e-15 on
  identical inputs); the private planes are the new cell values
  exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import multiset, port_cfg, port_flat_state, port_state, t

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.convert import (dense_state_from_numpy,
                                            dense_state_to_numpy)
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.hskpng import ijk_of_xyz
from libcloudphxx_tpu_torch.ops import cond as cond_ops
from libcloudphxx_tpu_torch.ops import step as tstep

F64 = dict(device="cpu", dtype=torch.float64)
KW = dict(nx=8, nz=8, sd_conc=8, sstp_cond=3, n_sd_max=8 * 64)
CAP = 16
MODES = {
    "mix": dict(exact_sstp_cond=True),
    "nomix": dict(exact_sstp_cond=True, sstp_cond_mix=False),
    "adaptive": dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                     sstp_cond_act=8),
}
SD_PLANES = ("sd_th", "sd_rv", "sd_rh", "sd_p")
PLANES = ("rd3", "rw2", "kpa", "x", "z", "vt") + SD_PLANES


def _kw(mode, **over):
    return dict(KW, opts_init_kw=dict(MODES[mode], coal_switch=False),
                **over)


def _jax_case(mode, seed=5, **over):
    """(JAX cfg, JAX flat State, port cfg, port flat State, th, rv): the
    JAX model's population with a snapshot of perturbed cell values, a
    third of its SDs holding a neighbouring cell's, and the advected cell
    fields."""
    m = JaxKinematic2D(micro="lgrngn", terminal_velocity=jl.vt_t.beard77,
                       **_kw(mode, **over))
    cfg, st = m.prtcls.cfg, m.prtcls.state
    rng = np.random.default_rng(seed)
    ijk = np.asarray(st.ijk)
    moved = rng.random(ijk.size) < 1 / 3
    old = np.where(moved, (ijk + rng.choice([-1, 1, -cfg.nz, cfg.nz],
                                            ijk.size)) % cfg.n_cell, ijk)
    # the cells at the last save, each SD with its old cell's values
    saved = dict(th=np.asarray(st.th) + rng.normal(0.0, 0.2, cfg.n_cell),
                 rv=np.asarray(st.rv) * (1 + rng.uniform(-0.02, 0.02,
                                                         cfg.n_cell)),
                 rh=np.asarray(st.rhod), p=np.asarray(st.p))
    js = dataclasses.replace(st, **{f"sstp_tmp_{k}": jnp.asarray(v[old])
                                    for k, v in saved.items()})
    th = np.asarray(st.th) + rng.normal(0.3, 0.3, cfg.n_cell)
    rv = np.asarray(st.rv) * (1 + rng.uniform(0.0, 0.06, cfg.n_cell))
    return cfg, js, port_cfg(cfg), port_flat_state(js), th, rv


def _pop(n, d, planes=PLANES):
    return multiset(np.asarray(n), tuple(np.asarray(getattr(d, a))
                                         for a in planes))


def _moved(cfg, d, seed):
    """``d`` (port) with every live SD moved by less than a cell on each
    axis, x wrapped, z kept inside the domain."""
    rng = np.random.default_rng(seed)
    g = lambda: torch.tensor(rng.uniform(-0.9, 0.9, d.n.shape))
    x = torch.remainder(d.x + g() * cfg.dx, cfg.x1)
    z = torch.clamp(d.z + g() * cfg.dz, 1e-6, cfg.z1 - 1e-6)
    live = d.n > 0
    return dataclasses.replace(d, x=torch.where(live, x, 0.0),
                               z=torch.where(live, z, 0.0))


@pytest.fixture(scope="module")
def mix_case():
    cfg, js, pcfg, ps, th, rv = _jax_case("mix")
    jd = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, js, CAP)
    return cfg, js, pcfg, ps, th, rv, jd


# ------------------------------------------------------------- the layout
def test_pack_unpack_repack_rebin_carry_the_planes(mix_case):
    cfg, js, pcfg, ps, _, _, jd = mix_case
    pd = tdense.pack(pcfg, ps, CAP)
    assert tdense.attrs_of(pcfg)[-4:] == SD_PLANES
    np.testing.assert_array_equal(_pop(pd.n, pd), _pop(jd.n, jd))
    live = pd.n > 0
    spread = torch.where(live, pd.sd_th, -1e9).amax(1) \
        - torch.where(live, pd.sd_th, 1e9).amin(1)
    assert float(spread.max()) > 0          # not row-constant
    # the cells' saved values are the State's th and rv
    assert torch.equal(pd.sstp_tmp_th, ps.th)

    # unpack: the planes become the flat State's per-SD snapshot
    got = tdense.unpack(pcfg, pd, ps)
    want = jdense.unpack(cfg, jd, js)
    keys = ("ijk", "n", "rd3", "rw2", "sstp_tmp_th", "sstp_tmp_rv",
            "sstp_tmp_rh", "sstp_tmp_p")
    rows = lambda st: np.stack([np.asarray(getattr(st, k), float)
                                for k in keys], 1)
    np.testing.assert_array_equal(rows(got), rows(want))
    assert got.sstp_tmp_th.shape == ps.n.shape

    # repack: a grow and a shrink (8 SDs a cell fill capacity 8)
    for new_cap in (32, 8):
        a = tdense.repack(pcfg, pd, new_cap)
        b = jdense.repack(cfg, jd, new_cap)
        assert a.sd_p.shape == (pcfg.n_cell, new_cap)
        np.testing.assert_array_equal(_pop(a.n, a), _pop(b.n, b))
        assert int(a.overflow) == int(b.overflow) == 0

    # the global re-bin of SDs moved to other cells
    mv = _moved(pcfg, pd, 1)
    jmv = dataclasses.replace(jd, **{k: jnp.asarray(getattr(mv, k).numpy())
                                     for k in ("x", "z")})
    tgt = jhskpng.ijk_of_xyz(cfg, jmv.x, jmv.x, jmv.z).astype(jnp.int32)
    b = jdense._rebin_global(cfg, jmv, jnp.where(jmv.n > 0, tgt, cfg.n_cell))
    a = tdense._rebin_global(pcfg, mv)
    np.testing.assert_array_equal(_pop(a.n, a), _pop(b.n, b))
    assert a.rebins == 1 and int(a.overflow) == int(b.overflow) == 0


def test_merge_with_eleven_planes_keeps_the_old_snapshot(mix_case):
    """rebin_x_plain with the four private planes against JAX's rebin
    (its neighbour exchange): a mover takes its old cell's snapshot
    along."""
    cfg, _, pcfg, ps, _, _, jd = mix_case
    mv = _moved(pcfg, tdense.pack(pcfg, ps, CAP), 2)
    tgt = torch.where(mv.n > 0, ijk_of_xyz(pcfg, mv.x, None, mv.z), -1).to(
        torch.int32)
    rows = torch.arange(pcfg.n_cell)[:, None]
    assert bool(((tgt != rows) & (mv.n > 0)).any())
    *planes, drops = tstep.rebin_x_plain(
        pcfg, *(getattr(mv, a) for a in tdense.ATTRS), tgt,
        extra=tuple(getattr(mv, a) for a in SD_PLANES))
    got = dict(zip(tdense.attrs_of(pcfg), planes))
    a = multiset(got["n"].numpy(), tuple(got[k].numpy() for k in PLANES))
    jmv = dataclasses.replace(jd, **{k: jnp.asarray(getattr(mv, k).numpy())
                                     for k in ("x", "z")})
    r = jdense.rebin(cfg, jmv)
    b = _pop(r.n, r)
    np.testing.assert_array_equal(a, b)
    assert float(drops.sum()) == 0
    # the merge of the dense step takes the same route
    m = tdense.merge(pcfg, mv, tgt)
    np.testing.assert_array_equal(_pop(m.n, m), b)


def test_rebin_x_refuses_other_plane_counts(mix_case):
    _, _, pcfg, ps, _, _, _ = mix_case
    d = tdense.pack(pcfg, ps, CAP)
    tgt = torch.full(d.n.shape, -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="0 or 4 extra planes"):
        tstep.rebin_x(pcfg, *(getattr(d, a) for a in tdense.ATTRS), tgt,
                      extra=(d.sd_th,))


def test_convert_roundtrip_of_an_exact_dense_state(mix_case):
    _, _, pcfg, ps, _, _, jd = mix_case
    back = dense_state_to_numpy(port_state(jd))
    back.pop("rng_seed"), back.pop("rng_step")
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jd, k)),
                                      err_msg=k)
    assert back["sd_th"].shape == (pcfg.n_cell, CAP)
    pd = tdense.pack(pcfg, ps, CAP)
    again = dense_state_from_numpy(dense_state_to_numpy(pd), "cpu",
                                   torch.float64)
    for f in dataclasses.fields(pd):
        a, b = getattr(pd, f.name), getattr(again, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


# ------------------------------------------------- the condensation phase
def _check_phase(got, want, rw2_before):
    (d, th, rv), (jd, jth, jrv) = got, want
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-12)
    np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), rtol=1e-12)
    live = (d.n > 0).numpy()
    got_rw2, want_rw2 = d.rw2.numpy()[live], np.asarray(jd.rw2)[live]
    rel = np.abs(got_rw2 - want_rw2) / want_rw2
    assert np.mean(rel <= 1e-10) >= 0.99
    np.testing.assert_allclose(got_rw2, want_rw2, rtol=1e-7)
    np.testing.assert_array_equal(d.rw2.numpy()[~live],
                                  np.asarray(jd.rw2)[~live])
    for k in ("T", "p", "RH", "eta", "sstp_tmp_th", "sstp_tmp_rv"):
        np.testing.assert_allclose(getattr(d, k).numpy(),
                                   np.asarray(getattr(jd, k)), rtol=1e-12,
                                   err_msg=k)
    # the private planes: the new cell values, the density, and the
    # pressure of the closure before condensation
    row = lambda a: a[:, None].expand(d.n.shape)
    assert torch.equal(d.sd_th, row(th)) and torch.equal(d.sd_rv, row(rv))
    assert torch.equal(d.sd_rh, row(d.rhod))
    np.testing.assert_array_equal(d.sd_rh.numpy(), np.asarray(jd.sd_rh))
    np.testing.assert_allclose(d.sd_p.numpy(), np.asarray(jd.sd_p),
                               rtol=1e-12)
    # droplets grew, and the cells took their vapour
    assert float(torch.abs(d.rw2 - rw2_before)[d.n > 0].max()) > 0
    assert (rv.numpy() < np.asarray(jrv) * (1 + 1e-9)).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_step_cond_matches_jax(mode, monkeypatch):
    """One condensation phase: dense.step_cond (step_cond_exact or
    step_cond_adaptive) against JAX's, and G's launches a phase counted
    on its entry (the plain version here)."""
    cfg, js, pcfg, ps, th, rv = _jax_case(mode)
    jd = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, js, CAP)
    pd = port_state(jd)
    assert tdense.exact_route(pcfg)
    want = jax.jit(jdense.step_cond, static_argnums=0)(
        cfg, jd, jnp.asarray(th), jnp.asarray(rv), 1.0, 44.0)
    calls = []
    real = cond_ops.advance_rw2
    monkeypatch.setattr(cond_ops, "advance_rw2",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tdense.step_cond(pcfg, pd, t(th), t(rv), 1.0, 44.0)
    _check_phase(got, want, pd.rw2)
    assert len(calls) == (pcfg.sstp_cond if mode != "adaptive" else
                          len(tl.condensation.adaptive_tries(pcfg.sstp_cond))
                          + max(pcfg.sstp_cond, pcfg.sstp_cond_act))
    assert (got[2].numpy() < rv).any()


def test_exact_mode_at_one_substep_refreshes_the_planes():
    """Exact mode at sstp_cond 1 dispatches to the per-cell substepping
    (kernel B, cond_plain here), and the private planes take the new cell
    values: against JAX's _step_cond_percell, fed the saved cell values
    and the vt B rebuilds from them."""
    cfg, js, pcfg, ps, th, rv = _jax_case("mix", sstp_cond=1)
    assert not tdense.exact_route(pcfg)
    pd = tdense.pack(pcfg, ps, CAP)
    jd = jax.jit(jdense.pack, static_argnums=(0, 2))(cfg, js, CAP)
    c = lambda a: a[:, None]
    T0, p0, _, eta0 = jdense._Tpr(cfg, js.th, js.rv, jd.rhod, jd.p)
    jd = dataclasses.replace(
        jd, sstp_tmp_th=js.th, sstp_tmp_rv=js.rv,
        vt=jvterm.vt_of(cfg, jd.rw2, c(T0), c(p0), c(jd.rhod), c(eta0)))
    want = jax.jit(jdense.step_cond, static_argnums=0)(
        cfg, jd, jnp.asarray(th), jnp.asarray(rv), 1.0, 44.0)
    with pytest.raises(ValueError, match="per-cell modes"):
        tdense.step_cond(pcfg, pd, t(th), t(rv), 1.0, 44.0)
    got = tdense.step_cond_resident(pcfg, pd, t(th), t(rv), 1.0, 44.0)
    _check_phase(got, want, pd.rw2)
