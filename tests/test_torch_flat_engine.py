"""Port parity: the flat engine's modules (libcloudphxx_tpu_torch.lgrngn
condensation, transport, coalescence) against the JAX package's flat
engine at float64 on the CPU, slot for slot.

The population is the JAX Kinematic2D's at 8x8 cells, sd_conc 16, with 40
dead slots after the live ones, handed to the port through
convert.state_from_numpy.  Tolerances:

* condensation (cond_percell, 3 substeps, with and without the substepped
  rhod): th/rv rtol 1e-13; rw2 rtol 1e-10 for 99% of the droplets and
  1e-6 for all.  Both packages take each cell's latent heat as the
  difference of a population-wide cumulative sum at the cell's ends, and
  the two libraries' cumulative sums add in other orders, so th/rv differ
  at ~1e-15; a haze droplet at its activation barrier (rw ~ 0.1 um),
  where the root of the growth equation moves ~1e7 times faster than RH,
  carries that to ~1e-8;
* transport, walls and re-binning: positions rtol 1e-14, cells,
  multiplicities and the puddle's particle count exact, its volumes rtol
  1e-13;
* coalescence, fed the port's draws (jax.random.uniform patched in the
  test, with keys that cannot tie): multiplicities exact, rw2 rtol 1e-12
  (the port's exp/log cube root against jnp.cbrt), rd3 and kappa rtol
  1e-14.

With the port's own draws the checks are physical: water and dry mass
conserved to rtol 1e-12 in every substep, and the Golovin box gate of
tests/test_pallas_coal_golovin.py (RMSD < 3.5e-5 against Scott 1967) on
the flat engine.
"""

import dataclasses
import filecmp
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_coal_golovin import (B_GOLOVIN, CAP, N_BOX, SIM_TIME,
                                      _golovin_population, _spectrum_err)
from test_pallas_cond import _population
from torch_parity import port_cfg, port_flat_state, t

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu.lgrngn import transport as jtransport
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.lgrngn.condensation import _advance_rw2_core
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch.convert import state_to_numpy
from libcloudphxx_tpu_torch.lgrngn import coalescence as tcoal
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import hskpng as thskpng
from libcloudphxx_tpu_torch.lgrngn import transport as ttransport
from libcloudphxx_tpu_torch.lgrngn import vterm as tvterm
from libcloudphxx_tpu_torch.lgrngn.enums import as_t, kernel_t
from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM, State
from libcloudphxx_tpu_torch.ops import cond as cond_ops
from libcloudphxx_tpu_torch.ops import philox

KW = dict(nx=8, nz=8, sd_conc=16, sstp_cond=3, sstp_coal=3,
          n_sd_max=16 * 64 + 40, opts_init_kw={"kernel_parameters": [1e4]})
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flat():
    """(JAX cfg, JAX State after the closure and vt, the port's cfg and
    State of the same numbers)."""
    m = JaxKinematic2D(micro="lgrngn", **KW)
    cfg = m.prtcls.cfg
    st = jvterm.hskpng_vterm_all(cfg, jhskpng.hskpng_Tpr(cfg, m.prtcls.state))
    return cfg, st, port_cfg(cfg), port_flat_state(st)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_state_converts_both_ways(flat):
    cfg, st, _, ps = flat
    back = state_to_numpy(ps)
    assert (int(back.pop("rng_seed")), int(back.pop("rng_step"))) == (44, 0)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st, k)),
                                      err_msg=k)
    assert int((ps.n > 0).sum()) == 16 * 64 and ps.n_sd_max == 16 * 64 + 40


def test_advance_rw2_plain_matches_core_f64():
    """ops/cond.advance_rw2 on CPU tensors is the plain version: it equals
    the JAX core at float64 (32 root-find iterations both sides)."""
    a = _population(513, seed=3, dtype=jnp.float64)
    want = np.asarray(_advance_rw2_core(1.0, *a.values(), 44.0))
    got = cond_ops.advance_rw2(1.0, *(t(v) for v in a.values()), 44.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("var_rho", [False, True])
def test_cond_percell_matches_jax(flat, var_rho):
    cfg, st, pcfg, ps = flat
    rng = np.random.default_rng(5)
    # a host-model increment: warmer here, moister there, and (var_rho) a
    # denser cell column
    dth = rng.normal(0.0, 0.3, cfg.n_cell)
    frv = 1.0 + rng.uniform(-0.02, 0.04, cfg.n_cell)
    frh = 1.0 + rng.uniform(0.0, 0.01, cfg.n_cell) * var_rho
    js = dataclasses.replace(st, th=st.th + dth, rv=st.rv * frv,
                             rhod=st.rhod * frh)
    want = jcond.cond_percell(cfg, js, 1.0, 44.0, var_rho=var_rho,
                              lam=jcond.stale_mfp(st))
    ts = dataclasses.replace(ps, th=ps.th + t(dth), rv=ps.rv * t(frv),
                             rhod=ps.rhod * t(frh))
    got = tcond.cond_percell(pcfg, ts, 1.0, 44.0, tcond.stale_mfp(ps),
                             var_rho=var_rho)
    rw2, ref = got.rw2.numpy(), np.asarray(want.rw2)
    rel = np.abs(rw2 - ref) / np.maximum(ref, 1e-300)
    assert np.mean(rel <= 1e-10) >= 0.99
    np.testing.assert_allclose(rw2, ref, rtol=1e-6)
    for k in ("th", "rv", "rhod", "T", "p", "RH"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-13,
                                   err_msg=k)
    assert _rel(got.rw2, ps.rw2) > 1e-3          # droplets grew
    saved = tcond.sstp_save(got)
    assert saved.sstp_tmp_th is got.th and saved.sstp_tmp_rh is got.rhod


def _moved(st, lib, rng_seed=9):
    """The state with positions scattered so that some SDs leave through
    every wall: the same numbers for either package's State (``lib`` the
    array module)."""
    rng = np.random.default_rng(rng_seed)
    n = st.n.shape[0]
    dz = rng.uniform(-300.0, 300.0, n)
    dx = rng.uniform(-300.0, 300.0, n)
    return dataclasses.replace(st, x=st.x + lib(dx), z=st.z + lib(dz))


@pytest.mark.parametrize("scheme", ["implicit", "euler", "pred_corr"])
def test_adve_sedi_subs_match_jax(flat, scheme):
    cfg, st, pcfg, ps = flat
    val = as_t[scheme].value
    cfg = dataclasses.replace(cfg, adve_scheme=val)
    pcfg = dataclasses.replace(pcfg, adve_scheme=val)
    w_LS = np.linspace(0.0, 0.05, cfg.nz)
    want = jtransport.subs(cfg, jtransport.sedi(
        jtransport.adve(cfg, st), 1.0), jnp.asarray(w_LS), 1.0)
    got = ttransport.subs(pcfg, ttransport.sedi(
        ttransport.adve(pcfg, ps), 1.0), t(w_LS), 1.0)
    for k in ("x", "z"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-14,
                                   err_msg=k)
    assert _rel(got.z, ps.z) > 0 and _rel(got.x, ps.x) > 0


@pytest.mark.parametrize("walls", ["closed", "open_side", "periodic_topbot"])
def test_bcnd_and_post_step_match_jax(flat, walls):
    cfg, st, pcfg, ps = flat
    over = {"open_side": {"open_side_walls": True},
            "periodic_topbot": {"periodic_topbot_walls": True}}.get(walls, {})
    cfg = dataclasses.replace(cfg, **over)
    pcfg = dataclasses.replace(pcfg, **over)
    want = jtransport.post_step(cfg, jtransport.bcnd(cfg, _moved(
        st, jnp.asarray)))
    got = ttransport.post_step(pcfg, ttransport.bcnd(pcfg, _moved(ps, t)))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    np.testing.assert_array_equal(got.ijk.numpy(), np.asarray(want.ijk))
    for k in ("x", "z"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-14,
                                   err_msg=k)
    np.testing.assert_allclose(got.puddle.numpy(), np.asarray(want.puddle),
                               rtol=1e-13)
    fell = float(got.puddle[OUT_PRTCL_NUM])
    assert (fell > 0) == (walls != "periodic_topbot")
    assert int((got.n > 0).sum()) < int((ps.n > 0).sum()) \
        or walls == "periodic_topbot"


def _jax_ranks(st, bits, n_cell):
    """The shuffle numbers that make the JAX sort by (cell, number) give
    the port's permutation: each slot's rank in the port's stable sort on
    (cell << 32 | bits), over the slot count (so no two tie)."""
    n = np.asarray(st.n)
    cell = np.where(n <= 0, n_cell, np.asarray(st.ijk)).astype(np.int64)
    key = (cell << 32) | bits
    order = np.argsort(key, kind="stable")
    rank = np.empty(n.size)
    rank[order] = np.arange(n.size)
    return rank / n.size


def test_coal_matches_jax_on_port_draws(flat, monkeypatch):
    """sstp_coal substeps of the port's coal against the JAX coal_substep
    stepped by hand, fed the port's Philox draws; vt refreshed before every
    substep, as both loops do."""
    cfg, st, pcfg, ps = flat
    params, sstp, step = [1e4], 3, 0
    got = tcoal.coal(pcfg, ps, params, 1.0, sstp)
    n_sd = ps.n_sd_max
    bits = philox.draw_substeps(ps.rng_seed, step, sstp, philox.SHUFFLE,
                                n_sd).numpy()
    u01 = philox.u01(philox.draw_substeps(ps.rng_seed, step, sstp,
                                          philox.BERNOULLI, n_sd),
                     torch.float64).numpy()
    g = lambda a: a[st.ijk]
    cells = (g(st.T), g(st.p), g(st.rhod), g(st.eta))
    js = st
    for s in range(sstp):
        js = dataclasses.replace(js, vt=jvterm.vt_of(cfg, js.rw2, *cells))
        feed = iter([jnp.asarray(_jax_ranks(js, bits[s], cfg.n_cell)),
                     jnp.asarray(u01[s])])
        monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: next(feed))
        js = jcoal.coal_substep(cfg, js, jnp.asarray(params), 1.0 / sstp,
                                jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(js.n))
    np.testing.assert_allclose(got.rw2.numpy(), np.asarray(js.rw2),
                               rtol=1e-12)
    for k in ("rd3", "kpa"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-14,
                                   err_msg=k)
    assert float(got.n.sum()) < float(ps.n.sum())     # collisions happened
    assert got.rng_step == 1 and got.rng_seed == ps.rng_seed


def test_coal_substep_conserves_water_and_dry_mass(flat):
    _, _, pcfg, ps = flat
    mass = lambda s: (float((s.n * s.rw2 ** 1.5).sum()),
                      float((s.n * s.rd3).sum()))
    bits = philox.draw_substeps(7, 0, 4, philox.SHUFFLE, ps.n_sd_max)
    u01 = philox.u01(philox.draw_substeps(7, 0, 4, philox.BERNOULLI,
                                          ps.n_sd_max), torch.float64)
    s, n0 = ps, float(ps.n.sum())
    for i in range(4):
        w0, d0 = mass(s)
        s = tcoal.coal_substep(pcfg, s, [1e4], 1.0, bits[i], u01[i])
        w1, d1 = mass(s)
        assert abs(w1 - w0) / w0 < 1e-12 and abs(d1 - d0) / d0 < 1e-12
    assert float(s.n.sum()) < n0


def test_flat_golovin_box_gate():
    """The Golovin box of tests/test_pallas_coal_golovin.py on the flat
    engine: 128 cells of 256 SDs, 100 substeps over 800 s, b = 1500, at
    float64 with the port's draws."""
    n, rw2, rd3 = _golovin_population()
    oi = lgrngn.opts_init_t()
    oi.nx, oi.nz, oi.dt, oi.n_sd_max = N_BOX, 1, 1.0, n.size
    oi.kernel = lgrngn.kernel_t.golovin
    oi.terminal_velocity = lgrngn.vt_t.beard77
    pcfg = port_cfg(lgrngn.StaticConfig.from_opts_init(oi))
    assert pcfg.n_cell == N_BOX and pcfg.kernel == kernel_t.golovin.value
    flat_ = lambda a: t(np.asarray(a).reshape(-1))
    ones = torch.ones(N_BOX, dtype=torch.float64)
    zsd = torch.zeros(n.size, dtype=torch.float64)
    st = State(n=flat_(n), rd3=flat_(rd3), rw2=flat_(rw2),
               kpa=flat_(np.where(n > 0, 1e-10, 0.0)), x=zsd, z=zsd, vt=zsd,
               ijk=torch.arange(N_BOX).repeat_interleave(CAP),
               th=ones * 300.0, rv=ones * 0.01, rhod=ones, p=ones * 1e5,
               courant_x=zsd[:0], courant_z=zsd[:0], T=ones * 300.0,
               RH=ones, eta=ones * 1.8e-5, dv=ones, sstp_tmp_th=ones,
               sstp_tmp_rv=ones, sstp_tmp_rh=ones,
               puddle=torch.zeros(16, dtype=torch.float64), rng_seed=1234)
    out = tcoal.coal(pcfg, st, [B_GOLOVIN], SIM_TIME, 100)
    n1 = out.n.numpy().reshape(N_BOX, CAP)
    rw2_1 = out.rw2.numpy().reshape(N_BOX, CAP)
    m3_0, m3_1 = (n * rw2 ** 1.5).sum(), (n1 * rw2_1 ** 1.5).sum()
    assert abs(m3_1 - m3_0) / m3_0 < 1e-12
    assert n1.sum() < 0.6 * n.sum()
    err = _spectrum_err(n, rw2, n1, rw2_1)
    assert err < 3.5e-5, err


def test_vterm_all_matches_jax(flat):
    cfg, st, pcfg, ps = flat
    got = tvterm.hskpng_vterm_all(pcfg, thskpng.hskpng_Tpr_state(pcfg, ps))
    np.testing.assert_allclose(got.vt.numpy(), np.asarray(st.vt),
                               rtol=1e-13)
    assert float(got.vt.max()) > 0


def test_kernel_data_copies_equal_jax_files():
    """The port's efficiency tables are byte for byte the JAX package's."""
    mine = REPO / "libcloudphxx_tpu_torch" / "lgrngn" / "kernel_data"
    ref = REPO / "libcloudphxx_tpu" / "lgrngn" / "kernel_data"
    names = sorted(p.name for p in ref.glob("*.npz"))
    assert names == sorted(p.name for p in mine.glob("*.npz"))
    assert len(names) == 6
    for name in names:
        assert filecmp.cmp(mine / name, ref / name, shallow=False), name
    assert tcoal.KERNEL_DATA == mine


def test_port_reads_nothing_of_the_jax_package():
    """A flat run with the hall kernel (its table read from disk) imports
    neither jax nor the JAX package and opens no file under it."""
    code = f"""
import sys
ref = {str(REPO / "libcloudphxx_tpu")!r} + "/"
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
import torch
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch.lgrngn import kernel_t
m = Kinematic2D(nx=4, nz=4, sd_conc=4, sstp_coal=2, device="cpu",
                opts_init_kw={{"kernel": kernel_t.hall}})
m.run(2)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "libcloudphxx_tpu")]
read = [p for p in opened if p.startswith(ref)]
assert not bad and not read, (bad, read)
assert any(p.endswith("kernel_data/hall.npz") for p in opened)
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)
