"""Port parity: the aqueous chemistry (lgrngn/chemistry.py, plain PyTorch
as the JAX package runs it in XLA) against the JAX package at float64 on
the CPU.

tests/test_lgrngn_chem.py's seven tests are mirrored: each runs its
physics gate on the port and holds the port against JAX on the same
inputs.  Tolerances:

* Henry's dissolution, the oxidation, the flag and init_chem_aq rtol
  1e-10 (the same float64 arithmetic; the flag exactly);
* the dissociation's root (the electroneutral H+, 44 iterations of the
  bracketed solve in both) rtol 1e-10;
* coalescence with the dissolved masses, the JAX package fed the port's
  Philox draws in place of its jax.random ones: the masses rtol 1e-12,
  each species' total conserved to 1e-12;
* the public API (a parcel, 5 steps with sstp_chem 2) and the
  lgrngn_chem kinematic model (tests/test_kinematic_2d.py's 10x10 case,
  4 steps, 2 of them spin-up): th, rv, the gases and the dissolved masses
  rtol 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.common import chem as jcc
from libcloudphxx_tpu.lgrngn import chemistry as jchem
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn.state import StaticConfig, empty_state
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.common import chem as tcc
from libcloudphxx_tpu_torch.common import constants as c
from libcloudphxx_tpu_torch.lgrngn import chemistry as tchem
from libcloudphxx_tpu_torch.lgrngn import coalescence as tcoal
from libcloudphxx_tpu_torch.ops import philox

H2O2, H, O3, S_VI, SO2 = (tchem.H2O2, tchem.H, tchem.O3, tchem.S_VI,
                          tchem.SO2)
F64 = dict(device="cpu", dtype=torch.float64)


def _cfg(**kw):
    """tests/test_lgrngn_chem.py's one-cell configuration (JAX)."""
    args = dict(
        n_dims=0, nx=1, ny=1, nz=1, n_cell=1, n_sd_max=8,
        dx=1.0, dy=1.0, dz=1.0, x0=0.0, x1=1.0, y0=0.0, y1=1.0,
        z0=0.0, z1=1.0, dt=0.1, sstp_cond=1, sstp_coal=1,
        th_dry=True, const_p=False, RH_formula=0, adve_scheme=0,
        terminal_velocity=0, kernel=0, exact_sstp_cond=False,
        variable_dt=False, sedi_switch=False, coal_switch=False,
        turb_cond_switch=False, open_side_walls=False,
        periodic_topbot_walls=False, chem_switch=True, sstp_chem=1,
        chem_rho=1.8e3)
    args.update(kw)
    return StaticConfig(**args)


def _state(cfg, rw_um=10.0, T=285.0, gas=1e-9, seed=None):
    """tests/test_lgrngn_chem.py's state (JAX): droplets of ``rw_um`` um
    at T in a cell of 1.1 kg/m3 with every gas at ``gas``; with ``seed``
    the radii spread over 1-20 um."""
    st = empty_state(cfg)
    n_sd = cfg.n_sd_max
    rw = np.full(n_sd, rw_um * 1e-6) if seed is None else \
        np.random.default_rng(seed).uniform(1e-6, 2e-5, n_sd)
    rd3 = jnp.full(n_sd, (0.05e-6) ** 3)
    return dataclasses.replace(
        st, n=jnp.ones(n_sd), rd3=rd3, rw2=jnp.asarray(rw ** 2),
        kpa=jnp.full(n_sd, 0.61),
        th=jnp.full(1, T * (1e5 / 93300.0) ** 0.2854), rv=jnp.full(1, 8e-3),
        rhod=jnp.full(1, 1.1), T=jnp.full(1, T), p=jnp.full(1, 93300.0),
        RH=jnp.full(1, 0.98), dv=jnp.ones(1),
        ambient_chem=jnp.full((6, 1), gas),
        sstp_tmp_chem=jnp.full((6, 1), gas),
        chem=jchem.init_chem_aq(rd3, 1.8e3))


def _both(**kw):
    cfg = _cfg()
    js = _state(cfg, **kw)
    return cfg, js, port_cfg(cfg), port_flat_state(js)


def _close(got, want, rtol=1e-10, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-300, **kw)


def test_init_chem_aq_and_constants():
    rd3 = np.random.default_rng(0).uniform(1e-24, 1e-20, 50)
    _close(tchem.init_chem_aq(torch.tensor(rd3), 1.8e3).numpy(),
           jchem.init_chem_aq(jnp.asarray(rd3), 1.8e3))
    T = np.linspace(260.0, 310.0, 11)
    for f, args in ((tcc.henry_temp, (tcc.H_SO2, tcc.dHR_SO2)),
                    (tcc.dissoc_temp, (tcc.K_HSO3, tcc.dKR_HSO3)),
                    (tcc.react_temp, (tcc.R_S_O3_k1, tcc.dER_O3_k1))):
        jf = getattr(jcc, f.__name__)
        _close(f(torch.tensor(T), *args).numpy(), jf(jnp.asarray(T), *args),
               rtol=1e-14)


def test_henry_equilibrium_O3():
    """Aqueous O3 approaches Henry's-law equilibrium, conc = H(T) p_O3
    (Warneck eq. 8.22; chem_henry.ipp:192-213) on the port; each implicit
    step against JAX's."""
    cfg, js, pcfg, ps = _both(gas=50e-9)
    flag = torch.ones(8, dtype=torch.bool)
    for _ in range(5):
        want = jchem.chem_henry(cfg, js, 1.0, jnp.ones(8, bool))
        got = tchem.chem_henry(pcfg, ps, 1.0, flag)
        _close(got.chem.numpy(), want.chem)
        _close(got.ambient_chem.numpy(), want.ambient_chem)
        js = dataclasses.replace(want, ambient_chem=js.ambient_chem)
        ps = dataclasses.replace(got, ambient_chem=ps.ambient_chem)
    for _ in range(200):
        ps = dataclasses.replace(tchem.chem_henry(pcfg, ps, 1.0, flag),
                                 ambient_chem=ps.ambient_chem)
    T = float(ps.T[0])
    V = float(tchem._V_of(ps.rw2)[0])
    p_O3 = 50e-9 * 1.1 * c.kaBoNA * T / tcc.M_O3
    expected = tcc.henry_temp(torch.tensor(T), tcc.H_O3, tcc.dHR_O3) * p_O3
    assert float(ps.chem[O3][0]) / tcc.M_O3 / V == pytest.approx(
        float(expected), rel=1e-6)


@pytest.mark.parametrize("water", ["pure", "acidic"])
def test_dissociation_root(water):
    """The electroneutral H+: pure water's pH 7, H2SO4 well below 6; the
    root against JAX's."""
    cfg, js, pcfg, ps = _both()
    if water == "pure":
        js = dataclasses.replace(js, chem=jnp.zeros_like(js.chem))
        ps = dataclasses.replace(ps, chem=torch.zeros_like(ps.chem))
    want = jchem.chem_dissoc(cfg, js, jnp.ones(8, bool))
    got = tchem.chem_dissoc(pcfg, ps, torch.ones(8, dtype=torch.bool))
    _close(got.chem.numpy(), want.chem)
    V = float(tchem._V_of(ps.rw2)[0])
    pH = -np.log10(float(got.chem[H][0]) / tcc.M_H / V / 1e3)
    if water == "pure":
        assert pH == pytest.approx(7.0, abs=0.01)
    else:
        assert pH < 6.0


def test_react_stoichiometry_and_rd3_growth():
    """S(IV) -> S(VI): moles made equal moles taken, the oxidants deplete,
    rd3 grows by 3/(4 pi chem_rho) of the sulfate made; against JAX."""
    cfg, js, pcfg, ps = _both(rw_um=20.0)
    V = np.asarray(jchem._V_of(js.rw2))
    chem = np.asarray(js.chem).copy()
    chem[SO2], chem[H2O2], chem[O3] = 1e-15, 1e-15, 1e-16
    chem[H] = 1e-5 * 1e3 * V * tcc.M_H
    js = dataclasses.replace(js, chem=jnp.asarray(chem))
    ps = dataclasses.replace(ps, chem=torch.tensor(chem))
    want = jchem.chem_react(cfg, js, 1.0, jnp.ones(8, bool))
    got = tchem.chem_react(pcfg, ps, 1.0, torch.ones(8, dtype=torch.bool))
    _close(got.chem.numpy(), want.chem)
    _close(got.rd3.numpy(), want.rd3)
    dS6 = (got.chem[S_VI] - ps.chem[S_VI]).numpy() / tcc.M_H2SO4
    dSIV = (ps.chem[SO2] - got.chem[SO2]).numpy() / tcc.M_SO2_H2O
    assert dS6[0] > 0
    np.testing.assert_allclose(dS6, dSIV, rtol=1e-10)
    np.testing.assert_allclose(
        (got.rd3 - ps.rd3).numpy(),
        0.75 / np.pi / 1.8e3 * dS6 * tcc.M_H2SO4, rtol=1e-10)


def test_chem_flag_matches_jax():
    """The ionic-strength gate: a droplet at 1 mol/l of H+ is skipped, a
    dilute one passes; at concentrations spread over 1e-8-1 mol/l the
    port's flag is JAX's."""
    cfg, js, pcfg, ps = _both(rw_um=1.0)
    V = np.asarray(jchem._V_of(js.rw2))
    conc = np.logspace(-8, 0, 8)
    chem = np.asarray(js.chem).copy()
    chem[H] = conc * 1e3 * V * tcc.M_H
    want = jchem.chem_flag(jnp.asarray(chem), jnp.asarray(V), js.T[js.ijk],
                           js.rw2)
    got = tchem.chem_flag(torch.tensor(chem), torch.tensor(V),
                          ps.T[ps.ijk], ps.rw2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got[0]) and not bool(got[-1])


def test_chem_coal_conserves_and_matches_jax(monkeypatch):
    """Coalescence adds the dissolved masses up (coal.ipp:459-468): each
    species' total sum n m is conserved, and the port's rows equal JAX's
    on the port's draws."""
    cfg = _cfg(n_sd_max=64, coal_switch=True, kernel=2)   # golovin
    js = _state(cfg, seed=7)
    rows = np.broadcast_to(np.linspace(1e-18, 5e-18, 64), (8, 64)) \
        * np.arange(1, 9)[:, None]
    # 1e-8 m3 of air, where pairs collide with probabilities near 1
    js = dataclasses.replace(js, n=jnp.full(64, 1e6), vt=jnp.zeros(64),
                             chem=jnp.asarray(rows), dv=jnp.full(1, 1e-8))
    ps = port_flat_state(js)
    got = tcoal.coal(port_cfg(cfg), ps, [1500.0], 10.0, 1)
    sh = philox.draw_substeps(ps.rng_seed, ps.rng_step, 1, philox.SHUFFLE,
                              64)[0]
    be = philox.draw_substeps(ps.rng_seed, ps.rng_step, 1,
                              philox.BERNOULLI, 64)[0]
    queue = [sh.numpy() * 2.0 ** -32, philox.u01(be, torch.float64).numpy()]

    def fed(key, shape=(), dtype=None, *args, **kwargs):
        return jnp.asarray(queue.pop(0))

    monkeypatch.setattr(jax.random, "uniform", fed)
    with jax.disable_jit():
        want = jcoal.coal(cfg, js, jnp.asarray([1500.0]), 10.0, 1)
    monkeypatch.undo()
    assert not queue
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    assert (got.n.numpy() < 1e6).any()                   # SDs collided
    _close(got.chem.numpy(), want.chem, rtol=1e-12)
    total = lambda st: (st.n * st.chem).sum(1)
    np.testing.assert_allclose(total(got).numpy(), total(ps).numpy(),
                               rtol=1e-12)


def _lognormal(lnr):
    from libcloudphxx_tpu_torch.common import lognormal as ln_mod
    return float(ln_mod.n_e(0.04e-6, 1.4, 60e6, torch.tensor(lnr)))


def test_particles_api_chem_end_to_end():
    """tests/test_lgrngn_chem.py's end-to-end parcel on both packages: the
    gases dissolve (SO2 falls, stays >= 0), diag_chem shows S(VI), S(IV)
    and H+, and the port's th, rv, gases and dissolved masses equal JAX's;
    the reference's gating errors."""
    def make(L):
        oi = L.opts_init_t()
        oi.dt, oi.sd_conc, oi.n_sd_max = 1.0, 64, 64
        oi.dry_distros = {(0.61, 0.0): _lognormal}
        oi.chem_switch, oi.chem_rho, oi.sstp_chem = True, 1.8e3, 2
        prt = L.factory(L.backend_t.serial, oi, **(F64 if L is tl else {}))
        return prt, oi

    cs = tcc.chem_species_t
    gases = {cs.SO2: 2e-10, cs.O3: 5e-8, cs.H2O2: 5e-10,
             cs.CO2: 360e-6 * 44.0 / 29.0, cs.NH3: 1e-10, cs.HNO3: 1e-11}
    runs = {}
    for L in (jl, tl):
        prt, _ = make(L)
        th, rv, rhod = np.array([300.0]), np.array([0.02]), np.array([1.0])
        amb = {k: np.array([v]) for k, v in gases.items()}
        prt.init(th, rv, rhod, ambient_chem=amb)
        opts = L.opts_t()
        opts.cond = True
        opts.coal = opts.adve = opts.sedi = False
        opts.chem_dsl = opts.chem_dsc = opts.chem_rct = True
        for _ in range(5):
            prt.step_sync(opts, th, rv, ambient_chem=amb)
            prt.step_async(opts)
        runs[L] = (prt, th, rv, amb)
    tp, tth, trv, tamb = runs[tl]
    jp, jth, jrv, jamb = runs[jl]
    assert tamb[cs.SO2][0] < gases[cs.SO2] and tamb[cs.SO2][0] >= 0
    _close(tth, jth)
    _close(trv, jrv)
    for k in gases:
        _close(tamb[k], jamb[k], err_msg=str(k))
    _close(tp.state.chem.numpy(), jp.state.chem)
    for sp in (cs.S_VI, cs.SO2, cs.H):
        for prt in (tp, jp):
            prt.diag_all()
            prt.diag_chem(sp)
        assert tp.outbuf()[0] > 0
        _close(tp.outbuf(), jp.outbuf(), err_msg=str(sp))
    # the gating (particles_step.ipp:68-72)
    oi2 = tl.opts_init_t()
    oi2.dt, oi2.sd_conc, oi2.n_sd_max = 1.0, 8, 8
    oi2.dry_distros = {(0.61, 0.0): _lognormal}
    p2 = tl.factory(tl.backend_t.serial, oi2, **F64)
    with pytest.raises(RuntimeError, match="switched off and ambient_chem"):
        p2.init(np.array([300.0]), np.array([0.02]), np.array([1.0]),
                ambient_chem={k: np.array([v]) for k, v in gases.items()})
    p3, _ = make(tl)
    with pytest.raises(RuntimeError, match="ambient_chem is empty"):
        p3.init(np.array([300.0]), np.array([0.02]), np.array([1.0]))


def test_lgrngn_chem_model_matches_jax():
    """tests/test_kinematic_2d.py's lgrngn_chem model (10x10, node grid,
    FCT, sd_conc 16) for 4 steps, 2 of them spin-up, on both packages:
    the gases dissolve where the cells are supersaturated and S(VI)
    appears; the port's fields and population equal JAX's."""
    kw = dict(nx=10, nz=10, micro="lgrngn_chem", sd_conc=16,
              n_sd_max=10 * 10 * 16, grid="node", fct=True)
    j = JaxKinematic2D(**kw)
    t = Kinematic2D(**kw, **F64)
    cs = tcc.chem_species_t
    so2_0 = t.chem_gases[cs.SO2].numpy().copy()
    assert so2_0.min() > 0
    np.testing.assert_allclose(so2_0, j.chem_gases[cs.SO2], rtol=1e-14)
    j.run(4, spinup=2)
    t.run(4, spinup=2)
    _close(t.th.numpy(), j.th)
    _close(t.rv.numpy(), j.rv)
    for sp in j.chem_gases:
        _close(t.chem_gases[sp].numpy(), j.chem_gases[sp], err_msg=str(sp))
    assert t.chem_gases[cs.SO2].min() < so2_0.max()
    _close(t.prtcls.state.chem.numpy(), j.prtcls.state.chem)
    p = t.prtcls
    p.diag_all()
    p.diag_chem(cs.S_VI)
    assert np.isfinite(p.outbuf()).all() and p.outbuf().max() > 0
