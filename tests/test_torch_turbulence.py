"""Port parity: the SGS turbulence (libcloudphxx_tpu_torch.common.
turbulence, lgrngn.turbulence), the turbulent collision kernels
(lgrngn.coalescence wang_enhancement, onishi_nograv, kernel_value under
onishi_hall and onishi_hall_davis_no_waals) and the Philox normals
(ops/philox.normal) against the JAX package at float64 on the CPU.

Tolerances:

* the GA17 formulas, update_turb_vel fed the port's normals and TKE, and
  turb_adve: rtol 1e-15 with an atol of 1e-14 of the largest value (the
  same operations, an ulp apart where XLA's simplifier turns a division by
  a constant into a product, which update_turb_vel's 1 - e^2 amplifies);
* tke's cube root (torch.pow against jnp.cbrt), the hskpng_tke field and
  the cell sums of hskpng_turb_dot_ss (index_add_ against segment_sum, in
  other orders): rtol 1e-14;
* wang_enhancement, onishi_nograv and kernel_value over radii of 1-300 um
  and dissipation rates of 1e-6 to 0.1 m2/s3 (across the Wang table's
  eps > 2.5e-2 switch): rtol 1e-12 (log10, tanh and pow in two
  libraries), onishi_nograv alone 5e-12 (its Ayala bracket cancels);
* a coalescence substep of the flat engine under the onishi kernels, the
  JAX substep fed the port's shuffle and Bernoulli draws: multiplicities
  exact, rw2, rd3, kappa and the in-cloud time rtol 1e-12;
* the Philox normals: mean within 5 sigma of 0, variance within 5 sigma
  of 1, the correlation of two axes' draws within 5 sigma of 0, and the
  same bits from the same (seed, step, axis).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_flat_state, t

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.common import turbulence as jga17
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import turbulence as jturb
from libcloudphxx_tpu.lgrngn.state import StaticConfig as JaxStaticConfig
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch.common import turbulence as ga17
from libcloudphxx_tpu_torch.lgrngn import coalescence as tcoal
from libcloudphxx_tpu_torch.lgrngn import turbulence as tturb
from libcloudphxx_tpu_torch.lgrngn.enums import kernel_t
from libcloudphxx_tpu_torch.ops import philox

ONISHI = ("onishi_hall", "onishi_hall_davis_no_waals")


def _eq(got, want):
    """Equal to an ulp or two of the values' scale (sums like update_turb_
    vel's cancel)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15,
                               atol=1e-14 * np.abs(want).max())


def test_ga17_formulas_match_jax():
    rng = np.random.default_rng(0)
    diss = 10.0 ** rng.uniform(-6, -1, 500)
    L = rng.uniform(5.0, 100.0, 500)
    tke_t = ga17.tke(t(diss), t(L))
    np.testing.assert_allclose(tke_t.numpy(), np.asarray(
        jga17.tke(jnp.asarray(diss), jnp.asarray(L))), rtol=1e-14)
    tke = tke_t.numpy()
    _eq(ga17.tau(t(tke), t(L)), jga17.tau(jnp.asarray(tke), jnp.asarray(L)))
    wp = rng.normal(0.0, 0.3, 500)
    r = philox.normal(7, 3, 1, 500, torch.float64)
    tau = ga17.tau(t(tke), t(L))
    _eq(ga17.update_turb_vel(t(wp), tau, 1.0, t(tke), r),
        jga17.update_turb_vel(jnp.asarray(wp), jnp.asarray(tau.numpy()), 1.0,
                              jnp.asarray(tke), jnp.asarray(r.numpy())))
    mom = 10.0 ** rng.uniform(-4, 0, 500)
    _eq(ga17.tau_relax(t(mom)), jga17.tau_relax(jnp.asarray(mom)))
    ssp = rng.normal(0.0, 1e-3, 500)
    tr = ga17.tau_relax(t(mom))
    _eq(ga17.dot_turb_ss(t(ssp), t(wp), tr),
        jga17.dot_turb_ss(jnp.asarray(ssp), jnp.asarray(wp),
                          jnp.asarray(tr.numpy())))
    for name in ("length_vertical", "length_geometric_mean",
                 "length_arithmetic_mean"):
        assert getattr(ga17, name)(20.0, 30.0) \
            == getattr(jga17, name)(20.0, 30.0)


def _pairs(seed=1, n=4000):
    """Radii of 1-300 um (log-uniform), dissipation rates of 1e-6 to 0.1,
    cell densities and viscosities around the GMD case's."""
    rng = np.random.default_rng(seed)
    r1 = 10.0 ** rng.uniform(-6, np.log10(300e-6), n)
    r2 = 10.0 ** rng.uniform(-6, np.log10(300e-6), n)
    eps = 10.0 ** rng.uniform(-6, -1, n)
    rhod = rng.uniform(0.9, 1.2, n)
    eta = rng.uniform(1.7e-5, 1.85e-5, n)
    return r1, r2, eps, rhod, eta


@pytest.mark.parametrize("eps_wang", [1e-3, 0.04, 100.0])
def test_wang_enhancement_matches_jax(eps_wang):
    r1, r2, _, _, _ = _pairs()
    r1[:7] = [5e-6, 10e-6, 20e-6, 60e-6, 100e-6, 100.5e-6, 300e-6]
    got = tcoal.wang_enhancement(t(r1), t(r2), eps_wang)
    want = jcoal.wang_enhancement(jnp.asarray(r1), jnp.asarray(r2),
                                  jnp.asarray(eps_wang))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    assert (got.numpy() >= 1.0).all()


def test_onishi_nograv_matches_jax():
    r1, r2, eps, rhod, eta = _pairs()
    eps[:3] = [0.0, 1e-11, 2.5e-2]
    args = (r1, r2)
    got = tcoal.onishi_nograv(*map(t, args), 100.0, t(eps), t(eta / rhod),
                              t(1e3 / rhod))
    want = jcoal.onishi_nograv(*map(jnp.asarray, args), jnp.asarray(100.0),
                               jnp.asarray(eps), jnp.asarray(eta / rhod),
                               jnp.asarray(1e3 / rhod))
    # the Ayala bracket of WrA2 cancels: the libraries' last-ulp
    # differences of exp, log10 and tanh reach 2e-12 in 7 of 4000 pairs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-12)
    assert np.isfinite(got.numpy()).all() and (got.numpy()[:2] == 0).all()


@pytest.mark.parametrize("kern", ONISHI)
@pytest.mark.parametrize("turb", [True, False])
def test_onishi_kernel_value_matches_jax(kern, turb):
    """kernel_value with the pairs' rhod, eta and dissipation rate (0 where
    turb_coal is off, coal.ipp:439-450)."""
    r1, r2, eps, rhod, eta = _pairs(seed=2)
    rng = np.random.default_rng(3)
    n_a, n_b = np.floor(10.0 ** rng.uniform(3, 9, (2, r1.size)))
    vt_a, vt_b = rng.uniform(0.0, 2.0, (2, r1.size))
    rd3 = (0.1 * r1) ** 3
    oi = jl.opts_init_t()
    oi.kernel = getattr(jl.kernel_t, kern)
    oi.kernel_parameters = [100.0]
    jcfg = JaxStaticConfig.from_opts_init(oi)
    table, r_max = jcoal.load_efficiency_table(oi.kernel)
    diss = eps if turb else 0.0
    want = jcoal.kernel_value(
        jcfg, jnp.asarray([100.0]), *map(jnp.asarray, (
            n_a, n_b, r1 ** 2, r2 ** 2, vt_a, vt_b, rd3, rd3)),
        eff_table=table, r_max_um=r_max, rhod=jnp.asarray(rhod),
        eta=jnp.asarray(eta), diss_rate=jnp.asarray(diss))
    eff = tcoal.efficiency(kernel_t[kern], torch.float64, "cpu")
    got = tcoal.kernel_value(
        port_cfg(jcfg), [100.0], *map(t, (n_a, n_b, r1 ** 2, r2 ** 2, vt_a,
                                          vt_b, rd3, rd3)),
        eff, (t(rhod), t(eta), t(np.broadcast_to(diss, r1.shape))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    with pytest.raises(ValueError, match="turb"):
        tcoal.kernel_value(port_cfg(jcfg), [100.0], *map(t, (
            n_a, n_b, r1 ** 2, r2 ** 2, vt_a, vt_b, rd3, rd3)), eff)


def test_philox_normals_statistics():
    n = 200_000
    a = philox.normal(44, 5, 0, n, torch.float64).numpy()
    b = philox.normal(44, 5, 1, n, torch.float64).numpy()
    sig = 5.0 / np.sqrt(n)
    assert abs(a.mean()) < sig and abs(b.mean()) < sig
    # var of a sample variance of normals: 2 / n
    assert abs(a.var() - 1.0) < 5.0 * np.sqrt(2.0 / n)
    assert abs(np.corrcoef(a, b)[0, 1]) < sig
    # the next step's draws are others, the same arguments the same bits
    c = philox.normal(44, 6, 0, n, torch.float64).numpy()
    assert abs(np.corrcoef(a, c)[0, 1]) < sig
    np.testing.assert_array_equal(
        a[:1000], philox.normal(44, 5, 0, 1000, torch.float64).numpy())
    assert np.isfinite(a).all()
    f32 = philox.normal(44, 5, 0, 1000, torch.float32)
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), a[:1000].astype(np.float32))


@pytest.fixture(scope="module")
def les_state():
    """The JAX Kinematic2D's population at 8x8, with a dissipation rate,
    velocity perturbations and supersaturation perturbations from a seed,
    and the port's State of the same numbers."""
    m = JaxKinematic2D(nx=8, nz=8, sd_conc=8, opts_init_kw=dict(
        turb_adve_switch=True, turb_cond_switch=True))
    rng = np.random.default_rng(11)
    st = m.prtcls.state
    n_sd, n_cell = st.n.shape[0], m.prtcls.cfg.n_cell
    js = dataclasses.replace(
        st, diss_rate=jnp.asarray(10.0 ** rng.uniform(-5, -2, n_cell)),
        up=jnp.asarray(rng.normal(0, 0.2, n_sd)),
        wp=jnp.asarray(rng.normal(0, 0.2, n_sd)),
        ssp=jnp.asarray(rng.normal(0, 1e-3, n_sd)))
    mix = np.full(8, m.prtcls.cfg.dz) * rng.uniform(0.5, 1.5, 8)
    return m.prtcls.cfg, js, port_cfg(m.prtcls.cfg), port_flat_state(js), mix


def test_hskpng_tke_and_turb_vel_match_jax(les_state):
    jcfg, js, pcfg, ps, mix = les_state
    want = jturb.hskpng_tke(jcfg, js, jnp.asarray(mix))
    got = tturb.hskpng_tke(pcfg, ps, t(mix))
    np.testing.assert_allclose(got.diss_rate.numpy(),
                               np.asarray(want.diss_rate), rtol=1e-14)
    # the OU update with the port's own normals, fed to JAX's pure formula
    got = dataclasses.replace(got, diss_rate=t(want.diss_rate))
    for only_vertical in (False, True):
        out = tturb.hskpng_turb_vel(pcfg, got, t(mix), 1.0,
                                    only_vertical=only_vertical)
        assert out.rng_step == got.rng_step + 1
        lam = jnp.asarray(mix)[jnp.arange(jcfg.n_cell) % jcfg.nz]
        tke = want.diss_rate
        tau = jga17.tau(jnp.maximum(tke, 1e-30), lam)
        for name in tturb.turb_vel_names(only_vertical):
            r = philox.normal(got.rng_seed, got.rng_step,
                              tturb.AXES[name], pcfg.n_sd_max,
                              torch.float64)
            ref = jga17.update_turb_vel(
                getattr(js, name), tau[js.ijk], 1.0, tke[js.ijk],
                jnp.asarray(r.numpy()))
            _eq(getattr(out, name), ref)
        if only_vertical:
            _eq(out.up, js.up)


def test_hskpng_turb_dot_ss_and_turb_adve_match_jax(les_state):
    jcfg, js, pcfg, ps, _ = les_state
    want = jturb.hskpng_turb_dot_ss(jcfg, js)
    got = tturb.hskpng_turb_dot_ss(pcfg, ps)
    np.testing.assert_allclose(got.dot_ssp.numpy(), np.asarray(want.dot_ssp),
                               rtol=1e-14)
    assert np.abs(got.dot_ssp.numpy()).max() > 0
    want = jturb.turb_adve(jcfg, js, 0.7)
    got = tturb.turb_adve(pcfg, ps, 0.7)
    _eq(got.x, want.x)
    _eq(got.z, want.z)
    _eq(tturb.apply_sgs_supersat(ps.ssp, got.dot_ssp, 0.1),
        jturb.apply_sgs_supersat(dataclasses.replace(
            js, dot_ssp=jnp.asarray(got.dot_ssp.numpy())), 0.1).ssp)


def _fed_uniform(draws):
    """A stand-in for jax.random.uniform that hands out ``draws`` in
    order."""
    queue = list(draws)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        a = queue.pop(0)
        assert a.shape == tuple(shape)
        return jnp.asarray(a)
    return uniform


@pytest.mark.parametrize("kern", ONISHI)
@pytest.mark.parametrize("turb_coal", [True, False])
def test_onishi_coal_substep_matches_jax(kern, turb_coal, monkeypatch):
    """One coalescence substep of the flat engine under an onishi kernel,
    with diag_incloud_time (the merged droplet keeps the longer in-cloud
    time): the JAX substep fed the port's shuffle and Bernoulli draws."""
    m = JaxKinematic2D(nx=4, nz=4, sd_conc=16, opts_init_kw=dict(
        kernel=getattr(jl.kernel_t, kern), kernel_parameters=[100.0],
        turb_coal_switch=True, diag_incloud_time=True))
    jcfg = m.prtcls.cfg
    rng = np.random.default_rng(4)
    st = m.prtcls.state
    n_sd = st.n.shape[0]
    # drizzle-sized droplets, so that pairs collide in one substep
    rw2 = np.asarray(st.rw2) * rng.uniform(1e2, 1e4, n_sd)
    js = dataclasses.replace(
        st, rw2=jnp.asarray(rw2),
        diss_rate=jnp.asarray(10.0 ** rng.uniform(-4, -1, jcfg.n_cell)),
        incloud_time=jnp.asarray(rng.uniform(0, 100, n_sd)))
    from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
    from libcloudphxx_tpu.lgrngn import vterm as jvterm
    js = jvterm.hskpng_vterm_all(jcfg, jhskpng.hskpng_Tpr(jcfg, js))
    ps = port_flat_state(js)
    bits = philox.draw_substeps(44, 0, 1, philox.SHUFFLE, n_sd)[0]
    u01 = philox.u01(philox.draw_substeps(44, 0, 1, philox.BERNOULLI,
                                          n_sd)[0], torch.float64)
    pcfg = port_cfg(jcfg)
    eff = tcoal.efficiency(pcfg.kernel, torch.float64, "cpu")
    got = tcoal.coal_substep(pcfg, ps, [100.0], 0.5, bits, u01, eff,
                             turb_coal)
    monkeypatch.setattr(jax.random, "uniform", _fed_uniform(
        [bits.numpy() * 2.0 ** -32, u01.numpy()]))
    table, r_max = jcoal.load_efficiency_table(jl.kernel_t(jcfg.kernel))
    want = jcoal.coal_substep(jcfg, js, jnp.asarray([100.0]), 0.5, js.key,
                              eff_table=table, r_max_um=r_max,
                              turb_coal=turb_coal)
    _eq(got.n, want.n)
    for k in ("rw2", "rd3", "kpa", "incloud_time"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-12,
                                   err_msg=k)
    assert (got.n.numpy() != np.asarray(js.n)).sum() > 4
