"""Port parity: recycling, the aerosol sources and the CCN relaxation
(libcloudphxx_tpu_torch.lgrngn recycle.rcyc, source.src_simple_distros,
src_matching_distros, src_dry_sizes, relax.rlx_dry_distros, and the
public API's opts.rcyc, opts.src and opts.rlx with their super-step
counters) against the JAX package at float64 on the CPU.

The state is the JAX Kinematic2D's population at 4x4 cells (its dead
slots after the live ones), handed to the port through
convert.state_from_numpy; both sides draw from numpy generators of one
seed, in one order.  Tolerances: slot for slot, every attribute exact
but the new SDs' equilibrium wet radius (kappa_koehler.rw3_eq in two
libraries: rtol 1e-12); the public API mirrors tests/test_lgrngn_transport
.py's source and relaxation tests, with the JAX package's gates, and
equals the JAX package's run slot for slot.
"""

import dataclasses
from math import exp, log, pi, sqrt

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import hskpng as jhskpng
from libcloudphxx_tpu.lgrngn import recycle as jrecycle
from libcloudphxx_tpu.lgrngn import relax as jrelax
from libcloudphxx_tpu.lgrngn import source as jsource
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import recycle as trecycle
from libcloudphxx_tpu_torch.lgrngn import relax as trelax
from libcloudphxx_tpu_torch.lgrngn import source as tsource

F64 = dict(device="cpu", dtype=torch.float64)
SD_ATTRS = ("n", "rd3", "rw2", "kpa", "x", "z", "vt", "ijk", "incloud_time",
            "up", "vp", "wp", "ssp", "dot_ssp")


def lognormal(lnr, n_tot=60e6, mean_r=0.02e-6):
    return n_tot * exp(-(lnr - log(mean_r)) ** 2 / 2 / log(1.4) ** 2) \
        / log(1.4) / sqrt(2 * pi)


def src_lognormal(lnr):
    return lognormal(lnr, 60e4, 0.05e-6)


def _case(**oi_kw):
    """(JAX cfg, opts_init and State, the port's) at 4x4 cells, sd_conc 8,
    with 300 dead slots, SGS attributes and in-cloud times from a seed."""
    kw = dict(nx=4, nz=4, sd_conc=8, n_sd_max=4 * 4 * 8 + 300)
    m = JaxKinematic2D(micro="lgrngn", opts_init_kw=dict(
        turb_adve_switch=True, turb_cond_switch=True, diag_incloud_time=True,
        **oi_kw), **kw)
    cfg, st = m.prtcls.cfg, m.prtcls.state
    rng = np.random.default_rng(9)
    n_sd = st.n.shape[0]
    js = dataclasses.replace(st, **{k: jnp.asarray(rng.normal(0, 1, n_sd))
                                    for k in ("up", "wp", "ssp", "dot_ssp")},
                             incloud_time=jnp.asarray(rng.uniform(0, 9, n_sd)))
    js = jhskpng.hskpng_Tpr(cfg, js)
    toi = tl.opts_init_t()
    for k, v in m.prtcls.opts_init.__dict__.items():
        setattr(toi, k, getattr(tl, type(v).__name__)[v.name]
                if hasattr(v, "name") and hasattr(tl, type(v).__name__)
                else v)
    return cfg, m.prtcls.opts_init, js, port_cfg(cfg), toi, \
        port_flat_state(js)


def _same(got, want, rw2_rtol=1e-12):
    for k in SD_ATTRS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if k == "rw2":
            np.testing.assert_allclose(g, w, rtol=rw2_rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_rcyc_matches_jax():
    """Recycling after collisions left dead slots among the live ones: the
    k-th dead slot takes half of the k-th largest SD, every attribute."""
    cfg, _, js, pcfg, _, ps = _case()
    rng = np.random.default_rng(2)
    n = np.asarray(js.n).copy()
    n[rng.permutation(np.nonzero(n > 0)[0])[:40]] = 0.0
    n[5] = 1.0                        # a donor that cannot split
    js = dataclasses.replace(js, n=jnp.asarray(n))
    ps = dataclasses.replace(ps, n=torch.tensor(n))
    want = jrecycle.rcyc(cfg, js)
    got = trecycle.rcyc(pcfg, ps)
    _same(got, want, rw2_rtol=0.0)
    assert (got.n.numpy() > 0).sum() > (n > 0).sum()
    # multiplicity and water conserved
    assert got.n.sum() == ps.n.sum()
    np.testing.assert_allclose(float((got.n * got.rw2 ** 1.5).sum()),
                               float((ps.n * ps.rw2 ** 1.5).sum()),
                               rtol=1e-14)


def _engines(cfg, js, pcfg, ps):
    return jsource.StateEngine(cfg, js), tsource.StateEngine(pcfg, ps)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kind", ["simple", "matching"])
def test_src_distros_match_jax(kind, exact):
    """The simple and the matching source in a box of the lower two levels
    (in exact mode the new SDs take their cell's state as their private
    copy): the new SDs land in the same dead slots, draw for draw."""
    cfg, joi, js, pcfg, toi, ps = _case(exact_sstp_cond=exact)
    for o in (joi, toi):
        o.src_x0, o.src_x1, o.src_z0, o.src_z1 = 0.0, 4 * cfg.dx, 0.0, \
            2 * cfg.dz
    je, pe = _engines(cfg, js, pcfg, ps)
    src = {(0.61, 0.0): (src_lognormal, 6, 1)}
    fn = {"simple": "src_simple_distros",
          "matching": "src_matching_distros"}[kind]
    if kind == "matching":
        # bins that hold none of the population's SDs get new ones
        src = {(1.28, 0.0): (src_lognormal, 6, 1)}
    n_j = getattr(jsource, fn)(cfg, joi, je, src, 1.0,
                               np.random.default_rng(3), 0.95)
    n_p = getattr(tsource, fn)(pcfg, toi, pe, src, 1.0,
                               np.random.default_rng(3), 0.95)
    assert n_j == n_p > 0
    _same(pe.state, je.state)
    if exact:
        for k in ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh", "sstp_tmp_p"):
            np.testing.assert_array_equal(getattr(pe.state, k).numpy(),
                                          np.asarray(getattr(je.state, k)))


def test_src_matching_boosts_existing_sds():
    """The matching source with the population's own kappa: the SD of each
    bin closest in radius takes the bin's particles."""
    cfg, joi, js, pcfg, toi, ps = _case()
    for o in (joi, toi):
        o.src_x1, o.src_z1 = 4 * cfg.dx, cfg.dz
    je, pe = _engines(cfg, js, pcfg, ps)
    kappa = next(iter(joi.dry_distros))[0]
    src = {(kappa, 0.0): (joi.dry_distros[(kappa, 0.0)], 8, 1)}
    jsource.src_matching_distros(cfg, joi, je, src, 1.0,
                                 np.random.default_rng(4), 0.95)
    tsource.src_matching_distros(pcfg, toi, pe, src, 1.0,
                                 np.random.default_rng(4), 0.95)
    _same(pe.state, je.state)
    assert (pe.state.n > ps.n).any()


def test_src_dry_sizes_matches_jax():
    cfg, joi, js, pcfg, toi, ps = _case()
    for o in (joi, toi):
        o.src_x1, o.src_z1 = 2 * cfg.dx, 4 * cfg.dz
    je, pe = _engines(cfg, js, pcfg, ps)
    sizes = {(0.61, 0.0): {0.05e-6: (1e6, 2, 1), 0.2e-6: (1e3, 1, 1)}}
    n_j = jsource.src_dry_sizes(cfg, joi, je, sizes, 2.0,
                                np.random.default_rng(5), 0.95)
    n_p = tsource.src_dry_sizes(pcfg, toi, pe, sizes, 2.0,
                                np.random.default_rng(5), 0.95)
    assert n_j == n_p == 8 * 3
    _same(pe.state, je.state)


def test_rlx_dry_distros_matches_jax():
    """Relaxation towards twice the population's distribution in the lower
    half: per (bin, level) deficit SDs, draw for draw."""
    cfg, joi, js, pcfg, toi, ps = _case()
    kappa = next(iter(joi.dry_distros))[0]
    fun = joi.dry_distros[(kappa, 0.0)]
    for o in (joi, toi):
        o.rlx_bins, o.rlx_sd_per_bin, o.rlx_timescale = 16, 1, 5.0
        o.rlx_dry_distros = {kappa: (lambda lnr: 2.0 * fun(lnr),
                                     (0.0, 2.0), (0.0, 2 * cfg.dz))}
    je, pe = _engines(cfg, js, pcfg, ps)
    np.testing.assert_array_equal(pe.rlx_counts((0.0, 2.0), np.exp(
        3.0 * np.linspace(-20, -12, 9))), je.rlx_counts((0.0, 2.0), np.exp(
            3.0 * np.linspace(-20, -12, 9))))
    n_j = jrelax.rlx_dry_distros(cfg, joi, je, 1.0, np.random.default_rng(6))
    n_p = trelax.rlx_dry_distros(pcfg, toi, pe, 1.0,
                                 np.random.default_rng(6))
    assert n_j == n_p > 0
    _same(pe.state, je.state)


def test_injection_refuses_a_full_state():
    _, _, _, pcfg, toi, ps = _case()
    st = dataclasses.replace(ps, n=torch.ones_like(ps.n))
    with pytest.raises(RuntimeError, match="n_sd_max too small"):
        tsource._inject(st, dict(n=np.ones(3)), pcfg)


# ------------------------------------------------------ the public API
def _transport_setup(pkg, src_type, **kw):
    """tests/test_lgrngn_transport.py's 2x2 case (reference unit tests
    source.py and relax.py)."""
    oi = pkg.opts_init_t()
    oi.dt = 1
    oi.nx = oi.nz = 2
    oi.dx = oi.dz = 1.0
    oi.x1 = oi.z1 = 2.0
    oi.coal_switch = oi.sedi_switch = False
    if src_type is None:
        oi.aerosol_independent_of_rhod = True
        oi.dry_distros = {(0.61, 0.0): lognormal}
        oi.sd_conc = 128
        oi.n_sd_max = 4096
        oi.rlx_switch = True
        oi.supstp_rlx = 2
        oi.rlx_bins = 64
        oi.rlx_sd_per_bin = 1
        oi.rlx_timescale = 1.0
        oi.rlx_dry_distros = {0.61: (lambda lnr: 2 * lognormal(lnr),
                                     (0.0, 2.0), (0.0, 1.0))}
    else:
        oi.src_z0, oi.src_z1 = 0.0, 1.0
        oi.src_x0, oi.src_x1 = 0.0, 2.0
        oi.dry_distros = {(0.61, 0.5e-6): lognormal}
        oi.sd_conc = 256
        oi.n_sd_max = (256 * 2 + 128 * 2) * 2
        oi.src_type = getattr(pkg.src_t, src_type)
    opts = pkg.opts_t()
    opts.adve = opts.sedi = opts.coal = opts.cond = opts.chem_dsl = False
    if src_type is None:
        opts.rlx = True
    else:
        opts.src = True
        opts.src_dry_distros = {(0.61, 0.5e-6): (src_lognormal, 128, 50)}
    prt = pkg.factory(pkg.backend_t.serial, oi, **kw)
    rhod, th, rv = np.ones((2, 2)), np.full((2, 2), 300.0), \
        np.full((2, 2), 0.01)
    prt.init(th, rv, rhod)
    return prt, opts, (th, rv, rhod)


def _run(prt, opts, fields, steps):
    for _ in range(steps):
        prt.step_sync(opts, *fields)
        prt.step_async(opts)


def _diag(prt, mom):
    prt.diag_all()
    getattr(prt, mom[0])(*mom[1:])
    return prt.outbuf().copy()


@pytest.mark.parametrize("src_type", ["simple", "matching"])
def test_aerosol_source_through_the_public_api(src_type, tmp_path):
    """tests/test_lgrngn_transport.py::test_aerosol_source (reference
    source.py): two source calls in 100 steps (supstp 50) double the
    concentration of the source cells; the port's run equals the JAX
    package's slot for slot, and a checkpoint keeps the counter."""
    prt, opts, fields = _transport_setup(tl, src_type, **F64)
    _run(prt, opts, fields, 60)
    prt.save(tmp_path / "src.npz")
    again, _, _ = _transport_setup(tl, src_type, **F64)
    again.load(tmp_path / "src.npz")
    assert again._src_ctr == prt._src_ctr == 60
    _run(prt, opts, fields, 40)
    sd = _diag(prt, ("diag_sd_conc",))
    mom0 = _diag(prt, ("diag_wet_mom", 0))
    assert sd[1] == 256 and sd[3] == 256
    if src_type == "simple":
        assert sd[0] == sd[2] == 256 + 2 * 128
    else:
        assert 256 < sd[0] <= 256 + 2 * 128
    assert abs((mom0[0] + mom0[2]) / (mom0[1] + mom0[3]) - 2.0) < 0.03
    jp, jo, jf = _transport_setup(jl, src_type)
    _run(jp, jo, jf, 100)
    for k in ("n", "rd3", "x", "z", "kpa"):
        np.testing.assert_array_equal(prt.get_attr(k), jp.get_attr(k),
                                      err_msg=k)
    np.testing.assert_allclose(prt.get_attr("rw2"), jp.get_attr("rw2"),
                               rtol=1e-12)


def test_ccn_relaxation_through_the_public_api():
    """tests/test_lgrngn_transport.py::test_ccn_relaxation (reference
    relax.py): relaxation towards twice the concentration in the lower
    level creates SDs there only; the port's run equals the JAX package's
    slot for slot."""
    prt, opts, fields = _transport_setup(tl, None, **F64)
    before = _diag(prt, ("diag_wet_mom", 0))
    _run(prt, opts, fields, 4)
    after = _diag(prt, ("diag_wet_mom", 0))
    assert prt._rlx_ctr == 4
    # cells (i*nz + k): 0 and 2 the lower level
    assert after[0] > 1.5 * before[0] and after[2] > 1.5 * before[2]
    np.testing.assert_array_equal(after[[1, 3]], before[[1, 3]])
    jp, jo, jf = _transport_setup(jl, None)
    _run(jp, jo, jf, 4)
    for k in ("n", "rd3", "x", "z", "kpa"):
        np.testing.assert_array_equal(prt.get_attr(k), jp.get_attr(k),
                                      err_msg=k)
