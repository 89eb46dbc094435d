"""Port parity: the double-moment bulk scheme (libcloudphxx_tpu_torch/blk_2m)
against the JAX package's blk_2m at float64 on the CPU.

Every public function of blk_2m.formulae gets the same inputs (numpy, from
a seed) on both sides, with drop sizes on both sides of each Simmel-2002
fall-speed regime boundary and supersaturations around the activation
edge; rhs_cellwise with every process switch and both theta conventions,
and rhs_columnwise.  torch.lgamma, torch.special.erf and erfc stand for
jax.scipy's gammaln, erf and erfc; a last-ulp difference between them
could flip a regime select or a limiter, so the inputs keep clear of the
selects' edges by more than that.  Tolerance: rel 1e-12, absolute floor
1e-300 (measured: at most 1.5e-13).

The reference-mirroring oracles of tests/test_blk_2m.py run on the port:
evaporation, activation and its cap by the droplets present,
autoconversion and accretion with their number sinks, sedimentation's
column-mass closure and cap, the ordering of the moment-weighted fall
speeds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libcloudphxx_tpu import blk_2m as jblk
from libcloudphxx_tpu_torch import blk_2m as tblk

torch.set_num_threads(2)

RTOL = 1e-12
SHAPE = (6, 9)


def _modes(pkg):
    # the bimodal aerosol of reference api_blk_2m.py:17-20
    return (
        pkg.lognormal_mode_t(mean_rd=0.04e-6 / 2, sdev_rd=1.4, N_stp=60e6,
                             chem_b=0.55),
        pkg.lognormal_mode_t(mean_rd=0.15e-6 / 2, sdev_rd=1.6, N_stp=40e6,
                             chem_b=0.55),
    )


def _with_zeros(rng, lo, hi, frac=0.25, log=False):
    v = np.exp(rng.uniform(np.log(lo), np.log(hi), SHAPE)) if log else \
        rng.uniform(lo, hi, SHAPE)
    return np.where(rng.uniform(size=SHAPE) < frac, 0.0, v)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    T = rng.uniform(270.0, 300.0, SHAPE)
    return dict(
        T=T,
        p=rng.uniform(8e4, 1e5, SHAPE),
        rhod=rng.uniform(0.9, 1.2, SHAPE),
        th=T * rng.uniform(1.0, 1.05, SHAPE),
        rv=rng.uniform(5e-3, 2e-2, SHAPE),
        rc=_with_zeros(rng, 1e-7, 2e-3, log=True),
        nc=_with_zeros(rng, 1e6, 3e8, log=True),
        rr=_with_zeros(rng, 1e-9, 2e-3, log=True),
        nr=_with_zeros(rng, 1e1, 1e6, log=True),
        # mean drop radii on both sides of d1/2, d2/2, d3/2 (and 0)
        r=np.choose(rng.integers(0, 8, SHAPE),
                    [0.0, 30e-6, 70e-6, 500e-6, 800e-6, 1.5e-3, 1.8e-3,
                     3e-3]),
        tau=rng.uniform(1.0, 100.0, SHAPE),
    )


def _pair(args):
    j = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    t = tuple(torch.tensor(a) if isinstance(a, np.ndarray) else a
              for a in args)
    return j, t


def _close(port, ref, rtol=RTOL):
    if isinstance(ref, tuple):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, rtol)
        return
    a = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(a, np.asarray(ref), rtol=rtol, atol=1e-300)


def _pos(x, *keys):
    """The named inputs with zeros replaced by typical values (for the
    formulae that the schemes call on guarded, positive arguments)."""
    fill = dict(rc=1e-4, nc=1e8, rr=1e-4, nr=1e4)
    return [np.where(x[k] > 0, x[k], fill[k]) if k in fill else x[k]
            for k in keys]


# (function, its inputs) of blk_2m.formulae; "+" marks inputs with zeros
# replaced (_pos)
FORMULAE = {
    "eta_MG": ("+nc",),
    "miu_c": ("+nc",),
    "lambda_c": ("+nc", "+rc", "rhod"),
    "N0_c": ("+nc", "+rc", "rhod"),
    "lambda_r": ("+nr", "+rr"),
    "N0_r": ("+nr", "+rr"),
    "r_drop_c": ("rc", "nc", "rhod"),
    "r_drop_r": ("rr", "nr"),
    "s_0": ("T", 0.02e-6, 0.55),
    "supersaturation": ("p", "T", "rv"),
    "u_MG": ("p", "T", "rv", 0.02e-6, 1.4, 0.55, 44.0),
    "n_c_p": ("p", "T", "rv", 0.075e-6, 1.6, 40e6, 0.55, 1.01),
    "activation_rate": ("+nc", "nc", 1.0),
    "tau_relax_c": ("T", "p", "r", "+nc"),
    "alpha_fall": ("r",),
    "beta_fall": ("r",),
    "a_fall": ("rr", "nr"),
    "b_fall": ("rr", "nr"),
    "tau_relax_r": ("T", "rhod", "+rr", "+nr"),
    "drv_s_dT": ("T", "rv"),
    "cond_evap_rate": ("T", "p", "rv", "tau"),
    "autoconv_rate": ("+rc", "+nc", "rhod", 1350.0, 2.47, -1.79),
    "accretion_rate": ("rc", "rr"),
    "collision_sink_rate": ("rr", "+nc"),
    "v_term_m": ("rhod", "rr", "nr"),
    "v_term_n": ("rhod", "rr", "nr"),
}


@pytest.mark.parametrize("name", list(FORMULAE))
def test_formula_matches_jax(name):
    x = _inputs()
    args = []
    for a in FORMULAE[name]:
        if not isinstance(a, str):
            args.append(a)
        elif a.startswith("+"):
            args += _pos(x, a[1:])
        else:
            args.append(x[a])
    j, t = _pair(args)
    ref = getattr(jblk.formulae, name)(*j)
    _close(getattr(tblk.formulae, name)(*t), ref)
    assert np.any(np.asarray(ref) != 0), name


@pytest.mark.parametrize("name", ["rc_eps", "rr_eps", "nc_eps", "nr_eps"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thresholds_follow_the_dtype(name, dtype):
    ref = getattr(jblk.formulae, name)(jnp.zeros(1, dtype))
    out = getattr(tblk.formulae, name)(torch.zeros(1, dtype=getattr(torch,
                                                                   dtype)))
    assert out == pytest.approx(float(ref), rel=1e-15)


def test_fall_speed_regimes_match_jax_at_their_edges():
    """alpha_fall and beta_fall just below and above each boundary, and
    the regimes' constant prefactors of v_term_m and v_term_n."""
    f = tblk.formulae
    edges = [0.0] + [d * s / 2 for d in (f.d1, f.d2, f.d3)
                     for s in (1 - 1e-9, 1 + 1e-9)]
    r = np.array(edges)
    for name in ("alpha_fall", "beta_fall"):
        ref = np.asarray(getattr(jblk.formulae, name)(jnp.asarray(r)))
        _close(getattr(f, name)(torch.tensor(r)), ref)
    jf, conv = jblk.formulae, f.c_md * 1000.0
    ref = [float(jf.alpha_fall(x) * conv ** jf.beta_fall(x))
           for x in (f.d1 / 4, (f.d1 + f.d2) / 4, (f.d2 + f.d3) / 4)]
    ref.append(float(jf.alpha_fall(f.d3)))
    assert list(f._FALL_COEFFS) == pytest.approx(ref, rel=1e-15)


@pytest.mark.parametrize("switches", [
    {}, dict(acti=False), dict(cond=False), dict(acnv=False),
    dict(accr=False), dict(sedi=False), dict(RH_max=1.01),
    dict(th_dry=False, const_p=True)],
    ids=["all", "no_acti", "no_cond", "no_acnv", "no_accr", "no_sedi",
         "spinup_rh", "const_p"])
def test_rhs_cellwise_matches_jax(switches):
    x = _inputs(seed=2)
    z = np.zeros(SHAPE)
    args = [z] * 6 + [x[k] for k in ("rhod", "th", "rv", "rc", "nc", "rr",
                                     "nr")] + [1.0]
    j, t = _pair(args + [x["p"]])
    ref = jblk.rhs_cellwise(jblk.opts_t(dry_distros=_modes(jblk),
                                        **switches), *j)
    out = tblk.rhs_cellwise(tblk.opts_t(dry_distros=_modes(tblk),
                                        **switches), *t)
    _close(out, ref)
    assert all(np.any(np.asarray(r) != 0) for r in ref)


@pytest.mark.parametrize("sedi", [True, False])
def test_rhs_columnwise_matches_jax(sedi):
    x = _inputs(seed=3)
    rng = np.random.default_rng(4)
    # cellwise tendencies the caps see
    dot_rr = rng.uniform(-1e-6, 1e-6, SHAPE)
    dot_nr = rng.uniform(-1.0, 1.0, SHAPE)
    j, t = _pair([dot_rr, dot_nr, x["rhod"], x["rr"], x["nr"], 1.0, 25.0])
    _close(tblk.rhs_columnwise(tblk.opts_t(sedi=sedi), *t),
           jblk.rhs_columnwise(jblk.opts_t(sedi=sedi), *j))


def test_options_are_the_jax_options():
    for name in ("opts_t", "lognormal_mode_t"):
        assert [f.name for f in dataclasses.fields(getattr(tblk, name))] == \
            [f.name for f in dataclasses.fields(getattr(jblk, name))]
    assert dataclasses.asdict(tblk.opts_t()) == dataclasses.asdict(
        jblk.opts_t())
    assert sorted(tblk.__all__) == sorted(jblk.__all__)


# ---- the reference-mirroring oracles (tests/test_blk_2m.py) on the port

def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def zeros():
    return [f64([0.0]) for _ in range(6)]


def test_rhs_cellwise_evaporation():
    # api_blk_2m.py:23-47: dry cell with cloud water -> evaporation
    opts = tblk.opts_t(dry_distros=_modes(tblk))
    out = tblk.rhs_cellwise(opts, *zeros(), f64([1.0]), f64([300.0]),
                            f64([0.0]), f64([0.01]), f64([1e-3]), f64([0.0]),
                            f64([0.0]), 1.0)
    dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr = (float(o) for o in out)
    assert dot_th != 0 and dot_rv > 0 and dot_rc < 0
    assert all(np.isfinite(float(o)) for o in out)
    assert np.isclose(dot_rv, -(dot_rc + dot_rr), rtol=1e-12)


def test_activation_supersaturated_and_capped():
    opts = tblk.opts_t(dry_distros=_modes(tblk), cond=False, acnv=False,
                       accr=False)
    rhod, th, rv = f64([1.0]), f64([290.0]), f64([0.02])
    out0 = tblk.rhs_cellwise(opts, *zeros(), rhod, th, rv, f64([0.0]),
                             f64([0.0]), f64([0.0]), f64([0.0]), 1.0)
    assert float(out0[3]) > 0 and float(out0[2]) > 0
    # activated number bounded by total aerosol per kg
    n_tot = sum(m.N_stp for m in _modes(tblk)) / 1.2248   # rho_stp
    assert float(out0[3]) <= n_tot
    # already activated droplets reduce the activation source
    out1 = tblk.rhs_cellwise(opts, *zeros(), rhod, th, rv, f64([0.0]),
                             f64([5e7]), f64([0.0]), f64([0.0]), 1.0)
    assert float(out1[3]) < float(out0[3])


def test_autoconversion_and_accretion():
    opts = tblk.opts_t(dry_distros=_modes(tblk), acti=False, cond=False)
    out = tblk.rhs_cellwise(opts, *zeros(), f64([1.0]), f64([300.0]),
                            f64([5e-3]), f64([2e-3]), f64([1e8]), f64([1e-4]),
                            f64([1e6]), 1.0)
    _, _, dot_rc, dot_nc, dot_rr, dot_nr = (float(o) for o in out)
    assert dot_rc < 0 and dot_rr > 0 and dot_nc < 0 and dot_nr > 0
    assert np.isclose(dot_rc, -dot_rr, rtol=1e-12)
    # KK2000 autoconversion magnitude: A * rc^b * (N/cm3)^c
    assert dot_rr >= 0.5 * 1350.0 * 2e-3**2.47 * (1e8 * 1e-6) ** -1.79


def test_rhs_columnwise_conservation_cap_and_flux_sign():
    opts = tblk.opts_t()
    nz = 6
    rhod = torch.linspace(1.1, 0.9, nz, dtype=torch.float64)
    rr = torch.full((nz,), 1e-3, dtype=torch.float64)
    nr = torch.full((nz,), 1e5, dtype=torch.float64)
    z = torch.zeros(nz, dtype=torch.float64)
    dot_rr, dot_nr, flux = tblk.rhs_columnwise(opts, z, z, rhod, rr, nr, 1.0,
                                               25.0)
    assert float(flux) < 0
    assert np.isclose(float((dot_rr * rhod).sum()), float(flux), rtol=1e-10)
    assert bool((dot_rr >= -rr / 1.0 - 1e-15).all())
    assert bool((dot_nr >= -nr / 1.0 - 1e-10).all())
    # no rain, no flux
    d_rr, d_nr, fl = tblk.rhs_columnwise(opts, f64([0.0]), f64([0.0]),
                                         f64([1.0]), f64([0.0]), f64([0.0]),
                                         1.0, 1.0)
    assert float(fl) == 0 and float(d_rr) == 0 and float(d_nr) == 0


def test_terminal_velocities_ordering():
    rhod, rr, nr = f64([1.0]), f64([1e-3]), f64([1e5])
    vm = float(tblk.formulae.v_term_m(rhod, rr, nr))
    vn = float(tblk.formulae.v_term_n(rhod, rr, nr))
    assert 15.0 > vm > vn > 0


def test_float32_keeps_the_dtype():
    x = _inputs(seed=5)
    z = torch.zeros(SHAPE, dtype=torch.float32)
    t = [torch.tensor(x[k], dtype=torch.float32)
         for k in ("rhod", "th", "rv", "rc", "nc", "rr", "nr")]
    out = tblk.rhs_cellwise(tblk.opts_t(dry_distros=_modes(tblk)), *[z] * 6,
                            *t, 1.0)
    out += tblk.rhs_columnwise(tblk.opts_t(), z, z, t[0], t[5], t[6], 1.0,
                               20.0)
    assert all(o.dtype == torch.float32 for o in out)
    assert all(bool(torch.isfinite(o).all()) for o in out)
