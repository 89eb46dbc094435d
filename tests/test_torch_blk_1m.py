"""Port parity: the single-moment bulk scheme (libcloudphxx_tpu_torch/blk_1m)
against the JAX package's blk_1m at float64 on the CPU.

Every public function, the Grabowski-1999 ice A/B formulae and both
saturation adjustments included, gets the same inputs (numpy, from a
seed) on both sides.  Tolerance: rel 1e-12 with an absolute floor of
1e-300 on the formulae and the rhs functions (the same operations; the
libm and XLA exp/log/pow differ in the last bits), the adjustments
included (measured: at most 5.5e-13).

The RK4 adjustment runs in chunks of iterations with one host test a
chunk: it is held bitwise against the loop that tests after every
iteration, to the end and when max_iters cuts it.

The reference-mirroring oracles of tests/test_blk_1m.py run on the port:
the supersaturation gates after adjustment in the four modes, the
adjustment changing a subsaturated cloudy cell, the column-mass
conservation of sedimentation and the sign of its flux.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libcloudphxx_tpu import blk_1m as jblk
from libcloudphxx_tpu_torch import blk_1m as tblk
from libcloudphxx_tpu_torch.common import const_cp, theta_dry, theta_std

torch.set_num_threads(2)

RTOL = 1e-12

# the four mode combinations of reference sat_adj_blk_1m.py:66-71
MODES = {
    "rk4_thdry": dict(adj_nwtrph=False, th_dry=True, const_p=False),
    "rk4_constp": dict(adj_nwtrph=False, th_dry=False, const_p=True),
    "nr_thdry": dict(adj_nwtrph=True, th_dry=True, const_p=False),
    "nr_constp": dict(adj_nwtrph=True, th_dry=False, const_p=True),
}

# final |supersaturation %| gates (reference sat_adj_blk_1m.py:74-88)
SS_GATES = {
    (True, "rk4_thdry"): 3e-2,
    (True, "rk4_constp"): 3e-2,
    (True, "nr_thdry"): 3.0,
    (True, "nr_constp"): 1.0,
    (False, "rk4_thdry"): 0.5,
    (False, "rk4_constp"): 0.5,
    (False, "nr_thdry"): 0.8,
    (False, "nr_constp"): 5e-3,
}

SHAPE = (6, 9)


def _with_zeros(rng, lo, hi, frac=0.25):
    """Uniform values in [lo, hi) with about ``frac`` of them exactly 0."""
    v = rng.uniform(lo, hi, SHAPE)
    return np.where(rng.uniform(size=SHAPE) < frac, 0.0, v)


def _inputs(seed=0):
    """Cells spanning homogeneous nucleation (T < 233.16 K), the Koenig
    table's 0 to -31 C and melting (T > 273.16 K), with zero and nonzero
    water contents."""
    rng = np.random.default_rng(seed)
    rvs = rng.uniform(4e-3, 1.5e-2, SHAPE)
    return dict(
        T=rng.uniform(228.0, 280.0, SHAPE),
        rhod=rng.uniform(0.8, 1.2, SHAPE),
        p=rng.uniform(7e4, 1e5, SHAPE),
        rv=rvs * rng.uniform(0.7, 1.1, SHAPE),
        rvs=rvs,
        rvsi=rvs * rng.uniform(0.6, 1.0, SHAPE),
        rc=_with_zeros(rng, 1e-6, 2e-3),
        rr=_with_zeros(rng, 1e-7, 2e-3),
        ria=_with_zeros(rng, 1e-7, 1e-3),
        rib=_with_zeros(rng, 1e-7, 1e-3),
    )


def _pair(args):
    """The same arguments for JAX (jnp float64) and the port (CPU float64
    tensors); numbers pass as they are."""
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


# (function, its argument names) of blk_1m.formulae; "dt" is 1 s and
# "rhod_0" the cells' rhod
FORMULAE = {
    "autoconversion_rate": ("rc", 5e-4, 1e-3),
    "collection_rate": ("rc", "rr"),
    "evaporation_rate": ("rv", "rvs", "rr", "rhod", "p"),
    "v_term": ("rr", "rhod", "rhod"),
    "lambda_rain": ("rr", "rhod"),
    "mass_a": ("ria", "T", "rhod"),
    "velocity_iceA": ("ria", "rhod"),
    "lambda_ice_b": ("rib", "rhod"),
    "mass_b": ("rib", "rhod"),
    "velocity_iceB": ("rib", "rhod"),
    "coeff_alpha": ("T",),
    "coeff_beta": ("T",),
    "hom_A_nucleation_1": ("rv", "rvs", "rvsi", "T", 1.0),
    "hom_A_nucleation_2": ("rc", "T", 1.0),
    "het_A_nucleation": ("ria", "rc", "T", "rhod", 1.0),
    "het_B_nucleation_1": ("rr", "ria", "T", "rhod"),
    "het_B_nucleation_2": ("rr", "ria", "T", "rhod"),
    "melting_A": ("ria", "T", "rhod", 1.0),
    "melting_B": ("rib", "T", "rhod", 1.0),
    "deposition_A": ("ria", "rv", "rvs", "rvsi", "T", "rhod"),
    "deposition_B": ("rib", "rv", "rvs", "rvsi", "T", "rhod"),
    "riming_A": ("ria", "rc", "rv", "rvs", "rvsi", "T", "rhod"),
    "riming_B": ("rib", "rc", "rv", "rvs", "rvsi", "T", "rhod"),
    "riming_B_1": ("rib", "rc", "rr", "rv", "rvs", "rvsi", "T", "rhod"),
    "riming_B_2": ("rib", "rc", "rr", "rv", "rvs", "rvsi", "T", "rhod"),
}


@pytest.mark.parametrize("name", list(FORMULAE))
def test_formula_matches_jax(name):
    x = _inputs()
    j, t = _pair([x[a] if isinstance(a, str) else a for a in FORMULAE[name]])
    ref = getattr(jblk.formulae, name)(*j)
    out = getattr(tblk.formulae, name)(*t)
    _close(out, ref)
    # the formulae act: some cells give a nonzero rate
    assert np.any(np.asarray(ref) != 0), name


def test_koenig_table_edges_match_jax():
    """The Koenig interpolation at whole degrees, at 0 and -31 C and
    outside the table on both sides."""
    T = np.array([300.0, 273.16, 272.16, 262.66, 242.16, 241.0, 200.0])
    for name in ("coeff_alpha", "coeff_beta"):
        _close(getattr(tblk.formulae, name)(torch.tensor(T)),
               getattr(jblk.formulae, name)(jnp.asarray(T)))


def _state(mode, seed=1):
    """A grid of cells around saturation for the adjustments and the rhs:
    th (dry or standard by the mode), rv from 80% to 110% of saturation,
    cloud and rain water with zeros."""
    rng = np.random.default_rng(seed)
    rhod = rng.uniform(0.9, 1.2, SHAPE)
    th_d = rng.uniform(285.0, 305.0, SHAPE)
    T = np.asarray(theta_dry.T(torch.tensor(th_d), torch.tensor(rhod)))
    p_d = np.asarray(theta_dry.p(torch.tensor(rhod), torch.zeros(SHAPE,
                                 dtype=torch.float64), torch.tensor(T)))
    rvs = np.asarray(const_cp.r_vs(torch.tensor(T), torch.tensor(p_d)))
    rv = rvs * rng.uniform(0.8, 1.1, SHAPE)
    p = np.asarray(theta_dry.p(torch.tensor(rhod), torch.tensor(rv),
                               torch.tensor(T)))
    th = th_d if MODES[mode]["th_dry"] else np.asarray(
        theta_dry.dry2std(torch.tensor(th_d), torch.tensor(rv)))
    return dict(rhod=rhod, p=p, th=th, rv=rv,
                rc=_with_zeros(rng, 1e-6, 1e-3, 0.4),
                rr=_with_zeros(rng, 1e-7, 1e-3, 0.4),
                ria=_with_zeros(rng, 1e-7, 1e-4, 0.5),
                rib=_with_zeros(rng, 1e-7, 1e-4, 0.5))


@pytest.mark.parametrize("mode", list(MODES))
def test_adj_cellwise_matches_jax(mode):
    opts = dict(MODES[mode])
    x = _state(mode)
    j, t = _pair([x[k] for k in ("rhod", "p", "th", "rv", "rc", "rr")])
    ref = jblk.adj_cellwise(jblk.opts_t(**opts), *j, 1.0)
    out = tblk.adj_cellwise(tblk.opts_t(**opts), *t, 1.0)
    _close(out, ref)
    assert not np.array_equal(np.asarray(ref[1]), x["rv"])


@pytest.mark.parametrize("mode", ["nr_thdry", "nr_constp"])
def test_adj_cellwise_nwtrph_matches_jax(mode):
    x = _state(mode)
    j, t = _pair([x[k] for k in ("rhod", "p", "th", "rv", "rc")])
    opts = dict(MODES[mode], nwtrph_iters=5)
    _close(tblk.adj_cellwise_nwtrph(tblk.opts_t(**opts), *t, 1.0),
           jblk.adj_cellwise_nwtrph(jblk.opts_t(**opts), *j, 1.0))


@pytest.mark.parametrize("mode", ["rk4_thdry", "rk4_constp"])
@pytest.mark.parametrize("switches", [{}, dict(revp=False), dict(cevp=False)],
                         ids=["all", "no_revp", "no_cevp"])
def test_adj_cellwise_rk4_matches_jax(mode, switches):
    x = _state(mode)
    j, t = _pair([x[k] for k in ("rhod", "p", "th", "rv", "rc", "rr")])
    opts = dict(MODES[mode], **switches)
    _close(tblk.adj_cellwise_rk4(tblk.opts_t(**opts), *t, 1.0),
           jblk.adj_cellwise_rk4(jblk.opts_t(**opts), *j, 1.0))


def _unchunked(opts, rhod, p, th, rv, rc, rr, dt, max_iters):
    """The RK4 adjustment's loop with the host test before every
    iteration, as a plain loop over blk_1m's own iteration."""
    from libcloudphxx_tpu_torch.blk_1m.adj_cellwise import (_rk4_iteration,
                                                            _T_p)
    T0, p0 = _T_p(opts, th, rv, rhod, p)
    rs0 = const_cp.r_vs(T0, p0)
    drr_max = torch.where((rs0 > rv) & (rr > 0), dt * tblk.formulae
                          .evaporation_rate(rv, rs0, rr, rhod, p0), 0.0)
    state = (th, rv, rc, rr, drr_max, torch.ones_like(rv, dtype=torch.bool))
    it = 0
    while it < max_iters:
        state, active = _rk4_iteration(opts, rhod, p, state)
        it += 1
        if not bool(active.any()):
            break
    return state[:4], it


@pytest.mark.parametrize("max_iters", [10_000, 37, 16],
                         ids=["to_the_end", "cut_mid_chunk", "cut_at_chunk"])
@pytest.mark.parametrize("chunk", [16, 5])
def test_rk4_chunks_are_bitwise_the_unchunked_loop(chunk, max_iters,
                                                   monkeypatch):
    x = _state("rk4_thdry", seed=3)
    # far from saturation, so that many iterations run; 15 K cooler, where
    # no cell's r_eps/2 steps overshoot saturation both ways for ever (the
    # warmest cells of _state do: they cycle until max_iters)
    x["th"] = x["th"] - 15.0
    x["rv"] = x["rv"] * np.where(np.arange(SHAPE[1]) % 2, 1.3, 0.6)
    t = [torch.tensor(x[k]) for k in ("rhod", "p", "th", "rv", "rc", "rr")]
    opts = tblk.opts_t(**MODES["rk4_thdry"])
    ref, iters = _unchunked(opts, *t, 1.0, max_iters)
    monkeypatch.setattr(sys.modules["libcloudphxx_tpu_torch.blk_1m."
                                    "adj_cellwise"], "RK4_CHUNK", chunk)
    out = tblk.adj_cellwise_rk4(opts, *t, 1.0, max_iters=max_iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    if max_iters == 10_000:
        assert 16 < iters < max_iters       # converged after a few chunks
    else:
        assert iters == max_iters           # cut


def test_rk4_idle_cell_with_nonfinite_slope_keeps_its_state(monkeypatch):
    """An idle cell keeps its state bitwise, even where its RK4 slope is
    not finite: a cell at rhod = 0 (T = 0, r_vs and the slope NaN) idles
    through the 40 iterations its neighbour needs, and keeps th and rv."""
    opts = tblk.opts_t(**MODES["rk4_thdry"])
    rhod = f64([0.0, 1.0])
    th, rv = f64([300.0, 300.0]), f64([0.01, 0.03])
    monkeypatch.setattr(sys.modules["libcloudphxx_tpu_torch.blk_1m."
                                    "adj_cellwise"], "RK4_CHUNK", 7)
    out = tblk.adj_cellwise_rk4(opts, rhod, rhod, th, rv, f64([0.0, 0.0]),
                                f64([0.0, 0.0]), 1.0)
    assert float(out[0][0]) == 300.0 and float(out[1][0]) == 0.01
    assert float(out[2][1]) > 0.0               # the neighbour condensed
    assert torch.isfinite(torch.stack(out)[:, 1]).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_rhs_cellwise_functions_match_jax(mode):
    x = _state(mode)
    opts = dict(MODES[mode])
    z = np.zeros(SHAPE)
    j, t = _pair([z, z, x["rc"], x["rr"]])
    _close(tblk.rhs_cellwise(tblk.opts_t(**opts), *t),
           jblk.rhs_cellwise(jblk.opts_t(**opts), *j))
    cells = [x[k] for k in ("rhod", "p", "th", "rv", "rc", "rr")]
    if opts["adj_nwtrph"]:
        j, t = _pair([z] * 4 + cells + [1.0])
        _close(tblk.rhs_cellwise_revap(tblk.opts_t(**opts), *t),
               jblk.rhs_cellwise_revap(jblk.opts_t(**opts), *j))
    else:
        with pytest.raises(ValueError, match="Newton-Raphson"):
            tblk.rhs_cellwise_revap(tblk.opts_t(**opts), *_pair(
                [z] * 4 + cells + [1.0])[1])


@pytest.mark.parametrize("mode", list(MODES))
def test_rhs_cellwise_ice_matches_jax(mode):
    """The ice A/B paths on cold cells (-45 to +5 C) with ice present."""
    x = _state(mode, seed=5)
    rng = np.random.default_rng(6)
    # cool the cells: th scaled so that T spans 228-278 K
    x["th"] = x["th"] * rng.uniform(0.78, 0.95, SHAPE)
    z = np.zeros(SHAPE)
    args = [z] * 6 + [x[k] for k in ("rhod", "p", "th", "rv", "rc", "rr",
                                     "ria", "rib")] + [1.0]
    j, t = _pair(args)
    ref = jblk.rhs_cellwise_ice(jblk.opts_t(**MODES[mode]), *j)
    _close(tblk.rhs_cellwise_ice(tblk.opts_t(**MODES[mode]), *t), ref)
    assert np.any(np.asarray(ref[4]) != 0) and np.any(np.asarray(ref[5]) != 0)


@pytest.mark.parametrize("sedi", [True, False])
def test_rhs_columnwise_functions_match_jax(sedi):
    x = _state("nr_thdry")
    opts = dict(sedi=sedi)
    j, t = _pair([np.zeros(SHAPE), x["rhod"], x["rr"], 25.0])
    _close(tblk.rhs_columnwise(tblk.opts_t(**opts), *t),
           jblk.rhs_columnwise(jblk.opts_t(**opts), *j))
    for ice in ("iceA", "iceB"):
        j, t = _pair([np.zeros(SHAPE), x["rhod"], x["ria"], 25.0])
        _close(tblk.rhs_columnwise_ice(tblk.opts_t(**opts), *t,
                                       tblk.ice_t[ice]),
               jblk.rhs_columnwise_ice(jblk.opts_t(**opts), *j,
                                       jblk.ice_t[ice]))


def test_options_are_the_jax_options():
    assert [f.name for f in dataclasses.fields(tblk.opts_t)] == \
        [f.name for f in dataclasses.fields(jblk.opts_t)]
    assert dataclasses.asdict(tblk.opts_t()) == dataclasses.asdict(
        jblk.opts_t())
    assert sorted(tblk.__all__) == sorted(jblk.__all__)


# ---- the reference-mirroring oracles (tests/test_blk_1m.py) on the port

def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def _initial_state(init_sup_sat):
    # reference sat_adj_blk_1m.py:21-36
    rhod = f64([1.0])
    th_d = f64([300.0])
    rv = f64([0.02]) if init_sup_sat else f64([0.002])
    rc = f64([0.015])
    rr = f64([0.0])
    T = theta_dry.T(th_d, rhod)
    p = theta_dry.p(rhod, rv, T)
    return rhod, th_d, rv, rc, rr, p


@pytest.mark.parametrize("init_sup_sat", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_sat_adj_supersaturation_gate(mode, init_sup_sat):
    opts = tblk.opts_t(**MODES[mode])
    rhod, th_d, rv, rc, rr, p = _initial_state(init_sup_sat)
    th = th_d if opts.th_dry else theta_dry.dry2std(th_d, rv)
    th, rv, rc, rr = tblk.adj_cellwise(opts, rhod, p, th, rv, rc, rr, 1.0)
    if opts.th_dry:
        T = theta_dry.T(th, rhod)
        p_fin = theta_dry.p(rhod, rv, T)
    else:
        T = theta_std.T(th, p)
        p_fin = p
    ss = float(100.0 * (rv / const_cp.r_vs(T, p_fin) - 1.0))
    assert abs(ss) < SS_GATES[(init_sup_sat, mode)], (mode, init_sup_sat, ss)
    # adjustment only moves mass between rv and rc/rr
    assert np.isclose(float(rv + rc + rr),
                      0.015 + (0.02 if init_sup_sat else 0.002), atol=1e-12)
    assert float(rc) >= 0 and float(rv) >= 0 and float(rr) >= 0


@pytest.mark.parametrize("mode", list(MODES))
def test_sat_adj_changes_state(mode):
    # reference api_blk_1m.py:50-61: subsaturated with cloud water present
    opts = tblk.opts_t(**MODES[mode])
    out = tblk.adj_cellwise(opts, f64([1.0]), f64([1e5]), f64([300.0]),
                            f64([0.0]), f64([0.01]), f64([0.0]), 1.0)
    th2, rv2, rc2, rr2 = (float(a) for a in out)
    assert th2 != 300.0 and rv2 != 0.0 and rc2 != 0.01 and rr2 == 0.0


def test_rhs_columnwise_mass_conservation_and_flux_sign():
    opts = tblk.opts_t()
    nz = 8
    rhod = torch.linspace(1.2, 0.8, nz, dtype=torch.float64)
    rr = torch.full((nz,), 1e-3, dtype=torch.float64)
    rr[0] = 2e-3
    dot_rr, flux = tblk.rhs_columnwise(opts, torch.zeros_like(rr), rhod, rr,
                                       50.0)
    # sum_k dot_rr[k] * rhod[k] telescopes to the surface flux
    assert float(flux) < 0
    assert np.isclose(float((dot_rr * rhod).sum()), float(flux), rtol=1e-10)
    assert float(dot_rr[-1]) <= 0
    # no rain, no flux; sedimentation off, nothing
    d, fl = tblk.rhs_columnwise(opts, f64([0.0]), f64([1.0]), f64([0.0]), 1.0)
    assert float(fl) == 0 and float(d[0]) == 0
    d, fl = tblk.rhs_columnwise(tblk.opts_t(sedi=False), f64([0.0]),
                                f64([1.0]), f64([1e-3]), 1.0)
    assert float(fl) == 0 and float(d[0]) == 0
    for ice in (tblk.ice_t.iceA, tblk.ice_t.iceB):
        ri = torch.full((4,), 0.1, dtype=torch.float64)
        one = torch.ones(4, dtype=torch.float64)
        d, fl = tblk.rhs_columnwise_ice(opts, torch.zeros(4,
                                        dtype=torch.float64), one, ri, 1.0,
                                        ice)
        assert float(fl) != 0
        assert np.isclose(float((d * one).sum()), float(fl), rtol=1e-10)


def test_invalid_theta_convention():
    opts = tblk.opts_t(th_dry=True, const_p=True)
    with pytest.raises(ValueError):
        tblk.adj_cellwise(opts, f64([1.0]), f64([1e5]), f64([300.0]),
                          f64([0.01]), f64([0.0]), f64([0.0]), 1.0)


def test_float32_keeps_the_dtype():
    """On float32 tensors every output stays float32 (the card's dtype)."""
    x = _state("nr_thdry")
    t = [torch.tensor(x[k], dtype=torch.float32)
         for k in ("rhod", "p", "th", "rv", "rc", "rr")]
    out = tblk.adj_cellwise(tblk.opts_t(), *t, 1.0)
    z = torch.zeros_like(t[0])
    out += tblk.rhs_cellwise_revap(tblk.opts_t(), z, z, z, z, *t, 1.0)
    out += tblk.rhs_columnwise(tblk.opts_t(), z, t[0], t[5], 20.0)
    assert all(o.dtype == torch.float32 for o in out)
