"""Port parity: the SD init modes (libcloudphxx_tpu_torch/lgrngn/init.py,
refinit.py, native/) against the JAX package's on the CPU.

Each mode runs through the port's and the JAX package's init_SD with the
same numpy Generator (or, for reference_rng_init, the same mt19937 seed),
on a 4x4 grid (375 m cells) or 8x8, with the GMD-2015 aerosol or a
lognormal of the port's common/lognormal.py.  Tolerance: bitwise at
float64 (the same numpy draws and arithmetic on both sides; the
reference RNG's glibc float32 transcendentals come from the same C core
source on both sides).  The refusals that the JAX package raises, the
port raises with the same type and message.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import init as jinit
from libcloudphxx_tpu.lgrngn import refinit as jrefinit
from libcloudphxx_tpu.lgrngn.state import StaticConfig as JCfg
from libcloudphxx_tpu.lgrngn.state import empty_state
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu.models.kinematic_2d import Setup as JSetup
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch import native
from libcloudphxx_tpu_torch.common import lognormal
from libcloudphxx_tpu_torch.lgrngn import init as tinit
from libcloudphxx_tpu_torch.lgrngn import refinit as trefinit
from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig as TCfg
from libcloudphxx_tpu_torch.models.kinematic_2d import Setup as TSetup

F64 = dict(device="cpu", dtype=torch.float64)
X = 1500.0
FIELDS = ("n", "rd3", "kpa", "x", "z", "ijk")


def _gmd(lnr):
    """The GMD-2015 bimodal aerosol (the kinematic model's)."""
    return TSetup().lognormal_lnrd(lnr)


def _broad(lnr):
    """A single lognormal mode whose tail reaches past the sd_conc range
    at 64 SDs a cell (common/lognormal.py)."""
    return lognormal.n_e(0.05e-6, 1.6, 1e8, torch.as_tensor(lnr)).numpy()


def _oi(pkg, nx=4, nz=4, distros=None, **over):
    oi = pkg.opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz, oi.x1, oi.z1, oi.dt = \
        nx, nz, X / nx, X / nz, X, X, 1.0
    oi.dry_distros = {(0.61, 0.0): _gmd} if distros is None else distros
    oi.sd_conc = 16
    oi.n_sd_max = 100_000
    for k, v in over.items():
        setattr(oi, k, v)
    return oi


def _rhod(n_cell, seed=3):
    return np.random.default_rng(seed).uniform(0.9, 1.2, n_cell)


def _both(seed=7, **kw):
    """(port population, JAX population as numpy arrays) of one init."""
    toi, joi = _oi(tl, **kw), _oi(jl, **kw)
    tcfg, jcfg = TCfg.from_opts_init(toi), JCfg.from_opts_init(joi)
    rhod = _rhod(tcfg.n_cell)
    got = tinit.init_SD(tcfg, toi, np.random.default_rng(seed), rhod)
    st = jinit.init_SD(jcfg, joi, empty_state(jcfg),
                       np.random.default_rng(seed), rhod)
    return got, _jax_pop(st, got["n"].size)


def _jax_pop(st, n_part):
    want = {k: np.asarray(getattr(st, k))[:n_part] for k in FIELDS}
    assert not np.asarray(st.n)[n_part:].any()
    return want


def _assert_bitwise(got, want):
    for k in FIELDS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


MODES = {
    "sd_conc": dict(),
    "const_multi": dict(sd_conc=0, sd_const_multi=5e9),
    "dry_sizes": dict(sd_conc=0, dry_distros={}, dry_sizes={
        (0.61, 0.0): {0.05e-6: (60e6, 3), 0.2e-6: (5e6, 2)},
        (1.28, 0.0): {0.1e-6: (30e6, 1)}}),
    "sd_conc_and_dry_sizes": dict(dry_sizes={
        (0.61, 0.0): {1e-6: (1e5, 2)}}),
    "large_tail": dict(sd_conc=64, sd_conc_large_tail=True,
                       distros={(0.61, 0.0): _broad}),
    "two_distros": dict(distros={(0.61, 0.0): _gmd, (1.28, 0.0): _broad}),
    "conc_factor_sd_conc": dict(aerosol_independent_of_rhod=True,
                                aerosol_conc_factor=[1.0, 0.5, 2.0, 0.0]),
    "conc_factor_const_multi": dict(
        sd_conc=0, sd_const_multi=5e9, aerosol_independent_of_rhod=True,
        aerosol_conc_factor=[1.0, 0.5, 2.0, 0.25]),
    "conc_factor_dry_sizes": dict(
        sd_conc=0, dry_distros={}, aerosol_independent_of_rhod=True,
        aerosol_conc_factor=[1.0, 0.5, 2.0, 0.25],
        dry_sizes={(0.61, 0.0): {0.05e-6: (60e6, 3)}}),
    "independent_of_rhod": dict(aerosol_independent_of_rhod=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_init_mode_matches_jax_bitwise(mode):
    got, want = _both(**MODES[mode])
    _assert_bitwise(got, want)
    assert got["n"].size > 0 and (got["n"] > 0).any()


def test_modes_make_what_they_say():
    """The populations have the shape of their mode: const-multi one
    multiplicity, dry_sizes the given radii, the large tail
    multiplicity-1 SDs above the sd_conc range, the concentration factor
    an empty top level."""
    cm, _ = _both(**MODES["const_multi"])
    assert np.all(cm["n"] == 5e9)
    ds, _ = _both(**MODES["dry_sizes"])
    assert set(np.round(np.cbrt(ds["rd3"]) * 1e9, 6)) == {50.0, 200.0,
                                                          100.0}
    assert ds["n"].size == 16 * 6
    tail, _ = _both(**MODES["large_tail"])
    base = 64 * 16
    assert tail["n"].size > base
    assert np.all(tail["n"][base:] == 1.0)
    assert tail["rd3"][base:].min() > tail["rd3"][:base].max()
    cf, _ = _both(**MODES["conc_factor_sd_conc"])
    k = cf["ijk"] % 4
    assert not cf["n"][k == 3].any() and cf["n"][k == 2].sum() > 0


@pytest.mark.parametrize("over,exc,match", [
    (dict(aerosol_independent_of_rhod=True, aerosol_conc_factor=[1.0, 2.0]),
     RuntimeError, "size needs to be"),
    (dict(aerosol_conc_factor=[1.0] * 4), RuntimeError,
     "aerosol_independent_of_rhod==true"),
    (dict(sd_conc=0), ValueError, "no SD init mode"),
    (dict(n_sd_max=100), RuntimeError, "exceeds n_sd_max"),
    (dict(distros={(0.61, 0.0): lambda lnr: 1e30 + 0.0 * np.asarray(lnr)}),
     RuntimeError, "non-zero"),
])
def test_refusals_match_jax(over, exc, match):
    errs = []
    for pkg, Cfg, call in (
            (tl, TCfg, lambda cfg, oi, rng, rhod: tinit.init_SD(
                cfg, oi, rng, rhod)),
            (jl, JCfg, lambda cfg, oi, rng, rhod: jinit.init_SD(
                cfg, oi, empty_state(cfg), rng, rhod))):
        oi = _oi(pkg, **over)
        cfg = Cfg.from_opts_init(oi)
        with pytest.raises(exc, match=match) as e:
            call(cfg, oi, np.random.default_rng(0), _rhod(cfg.n_cell))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_no_ccn_at_init_matches_jax():
    """no_ccn_at_init: no SD at all after init, on both sides, and the
    cell fields still set."""
    kw = dict(nx=4, nz=4, sd_conc=8, n_sd_max=512,
              opts_init_kw={"no_ccn_at_init": True})
    m = Kinematic2D(**kw, **F64)
    jm = JaxKinematic2D(micro="lgrngn", **kw)
    assert not m.prtcls.state.n.any() and not np.asarray(
        jm.prtcls.state.n).any()
    m.prtcls.diag_all()
    m.prtcls.diag_sd_conc()
    assert not m.prtcls.outbuf().any()
    np.testing.assert_allclose(m.prtcls.state.T.numpy(),
                               np.asarray(jm.prtcls.state.T), rtol=1e-13)


# ---------------------------------------------------- the reference RNG
def test_native_core_matches_jax_core():
    """The port's C core (its own copy, built into _build/) gives the JAX
    package's mt19937 stream and glibc logf/expf, bit for bit."""
    from libcloudphxx_tpu import native as jnative
    if not jnative.available():
        pytest.skip("the JAX package's C core did not build")
    a, b = native.MT19937State(44), jnative.MT19937State(44)
    np.testing.assert_array_equal(a.u01(5000), b.u01(5000))
    x = np.random.default_rng(0).uniform(1e-8, 50.0, 4000).astype(np.float32)
    np.testing.assert_array_equal(native.vec_logf(x), jnative.vec_logf(x))
    np.testing.assert_array_equal(native.vec_expf(-x), jnative.vec_expf(-x))
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("nx,sd_conc", [(4, 16), (8, 64)])
def test_reference_rng_init_matches_jax_bitwise(nx, sd_conc):
    """init_SD_reference with the float32 GMD distribution against JAX's,
    every field bitwise."""
    kw = dict(nx=nx, nz=nx, sd_conc=sd_conc)
    toi = _oi(tl, **kw, distros={(0.61, 0.0): TSetup().lognormal_lnrd_f32})
    joi = _oi(jl, **kw, distros={(0.61, 0.0): JSetup().lognormal_lnrd_f32})
    tcfg, jcfg = TCfg.from_opts_init(toi), JCfg.from_opts_init(joi)
    rhod = _rhod(tcfg.n_cell)
    dv = tinit.cell_dv(tcfg)
    got = trefinit.init_SD_reference(tcfg, toi, 44, rhod, dv)
    st = jrefinit.init_SD_reference(jcfg, joi, empty_state(jcfg), 44, rhod,
                                    dv)
    _assert_bitwise(got, _jax_pop(st, got["n"].size))
    assert got["n"].size == sd_conc * nx * nx


def test_reference_rng_model_matches_jax():
    """Kinematic2D(reference_rng=True): the same float32 th and the same
    population as the JAX model's, through particles_t.init; and
    reference_rng_init refuses the other modes as JAX does."""
    kw = dict(nx=8, nz=8, sd_conc=16, n_sd_max=16 * 64,
              kernel_parameters=[0.5])
    m = Kinematic2D(reference_rng=True, **kw, **F64)
    jm = JaxKinematic2D(micro="lgrngn", reference_rng=True, **kw)
    np.testing.assert_array_equal(m.th.numpy(), jm.th)
    assert m.opts_init.kernel_parameters == [0.5]
    assert list(jm.prtcls.opts_init.kernel_parameters) == [0.5]
    st, js = m.prtcls.state, jm.prtcls.state
    for k in ("n", "rd3", "kpa", "x", "z", "ijk"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(st.rw2.numpy(), np.asarray(js.rw2),
                               rtol=1e-13)
    for pkg, call in ((tl, lambda cfg, oi: trefinit.init_SD_reference(
            cfg, oi, 44, _rhod(cfg.n_cell), tinit.cell_dv(cfg))),
                      (jl, lambda cfg, oi: jrefinit.init_SD_reference(
            cfg, oi, empty_state(cfg), 44, _rhod(cfg.n_cell),
            tinit.cell_dv(cfg)))):
        oi = _oi(pkg, sd_conc=0, sd_const_multi=5e9)
        Cfg = TCfg if pkg is tl else JCfg
        with pytest.raises(ValueError, match="sd_conc mode only"):
            call(Cfg.from_opts_init(oi), oi)


def test_lognormal_matches_jax():
    from libcloudphxx_tpu.common import lognormal as jlognormal
    r = np.exp(np.linspace(math.log(1e-9), math.log(1e-4), 257))
    for mean, sdev, n_tot in ((0.02e-6, 1.4, 60e6), (0.075e-6, 1.6, 40e6)):
        np.testing.assert_allclose(
            lognormal.n_e(mean, sdev, n_tot, torch.tensor(np.log(r))).numpy(),
            np.asarray(jlognormal.n_e(mean, sdev, n_tot, np.log(r))),
            rtol=1e-13)
        np.testing.assert_allclose(
            lognormal.n(mean, sdev, n_tot, torch.tensor(r)).numpy(),
            np.asarray(jlognormal.n(mean, sdev, n_tot, r)), rtol=1e-13)
    # the model's float32 distribution, bitwise
    lnr = np.linspace(-20.0, -12.0, 301)
    np.testing.assert_array_equal(TSetup().lognormal_lnrd_f32(lnr),
                                  JSetup().lognormal_lnrd_f32(lnr))


def test_state_fill_of_every_mode():
    """init_SD_state puts a population in the flat State as the JAX
    package does: the live SDs first, then dead slots (n 0, rd3 1e-30,
    cell 0)."""
    toi = _oi(tl, **MODES["const_multi"])
    cfg = TCfg.from_opts_init(toi)
    from libcloudphxx_tpu_torch.lgrngn.state import empty_state as t_empty
    pop = tinit.init_SD(cfg, toi, np.random.default_rng(1),
                        _rhod(cfg.n_cell))
    st = tinit.init_SD_state(cfg, t_empty(cfg, torch.float64, "cpu"), pop)
    k = pop["n"].size
    assert torch.equal(st.n[:k], torch.tensor(pop["n"]))
    assert not st.n[k:].any() and torch.all(st.rd3[k:] == 1e-30)
    assert not st.ijk[k:].any()
    assert dataclasses.is_dataclass(st)
