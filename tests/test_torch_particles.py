"""Port parity: the public API (factory -> particles_t: init, step_sync,
step_async, the diagnostics, save/load) and the stepwise icicle loop
(Kinematic2D.run) against the JAX package's flat engine at float64 on the
CPU.

Tolerances: at init every attribute and diagnostic equals the JAX
package's to rtol 1e-13 (the same numpy draws; the closure and the
kappa-Koehler solve in two libraries).  After coalescence-free steps
th/rv rtol 1e-12, positions rtol 1e-12, multiplicities and cells exact,
rw2 and vt rtol 1e-10 for 99% of the droplets and 1e-6 for all (haze
droplets at their activation barrier amplify the ~1e-15 th/rv differences
of the two libraries' cell sums, see test_torch_flat_engine.py), moments
rtol 1e-9.
With coalescence the draws differ (Philox here, jax.random there), so the
checks are bench.py's physics checks, collisions, and exact agreement
between the port's own paths.
"""

import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.common import constants as c
from libcloudphxx_tpu_torch.lgrngn.particles import factory

KW = dict(nx=8, nz=8, sd_conc=16, sstp_cond=3, sstp_coal=3,
          n_sd_max=16 * 64 + 40, opts_init_kw={"coal_switch": False})
KW_COAL = dict(KW, opts_init_kw={"kernel_parameters": [100.0]})
F64 = dict(device="cpu", dtype=torch.float64)
ATTRS = ("rd3", "rw2", "kpa", "kappa", "n", "x", "y", "z", "vt")
STEPS = 3


def _rw2_close(got, want):
    rel = np.abs(got - want) / np.maximum(want, 1e-300)
    assert np.mean(rel <= 1e-10) >= 0.99
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _host_fields(m, k):
    """th/rv as a host model hands them over at step k: the model's
    initial fields with a seeded increment."""
    rng = np.random.default_rng(100 + k)
    th = np.full((m.nx, m.nz), 289.0) + rng.normal(0.5, 0.2, (m.nx, m.nz))
    rv = np.full((m.nx, m.nz), 7.5e-3) * (1 + rng.uniform(0, 0.03,
                                                          (m.nx, m.nz)))
    return th, rv


def _drive(prt, rhod, opts, steps, tensors=False):
    """``steps`` step_sync/step_async pairs with the host fields of
    _host_fields; returns the th/rv the engine handed back."""
    m = type("M", (), {"nx": KW["nx"], "nz": KW["nz"]})
    out = []
    for k in range(steps):
        th, rv = _host_fields(m, k)
        if tensors:
            th, rv = torch.tensor(th), torch.tensor(rv)
            th, rv = prt.step_sync(opts, th, rv, torch.tensor(rhod))
            th, rv = th.numpy(), rv.numpy()
        else:
            assert prt.step_sync(opts, th, rv, rhod) is None
        out.append((th.reshape(-1).copy(), rv.reshape(-1).copy()))
        prt.step_async(opts)
    return out


def _opts(pkg):
    o = pkg.opts_t()
    o.coal = False
    return o


@pytest.fixture(scope="module")
def inited():
    """The JAX and the port's particles_t after init (Kinematic2D's)."""
    jm = JaxKinematic2D(micro="lgrngn", **KW)
    pm = Kinematic2D(**KW, **F64)
    return jm, pm


@pytest.fixture(scope="module")
def stepped():
    """Both engines after STEPS coalescence-free steps of host fields."""
    jm = JaxKinematic2D(micro="lgrngn", **KW)
    pm = Kinematic2D(**KW, **F64)
    rhod = np.asarray(jm.rhod)
    j = _drive(jm.prtcls, rhod, _opts(jl), STEPS)
    p = _drive(pm.prtcls, rhod, _opts(tl), STEPS)
    return jm, pm, j, p


def _diags(prt):
    """Every diagnostic of the warm surface, as {name: array}."""
    out = {}

    def take(name, select, diag):
        select()
        diag()
        out[name] = np.array(prt.outbuf())

    take("sd_conc", prt.diag_all, prt.diag_sd_conc)
    for k in (0, 1, 3):
        take(f"dry_mom{k}", lambda: prt.diag_dry_rng(0.0, 1.0),
             lambda: prt.diag_dry_mom(k))
        take(f"wet_mom{k}", lambda: prt.diag_wet_rng(1e-6, 1.0),
             lambda: prt.diag_wet_mom(k))
    take("precip", prt.diag_all, prt.diag_precip_rate)
    for name in ("RH", "pressure", "temperature", "max_rw"):
        prt.diag_all()
        getattr(prt, f"diag_{name}")()
        out[name] = np.array(prt.outbuf())
    out["puddle"] = np.array(list(prt.diag_puddle().values()))
    return out


def _compare(jprt, pprt, rtol_m, rw2=_rw2_close):
    for a in ATTRS:
        got, want = pprt.get_attr(a), np.asarray(jprt.get_attr(a))
        assert got.shape == want.shape, a
        if a in ("rw2", "vt"):          # vt is a function of rw2
            rw2(got, want)
        elif a == "n":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=a)
    dj, dp = _diags(jprt), _diags(pprt)
    assert dj.keys() == dp.keys()
    for k in dj:
        np.testing.assert_allclose(dp[k], dj[k], rtol=rtol_m, err_msg=k,
                                   atol=1e-300)
    assert dp["sd_conc"].sum() > 0 and dp["wet_mom3"].sum() > 0


def test_init_matches_jax(inited):
    jm, pm = inited
    exact = lambda got, want: np.testing.assert_allclose(got, want,
                                                         rtol=1e-13)
    _compare(jm.prtcls, pm.prtcls, 1e-13, rw2=exact)
    np.testing.assert_array_equal(pm.prtcls.state.ijk.numpy(),
                                  np.asarray(jm.prtcls.state.ijk))


def test_steps_match_jax(stepped):
    jm, pm, j, p = stepped
    for (jth, jrv), (pth, prv) in zip(j, p):
        np.testing.assert_allclose(pth, jth, rtol=1e-12)
        np.testing.assert_allclose(prv, jrv, rtol=1e-12)
    _compare(jm.prtcls, pm.prtcls, 1e-9)
    np.testing.assert_array_equal(pm.prtcls.state.ijk.numpy(),
                                  np.asarray(jm.prtcls.state.ijk))
    assert pm.prtcls.diag_puddle()["particle_number"] >= 0.0


def test_numpy_and_tensor_abis_agree():
    """The same steps through the numpy write-back ABI and the tensor
    ABI give the same fields and the same population."""
    a, b = (Kinematic2D(**KW, **F64) for _ in range(2))
    rhod = a.rhod.numpy()
    out_a = _drive(a.prtcls, rhod, _opts(tl), 2)
    out_b = _drive(b.prtcls, rhod, _opts(tl), 2, tensors=True)
    for (tha, rva), (thb, rvb) in zip(out_a, out_b):
        np.testing.assert_array_equal(tha, thb)
        np.testing.assert_array_equal(rva, rvb)
    for k in ("n", "rw2", "x", "z", "vt", "ijk", "th", "rv"):
        assert torch.equal(getattr(a.prtcls.state, k),
                           getattr(b.prtcls.state, k)), k


def _messages(pkg, make, rhod, th, rv):
    """The errors a fixed misuse sequence raises, in order."""
    msgs = []

    def expect(fn, *args):
        try:
            fn(*args)
        except (RuntimeError, ValueError) as e:
            msgs.append(f"{type(e).__name__}: {e}")
        else:
            msgs.append("no error")

    prt = make()
    opts = pkg.opts_t()
    opts.coal = False
    expect(prt.step_sync, opts, th, rv, rhod)
    expect(prt.step_async, opts)
    expect(prt.diag_RH)
    prt.init(th.copy(), rv.copy(), rhod)
    expect(prt.init, th.copy(), rv.copy(), rhod)
    expect(prt.step_async, opts)
    expect(prt.step_cond, opts)
    expect(prt.diag_wet_mom, 3)
    prt.sync_in(th=th.copy(), rv=rv.copy())
    expect(prt.sync_in, th.copy())
    bad = pkg.opts_t()
    bad.dt = 0.5
    expect(prt.step_cond, bad)
    prt.sync_in()
    prt.step_cond(opts, th.copy(), rv.copy())
    expect(prt.step_sync, opts, th.copy(), rv.copy())
    coal = pkg.opts_t()
    coal.turb_coal = True
    expect(prt.step_async, coal)
    prt.sync_in()
    prt.step_cond(opts)
    expect(prt.step_async, coal)
    expect(prt.get_attr, "nonsense")
    expect(prt.get_attr, "ice_a")
    expect(prt.sync_in, th.copy()[:3])
    return msgs


def test_call_order_errors_match_jax():
    def oi(pkg):
        o = pkg.opts_init_t()
        o.nx, o.nz, o.dx, o.dz, o.x1, o.z1 = 4, 4, 100.0, 100.0, 400.0, 400.0
        o.dt, o.sd_conc, o.n_sd_max = 1.0, 4, 4 * 16
        o.dry_distros = {(0.61, 0.0): lambda lnr: 1e8 * np.exp(
            -(lnr - np.log(5e-8)) ** 2 / 0.5)}
        o.terminal_velocity = pkg.vt_t.beard77fast
        return o

    rng = np.random.default_rng(1)
    th = np.full(16, 290.0) + rng.normal(0, 0.1, 16)
    rv = np.full(16, 7e-3)
    rhod = np.full(16, 1.1)
    want = _messages(jl, lambda: jl.particles_t(jl.backend_t.serial, oi(jl)),
                     rhod, th, rv)
    got = _messages(tl, lambda: factory(tl.backend_t.serial, oi(tl), **F64),
                    rhod, th, rv)
    assert got == want
    assert sum(m != "no error" for m in got) >= 12


def test_save_load_restores_state_and_draws(tmp_path):
    """save() after a step, two coalescing steps, load() into a new
    engine and the same two steps: the same numbers, draws included."""
    a = Kinematic2D(**KW_COAL, **F64)
    a.run(1, spinup=1)
    path = tmp_path / "ckpt.npz"
    a.prtcls.save(path)
    a.run(2)
    b = Kinematic2D(**KW_COAL, **F64)
    b.prtcls.load(path)
    b.th = b.prtcls.state.th.reshape(b.nx, b.nz)
    b.rv = b.prtcls.state.rv.reshape(b.nx, b.nz)
    b.run(2)
    for k in ("n", "rw2", "rd3", "x", "z", "th", "rv", "puddle"):
        assert torch.equal(getattr(a.prtcls.state, k),
                           getattr(b.prtcls.state, k)), k
    assert b.prtcls.state.rng_step == a.prtcls.state.rng_step == 2
    assert float(a.prtcls.state.n.sum()) < float(
        Kinematic2D(**KW_COAL, **F64).prtcls.state.n.sum())


def test_slice_run_matches_jax_run():
    """Kinematic2D.run(): MPDATA one field at a time, then step_sync and
    step_async with the fields as device tensors, two spin-up and two
    sedimenting steps without coalescence, against JAX's run()."""
    jm = JaxKinematic2D(micro="lgrngn", **KW)
    pm = Kinematic2D(**KW, **F64)
    jm.run(4, spinup=2)
    pm.run(4, spinup=2)
    np.testing.assert_allclose(pm.th.numpy(), jm.th, rtol=1e-12)
    np.testing.assert_allclose(pm.rv.numpy(), jm.rv, rtol=1e-12)
    _compare(jm.prtcls, pm.prtcls, 1e-9)
    assert pm.t == jm.t == 4.0


def _totals(prt, rv):
    """bench.py's water mass and dry volume, through get_attr and
    diag_puddle."""
    n, rw2, rd3 = (prt.get_attr(k) for k in ("n", "rw2", "rd3"))
    pud = prt.diag_puddle()
    st = prt.state
    vap = float((st.rhod * st.dv * rv.reshape(-1)).sum())
    liq = 4 / 3 * c.pi * c.rho_w * (np.sum(n * rw2 ** 1.5)
                                    + 3 / (4 * c.pi) * pud["liquid_volume"])
    return vap + liq, np.sum(n * rd3) + pud["dry_volume"] / (4 / 3 * c.pi)


def test_coal_slice_physics_and_paths_agree():
    """With coalescence: bench.py's checks through the public API,
    collisions, and run_device_lgrngn(engine="flat") equal to the stepwise
    run() from the same state, and the draws advance once a main step."""
    m = Kinematic2D(**KW_COAL, **F64)
    water0, dry0 = _totals(m.prtcls, m.rv)
    n0 = float(m.prtcls.state.n.sum())
    m.run(2, spinup=2)
    start = (m.prtcls.state, m.th, m.rv)
    m.run(2)
    st = m.prtcls.state
    assert st.rng_step == 2
    water, dry = _totals(m.prtcls, m.rv)
    assert abs(water - water0) / water0 < 1e-3
    assert abs(dry - dry0) / dry0 < 1e-4
    fell = m.prtcls.diag_puddle()["particle_number"]
    assert n0 - float(st.n.sum()) - fell > 0          # collisions
    assert ((m.th > 250) & (m.th < 350)).all() and (m.rv > 0).all()
    alive = st.n > 0
    assert (st.rw2[alive] > 0).all() and float(st.rw2.max()) < 25e-6
    m.prtcls.state, m.th, m.rv = start
    m.run_device_lgrngn(2)
    dev = m.prtcls.state
    for k in ("n", "rw2", "rd3", "x", "z", "ijk", "th", "rv"):
        assert torch.equal(getattr(dev, k), getattr(st, k)), k


def test_dense_run_writes_the_population_back():
    """run_device_lgrngn(engine="dense") leaves the flat engine holding the
    dense population: the same SDs per cell, th/rv, the puddle and the
    draws, so the diagnostics read the current state; the next dense run
    continues from the same dense state."""
    m = Kinematic2D(**KW_COAL, **F64)
    m.run_device_lgrngn(3, spinup=1, engine="dense")
    d, st = m.dense_state, m.prtcls.state
    assert d is m.dense_state                   # no repack while unchanged
    counts = torch.bincount(st.ijk[st.n > 0], minlength=64)
    assert torch.equal(counts, (d.n > 0).sum(1))
    assert torch.equal(st.th, m.th.reshape(-1))
    assert st.rng_step == d.rng_step == 2
    assert torch.equal(st.puddle, d.puddle)
    m.prtcls.diag_all()
    m.prtcls.diag_wet_mom(3)
    assert m.prtcls.outbuf().sum() > 0
    np.testing.assert_allclose(
        sorted(st.rw2[st.n > 0].tolist()), sorted(d.rw2[d.n > 0].tolist()))


def test_defaults_and_refusals(monkeypatch):
    """The entry points run on the card unless asked for the CPU (and
    raise without one); the unported paths raise NotImplementedError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Kinematic2D(nx=4, nz=4, sd_conc=2)
    oi = Kinematic2D(nx=4, nz=4, sd_conc=2, **F64).opts_init
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory(tl.backend_t.CUDA, oi)
    for over, match in (({"dev_count": 2}, "Multi-device"),
                        ({"ice_switch": True}, "ice_switch"),
                        ({"turb_cond_switch": True}, "turb_cond_switch"),
                        ({"chem_switch": True}, "chem_switch"),
                        ({"diag_incloud_time": True}, "diag_incloud_time"),
                        ({"turb_adve_switch": True},
                         "turb_adve_switch.*remaining features")):
        o = _copy(oi, **over)
        with pytest.raises(NotImplementedError, match=match):
            factory(tl.backend_t.CUDA, o, **F64)
    m = Kinematic2D(nx=4, nz=4, sd_conc=2, **F64)
    for name in ("src", "rlx", "rcyc"):
        opts = tl.opts_t()
        setattr(opts, name, True)
        m.prtcls.step_sync(opts, m.th, m.rv)
        with pytest.raises(NotImplementedError, match=f"opts.{name}"):
            m.prtcls.step_async(opts)
    with pytest.raises(ValueError, match="engine"):
        m.run_device_lgrngn(1, engine="multi")


def _copy(oi, **over):
    o = tl.opts_init_t()
    o.__dict__.update(oi.__dict__)
    o.__dict__.update(over)
    return o
