"""Port parity: the turbulent (onishi) collision kernels on the dense
engine, at dissipation rate 0 as the JAX package's dense engine computes
them in XLA (libcloudphxx_tpu/lgrngn/dense.py:606, :738): the hall
family's efficiency times the Wang et al. 2009 enhancement times the
geometric kernel (libcloudphxx_tpu_torch/lgrngn/dense.py _turb,
lgrngn/coalescence.py kernel_value, ops/coal.py coal_resident_plain, which
kernel E's onishi form reproduces on the card), at float64 on the CPU.

* pair_and_collide_stride and pair_and_collide_partners with
  onishi_hall and onishi_hall_davis_no_waals, kernel_parameters[0] (Wang's
  dissipation rate) on each side of his table's 2.5e-2: the JAX functions
  row by row with the same uniforms (tests/test_torch_coal.py's
  population and gates: n and rd3 exact, rw2 and kappa rtol 1e-12, the
  overflow flags).
* the kernel's value in float32: sqrt(geo^2 + 0) with the square rounded,
  so that it is 0 for the haze pairs whose geo^2 underflows, as the plain
  version computes it and kernel E's onishi form copies.
* bench.py's GMD case cut to 8x8 cells with kernel onishi_hall and
  kernel_parameters [100] (the LES slice's Re_lambda), radii grown x30 so
  that droplets collide: Kinematic2D.run_device_lgrngn(engine="dense")
  against the JAX XLA dense step with its coalescence phase built from the
  JAX pair functions fed the port's draws in the port's lane order
  (torch_parity.jax_coal_loop), stride and sort pairing, th and rv rtol
  1e-10 (tests/test_torch_dense_options.py's gates); and the dense front
  through the public API bitwise equal to run_device_lgrngn
  (tests/test_torch_dense_front.py's check).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_coal import (DT, _cfg, _check_pair, _pair_inputs, _per_row,
                             _tables)
from test_torch_dense_options import _compare, _pack, _xla_loop
from test_torch_kinematic import _port_order
from torch_parity import jax_coal_loop, port_cfg, port_flat_state

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu.lgrngn import coalescence as jcoal
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
from libcloudphxx_tpu_torch import Kinematic2D
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.lgrngn import coalescence as tcoal
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn import kernel_t
from libcloudphxx_tpu_torch.lgrngn.dense_front import (dense_capable,
                                                       particles_dense_t)
from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM

F64 = dict(device="cpu", dtype=torch.float64)
ONISHI = [kernel_t.onishi_hall, kernel_t.onishi_hall_davis_no_waals]
# Wang's table switches at a dissipation rate of 2.5e-2
EPS = [1e-2, 100.0]
T = lambda a: torch.tensor(a)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("kernel", ONISHI, ids=lambda k: k.name)
def test_pair_and_collide_stride_matches_jax(kernel, eps):
    cfg = _cfg(kernel, (eps,))
    vals, (dv, rhod, eta), u01 = _pair_inputs(40, kernel)
    jt, r_max, eff = _tables(kernel)
    jp = jnp.asarray([eps], jnp.float64)

    def ref(planes):
        *v, d, rh, e, u = planes
        return jdense.pair_and_collide_stride(cfg, jp, tuple(v), 2, d, rh, e,
                                              DT, u, eff_table=jt,
                                              r_max_um=r_max)

    ref_rows = _per_row(ref, vals + (dv, rhod, eta, u01), vals[0].shape[0])
    got = tdense.pair_and_collide_stride(
        port_cfg(cfg), (eps,), tuple(map(T, vals)), 2, T(dv), T(rhod),
        T(eta), DT, T(u01), eff)
    _check_pair(got, ref_rows, vals[0])


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("kernel", ONISHI, ids=lambda k: k.name)
def test_pair_and_collide_partners_matches_jax(kernel, eps):
    """Partners from a random perfect matching of each row's lanes."""
    cfg = _cfg(kernel, (eps,))
    vals, (dv, rhod, eta), u01 = _pair_inputs(41, kernel)
    jt, r_max, eff = _tables(kernel)
    rows, cap = vals[0].shape
    rng = np.random.default_rng(42)
    partner = np.empty((rows, cap), int)
    is_a = np.zeros((rows, cap), bool)
    for r in range(rows):
        lanes = rng.permutation(cap).reshape(-1, 2)
        partner[r, lanes[:, 0]], partner[r, lanes[:, 1]] = lanes[:, 1], \
            lanes[:, 0]
        is_a[r, lanes[:, 0]] = True
    parts = tuple(np.take_along_axis(v, partner, 1) for v in vals)
    u_b = np.take_along_axis(u01, partner, 1)
    jp = jnp.asarray([eps], jnp.float64)

    def ref(planes):
        v, q = tuple(planes[:5]), tuple(planes[5:10])
        return jdense.pair_and_collide_partners(
            cfg, jp, v, q, planes[10], *planes[11:14], DT, planes[14],
            planes[15], eff_table=jt, r_max_um=r_max)

    ref_rows = _per_row(ref, vals + parts + (is_a, dv, rhod, eta, u01, u_b),
                        rows)
    got = tdense.pair_and_collide_partners(
        port_cfg(cfg), (eps,), tuple(map(T, vals)), tuple(map(T, parts)),
        T(is_a), T(dv), T(rhod), T(eta), DT, T(u01), T(u_b), eff)
    _check_pair(got, ref_rows, vals[0])


def test_kernel_value_in_float32_keeps_the_underflow():
    """At dissipation rate 0 the onishi value is eff * enh * sqrt(geo^2 +
    0^2); in float32 geo^2 underflows to 0 for a haze pair, and the value
    with it (kernel E's onishi form computes sqrtf(geo * geo) for that)."""
    cfg = port_cfg(_cfg(kernel_t.onishi_hall, (100.0,)))
    f32 = torch.float32
    rng = np.random.default_rng(7)
    # radii of 10 nm - 0.3 mm, a vt of ~2 m/s at 0.3 mm falling as r^2
    rw = torch.tensor(np.exp(rng.uniform(np.log(1e-8), np.log(3e-4),
                                         (2, 4096))), dtype=f32)
    n = torch.tensor(10.0 ** rng.uniform(0, 3, 4096), dtype=f32)
    vt = torch.tensor(rng.uniform(0.0, 2.0, (2, 4096)), dtype=f32) * (
        rw / 3e-4) ** 2
    rhod, eta = torch.tensor(1.1, dtype=f32), torch.tensor(1.8e-5, dtype=f32)
    eff = tcoal.efficiency(kernel_t.onishi_hall, f32, "cpu")
    got = tcoal.kernel_value(cfg, (100.0,), n, n, rw[0] ** 2, rw[1] ** 2,
                             vt[0], vt[1], n, n, eff, (rhod, eta, 0.0))
    geo = np.pi * n * torch.abs(vt[0] - vt[1]) \
        * (rw[0] ** 2 + rw[1] ** 2 + 2.0 * rw[0] * rw[1])
    want = tcoal.interpolated_efficiency(eff, rw[0], rw[1]) \
        * tcoal.wang_enhancement(rw[0], rw[1], 100.0) * torch.sqrt(geo * geo)
    assert got.dtype == f32
    assert torch.equal(got, want)
    under = (geo > 0) & (geo * geo == 0)
    assert under.any() and not got[under].any()


# ------------------------------------------------- the dense engine's run
KW = dict(nx=8, nz=8, sd_conc=8, n_sd_max=1024, sstp_cond=3, sstp_coal=3)
NT, SPINUP = 5, 2


def _kw(pkg, kernel="onishi_hall"):
    return dict(KW, terminal_velocity=pkg.vt_t.beard77, opts_init_kw=dict(
        kernel=pkg.kernel_t[kernel], kernel_parameters=[100.0]))


def _grown(js, factor=30.0):
    return dataclasses.replace(js, rw2=js.rw2 * factor ** 2)


@pytest.mark.parametrize("pairing", ["stride", "sort"])
def test_run_device_lgrngn_matches_jax_on_port_draws(pairing):
    m = Kinematic2D(**_kw(tl), **F64)
    jm = JaxKinematic2D(micro="lgrngn", **_kw(jl))
    assert dense_capable(m.cfg)          # the factory's pick on the card
    js = _grown(jm.prtcls.state)
    jm.prtcls.state = js
    m.prtcls.state = dataclasses.replace(
        port_flat_state(js), rng_seed=m.prtcls.state.rng_seed, rng_step=0)
    m.coal_pairing = pairing
    before = []
    for i in range(NT):
        before.append(m.dense_state)
        m.run_device_lgrngn(1, spinup=int(i < SPINUP), engine="dense")
    cfg, oi = jm.prtcls.cfg, jm.prtcls.opts_init
    eff = jcoal.load_efficiency_table(jl.kernel_t.onishi_hall)
    planes = ("n", "rw2", "rd3", "kpa", "x", "z")

    def coal_phase(i, d):
        perm = _port_order(d, before[i])
        out = jax_coal_loop(
            cfg, oi.kernel_parameters, m.cfg.sstp_coal, 1.0, oi.rng_seed,
            i - SPINUP,
            tuple(np.take_along_axis(np.asarray(getattr(d, a)), perm, 1)
                  for a in planes),
            tuple(np.asarray(getattr(d, a))
                  for a in ("T", "p", "rhod", "eta", "dv")), pairing,
            eff_table=eff[0], r_max_um=eff[1])
        return dataclasses.replace(
            d, **{a: jnp.asarray(v) for a, v in zip(planes, out)})

    ref = _xla_loop(jm, _pack(jm, before[0].cap), coal_phase, NT)
    _compare(m, *ref, rtol_th=1e-10, rtol_rv=1e-10, rtol_m3=1e-9)
    d = m.dense_state
    lost = float(before[SPINUP].n.sum() - d.n.sum() - d.puddle[OUT_PRTCL_NUM])
    assert lost > 0.0                                 # droplets collided


def test_dense_front_equals_run_device_lgrngn():
    """Kinematic2D.run() through the dense front equals
    run_device_lgrngn(engine="dense") from the same state, bitwise, with
    onishi_hall_davis_no_waals collisions."""
    kw = dict(_kw(tl, "onishi_hall_davis_no_waals"), **F64)
    front = Kinematic2D(engine="dense", **kw)
    fused = Kinematic2D(engine="flat", **kw)
    assert isinstance(front.prtcls, particles_dense_t)
    st = _grown(front.prtcls.state)
    front.prtcls.state = fused.prtcls.state = st
    n0 = float(st.n.sum())
    front.run(5, spinup=2)
    fused.run_device_lgrngn(5, spinup=2, engine="dense")
    assert torch.equal(front.th, fused.th) and torch.equal(front.rv,
                                                           fused.rv)
    a, b = front.dense_state, fused.dense_state
    for k in tdense.ATTRS + ("puddle", "T", "p", "RH", "eta"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert n0 - float(a.n.sum()) - float(a.puddle[OUT_PRTCL_NUM]) > 0.0
