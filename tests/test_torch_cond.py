"""Port parity: the per-droplet implicit condensation step
(libcloudphxx_tpu_torch.lgrngn.condensation) against
libcloudphxx_tpu.lgrngn.condensation on the CPU.

A seeded population of haze, activating and cloud droplets in cells from
sub- to supersaturated, with a few dead slots.  Tolerances: rtol 1e-12 at
float64 (32 root-find iterations on both sides).  At float32 (12
iterations) rtol 1e-5 for 99% of the droplets, the last-ulp spread of a
root find that the JAX package itself shows between its interpreter and
XLA paths; the rest are droplets evaporating by an order of magnitude in
one step, whose root find has not converged in 12 float32 iterations on
either side, and there the two libraries' float32 transcendentals (XLA's
and PyTorch's) steer it differently: rtol 1e-2 (the reference's own
float32 root-find tolerance is 2^-7, src/detail/config.hpp:181-205).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from libcloudphxx_tpu.lgrngn import condensation as jcond
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond

N = 2048


def _population():
    rng = np.random.default_rng(2015)
    u = lambda lo, hi: rng.uniform(lo, hi, N)
    rd3 = np.exp(u(np.log(1e-24), np.log(1e-19)))
    rw2 = rd3 ** (2 / 3) * np.exp(u(0.0, 10.0))
    rw2[::97] = 0.0  # dead slots
    T = u(270.0, 295.0)
    p = u(8e4, 1.01e5)
    rhod = p / (287.0 * T)
    return dict(rw2=rw2, rd3=rd3, kpa=u(0.2, 1.2), vt=u(0.0, 0.5), rhod=rhod,
                rv=u(5e-3, 1.2e-2), T=T, p=p, RH=u(0.9, 1.02),
                eta=u(1.7e-5, 1.8e-5), lam_D=u(5e-8, 8e-8),
                lam_K=u(8e-8, 1.1e-7))


ARGS = ("rw2", "rd3", "kpa", "vt", "rhod", "rv", "T", "p", "RH", "eta",
        "lam_D", "lam_K")


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("RH_max", [1.01, 44.0])
def test_advance_rw2_core_matches_jax(dtype, rtol, RH_max):
    pop = _population()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jcond._advance_rw2_core(
        1.0 / 3, *(jnp.asarray(pop[k], jdt) for k in ARGS),
        jnp.asarray(RH_max, jdt))
    got = tcond._advance_rw2_core(
        1.0 / 3, *(t(pop[k], tdt) for k in ARGS), RH_max)
    assert got.dtype == tdt
    got, want = got.numpy(), np.asarray(want)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        rel = np.abs(got - want) / np.where(want > 0, want, 1.0)
        assert np.mean(rel <= rtol) >= 0.99
        np.testing.assert_allclose(got, want, rtol=1e-2)
    # the step changed something: growth and evaporation both occur
    d = got - pop["rw2"].astype(dtype)
    assert (d > 0).any() and (d < 0).any()


def test_drw2_dt_matches_jax():
    pop = _population()
    alive = pop["rw2"] > 0
    args = [pop[k][alive] for k in ARGS]
    want = jcond.drw2_dt(*map(jnp.asarray, args), 44.0)
    got = tcond.drw2_dt(*map(t, args), 44.0).numpy()
    want = np.asarray(want)
    # near equilibrium the rate is a difference of nearly equal terms, so
    # the error is relative to the population's scale of rates
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dtype,iters", [(torch.float64, 32),
                                         (torch.float32, 12)])
def test_root_iters(dtype, iters):
    assert tcond._root_iters(dtype) == iters == jcond._root_iters(
        jnp.dtype(str(dtype).split(".")[1]))
