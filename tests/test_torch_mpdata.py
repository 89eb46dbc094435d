"""Port parity: MPDATA advection (libcloudphxx_tpu_torch.models.mpdata)
against libcloudphxx_tpu.models.mpdata on the CPU.

A 12x10 grid with the GMD-2015 courants of make_gc (the port's copy of it
too), a seeded positive field with exact zeros (clear air, where the ratio
guard's zero test matters), n_iters 1-3, FCT on and off.  JAX runs the
same _advect_body on the CPU that its TPU kernel runs.  Tolerances: rtol
1e-12 at float64, 1e-5 at float32 (sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from libcloudphxx_tpu.models import kinematic_2d as jk
from libcloudphxx_tpu.models import mpdata as jmp
from libcloudphxx_tpu_torch.models import kinematic_2d as tk
from libcloudphxx_tpu_torch.models import mpdata as tmp

NX, NZ = 12, 10


def _fields():
    s = jk.Setup()
    dx, dz = s.X / NX, s.Z / NZ
    gc_x, gc_z = jk.make_gc(s, NX, NZ, dx, dz)
    px, pz = tk.make_gc(tk.Setup(), NX, NZ, dx, dz)
    np.testing.assert_array_equal(px, gc_x)
    np.testing.assert_array_equal(pz, gc_z)
    rng = np.random.default_rng(12)
    G = 1.0 + 0.2 * rng.random((NX, NZ))
    a = rng.uniform(0.5, 2.0, (NX, NZ))
    a[3:6, 4:7] = 0.0  # clear air: exact zeros
    b = 290.0 + rng.normal(0.0, 1.0, (NX, NZ))
    # courants scaled so the field moves by a good part of a cell
    return a, b, 4.0 * gc_x, 4.0 * gc_z, G


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_advect2_matches_jax(n_iters, fct, dtype):
    a, b, gc_x, gc_z, G = _fields()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jmp.advect2(*(jnp.asarray(v, jdt) for v in (a, b, gc_x, gc_z, G)),
                       n_iters=n_iters, fct=fct)
    got = tmp.advect2(*(t(v, tdt) for v in (a, b, gc_x, gc_z, G)),
                      n_iters=n_iters, fct=fct)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("fct", [False, True])
def test_advect_matches_jax(fct):
    a, _, gc_x, gc_z, G = _fields()
    want = jmp.advect(*map(jnp.asarray, (a, gc_x, gc_z, G)), n_iters=2,
                      fct=fct)
    got = tmp.advect(*map(t, (a, gc_x, gc_z, G)), n_iters=2, fct=fct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_advect_conserves_mass():
    """Divergence-free courants, periodic x, closed z: sum(G psi) is kept."""
    a, _, gc_x, gc_z, G = _fields()
    out = tmp.advect(*map(t, (a, gc_x, gc_z, G)), n_iters=3, fct=True)
    np.testing.assert_allclose(float((t(G) * out).sum()), float((G * a).sum()),
                               rtol=1e-12)


@pytest.mark.parametrize("fct", [False, True])
@pytest.mark.parametrize("nx,nz", [(1, 4), (3, 10), (5, 7), (12, 10), (16, 3),
                                   (17, 5), (76, 76), (77, 76), (200, 40),
                                   (1000, 8)])
def test_launch_plan_covers_the_grid(nx, nz, fct):
    """Kernel A's plan: every column owned by exactly one CTA, slabs
    contiguous and none empty, at most 16 CTAs and never more than nx, and
    the shared memory a CTA needs (its slab and a halo column a side)
    under the limit."""
    plan = tmp.launch_plan(nx, nz, fct)
    assert 1 <= plan.ctas <= min(tmp.MAX_CLUSTER, nx)
    slabs = [range(q * plan.cols, min(nx, (q + 1) * plan.cols))
             for q in range(plan.ctas)]
    assert all(len(s) > 0 for s in slabs)
    owned = [i for s in slabs for i in s]
    assert owned == list(range(nx))          # contiguous, each column once
    assert all(len(s) == plan.cols for s in slabs[:-1])
    cols = plan.cols + 2
    words = (5 if fct else 3) * cols * nz + 2 * (plan.cols + 1) * nz \
        + 2 * cols * (nz + 1)
    assert plan.smem == 4 * words <= tmp.SMEM_LIMIT
    small = tmp.launch_plan(nx, nz, fct, max_cluster=8)
    assert small.ctas <= min(8, nx) and small.cols >= plan.cols


def test_launch_plan_refuses_a_grid_that_does_not_fit():
    """A z extent so deep that one column and its halo overflow a CTA's
    shared memory: the error names what a CTA needs."""
    with pytest.raises(ValueError, match=r"bytes of shared memory a CTA"):
        tmp.launch_plan(64, 4000, True)
    tmp.launch_plan(64, 1000, True)          # still fits


def test_advect_refuses_other_devices():
    a, _, gc_x, gc_z, G = _fields()
    meta = lambda v: torch.empty(np.shape(v), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tmp.advect(*map(meta, (a, gc_x, gc_z, G)))
