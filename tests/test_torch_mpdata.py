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


def test_advect_refuses_other_devices():
    a, _, gc_x, gc_z, G = _fields()
    meta = lambda v: torch.empty(np.shape(v), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tmp.advect(*map(meta, (a, gc_x, gc_z, G)))
