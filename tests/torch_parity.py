"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Each test makes its inputs from a numpy seed and hands the same arrays to
the JAX package and to the port (libcloudphxx_tpu_torch) on the CPU, where
the port runs the plain PyTorch version of every kernel.  JAX runs with
x64 on (conftest.py), so float32 cases cast explicitly on both sides.

The suite runs in several pytest-xdist worker processes, so each keeps
PyTorch to two threads.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)


def t(a, dtype=torch.float64):
    """numpy / JAX array -> CPU tensor of ``dtype`` (a copy: JAX hands out
    read-only buffers)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def port_cfg(jax_cfg):
    """The port's StaticConfig for a JAX StaticConfig."""
    from libcloudphxx_tpu_torch.convert import static_config_from_numpy
    return static_config_from_numpy(dataclasses.asdict(jax_cfg))


def port_state(jax_dense, dtype=torch.float64):
    """The port's DenseState (CPU) for a JAX DenseState."""
    from libcloudphxx_tpu_torch.convert import dense_state_from_numpy
    arrays = {f.name: np.asarray(getattr(jax_dense, f.name))
              for f in dataclasses.fields(jax_dense)}
    return dense_state_from_numpy(arrays, "cpu", dtype)


def port_shuffle(seed, step, substep, n):
    """The port's shuffle of one coalescence substep (ops/coal.py) as a
    numpy gather index: row r's lane j takes the SD of lane perm[r, j]."""
    from libcloudphxx_tpu_torch.ops import coal, philox
    n = np.asarray(n)
    bits = philox.draw(seed, step, substep, philox.SHUFFLE, *n.shape)
    key = coal.shuffle_key(bits, torch.tensor(n > 0))
    return torch.sort(key, dim=1).indices.numpy()


def port_u01(seed, step, substep, shape):
    """The port's Bernoulli plane of one coalescence substep, float64."""
    from libcloudphxx_tpu_torch.ops import philox
    bits = philox.draw(seed, step, substep, philox.BERNOULLI, *shape)
    return philox.u01(bits, torch.float64).numpy()


def jax_coal_loop(cfg, params, sstp, dt, seed, step, planes, cells,
                  pairing="stride", eff_table=None, r_max_um=0.0):
    """The coalescence phase of the resident step (pallas_step.py:233-336)
    built from the JAX package's functions, fed the port's shuffles and
    Bernoulli planes.  ``planes`` (n, rw2, rd3, kpa, x, z) and ``cells``
    (T, p, rhod, eta, dv) numpy; returns the planes."""
    import jax.numpy as jnp

    from libcloudphxx_tpu.lgrngn import dense as jdense
    from libcloudphxx_tpu.ops.pallas_coal import _vt_in_kernel
    T, p, rhod, eta, dv = (jnp.asarray(a)[:, None] for a in cells)
    jp = jnp.asarray(params, jnp.float64)
    kw = dict(eff_table=eff_table, r_max_um=r_max_um)
    vt_of = lambda rw2: _vt_in_kernel(cfg, rw2, T, p, rhod, eta)
    take = lambda perm, *a: tuple(np.take_along_axis(np.asarray(v), perm, 1)
                                  for v in a)
    n, rw2, rd3, kpa, x, z = planes
    dt_sub = dt / sstp
    if pairing == "stride":
        n_strides = 1          # pallas_step.py:252-255
        while (1 << n_strides) <= n.shape[1] // 4 and n_strides < 6:
            n_strides += 1
        for s in range(sstp):
            if s % n_strides == 0:
                n, rw2, rd3, kpa, x, z = take(
                    port_shuffle(seed, step, s, n), n, rw2, rd3, kpa, x, z)
            n, rw2, rd3, kpa, _ = jdense.pair_and_collide_stride(
                cfg, jp, (n, rw2, rd3, kpa, vt_of(jnp.asarray(rw2))),
                1 << (s % n_strides), dv, rhod, eta, dt_sub,
                port_u01(seed, step, s, n.shape), **kw)
    else:
        ids = np.broadcast_to(np.arange(n.shape[1]), n.shape)
        for s in range(sstp):
            n, rw2, rd3, kpa, ids = take(port_shuffle(seed, step, s, n), n,
                                         rw2, rd3, kpa, ids)
            count = (n > 0).sum(1, keepdims=True).astype(float)
            n, rw2, rd3, kpa, _ = jdense.pair_and_collide(
                cfg, jp, (n, rw2, rd3, kpa, vt_of(jnp.asarray(rw2))), count,
                dv, rhod, eta, dt_sub, port_u01(seed, step, s, n.shape),
                **kw)
        n, rw2, rd3, kpa = take(np.argsort(ids, axis=1), n, rw2, rd3, kpa)
    return tuple(np.asarray(a) for a in (n, rw2, rd3, kpa, x, z))


def multiset(n, planes):
    """Alive SDs of an (n_cell, cap) layout as sorted rows
    (cell, n, *planes): the per-cell multiset, whatever the lane order.
    Put a per-droplet constant (rd3) first among ``planes`` so that rows
    pair up droplet by droplet."""
    n = np.asarray(n)
    cap = n.shape[1]
    alive = n.reshape(-1) > 0
    cols = [np.repeat(np.arange(n.shape[0]), cap)[alive],
            n.reshape(-1)[alive]] \
        + [np.asarray(p).reshape(-1)[alive] for p in planes]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], 1)


def port_flat_state(jax_state, dtype=torch.float64):
    """The port's flat State (CPU) for a JAX State; the draws start from
    the config's seed (convert.state_from_numpy)."""
    from libcloudphxx_tpu_torch.convert import state_from_numpy
    arrays = {f.name: np.asarray(getattr(jax_state, f.name))
              for f in dataclasses.fields(jax_state)}
    return state_from_numpy(arrays, "cpu", dtype)
