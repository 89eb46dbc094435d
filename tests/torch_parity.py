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
