"""Carry state between the JAX package and the port, through numpy.

The tests feed one state to both packages: the JAX side hands over its
StaticConfig fields and DenseState arrays as plain Python values and numpy
arrays (``dataclasses.asdict`` + ``numpy.asarray``), so this module
imports nothing of JAX.
"""

import dataclasses

import numpy as np
import torch

from .lgrngn.dense import ATTRS, DenseState
from .lgrngn.state import StaticConfig

# JAX DenseState fields the port does not hold: they must be empty (2-D,
# no deferred x pass, no per-SD ambient copies) or are the JAX RNG key
_EMPTY = ("y", "courant_y", "xkey", "sd_th", "sd_rv", "sd_rh", "sd_p")
_CELLS = ("rhod", "p", "T", "RH", "eta", "dv", "sstp_tmp_th", "sstp_tmp_rv",
          "courant_x", "courant_z", "puddle")


def static_config_from_numpy(fields: dict) -> StaticConfig:
    """The port's StaticConfig from the JAX StaticConfig's fields."""
    names = [f.name for f in dataclasses.fields(StaticConfig)]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"static_config_from_numpy: missing {missing}")
    return StaticConfig(**{k: fields[k].item() if isinstance(
        fields[k], np.generic) else fields[k] for k in names})


def dense_state_from_numpy(arrays: dict, device, dtype) -> DenseState:
    """A port DenseState from the JAX DenseState's arrays as numpy."""
    for k in _EMPTY:
        if k in arrays and np.asarray(arrays[k]).size:
            raise NotImplementedError(
                f"dense_state_from_numpy: {k} is not held by the port")
    # a copy: JAX hands out read-only buffers
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return DenseState(
        **{k: t(arrays[k]) for k in ATTRS + _CELLS},
        overflow=torch.as_tensor(int(np.asarray(arrays["overflow"])),
                                 dtype=torch.int64, device=device))


def dense_state_to_numpy(d: DenseState) -> dict:
    """The DenseState's arrays as numpy, under the JAX DenseState's names."""
    out = {k: getattr(d, k).detach().cpu().numpy() for k in ATTRS + _CELLS}
    out["overflow"] = np.asarray(int(d.overflow))
    return out
