"""Carry state between the JAX package and the port, through numpy.

The tests feed one state to both packages: the JAX side hands over its
StaticConfig fields and its flat State or DenseState arrays as plain
Python values and numpy arrays (``dataclasses.asdict`` +
``numpy.asarray``), so this module imports nothing of JAX.

The bulk schemes' state is the model's fields (bulk_fields_from_numpy,
bulk_fields_to_numpy): th, rv, rc, rr (and blk_2m's nc, nr) and the
accumulated surface flux puddle_flux.

The random streams do not carry over: the JAX state's ``key`` is a JAX
PRNG key, while the port draws Philox numbers from a seed and a step
counter (ops/philox.py).  A state converted from JAX is seeded from the
configuration (opts_init.rng_seed) at step 0; the port's own arrays carry
``rng_seed`` and ``rng_step`` and restore both.
"""

import dataclasses

import numpy as np
import torch

from .lgrngn.dense import ATTRS, EXACT_ATTRS, Y_ATTRS, DenseState
from .lgrngn.state import TENSOR_FIELDS, State, StaticConfig
from .models.kinematic_2d import BULK_FIELDS

# JAX DenseState fields the port's dense engine does not hold: they must be
# empty (it has no deferred x pass) or are the JAX RNG key
_EMPTY = ("xkey",)
# the planes and cell fields it holds where they are not empty: the exact
# mode's private planes, and the 3-D grid's y plane and courant_y
_OPTIONAL = EXACT_ATTRS + Y_ATTRS + ("courant_y",)
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


def dense_state_from_numpy(arrays: dict, device, dtype,
                           rng_seed=44) -> DenseState:
    """A port DenseState from the JAX DenseState's arrays as numpy, the
    exact mode's private planes (sd_th, sd_rv, sd_rh, sd_p) and the 3-D
    grid's y plane and courant_y where the arrays hold them, else empty.  The coalescence draws are keyed by
    ``arrays["rng_seed"]`` where the arrays came from the port, else by
    ``rng_seed`` (opts_init.rng_seed), and continue from
    ``arrays["rng_step"]`` (else step 0)."""
    for k in _EMPTY:
        if k in arrays and np.asarray(arrays[k]).size:
            raise NotImplementedError(
                f"dense_state_from_numpy: {k} is not held by the port")
    # a copy: JAX hands out read-only buffers
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return DenseState(
        **{k: t(arrays[k]) for k in ATTRS + _CELLS},
        **{k: t(arrays[k]) for k in _OPTIONAL
           if k in arrays and np.asarray(arrays[k]).size},
        overflow=torch.as_tensor(int(np.asarray(arrays["overflow"])),
                                 dtype=torch.int64, device=device),
        rng_seed=int(arrays.get("rng_seed", rng_seed)),
        rng_step=int(arrays.get("rng_step", 0)))


def dense_state_to_numpy(d: DenseState) -> dict:
    """The DenseState's arrays as numpy, under the JAX DenseState's names
    (the private planes (0, 0) outside exact mode and y off the 3-D grid,
    as JAX's), and its random stream as ``rng_seed`` and ``rng_step``."""
    out = {k: getattr(d, k).detach().cpu().numpy()
           for k in ATTRS + _CELLS + _OPTIONAL}
    out["overflow"] = np.asarray(int(d.overflow))
    out["rng_seed"] = np.asarray(d.rng_seed)
    out["rng_step"] = np.asarray(d.rng_step)
    return out


def state_from_numpy(arrays: dict, device, dtype, rng_seed=44) -> State:
    """A port flat State from the JAX State's arrays as numpy, the
    substepping snapshot (sstp_tmp_*) per cell, or per SD with sstp_tmp_p
    in exact_sstp_cond mode, as the arrays hold it, with the ice attributes
    and the chemistry's rows (zero-width when chem_switch is off).  The
    coalescence draws are keyed by ``arrays["rng_seed"]`` where the arrays
    came from the port, else by ``rng_seed`` (opts_init.rng_seed), and
    continue from ``arrays["rng_step"]`` (else step 0)."""
    t = lambda a, dt=dtype: torch.tensor(np.asarray(a), dtype=dt,
                                         device=device)
    return State(
        **{k: t(arrays[k], torch.int64 if k == "ijk" else dtype)
           for k in TENSOR_FIELDS},
        rng_seed=int(arrays.get("rng_seed", rng_seed)),
        rng_step=int(arrays.get("rng_step", 0)))


def state_to_numpy(st: State) -> dict:
    """The State's arrays as numpy, under the JAX State's names, and its
    random stream as ``rng_seed`` and ``rng_step``."""
    out = {k: getattr(st, k).detach().cpu().numpy() for k in TENSOR_FIELDS}
    out["rng_seed"] = np.asarray(st.rng_seed)
    out["rng_step"] = np.asarray(st.rng_step)
    return out


def bulk_fields_from_numpy(arrays: dict, device, dtype) -> dict:
    """The bulk fields of a kinematic model (a JAX Kinematic2D's
    attributes as numpy) as {name: tensor} for each of th, rv, rc, rr, nc,
    nr the arrays hold, and ``puddle_flux`` as a float where they hold it:
    set each on the port's Kinematic2D (``setattr``) to start it from that
    state."""
    out = {k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                           device=device)
           for k in BULK_FIELDS["blk_2m"] if k in arrays}
    if "puddle_flux" in arrays:
        out["puddle_flux"] = float(arrays["puddle_flux"])
    return out


def bulk_fields_to_numpy(model) -> dict:
    """A bulk-scheme Kinematic2D's fields (th, rv, rc, rr, and for blk_2m
    nc, nr) as numpy, and its ``puddle_flux``."""
    out = {k: getattr(model, k).detach().cpu().numpy()
           for k in BULK_FIELDS[model.micro]}
    out["puddle_flux"] = model.puddle_flux
    return out
