"""NaN/Inf sweeps after the step phases (libcloudphxx_tpu/utils/debug.py;
reference src/detail/checknan.hpp), for particles_t(..., debug=True).

The reference wraps every phase in `nancheck(vec, "msg")` transform_reduce
asserts under THRUST_DEBUG.  Here the sweep reads the state's tensors
after each phase: off by default (no cost), and each sweep synchronises
the device.
"""

import torch

# the per-SD / per-cell arrays the reference nanchecks around the step
# phases (particles_step.ipp:114-128: th, rv, courants; coal.ipp:453-456:
# rw2, rd3, vt; cond: rw2, th, rv)
_CHECKED = ("th", "rv", "rhod", "rw2", "rd3", "n", "x", "y", "z", "vt",
            "T", "p", "RH")


def nancheck(arr, msg: str):
    """Raise if ``arr`` (a tensor or an array) holds NaN/Inf (checknan.hpp
    semantics: the blast radius named instead of downstream garbage)."""
    t = torch.as_tensor(arr)
    if t.numel():
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            raise FloatingPointError(
                f"libcloudphxx debug: {bad} non-finite value(s) in {msg}")


def nancheck_state(state, phase: str):
    """Sweep the step-relevant arrays of ``state`` (a flat State or a
    DenseState: what it lacks is skipped) after ``phase``."""
    for name in _CHECKED:
        arr = getattr(state, name, None)
        if not isinstance(arr, torch.Tensor) or arr.numel() == 0:
            continue
        nancheck(arr, f"{name} after {phase}")
