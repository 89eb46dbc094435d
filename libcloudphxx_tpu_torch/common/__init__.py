"""Common physics shared by the port's schemes: the functions of
libcloudphxx_tpu/common/ that the port's schemes call, written on
torch tensors.  Every function is elementwise and keeps the dtype of its
tensor arguments (float64 for the parity tests, float32 on the card)."""

from . import (
    chem,
    const_cp,
    constants,
    fastmath,
    hydrostatic,
    ice_nucleation,
    kappa_koehler,
    kelvin,
    lognormal,
    maxwell_mason,
    mean_free_path,
    moist_air,
    tetens,
    theta_dry,
    theta_std,
    transition_regime,
    ventil,
    vterm,
)

__all__ = [
    "chem",
    "const_cp",
    "constants",
    "fastmath",
    "hydrostatic",
    "ice_nucleation",
    "kappa_koehler",
    "kelvin",
    "lognormal",
    "maxwell_mason",
    "mean_free_path",
    "moist_air",
    "tetens",
    "theta_dry",
    "theta_std",
    "transition_regime",
    "ventil",
    "vterm",
]
