"""Common physics shared by the port's schemes: the functions of
libcloudphxx_tpu/common/ that the kinematic lgrngn path calls, written on
torch tensors.  Every function is elementwise and keeps the dtype of its
tensor arguments (float64 for the parity tests, float32 on the card)."""

from . import (
    const_cp,
    constants,
    fastmath,
    hydrostatic,
    kappa_koehler,
    kelvin,
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
    "const_cp",
    "constants",
    "fastmath",
    "hydrostatic",
    "kappa_koehler",
    "kelvin",
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
