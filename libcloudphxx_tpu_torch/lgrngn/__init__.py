"""The Lagrangian super-droplet scheme (libcloudphxx_tpu/lgrngn), as far
as the kinematic dense path needs it."""

from .enums import RH_formula_t, as_t, kernel_t, vt_t
from .opts import opts_init_t, opts_t

__all__ = ["RH_formula_t", "as_t", "kernel_t", "opts_init_t", "opts_t",
           "vt_t"]
