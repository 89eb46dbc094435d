"""The Lagrangian super-droplet scheme (libcloudphxx_tpu/lgrngn): the
public particles_t API over the flat engine, and the dense cell-major
engine of the kinematic model's fast path."""

from .enums import RH_formula_t, as_t, backend_t, kernel_t, src_t, vt_t
from .opts import opts_init_t, opts_t
from .particles import factory, particles_t
from .state import State, StaticConfig

__all__ = ["RH_formula_t", "as_t", "backend_t", "kernel_t", "src_t",
           "vt_t", "opts_init_t", "opts_t", "factory", "particles_t",
           "State", "StaticConfig"]
