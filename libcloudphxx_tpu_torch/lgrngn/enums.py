"""Enumerations of the lgrngn public API — a copy of
libcloudphxx_tpu/lgrngn/enums.py, which is pure Python (importing it from
the JAX package would load jax).

Reference: include/libcloudph++/lgrngn/{backend,kernel,terminal_velocity,
advection_scheme,RH_formula,ccn_source}.hpp.  ``backend_t`` keeps the
reference's names for source compatibility; the port places tensors on the
device its caller names.
"""

import enum


class backend_t(enum.Enum):
    """(reference backend.hpp:8)"""
    serial = 0
    OpenMP = 1
    CUDA = 2
    multi_CUDA = 3
    # the native execution target of this library
    tpu = 10


class kernel_t(enum.Enum):
    """Coalescence kernels (reference kernel.hpp:8)."""
    undefined = 0
    geometric = 1
    golovin = 2
    hall = 3
    hall_davis_no_waals = 4
    long = 5
    onishi_hall = 6
    onishi_hall_davis_no_waals = 7
    hall_pinsky_1000mb_grav = 8
    hall_pinsky_cumulonimbus = 9
    hall_pinsky_stratocumulus = 10
    vohl_davis_no_waals = 11


class vt_t(enum.Enum):
    """Terminal-velocity formulas (reference terminal_velocity.hpp:8)."""
    undefined = 0
    beard76 = 1
    beard77 = 2
    beard77fast = 3
    khvorostyanov_spherical = 4
    khvorostyanov_nonspherical = 5


class as_t(enum.Enum):
    """SD advection schemes (reference advection_scheme.hpp:8)."""
    implicit = 0
    euler = 1
    pred_corr = 2


class RH_formula_t(enum.Enum):
    """(reference RH_formula.hpp:8-12)"""
    pv_cc = 0    # RH = p_v / p_vs with Clausius-Clapeyron
    rv_cc = 1    # RH = r_v / r_vs with Clausius-Clapeyron
    pv_tet = 2   # RH = p_v / p_vs with Tetens
    rv_tet = 3   # RH = r_v / r_vs with Tetens


class src_t(enum.Enum):
    """CCN source types (reference ccn_source.hpp:8)."""
    off = 0
    simple = 1
    matching = 2
