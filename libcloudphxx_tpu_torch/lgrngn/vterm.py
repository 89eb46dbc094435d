"""Terminal velocity of the SD population (libcloudphxx_tpu/lgrngn/vterm.py
and the in-kernel formula of libcloudphxx_tpu/ops/pallas_coal._vt_in_kernel;
reference src/impl/housekeeping/particles_impl_hskpng_vterm.ipp)."""

import dataclasses

import numpy as np
import torch

from ..common import vterm as cv
from .enums import vt_t
from .state import StaticConfig

# beard77fast sea-level vt cache (reference src/detail/config.hpp:207-210 +
# init_vterm.ipp): 10k bins in ln(r)
VT0_BINS = 10000
VT0_LN_R_MIN = float(np.log(0.5e-6))
VT0_LN_R_MAX = float(np.log(3.5e-3))


_VT0 = {}


def _vt0_table(dtype, device):
    """The binned sea-level vt, made once per dtype and device."""
    key = (dtype, str(device))
    if key not in _VT0:
        r = np.exp(np.linspace(VT0_LN_R_MIN, VT0_LN_R_MAX, VT0_BINS))
        _VT0[key] = cv.vt_beard77_v0(torch.from_numpy(r)).to(dtype=dtype,
                                                             device=device)
    return _VT0[key]


def _formula(cfg: StaticConfig, rw, T, p, rhod, eta):
    """The formulas both vt_of and vt_in_kernel compute alike: beard76,
    Khvorostyanov's two, and zeros for ``undefined``; None for beard77
    and beard77fast, where the two differ."""
    formula = vt_t(cfg.terminal_velocity)
    if formula == vt_t.beard76:
        return cv.vt_beard76(rw, T, p, rhod, eta)
    if formula in (vt_t.khvorostyanov_spherical,
                   vt_t.khvorostyanov_nonspherical):
        return cv.vt_khvorostyanov(
            rw, T, rhod, eta,
            spherical=formula == vt_t.khvorostyanov_spherical)
    if formula == vt_t.undefined:
        return torch.zeros_like(rw)
    return None


def vt_of(cfg: StaticConfig, rw2, T, p, rhod, eta):
    """Population terminal velocity by the selected formula, beard77fast
    through the binned sea-level table (reference hskpng_vterm.ipp:37-100).
    Cell fields broadcast against the (n_cell, cap) planes."""
    rw = torch.sqrt(torch.clamp(rw2, min=1e-300))
    v = _formula(cfg, rw, T, p, rhod, eta)
    if v is None and vt_t(cfg.terminal_velocity) == vt_t.beard77:
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * cv.vt_beard77_v0(rw)
    elif v is None:  # beard77fast
        lnr = 0.5 * torch.log(torch.clamp(rw2, min=1e-300))
        pos = (lnr - VT0_LN_R_MIN) / (VT0_LN_R_MAX - VT0_LN_R_MIN)
        idx = torch.clamp((pos * VT0_BINS).to(torch.int64), 0, VT0_BINS - 1)
        vt0 = _vt0_table(rw.dtype, rw.device)[idx]
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * vt0
    return torch.where(rw2 > 0, v, 0.0)


def hskpng_vterm_all(cfg: StaticConfig, state):
    """Recompute vt of every SD of a flat State from its cell's T, p, rhod
    and eta (reference hskpng_vterm_all)."""
    g = lambda a: a[state.ijk]
    return dataclasses.replace(state, vt=vt_of(
        cfg, state.rw2, g(state.T), g(state.p), g(state.rhod), g(state.eta)))


def vt_in_kernel(cfg: StaticConfig, rw2, T, p, rhod, eta):
    """The terminal velocity the step kernels compute (pallas_coal.py:80-96;
    csrc/physics.cuh vt_formula): beard77 and beard77fast both by the
    direct beard77 polynomial, the other formulas as vt_of computes them,
    on the radius of rw2 clamped at 1e-30."""
    rw = torch.sqrt(torch.clamp(rw2, min=1e-30))
    v = _formula(cfg, rw, T, p, rhod, eta)
    if v is None:
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * cv.vt_beard77_v0(rw)
    return torch.where(rw2 > 0, v, 0.0)
