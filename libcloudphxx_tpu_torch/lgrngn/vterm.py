"""Terminal velocity of the SD population (libcloudphxx_tpu/lgrngn/vterm.py
and the in-kernel formula of libcloudphxx_tpu/ops/pallas_coal._vt_in_kernel;
reference src/impl/housekeeping/particles_impl_hskpng_vterm.ipp)."""

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


def _vt0_table(dtype, device):
    r = np.exp(np.linspace(VT0_LN_R_MIN, VT0_LN_R_MAX, VT0_BINS))
    return cv.vt_beard77_v0(torch.from_numpy(r)).to(dtype=dtype, device=device)


def vt_of(cfg: StaticConfig, rw2, T, p, rhod, eta):
    """Population terminal velocity by the selected formula, beard77fast
    through the binned sea-level table (reference hskpng_vterm.ipp:37-100).
    Cell fields broadcast against the (n_cell, cap) planes."""
    rw = torch.sqrt(torch.clamp(rw2, min=1e-300))
    formula = vt_t(cfg.terminal_velocity)
    if formula == vt_t.beard76:
        v = cv.vt_beard76(rw, T, p, rhod, eta)
    elif formula == vt_t.beard77:
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * cv.vt_beard77_v0(rw)
    elif formula == vt_t.beard77fast:
        lnr = 0.5 * torch.log(torch.clamp(rw2, min=1e-300))
        pos = (lnr - VT0_LN_R_MIN) / (VT0_LN_R_MAX - VT0_LN_R_MIN)
        idx = torch.clamp((pos * VT0_BINS).to(torch.int64), 0, VT0_BINS - 1)
        vt0 = _vt0_table(rw.dtype, rw.device)[idx]
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * vt0
    else:
        raise NotImplementedError(
            f"vt_of: terminal velocity {formula.name} is not ported "
            "(ROADMAP.md, Queue 1)")
    return torch.where(rw2 > 0, v, 0.0)


def require_kernel_vt(cfg: StaticConfig):
    """Raise unless the step kernels compute this config's terminal
    velocity (beard77 or beard77fast)."""
    formula = vt_t(cfg.terminal_velocity)
    if formula not in (vt_t.beard77, vt_t.beard77fast):
        raise NotImplementedError(
            f"step kernels: terminal velocity {formula.name} is not ported "
            "(ROADMAP.md, Queue 1)")


def vt_in_kernel(cfg: StaticConfig, rw2, T, p, rhod, eta):
    """The terminal velocity the step kernels compute: beard77 and
    beard77fast both by the direct beard77 polynomial (pallas_coal.py:80-96;
    csrc/physics.cuh vt_beard77).  Other formulas are not ported."""
    require_kernel_vt(cfg)
    rw = torch.sqrt(torch.clamp(rw2, min=1e-30))
    v = cv.vt_beard77_fact(rw, p, rhod, eta) * cv.vt_beard77_v0(rw)
    return torch.where(rw2 > 0, v, 0.0)
