"""Collision kernels and the tabulated collision efficiencies
(libcloudphxx_tpu/lgrngn/coalescence.py:41-389; reference
src/detail/kernels.hpp, kernel_interpolation.hpp, kernel_utils.hpp).

The efficiency tables are the JAX package's data files
(libcloudphxx_tpu/lgrngn/kernel_data/*.npz), read with numpy by path so
that nothing of the JAX package is imported.  The turbulent (onishi) and
vohl kernels are not ported (ROADMAP.md, Queue 1 item 10).
"""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..common import constants as c
from .enums import kernel_t

KERNEL_DATA = (Path(__file__).resolve().parents[2] / "libcloudphxx_tpu"
               / "lgrngn" / "kernel_data")

# which kernel_t values use which tabulated efficiency dataset
TABULATED = {
    kernel_t.hall: "hall",
    kernel_t.hall_davis_no_waals: "hall_davis_no_waals",
    kernel_t.hall_pinsky_1000mb_grav: "hall_pinsky_1000mb_grav",
    kernel_t.hall_pinsky_cumulonimbus: "hall_pinsky_cumulonimbus",
    kernel_t.hall_pinsky_stratocumulus: "hall_pinsky_stratocumulus",
    kernel_t.vohl_davis_no_waals: "vohl_davis_no_waals",
}
UNPORTED = (kernel_t.vohl_davis_no_waals, kernel_t.onishi_hall,
            kernel_t.onishi_hall_davis_no_waals, kernel_t.undefined)
_CACHE = {}


def require_ported(kern: kernel_t):
    """Raise unless the port computes this collision kernel."""
    if kernel_t(kern) in UNPORTED:
        raise NotImplementedError(
            f"coalescence: kernel {kernel_t(kern).name} is not ported "
            "(ROADMAP.md, Queue 1 item 10)")


def load_efficiency_table(kern: kernel_t):
    """The dense symmetric efficiency table of a tabulated kernel as a
    numpy array, and its largest radius [um]; (zeros((1, 1)), 0.0) for
    the formula kernels."""
    name = TABULATED.get(kernel_t(kern))
    if name is None:
        return np.zeros((1, 1)), 0.0
    if name not in _CACHE:
        with np.load(KERNEL_DATA / f"{name}.npz") as d:
            _CACHE[name] = (np.asarray(d["efficiencies"]),
                            float(d["r_max_um"]))
    return _CACHE[name]


def clamped_efficiency_table(kern: kernel_t):
    """The table as a (128, 128) float32 block with its saturation index K:
    rows and columns past K repeat row/column K, so clamping the indices to
    K reads the same values (the form kernel E reads, one 64 KB table in
    global memory).  Returns (table128, r_max_um, K), or None where K > 126
    (vohl) or the kernel has no table."""
    name = TABULATED.get(kernel_t(kern))
    if name is None:
        return None
    key = ("clamp128", name)
    if key not in _CACHE:
        table, r_max = load_efficiency_table(kern)
        K = table.shape[0] - 1
        while K > 0 and np.array_equal(table[K - 1], table[-1]) \
                and np.array_equal(table[:, K - 1], table[:, -1]):
            K -= 1
        if K > 126:
            _CACHE[key] = None
        else:
            t128 = np.zeros((128, 128), np.float32)
            t128[:K + 1, :K + 1] = table[:K + 1, :K + 1].astype(np.float32)
            _CACHE[key] = (t128, r_max, K)
    return _CACHE[key]


class Efficiency(NamedTuple):
    """A hall-family efficiency table in the form the port reads it: the
    clamped (128, 128) block as a tensor, its largest radius [um] and its
    saturation index."""
    table: torch.Tensor
    r_max_um: float
    clamp: int


def efficiency(kern: kernel_t, dtype, device):
    """The Efficiency of a tabulated kernel, cached per dtype and device;
    None for the formula kernels.  The clamped block holds the float32
    values of the data files, so at any dtype it reads what the full
    table reads."""
    require_ported(kern)
    if kernel_t(kern) not in TABULATED:
        return None
    key = ("tensor", kernel_t(kern), dtype, str(device))
    if key not in _CACHE:
        table, r_max, clamp = clamped_efficiency_table(kern)
        _CACHE[key] = Efficiency(
            torch.as_tensor(table, dtype=dtype, device=device), r_max, clamp)
    return _CACHE[key]


def _kernel_index(r_um):
    """Radius [um] -> table index: 1 um steps to 100 um, 10 um above
    (reference kernel_utils.hpp:12-18)."""
    return torch.where(r_um <= 100.0, r_um,
                       100.0 + (r_um - 100.0) / 10.0).to(torch.int64)


def interpolated_efficiency(eff: Efficiency, rw_a, rw_b):
    """Bilinear collision-efficiency lookup over the nonuniform radius grid
    (reference kernel_interpolation.hpp:9-67) in the clamped table: the
    indices stop at its saturation index, past which the full table
    repeats itself (the TPU kernel's interpolated_efficiency_sweep reads
    it the same way)."""
    table, r_max_um, clamp = eff

    def prep(r_m):
        r = torch.clamp(r_m * 1e6, max=r_max_um - 1e-6)
        big = r >= 100.0
        x0 = torch.where(big, torch.floor(r / 10.0) * 10.0, torch.floor(r))
        dx = torch.where(big, 10.0, 1.0)
        i0 = torch.clamp(_kernel_index(x0), max=clamp)
        i1 = torch.clamp(_kernel_index(x0 + dx), max=clamp)
        return i0, i1, r - x0, x0 + dx - r, dx

    i0, i1, w1h, w1l, d1 = prep(rw_a)
    j0, j1, w2h, w2l, d2 = prep(rw_b)
    flat = table.reshape(-1)
    at = lambda i, j: flat[i * table.shape[1] + j]
    return (at(i0, j0) * w1l * w2l
            + at(i1, j0) * w1h * w2l
            + at(i0, j1) * w1l * w2h
            + at(i1, j1) * w1h * w2h) / d1 / d2


def kernel_value(cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a, vt_b, rd3_a,
                 rd3_b, eff=None):
    """Collision kernel K(a, b) times the larger multiplicity (reference
    kernels.hpp:40-207).  ``params`` = opts_init.kernel_parameters (a
    sequence of floats, may be empty); ``eff`` the hall family's
    efficiencies (efficiency())."""
    kern = kernel_t(cfg.kernel)
    require_ported(kern)
    n_max = torch.maximum(n_a, n_b)
    if kern == kernel_t.golovin:
        # (kernels.hpp:40-80)
        b = float(params[0])
        return c.pi * 4.0 / 3.0 * b * n_max \
            * (rw2_a * torch.sqrt(rw2_a) + rw2_b * torch.sqrt(rw2_b))
    # geometric base (kernels.hpp:84-125)
    rw_a, rw_b = torch.sqrt(rw2_a), torch.sqrt(rw2_b)
    geo = c.pi * n_max * torch.abs(vt_a - vt_b) \
        * (rw2_a + rw2_b + 2.0 * rw_a * rw_b)
    if kern == kernel_t.geometric:
        # one user parameter multiplies it (kernels.hpp:128-142)
        return geo * float(params[0]) if len(params) else geo
    if kern == kernel_t.long:
        # Long 1974 efficiency below 50 um (kernels.hpp:146-176)
        r_L, r_s = torch.maximum(rw_a, rw_b), torch.minimum(rw_a, rw_b)
        eff = torch.where(r_s <= 3e-6, 0.0,
                          4.5e8 * r_L * r_L * (1.0 - 3e-6 / r_s))
        return torch.where(r_L < 50e-6, geo * eff, geo)
    # the hall family (kernels.hpp:179-207)
    return geo * interpolated_efficiency(eff, rw_a, rw_b)
