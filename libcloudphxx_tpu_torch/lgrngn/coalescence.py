"""Collision kernels, the tabulated collision efficiencies, the Shima
collision and the flat engine's coalescence loop
(libcloudphxx_tpu/lgrngn/coalescence.py; reference src/detail/kernels.hpp,
kernel_interpolation.hpp, kernel_utils.hpp, and
src/impl/coalescence/particles_impl_coal.ipp).

The efficiency tables are the port's copies of the reference's data
(kernel_data/*.npz beside this file, byte for byte the JAX package's).
The turbulent (onishi) kernels take the hall tables times the Wang et al.
2009 enhancement and the Onishi kernel without gravity (wang_enhancement,
onishi_nograv); they need each pair's cell density, viscosity and
dissipation rate, which the flat loop gives them (the cells' under
turb_coal, else 0), and the dense engine gives them at dissipation rate
0, as the JAX package's dense engine does (lgrngn/dense.py _turb; on the
card kernel E's onishi form, ops/coal.py).

The flat loop (coal, coal_substep) draws its random numbers from Philox
(ops/philox.py), keyed by the state's seed and with the counter (step
counter, substep, kind, slot): the in-cell shuffle sorts on
(cell << 32 | 32 random bits), stably, so ties fall back to the slot
order and the CPU and the card give one permutation.
"""

import dataclasses
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..common import constants as c
from ..ops import philox
from .enums import kernel_t
from .state import OUT_COAL_OVERFLOW, State, StaticConfig
from .vterm import vt_of

KERNEL_DATA = Path(__file__).resolve().parent / "kernel_data"

# which kernel_t values use which tabulated efficiency dataset
TABULATED = {
    kernel_t.hall: "hall",
    kernel_t.hall_davis_no_waals: "hall_davis_no_waals",
    kernel_t.hall_pinsky_1000mb_grav: "hall_pinsky_1000mb_grav",
    kernel_t.hall_pinsky_cumulonimbus: "hall_pinsky_cumulonimbus",
    kernel_t.hall_pinsky_stratocumulus: "hall_pinsky_stratocumulus",
    kernel_t.vohl_davis_no_waals: "vohl_davis_no_waals",
    # the onishi turbulent kernels share the stagnant-air tables
    kernel_t.onishi_hall: "hall",
    kernel_t.onishi_hall_davis_no_waals: "hall_davis_no_waals",
}
UNPORTED = (kernel_t.undefined,)
# the turbulent kernels: their value reads each pair's cell (kernel_value's
# ``turb``)
TURBULENT = (kernel_t.onishi_hall, kernel_t.onishi_hall_davis_no_waals)
# the widest table kernel E reads at the hall family's fixed row stride
NARROW = 128
_CACHE = {}


def require_ported(kern: kernel_t):
    """Raise unless the port computes this collision kernel (undefined is
    no kernel)."""
    if kernel_t(kern) in UNPORTED:
        raise NotImplementedError(
            f"coalescence: kernel {kernel_t(kern).name} is not a collision "
            "kernel")


def require_resident(kern: kernel_t):
    """Raise for a kernel the dense engine and kernel E do not run: only
    undefined, which is no collision kernel.  The dense engine runs every
    other kernel, the turbulent ones at dissipation rate 0, as the JAX
    package's dense engine does (libcloudphxx_tpu/lgrngn/dense.py:606,
    :738); its flat engine gives them the cells' dissipation rate under
    turb_coal."""
    require_ported(kern)


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
    """The table as a square float32 block with its saturation index K:
    rows and columns past K repeat row/column K, so clamping the indices
    to K reads the same values (the form kernel E reads from global
    memory).  The block is 128 wide where K <= 126 (the hall family's K is
    120: one 64 KB table at E's fixed row stride) and K + 2 wide otherwise
    (vohl_davis_no_waals, K = 150: E's wide form, whose row stride is
    K + 2).  Returns (table, r_max_um, K), or None for a kernel without a
    table."""
    name = TABULATED.get(kernel_t(kern))
    if name is None:
        return None
    key = ("clamp", name)
    if key not in _CACHE:
        table, r_max = load_efficiency_table(kern)
        K = table.shape[0] - 1
        while K > 0 and np.array_equal(table[K - 1], table[-1]) \
                and np.array_equal(table[:, K - 1], table[:, -1]):
            K -= 1
        width = NARROW if K <= NARROW - 2 else K + 2
        block = np.zeros((width, width), np.float32)
        block[:K + 1, :K + 1] = table[:K + 1, :K + 1].astype(np.float32)
        _CACHE[key] = (block, r_max, K)
    return _CACHE[key]


class Efficiency(NamedTuple):
    """An efficiency table in the form the port reads it: the clamped
    square block as a tensor (128 wide, or K + 2 for the wide form), its
    largest radius [um] and its saturation index K."""
    table: torch.Tensor
    r_max_um: float
    clamp: int


def efficiency(kern: kernel_t, dtype, device):
    """The Efficiency of a tabulated kernel (the hall family and vohl),
    cached per dtype and device; None for the formula kernels.  The
    clamped block holds the float32 values of the data files, so at any
    dtype it reads what the full table reads."""
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
    it the same way), so it reads what the JAX package's
    interpolated_efficiency reads from the full table."""
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


# Wang et al. 2009 turbulent collision-efficiency enhancement, table 1
# (reference src/detail/wang_collision_enhancement.hpp:11-110): collector
# radii, radius ratios, and eta[ratio, eps > 2.5e-2, collector radius]
_WANG_R0 = np.array([10e-6, 20e-6, 30e-6, 40e-6, 50e-6, 60e-6, 100e-6])
_WANG_RAT = np.linspace(0.0, 1.0, 11)
_WANG_ETA = np.array([
    [[1.74, 1.74, 1.773, 1.49, 1.207, 1.207, 1.0],
     [4.976, 4.976, 3.593, 2.519, 1.445, 1.445, 1.0]],
    [[1.46, 1.46, 1.421, 1.245, 1.069, 1.069, 1.0],
     [2.984, 2.984, 2.181, 1.691, 1.201, 1.201, 1.0]],
    [[1.32, 1.32, 1.245, 1.123, 1.000, 1.000, 1.0],
     [1.988, 1.988, 1.475, 1.313, 1.150, 1.150, 1.0]],
    [[1.250, 1.250, 1.148, 1.087, 1.025, 1.025, 1.0],
     [1.490, 1.490, 1.187, 1.156, 1.126, 1.126, 1.0]],
    [[1.186, 1.186, 1.066, 1.060, 1.056, 1.056, 1.0],
     [1.249, 1.249, 1.088, 1.090, 1.092, 1.092, 1.0]],
    [[1.045, 1.045, 1.000, 1.014, 1.028, 1.028, 1.0],
     [1.139, 1.139, 1.130, 1.091, 1.051, 1.051, 1.0]],
    [[1.070, 1.070, 1.030, 1.038, 1.046, 1.046, 1.0],
     [1.220, 1.220, 1.190, 1.138, 1.086, 1.086, 1.0]],
    [[1.000, 1.000, 1.054, 1.042, 1.029, 1.029, 1.0],
     [1.325, 1.325, 1.267, 1.165, 1.063, 1.063, 1.0]],
    [[1.223, 1.223, 1.117, 1.069, 1.021, 1.021, 1.0],
     [1.716, 1.716, 1.345, 1.223, 1.100, 1.100, 1.0]],
    [[1.570, 1.570, 1.244, 1.166, 1.088, 1.088, 1.0],
     [3.788, 3.788, 1.501, 1.311, 1.120, 1.120, 1.0]],
    [[20.3, 20.3, 14.6, 8.61, 2.60, 2.60, 1.0],
     [36.52, 36.52, 19.16, 22.80, 26.0, 26.0, 1.0]],
])


def _wang_tables(dtype, device):
    key = ("wang", dtype, str(device))
    if key not in _CACHE:
        _CACHE[key] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                            for a in (_WANG_R0, _WANG_RAT, _WANG_ETA))
    return _CACHE[key]


def wang_enhancement(r1, r2, eps):
    """The turbulent collision-efficiency enhancement (Wang et al. 2009),
    bilinear in (collector radius, radius ratio) (reference
    wang_collision_enhancement.hpp:44-88; libcloudphxx_tpu/lgrngn/
    coalescence.py:232-257).  ``eps`` a number or a tensor."""
    R0, RAT, ETA = _wang_tables(r1.dtype, r1.device)
    R, r = torch.maximum(r1, r2), torch.minimum(r1, r2)
    n_eps = (torch.as_tensor(eps, dtype=r1.dtype, device=r1.device)
             > 2.5e-2).to(torch.int64)
    # the first R0 above R, the first ratio node above r / R
    n_R0 = torch.searchsorted(R0, R.contiguous(), right=True)
    ratio = r / torch.clamp(R, min=1e-300)
    n_rat = torch.clamp(torch.searchsorted(RAT, ratio.contiguous(),
                                           right=True), 1, 10)
    small = n_R0 == 0
    n_R0c = torch.clamp(n_R0, 1, 6)
    w0 = R - R0[n_R0c - 1]
    w1 = R0[n_R0c] - R
    w2 = ratio - RAT[n_rat - 1]
    w3 = RAT[n_rat] - ratio
    interp = (ETA[n_rat - 1, n_eps, n_R0c - 1] * w1 * w3
              + ETA[n_rat - 1, n_eps, n_R0c] * w0 * w3
              + ETA[n_rat, n_eps, n_R0c - 1] * w1 * w2
              + ETA[n_rat, n_eps, n_R0c] * w0 * w2) \
        / (R0[n_R0c] - R0[n_R0c - 1]) / (RAT[n_rat] - RAT[n_rat - 1])
    out = torch.where(small, ETA[n_rat, n_eps, 0], interp)
    return torch.where(R > 100e-6, 1.0, out)


def onishi_nograv(r1, r2, Re_l, eps, dnu, ratio_den):
    """The turbulent collision kernel without gravitational settling
    (Onishi 2005/2013/2014; Wang et al. 2000 <|Wr|>; Zhou et al. 2001 g12;
    reference src/detail/kernel_onishi_nograv.hpp:30-160; libcloudphxx_tpu/
    lgrngn/coalescence.py:260-322).  ``Re_l`` the Taylor-microscale
    Reynolds number (a number), ``eps`` the dissipation rate, ``dnu`` the
    kinematic viscosity, ``ratio_den`` rho_w / rhod.  The Kolmogorov scale
    is (nu^3 / eps)^(1/4), as in the JAX package (the reference's integer
    exponent 1/4 == 0 makes it 1 m)."""
    eps = torch.as_tensor(eps, dtype=r1.dtype, device=r1.device)
    eps_s = torch.clamp(eps, min=1e-30)
    urms = torch.sqrt(Re_l / torch.sqrt(15.0 / dnu / eps_s))
    CR = r1 + r2
    taup1 = ratio_den * 4.0 * r1 * r1 / 18.0 / dnu
    taup2 = ratio_den * 4.0 * r2 * r2 / 18.0 / dnu
    leta = (dnu ** 3 / eps_s) ** 0.25
    tauk = leta * leta / dnu
    Te = Re_l * tauk / math.sqrt(15.0)

    theta1 = 2.5 * taup1 / Te
    theta2 = 2.5 * taup2 / Te
    phi = torch.maximum(theta2 / theta1, theta1 / theta2)
    cw = 1.0 + 0.6 * torch.exp(-torch.clamp(phi - 1.0, min=0.0) ** 1.5)
    gamma = phi * 0.183 * urms * urms / (dnu * dnu / leta / leta)

    WrS2 = (dnu * dnu * CR * CR) / leta ** 4 / 15.0
    WrA2 = (urms * urms * gamma / (gamma - 1.0)
            * ((theta1 + theta2) - 4.0 * theta1 * theta2 / (theta1 + theta2)
               * torch.sqrt((1.0 + theta1 + theta2)
                            / (1.0 + theta1) / (1.0 + theta2)))
            * (1.0 / (1.0 + theta1) / (1.0 + theta2)
               - 1.0 / (1.0 + gamma * theta1) / (1.0 + gamma * theta2)))
    WrA2 = cw * WrA2 / 3.0  # Ayala 2008
    Wr = torch.sqrt(2.0 / c.pi * (WrA2 + WrS2))

    A1, A2, A3 = 110.0, 0.38, 0.16
    alpha = max(math.log10(0.26 * math.sqrt(Re_l)) / math.log10(2.0), 1e-20)
    CA = 0.06 * Re_l ** 0.30
    CB = 0.4
    StA = (A2 / A1 * Re_l) ** 0.25
    StB = np.cbrt(A2 / A3) ** 2 * np.cbrt(Re_l)
    St1 = taup1 / tauk
    St2 = taup2 / tauk

    def g_mono(St, St_other):
        y1 = torch.where(St_other <= StA, A1 * St * St, 0.0)
        y2 = torch.where(St_other <= StA, 0.0, A2 * Re_l / (St * St))
        y3 = A3 * torch.sqrt(Re_l / St)
        za = 0.5 * (1.0 - torch.tanh((torch.log10(St) - math.log10(StA))
                                     / CA))
        zb = 0.5 * (1.0 + torch.tanh((torch.log10(St) - math.log10(StB))
                                     / CB))
        return y1 * za ** alpha + y2 * (1.0 - za) ** alpha + y3 * zb + 1.0

    gR1 = g_mono(St1, St2)
    gR2 = g_mono(St2, St1)
    xai = torch.maximum(taup2 / taup1, taup1 / taup2)
    RG12 = 2.6 * torch.exp(-xai) + 0.205 * torch.exp(-0.0206 * xai) \
        * 0.5 * (1.0 + torch.tanh(xai - 3.0))
    gR = 1.0 + RG12 * torch.sqrt(torch.clamp(gR1 - 1.0, min=0.0)) \
        * torch.sqrt(torch.clamp(gR2 - 1.0, min=0.0))

    out = 2.0 * c.pi * CR * CR * Wr * gR
    return torch.where(eps < 1e-10, 0.0, out)


def kernel_value(cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a, vt_b, rd3_a,
                 rd3_b, eff=None, turb=None):
    """Collision kernel K(a, b) times the larger multiplicity (reference
    kernels.hpp:40-255).  ``params`` = opts_init.kernel_parameters (a
    sequence of floats, may be empty); ``eff`` the hall family's
    efficiencies (efficiency()); ``turb`` the pairs' cell (rhod, eta,
    dissipation rate) that the turbulent kernels take."""
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
    if kern in TURBULENT:
        # (kernels.hpp:210-255): the stagnant efficiency times the Wang
        # enhancement times sqrt(geometric^2 + onishi^2); params[0] is
        # both Re_lambda (nograv) and epsilon (Wang), as in the reference,
        # and n_max multiplies the whole kernel (libcloudphxx_tpu/lgrngn/
        # coalescence.py:377-389)
        if turb is None:
            raise ValueError(f"kernel_value: {kern.name} needs the pairs' "
                             "rhod, eta and dissipation rate (turb)")
        rhod, eta, diss_rate = turb
        Re_l = float(params[0])
        nograv = onishi_nograv(rw_a, rw_b, Re_l, diss_rate, eta / rhod,
                               c.rho_w / rhod) * n_max
        return interpolated_efficiency(eff, rw_a, rw_b) \
            * wang_enhancement(rw_a, rw_b, Re_l) \
            * torch.sqrt(geo * geo + nograv * nograv)
    # the hall family and vohl (kernels.hpp:179-207)
    return geo * interpolated_efficiency(eff, rw_a, rw_b)


def _cbrt(v):
    """The cube root kernel E computes (the exp/log form of the TPU
    kernel's cbrt_pos), here so that the two agree bitwise."""
    return torch.exp(torch.log(torch.clamp(v, min=1e-38)) / 3.0)


def shima(cfg, params, a, b, a_big, ok, u, dt, dv_row, scale, eff,
          turb=None, with_col=False):
    """The Shima collision of every pair (a, b) that ``ok`` marks, with
    ``a_big`` saying which SD has the larger multiplicity (coal.ipp:98-236,
    Shima 2009 eqs. 12-13).  Returns (happened, n_big_new, rw2_small_new,
    rd3_small_new, kpa_small_new, overflow per row), and with ``with_col``
    the pairs' collision counts after them."""
    n_a, rw2_a, rd3_a, kpa_a, vt_a = a
    n_b, rw2_b, rd3_b, kpa_b, vt_b = b
    K = kernel_value(cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a,
                              vt_b, rd3_a, rd3_b, eff, turb)
    prob = torch.where(ok, dt / dv_row * scale * K, 0.0)
    # all-or-nothing multi-collision (coal.ipp:218-236)
    col_no = torch.floor(prob)
    overflow = (ok & (col_no >= 1.0)).any(dim=-1)
    col_no = col_no + (u < prob - col_no)
    big = lambda p, q: torch.where(a_big, p, q)
    n_big, n_small = big(n_a, n_b), big(n_b, n_a)
    ratio = torch.where(n_small > 0,
                        torch.floor(n_big / torch.clamp(n_small, min=1.0)),
                        0.0)
    col_no = torch.minimum(col_no, ratio)
    happened = ok & (col_no > 0)
    rw2_big, rw2_small = big(rw2_a, rw2_b), big(rw2_b, rw2_a)
    rd3_big, rd3_small = big(rd3_a, rd3_b), big(rd3_b, rd3_a)
    kpa_big, kpa_small = big(kpa_a, kpa_b), big(kpa_b, kpa_a)
    n_big_new = n_big - col_no * n_small
    rw3_small_new = col_no * rw2_big * torch.sqrt(rw2_big) \
        + rw2_small * torch.sqrt(rw2_small)
    r_new = _cbrt(rw3_small_new)
    rd3_small_new = col_no * rd3_big + rd3_small
    kpa_small_new = torch.where(
        rd3_small_new > 0,
        (col_no * kpa_big * rd3_big + kpa_small * rd3_small)
        / torch.clamp(rd3_small_new, min=1e-300),
        kpa_small)
    return (happened, n_big_new, r_new * r_new, rd3_small_new,
            kpa_small_new, overflow) + ((col_no,) if with_col else ())


# ---------------------------------------------------------- flat engine
def _shift_up(a):
    """a[i+1] with the last element repeated."""
    return torch.cat([a[1:], a[-1:]])


def _shift_down(a):
    """a[i-1] with the first element repeated."""
    return torch.cat([a[:1], a[:-1]])


def _shift_down_mask(m):
    """m[i-1] with False injected at position 0."""
    return torch.cat([torch.zeros_like(m[:1]), m[:-1]])


def coal_substep(cfg: StaticConfig, state: State, params, dt, shuffle_bits,
                 u01, eff=None, turb_coal=False) -> State:
    """One coalescence substep over the whole flat population
    (libcloudphxx_tpu/lgrngn/coalescence.py:410-586; reference
    particles_impl_coal.ipp:273-546): a random permutation within each
    cell (a stable sort on (cell << 32 | ``shuffle_bits``), dead slots
    past every cell), the Shima scale factor from the cell counts,
    adjacent pairs, the pair outcome applied in sorted space and one
    scatter back to slot order.  ``shuffle_bits`` are 32-bit words per
    slot, ``u01`` the Bernoulli draws per sorted position.  The turbulent
    kernels take each pair's cell density and viscosity, and its
    dissipation rate under ``turb_coal`` (0 otherwise; coal.ipp:439-450).
    With diag_incloud_time the merged droplet keeps the longer in-cloud
    time of the two (coal.ipp's max post-summator); with chem_switch it
    takes col_no times the big SD's dissolved masses (coal.ipp:459-468;
    libcloudphxx_tpu/lgrngn/coalescence.py:555-566)."""
    n_sd = state.n.shape[0]
    cellkey = torch.where(state.n <= 0, cfg.n_cell, state.ijk)
    skey, orig = torch.sort((cellkey << 32) | shuffle_bits, stable=True)
    sijk = skey >> 32
    a = tuple(v[orig] for v in (state.n, state.rw2, state.rd3, state.kpa,
                                state.vt))
    n_a, rw2_a, rd3_a, kpa_a, _ = a
    # per-cell SD counts and offsets from the sorted keys
    bounds = torch.searchsorted(
        sijk, torch.arange(cfg.n_cell + 1, device=sijk.device))
    count = (bounds[1:] - bounds[:-1]).to(n_a.dtype)
    # Shima 2009 sec 5.1.3 scale factor n(n-1)/2 / floor(n/2)
    half = torch.floor(count / 2)
    scale = torch.where(count > 1, count * (count - 1) / 2.0 / half, 0.0)
    in_domain = sijk < cfg.n_cell
    cell = torch.clamp(sijk, max=cfg.n_cell - 1)
    pos = torch.arange(n_sd, device=sijk.device)
    cix = pos - torch.where(in_domain, bounds[:-1][cell], 0)
    # candidate pairs: even in-cell index, the neighbour in the same cell
    is_pair = (cix % 2 == 0) & in_domain & (_shift_up(sijk) == sijk) \
        & (pos < n_sd - 1)
    b = tuple(_shift_up(v) for v in a)
    a_is_big = n_a >= b[0]
    turb = None
    if kernel_t(cfg.kernel) in TURBULENT:
        turb = (state.rhod[cell], state.eta[cell],
                state.diss_rate[cell] if turb_coal else 0.0)
    happened, n_big_new, rw2_new, rd3_new, kpa_new, overflow, col_no = \
        shima(cfg, params, a, b, a_is_big, is_pair, u01, dt, state.dv[cell],
              scale[cell], eff, turb, with_col=True)
    # position p holds the pair's outcome, p+1 reads it shifted
    hp, bigp = _shift_down_mask(happened), _shift_down(a_is_big)
    n_s = torch.where(happened & a_is_big, n_big_new, n_a)
    n_s = torch.where(hp & ~bigp, _shift_down(n_big_new), n_s)
    out = [n_s]
    pairs = [(rw2_a, rw2_new), (rd3_a, rd3_new), (kpa_a, kpa_new)]
    if cfg.chem_switch:
        # the dissolved masses add up (coal.ipp:459-468's post-summator)
        for row in state.chem:
            ch_a = row[orig]
            ch_b = _shift_up(ch_a)
            pairs.append((ch_a, torch.where(a_is_big, ch_b, ch_a)
                          + col_no * torch.where(a_is_big, ch_a, ch_b)))
    if cfg.diag_incloud_time:
        ict_a = state.incloud_time[orig]
        pairs.append((ict_a, torch.maximum(ict_a, _shift_up(ict_a))))
    for own, new in pairs:
        v = torch.where(happened & ~a_is_big, new, own)
        out.append(torch.where(hp & bigp, _shift_down(new), v))
    back = []
    for v in out:
        w = torch.empty_like(v)
        w[orig] = v
        back.append(w)
    puddle = state.puddle
    if cfg.pure_const_multi:
        # a const-multi pair asked for more than one collision: the sticky
        # increase_sstp_coal request (coal.ipp:224-227)
        flag = torch.zeros_like(puddle)
        flag[OUT_COAL_OVERFLOW] = overflow.to(puddle.dtype)
        puddle = torch.maximum(puddle, flag)
    upd = {}
    if cfg.chem_switch:
        upd["chem"] = torch.stack(back[4:12])
    if cfg.diag_incloud_time:
        upd["incloud_time"] = back[-1]
    return dataclasses.replace(state, n=back[0], rw2=back[1], rd3=back[2],
                               kpa=back[3], puddle=puddle, **upd)


def coal(cfg: StaticConfig, state: State, params, dt, sstp_coal: int,
         turb_coal: bool = False) -> State:
    """The sstp_coal substeps of step_async's coalescence
    (libcloudphxx_tpu/lgrngn/coalescence.py:589-631; reference
    particles_step.ipp:382-404), vt refreshed before every substep and
    after the last.  The draws of substep s are Philox words keyed by
    (state.rng_seed, 0), counter (state.rng_step, s, kind, slot); the step
    counter advances by one (the key's second word is state.rng_key: 0,
    or a shard's, ops/philox.shard_key).  ``turb_coal`` hands the turbulent kernels
    the cells' dissipation rate."""
    dt_sub = dt / sstp_coal
    eff = efficiency(cfg.kernel, state.n.dtype, state.n.device)
    g = lambda a: a[state.ijk]
    cells = (g(state.T), g(state.p), g(state.rhod), g(state.eta))
    n_sd = state.n.shape[0]
    draws = lambda kind: philox.draw_substeps(
        state.rng_seed, state.rng_step, sstp_coal, kind, n_sd,
        state.n.device, key1=state.rng_key)
    shuffle = draws(philox.SHUFFLE)
    u01 = philox.u01(draws(philox.BERNOULLI), state.n.dtype)
    for s in range(sstp_coal):
        state = dataclasses.replace(state, vt=vt_of(cfg, state.rw2, *cells))
        state = coal_substep(cfg, state, params, dt_sub, shuffle[s], u01[s],
                             eff, turb_coal)
    return dataclasses.replace(state, vt=vt_of(cfg, state.rw2, *cells),
                               rng_step=state.rng_step + 1)
