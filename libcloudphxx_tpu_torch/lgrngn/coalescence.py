"""Collision kernels, the tabulated collision efficiencies, the Shima
collision and the flat engine's coalescence loop
(libcloudphxx_tpu/lgrngn/coalescence.py; reference src/detail/kernels.hpp,
kernel_interpolation.hpp, kernel_utils.hpp, and
src/impl/coalescence/particles_impl_coal.ipp).

The efficiency tables are the port's copies of the reference's data
(kernel_data/*.npz beside this file, byte for byte the JAX package's).
The turbulent (onishi) kernels are not ported (ROADMAP.md, Queue 1, "The
LES slice").

The flat loop (coal, coal_substep) draws its random numbers from Philox
(ops/philox.py), keyed by the state's seed and with the counter (step
counter, substep, kind, slot): the in-cell shuffle sorts on
(cell << 32 | 32 random bits), stably, so ties fall back to the slot
order and the CPU and the card give one permutation.
"""

import dataclasses
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
}
UNPORTED = (kernel_t.onishi_hall, kernel_t.onishi_hall_davis_no_waals,
            kernel_t.undefined)
# the widest table kernel E reads at the hall family's fixed row stride
NARROW = 128
_CACHE = {}


def require_ported(kern: kernel_t):
    """Raise unless the port computes this collision kernel."""
    if kernel_t(kern) in UNPORTED:
        raise NotImplementedError(
            f"coalescence: kernel {kernel_t(kern).name} is not ported "
            "(ROADMAP.md, Queue 1, \"The LES slice\")")


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
    # the hall family and vohl (kernels.hpp:179-207)
    return geo * interpolated_efficiency(eff, rw_a, rw_b)


def _cbrt(v):
    """The cube root kernel E computes (the exp/log form of the TPU
    kernel's cbrt_pos), here so that the two agree bitwise."""
    return torch.exp(torch.log(torch.clamp(v, min=1e-38)) / 3.0)


def shima(cfg, params, a, b, a_big, ok, u, dt, dv_row, scale, eff):
    """The Shima collision of every pair (a, b) that ``ok`` marks, with
    ``a_big`` saying which SD has the larger multiplicity (coal.ipp:98-236,
    Shima 2009 eqs. 12-13).  Returns (happened, n_big_new, rw2_small_new,
    rd3_small_new, kpa_small_new, overflow per row)."""
    n_a, rw2_a, rd3_a, kpa_a, vt_a = a
    n_b, rw2_b, rd3_b, kpa_b, vt_b = b
    K = kernel_value(cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a,
                              vt_b, rd3_a, rd3_b, eff)
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
            kpa_small_new, overflow)


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
                 u01, eff=None) -> State:
    """One coalescence substep over the whole flat population
    (libcloudphxx_tpu/lgrngn/coalescence.py:410-586; reference
    particles_impl_coal.ipp:273-546): a random permutation within each
    cell (a stable sort on (cell << 32 | ``shuffle_bits``), dead slots
    past every cell), the Shima scale factor from the cell counts,
    adjacent pairs, the pair outcome applied in sorted space and one
    scatter back to slot order.  ``shuffle_bits`` are 32-bit words per
    slot, ``u01`` the Bernoulli draws per sorted position."""
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
    happened, n_big_new, rw2_new, rd3_new, kpa_new, overflow = shima(
        cfg, params, a, b, a_is_big, is_pair, u01, dt, state.dv[cell],
        scale[cell], eff)
    # position p holds the pair's outcome, p+1 reads it shifted
    hp, bigp = _shift_down_mask(happened), _shift_down(a_is_big)
    n_s = torch.where(happened & a_is_big, n_big_new, n_a)
    n_s = torch.where(hp & ~bigp, _shift_down(n_big_new), n_s)
    out = [n_s]
    for own, new in ((rw2_a, rw2_new), (rd3_a, rd3_new), (kpa_a, kpa_new)):
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
    return dataclasses.replace(state, n=back[0], rw2=back[1], rd3=back[2],
                               kpa=back[3], puddle=puddle)


def coal(cfg: StaticConfig, state: State, params, dt,
         sstp_coal: int) -> State:
    """The sstp_coal substeps of step_async's coalescence
    (libcloudphxx_tpu/lgrngn/coalescence.py:589-631; reference
    particles_step.ipp:382-404), vt refreshed before every substep and
    after the last.  The draws of substep s are Philox words keyed by
    (state.rng_seed, 0), counter (state.rng_step, s, kind, slot); the step
    counter advances by one."""
    dt_sub = dt / sstp_coal
    eff = efficiency(cfg.kernel, state.n.dtype, state.n.device)
    g = lambda a: a[state.ijk]
    cells = (g(state.T), g(state.p), g(state.rhod), g(state.eta))
    n_sd = state.n.shape[0]
    draws = lambda kind: philox.draw_substeps(
        state.rng_seed, state.rng_step, sstp_coal, kind, n_sd,
        state.n.device)
    shuffle = draws(philox.SHUFFLE)
    u01 = philox.u01(draws(philox.BERNOULLI), state.n.dtype)
    for s in range(sstp_coal):
        state = dataclasses.replace(state, vt=vt_of(cfg, state.rw2, *cells))
        state = coal_substep(cfg, state, params, dt_sub, shuffle[s], u01[s],
                             eff)
    return dataclasses.replace(state, vt=vt_of(cfg, state.rw2, *cells),
                               rng_step=state.rng_step + 1)
