"""Super-droplet initialisation (libcloudphxx_tpu/lgrngn/init.py;
reference src/impl/initialization/).

The distribution analysis and the sampling run in numpy with the caller's
``numpy.random.Generator`` and the JAX package's draw order, so one seed
gives the JAX package's population draw for draw; the equilibrium wet
radius is solved on the tensors' device.  particles_t.init runs the
sequence on the flat State (init_SD_state, init_wet_state).

Modes: ``sd_conc`` (stratified ln-radius sampling, the same SD count in
every cell; with ``sd_conc_large_tail`` also multiplicity-1 SDs from the
distribution's tail), ``sd_const_multi`` (inverse-CDF ln-radius sampling at
one multiplicity) and ``dry_sizes`` (fixed radius and concentration pairs),
each scaled by ``aerosol_conc_factor`` per level where given.  The
reference's bit-exact mt19937 init is lgrngn/refinit.py.
"""

import dataclasses
import math

import numpy as np
import torch

from ..common import constants as c
from ..common import ice_nucleation, kappa_koehler
from .state import State, StaticConfig

# reference src/detail/config.hpp:21-24
RD_MIN_INIT = 1e-14
RD_MAX_INIT = 1e-3
CONST_MULTI_THRESHOLD = 1e20
# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def cell_dv(cfg: StaticConfig) -> np.ndarray:
    """Per-cell sample volume with the Lagrangian-domain crop
    (reference init_grid.ipp dv_eval:33-52), ravelled i outermost."""
    def axis(n, d, a0, a1):
        i = np.arange(max(1, n))
        return np.maximum(
            0.0, np.minimum((i + 1) * d, a1) - np.maximum(i * d, a0))

    wx = axis(cfg.nx, cfg.dx, cfg.x0, cfg.x1)
    wy = axis(cfg.ny, cfg.dy, cfg.y0, cfg.y1)
    wz = axis(cfg.nz, cfg.dz, cfg.z0, cfg.z1)
    return (wx[:, None, None] * wy[None, :, None] * wz[None, None, :]).ravel()


def conc_factor_cells(cfg: StaticConfig, oi):
    """The per-cell aerosol concentration factor from the per-level
    profile ``opts_init.aerosol_conc_factor`` (reference opts_init.hpp:140,
    applied by k = cell % nz in particles_impl_init_count_num.ipp:65-70 and
    init_n.ipp:100-110), with the sanity checks of
    init_sanity_check.ipp:119-127.  Returns (n_cell,) or None."""
    factor = np.asarray(oi.aerosol_conc_factor or [], dtype=float)
    if factor.size == 0:
        return None
    if cfg.n_dims < 2:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor can only be used in 2D and 3D")
    if factor.size != cfg.nz:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor size needs to be either 0 "
            "or nz")
    if not oi.aerosol_independent_of_rhod:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor can only be used if "
            "aerosol_independent_of_rhod==true")
    return factor[np.arange(cfg.n_cell) % cfg.nz]


def _eval_distro(fun, lnrd):
    """Evaluate a user distribution over an array of ln(rd): vectorised
    when the callable takes arrays, element by element otherwise."""
    lnrd = np.asarray(lnrd, dtype=float)
    try:
        out = np.asarray(fun(lnrd), dtype=float)
    except (TypeError, ValueError):
        out = None
    if out is not None and out.shape == lnrd.shape:
        return out
    return np.vectorize(lambda v: float(fun(v)), otypes=[float])(lnrd)


def _dist_analysis_sd_conc(fun, sd_conc, cell_vol, rd_min=-1.0, rd_max=-1.0):
    """The [rd_min, rd_max] support of n(ln rd) and the multiplicity
    coefficient (reference init_dist_analysis.ipp:17-80).
    Returns (log_rd_min, log_rd_max, multiplier)."""
    if rd_min >= 0 and rd_max >= 0:
        mult = math.log(rd_max / rd_min) / sd_conc * cell_vol
        return math.log(rd_min), math.log(rd_max), mult
    if not (rd_min < 0 and rd_max < 0):
        raise ValueError("opts_init.rd_min * opts_init.rd_max < 0")

    lo, hi = RD_MIN_INIT, RD_MAX_INIT
    while True:
        mult = math.log(hi / lo) / sd_conc * cell_vol
        # an integer multiplicity type: sub-1 values count as zero
        # (init_dist_analysis.ipp:63-65)
        n_min = int(float(fun(math.log(lo))) * mult)
        n_max = int(float(fun(math.log(hi))) * mult)
        if lo == RD_MIN_INIT and n_min != 0:
            raise RuntimeError(
                f"Initial dry distribution non-zero ({n_min}) at rd_min_init")
        if hi == RD_MAX_INIT and n_max != 0:
            raise RuntimeError(
                f"Initial dry distribution non-zero ({n_max}) at rd_max_init")
        if n_min == 0:
            lo *= 1.01
        elif n_max == 0:
            hi /= 1.01
        else:
            return math.log(lo), math.log(hi), mult


def _dist_analysis_const_multi(fun):
    """The support of n(ln rd) in const-multi mode: where the
    distribution lies above its peak over CONST_MULTI_THRESHOLD
    (reference init_dist_analysis.ipp:83-122).  Returns (log_rd_min,
    log_rd_max)."""
    lnr = np.linspace(math.log(RD_MIN_INIT), math.log(RD_MAX_INIT), 20001)
    vals = _eval_distro(fun, lnr)
    above = np.nonzero(vals > vals.max() / CONST_MULTI_THRESHOLD)[0]
    if len(above) == 0:
        raise RuntimeError("const-multi distribution analysis: empty support")
    return float(lnr[above[0]]), float(lnr[above[-1]])


def _sample_const_multi(fun, log_lo, log_hi, multi, oi, cfg, dv_host,
                        rhod_host, rng):
    """Constant-multiplicity sampling over [log_lo, log_hi] in every cell
    (reference init_count_num_const_multi + init_dry_const_multi): a cell
    holds round(concentration * dv * rhod / rho_stp / multi) SDs, their
    ln(rd) drawn by inverse-CDF sampling.  Returns (lnrd, multiplicity,
    ijk)."""
    lnr = np.linspace(log_lo, log_hi, 10001)
    vals = _eval_distro(fun, lnr)
    conc = _trapezoid(vals, lnr)  # [1/m3] @ STP
    n_in_cell = conc * np.asarray(dv_host, float)
    if not oi.aerosol_independent_of_rhod:
        n_in_cell = n_in_cell * np.asarray(rhod_host) / c.rho_stp
    factor = conc_factor_cells(cfg, oi)
    if factor is not None:
        n_in_cell = n_in_cell * factor
    counts = np.floor(n_in_cell / multi + 0.5).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0, np.int64)
    ijk = np.repeat(np.arange(cfg.n_cell, dtype=np.int64), counts)
    cdf = np.concatenate([[0.0], np.cumsum(
        0.5 * (vals[1:] + vals[:-1]) * np.diff(lnr))])
    cdf /= cdf[-1]
    lnrd = np.interp(rng.random(total), cdf, lnr)
    return lnrd, np.full(total, float(multi)), ijk


def key_parts(key):
    """(kappa, rd_insol) of a distribution key: (kappa, rd_insol), (kappa,)
    or kappa, rd_insol 0 where the key gives none (reference
    distro_t.hpp:9-57)."""
    if isinstance(key, tuple):
        return key[0], (key[1] if len(key) > 1 else 0.0)
    return key, 0.0


def init_SD(cfg: StaticConfig, oi, rng: np.random.Generator,
            rhod_host: np.ndarray) -> dict:
    """The initial super-droplets of any grid (reference
    init_SD_with_distros.ipp and init_SD_with_sizes.ipp; the JAX package's
    init_SD, the same draws from ``rng`` in the same order).  In a parcel
    the one cell holds 1 kg of dry air (its volume 1/rhod).  Returns flat
    float64 numpy arrays {n, rd3, kpa, x, y, z, rd2_insol} and the int64
    cell index ``ijk``, laid out as the JAX package lays them: by mode and
    distribution, sorted by cell within each; with singular freezing
    (ice_switch without time_dep_ice_nucl) also ``T_freeze_u``, the
    uniform draw of each SD's freezing temperature (init_T_freeze.ipp:
    16-31), drawn after the positions as there."""
    n_cell = cfg.n_cell
    if cfg.n_dims == 0:
        dv_host = 1.0 / np.asarray(rhod_host, float)
        cell_vol = float(dv_host[0])
    else:
        dv_host = cell_dv(cfg)
        cell_vol = cfg.dx * cfg.dy * cfg.dz
    lnrd_l, n_l, kpa_l, ijk_l, insol_l = [], [], [], [], []

    def add(lnrd, mult, key, ijk):
        kappa, rd_insol = key_parts(key)
        lnrd_l.append(lnrd)
        n_l.append(mult)
        kpa_l.append(np.full(lnrd.size, kappa))
        insol_l.append(np.full(lnrd.size, rd_insol))
        ijk_l.append(ijk)

    if oi.dry_distros and oi.sd_conc > 0:
        # sd_conc mode (init_SD_with_distros_sd_conc.ipp:14-45)
        analyses = {key: _dist_analysis_sd_conc(
            fun, oi.sd_conc, cell_vol, oi.rd_min, oi.rd_max)
            for key, fun in oi.dry_distros.items()}
        tot_rng = sum(a[1] - a[0] for a in analyses.values())
        for key, fun in oi.dry_distros.items():
            log_lo, log_hi, mult = analyses[key]
            count = int((log_hi - log_lo) / tot_rng * oi.sd_conc + 0.5)
            if count == 0:
                continue
            # rounding correction (init_SD_with_distros_sd_conc.ipp:27-29)
            mult *= oi.sd_conc / count
            # stratified ln(rd) sampling within each cell
            # (init_dry_sd_conc.ipp)
            u01 = rng.random((n_cell, count))
            strata = (np.arange(count)[None, :] + u01) / count
            lnrd = log_lo + strata * (log_hi - log_lo)
            # multiplicity: STP-corrected by rhod, scaled by the level's
            # concentration factor, volume-adjusted on a grid
            # (init_n.ipp:80-135)
            n_of = _eval_distro(fun, lnrd) * mult
            if not oi.aerosol_independent_of_rhod:
                n_of *= np.asarray(rhod_host)[:, None] / c.rho_stp
            factor = conc_factor_cells(cfg, oi)
            if factor is not None:
                n_of = n_of * factor[:, None]
            if cfg.n_dims > 0:
                n_of *= dv_host[:, None] / cell_vol
            add(lnrd.ravel(), np.floor(n_of + 0.5).ravel(), key,
                np.repeat(np.arange(n_cell), count))
            if oi.sd_conc_large_tail:
                # multiplicity-1 SDs from the tail above the sd_conc range
                # (init_SD_with_distros_tail.ipp)
                _, tail_hi = _dist_analysis_const_multi(fun)
                if tail_hi > log_hi:
                    t_lnrd, t_n, t_ijk = _sample_const_multi(
                        fun, log_hi, tail_hi, 1, oi, cfg, dv_host, rhod_host,
                        rng)
                    add(t_lnrd, t_n, key, t_ijk)
    elif oi.dry_distros and oi.sd_const_multi > 0:
        # const-multi mode (init_SD_with_distros_const_multi.ipp)
        for key, fun in oi.dry_distros.items():
            lnrd, mlt, ijk = _sample_const_multi(
                fun, *_dist_analysis_const_multi(fun), oi.sd_const_multi, oi,
                cfg, dv_host, rhod_host, rng)
            add(lnrd, mlt, key, ijk)

    if oi.dry_sizes:
        # dry_sizes mode (init_SD_with_sizes.ipp)
        for key, sizes in oi.dry_sizes.items():
            for radius, (conc, sd_count) in sizes.items():
                sd_count = int(sd_count)
                number = conc * dv_host
                if not oi.aerosol_independent_of_rhod:
                    number = number * np.asarray(rhod_host) / c.rho_stp
                factor = conc_factor_cells(cfg, oi)
                if factor is not None:
                    number = number * factor
                total = n_cell * sd_count
                add(np.full(total, math.log(radius)),
                    np.repeat(np.floor(number / sd_count + 0.5), sd_count),
                    key, np.repeat(np.arange(n_cell), sd_count))

    if not lnrd_l:
        raise ValueError(
            "lgrngn init: no SD init mode selected "
            "(set sd_conc, sd_const_multi or dry_sizes)")
    lnrd = np.concatenate(lnrd_l)
    ijk = np.concatenate(ijk_l).astype(np.int64)
    n_part = lnrd.size
    if n_part > cfg.n_sd_max:
        raise RuntimeError(f"lgrngn init: n_part ({n_part}) exceeds "
                           f"n_sd_max ({cfg.n_sd_max})")
    pop = dict(n=np.concatenate(n_l), rd3=np.exp(3.0 * lnrd),
               kpa=np.concatenate(kpa_l), **positions(cfg, ijk, rng),
               ijk=ijk, rd2_insol=np.concatenate(insol_l) ** 2)
    if cfg.ice_switch and not cfg.time_dep_ice_nucl:
        pop["T_freeze_u"] = rng.random(n_part)
    return pop


def positions(cfg: StaticConfig, ijk, rng):
    """Uniform positions in each SD's cell crossed with the Lagrangian
    domain (init_xyz.ipp:17-35) on the grid's axes (the JAX package's
    rules, hskpng.ijk_of_xyz's: x where the grid has an axis, y where ny >
    1, z where nz > 1 or the grid has two), drawn innermost first (z, y,
    then x) as in the JAX package; an axis the grid lacks stays at 0 and
    draws nothing.  Returns {x, y, z}."""
    axes = (("z", cfg.nz > 1 or cfg.n_dims >= 2, cfg.nz, cfg.z0, cfg.z1,
             cfg.dz),
            ("y", cfg.ny > 1, cfg.ny, cfg.y0, cfg.y1, cfg.dy),
            ("x", cfg.n_dims >= 1, cfg.nx, cfg.x0, cfg.x1, cfg.dx))
    coords = {k: np.zeros(len(ijk)) for k in "xyz"}
    idx = np.array(ijk)
    for name, on, n_axis, a0, a1, da in axes:
        if not on:
            continue
        axis_idx = idx % n_axis
        idx //= n_axis
        u01 = rng.random(idx.size)
        lo = np.maximum(a0, axis_idx * da)
        hi = np.minimum(a1, (axis_idx + 1) * da)
        coords[name] = u01 * hi + (1.0 - u01) * lo
    return coords


def init_wet(rd3, kpa, RH_sd, T_sd, RH_max):
    """Equilibrium wet radius squared at min(RH, RH_max) by the batched
    kappa-Koehler root solve (reference init_wet.ipp:18-77)."""
    rw3 = kappa_koehler.rw3_eq(rd3, kpa, torch.clamp(RH_sd, max=RH_max), T_sd)
    return rw3 ** (2.0 / 3)


def init_SD_state(cfg: StaticConfig, state: State, pop: dict) -> State:
    """The population ``pop`` (what init_SD or refinit.init_SD_reference
    returns) in the flat State's n_sd_max slots, the dead slots after the
    live ones (n 0, rd3 1e-30, cell 0), as the JAX package fills them; vt
    starts at zero.  Where ``pop`` holds ``T_freeze_u``, each SD's singular
    freezing temperature is the inverse CDF at it (a dead slot's at 0.5;
    libcloudphxx_tpu/lgrngn/init.py:349-355)."""
    pad = cfg.n_sd_max - pop["n"].size
    like = state.rd3

    def padded(a, fill=0.0, dtype=like.dtype):
        return torch.as_tensor(np.concatenate([a, np.full(pad, fill)]),
                               dtype=dtype, device=like.device)

    upd = {}
    rd2_insol = padded(pop["rd2_insol"])
    if "T_freeze_u" in pop:
        upd["T_freeze"] = ice_nucleation.T_freeze_CDF_inv(
            rd2_insol, padded(pop["T_freeze_u"], fill=0.5))
    return dataclasses.replace(
        state, n=padded(pop["n"]), rd3=padded(pop["rd3"], fill=1e-30),
        kpa=padded(pop["kpa"]), x=padded(pop["x"]), y=padded(pop["y"]),
        z=padded(pop["z"]),
        ijk=padded(pop["ijk"], fill=0, dtype=torch.int64),
        vt=torch.zeros_like(like), rd2_insol=rd2_insol, **upd)


def init_wet_state(state: State, RH_max) -> State:
    """init_wet on the flat State, from the cell RH and T of each SD; dead
    slots get rw2 = 0."""
    g = lambda a: a[state.ijk]
    rw2 = init_wet(state.rd3, state.kpa, g(state.RH), g(state.T), RH_max)
    return dataclasses.replace(state, rw2=torch.where(state.n > 0, rw2, 0.0))
