"""Super-droplet initialisation, sd_conc mode
(libcloudphxx_tpu/lgrngn/init.py; reference src/impl/initialization/).

The distribution analysis and the sampling run in numpy with the caller's
``numpy.random.Generator`` and the JAX package's draw order, so one seed
gives the JAX package's population draw for draw; the equilibrium wet
radius is solved on the tensors' device.
"""

import math

import numpy as np
import torch

from ..common import constants as c
from ..common import kappa_koehler
from .state import StaticConfig

# reference src/detail/config.hpp:21-24
RD_MIN_INIT = 1e-14
RD_MAX_INIT = 1e-3


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


def init_SD(cfg: StaticConfig, oi, rng: np.random.Generator,
            rhod_host: np.ndarray) -> dict:
    """The initial super-droplets of a 2-D grid in sd_conc mode
    (reference init_SD_with_distros_sd_conc.ipp:14-45, init_dry_sd_conc.ipp,
    init_n.ipp, init_xyz.ipp).  Returns flat float64 numpy arrays
    {n, rd3, kpa, x, z} and the int64 cell index ``ijk``, sorted by cell
    within each distribution, as the JAX package lays them out."""
    unported = [name for name, on in (
        ("sd_const_multi", oi.sd_const_multi > 0),
        ("dry_sizes", bool(oi.dry_sizes)),
        ("sd_conc_large_tail", oi.sd_conc_large_tail),
        ("aerosol_conc_factor", len(oi.aerosol_conc_factor) > 0),
        ("reference_rng_init", oi.reference_rng_init),
        ("no_ccn_at_init", oi.no_ccn_at_init)) if on]
    if unported or cfg.n_dims != 2 or not (oi.dry_distros and oi.sd_conc > 0):
        raise NotImplementedError(
            f"init_SD: only 2-D sd_conc init is ported (got {unported or 'no sd_conc distros'}, "
            f"n_dims={cfg.n_dims}; ROADMAP.md, Queue 1)")
    n_cell = cfg.n_cell
    cell_vol = cfg.dx * cfg.dy * cfg.dz
    dv_host = cell_dv(cfg)

    analyses = {key: _dist_analysis_sd_conc(
        fun, oi.sd_conc, cell_vol, oi.rd_min, oi.rd_max)
        for key, fun in oi.dry_distros.items()}
    tot_rng = sum(a[1] - a[0] for a in analyses.values())

    lnrd_l, n_l, kpa_l, ijk_l = [], [], [], []
    for key, fun in oi.dry_distros.items():
        kappa = key[0] if isinstance(key, tuple) else key
        log_lo, log_hi, mult = analyses[key]
        count = int((log_hi - log_lo) / tot_rng * oi.sd_conc + 0.5)
        if count == 0:
            continue
        # rounding correction (init_SD_with_distros_sd_conc.ipp:27-29)
        mult *= oi.sd_conc / count
        # stratified ln(rd) sampling within each cell (init_dry_sd_conc.ipp)
        u01 = rng.random((n_cell, count))
        strata = (np.arange(count)[None, :] + u01) / count
        lnrd = log_lo + strata * (log_hi - log_lo)
        # multiplicity: STP-corrected by rhod, volume-adjusted (init_n.ipp)
        n_of = _eval_distro(fun, lnrd) * mult
        if not oi.aerosol_independent_of_rhod:
            n_of *= np.asarray(rhod_host)[:, None] / c.rho_stp
        n_of *= dv_host[:, None] / (cfg.dx * cfg.dy * cfg.dz)
        lnrd_l.append(lnrd.ravel())
        n_l.append(np.floor(n_of + 0.5).ravel())
        kpa_l.append(np.full(n_cell * count, kappa))
        ijk_l.append(np.repeat(np.arange(n_cell), count))

    lnrd = np.concatenate(lnrd_l)
    ijk = np.concatenate(ijk_l)
    n_part = lnrd.size
    if n_part > cfg.n_sd_max:
        raise RuntimeError(
            f"lgrngn init: n_part ({n_part}) exceeds n_sd_max ({cfg.n_sd_max})")

    # uniform positions in the cell crossed with the Lagrangian domain
    # (init_xyz.ipp:17-35), z drawn before x as in the JAX package
    coords = {}
    idx = ijk.copy()
    for name, n_axis, a0, a1, da in (
            ("z", cfg.nz, cfg.z0, cfg.z1, cfg.dz),
            ("x", cfg.nx, cfg.x0, cfg.x1, cfg.dx)):
        axis_idx = idx % n_axis
        idx //= n_axis
        u01 = rng.random(n_part)
        lo = np.maximum(a0, axis_idx * da)
        hi = np.minimum(a1, (axis_idx + 1) * da)
        coords[name] = u01 * hi + (1.0 - u01) * lo

    return dict(n=np.concatenate(n_l), rd3=np.exp(3.0 * lnrd),
                kpa=np.concatenate(kpa_l), x=coords["x"], z=coords["z"],
                ijk=ijk)


def init_wet(rd3, kpa, RH_sd, T_sd, RH_max):
    """Equilibrium wet radius squared at min(RH, RH_max) by the batched
    kappa-Koehler root solve (reference init_wet.ipp:18-77)."""
    rw3 = kappa_koehler.rw3_eq(rd3, kpa, torch.clamp(RH_sd, max=RH_max), T_sd)
    return rw3 ** (2.0 / 3)
