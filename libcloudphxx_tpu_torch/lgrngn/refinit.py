"""Reference-compatible super-droplet initialisation: mt19937 draws and
float32 arithmetic (libcloudphxx_tpu/lgrngn/refinit.py).

The reference's serial backend draws its init randoms from std::mt19937
through std::uniform_real_distribution<float> (src/detail/urand.hpp:20-88),
and the icicle host model instantiates the engine with real_t = float
(models/kinematic_2D/cases/icmw8_case1.hpp:21).  This module repeats the
draw order and the float32 arithmetic of the reference's sd_conc init:

    init_dist_analysis_sd_conc   (particles_impl_init_dist_analysis.ipp:38-77)
    init_count_num / init_ijk    (particles_impl_init_ijk.ipp:36-52)
    init_dry_sd_conc             (particles_impl_init_dry_sd_conc.ipp:43-90)
    init_n_sd_conc               (particles_impl_init_n.ipp:47-137)
    init_xyz                     (particles_impl_init_xyz.ipp:17-35, :40+)

so that positions, dry radii and multiplicities are the reference float
build's.  The mt19937 stream and glibc's float32 logf and expf come from
the C core (libcloudphxx_tpu_torch/native); numpy's float32 log and exp
differ from glibc's in the last bit at some inputs, which flips integer
multiplicities at the floor(+0.5) edge.  Only the sd_conc mode is
reproduced (what the GMD-2015 regression uses).
"""

import numpy as np

from ..common import constants as c
from .. import native
from . import init as init_host
from .state import StaticConfig

f32 = np.float32

# reference src/detail/config.hpp rd_min_init / rd_max_init
_RD_MIN_INIT = 1e-14
_RD_MAX_INIT = 1e-3


def logf(a):
    """glibc logf of every element, float32."""
    return native.vec_logf(np.asarray(a, f32))


def expf(a):
    """glibc expf of every element, float32."""
    return native.vec_expf(np.asarray(a, f32))


def _dist_analysis_sd_conc_f32(fun, sd_conc, cell_vol, rd_min=-1.0,
                               rd_max=-1.0):
    """float32 init_dist_analysis_sd_conc (the 1.01 bracketing walk):
    ``fun`` is evaluated at float32 arguments and its result cast to
    float32, as the reference's real_t=float distribution functor.
    Returns (log_rd_min, log_rd_max, multiplier) as float32."""
    if rd_min >= 0 and rd_max >= 0:
        mult = f32(logf(f32(rd_max) / f32(rd_min))[()] / f32(sd_conc)
                   * f32(cell_vol))
        return logf(f32(rd_min))[()], logf(f32(rd_max))[()], mult

    lo, hi = f32(_RD_MIN_INIT), f32(_RD_MAX_INIT)
    while True:
        # log(rd_max / rd_min) / sd_conc * dx * dy * dz, all float32
        mult = f32(f32(logf(hi / lo)[()]) / f32(sd_conc) * f32(cell_vol))
        log_lo = logf(lo)[()]
        log_hi = logf(hi)[()]
        n_min = int(f32(f32(fun(log_lo)) * mult))  # the n_t cast truncates
        n_max = int(f32(f32(fun(log_hi)) * mult))
        if lo == f32(_RD_MIN_INIT) and n_min != 0:
            raise RuntimeError(
                "Initial dry radii distribution is non-zero for rd_min_init")
        if hi == f32(_RD_MAX_INIT) and n_max != 0:
            raise RuntimeError(
                "Initial dry radii distribution is non-zero for rd_max_init")
        if n_min == 0:
            lo = f32(lo * f32(1.01))
        elif n_max == 0:
            hi = f32(hi / f32(1.01))
        else:
            return log_lo, log_hi, mult


def init_SD_reference(cfg: StaticConfig, oi, seed: int,
                      rhod_host: np.ndarray, dv_host: np.ndarray) -> dict:
    """sd_conc-mode init with the reference's mt19937 draw order and
    float32 arithmetic (libcloudphxx_tpu/lgrngn/refinit.py:135), on any
    grid.  ``rhod_host`` and ``dv_host`` are per-cell arrays, taken in
    float32 as the reference's device vectors (a parcel's dv is 1/rhod).
    Returns what init.init_SD returns: flat float64 numpy arrays {n, rd3,
    kpa, x, y, z} and the int64 ``ijk``."""
    if not (oi.dry_distros and oi.sd_conc > 0):
        raise ValueError("reference init replica supports sd_conc mode only")
    n_cell = cfg.n_cell
    rng = native.MT19937State(int(seed))
    rhod32 = np.asarray(rhod_host, f32)
    dv32 = np.asarray(dv_host, f32)
    # a parcel: the distribution analysis' multiplier takes dv[0], the
    # volume of 1 kg of dry air (init_dist_analysis.ipp:27-33)
    cell_vol = (float(dv32[0]) if cfg.n_dims == 0
                else cfg.dx * cfg.dy * cfg.dz)
    rho_stp32 = f32(c.rho_stp)

    # the total ln(rd) range over all distributions
    # (init_SD_with_distros.ipp:18-27)
    analyses = {}
    tot_rng = f32(0.0)
    for key, fun in oi.dry_distros.items():
        analyses[key] = _dist_analysis_sd_conc_f32(
            fun, oi.sd_conc, cell_vol, oi.rd_min, oi.rd_max)
        tot_rng = f32(tot_rng + f32(analyses[key][1] - analyses[key][0]))

    rd3_l, n_l, kpa_l, ijk_l, insol_l = [], [], [], [], []
    pos_l = {k: [] for k in "xyz"}
    for key, fun in oi.dry_distros.items():
        kappa, rd_insol = init_host.key_parts(key)
        log_lo, log_hi, mult = analyses[key]
        fraction = f32(f32(log_hi - log_lo) / tot_rng)
        # multiplier *= sd_conc / int(fraction * sd_conc + .5), an integer
        # division (init_SD_with_distros_sd_conc.ipp:28)
        count_round = int(f32(fraction * f32(oi.sd_conc)) + 0.5)
        if count_round == 0:
            continue
        mult = f32(mult * f32(int(oi.sd_conc) // count_round))
        # count_num = n_t(fraction * sd_conc), truncated
        count = int(f32(fraction * f32(oi.sd_conc)))
        if count == 0:
            continue
        n_to_init = n_cell * count
        ijk = np.repeat(np.arange(n_cell, dtype=np.int64), count)

        # dry radii (init_dry_sd_conc.ipp calc_lnrd)
        u01 = rng.u01(n_to_init)
        stratum = np.tile(np.arange(count, dtype=np.uint64), n_cell)
        t = stratum.astype(f32) + u01
        lnrd = f32(log_lo + t * f32(log_hi - log_lo) / f32(count))
        rd3 = expf(f32(3.0) * lnrd)

        # multiplicities (init_n.ipp:47-137): ln(rd) again from rd3 as
        # real_t(log(x) / 3.), logf widened, divided in double, cast back
        lnrd_back = f32(logf(rd3).astype(np.float64) / 3.0)
        val = f32(mult * init_host._eval_distro(fun, lnrd_back).astype(f32))
        if not oi.aerosol_independent_of_rhod:
            val = f32(val * rhod32[ijk] / rho_stp32)
        factor = init_host.conc_factor_cells(cfg, oi)
        if factor is not None:
            # between the STP correction and the volume adjustment
            # (particles_impl_init_n.ipp:100-110)
            val = f32(val * factor.astype(f32)[ijk])
        if cfg.n_dims > 0:
            val = f32(val * dv32[ijk] / f32(f32(cfg.dx) * f32(cfg.dy)
                                            * f32(cfg.dz)))
        n_l.append(np.floor(val + f32(0.5)).astype(np.float64))

        # positions (init_xyz.ipp), drawn x, y, z over the axes the grid
        # has; the others stay at 0
        idx = dict(zip("xyz", (ijk // (cfg.nz * cfg.ny),
                               (ijk // cfg.nz) % cfg.ny, ijk % cfg.nz)))
        for name, n_axis in (("x", oi.nx), ("y", oi.ny), ("z", oi.nz)):
            if n_axis == 0:
                pos_l[name].append(np.zeros(n_to_init))
                continue
            ii = idx[name]
            p0, p1 = getattr(oi, name + "0"), getattr(oi, name + "1")
            dp = getattr(oi, "d" + name)
            u = rng.u01(n_to_init)
            hi_b = np.minimum(f32(p1), (ii + 1).astype(f32) * f32(dp))
            lo_b = np.maximum(f32(p0), ii.astype(f32) * f32(dp))
            # u01 * min(...) is float32; (1. - u01) * max(...) is double,
            # and the sum is cast back to real_t (init_xyz.ipp:33)
            pos = f32((u * hi_b).astype(np.float64)
                      + (1.0 - u.astype(np.float64)) * lo_b.astype(np.float64))
            pos_l[name].append(pos.astype(np.float64))
        # the reference keeps rd3 in float32 (expf)
        rd3_l.append(rd3.astype(np.float64))
        kpa_l.append(np.full(n_to_init, kappa))
        insol_l.append(np.full(n_to_init, rd_insol))
        ijk_l.append(ijk)

    n_part = sum(a.size for a in n_l)
    if n_part > cfg.n_sd_max:
        raise RuntimeError(f"lgrngn init: n_part ({n_part}) exceeds "
                           f"n_sd_max ({cfg.n_sd_max})")
    cat = np.concatenate
    return dict(n=cat(n_l), rd3=cat(rd3_l), kpa=cat(kpa_l),
                **{k: cat(v) for k, v in pos_l.items()}, ijk=cat(ijk_l),
                rd2_insol=cat(insol_l) ** 2)
