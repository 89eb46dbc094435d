"""Build and load the port's CUDA kernels (csrc/), and count their launches.

The kernels are CUDA C++ for sm_90a with a plain C interface: at first use
one nvcc per csrc/*.cu compiles it to an object file, all of them at once,
and one more links the objects into a shared library in ``_build/`` beside
this file (a directory git ignores), which ctypes loads.  The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here runs at import: tests import every module on machines
without nvcc or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_D = ctypes.c_double


class Kernel:
    """One hand-written kernel: its C entry point, the TPU kernel it
    replaces, and ``launches``, the number of times a wrapper launched it
    (reset it to 0 to count a run)."""

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # the stream comes last
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, *args):
        """Launch on PyTorch's current stream; raise if the launch failed."""
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            msg = load().lcp_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed, CUDA error "
                               f"{err} ({msg})")
        self.launches += 1


# fields in and out, courants, G; nfields, nx, nz, n_iters, fct; the
# launch plan (models/mpdata.py launch_plan: CTAs a cluster, columns a
# CTA, shared bytes a CTA)
MPDATA = Kernel(
    "mpdata", "lcp_mpdata", [_P] * 5 + [_I] * 8,
    "libcloudphxx_tpu_torch/csrc/mpdata.cu",
    "libcloudphxx_tpu/models/mpdata.py:256 (advect2; advect :226)")
# planes in (4), cells, rw2 out, cells out, scratch (positions, floats),
# row order; n_cell, cap, sstp; dt_sub, RH_max; th_dry, const_p, RH
# formula, iterations, vt formula
COND = Kernel(
    "cond", "lcp_cond", [_P] * 10 + [_I, _I, _I, _D, _D] + [_I] * 5,
    "libcloudphxx_tpu_torch/csrc/cond.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, cond phase :191-231)")
# planes in (5), cells, outputs (5), row info; n_cell, cap, nx, nz; dx, dz,
# dt, x0, x1, z0, z1; implicit, do_adve, do_sedi, do_subs, open side
# walls, periodic top/bottom walls, vt formula
TRANSPORT = Kernel(
    "transport", "lcp_transport",
    [_P] * 12 + [_I, _I, _I, _I] + [_D] * 7 + [_I] * 7,
    "libcloudphxx_tpu_torch/csrc/transport.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, transport and "
    "re-bin classification :338-487)")
# kernel C's unwrapped form on a shard of the x-slab mesh: TRANSPORT's
# arguments, then the shard's first column and its width
TRANSPORT_UNWRAPPED = Kernel(
    "transport_unwrapped", "lcp_transport_unwrapped",
    TRANSPORT.argtypes[:-1] + [_I, _I],
    "libcloudphxx_tpu_torch/csrc/transport.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel with x_wrap=False, "
    ":378-382; lgrngn/dense.py:1373 _shard_phase)")
# kernel C's pred_corr form (predictor-corrector SD advection): TRANSPORT's
# arguments, then the staggered courant_x and courant_z
TRANSPORT_PRED_CORR = Kernel(
    "transport_pred_corr", "lcp_transport_pred_corr",
    TRANSPORT.argtypes[:-1] + [_P, _P],
    "libcloudphxx_tpu_torch/csrc/transport.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, transport :338-487) "
    "with the pred_corr advection that the JAX package runs in XLA "
    "(lgrngn/dense.py:962-1005)")
# kernel C's pred_corr form on a shard of the x-slab mesh: TRANSPORT's
# arguments, the shard's first column and its width, then its courant_x
# and courant_z in the halo-2 layout (parallel/decomp.xchng_courants_pc)
TRANSPORT_PRED_CORR_UNWRAPPED = Kernel(
    "transport_pred_corr_unwrapped", "lcp_transport_pred_corr_unwrapped",
    TRANSPORT.argtypes[:-1] + [_I, _I, _P, _P],
    "libcloudphxx_tpu_torch/csrc/transport.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel with x_wrap=False, "
    ":378-382) with the pred_corr advection that the JAX package's mesh "
    "runs in XLA (lgrngn/dense.py:962-1005 with x_wrap=False; "
    "parallel/dense_mesh.py:320-328)")
# planes in (7), targets, planes out (7), drops; n_cell, cap, nx, nz
MERGE = Kernel(
    "merge", "lcp_merge", [_P] * 16 + [_I, _I, _I, _I],
    "libcloudphxx_tpu_torch/csrc/merge.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:716 (_xmerge_kernel) and :405 "
    "(_kernel z-merge epilogue)")
# kernel D's 11-plane form (exact mode: the private ambient planes ride):
# planes in (11), targets, planes out (11), drops; n_cell, cap, nx, nz
MERGE_EXACT = Kernel(
    "merge_exact", "lcp_merge_exact", [_P] * 24 + [_I, _I, _I, _I],
    "libcloudphxx_tpu_torch/csrc/merge_exact.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:716 (_xmerge_kernel) and :405 "
    "(_kernel z-merge epilogue), with the exact mode's per-SD ambient "
    "planes (lgrngn/dense.py:1088-1180 rebin over attrs_of)")
# planes in (6), cells, table; the outputs; the flags, n_cell, cap, sstp;
# dt_sub, kernel, coef, r_max - 1e-6, clamp, seed, step, vt formula; the
# resident form also the pairing and the global index of the first row
_COAL_TAIL = [_P, _I, _I, _I, _D, _I, _D, _D, _I, _U, _U, _I]
COAL = Kernel(
    "coal", "lcp_coal", [_P] * 8 + [_P] * 6 + _COAL_TAIL + [_I, _U],
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, coal phase :233-336)")
# kernel E's wide-table form (vohl_davis_no_waals: a (K+2)-square table,
# K = 150), the resident step's form: COAL's arguments
COAL_VOHL = Kernel(
    "coal_vohl", "lcp_coal_vohl", COAL.argtypes[:-1],
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, coal phase :233-336) "
    "with vohl's efficiencies, which the JAX package reads in XLA "
    "(lgrngn/coalescence.py:374-376; the TPU kernel refuses vohl, "
    "lgrngn/dense.py:1219-1229)")
COAL_STANDALONE = Kernel(
    "coal_standalone", "lcp_coal_standalone",
    [_P] * 8 + [_P] * 7 + _COAL_TAIL,
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    "libcloudphxx_tpu/ops/pallas_coal.py:99 (_kernel)")
# SD arrays in (5), ends, cells, rw2 out, cells out, scratch (positions,
# floats), cell order; n_cell, n_sd, sstp; dt_sub, RH_max; th_dry,
# const_p, RH formula, var_rho, iterations
COND_FLAT = Kernel(
    "cond_flat", "lcp_cond_flat", [_P] * 12 + [_I, _I, _I, _D, _D] + [_I] * 5,
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    "libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
    ":46, with the host substep loop of lgrngn/condensation.py:312-388)")
# SD arrays in (12: rw2 rd3 kpa vt rhod rv T p RH eta lam_D lam_K), the
# per-droplet dt (or null), rw2 out; n; dt, RH_max; iterations
COND_SD = Kernel(
    "cond_sd", "lcp_cond_sd", [_P] * 14 + [_L, _D, _D, _I],
    "libcloudphxx_tpu_torch/csrc/cond_sd.cu",
    "libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
    ":46, call :78), per-droplet ambient callers (lgrngn/condensation.py "
    ":468 cond_perparticle, :684 perparticle_adaptive_core; lgrngn/"
    "dense.py:359 step_cond_exact, :456 step_cond_adaptive; off every path "
    "of the port, where COND_SD_FIXED and COND_SD_ADAPTIVE run them)")
# kernel G's fixed-count form: SD arrays in (9: n rw2 rd3 kpa vt and the
# private th rv rhod p), cells (7: th rv rhod p dv lam_D lam_K), the
# layout (order, ends, sijk; null for dense rows), outputs (5: rw2 th rv
# rhod p), scratch positions; n_cell, cap, sstp; dt, RH_max; th_dry,
# const_p, RH formula, mixing, iterations
COND_SD_FIXED = Kernel(
    "cond_sd_fixed", "lcp_cond_sd_fixed", [_P] * 25 + [_I] * 3 + [_D] * 2
    + [_I] * 5,
    "libcloudphxx_tpu_torch/csrc/cond_sd_fixed.cu",
    "libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
    ":46, call :78) with the substep loop around it: lgrngn/"
    "condensation.py:468 cond_perparticle, lgrngn/dense.py:359 "
    "step_cond_exact")
# kernel G's adaptive form: the fixed form's pointers with the cells' T
# after lam_K and without the scratch positions; n_cell, cap, n_slots,
# sstp, sstp_act; dt, RH_max, the drw2 criteria (eps, max); th_dry,
# const_p, RH formula, iterations
COND_SD_ADAPTIVE = Kernel(
    "cond_sd_adaptive", "lcp_cond_sd_adaptive", [_P] * 25 + [_I, _I, _L]
    + [_I] * 2 + [_D] * 4 + [_I] * 4,
    "libcloudphxx_tpu_torch/csrc/cond_sd_adaptive.cu",
    "libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
    ":46, call :78) with the loops around it: lgrngn/condensation.py:684 "
    "perparticle_adaptive_core, lgrngn/dense.py:456 step_cond_adaptive")
# the turb_cond forms of kernels F and G (the SGS supersaturation
# perturbation ssp at each SD's RH): each form's arguments, then F's
# sorted ssp and dot_ssp in and ssp out (its scratch 8 rows), G-fixed's
# ssp, G-adaptive's ssp and dot_ssp in and ssp out
_TURB = ("libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
         ":46, call :78) at each SD's RH plus its SGS supersaturation "
         "perturbation ssp, with ")
COND_FLAT_TURB = Kernel(
    "cond_flat_turb", "lcp_cond_flat_turb", COND_FLAT.argtypes[:-1] + [_P] * 3,
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _TURB + "the host substep loop of lgrngn/condensation.py:312-388 "
    "(ssp += dt_sub dot_ssp a substep, :353-358)")
COND_SD_FIXED_TURB = Kernel(
    "cond_sd_fixed_turb", "lcp_cond_sd_fixed_turb",
    COND_SD_FIXED.argtypes[:-1] + [_P],
    "libcloudphxx_tpu_torch/csrc/cond_sd_fixed.cu",
    _TURB + "the substep loop of lgrngn/condensation.py:412-528 "
    "cond_perparticle (RHp + ssp, :462-463)")
COND_SD_ADAPTIVE_TURB = Kernel(
    "cond_sd_adaptive_turb", "lcp_cond_sd_adaptive_turb",
    COND_SD_ADAPTIVE.argtypes[:-1] + [_P] * 3,
    "libcloudphxx_tpu_torch/csrc/cond_sd_adaptive.cu",
    _TURB + "the loops of lgrngn/condensation.py:655-790 "
    "perparticle_adaptive_core (ssp on the tries and substeps, rewound, "
    ":711-734, :757-758, :776)")
# the parcel forms of kernels F and G (a parcel's cell is 1 kg of dry
# air: F weighs a droplet by 1 / (dv rhod) with dv = 1 / rhod at each
# substep, G feeds an SD's private air its vapour undivided), without and
# with turb_cond: each the arguments of its grid form; F's and G-fixed's
# (a cluster of CTAs a cell, G-fixed's without the scratch positions)
# then their plan (ops/cond.py parcel_plan: CTAs a cluster, threads a CTA)
_PARCEL = ("libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; "
           "advance_rw2_pallas :46, call :78) in a parcel (n_dims 0: dv = "
           "1/rhod, libcloudphxx_tpu/lgrngn/hskpng.py:50), with ")
_PLAN = [_I, _I]
COND_FLAT_PARCEL = Kernel(
    "cond_flat_parcel", "lcp_cond_flat_parcel", COND_FLAT.argtypes[:-1]
    + _PLAN, "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _PARCEL + "the host substep loop of lgrngn/condensation.py:312-388 "
    "(the weight's dv * rhod at each substep, :366)")
COND_FLAT_PARCEL_TURB = Kernel(
    "cond_flat_parcel_turb", "lcp_cond_flat_parcel_turb",
    COND_FLAT_TURB.argtypes[:-1] + _PLAN,
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _PARCEL + "the host substep loop of lgrngn/condensation.py:312-388 at "
    "each SD's RH plus its ssp (:353-358)")
_SD_PARCEL = COND_SD_FIXED.argtypes[:24] + COND_SD_FIXED.argtypes[25:-1]
COND_SD_FIXED_PARCEL = Kernel(
    "cond_sd_fixed_parcel", "lcp_cond_sd_fixed_parcel", _SD_PARCEL + _PLAN,
    "libcloudphxx_tpu_torch/csrc/cond_sd_fixed.cu",
    _PARCEL + "the substep loop of lgrngn/condensation.py:412-528 "
    "cond_perparticle (drv per kg of air, :478-481)")
COND_SD_FIXED_PARCEL_TURB = Kernel(
    "cond_sd_fixed_parcel_turb", "lcp_cond_sd_fixed_parcel_turb",
    _SD_PARCEL + [_P] + _PLAN,
    "libcloudphxx_tpu_torch/csrc/cond_sd_fixed.cu",
    _PARCEL + "the substep loop of lgrngn/condensation.py:412-528 "
    "cond_perparticle (drv per kg of air, :478-481; RHp + ssp, :462-463)")
COND_SD_ADAPTIVE_PARCEL = Kernel(
    "cond_sd_adaptive_parcel", "lcp_cond_sd_adaptive_parcel",
    COND_SD_ADAPTIVE.argtypes[:-1],
    "libcloudphxx_tpu_torch/csrc/cond_sd_adaptive.cu",
    _PARCEL + "the loops of lgrngn/condensation.py:655-795 "
    "perparticle_adaptive_core (drv per kg of air, :787-790)")
COND_SD_ADAPTIVE_PARCEL_TURB = Kernel(
    "cond_sd_adaptive_parcel_turb", "lcp_cond_sd_adaptive_parcel_turb",
    COND_SD_ADAPTIVE_TURB.argtypes[:-1],
    "libcloudphxx_tpu_torch/csrc/cond_sd_adaptive.cu",
    _PARCEL + "the loops of lgrngn/condensation.py:655-795 "
    "perparticle_adaptive_core (drv per kg of air, :787-790; ssp on the "
    "tries and substeps, :711-734, :757-758, :776)")
# the ice forms of kernel F (ice_switch: the deposition after each
# substep's liquid growth): each warm form's arguments, then the sorted
# ice_a, ice_c and ice_rho in and ice_a and ice_c out (the scratch 3 rows
# more, the cells out 5 rows: th, rv, rhod and the th and rv of the last
# substep's closure)
_ICE = ("libcloudphxx_tpu/ops/pallas_cond.py:34 (_kernel; advance_rw2_pallas "
        ":46, call :78) at its ice caller, the unsorted substep loop of "
        "lgrngn/condensation.py:248-305 with lgrngn/ice.py:106 "
        "ice_dep_substep after each call")
COND_FLAT_ICE = Kernel(
    "cond_flat_ice", "lcp_cond_flat_ice", COND_FLAT.argtypes[:-1] + [_P] * 5,
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu", _ICE)
COND_FLAT_ICE_TURB = Kernel(
    "cond_flat_ice_turb", "lcp_cond_flat_ice_turb",
    COND_FLAT_TURB.argtypes[:-1] + [_P] * 5,
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _ICE + ", at each SD's RH plus its ssp (:254-263)")
COND_FLAT_PARCEL_ICE = Kernel(
    "cond_flat_parcel_ice", "lcp_cond_flat_parcel_ice",
    COND_FLAT_ICE.argtypes[:-1], "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _ICE + ", in a parcel (dv = 1/rhod, lgrngn/hskpng.py:50)")
COND_FLAT_PARCEL_ICE_TURB = Kernel(
    "cond_flat_parcel_ice_turb", "lcp_cond_flat_parcel_ice_turb",
    COND_FLAT_ICE_TURB.argtypes[:-1],
    "libcloudphxx_tpu_torch/csrc/cond_flat.cu",
    _ICE + ", in a parcel (dv = 1/rhod, lgrngn/hskpng.py:50), at each SD's "
    "RH plus its ssp (:254-263)")
# kernel C's 3-D forms: TRANSPORT's arguments, then the y plane in and out
# and the y axis (ny; dy, y0, y1); the pred_corr form then the staggered
# courant_x, courant_z and courant_y
_3D = ("libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, transport and "
       "re-bin classification :338-487) on the 3-D grid, which the TPU "
       "kernel refuses (lgrngn/dense.py:1209-1241) and the JAX package runs "
       "in XLA (lgrngn/dense.py:918-1030 adve_sedi_bcnd")
TRANSPORT_3D = Kernel(
    "transport_3d", "lcp_transport_3d",
    TRANSPORT.argtypes[:-1] + [_P, _P, _I, _D, _D, _D],
    "libcloudphxx_tpu_torch/csrc/transport3d.cu", _3D + ")")
TRANSPORT_3D_PRED_CORR = Kernel(
    "transport_3d_pred_corr", "lcp_transport_3d_pred_corr",
    TRANSPORT_3D.argtypes[:-1] + [_P] * 3,
    "libcloudphxx_tpu_torch/csrc/transport3d.cu",
    _3D + ", its pred_corr branch :962-1005)")
# kernel D's 3-D forms (27 source rows, x and y periodic; a brick of
# destination rows a block): planes in (8: n rw2 rd3 kpa vt x z y),
# targets, planes out (8), drops; n_cell, cap, nx, ny, nz, the brick's rows
# (ops/step.py merge3d_plan); the exact mode's with the four private
# planes after the eight
_MERGE_3D = ("libcloudphxx_tpu/ops/pallas_step.py:716 (_xmerge_kernel) and "
             ":405 (_kernel z-merge epilogue) on the 3-D grid, which the JAX "
             "package re-bins in XLA (lgrngn/dense.py:1095-1180 "
             "_rebin_neighbor, rebin")
MERGE_3D = Kernel(
    "merge_3d", "lcp_merge_3d", [_P] * 18 + [_I] * 6,
    "libcloudphxx_tpu_torch/csrc/merge3d.cu", _MERGE_3D + ")")
MERGE_3D_EXACT = Kernel(
    "merge_3d_exact", "lcp_merge_3d_exact", [_P] * 26 + [_I] * 6,
    "libcloudphxx_tpu_torch/csrc/merge3d_exact.cu",
    _MERGE_3D + ", with the exact mode's per-SD ambient planes)")
# kernel E's y forms (the 3-D grid's y plane riding) and its onishi form
# (the turbulent kernels at dissipation rate 0): COAL's arguments up to the
# pairing, then the y plane in and out (null twice for the onishi form off
# the 3-D grid) and the scratch of n_cell + 1 ints (csrc/coal_y.cuh: the
# rows above 128 slots that the one-warp pass leaves to the wide form; null
# up to cap 128)
_COAL_Y = ("libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, coal phase "
           ":233-336) ")
COAL_3D = Kernel(
    "coal_3d", "lcp_coal_3d", COAL.argtypes[:-2] + [_P, _P, _P],
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    _COAL_Y + "on the 3-D grid, whose sort pairing carries y in the JAX "
    "package's XLA coalescence (lgrngn/dense.py:801-804)")
COAL_VOHL_3D = Kernel(
    "coal_vohl_3d", "lcp_coal_vohl_3d", COAL_3D.argtypes[:-1],
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    _COAL_Y + "on the 3-D grid with vohl's efficiencies (lgrngn/dense.py:"
    "801-804; lgrngn/coalescence.py:374-376)")
# kernel E's onishi form: COAL's arguments (row0 last), then the y plane in
# and out (null twice off the 3-D grid; row0 0 on it) and the scratch
COAL_ONISHI = Kernel(
    "coal_onishi", "lcp_coal_onishi", COAL.argtypes[:-1] + [_P, _P, _P],
    "libcloudphxx_tpu_torch/csrc/coal.cu",
    _COAL_Y + "with the onishi kernels at dissipation rate 0, which the JAX "
    "package computes in XLA (lgrngn/dense.py:606, :738; "
    "lgrngn/coalescence.py:377-388) and its TPU kernel refuses "
    "(lgrngn/dense.py:1221-1225)")
# kernel B's merge-prologue form (the deferred re-binning, then the
# condensation of the merged rows): COND's arguments (the planes before the
# merge), then the planes vt, x, z before it, the targets, the seven merged
# planes out, the drops a row, nx and nz
COND_MERGED = Kernel(
    "cond_merged", "lcp_cond_merged", COND.argtypes[:-1] + [_P] * 12
    + [_I, _I],
    "libcloudphxx_tpu_torch/csrc/cond_merged.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel with do_xmerge, the "
    "deferred-x prologue :170-175 over _xmerge_values :53; "
    "step_resident(..., xkey) :537)")
# kernel D's MPDATA-epilogue form: MERGE's arguments, then th and rv in,
# their advected fields out, gc_x, gc_z, G; n_iters, fct, the plan
# (models/mpdata.py launch_plan: CTAs a cluster, columns a CTA, shared
# bytes a CTA)
MERGE_MPDATA = Kernel(
    "merge_mpdata", "lcp_merge_mpdata", MERGE.argtypes[:-1] + [_P] * 7
    + [_I] * 5,
    "libcloudphxx_tpu_torch/csrc/merge_mpdata.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:716 (_xmerge_kernel with mp_iters, "
    "the MPDATA epilogue :740-757; rebin_x(..., mpdata_fields) :765)")
KERNELS = (MPDATA, COND, TRANSPORT, MERGE, COAL, COAL_STANDALONE,
           COND_FLAT, COND_SD, TRANSPORT_UNWRAPPED, MERGE_EXACT,
           COND_SD_FIXED, COND_SD_ADAPTIVE, COAL_VOHL, TRANSPORT_PRED_CORR,
           COND_FLAT_TURB, COND_SD_FIXED_TURB, COND_SD_ADAPTIVE_TURB,
           COND_FLAT_PARCEL, COND_FLAT_PARCEL_TURB, COND_SD_FIXED_PARCEL,
           COND_SD_FIXED_PARCEL_TURB, COND_SD_ADAPTIVE_PARCEL,
           COND_SD_ADAPTIVE_PARCEL_TURB, COND_FLAT_ICE, COND_FLAT_ICE_TURB,
           COND_FLAT_PARCEL_ICE, COND_FLAT_PARCEL_ICE_TURB, TRANSPORT_3D,
           TRANSPORT_3D_PRED_CORR, MERGE_3D, MERGE_3D_EXACT, COAL_3D,
           COAL_VOHL_3D, COAL_ONISHI, TRANSPORT_PRED_CORR_UNWRAPPED,
           COND_MERGED, MERGE_MPDATA)

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"libcloudphxx_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("building the kernels needs nvcc (the CUDA toolkit); "
                       "none was found")


def build(verbose=False):
    """Compile csrc/ unless the library for these sources exists: one nvcc
    per source, all started together, then one link.  Returns (path,
    seconds spent compiling, compiler output).  With ``verbose`` the
    compiler also reports each kernel's registers and shared memory."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, f"{p.stem}.o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", o, str(p)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for p, o in zip(cu, objs)]
        logs = [pr.communicate()[0] for pr in procs]
        failed = [(p.name, pr.returncode, log)
                  for p, pr, log in zip(cu, procs, logs) if pr.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                               *objs], capture_output=True, text=True,
                              check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, out)
    return out, time.perf_counter() - t0, "".join(logs)


def load():
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.lcp_error_string.argtypes = [_I]
        lib.lcp_error_string.restype = ctypes.c_char_p
        lib.lcp_mpdata_clusters.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.lcp_mpdata_clusters.restype = _I
        _lib = lib
    return _lib


def max_clusters(kernel, ctas, threads):
    """How many clusters of ``ctas`` CTAs of ``threads`` threads of a
    cluster kernel (F's and G-fixed's parcel forms) the card holds at
    once: 0 where it takes no cluster of that size."""
    fn = getattr(load(), kernel.symbol + "_clusters")
    fn.argtypes = [_I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    count = _I(0)
    fn(ctas, threads, ctypes.byref(count))
    return count.value


# what attributes() reports of a kernel
ATTRS = ("registers", "static_shared", "dynamic_shared", "local",
         "blocks_per_sm", "threads", "warps_a_row", "slots_a_lane")


def attributes(query, *args):
    """What the card makes of a kernel: the C query ``query`` (kernel D's
    3-D forms' ``lcp_merge_3d_attrs`` and ``lcp_merge_3d_exact_attrs``
    with (vec, brick, cap); kernel E's y and onishi forms'
    ``lcp_coal_y_attrs`` with (vt, sort, cap, narrow): the wide form, or
    with narrow 1 the one-warp pass) over cudaFuncGetAttributes
    and cudaOccupancyMaxActiveBlocksPerMultiprocessor, as {ATTRS[i]: int}
    (registers a thread, shared memory static and dynamic and local memory
    a thread in bytes, blocks an SM, threads a block; E's forms also warps
    a row and register slots a lane).  Raises with the CUDA error of the
    query (D's sets the dynamic shared memory first)."""
    fn = getattr(load(), query)
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * len(ATTRS))()
    err = fn(*args, out)
    if err:
        raise RuntimeError(f"{query}{args}: CUDA error {err} "
                           f"({load().lcp_error_string(err).decode()})")
    return dict(zip(ATTRS, out))


def use_plain(name, t, plain):
    """Whether a wrapper runs its plain version: with ``plain``, or for a
    tensor on the CPU.  A CUDA tensor launches the kernel; any other device
    raises."""
    if plain or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def longest_first(counts):
    """The cells in descending order of their droplets ``counts`` (int32,
    ties in cell order): the order in which the condensation kernels (B,
    F) hand cells to warps, so that the longest cells start first and the
    shortest fill the end."""
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def cond_scratch(n_slots, device, rows=6):
    """The per-slot scratch of the condensation kernels (B, F): each
    cell's live droplets, compacted, as int32 positions and ``rows``
    float32 rows: six (rw2, rd3, rd3 * (1 - kappa), rd^2, vt, the weight's
    numerator), F's turb_cond form's eight (ssp and dot_ssp too), and its
    ice forms' three more (ice_a, ice_c, ice_rho)."""
    return (torch.empty(n_slots, dtype=torch.int32, device=device),
            torch.empty((rows, n_slots), dtype=torch.float32, device=device))


def check_planes(name, cap, *planes):
    """Raise unless every SD plane is (n_cell, cap), all of one shape."""
    for p in planes:
        if p.dim() != 2 or p.shape[1] != cap or p.shape != planes[0].shape:
            raise ValueError(f"{name}: SD planes must all be (n_cell, {cap}), "
                             f"got {tuple(p.shape)}")


def check(name, *tensors, dtype=torch.float32):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one device — what each kernel takes."""
    dev = tensors[0].device
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors lie on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must lie on one CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
