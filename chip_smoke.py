#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libcloudphxx_tpu_torch) on one GPU.

Drives the port's paths, the GMD-2015 kinematic lgrngn case at 76x76
cells and 64 super-droplets a cell with sstp_cond = sstp_coal = 10 and the
geometric kernel (bench.py's configuration), on the dense engine (kernels
A-E; with exact per-particle condensation A, C, D, E and G's fixed-count
or adaptive form) through run_device_lgrngn and through the public API's
dense front, and on the flat engine behind the public API (kernels A and
F, and with exact per-particle condensation kernels A and G's forms), and
checks them:

  1. device: the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build: compile the kernels from csrc/, one nvcc per source in parallel
  3. kernels against their plain PyTorch versions, on the card, at the main
     path's shapes: A-D from the initial population (A bitwise, n_iters
     1-3, FCT off and on; C and D bitwise in every slot, on the cloud and
     on a rain population, and C also in its subsidence, no-advection and
     vt-only forms), E (coalescence) from the population after the
     spin-up, in stride, sort and standalone form, each with the geometric
     and the hall kernel, lane by lane; then E's Golovin box gate (Scott
     1967)
  4. the slice without coalescence: spin-up and main steps through the
     kernels, bench.py's physics checks, kernels A-D launched
  5. the slice with coalescence (the main path): the same, kernels A-E
     launched, and collisions happened
  6. the standalone coalescence path (dense.coal): its form of kernel E
  7. the flat engine through the public API (factory(engine="flat") ->
     init -> Kinematic2D.run(): step_sync / step_async): spin-up and
     coalescing
     steps, bench.py's physics checks read through get_attr and
     diag_puddle, kernel F (the per-cell condensation substep loop) once a
     step and kernel A twice, kernel F against its plain version on the
     inputs a main step gives it (and with cell 0 holding 65,536 more dead
     slots), run_device_lgrngn(engine="flat") against the stepwise loop,
     the kernel path against the plain path
  8. the exact per-particle condensation (exact_sstp_cond) through the
     public API on the flat engine (engine="flat"), with in-cell mixing,
     without it, and adaptive (sstp_cond_act 8 and 16): spin-up and
     coalescing steps with bench.py's physics checks, kernel G's
     fixed-count or adaptive form (a whole condensation phase over the
     cell-sorted segments) once a step, its one-substep entry never, and
     kernel A twice, run_device_lgrngn(engine="flat") against the
     stepwise loop, the kernel path against the plain path (bitwise);
     each form against its plain version on what a main step gives it
     (rw2 and the live SDs' private state bitwise; with mixing B's gates
     on rw2, th and rv), timed beside its bound; the one-substep entry
     against its plain version, bitwise, on the full population's first
     substep as the plain path calls it, RH
     capped at 1.01 and 44, on 1 and 32,773 droplets, with 65,536 dead
     slots added, and with a dt a droplet (the adaptive phase B)
  9. the dense front through the public API (factory on the card ->
     particles_dense_t; Kinematic2D.run()): spin-up and coalescing steps
     through kernels A (a field a call), B, C, D and E, bitwise equal to
     run_device_lgrngn(engine="dense") from the same state (th, rv, every
     plane as a per-cell multiset), bench.py's physics checks through the
     public API
 10. timing: best of 3 from-init reps through the kernels and through the
     plain versions, with and without coalescence, on the dense engine;
     best of 3 from-init reps of the flat slice, of the exact slice (with
     mixing) and of the dense front; each kernel against its plain
     version, beside its bound (bytes or operations at the card's peak
     rates)
 11. the sustained run (SUSTAINED_r05.json's shape: 3600 steps, 2400 of
     them spin-up, the repack policy every 50 steps with margin 1.25): the
     chunk log, the last 1000 steps' ms/step beside the from-init one, the
     global re-bins, conservation and the SDs alive at the end
 12. the repack policy forced to retarget at full width: 118 SDs a cell
     started at capacity 128 (a grow) and at 512 (a shrink), every repack
     conserving the population per cell, and kernel E's device time in the
     step at capacities 512 and 256
 13. the terminal velocity formulas the main path does not use (beard76,
     khvorostyanov_spherical, khvorostyanov_nonspherical): kernels B, C
     (full and vt-only forms, cloud and rain) and E (stride, sort,
     standalone) against their plain versions at the main path's shapes
     (B within its cell-sum gates, C and E bitwise); the smallest live wet
     radius and the NaN vt of the port and of the float32 evaluation; the
     dense slice from init with bench.py's physics checks, kernels A-E
     launched and collisions, the kernel path against the plain path after
     5 steps, best-of-3 timing (beard77fast's too, for the comparison in
     one call) and each kernel's device time in the step beside its bound;
     under khvorostyanov_nonspherical the dense front bitwise equal to
     run_device_lgrngn(engine="dense") and 5 steps of the flat engine
     through the public API with the physics checks
 14. the dense x-slab mesh (libcloudphxx_tpu_torch/parallel) over 8 shards
     of 10,10,10,10,9,9,9,9 columns and over 1 shard, all on this card:
     kernel C's unwrapped form (the TPU kernel's x_wrap=False) bitwise
     equal to its plain version on every shard's rows in a spin-up and a
     coalescing step; coalescence off, 10 steps of the mesh against the
     serial dense engine (per cell: cell, n, rd3, kappa and x exact; z,
     rw2 and vt rel 1e-5, th 2e-6, rv 2e-5, kernel B's gates); coalescence
     on, the first step after the spin-up the same against the serial step
     (and from that state with radii x10, where droplets collide: there
     each shard's B, E (keyed by its global rows) and D against their plain
     versions, E and D bitwise, B within its gates), then
     spin-up and coalescing steps from init through kernels A, B, C's
     unwrapped form, D and E with bench.py's physics checks, no overflow
     and SDs that crossed slab edges; best-of-3 timing of 50 coalescing
     steps from init at 8 and 1 shards beside the serial engine, and C's
     unwrapped form per launch beside its bound
 15. exact and adaptive condensation on the dense engine, in phase 8's
     four variants: the factory on the card gives the dense front;
     spin-up and coalescing steps through run_device_lgrngn(engine=
     "dense") with bench.py's physics checks, kernel G's fixed-count or
     adaptive form on the (n_cell, cap) rows and D's 11-plane form (the
     four private ambient planes riding) once a step, B, D's 7-plane form
     and G's one-substep entry never; the dense front bitwise equal to it;
     G's form (as in phase 8) and the 11-plane D (bitwise) against their
     plain versions on what a main step gives them; the kernel path
     against the plain path; best-of-3 timing from init beside the flat
     exact slice's, and the rows of G's two forms and of D with their
     bounds

Run from the repository root: ``python3 chip_smoke.py``; ``--profile``
adds the device-time split of the coalescing steps on the dense engine,
the flat engine, the dense front, the exact slice and the dense exact
slice (torch.profiler).  The last line is {"ok": true, "device": {...}}; the
line before it the card's name and power limit; before that one JSON
object with a row per kernel.  Any failed check raises: the script then
prints ``chip_smoke: FAILED: <reason>`` on stdout, and exits non-zero.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
NX = NZ = 76
SD_CONC = 64
SSTP_COND = 10
SSTP_COAL = 10
SLICE_SPINUP, SLICE_MAIN = 10, 10
TIME_STEPS, TIME_REPS = 50, 3       # with coalescence: bench.py's protocol
TIME_STEPS_NO_COAL = 20
KERNEL_REPS = 20
STANDALONE_CALLS = 3
FLAT_TIME_STEPS = 20
FLAT_DEAD_CELL0 = 65536     # dead slots added to cell 0 in F's second case
# the exact per-particle slices (kernel G): their four variants (the
# adaptive mode with sstp_cond_act below and above sstp_cond), the ragged
# lengths and dead slots of the one-substep entry's checks, the steps of
# the kernel path against the plain path (3 spin-up, 2 coalescing), and
# the calls a plain version of G's two forms is timed over
EXACT_VARIANTS = {
    "mixing": dict(exact_sstp_cond=True),
    "no mixing": dict(exact_sstp_cond=True, sstp_cond_mix=False),
    "adaptive": dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                     sstp_cond_act=8),
    "adaptive, act 16": dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                             sstp_cond_act=16),
}
EXACT_LENGTHS, EXACT_DEAD = (1, 32773), 65536
EXACT_PLAIN_STEPS, EXACT_PLAIN_SPINUP = 5, 3
FORM_PLAIN_REPS = 3

# the card's peak rates (H100 SXM data sheet, at a 700 W power limit):
# device memory bytes/s, float32 and float64 operations/s outside the
# tensor cores
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12
# operations per element, counted from the device code: one per add,
# multiply, min/max, division, square root, exp or log (the library is
# built with -fmad=false, so there is no multiply-add; the 67e12 rate
# counts one as two), none per compare or select.  Condensation
# (csrc/cond_cell.cuh): one drw2_dt evaluation (its cell terms apart, and
# the Reynolds power that D's and K's Nusselt numbers share taken once);
# one Anderson-Bjoerck iteration beside its evaluation; the root find's
# other end and first point beside its evaluation; a live droplet's
# substep outside these (the explicit step, the bracket and its test, the
# new rw2, its d(rw^3) and weight); a cell's substep (the increments, the
# closure, drw2_dt's cell terms, the butterfly, the latent heat's
# feedback); the closure alone; a live droplet's set-up, once a call (the
# dry radius' cube root and square, rd3 * (1 - kappa))
OPS_DRW2, OPS_ITER, OPS_BRACKET, OPS_ADVANCE = 65, 19, 12, 24
OPS_CELL_SUBSTEP, OPS_CLOSURE, OPS_DROP = 71, 32, 6
# kernel G (csrc/cond_sd.cu) evaluates drw2_dt's cell terms (cond_cell.cuh
# cell_growth) for every droplet: the Schmidt and Prandtl numbers, the RH
# cap, the surface tension and Kelvin coefficient, l_v, rho_v and the
# latent-heat term
OPS_GROWTH = 20
# kernel G's two forms (csrc/cond_sd_fixed.cu, cond_sd_adaptive.cu), per
# SD and substep beside the closure and the growth terms: the increments
# of the private state, d(rw^3), the vapour and the heat fed back; the
# adaptive form's Koehler function of the critical radius (a powf counted
# as three); a cell's butterfly of two float64 sums a substep
OPS_FEEDBACK, OPS_KOEHLER, OPS_BUTTERFLY = 32, 14, 20
# per live SD: vt_beard77; kernel C's advection, walls and classification
# beside it; kernel D's nine-source merge
OPS_VT, OPS_TRANSPORT, OPS_MERGE = 45, 60, 30
# vt under the other formulas (csrc/physics.cuh vt_formula), a pow counted
# as three (log, multiply, exp): beard76 by the regime a droplet is in (to
# 9.5 um, to 503.5 um, above), in float32; Khvorostyanov in float64, beside
# two float32 operations of the radius
OPS_VT_BEARD76 = ((9.5e-6, 20), (5.035e-4, 42), (float("inf"), 44))
OPS_VT_KHV = {"khvorostyanov_spherical": 49,
              "khvorostyanov_nonspherical": 57}
# kernel E (csrc/coal.cu), counted on the work its data needs (coal_work):
# a Philox 4x32-10 word, 10 rounds of 2 multiply-highs, 2 multiply-lows
# and 4 xors, and 2 key additions in rounds 2-10, each 32-bit integer
# operation counted as one at the float32 rate (the data sheet gives no
# int32 rate; Hopper runs integer multiplies at half the float32 rate,
# so the bound is lower than the card can reach); the geometric kernel's
# value of a pair and its collision count (physics.cuh kernel_value,
# collision_count); a collision's outcome for its small droplet
# (collide).  One draw a live SD a shuffle, one draw and one evaluation a
# pair of live SDs, vt once a live SD and again with the outcome of each
# droplet a collision changed; the shuffle's compare-exchanges and the
# scale factors are not counted.
OPS_PHILOX, OPS_PAIR, OPS_COLLIDE = 98, 17, 25
# MPDATA per cell and field (csrc/mpdata.cu): the donor pass (four donor
# fluxes, their divergence over G), and each corrective iteration's
# antidiffusive velocities of a cell's x and z face
OPS_DONOR, OPS_ANTIDIFF = 25, 46

# the sustained run (SUSTAINED_r05.json's shape) and the forced retargets:
# 118 SDs a cell fill 0.92 of capacity 128
SUSTAINED_NT, SUSTAINED_SPINUP, SUSTAINED_TAIL = 3600, 2400, 1000
REPACK_EVERY, REPACK_MARGIN = 50, 1.25
FORCED_SD_CONC, FORCED_EVERY, FORCED_CHUNKS = 118, 10, 3
PROFILE_STEPS = 5
# phase 14: the dense x-slab mesh on this card, its slabs (uneven, as
# slab_widths makes them) and the steps of its comparison with the serial
# engine without coalescence
MESH_SHARDS = 8
MESH_WIDTHS = [10, 10, 10, 10, 9, 9, 9, 9]
MESH_STEPS = 10

# the terminal velocity formulas off the main path (formulas()): the
# steps of their kernel path against their plain path (2 spin-up), and of
# the flat engine through the public API
FORMULAS = ("beard76", "khvorostyanov_spherical",
            "khvorostyanov_nonspherical")
FORMULA_PLAIN_STEPS, FORMULA_PLAIN_SPINUP, FORMULA_FLAT_STEPS = 5, 2, 5

# the Golovin box of tests/test_pallas_coal_golovin.py
GOLOVIN_SIM_TIME, GOLOVIN_SSTP = 800.0, 100
GOLOVIN_R0, GOLOVIN_N0, GOLOVIN_B = 30.084e-6, 2.0 ** 23, 1500.0
GOLOVIN_BOXES, GOLOVIN_CAP, GOLOVIN_SDS = 128, 256, 256
GOLOVIN_BINS = 10.0 ** (-6 + np.arange(150) / 50.0)


class CheckFailed(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def max_rel(a, b):
    a, b = a.double(), b.double()
    return float((torch.abs(a - b) / torch.clamp(torch.abs(b), min=1e-300)).max())


def max_abs(a, b):
    return float(torch.abs(a.double() - b.double()).max())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def multiset(n, planes):
    """Alive SDs as rows (cell, n, planes...), sorted: the per-cell
    multiset, independent of lane order."""
    cap = n.shape[1]
    nn = n.cpu().numpy().reshape(-1)
    alive = nn > 0
    cols = [np.repeat(np.arange(n.shape[0]), cap)[alive], nn[alive]] \
        + [p.cpu().numpy().reshape(-1)[alive] for p in planes]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], 1)


def time_cuda(fn, reps):
    """Mean device time of fn() in ms over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_model(Kinematic2D, coal, engine="auto", sd_conc=SD_CONC, vt=None,
               **oi_kw):
    """bench.py's model; ``vt`` the terminal velocity formula (None:
    Kinematic2D's beard77fast)."""
    return Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=sd_conc, sstp_cond=SSTP_COND,
        sstp_coal=SSTP_COAL, n_sd_max=sd_conc * NX * NZ,
        opts_init_kw={"coal_switch": coal, **oi_kw}, engine=engine,
        terminal_velocity=vt, device=DEVICE)


def occupancy(d):
    """SDs in the densest row of a DenseState."""
    return int((d.n > 0).sum(1).max())


def population(d):
    """The per-cell multiset of a DenseState's SDs, every plane."""
    return multiset(d.n, (d.rd3, d.rw2, d.kpa, d.vt, d.x, d.z))


def checked_repacks(dense, log):
    """dense.repack wrapped to check that every repack keeps each cell's
    SDs (the per-cell multiset of every plane) and drops none; ``log``
    gets (old capacity, new capacity) a call.  Returns the unwrap."""
    real = dense.repack

    def repack(cfg, d, new_cap):
        out = real(cfg, d, new_cap)
        check(int(out.overflow) == int(d.overflow),
              f"repack {d.cap} -> {new_cap} dropped SDs")
        check(np.array_equal(population(out), population(d)),
              f"repack {d.cap} -> {new_cap} changed a cell's SDs")
        log.append((d.cap, new_cap))
        return out

    dense.repack = repack
    return lambda: setattr(dense, "repack", real)


def device_ms(run, steps, names):
    """Device time a step [ms] of the kernels whose name holds one of
    ``names``, over run(steps) (torch.profiler): {name: ms}, empty where
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            for name in names:
                if name in e.key:
                    out[name] = out.get(name, 0.0) \
                        + e.device_time_total / 1e3 / steps
    return out


def time_reps(m, init, steps, plain, totals, dense):
    """Best of TIME_REPS from-init reps of ``steps`` dense steps of model
    ``m`` (after a 2-step warm-up), bench.py's physics checks against
    ``totals`` (water, dry) on every rep: (seconds, (th, rv, state) of the
    last rep); the model is put back at ``init``."""
    m.run_device_lgrngn(2, plain=plain, engine="dense")  # warm-up
    best = float("inf")
    for _ in range(TIME_REPS):
        m.dense_state, m.th, m.rv = init
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_device_lgrngn(steps, plain=plain, engine="dense")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        physics_checks(m, *totals, dense)
    out = (m.th, m.rv, m.dense_state)
    m.dense_state, m.th, m.rv = init
    return best, out


def physics_checks(model, water0, dry0, dense):
    """bench.py:45-96 on the port's state."""
    d = model.dense_state
    th, rv = model.th, model.rv
    alive = d.n > 0
    rw2, rd3 = d.rw2[alive], d.rd3[alive]
    check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
          "non-finite th/rv")
    check(bool(((th > 250.0) & (th < 350.0)).all()), "th outside [250, 350] K")
    check(bool(((rv > 0.0) & (rv < 0.03)).all()), "rv outside (0, 0.03)")
    check(bool(torch.isfinite(rw2).all() and (rw2 > 0).all()),
          "non-physical rw2")
    check(float(rw2.max()) < (5e-3) ** 2, "rw > 5 mm")
    check(bool((rd3 > 0).all()), "non-positive rd3")
    water, dry = dense.water_dry_totals(d, rv)
    dw, dd = abs(water - water0) / water0, abs(dry - dry0) / dry0
    check(dw < 1e-3, f"water conservation off by {dw:.2e}")
    check(dd < 1e-4, f"dry-mass conservation off by {dd:.2e}")
    check(int(d.overflow) == 0, f"{int(d.overflow)} SDs dropped")
    return dw, dd


def golovin_population():
    """tests/test_pallas_coal_golovin.py _golovin_population."""
    rng = np.random.default_rng(7)
    lnr_lo, lnr_hi = np.log(GOLOVIN_R0 / 30), np.log(GOLOVIN_R0 * 12)
    strata = (np.arange(GOLOVIN_SDS)[None, :]
              + rng.random((GOLOVIN_BOXES, GOLOVIN_SDS))) / GOLOVIN_SDS
    lnrd = lnr_lo + strata * (lnr_hi - lnr_lo)
    r = np.exp(lnrd)
    expvol = GOLOVIN_N0 * 3.0 * r ** 3 / GOLOVIN_R0 ** 3 \
        * np.exp(-((r / GOLOVIN_R0) ** 3))
    mult = np.floor(expvol * (lnr_hi - lnr_lo) / GOLOVIN_SDS + 0.5)
    shape = (GOLOVIN_BOXES, GOLOVIN_CAP)
    n, rw2, rd3 = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    n[:, :GOLOVIN_SDS] = mult
    rw2[:, :GOLOVIN_SDS] = r ** 2
    rd3[:, :GOLOVIN_SDS] = (r * 1e-3) ** 3
    return n, rw2, rd3


def golovin_rmsd(n, n1, rw2_1, c):
    """RMSD of the mass-density spectrum against Scott's analytic Golovin
    solution (tests/test_pallas_coal_golovin.py _spectrum_err)."""
    from scipy import special
    vol = lambda r: 4.0 / 3.0 * r ** 3 * np.pi
    n0 = n[:, :GOLOVIN_SDS].sum() / GOLOVIN_BOXES
    count = (n1 > 0).sum(axis=1, keepdims=True)
    sig = 0.62 / np.maximum(count, 1.0) ** 0.2
    x = np.maximum(rw2_1, 1e-300)
    pref = 4.0 / 3.0 * c.rho_w * np.sqrt(c.pi / 2.0)
    spec, ana = [], []
    for i in range(GOLOVIN_BINS.size - 1):
        rad = (GOLOVIN_BINS[i] + GOLOVIN_BINS[i + 1]) / 2
        vals = n1 / sig * x ** 1.5 * np.exp(
            -((0.5 * np.log(x) - np.log(rad)) / sig) ** 2 / 2.0)
        spec.append(pref * vals.sum() / GOLOVIN_BOXES)
        xx = vol(rad) / vol(GOLOVIN_R0)
        tau = 1 - np.exp(-GOLOVIN_B * n0 * vol(GOLOVIN_R0) * GOLOVIN_SIM_TIME)
        z = 2 * xx * np.sqrt(tau)
        res = (n0 / vol(GOLOVIN_R0) * special.ive(1, z) * (1 - tau)
               * np.exp(z - xx * (tau + 1)) / xx / np.sqrt(tau))
        ana.append((res if np.isfinite(res) else 0.0) * vol(rad) ** 2
                   * 3000.0)
    spec, ana = np.array(spec), np.array(ana)
    mask = (spec > 0) | (ana > 0)
    return float(np.sqrt(np.mean((spec[mask] - ana[mask]) ** 2)))


def collided(before, after):
    """The share of the total multiplicity that collisions took between
    two states (what fell into the puddle meanwhile excluded)."""
    from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM
    total = lambda d: float(d.n.double().sum())
    fell = float(after.puddle[OUT_PRTCL_NUM] - before.puddle[OUT_PRTCL_NUM])
    return (total(before) - total(after) - fell) / total(before)


def coal_work(run, n):
    """What one call of kernel E needs on its data, counted on its plain
    version ``run()`` (a coal_resident or coal_standalone call with
    plain=True) from the multiplicities ``n`` it starts from: the shuffle
    draws (a live SD a shuffle), the pairs of live SDs, the droplets a
    collision changed, and the live SDs at load."""
    from libcloudphxx_tpu_torch.lgrngn import dense
    work = {"draws": 0, "pairs": 0, "changed": 0,
            "live": int((n > 0).sum())}
    stride_fn, adjacent_fn = dense.pair_and_collide_stride, \
        dense.pair_and_collide

    def changed(vals, out):
        work["changed"] += int((out[1] != vals[1]).sum())
        return out

    def stride(cfg, params, vals, stride, *args, **kw):
        live = vals[0] > 0
        if stride == 1:                    # the first stride follows a shuffle
            work["draws"] += int(live.sum())
        lane = torch.arange(live.shape[1], device=live.device)
        partner = dense._xor_partner(vals[0], stride, lane)
        work["pairs"] += int((live & (partner > 0)
                              & ((lane & stride) == 0)).sum())
        return changed(vals, stride_fn(cfg, params, vals, stride, *args,
                                       **kw))

    def adjacent(cfg, params, vals, count, *args, **kw):
        work["draws"] += int((vals[0] > 0).sum())
        work["pairs"] += int(torch.floor(count / 2).sum())
        return changed(vals, adjacent_fn(cfg, params, vals, count, *args,
                                         **kw))

    dense.pair_and_collide_stride, dense.pair_and_collide = stride, adjacent
    try:
        run()
    finally:
        dense.pair_and_collide_stride, dense.pair_and_collide = \
            stride_fn, adjacent_fn
    return work


def coal_ops(work):
    """The operations of coal_work's ``work`` but vt's."""
    return (work["draws"] * OPS_PHILOX
            + work["pairs"] * (OPS_PHILOX + OPS_PAIR)
            + work["changed"] * OPS_COLLIDE)


def reset(kernels):
    for k in kernels:
        k.launches = 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, ops_f64=0):
    """The least time the card could take [ms], and what sets it: the
    bytes moved at the memory rate or the operations at the float32 (and
    float64) rate."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = (ops / PEAK_F32 + ops_f64 / PEAK_F64) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def rootfind_ops(dt, arrays, RH_max, live):
    """The operations one substep's growth needs on the ``live`` droplets of
    these arrays: the explicit step, the bracket end the test needs, the
    other end and the root-find iterations where the bracket holds; the
    explicit step and the bracket test where it does not; one evaluation
    for a droplet that does not grow; none for a dead slot.  Returns
    (operations, bracketed droplets, live droplets)."""
    from libcloudphxx_tpu_torch.lgrngn import condensation as cnd
    rw2, rd3, *rest = arrays
    grow = lambda x: cnd.drw2_dt(x, rd3, *rest, RH_max)
    alive = live & (rw2 > 0)
    w = torch.where(alive, rw2, 1e-12)
    drw2 = dt * grow(w)
    rd2 = torch.exp(torch.log(rd3) / 3.0) ** 2
    a = torch.maximum(rd2, w + torch.clamp(2.0 * drw2, max=0.0))
    b = w + torch.clamp(2.0 * drw2, min=0.0)
    f = lambda x: w + dt * grow(x) - x
    fa = torch.where(drw2 > 0, drw2, f(a))
    fb = torch.where(drw2 > 0, f(b), drw2)
    act = alive & (drw2 != 0)
    brk = act & (fa * fb <= 0) & (a < b)
    iters = cnd._root_iters(rw2.dtype)
    n_brk, n_act, n_live = int(brk.sum()), int(act.sum()), int(live.sum())
    per = {"bracketed": (3 + iters) * OPS_DRW2 + iters * OPS_ITER
           + OPS_BRACKET, "explicit": 2 * OPS_DRW2, "idle": OPS_DRW2}
    ops = (n_brk * per["bracketed"] + (n_act - n_brk) * per["explicit"]
           + (n_live - n_act) * per["idle"] + n_live * OPS_ADVANCE)
    return ops, n_brk, n_live


def flat_totals(prtcls, rv, c):
    """Total water mass [kg] and dry-aerosol volume sum [n*rd^3] of the
    flat engine, read through the public API (get_attr, diag_puddle), in
    float64: bench.py's conservation checks."""
    n = prtcls.get_attr("n").astype(np.float64)
    rw2 = prtcls.get_attr("rw2").astype(np.float64)
    rd3 = prtcls.get_attr("rd3").astype(np.float64)
    pud = prtcls.diag_puddle()
    st = prtcls.state
    vap = float((st.rhod.double() * st.dv.double()
                 * rv.double().reshape(-1)).sum())
    alive = n > 0
    liq = 4.0 / 3 * c.pi * c.rho_w * float(
        np.sum(n[alive] * rw2[alive] ** 1.5)) + c.rho_w * pud["liquid_volume"]
    dry = float(np.sum(n[alive] * rd3[alive])) \
        + pud["dry_volume"] / (4.0 / 3 * c.pi)
    return vap + liq, dry


def flat_physics_checks(model, water0, dry0, c):
    """bench.py:45-96 on the flat engine, read through the public API."""
    p, th, rv = model.prtcls, model.th, model.rv
    n = p.get_attr("n")
    rw2, rd3 = p.get_attr("rw2")[n > 0], p.get_attr("rd3")[n > 0]
    check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
          "flat: non-finite th/rv")
    check(bool(((th > 250.0) & (th < 350.0)).all()),
          "flat: th outside [250, 350] K")
    check(bool(((rv > 0.0) & (rv < 0.03)).all()), "flat: rv outside (0, 0.03)")
    check(bool(np.isfinite(rw2).all() and (rw2 > 0).all()),
          "flat: non-physical rw2")
    check(float(rw2.max()) < (5e-3) ** 2, "flat: rw > 5 mm")
    check(bool((rd3 > 0).all()), "flat: non-positive rd3")
    water, dry = flat_totals(p, rv, c)
    dw, dd = abs(water - water0) / water0, abs(dry - dry0) / dry0
    check(dw < 1e-3, f"flat: water conservation off by {dw:.2e}")
    check(dd < 1e-4, f"flat: dry-mass conservation off by {dd:.2e}")
    return dw, dd


def capture(module, name, step, which=-1):
    """The arguments, by name, that the wrapper ``module.name`` takes on a
    main path: ``step()`` runs a step with the wrapper wrapped to record
    its calls; the call ``which`` (the last by default; None: all of
    them, in order)."""
    calls = capture_all({name: (module, name)}, step)[name]
    return calls if which is None else calls[which]


def capture_all(targets, step):
    """capture() of several wrappers in one run of ``step()``: ``targets``
    is {key: (module, name)}; returns {key: all its calls, in order}."""
    import inspect
    real = {key: getattr(mod, name) for key, (mod, name) in targets.items()}
    seen = {key: [] for key in targets}

    def spy(key):
        def call(*args, **kw):
            seen[key].append(
                inspect.signature(real[key]).bind(*args, **kw).arguments)
            return real[key](*args, **kw)
        return call

    for key, (mod, name) in targets.items():
        setattr(mod, name, spy(key))
    try:
        step()
    finally:
        for key, (mod, name) in targets.items():
            setattr(mod, name, real[key])
    for key, (_, name) in targets.items():
        check(len(seen[key]) > 0, f"a step did not call {name}")
    return {key: [{k: v for k, v in c.items() if k != "plain"} for c in calls]
            for key, calls in seen.items()}


def with_dead_cell0(kw, n_dead):
    """Kernel F's arguments with ``n_dead`` dead slots (weight 0, keeping
    the rw2 of the droplets they copy) added to cell 0 after its
    droplets, as the flat engine parks dead slots there."""
    at = int(kw["ends"][0]) + 1
    src = torch.arange(n_dead, device=kw["rw2"].device) % kw["rw2"].numel()
    out = dict(kw, ends=kw["ends"] + n_dead)
    for k in ("sijk", "rw2", "rd3", "kpa", "vt", "wgt"):
        fill = torch.zeros_like(kw[k][src]) if k in ("sijk", "wgt") \
            else kw[k][src]
        out[k] = torch.cat([kw[k][:at], fill, kw[k][at:]])
    return out


def flat_first_substep(cfg, kw):
    """The per-droplet arrays of kernel F's first substep on its inputs
    ``kw`` (cond_flat's arguments): the sorted SDs with the cell state
    after the first increment gathered to them, as rootfind_ops takes
    them."""
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_Tpr
    sstp = kw["sstp"]
    th = kw["th"] + kw["delta_th"] / sstp
    rv = kw["rv"] + kw["delta_rv"] / sstp
    rhod = kw["rhod"] + kw["delta_rh"] / sstp if kw["var_rho"] \
        else kw["rhod"]
    T, p, RH, eta = hskpng_Tpr(cfg, th, rv, rhod, kw["p"])
    g = lambda a: a[kw["sijk"]]
    return (kw["rw2"], kw["rd3"], kw["kpa"], kw["vt"], g(rhod), g(rv), g(T),
            g(p), g(RH), g(eta), g(kw["lambda_D"]), g(kw["lambda_K"]))


def segments(kw):
    """(longest cell segment, most live droplets in a cell) of kernel F's
    inputs."""
    ends = kw["ends"]
    seg = torch.diff(ends, prepend=ends.new_full((1,), -1))
    live = torch.bincount(kw["sijk"][kw["wgt"] > 0],
                          minlength=ends.numel())
    return int(seg.max()), int(live.max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print the device-time split of coalescing "
                         "steps on the dense engine, the flat engine, the "
                         "dense front, the exact slice and the dense exact "
                         "slice (torch.profiler)")
    opts = ap.parse_args()
    try:
        return smoke(opts)
    except Exception as e:
        # the reason in the last line of stdout; the traceback follows on
        # stderr and the script exits non-zero
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", flush=True)
        raise


def smoke(opts):
    # ---- 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false; "
          "this script needs an NVIDIA GPU")
    from libcloudphxx_tpu_torch import Kinematic2D, _ext
    from libcloudphxx_tpu_torch.common import constants as c
    from libcloudphxx_tpu_torch.lgrngn import dense, kernel_t
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    from libcloudphxx_tpu_torch.models import mpdata
    from libcloudphxx_tpu_torch.ops import coal, step

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build
    path, secs, log = _ext.build(verbose=True)
    print(f"build: {secs:.1f} s -> {path.name}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _ext.load()

    # ---- 3. kernels against plain versions
    t0 = time.perf_counter()
    model = make_model(Kinematic2D, coal=False)
    torch.cuda.synchronize()
    d0, th0, rv0 = model.dense_state, model.th, model.rv
    cfg = model.cfg
    n_sd = int((d0.n > 0).sum())
    print(f"init: {n_sd} SDs, cap {d0.cap}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    err = {}

    # A: MPDATA, 1 and 2 fields, FCT off and on, n_iters 1-3, on perturbed
    # fields: bitwise equal to the plain version
    rng = np.random.default_rng(0)
    like = lambda a: torch.as_tensor(a, dtype=th0.dtype, device=th0.device)
    th_p = th0 + like(rng.normal(0.0, 0.5, (NX, NZ)))
    rv_p = rv0 * (1.0 + like(rng.uniform(-0.05, 0.05, (NX, NZ))))
    err["mpdata"] = 0.0
    for fct in (False, True):
        for n_iters in (1, 2, 3):
            mp = (model.gc_x, model.gc_z, model.G, n_iters, fct)
            pairs = list(zip(
                (mpdata.advect(th_p, *mp),
                 *mpdata.advect2(th_p, rv_p, *mp)),
                (mpdata.advect(th_p, *mp, plain=True),
                 *mpdata.advect2(th_p, rv_p, *mp, plain=True))))
            err["mpdata"] = max(err["mpdata"],
                                *(max_abs(k, p) for k, p in pairs))
            same = all(torch.equal(k, p) for k, p in pairs)
            print(f"A mpdata fct={fct} n_iters={n_iters}: bitwise equal "
                  f"{same}")
            check(same, f"mpdata fct={fct} n_iters={n_iters}: kernel and "
                  f"plain version differ")
    print(f"A launch plan at {NX}x{NZ}: "
          f"{mpdata._card_plan(NX, NZ, False)} (fct off), "
          f"{mpdata._card_plan(NX, NZ, True)} (fct on)")

    # B: condensation, post-spin-up RH cap, from the initial population
    tha, rva = mpdata.advect2(th0, rv0, model.gc_x, model.gc_z, model.G)
    lam_D, lam_K = hskpng_mfp(d0.T, d0.p)
    cond_args = (cfg, SSTP_COND, 1.0, 44.0, d0.n, d0.rw2, d0.rd3, d0.kpa,
                 tha.reshape(-1), rva.reshape(-1), d0.sstp_tmp_th,
                 d0.sstp_tmp_rv, d0.rhod, d0.dv, lam_D, lam_K, d0.p)
    kb = step.cond(*cond_args)
    pb = step.cond(*cond_args, plain=True)
    live_b = d0.n > 0
    rel_th, rel_rv = max_rel(kb[1], pb[1]), max_rel(kb[2], pb[2])
    rel_rw2 = max_rel(kb[0][live_b], pb[0][live_b])
    err["cond"] = max(max_abs(kb[0][live_b], pb[0][live_b]),
                      max_abs(kb[1], pb[1]), max_abs(kb[2], pb[2]))
    same_cells = float(((kb[1] == pb[1]) & (kb[2] == pb[2])).double().mean())
    same_sds = float((kb[0] == pb[0])[live_b].double().mean())
    print(f"B cond: th rel {rel_th:.2e}, rv rel {rel_rv:.2e}, rw2 rel "
          f"{rel_rw2:.2e} (live lanes); bitwise equal: {same_cells:.4f} of "
          f"the cells (th and rv), {same_sds:.4f} of the droplets; dead "
          f"lanes kept {bool(torch.equal(kb[0][~live_b], d0.rw2[~live_b]))}")
    check(rel_th <= 2e-6 and rel_rv <= 2e-5 and rel_rw2 <= 1e-5,
          "cond kernel disagrees with its plain version")
    check(bool(torch.equal(kb[0][~live_b], d0.rw2[~live_b])),
          "cond kernel changed a dead lane")

    # C+D: transport, walls, classification and merge; the cloudy state
    # after B, and a rain variant (mm drops in the lowest 20 m) that
    # fills the puddle
    rw2, T, p, RH, eta = kb[0], kb[3], kb[4], kb[5], kb[6]
    C = dense._row_courants(cfg, d0)
    alive = d0.n > 0
    rain = (torch.where(alive, 2.0, 0.0), torch.where(alive, 1e-6, 0.0),
            torch.where(alive, cfg.z0 + 20.0 * (d0.z / cfg.z1), d0.z))
    err["transport"] = err["merge"] = 0.0
    for label, (n, w2, z) in (("cloud", (d0.n, rw2, d0.z)), ("rain", rain)):
        args = (cfg, 1.0, True, n, w2, d0.rd3, d0.x, z, T, p, d0.rhod,
                eta) + C
        kc = step.transport(*args)
        pc = step.transport(*args, plain=True)
        # n, x, z, vt and the targets of every slot, bitwise
        tgt_same = bool(torch.equal(kc[4], pc[4]))
        c_same = tgt_same and all(torch.equal(a, b)
                                  for a, b in zip(kc[:4], pc[:4]))
        err["transport"] = max(err["transport"],
                               *(max_abs(a, b) for a, b in zip(kc[:4], pc[:4])))
        kd = step.rebin_x(cfg, kc[0], w2, d0.rd3, d0.kpa, kc[3], kc[1], kc[2],
                          kc[4])
        pd = step.rebin_x(cfg, pc[0], w2, d0.rd3, d0.kpa, pc[3], pc[1], pc[2],
                          pc[4], plain=True)
        # the seven merged planes lane by lane, and the drops
        lanes = all(torch.equal(a, b) for a, b in zip(kd, pd))
        err["merge"] = max(err["merge"],
                           *(max_abs(a, b) for a, b in zip(kd, pd)))
        n_sds = int((kd[0] > 0).sum())
        ovf_k, ovf_p = float(kd[7].sum()), float(pd[7].sum())
        pud_k, pud_p = kc[5].sum(0), pc[5].sum(0)
        rel_pud = max_rel(pud_k[:4], pud_p[:4]) if float(pud_p[3]) else \
            float(pud_k[:4].abs().max())
        print(f"C+D {label}: {n_sds} SDs, targets equal {tgt_same}, n/x/z/vt "
              f"equal {c_same}, lanes equal {lanes}, overflow {ovf_k:.0f}/"
              f"{ovf_p:.0f}, far {float(pud_k[4]):.0f}/{float(pud_p[4]):.0f}, "
              f"puddle prt_num {float(pud_k[3]):.6g} rel {rel_pud:.2e}")
        check(tgt_same, f"{label}: kernel C's targets differ from its plain "
              f"version's")
        check(c_same, f"{label}: kernel C's n, x, z or vt differ from its "
              f"plain version's")
        check(lanes, f"{label}: kernel D and its plain version differ lane "
              f"by lane (planes or drops)")
        check(n_sds > 0, f"{label}: no SD left")
        check(bool(torch.equal(kc[5][:, 4], pc[5][:, 4])),
              f"{label}: far flags differ")
        check(rel_pud <= 1e-5, f"{label}: puddle rel {rel_pud:.2e} > 1e-5")
    check(float(pc[5].sum(0)[3]) > 0, "rain case: nothing reached the puddle")

    # C's other forms on the same data: subsidence beside sedimentation (a
    # w_LS profile rising to 5 cm/s at the top), no advection, and the vt
    # refresh alone; bitwise in every slot they write
    w_cells = torch.linspace(0.0, 0.05, NZ, device=DEVICE)[
        torch.arange(cfg.n_cell, device=DEVICE) % NZ]
    for label, (n, w2, z) in (("cloud", (d0.n, rw2, d0.z)), ("rain", rain)):
        for form, sedi, kw in (("subsidence", True, dict(w_cells=w_cells)),
                               ("no advection", True, dict(do_adve=False)),
                               ("vt only", False, dict(do_adve=False))):
            args = (cfg, 1.0, sedi, n, w2, d0.rd3, d0.x, z, T, p, d0.rhod,
                    eta) + C
            kc = step.transport(*args, **kw)
            pc = step.transport(*args, **kw, plain=True)
            pairs = [(a, b) for a, b in zip(kc[:5], pc[:5]) if a is not None]
            same = all(torch.equal(a, b) for a, b in pairs)
            err["transport"] = max(err["transport"],
                                   *(max_abs(a, b) for a, b in pairs))
            moved = kc[5] is not None
            far = moved and bool(torch.equal(kc[5][:, 4], pc[5][:, 4]))
            rel_pud = max_rel(kc[5].sum(0)[:4], pc[5].sum(0)[:4]) \
                if moved and float(pc[5].sum(0)[3]) else 0.0
            print(f"C {label}, {form}: {'n/x/z/vt/targets' if moved else 'vt'}"
                  f" equal {same}" + (f", far flags equal {far}, puddle rel "
                                      f"{rel_pud:.2e}" if moved else ""))
            check(same and (far or not moved) and rel_pud <= 1e-5,
                  f"{label}, {form}: kernel C differs from its plain version")
            check(moved or (kc[0] is n and kc[1] is d0.x),
                  f"{label}, vt only: kernel C moved droplets")

    # E: coalescence, from the population after the spin-up, with the same
    # draws (seed, step) on both sides; and a drizzle variant (radii x10),
    # in which droplets certainly collide
    model_c = make_model(Kinematic2D, coal=True)
    dc0, thc0, rvc0 = model_c.dense_state, model_c.th, model_c.rv
    model_c.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP,
                              engine="dense")
    ds = model_c.dense_state
    params = model_c.opts_init.kernel_parameters
    e_cells = (ds.T, ds.p, ds.rhod, ds.eta, ds.dv)
    cfg_hall = dataclasses.replace(cfg, kernel=kernel_t.hall.value)
    populations = {"cloud": (ds.n, ds.rw2, ds.rd3, ds.kpa, ds.x, ds.z),
                   "drizzle": (ds.n, ds.rw2 * 100.0, ds.rd3, ds.kpa, ds.x,
                               ds.z)}

    def coal_call(form, plain, kcfg=cfg, pop="cloud"):
        args = (kcfg, params, SSTP_COAL, 1.0, ds.rng_seed, ds.rng_step) \
            + populations[pop] + e_cells
        if form == "standalone":
            n, rw2, rd3, kpa, vt, x, z, ovf = coal.coal_standalone(
                *args, plain=plain)
            return (n, rw2, rd3, kpa, x, z, vt), ovf
        *out, ovf = coal.coal_resident(*args, pairing=form, plain=plain)
        return tuple(out), ovf

    err["coal"] = err["coal_standalone"] = 0.0
    cases = [(form, kcfg, pop, f"{pop} {form}{suffix}")
             for pop in populations
             for kcfg, suffix in ((cfg, ""), (cfg_hall, " hall"))
             for form in ("stride", "sort", "standalone")]
    for form, kcfg, pop, label in cases:
        (ko, kf), (po, pf) = (coal_call(form, plain, kcfg, pop)
                              for plain in (False, True))
        # per cell (n, rd3, kpa, x, z) exact, then rw2
        mk = multiset(ko[0], (ko[2], ko[3], ko[4], ko[5], ko[1]))
        mp = multiset(po[0], (po[2], po[3], po[4], po[5], po[1]))
        check(mk.shape == mp.shape, f"E {label}: SD counts differ")
        check(np.array_equal(mk[:, :6], mp[:, :6]),
              f"E {label}: cells / n / rd3 / kappa / x / z differ")
        rel_w = float(np.max(np.abs(mk[:, 6] - mp[:, 6])
                             / np.maximum(np.abs(mp[:, 6]), 1e-300)))
        key = "coal_standalone" if form == "standalone" else "coal"
        err[key] = max(err[key], max(max_abs(a, b) for a, b in zip(ko, po)))
        lanes = all(torch.equal(a, b) for a, b in zip(ko, po))
        lost = float(ds.n.double().sum() - ko[0].double().sum())
        print(f"E coal {label}: {mk.shape[0]} SDs, multiplicity lost "
              f"{lost:.6g}, rw2 rel {rel_w:.2e}, flags equal "
              f"{bool(torch.equal(kf, pf))} ({int(kf.sum())} rows), lanes "
              f"equal {lanes}", flush=True)
        check(rel_w <= 1e-6, f"E {label}: rw2 rel {rel_w:.2e} > 1e-6")
        check(bool(torch.equal(kf, pf)), f"E {label}: overflow flags differ")
        check(lanes, f"E {label}: kernel and plain version differ lane by "
              f"lane")
        check(lost > 0.0 or pop == "cloud", f"E {label}: no collision")

    # E: the Golovin box gate of the kernel itself
    n_g, rw2_g, rd3_g = golovin_population()
    cfg_g = dataclasses.replace(cfg, kernel=kernel_t.golovin.value)
    gpu = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    ones = torch.ones(GOLOVIN_BOXES, dtype=torch.float32, device=DEVICE)
    for form in ("stride", "sort"):
        out = coal.coal_resident(
            cfg_g, (GOLOVIN_B,), GOLOVIN_SSTP, GOLOVIN_SIM_TIME, 1234, 0,
            gpu(n_g), gpu(rw2_g), gpu(rd3_g), gpu(np.where(n_g > 0, 1e-10, 0)),
            gpu(n_g * 0), gpu(n_g * 0), ones * 300.0, ones * 1e5, ones,
            ones * 1.8e-5, ones, pairing=form)
        n1, rw2_1 = (o.double().cpu().numpy() for o in out[:2])
        m3_0, m3_1 = (n_g * rw2_g ** 1.5).sum(), (n1 * rw2_1 ** 1.5).sum()
        water = abs(m3_1 - m3_0) / m3_0
        frac = n1.sum() / n_g.sum()
        rmsd = golovin_rmsd(n_g, n1, rw2_1, c)
        print(f"E golovin {form}: RMSD {rmsd:.3e} (< 3.5e-5), water rel "
              f"{water:.2e} (< 5e-5), total n {frac:.3f} x initial (< 0.6)")
        check(rmsd < 3.5e-5 and water < 5e-5 and frac < 0.6,
              f"Golovin gate failed in {form} mode")

    # ---- 4. the slice without coalescence
    water0, dry0 = dense.water_dry_totals(d0, rv0)
    reset(_ext.KERNELS)
    model.run_device_lgrngn(SLICE_SPINUP + SLICE_MAIN, spinup=SLICE_SPINUP,
                            engine="dense")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _ext.KERNELS}
    dw, dd = physics_checks(model, water0, dry0, dense)
    print(f"slice, coalescence off: water rel err {dw:.2e}, dry rel err "
          f"{dd:.2e}; launches {launches}", flush=True)
    check(all(launches[k.name] > 0 for k in _ext.KERNELS[:4]),
          f"a kernel of the path was not launched: {launches}")

    # ---- 5. the slice with coalescence: the main path
    model_c.dense_state, model_c.th, model_c.rv = dc0, thc0, rvc0
    reset(_ext.KERNELS)
    t0 = time.perf_counter()
    model_c.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP,
                              engine="dense")
    d_sp = model_c.dense_state
    c_sp = (d_sp, model_c.th, model_c.rv)
    model_c.run_device_lgrngn(SLICE_MAIN, engine="dense")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.KERNELS}
    dw, dd = physics_checks(model_c, water0, dry0, dense)
    d_end = model_c.dense_state
    c_end = (d_end, model_c.th, model_c.rv)
    lost = collided(d_sp, d_end)
    print(f"slice, coalescence on: {SLICE_SPINUP} spin-up + {SLICE_MAIN} "
          f"main steps in {secs:.2f} s; water rel err {dw:.2e}, dry rel err "
          f"{dd:.2e}, SDs {int((d_end.n > 0).sum())}, max occupancy "
          f"{int((d_end.n > 0).sum(1).max())}/{d_end.cap}, multiplicity lost "
          f"to collisions {lost:.3e}; launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in
              ("mpdata", "cond", "transport", "merge", "coal")),
          f"a kernel of the path was not launched: {launches}")
    check(lost > 0.0, "no collision in the main steps")
    main_launches = launches

    # ---- 6. the standalone coalescence path (dense.coal)
    reset(_ext.KERNELS)
    d = d_end
    for _ in range(STANDALONE_CALLS):
        d = dense.coal(cfg, d, params, 1.0, SSTP_COAL)
    torch.cuda.synchronize()
    standalone = _ext.COAL_STANDALONE.launches
    m3 = lambda s: float((s.n.double() * s.rw2.double() ** 1.5).sum())
    water_rel = abs(m3(d) - m3(d_end)) / m3(d_end)
    print(f"standalone coalescence: {STANDALONE_CALLS} calls, launches "
          f"{standalone}, liquid water rel change {water_rel:.2e}, "
          f"multiplicity {float(d.n.sum()) / float(d_end.n.sum()):.6f} x")
    check(standalone == STANDALONE_CALLS and water_rel < 1e-5
          and float(d.n.sum()) <= float(d_end.n.sum()),
          "standalone coalescence path failed")

    # ---- 7. the flat engine through the public API
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    t0 = time.perf_counter()
    model_f = make_model(Kinematic2D, coal=True, engine="flat")
    prt = model_f.prtcls
    check(type(prt).__name__ == "particles_t",
          f"factory(engine='flat') gave {type(prt).__name__}")
    torch.cuda.synchronize()
    f_init = (prt.state, model_f.th, model_f.rv)
    fw0, fd0 = flat_totals(prt, model_f.rv, c)
    n_flat = int((prt.state.n > 0).sum())
    print(f"flat init (factory -> particles_t.init): {n_flat} SDs in "
          f"{prt.cfg.n_sd_max} slots, {time.perf_counter() - t0:.1f} s",
          flush=True)

    def restore_flat(init):
        prt.state, model_f.th, model_f.rv = init

    def flat_launches():
        return {k.name: k.launches for k in (_ext.MPDATA, _ext.COND_FLAT)}

    reset(_ext.KERNELS)
    t0 = time.perf_counter()
    model_f.run(SLICE_SPINUP, spinup=SLICE_SPINUP)
    torch.cuda.synchronize()
    f_sp = (prt.state, model_f.th, model_f.rv)
    model_f.run(SLICE_MAIN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    flat_main = flat_launches()
    dw, dd = flat_physics_checks(model_f, fw0, fd0, c)
    st_end, f_end_th, f_end_rv = prt.state, model_f.th, model_f.rv
    lost = collided(f_sp[0], st_end)
    steps = SLICE_SPINUP + SLICE_MAIN
    print(f"flat slice, public API: {SLICE_SPINUP} spin-up + {SLICE_MAIN} "
          f"main steps in {secs:.2f} s; water rel err {dw:.2e}, dry rel err "
          f"{dd:.2e}, SDs {int((st_end.n > 0).sum())}, multiplicity lost to "
          f"collisions {lost:.3e}, coalescence step counter "
          f"{st_end.rng_step}; launches {flat_main}", flush=True)
    check(flat_main == {"mpdata": 2 * steps, "cond_flat": steps},
          f"flat: kernel A twice and F once a step expected, got "
          f"{flat_main}")
    check(lost > 0.0, "flat: no collision in the main steps")
    check(st_end.rng_step == SLICE_MAIN, "flat: coalescence did not run "
          "every main step")

    # F against its plain version on what the first main step gives it,
    # and with 65,536 more dead slots in cell 0
    f_kw = capture(cond_ops, "cond_flat",
                   lambda: (restore_flat(f_sp), model_f.run(1)))
    f_dead = with_dead_cell0(f_kw, FLAT_DEAD_CELL0)
    err["cond_flat"] = 0.0
    for label, kw in (("main", f_kw), ("dead cell 0", f_dead)):
        k = cond_ops.cond_flat(**kw)
        pl = cond_ops.cond_flat(**kw, plain=True)
        live = kw["wgt"] > 0
        rel_w = max_rel(k[0][live], pl[0][live])
        rel_th, rel_rv = max_rel(k[1], pl[1]), max_rel(k[2], pl[2])
        rel_rh = max_rel(k[3], pl[3])
        err["cond_flat"] = max(err["cond_flat"],
                               max_abs(k[0][live], pl[0][live]),
                               *(max_abs(a, b) for a, b in zip(k[1:], pl[1:])))
        same_cells = float(((k[1] == pl[1]) & (k[2] == pl[2])).double()
                           .mean())
        same_sds = float((k[0] == pl[0])[live].double().mean())
        kept = bool(torch.equal(k[0][~live], kw["rw2"][~live]))
        longest, most = segments(kw)
        print(f"F cond_flat {label}: {kw['rw2'].numel()} slots, "
              f"{int(live.sum())} live, longest segment {longest} (cell 0: "
              f"{int(kw['ends'][0]) + 1}), most live in a cell {most}; rw2 "
              f"rel {rel_w:.2e}, th rel {rel_th:.2e}, rv rel {rel_rv:.2e}, "
              f"rhod rel {rel_rh:.2e}; bitwise equal: {same_cells:.4f} of the "
              f"cells (th and rv), {same_sds:.4f} of the droplets; dead "
              f"slots kept {kept}", flush=True)
        # the cell sums add in another order than the plain version's
        # cumulative sum: B's tolerances
        check(rel_th <= 2e-6 and rel_rv <= 2e-5 and rel_w <= 1e-5
              and rel_rh <= 2e-6 and kept,
              f"F {label}: kernel disagrees with its plain version")

    # run_device_lgrngn(engine="flat") from the post-spin-up state against
    # the stepwise public-API loop: the same draws, so the same numbers
    restore_flat(f_sp)
    model_f.run_device_lgrngn(SLICE_MAIN)
    torch.cuda.synchronize()
    st_dev = prt.state
    eq = {"th": bool(torch.equal(model_f.th, f_end_th)),
          "rv": bool(torch.equal(model_f.rv, f_end_rv)),
          "rw2": bool(torch.equal(st_dev.rw2, st_end.rw2)),
          "n": bool(torch.equal(st_dev.n, st_end.n))}
    print(f"flat run_device_lgrngn vs stepwise run(): equal {eq}",
          flush=True)
    check(all(eq.values()), "flat: run_device_lgrngn differs from run()")

    # the kernel path against the plain path, from init
    restore_flat(f_init)
    model_f.run(steps, spinup=SLICE_SPINUP, plain=True)
    torch.cuda.synchronize()
    rel_th, rel_rv = max_rel(model_f.th, f_end_th), max_rel(model_f.rv,
                                                             f_end_rv)
    print(f"flat, kernels vs plain after {steps} steps: th rel {rel_th:.2e}, "
          f"rv rel {rel_rv:.2e}", flush=True)
    check(rel_th <= 1e-4 and rel_rv <= 1e-3,
          "flat: the kernel path drifted from the plain path")

    # ---- 8. the exact per-particle slice through the public API
    exact = exact_slice(Kinematic2D, _ext, c, err)

    # ---- 9. the dense front through the public API
    from libcloudphxx_tpu_torch.lgrngn import backend_t, factory
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    probe = factory(backend_t.CUDA, model_c.opts_init, device=DEVICE)
    check(isinstance(probe, particles_dense_t),
          f"factory on the card gave {type(probe).__name__} for bench.py's "
          f"configuration, not particles_dense_t")
    model_d = make_model(Kinematic2D, coal=True)
    prt_d = model_d.prtcls
    check(isinstance(prt_d, particles_dense_t),
          f"Kinematic2D's public API is {type(prt_d).__name__}")
    fd_init = (model_d.dense_state, model_d.th, model_d.rv)
    dw0, dd0 = flat_totals(prt_d, model_d.rv, c)
    steps = SLICE_SPINUP + SLICE_MAIN
    reset(_ext.KERNELS)
    t0 = time.perf_counter()
    model_d.run(steps, spinup=SLICE_SPINUP)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    front = {k.name: k.launches for k in _ext.KERNELS}
    print(f"dense front, public API: {SLICE_SPINUP} spin-up + {SLICE_MAIN} "
          f"main steps in {secs:.2f} s; capacity {prt_d._d.cap}; launches "
          f"{front}", flush=True)
    check(front == dict(mpdata=2 * steps, cond=steps, transport=steps,
                        merge=steps, coal=SLICE_MAIN, coal_standalone=0,
                        cond_flat=0, cond_sd=0, transport_unwrapped=0,
                        merge_exact=0, cond_sd_fixed=0, cond_sd_adaptive=0),
          f"dense front: kernel A twice, B, C and D once a step and E once "
          f"a main step expected, got {front}")
    # bitwise against run_device_lgrngn(engine="dense") from the same state
    # (phase 5): the same kernels on the same inputs
    d_f, (d_r, th_r, rv_r) = model_d.dense_state, c_end
    eq = {"th": bool(torch.equal(model_d.th, th_r)),
          "rv": bool(torch.equal(model_d.rv, rv_r))}
    for k in dense.ATTRS:
        eq[k] = bool(np.array_equal(multiset(d_f.n, (d_f.rd3, getattr(d_f, k))),
                                    multiset(d_r.n, (d_r.rd3, getattr(d_r, k)))))
    eq["all planes"] = bool(np.array_equal(population(d_f), population(d_r)))
    print(f"dense front vs run_device_lgrngn(engine='dense'): bitwise equal "
          f"{eq}", flush=True)
    check(all(eq.values()), "the dense front differs from "
          "run_device_lgrngn(engine='dense')")
    dw, dd = flat_physics_checks(model_d, dw0, dd0, c)
    print(f"dense front, physics through get_attr/diag_puddle: water rel err "
          f"{dw:.2e}, dry rel err {dd:.2e}", flush=True)

    # ---- 10. timing: from-init reps through the kernels and the plain path
    def run_reps(m, init, steps, plain):
        return time_reps(m, init, steps, plain, (water0, dry0), dense)

    dense_ms = {}
    for label, m, init, steps in (
            ("coalescence on", model_c, (dc0, thc0, rvc0), TIME_STEPS),
            ("coalescence off", model, (d0, th0, rv0), TIME_STEPS_NO_COAL)):
        t_k, (th_k, rv_k, s_k) = run_reps(m, init, steps, False)
        dense_ms[label] = t_k / steps * 1e3
        t_p, (th_p2, rv_p2, s_p) = run_reps(m, init, steps, True)
        rel_th, rel_rv = max_rel(th_k, th_p2), max_rel(rv_k, rv_p2)
        wk = dense.water_dry_totals(s_k, rv_k)[0]
        wp = dense.water_dry_totals(s_p, rv_p2)[0]
        lost = collided(init[0], s_k)
        for how, t in (("kernels", t_k), ("plain", t_p)):
            print(f"timing {label}, {how}: {t / steps * 1e3:.3f} ms/step, "
                  f"{n_sd * steps / t:.4g} SD-updates/s ({steps} steps, "
                  f"best of {TIME_REPS}; {card})")
        print(f"{label}, kernels vs plain after {steps} steps: th rel "
              f"{rel_th:.2e}, rv rel {rel_rv:.2e}, total water rel "
              f"{abs(wk - wp) / wp:.2e}; multiplicity lost to collisions "
              f"{lost:.3e}", flush=True)
        check(rel_th <= 1e-4 and rel_rv <= 1e-3,
              f"{label}: the kernel path drifted from the plain path")
        check(lost > 0.0 or m is model, f"{label}: no collision")

    # the flat slice: from-init reps of the stepwise public-API loop
    best = float("inf")
    for _ in range(TIME_REPS):
        restore_flat(f_init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_f.run(FLAT_TIME_STEPS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        flat_physics_checks(model_f, fw0, fd0, c)
    flat_ms = best / FLAT_TIME_STEPS * 1e3
    print(f"timing flat slice (public API, coalescence on), kernels: "
          f"{flat_ms:.3f} ms/step, "
          f"{n_flat * FLAT_TIME_STEPS / best:.4g} SD-updates/s "
          f"({FLAT_TIME_STEPS} steps, best of {TIME_REPS}; {card})",
          flush=True)
    restore_flat(f_init)

    # the exact slice (mixing): from-init reps of the stepwise public-API
    # loop, beside the per-cell flat slice
    m_x, x_init = exact["model"], exact["init"]
    best = float("inf")
    for _ in range(TIME_REPS):
        m_x.prtcls.state, m_x.th, m_x.rv = x_init
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_x.run(FLAT_TIME_STEPS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        flat_physics_checks(m_x, *exact["totals"], c)
    m_x.prtcls.state, m_x.th, m_x.rv = x_init
    exact_ms = best / FLAT_TIME_STEPS * 1e3
    print(f"timing exact slice (mixing, public API, coalescence on), "
          f"kernels: {exact_ms:.3f} ms/step, "
          f"{exact['n_sd'] * FLAT_TIME_STEPS / best:.4g} SD-updates/s "
          f"({FLAT_TIME_STEPS} steps, best of {TIME_REPS}); the per-cell "
          f"flat slice {flat_ms:.3f} ms/step ({card})", flush=True)

    # the dense front: from-init reps of the stepwise public-API loop,
    # bench.py's physics checks through the public API on every rep
    model_d.dense_state, model_d.th, model_d.rv = fd_init
    model_d.run(2)                                       # warm-up
    best = float("inf")
    for _ in range(TIME_REPS):
        model_d.dense_state, model_d.th, model_d.rv = fd_init
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_d.run(TIME_STEPS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        flat_physics_checks(model_d, dw0, dd0, c)
    front_ms = best / TIME_STEPS * 1e3
    print(f"timing dense front (public API, coalescence on), kernels: "
          f"{front_ms:.3f} ms/step, {n_sd * TIME_STEPS / best:.4g} "
          f"SD-updates/s ({TIME_STEPS} steps, best of {TIME_REPS}; {card})")
    print(f"timing, coalescence on, from init: dense front "
          f"{front_ms:.3f} ms/step, dense run_device_lgrngn "
          f"{dense_ms['coalescence on']:.3f}, flat public API "
          f"{flat_ms:.3f} ({card})", flush=True)

    # per-kernel device time at the main path's shapes
    mp = (model.gc_x, model.gc_z, model.G)
    n, x, z = d0.n, d0.x, d0.z
    kc = step.transport(cfg, 1.0, True, n, rw2, d0.rd3, x, z, T, p,
                        d0.rhod, eta, *C)
    merge_args = (cfg, kc[0], rw2, d0.rd3, d0.kpa, kc[3], kc[1], kc[2], kc[4])
    calls = {
        "mpdata": lambda plain: mpdata.advect2(th0, rv0, *mp, plain=plain),
        "cond": lambda plain: step.cond(*cond_args, plain=plain),
        "transport": lambda plain: step.transport(
            cfg, 1.0, True, n, rw2, d0.rd3, x, z, T, p, d0.rhod, eta, *C,
            plain=plain),
        "merge": lambda plain: step.rebin_x(*merge_args, plain=plain),
        "coal": lambda plain: coal_call("stride", plain),
        "coal_standalone": lambda plain: coal_call("standalone", plain),
        "cond_flat": lambda plain: cond_ops.cond_flat(**f_kw, plain=plain),
        "cond_sd": lambda plain: cond_ops.advance_rw2(**exact["g_kw"],
                                                      plain=plain),
    }
    launches = dict(main_launches, coal_standalone=standalone,
                    cond_flat=flat_main["cond_flat"],
                    cond_sd=exact["launches"])
    work_e = [coal_work(lambda: coal_call(form, True), ds.n)
              for form in ("stride", "standalone")]
    for form, w in zip(("stride", "standalone"), work_e):
        print(f"E {form} work on the cloud population: {w}")
    bounds = kernel_bounds(cfg, d0, ds, th0, rv0, tha, rva, (model.gc_x,
                           model.gc_z, model.G), kc, prt.cfg, f_kw, work_e)
    bounds["cond_sd"] = cond_sd_bound(exact["g_kw"])
    rows = []
    for k in _ext.KERNELS:
        if k in (_ext.TRANSPORT_UNWRAPPED, _ext.MERGE_EXACT,  # 14's, 15's
                 _ext.COND_SD_FIXED, _ext.COND_SD_ADAPTIVE):  # 8's, 15's
            continue
        ms = time_cuda(lambda: calls[k.name](False), KERNEL_REPS)
        plain_ms = time_cuda(lambda: calls[k.name](True), KERNEL_REPS)
        bound_ms, bound_by = bounds[k.name]
        print(f"kernel {k.name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) ({card})")
        # G's one-substep entry is on no path: its two forms run the
        # per-particle phases (phase 8 checks it launched 0 times there)
        check(launches[k.name] > 0 or k is _ext.COND_SD,
              f"kernel {k.name} was not launched")
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": err[k.name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    rows += exact["rows"]
    ms_dead = time_cuda(lambda: cond_ops.cond_flat(**f_dead), KERNEL_REPS)
    print(f"kernel cond_flat with {FLAT_DEAD_CELL0} more dead slots in cell "
          f"0: {ms_dead:.4f} ms ({card})")

    # B on what a main step after the spin-up gives it (rows of unequal
    # occupancy), against its plain version
    def set_dense(s):
        model_c.dense_state, model_c.th, model_c.rv = s

    b_kw = capture(step, "cond", lambda: (
        set_dense(c_sp), model_c.run_device_lgrngn(1, engine="dense")))
    set_dense((dc0, thc0, rvc0))
    k, pl = step.cond(**b_kw), step.cond(**b_kw, plain=True)
    live = b_kw["n"] > 0
    rel = (max_rel(k[1], pl[1]), max_rel(k[2], pl[2]),
           max_rel(k[0][live], pl[0][live]))
    print(f"B cond in a main step: live droplets a row {int(live.sum(1).min())}"
          f"-{int(live.sum(1).max())}; th rel {rel[0]:.2e}, rv rel "
          f"{rel[1]:.2e}, rw2 rel {rel[2]:.2e}; {time_cuda(lambda: step.cond(**b_kw), KERNEL_REPS):.4f} ms ({card})")
    check(rel[0] <= 2e-6 and rel[1] <= 2e-5 and rel[2] <= 1e-5,
          "cond kernel disagrees with its plain version in a main step")

    # ---- 11. the sustained run: SUSTAINED_r05.json's shape on the card
    sustained(Kinematic2D, dense, _ext, card, dense_ms["coalescence on"])

    # ---- 12. the repack policy forced to retarget at full width
    forced_retargets(Kinematic2D, dense, _ext, card)

    # ---- 13. the terminal velocity formulas off the main path
    vt_rows = formulas(Kinematic2D, dense, _ext, c, card, err)
    print("timing, dense, coalescence on, by formula: " + ", ".join(
        f"{k} {v['ms']:.3f} ms/step" for k, v in vt_rows.items())
        + f"; the flat public API (beard77fast) {flat_ms:.3f} ({card})",
        flush=True)

    # ---- 14. the dense x-slab mesh
    row, shard_err = mesh_phase(Kinematic2D, dense, _ext, step, card,
                                (model, (d0, th0, rv0)),
                                (model_c, (dc0, thc0, rvc0), c_sp),
                                (water0, dry0))
    for kr in rows:                 # B, E and D on the shards' rows too
        kr["max_abs_err"] = max(kr["max_abs_err"],
                                shard_err.get(kr["name"], 0.0))
    rows.append(row)
    model_c.dense_state, model_c.th, model_c.rv = dc0, thc0, rvc0

    # ---- 15. exact and adaptive condensation on the dense engine
    dx_rows, dx = dense_exact(Kinematic2D, dense, _ext, step, card, exact_ms,
                              dense_ms["coalescence on"])
    rows += dx_rows

    if opts.profile:
        model_f = make_model(Kinematic2D, coal=True, engine="flat")
        profile_both(model_c, (dc0, thc0, rvc0), model_f,
                     (model_f.prtcls.state, model_f.th, model_f.rv), card)
        profile_front(model_d, fd_init, card)
        profile_flat(exact["model"], exact["init"], card,
                     label="exact (mixing), public API")
        for label in ("mixing", "adaptive"):
            profile_dense(*dx[label], card,
                          label=f"dense exact ({label}), run_device_lgrngn")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def mesh_population_check(label, d_m, th_m, rv_m, d_s, th_s, rv_s):
    """The mesh's population against the serial engine's, per cell: cell,
    n, rd3, kappa and x exact; z, rw2 and vt within kernel B's rw2 gate
    (rel 1e-5), th and rv within its gates (2e-6, 2e-5)."""
    cols = lambda d: multiset(d.n, (d.rd3, d.kpa, d.x, d.z, d.rw2, d.vt))
    a, b = cols(d_m), cols(d_s)
    check(a.shape == b.shape, f"mesh {label}: {a.shape[0]} SDs, serial "
          f"{b.shape[0]}")
    exact = np.array_equal(a[:, :5], b[:, :5])
    rel = float(np.max(np.abs(a[:, 5:] - b[:, 5:])
                       / np.maximum(np.abs(b[:, 5:]), 1e-300)))
    same = float(np.all(a == b, axis=1).mean())
    rel_th, rel_rv = max_rel(th_m, th_s), max_rel(rv_m, rv_s)
    print(f"mesh {label}: {a.shape[0]} SDs; cell/n/rd3/kappa/x equal "
          f"{exact}; z/rw2/vt rel {rel:.2e}; SDs bitwise equal in every plane "
          f"{same:.6f}; th rel {rel_th:.2e}, rv rel {rel_rv:.2e}", flush=True)
    check(exact, f"mesh {label}: cell, n, rd3, kappa or x differ from the "
          f"serial engine's")
    check(rel <= 1e-5 and rel_th <= 2e-6 and rel_rv <= 2e-5,
          f"mesh {label}: beyond kernel B's gates")
    check(int(d_m.overflow) == 0, f"mesh {label}: {int(d_m.overflow)} SDs "
          f"dropped")


def shard_kernels(step, coal, calls, label):
    """B, E and D on each shard's rows, as a mesh step called them
    (``calls``: capture_all's {"cond", "coal", "merge"}), against their
    plain versions: E and D bitwise, B within its gates (th 2e-6, rv 2e-5,
    rw2 1e-5 on live lanes).  Returns {kernel name: max abs error}."""
    err = {"cond": 0.0, "coal": 0.0, "merge": 0.0}
    rel = [0.0, 0.0, 0.0]
    for kw in calls["cond"]:
        k, pl = step.cond(**kw), step.cond(**kw, plain=True)
        live = kw["n"] > 0
        rel = [max(rel[0], max_rel(k[1], pl[1])),
               max(rel[1], max_rel(k[2], pl[2])),
               max(rel[2], max_rel(k[0][live], pl[0][live]))]
        err["cond"] = max(err["cond"], max_abs(k[0][live], pl[0][live]),
                          max_abs(k[1], pl[1]), max_abs(k[2], pl[2]))
    same = {"coal": True, "merge": True}
    for name, fn in (("coal", coal.coal_resident), ("merge", step.rebin_x)):
        for kw in calls[name]:
            k, pl = fn(**kw), fn(**kw, plain=True)
            same[name] = same[name] and all(torch.equal(a, b)
                                            for a, b in zip(k, pl))
            err[name] = max(err[name], *(max_abs(a, b) for a, b in zip(k, pl)))
    rows0 = [int(kw["row0"]) for kw in calls["coal"]]
    print(f"B/E/D on the shards' rows, {label}: {len(calls['cond'])}/"
          f"{len(calls['coal'])}/{len(calls['merge'])} calls, E's first rows "
          f"{rows0}; B th rel {rel[0]:.2e}, rv rel {rel[1]:.2e}, rw2 rel "
          f"{rel[2]:.2e}; E bitwise {same['coal']}, D bitwise "
          f"{same['merge']}", flush=True)
    check(rel[0] <= 2e-6 and rel[1] <= 2e-5 and rel[2] <= 1e-5,
          f"mesh {label}: kernel B differs from its plain version on a shard")
    check(same["coal"] and same["merge"], f"mesh {label}: kernel E or D "
          f"differs from its plain version on a shard")
    return err


def mesh_phase(Kinematic2D, dense, _ext, step, card, off, on, totals):
    """Phase 14: the dense x-slab mesh at full width, over MESH_SHARDS
    shards on this card and over 1.  ``off`` is (the coalescence-off
    model, its initial state), ``on`` (the coalescing model, its initial
    state, its state after the spin-up), ``totals`` the initial water and
    dry mass.  Returns (the JSON row of kernel C's unwrapped form, the max
    abs errors of B, E and D against their plain versions on the shards'
    rows)."""
    from types import SimpleNamespace

    from libcloudphxx_tpu_torch.ops import coal
    from libcloudphxx_tpu_torch.parallel import MeshRunner, slab_widths
    (m_off, init_off), (m_on, init_on, c_sp) = off, on
    check(slab_widths(NX, MESH_SHARDS) == MESH_WIDTHS,
          f"slabs {slab_widths(NX, MESH_SHARDS)}")
    err, launches_main, kc_args = 0.0, None, None
    shard_err = {"cond": 0.0, "coal": 0.0, "merge": 0.0}
    for n_shards in (MESH_SHARDS, 1):
        label = f"{n_shards} shard{'s' * (n_shards > 1)}"
        # C's unwrapped form against its plain version on every shard's
        # rows, in a spin-up step from init and a coalescing step after
        # the spin-up
        r = MeshRunner(m_on, n_shards)
        calls = []
        for st, spinup in ((init_on, True), (c_sp, False)):
            r.load(*st)
            calls += capture(step, "transport", lambda: r.step(spinup),
                             which=None)
        check(len(calls) == 2 * n_shards and all(
            c["slab"] is not None for c in calls), f"mesh {label}: "
            f"{len(calls)} transport calls")
        same, moved = True, 0
        for kw in calls:
            kc, pc = step.transport(**kw), step.transport(**kw, plain=True)
            same = same and all(torch.equal(a, b) for a, b in
                                zip(kc[:5], pc[:5])) \
                and torch.equal(kc[5][:, 4], pc[5][:, 4])
            err = max(err, *(max_abs(a, b) for a, b in zip(kc[:4], pc[:4])))
            moved += int(((kc[0] > 0) & (kc[4] < 0)).sum())
        print(f"C unwrapped, {label}: {len(calls)} calls (a spin-up and a "
              f"coalescing step), n/x/z/vt/targets and far flags bitwise "
              f"equal {same}; {moved} droplets left their shard", flush=True)
        check(same, f"mesh {label}: kernel C's unwrapped form differs from "
              f"its plain version")
        check(n_shards == 1 or moved > 0, f"mesh {label}: nobody left a "
              f"shard")
        if n_shards == MESH_SHARDS:
            kc_args = calls[n_shards]     # shard 0 in the coalescing step

        # coalescence off: MESH_STEPS steps against the serial engine
        r_off = MeshRunner(m_off, n_shards)
        r_off.load(*init_off)
        r_off.run(MESH_STEPS)
        d_m, th_m, rv_m = r_off.state(), m_off.th, m_off.rv
        m_off.dense_state, m_off.th, m_off.rv = init_off
        m_off.run_device_lgrngn(MESH_STEPS, engine="dense")
        mesh_population_check(
            f"{label}, coalescence off, {MESH_STEPS} steps", d_m, th_m, rv_m,
            m_off.dense_state, m_off.th, m_off.rv)
        check(int(r_off.crossed) > 0, f"mesh {label}: no SD crossed")
        m_off.dense_state, m_off.th, m_off.rv = init_off

        # coalescence on: the first step after the spin-up, the same; and
        # from the same state with radii x10 (drizzle), where droplets
        # certainly collide: there B, E and D on each shard's rows against
        # their plain versions
        drizzle = (dataclasses.replace(c_sp[0], rw2=c_sp[0].rw2 * 100.0),) \
            + tuple(c_sp[1:])
        for what, st in (("after the spin-up", c_sp),
                         ("after the spin-up, radii x10", drizzle)):
            r.load(*st)
            if st is drizzle:
                calls = capture_all({"cond": (step, "cond"),
                                     "coal": (coal, "coal_resident"),
                                     "merge": (dense, "rebin_x")}, r.step)
                check(all(len(v) == n_shards for v in calls.values()),
                      f"mesh {label}: B/E/D calls "
                      f"{ {k: len(v) for k, v in calls.items()} }")
                for k, e in shard_kernels(step, coal, calls, label).items():
                    shard_err[k] = max(shard_err[k], e)
            else:
                r.step()
            d_m, th_m, rv_m = r.state(), m_on.th, m_on.rv
            m_on.dense_state, m_on.th, m_on.rv = st
            m_on.run_device_lgrngn(1, engine="dense")
            lost = collided(st[0], m_on.dense_state)
            print(f"mesh {label}, coalescence on, the first step {what}: "
                  f"multiplicity lost to collisions {lost:.3e} (serial)")
            mesh_population_check(
                f"{label}, coalescence on, the first step {what}", d_m,
                th_m, rv_m, m_on.dense_state, m_on.th, m_on.rv)
        check(lost > 0, f"mesh {label}: no collision in the serial drizzle "
              f"step")

        # the main path: spin-up and coalescing steps from init
        r.load(*init_on)
        reset(_ext.KERNELS)
        r.run(SLICE_SPINUP, spinup=SLICE_SPINUP)
        d_sp = r.state()
        r.run(SLICE_MAIN)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _ext.KERNELS}
        d_end = r.state()
        m_on.dense_state = d_end
        dw, dd = physics_checks(m_on, *totals, dense)
        lost = collided(d_sp, d_end)
        print(f"mesh {label}, coalescence on: {SLICE_SPINUP} spin-up + "
              f"{SLICE_MAIN} main steps; water rel err {dw:.2e}, dry rel err "
              f"{dd:.2e}, SDs {int((d_end.n > 0).sum())}, overflow "
              f"{int(d_end.overflow)}, crossed slab edges {int(r.crossed)}, "
              f"global re-bins {d_end.rebins}, multiplicity lost to "
              f"collisions {lost:.3e}; launches {launches}", flush=True)
        steps = SLICE_SPINUP + SLICE_MAIN
        want = dict(mpdata=steps, cond=n_shards * steps,
                    transport_unwrapped=n_shards * steps,
                    merge=n_shards * steps, coal=n_shards * SLICE_MAIN,
                    transport=0)
        check({k: launches[k] for k in want} == want,
              f"mesh {label}: launches {launches}, expected {want}")
        check(int(r.crossed) > 0 and lost > 0,
              f"mesh {label}: no SD crossed a slab edge or no collision")
        if n_shards == MESH_SHARDS:
            launches_main = launches

    # timing: best of TIME_REPS from-init reps of TIME_STEPS coalescing
    # steps, the mesh at MESH_SHARDS and 1 shards and the serial engine
    ms = {}
    for n_shards in (MESH_SHARDS, 1):
        r = MeshRunner(m_on, n_shards)
        r.load(*init_on)
        r.run(2)                                              # warm-up
        best = float("inf")
        for _ in range(TIME_REPS):
            r.load(*init_on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.run(TIME_STEPS)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            m_on.dense_state = r.state()
            physics_checks(m_on, *totals, dense)
        ms[n_shards] = best / TIME_STEPS * 1e3
    t_s, _ = time_reps(m_on, init_on, TIME_STEPS, False, totals, dense)
    ms["serial"] = t_s / TIME_STEPS * 1e3
    print(f"timing mesh, coalescence on, from init ({TIME_STEPS} steps, best "
          f"of {TIME_REPS}): {MESH_SHARDS} shards {ms[MESH_SHARDS]:.3f} "
          f"ms/step, 1 shard {ms[1]:.3f} ms/step, the serial dense engine "
          f"{ms['serial']:.3f} ms/step ({card})", flush=True)

    # C's unwrapped form per launch on shard 0's rows in a coalescing step
    k_ms = time_cuda(lambda: step.transport(**kc_args), KERNEL_REPS)
    p_ms = time_cuda(lambda: step.transport(**kc_args, plain=True),
                     KERNEL_REPS)
    kc = step.transport(**kc_args)
    shard = SimpleNamespace(n=kc_args["n"], rw2=kc_args["rw2"],
                            rhod=kc_args["rhod"])
    cfg = kc_args["cfg"]
    bound_ms, bound_by = transport_bound(cfg, shard, kc)
    print(f"kernel transport_unwrapped: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), on {kc_args['n'].shape[0]} "
          f"rows x {kc_args['n'].shape[1]} ({card})", flush=True)
    k = _ext.TRANSPORT_UNWRAPPED
    return {"name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": launches_main["transport_unwrapped"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, shard_err


def khv_float32_nan(rw2, rhod, eta):
    """The droplets whose vt the reference's float32 Khvorostyanov
    (common/vterm.py's operation order in float32, as the JAX package's
    TPU kernel evaluates it) gives as NaN: root rounds to 1, and
    b = 0 / 0."""
    r = torch.sqrt(rw2)
    X = (32.0 / 3) * (1e3 - rhod) / rhod * 9.81 * r ** 3 / eta ** 2 \
        * rhod ** 2
    return torch.sqrt(1.0 + 0.0902 * torch.sqrt(X)) == 1.0


def formula_kernels(cfg, m, ds, err, label):
    """Kernels B, C (full form on the cloud and on rain, and the vt-only
    form) and E (stride, sort, standalone) under ``cfg``'s formula at the
    main path's shapes, against their plain versions: B within its
    cell-sum gates, C and E bitwise; ``m`` the model at init, ``ds`` its
    population after the spin-up.  Returns the event time of each kernel's
    call [ms]."""
    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    from libcloudphxx_tpu_torch.models import mpdata
    from libcloudphxx_tpu_torch.ops import coal, step
    d0 = m.dense_state
    tha, rva = mpdata.advect2(m.th, m.rv, m.gc_x, m.gc_z, m.G)
    lam_D, lam_K = hskpng_mfp(d0.T, d0.p)
    cond_args = (cfg, SSTP_COND, 1.0, 44.0, d0.n, d0.rw2, d0.rd3, d0.kpa,
                 tha.reshape(-1), rva.reshape(-1), d0.sstp_tmp_th,
                 d0.sstp_tmp_rv, d0.rhod, d0.dv, lam_D, lam_K, d0.p)
    kb, pb = step.cond(*cond_args), step.cond(*cond_args, plain=True)
    live = d0.n > 0
    rel = (max_rel(kb[1], pb[1]), max_rel(kb[2], pb[2]),
           max_rel(kb[0][live], pb[0][live]))
    err["cond"] = max(err["cond"], max_abs(kb[0][live], pb[0][live]),
                      max_abs(kb[1], pb[1]), max_abs(kb[2], pb[2]))
    print(f"{label}: B cond th rel {rel[0]:.2e}, rv rel {rel[1]:.2e}, rw2 "
          f"rel {rel[2]:.2e}; finite {bool(torch.isfinite(kb[0]).all())}")
    check(rel[0] <= 2e-6 and rel[1] <= 2e-5 and rel[2] <= 1e-5
          and bool(torch.isfinite(kb[0]).all()),
          f"{label}: cond kernel disagrees with its plain version")
    rw2, T, p, eta = kb[0], kb[3], kb[4], kb[6]
    C = dense._row_courants(cfg, d0)
    rain = (torch.where(live, 2.0, 0.0), torch.where(live, 1e-6, 0.0),
            torch.where(live, cfg.z0 + 20.0 * (d0.z / cfg.z1), d0.z))
    c_args = {}
    for pop, (n, w2, z) in (("cloud", (d0.n, rw2, d0.z)), ("rain", rain)):
        for form, sedi, adve in (("full", True, True),
                                 ("vt only", False, False)):
            args = (cfg, 1.0, sedi, n, w2, d0.rd3, d0.x, z, T, p, d0.rhod,
                    eta) + C
            kc = step.transport(*args, do_adve=adve)
            pc = step.transport(*args, do_adve=adve, plain=True)
            pairs = [(a, b) for a, b in zip(kc[:5], pc[:5])
                     if a is not None]
            same = all(torch.equal(a, b) for a, b in pairs)
            err["transport"] = max(err["transport"],
                                   *(max_abs(a, b) for a, b in pairs))
            print(f"{label}: C {pop}, {form}: bitwise equal {same}, vt "
                  f"finite {bool(torch.isfinite(kc[3]).all())}")
            check(same and bool(torch.isfinite(kc[3]).all()),
                  f"{label}: kernel C ({pop}, {form}) differs from its "
                  f"plain version")
            c_args.setdefault(form, args)
    params = m.opts_init.kernel_parameters
    e_args = (cfg, params, SSTP_COAL, 1.0, ds.rng_seed, ds.rng_step, ds.n,
              ds.rw2, ds.rd3, ds.kpa, ds.x, ds.z, ds.T, ds.p, ds.rhod,
              ds.eta, ds.dv)
    calls = {"cond": lambda: step.cond(*cond_args),
             "transport": lambda: step.transport(*c_args["full"]),
             "transport vt only": lambda: step.transport(
                 *c_args["vt only"], do_adve=False)}
    for form in ("stride", "sort", "standalone"):
        if form == "standalone":
            run = lambda plain: coal.coal_standalone(*e_args, plain=plain)
        else:
            run = lambda plain, form=form: coal.coal_resident(
                *e_args, pairing=form, plain=plain)
        ko, po = run(False), run(True)
        lanes = all(torch.equal(a, b) for a, b in zip(ko, po))
        key = "coal_standalone" if form == "standalone" else "coal"
        err[key] = max(err[key], max(max_abs(a, b) for a, b in zip(ko, po)))
        lost = float(ds.n.double().sum() - ko[0].double().sum())
        print(f"{label}: E coal {form}: lanes equal {lanes}, multiplicity "
              f"lost {lost:.6g}")
        check(lanes, f"{label}: E {form} differs from its plain version")
        calls["coal " + form] = lambda run=run: run(False)
    return {k: time_cuda(fn, KERNEL_REPS) for k, fn in calls.items()}


def formulas(Kinematic2D, dense, _ext, c, card, err):
    """The terminal velocity formulas the main path does not use, on
    bench.py's case at full width: for each of FORMULAS kernels B, C and E
    against their plain versions at the main path's shapes
    (formula_kernels); the smallest live wet radius and the NaN vt under
    float32; the dense slice from init with bench.py's physics checks and
    kernels A-E launched, collisions, the kernel path against the plain
    path after FORMULA_PLAIN_STEPS steps, best-of-3 timing and each
    kernel's device time in the step beside its bound.  beard77fast (the
    main path) runs the slice's timing and device times too, for the
    comparison within this call.  Under khvorostyanov_nonspherical the
    dense front's stepwise run equals run_device_lgrngn(engine="dense")
    bitwise, and the flat engine runs FORMULA_FLAT_STEPS steps through the
    public API with the physics checks."""
    from libcloudphxx_tpu_torch.lgrngn import backend_t, factory, vt_t
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    from libcloudphxx_tpu_torch.models import mpdata
    from libcloudphxx_tpu_torch.ops import coal, step
    steps = SLICE_SPINUP + SLICE_MAIN
    path = ("mpdata", "cond", "transport", "merge", "coal")
    rows = {}
    for name in ("beard77fast",) + FORMULAS:
        f, label = vt_t[name], f"vt {name}"
        t0 = time.perf_counter()
        m = make_model(Kinematic2D, coal=True, vt=f)
        cfg, init = m.cfg, (m.dense_state, m.th, m.rv)
        check(vt_t(cfg.terminal_velocity) == f, f"{label}: the model runs "
              f"{vt_t(cfg.terminal_velocity).name}")
        d0 = init[0]
        live = d0.n > 0
        totals = dense.water_dry_totals(d0, m.rv)
        print(f"{label}: init {time.perf_counter() - t0:.1f} s, "
              f"{int(live.sum())} SDs; " + nan_report(cfg, d0), flush=True)
        # the slice from init: spin-up and coalescing steps
        reset(_ext.KERNELS)
        m.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP,
                            engine="dense")
        sp = (m.dense_state, m.th, m.rv)
        ds = sp[0]
        m.run_device_lgrngn(SLICE_MAIN, engine="dense")
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _ext.KERNELS}
        dw, dd = physics_checks(m, *totals, dense)
        end = (m.dense_state, m.th, m.rv)
        lost = collided(ds, end[0])
        print(f"{label}: after the slice, " + nan_report(cfg, end[0]))
        print(f"{label}: slice {SLICE_SPINUP} spin-up + {SLICE_MAIN} main "
              f"steps, water rel err {dw:.2e}, dry rel err {dd:.2e}, "
              f"multiplicity lost to collisions {lost:.3e}; launches "
              f"{launches}", flush=True)
        check(all(launches[k] > 0 for k in path),
              f"{label}: a kernel of the path was not launched: {launches}")
        check(lost > 0.0, f"{label}: no collision in the main steps")
        ev = {} if name == "beard77fast" else \
            formula_kernels(cfg, m, ds, err, label)
        # the kernel path against the plain path from init
        outs = []
        for plain in (False, True):
            m.dense_state, m.th, m.rv = init
            m.run_device_lgrngn(FORMULA_PLAIN_STEPS,
                                spinup=FORMULA_PLAIN_SPINUP, plain=plain,
                                engine="dense")
            outs.append((m.th, m.rv))
        rel_th = max_rel(outs[0][0], outs[1][0])
        rel_rv = max_rel(outs[0][1], outs[1][1])
        print(f"{label}: kernels vs plain after {FORMULA_PLAIN_STEPS} steps: "
              f"th rel {rel_th:.2e}, rv rel {rel_rv:.2e}")
        check(rel_th <= 1e-4 and rel_rv <= 1e-3,
              f"{label}: the kernel path drifted from the plain path")
        # timing, and each kernel's device time in the coalescing steps
        t, _ = time_reps(m, init, TIME_STEPS, False, totals, dense)
        ms = t / TIME_STEPS * 1e3
        m.dense_state, m.th, m.rv = sp
        dev = device_ms(lambda n: m.run_device_lgrngn(n, engine="dense"),
                        PROFILE_STEPS, ("cond_kernel", "coal_kernel",
                                        "transport_kernel"))
        m.dense_state, m.th, m.rv = init
        # each kernel's bound on the inputs of this run
        kc = step.transport(cfg, 1.0, True, d0.n, d0.rw2, d0.rd3, d0.x,
                            d0.z, d0.T, d0.p, d0.rhod, d0.eta,
                            *dense._row_courants(cfg, d0))
        tha, rva = mpdata.advect2(m.th, m.rv, m.gc_x, m.gc_z, m.G)
        e_args = (cfg, m.opts_init.kernel_parameters, SSTP_COAL, 1.0,
                  ds.rng_seed, ds.rng_step, ds.n, ds.rw2, ds.rd3, ds.kpa,
                  ds.x, ds.z, ds.T, ds.p, ds.rhod, ds.eta, ds.dv)
        work = [coal_work(lambda: coal.coal_resident(*e_args, plain=True),
                          ds.n),
                coal_work(lambda: coal.coal_standalone(*e_args, plain=True),
                          ds.n)]
        bounds = dict(cond=cond_bound(cfg, d0, tha, rva),
                      transport=transport_bound(cfg, d0, kc),
                      **coal_bounds(cfg, ds, work))
        print(f"timing {label}, dense, coalescence on: {ms:.3f} ms/step, "
              f"{int(live.sum()) * TIME_STEPS / t:.4g} SD-updates/s "
              f"({TIME_STEPS} steps, best of {TIME_REPS}; {card})")
        in_step = {"cond": "cond_kernel", "transport": "transport_kernel",
                   "coal": "coal_kernel"}
        a_call = {"cond": "cond", "transport": "transport",
                  "coal": "coal stride", "coal_standalone": "coal standalone"}
        for k, (b_ms, b_by) in bounds.items():
            dms = dev.get(in_step.get(k))
            call = ev.get(a_call[k])
            print(f"{label}: kernel {k}: in the step "
                  + (f"{dms:.4f} ms/step" if dms else "not measured")
                  + (f", a call {call:.4f} ms" if call else "")
                  + f", bound {b_ms:.4f} ms ({b_by}) ({card})")
        if "transport vt only" in ev:
            print(f"{label}: kernel transport, vt-only form, a call "
                  f"{ev['transport vt only']:.4f} ms ({card})")
        rows[name] = dict(ms=ms)
        if name != "khvorostyanov_nonspherical":
            continue
        # the dense front through the public API, bitwise against the
        # slice's run_device_lgrngn(engine="dense") from the same init
        probe = factory(backend_t.CUDA, m.opts_init, device=DEVICE)
        check(isinstance(probe, particles_dense_t),
              f"{label}: factory on the card gave {type(probe).__name__}")
        md = make_model(Kinematic2D, coal=True, vt=f)
        check(isinstance(md.prtcls, particles_dense_t),
              f"{label}: Kinematic2D's public API is "
              f"{type(md.prtcls).__name__}")
        fw0 = flat_totals(md.prtcls, md.rv, c)
        reset(_ext.KERNELS)
        md.run(steps, spinup=SLICE_SPINUP)
        torch.cuda.synchronize()
        front = {k.name: k.launches for k in _ext.KERNELS}
        d_f, (d_r, th_r, rv_r) = md.dense_state, end
        eq = {"th": bool(torch.equal(md.th, th_r)),
              "rv": bool(torch.equal(md.rv, rv_r)),
              "all planes": bool(np.array_equal(population(d_f),
                                                population(d_r)))}
        dw, dd = flat_physics_checks(md, *fw0, c)
        print(f"{label}: dense front, public API: launches {front}; vs "
              f"run_device_lgrngn(engine='dense') bitwise equal {eq}; water "
              f"rel err {dw:.2e}, dry rel err {dd:.2e}", flush=True)
        check(all(front[k] > 0 for k in path), f"{label}: dense front: a "
              f"kernel of the path was not launched: {front}")
        check(all(eq.values()), f"{label}: the dense front differs from "
              "run_device_lgrngn(engine='dense')")
        # the flat engine through the public API
        mf = make_model(Kinematic2D, coal=True, engine="flat", vt=f)
        check(type(mf.prtcls).__name__ == "particles_t",
              f"{label}: factory(engine='flat') gave "
              f"{type(mf.prtcls).__name__}")
        fw0 = flat_totals(mf.prtcls, mf.rv, c)
        reset(_ext.KERNELS)
        mf.run(FORMULA_FLAT_STEPS, spinup=FORMULA_PLAIN_SPINUP)
        torch.cuda.synchronize()
        flat = {k.name: k.launches for k in (_ext.MPDATA, _ext.COND_FLAT)}
        dw, dd = flat_physics_checks(mf, *fw0, c)
        vt_f = torch.as_tensor(mf.prtcls.get_attr("vt"))
        print(f"{label}: flat engine, public API, {FORMULA_FLAT_STEPS} steps: "
              f"launches {flat}, water rel err {dw:.2e}, dry rel err "
              f"{dd:.2e}, vt finite {bool(torch.isfinite(vt_f).all())}",
              flush=True)
        check(flat == {"mpdata": 2 * FORMULA_FLAT_STEPS,
                       "cond_flat": FORMULA_FLAT_STEPS},
              f"{label}: flat: kernel A twice and F once a step expected, "
              f"got {flat}")
        check(bool(torch.isfinite(vt_f).all()), f"{label}: flat: NaN vt")
    return rows


def nan_report(cfg, d):
    """The smallest live wet radius of a DenseState and its NaN vt: the
    port's (kernel C's vt-only form; none, or the check fails) and, under
    Khvorostyanov, the float32 evaluation's (khv_float32_nan)."""
    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.ops import step
    live = d.n > 0
    vt = step.transport(cfg, 1.0, False, d.n, d.rw2, d.rd3, d.x, d.z, d.T,
                        d.p, d.rhod, d.eta, *dense._row_courants(cfg, d),
                        do_adve=False)[3]
    nan_port = int(torch.isnan(vt[live]).sum())
    check(nan_port == 0, f"{nan_port} NaN vt")
    col = lambda a: a[:, None].expand_as(d.n)[live]
    nan_f32 = int(khv_float32_nan(d.rw2[live], col(d.rhod),
                                  col(d.eta)).sum())
    return (f"smallest live wet radius {float(d.rw2[live].min().sqrt()):.4g}"
            f" m; NaN vt: port {nan_port}, the float32 evaluation of "
            f"Khvorostyanov {nan_f32}")


def sustained(Kinematic2D, dense, _ext, card, from_init_ms):
    """nt 3600 steps, 2400 of them spin-up, on the dense engine with the
    repack policy every 50 steps (margin 1.25), as SUSTAINED_r05.json: the
    chunk log, the last 1000 steps' ms/step (timed as one call of
    run_device_lgrngn) beside the from-init one, the global re-bins,
    bench.py's physics checks at the end."""
    m = make_model(Kinematic2D, coal=True)
    d = m.dense_state
    water0, dry0 = dense.water_dry_totals(d, m.rv)
    n0 = int((d.n > 0).sum())
    log, repacks = [], []
    unwrap = checked_repacks(dense, repacks)
    reset(_ext.KERNELS)
    policy = dict(engine="dense", repack_every=REPACK_EVERY,
                  repack_margin=REPACK_MARGIN, chunk_log=log)
    t0 = time.perf_counter()
    try:
        m.run_device_lgrngn(SUSTAINED_NT - SUSTAINED_TAIL,
                            spinup=SUSTAINED_SPINUP, **policy)
        torch.cuda.synchronize()
        t1, n_first = time.perf_counter(), len(log)
        m.run_device_lgrngn(SUSTAINED_TAIL, **policy)
        torch.cuda.synchronize()
    finally:
        unwrap()
    t2 = time.perf_counter()
    wall, tail_ms = t2 - t0, (t2 - t1) / SUSTAINED_TAIL * 1e3
    launches = {k.name: k.launches for k in _ext.KERNELS}
    rebins = m.dense_state.rebins - d.rebins
    step0 = 0
    for i, e in enumerate(log):
        if i == n_first:   # the tail's call
            step0 = SUSTAINED_NT - SUSTAINED_TAIL
        e["step0"] = step0
        step0 += e["steps"]
        print(f"sustained chunk: steps {e['step0']:>4}+{e['steps']} "
              f"{'spin-up' if e['spinup'] else 'main   '} occ {e['occ']:>3} "
              f"cap {e['cap']:>3} {e['seconds']:.4f} s "
              f"({e['seconds'] / e['steps'] * 1e3:.3f} ms/step)"
              + (f" after {e['redo']} retargets" if e["redo"] else ""))
    median_ms = float(np.median([e["seconds"] / e["steps"] * 1e3
                                 for e in log[n_first:]]))
    d = m.dense_state
    alive = int((d.n > 0).sum())
    dw, dd = physics_checks(m, water0, dry0, dense)
    print(f"sustained run: {SUSTAINED_NT} steps ({SUSTAINED_SPINUP} spin-up) "
          f"in {wall:.1f} s, repack every {REPACK_EVERY} (margin "
          f"{REPACK_MARGIN}), capacities {sorted({e['cap'] for e in log})}, "
          f"occupancy up to {max(e['occ'] for e in log)}, {len(repacks)} "
          f"repacks {repacks}; launches {launches}; global re-bins {rebins}")
    print(f"sustained: last {SUSTAINED_TAIL} steps {tail_ms:.3f} ms/step "
          f"(median logged chunk {median_ms:.3f}), {alive * 1e3 / tail_ms:.4g} "
          f"SD-updates/s; from init {from_init_ms:.3f} ms/step; sustained / "
          f"from-init {tail_ms / from_init_ms:.3f} ({card})")
    print(f"sustained, at the end: SDs alive {alive} of {n0}, water rel err "
          f"{dw:.2e}, dry rel err {dd:.2e}", flush=True)
    check(all(launches[k] > 0 for k in
              ("mpdata", "cond", "transport", "merge", "coal")),
          f"sustained: a kernel of the path was not launched: {launches}")
    # every chunk but the last of each call is logged
    check(len(log) == SUSTAINED_NT // REPACK_EVERY - 2,
          f"sustained: {len(log)} chunks logged")


def forced_retargets(Kinematic2D, dense, _ext, card):
    """The repack policy at full width with retargets forced: 118 SDs a
    cell (0.92 of capacity 128) started at 128, where it must grow (or
    run a chunk again), and then at 512, where it must shrink; every repack
    conserves the population per cell.  Kernel E's device time in the step
    at 512 and 256 (torch.profiler), after the policy runs."""
    m = make_model(Kinematic2D, coal=True, sd_conc=FORCED_SD_CONC)
    d = m.dense_state
    occ0 = occupancy(d)
    print(f"forced retargets: {int((d.n > 0).sum())} SDs, densest cell "
          f"{occ0} = {occ0 / 128:.3f} of capacity 128", flush=True)
    check(0.85 <= occ0 / 128 < 1.0, f"forced: densest cell {occ0}")
    repacks = []
    unwrap = checked_repacks(dense, repacks)
    try:
        for label, cap in (("grow", 128), ("shrink", 512)):
            m.dense_state = dense.repack(m.cfg, m.dense_state, cap)
            start = m.dense_state
            log = []
            reset(_ext.KERNELS)
            m.run_device_lgrngn(FORCED_EVERY * FORCED_CHUNKS, engine="dense",
                                repack_every=FORCED_EVERY,
                                repack_margin=REPACK_MARGIN, chunk_log=log)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in _ext.KERNELS}
            caps = [start.cap] + [e["cap"] for e in log]
            for e in log:
                print(f"forced {label} chunk: {e['steps']} steps occ "
                      f"{e['occ']} cap {e['cap']} {e['seconds']:.4f} s"
                      + (f" after {e['redo']} retargets" if e["redo"]
                         else ""))
            print(f"forced {label}: capacities {caps}; launches {launches}",
                  flush=True)
            check(launches["coal"] == FORCED_EVERY * FORCED_CHUNKS
                  + FORCED_EVERY * sum(e["redo"] for e in log),
                  f"forced {label}: kernel E launches {launches}")
            moved = caps[1] > caps[0] if label == "grow" else \
                caps[1] < caps[0]
            check(moved, f"forced {label}: the policy kept capacity "
                  f"{caps[0]} ({caps})")
            check(int(m.dense_state.overflow) == 0,
                  f"forced {label}: SDs dropped")
        # kernel E's device time in the step at the capacities reached
        fields, e_ms = (m.th, m.rv), {}
        for at in (512, 256):
            m.dense_state = dense.repack(m.cfg, start, at)
            e_ms[at] = device_ms(
                lambda n: m.run_device_lgrngn(n, engine="dense"),
                PROFILE_STEPS, ("coal_kernel",)).get("coal_kernel")
            m.th, m.rv = fields
        print(f"kernel E in the step, {FORCED_SD_CONC} SDs a cell: " + ", ".join(
            f"capacity {at} " + (f"{ms:.4f} ms/step" if ms else
                                 "not measured")
            for at, ms in e_ms.items()) + f" ({card})")
    finally:
        unwrap()
    print(f"forced retargets: repacks {repacks}, each conserving every "
          f"cell's SDs", flush=True)


def form_of(cfg, _ext):
    """Kernel G's form for an exact configuration: (its wrapper's name in
    ops/cond.py, its Kernel)."""
    if cfg.adaptive_sstp_cond:
        return "perparticle_adaptive", _ext.COND_SD_ADAPTIVE
    return "perparticle_fixed", _ext.COND_SD_FIXED


def check_form(label, kw, err):
    """One of G's forms against its plain version on its captured
    arguments ``kw``: rw2 in every slot and the live SDs' private state
    bitwise; with in-cell mixing (the kernel's butterfly sums add in
    another order) B's and F's gates on rw2 1e-5, th 2e-6 and rv 2e-5, the
    live SDs' private rhod and p and the slots it does not advance
    bitwise.  A dead slot's private values
    are not compared (the kernel keeps them; the plain version may leave
    0 * 0 / 0 there).  Records the largest difference in err[key]."""
    from libcloudphxx_tpu_torch import _ext
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    cfg = kw["cfg"]
    fname, kernel = form_of(cfg, _ext)
    f = getattr(cond_ops, fname)
    k, pl = f(**kw), f(**kw, plain=True)
    torch.cuda.synchronize()
    n, rw2 = kw["sd"][0], kw["sd"][1]
    live = n > 0
    key = kernel.name
    err[key] = max(err.get(key, 0.0), max_abs(k[0], pl[0]),
                   *(max_abs(a[live], b[live]) for a, b in zip(k[1:], pl[1:])))
    mix = not cfg.adaptive_sstp_cond and cfg.sstp_cond_mix
    if mix:
        kept = ~live & (rw2 <= 0)
        rel = (max_rel(k[0][live], pl[0][live]), max_rel(k[2][live],
               pl[2][live]), max_rel(k[1][live], pl[1][live]))
        same = bool(torch.equal(k[0][kept], pl[0][kept])) and all(
            torch.equal(a[live], b[live]) for a, b in zip(k[3:], pl[3:]))
        ok = same and rel[0] <= 1e-5 and rel[1] <= 2e-6 and rel[2] <= 2e-5
        what = (f"rw2 rel {rel[0]:.2e}, th rel {rel[1]:.2e}, rv rel "
                f"{rel[2]:.2e} (live), slots not advanced and private rhod, "
                f"p bitwise {same}")
    else:
        ok = bool(torch.equal(k[0], pl[0])) and all(
            torch.equal(a[live], b[live]) for a, b in zip(k[1:], pl[1:]))
        what = f"bitwise equal (rw2 every slot, private state live) {ok}"
    moved = float((k[0] != rw2)[live].double().mean())
    print(f"G {key} {label}: {n.numel()} slots, {int(live.sum())} live; "
          f"{what}; {moved:.4f} of the live SDs changed", flush=True)
    check(ok, f"G's {key} form, {label}: kernel and plain version differ")


def exact_slice(Kinematic2D, _ext, c, err):
    """bench.py's configuration with exact per-particle condensation, in
    each of EXACT_VARIANTS, through the public API on the flat engine
    (factory(engine="flat") -> particles_t -> Kinematic2D.run(); the
    factory's own pick on the card is the dense front, phase 15): spin-up
    and coalescing steps with bench.py's physics checks, kernel G's
    fixed-count or adaptive form once a step and no other condensation
    kernel (G's one-substep entry never), run_device_lgrngn(engine="flat")
    equal to the stepwise loop, and the kernel path against the plain
    path (bitwise).  Then each form against its plain version on what a
    main step gives it (check_form), timed beside its bound, and G's
    one-substep entry against its plain version, bitwise, on the inputs
    of the mixing
    variant's first main substep (the full population), RH capped at 1.01
    and 44, on a ragged length or one droplet, with 65,536 dead slots
    added, and on the adaptive variant's first phase-B call (a dt a
    droplet), each as the plain path calls it.  Returns the mixing
    variant's model, initial state, totals, SD count, the one-substep
    entry's first-substep inputs, and the kernel rows of the two forms on
    the flat segments."""
    from libcloudphxx_tpu_torch.lgrngn import condensation as cnd
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    steps = SLICE_SPINUP + SLICE_MAIN
    out, g_cases, form_kw = {}, {}, {}
    for label, oi in EXACT_VARIANTS.items():
        t0 = time.perf_counter()
        m = make_model(Kinematic2D, coal=True, engine="flat", **oi)
        prt = m.prtcls
        check(type(prt).__name__ == "particles_t",
              f"exact {label}: engine='flat' gave {type(prt).__name__}")
        check(prt.state.sstp_tmp_th.shape == prt.state.n.shape
              and prt.state.sstp_tmp_p.shape == prt.state.n.shape,
              f"exact {label}: the substepping snapshot is not per SD")
        torch.cuda.synchronize()
        init = (prt.state, m.th, m.rv)
        totals = flat_totals(prt, m.rv, c)
        n_sd = int((prt.state.n > 0).sum())
        fname, form = form_of(prt.cfg, _ext)

        def restore(s):
            prt.state, m.th, m.rv = s

        reset(_ext.KERNELS)
        t1 = time.perf_counter()
        m.run(SLICE_SPINUP, spinup=SLICE_SPINUP)
        torch.cuda.synchronize()
        sp = (prt.state, m.th, m.rv)
        m.run(SLICE_MAIN)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = {k.name: k.launches for k in _ext.KERNELS}
        dw, dd = flat_physics_checks(m, *totals, c)
        end = (prt.state, m.th, m.rv)
        lost = collided(sp[0], end[0])
        print(f"exact slice, {label}: init {t1 - t0:.1f} s, {n_sd} SDs; "
              f"{SLICE_SPINUP} spin-up + {SLICE_MAIN} main steps in "
              f"{secs:.2f} s; water rel err {dw:.2e}, dry rel err {dd:.2e}, "
              f"multiplicity lost to collisions {lost:.3e}; launches "
              f"{launches}", flush=True)
        want = {k.name: 0 for k in _ext.KERNELS}
        want.update({"mpdata": 2 * steps, form.name: steps})
        check(launches == want, f"exact {label}: kernel A twice and G's "
              f"{form.name} form once a step expected (the one-substep "
              f"entry never), got {launches}")
        check(lost > 0.0, f"exact {label}: no collision in the main steps")

        # run_device_lgrngn(engine="flat") from the spin-up state against
        # the stepwise public-API loop
        restore(sp)
        m.run_device_lgrngn(SLICE_MAIN)
        torch.cuda.synchronize()
        eq = {k: bool(torch.equal(getattr(prt.state, k), getattr(end[0], k)))
              for k in ("n", "rw2", "sstp_tmp_th", "sstp_tmp_rv")}
        eq.update(th=bool(torch.equal(m.th, end[1])),
                  rv=bool(torch.equal(m.rv, end[2])))
        print(f"exact {label}: run_device_lgrngn vs stepwise run(): equal "
              f"{eq}", flush=True)
        check(all(eq.values()),
              f"exact {label}: run_device_lgrngn differs from run()")

        # the kernel path against the plain path, from init: bitwise (with
        # mixing too: on the H100 the butterfly's float64 sums round to
        # the float32 bits of the plain float64 sums; PERF.md section 6)
        res = []
        for plain in (False, True):
            restore(init)
            m.run(EXACT_PLAIN_STEPS, spinup=EXACT_PLAIN_SPINUP, plain=plain)
            torch.cuda.synchronize()
            res.append((prt.state, m.th, m.rv))
        (sk, thk, rvk), (sp_, thp, rvp) = res
        rel_th, rel_rv = max_rel(thk, thp), max_rel(rvk, rvp)
        same = all(torch.equal(a, b) for a, b in (
            (thk, thp), (rvk, rvp), (sk.rw2, sp_.rw2),
            (sk.sstp_tmp_th, sp_.sstp_tmp_th)))
        print(f"exact {label}, kernels vs plain after {EXACT_PLAIN_STEPS} "
              f"steps: th rel {rel_th:.2e}, rv rel {rel_rv:.2e}, bitwise "
              f"equal (th, rv, rw2, sstp_tmp_th) {same}", flush=True)
        check(same, f"exact {label}: the kernel path differs from the "
              f"plain path")

        # G's form on what a main step gives it; the one-substep entry's
        # inputs as the plain path calls it (the mixing variant's first
        # main substep, the adaptive variant's first phase-B call)
        form_kw[label] = capture(cond_ops, fname,
                                 lambda: (restore(sp), m.run(1)))
        check_form(f"on the flat segments, {label}", form_kw[label], err)
        which = len(cnd.adaptive_tries(SSTP_COND)) \
            if oi.get("adaptive_sstp_cond") else 0
        g_cases[label] = capture(cond_ops, "advance_rw2",
                                 lambda: (restore(sp), m.run(1, plain=True)),
                                 which)
        restore(init)
        out[label] = dict(model=m, init=init, totals=totals, n_sd=n_sd,
                          launches=launches)

    g_kw = g_cases["mixing"]
    names = [k for k in g_kw if k not in ("dt", "RH_max")]
    cut = lambda kw, n: dict(kw, **{k: kw[k][:n].contiguous()
                                    for k in names})
    dead = dict(g_kw, **{k: torch.cat([g_kw[k], torch.zeros_like(
        g_kw[k][:EXACT_DEAD]) if k == "rw2" else g_kw[k][:EXACT_DEAD]])
        for k in names})
    cases = [("first substep", g_kw),
             ("first substep, RH_max 1.01", dict(g_kw, RH_max=1.01))]
    cases += [(f"length {n}", cut(g_kw, n)) for n in EXACT_LENGTHS]
    cases += [(f"{EXACT_DEAD} dead slots added", dead),
              ("adaptive phase B (a dt a droplet)", g_cases["adaptive"])]
    err["cond_sd"] = 0.0
    for label, kw in cases:
        k = cond_ops.advance_rw2(**kw)
        pl = cond_ops.advance_rw2(**kw, plain=True)
        alive = kw["rw2"] > 0
        same = bool(torch.equal(k, pl))
        err["cond_sd"] = max(err["cond_sd"], max_abs(k, pl))
        moved = float((k != kw["rw2"])[alive].double().mean()) \
            if bool(alive.any()) else 0.0
        print(f"G cond_sd {label}: {kw['rw2'].numel()} slots, "
              f"{int(alive.sum())} with rw2 > 0, dt "
              f"{'a droplet' if isinstance(kw['dt'], torch.Tensor) else kw['dt']}"
              f", RH_max {kw['RH_max']}; bitwise equal {same}, max abs "
              f"{max_abs(k, pl):.3e}; {moved:.4f} of the droplets changed; "
              f"rw2 <= 0 kept {bool(torch.equal(k[~alive], kw['rw2'][~alive]))}",
              flush=True)
        check(same, f"G {label}: kernel and plain version differ")
        check(bool(torch.equal(k[~alive], kw["rw2"][~alive])),
              f"G {label}: a slot with rw2 <= 0 changed")
    check(isinstance(g_cases["adaptive"]["dt"], torch.Tensor),
          "G: the adaptive variant's phase B call has no dt a droplet")
    rows = form_rows(_ext, form_kw, out, "flat", err)
    mix = out["mixing"]
    return dict(mix, launches=mix["launches"]["cond_sd"], g_kw=g_kw,
                rows=rows)


def form_rows(_ext, form_kw, out, where, err):
    """The kernel rows of G's two forms on ``where``'s layout (the
    captured arguments ``form_kw`` of the mixing and the adaptive
    variants, their launches in ``out``): time a launch beside the plain
    version's and the bound."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    card = card_line()
    rows = []
    for label, fname, kernel, bnd in (
            ("mixing", "perparticle_fixed", _ext.COND_SD_FIXED,
             cond_sd_fixed_bound),
            ("adaptive", "perparticle_adaptive", _ext.COND_SD_ADAPTIVE,
             cond_sd_adaptive_bound)):
        kw = form_kw[label]
        f = getattr(cond_ops, fname)
        ms = time_cuda(lambda: f(**kw), KERNEL_REPS)
        plain_ms = time_cuda(lambda: f(**kw, plain=True), FORM_PLAIN_REPS)
        bound_ms, bound_by = bnd(kw)
        launches = out[label]["launches"][kernel.name]
        name = kernel.name + ("_flat" if where == "flat" else "")
        print(f"kernel {name}: {ms:.4f} ms a launch (a phase), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"{launches} launches in the {label} variant's "
              f"{SLICE_SPINUP + SLICE_MAIN} steps ({card})", flush=True)
        check(launches > 0, f"kernel {name} was not launched")
        rows.append({"name": name, "route": "cuda", "source": kernel.source,
                     "replaces": kernel.replaces, "launches": launches,
                     "max_abs_err": err[kernel.name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return rows


def dense_exact(Kinematic2D, dense, _ext, step, card, flat_exact_ms,
                dense_ms):
    """Phase 15: bench.py's configuration with exact per-particle
    condensation on the dense engine, in each of EXACT_VARIANTS: the
    factory on the card gives the dense front; spin-up and coalescing
    steps through run_device_lgrngn(engine="dense") with bench.py's
    physics checks, kernel G's fixed-count or adaptive form on the
    (n_cell, cap) rows and D's 11-plane form once a step, B, D's 7-plane
    form and G's one-substep entry never; the dense front's stepwise run
    bitwise equal to it; G's form (check_form) and the 11-plane D (bitwise)
    against their plain versions on what a main step gives them; the
    kernel path against the plain path from init (bitwise without in-cell
    mixing); best-of-TIME_REPS timing from init beside the flat exact
    slice's and the dense main path's.  Returns (kernel rows for G's two
    forms on the dense rows and the 11-plane D, {variant: (model, initial
    state)})."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    steps = SLICE_SPINUP + SLICE_MAIN
    err = {"merge_exact": 0.0}
    out, timing, form_kw = {}, {}, {}
    for label, oi in EXACT_VARIANTS.items():
        t0 = time.perf_counter()
        m = make_model(Kinematic2D, coal=True, **oi)
        check(isinstance(m.prtcls, particles_dense_t),
              f"dense exact {label}: the factory on the card gave "
              f"{type(m.prtcls).__name__}, not particles_dense_t")
        init = (m.dense_state, m.th, m.rv)
        d0 = init[0]
        check(d0.sd_th.shape == d0.n.shape,
              f"dense exact {label}: no private ambient planes")
        totals = dense.water_dry_totals(d0, m.rv)
        fname, form = form_of(m.cfg, _ext)

        def restore(s):
            m.dense_state, m.th, m.rv = s

        reset(_ext.KERNELS)
        t1 = time.perf_counter()
        m.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP,
                            engine="dense")
        sp = (m.dense_state, m.th, m.rv)
        m.run_device_lgrngn(SLICE_MAIN, engine="dense")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = {k.name: k.launches for k in _ext.KERNELS}
        dw, dd = physics_checks(m, *totals, dense)
        end = (m.dense_state, m.th, m.rv)
        lost = collided(sp[0], end[0])
        print(f"dense exact, {label}: init {t1 - t0:.1f} s, "
              f"{int((d0.n > 0).sum())} SDs at capacity {d0.cap}; "
              f"{SLICE_SPINUP} spin-up + {SLICE_MAIN} main steps in "
              f"{secs:.2f} s; water rel err {dw:.2e}, dry rel err {dd:.2e}, "
              f"multiplicity lost to collisions {lost:.3e}, global re-bins "
              f"{end[0].rebins}; launches {launches}", flush=True)
        want = {k.name: 0 for k in _ext.KERNELS}
        want.update({"mpdata": steps, "transport": steps,
                     "merge_exact": steps, "coal": SLICE_MAIN,
                     form.name: steps})
        check(launches == want, f"dense exact {label}: launches {launches}, "
              f"expected {want}")
        check(lost > 0.0, f"dense exact {label}: no collision in the main "
              f"steps")

        # the dense front's stepwise run from the same state, bitwise
        restore(init)
        reset(_ext.KERNELS)
        m.run(steps, spinup=SLICE_SPINUP)
        torch.cuda.synchronize()
        front = {k.name: k.launches for k in _ext.KERNELS}
        d_f, d_r = m.dense_state, end[0]
        eq = {"th": bool(torch.equal(m.th, end[1])),
              "rv": bool(torch.equal(m.rv, end[2]))}
        for a in dense.attrs_of(m.cfg):
            eq[a] = bool(np.array_equal(
                multiset(d_f.n, (d_f.rd3, getattr(d_f, a))),
                multiset(d_r.n, (d_r.rd3, getattr(d_r, a)))))
        physics_checks(m, *totals, dense)
        print(f"dense exact {label}: dense front, public API: launches "
              f"{front}; vs run_device_lgrngn(engine='dense') bitwise equal "
              f"{eq}", flush=True)
        check(front == dict(want, mpdata=2 * steps), f"dense exact {label}: "
              f"dense front launches {front}")
        check(all(eq.values()), f"dense exact {label}: the dense front "
              f"differs from run_device_lgrngn(engine='dense')")

        # G's form and the 11-plane D on what a main step gives them
        calls = capture_all({"g": (cond_ops, fname),
                             "d": (dense, "rebin_x")},
                            lambda: (restore(sp),
                                     m.run_device_lgrngn(1, engine="dense")))
        form_kw[label] = calls["g"][0]
        check(form_kw[label].get("seg") is None,
              f"dense exact {label}: G's form took a flat layout")
        check_form(f"on the dense rows, {label}", form_kw[label], err)
        d_kw = calls["d"][-1]
        check(len(d_kw["extra"]) == 4, f"dense exact {label}: the merge "
              f"took {len(d_kw['extra'])} extra planes")
        kd = step.rebin_x(**d_kw)
        pd = step.rebin_x(**d_kw, plain=True)
        same = all(torch.equal(a, b) for a, b in zip(kd, pd))
        err["merge_exact"] = max(err["merge_exact"],
                                 *(max_abs(a, b) for a, b in zip(kd, pd)))
        taken = int((d_kw["tgt"] >= 0).sum())
        print(f"D merge_exact, {label}: 11 planes, {taken} droplets taken; "
              f"bitwise equal {same}", flush=True)
        check(same, f"D's 11-plane form, {label}: kernel and plain version "
              f"differ")

        # the kernel path against the plain path, from init: bitwise (with
        # mixing too, as on the flat engine)
        res = []
        for plain in (False, True):
            restore(init)
            m.run_device_lgrngn(EXACT_PLAIN_STEPS, spinup=EXACT_PLAIN_SPINUP,
                                engine="dense", plain=plain)
            torch.cuda.synchronize()
            res.append((m.dense_state, m.th, m.rv))
        (sk, thk, rvk), (sp_, thp, rvp) = res
        rel_th, rel_rv = max_rel(thk, thp), max_rel(rvk, rvp)
        planes = lambda d: multiset(d.n, (d.rd3, d.rw2, d.kpa, d.vt, d.x,
                                          d.z, d.sd_th, d.sd_rv, d.sd_rh,
                                          d.sd_p))
        same = bool(torch.equal(thk, thp) and torch.equal(rvk, rvp)
                    and np.array_equal(planes(sk), planes(sp_)))
        print(f"dense exact {label}, kernels vs plain after "
              f"{EXACT_PLAIN_STEPS} steps: th rel {rel_th:.2e}, rv rel "
              f"{rel_rv:.2e}, bitwise equal (th, rv, every plane) {same}",
              flush=True)
        check(same, f"dense exact {label}: the kernel path differs from "
              f"the plain path")

        # timing: best of TIME_REPS from-init reps, physics checks on each
        restore(init)
        best, _ = time_reps(m, init, TIME_STEPS, False, totals, dense)
        timing[label] = best / TIME_STEPS * 1e3
        print(f"timing dense exact ({label}, run_device_lgrngn, coalescence "
              f"on), kernels: {timing[label]:.3f} ms/step, "
              f"{int((d0.n > 0).sum()) * TIME_STEPS / best:.4g} SD-updates/s "
              f"({TIME_STEPS} steps, best of {TIME_REPS}; {card})",
              flush=True)
        restore(init)
        out[label] = dict(model=m, init=init, d_kw=d_kw, launches=launches)
    print(f"timing, exact condensation, coalescence on, from init: dense "
          f"engine " + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
          + f" ms/step; the flat exact slice (mixing, public API) "
          f"{flat_exact_ms:.3f}; the dense main path (per-cell) "
          f"{dense_ms:.3f} ({card})", flush=True)

    rows = form_rows(_ext, form_kw, out, "dense", err)
    mix = out["mixing"]
    d_kw = mix["d_kw"]
    ms = time_cuda(lambda: step.rebin_x(**d_kw), KERNEL_REPS)
    plain_ms = time_cuda(lambda: step.rebin_x(**d_kw, plain=True),
                         KERNEL_REPS)
    bound_ms, bound_by = merge_exact_bound(d_kw)
    launches = mix["launches"]["merge_exact"]
    print(f"kernel merge_exact: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {launches} launches in the "
          f"mixing variant's {steps} steps ({card})")
    check(launches > 0, "kernel merge_exact was not launched")
    rows.append({"name": "merge_exact", "route": "cuda",
                 "source": _ext.MERGE_EXACT.source,
                 "replaces": _ext.MERGE_EXACT.replaces, "launches": launches,
                 "max_abs_err": err["merge_exact"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None})
    return rows, {k: (v["model"], v["init"]) for k, v in out.items()}


def merge_exact_bound(kw):
    """D's 11-plane bound on its arguments ``kw`` (rebin_x's): the targets
    of every slot and the eleven planes of the droplets it takes (those
    alive after C) in, eleven planes and the drops out, at the memory
    rate, against the nine-source merge of each taken droplet."""
    n, tgt = kw["n"], kw["tgt"]
    live = int((tgt >= 0).sum())
    slot = n.element_size()
    return bound(nbytes(tgt) + 11 * slot * live + 11 * nbytes(n)
                 + slot * n.shape[0], live * OPS_MERGE)


G_ARRAYS = ("rw2", "rd3", "kpa", "vt", "rhod", "rv", "T", "p", "RH", "eta",
            "lam_D", "lam_K")


def cond_sd_bound(kw):
    """Kernel G's one-substep bound on its inputs ``kw`` (advance_rw2's
    arguments): for each droplet with rw2 > 0, 12 arrays in (13 with a dt
    a droplet) and rw2 out, and for each slot with rw2 <= 0, which the
    function returns as it was given, rw2 in and out, at the memory rate;
    against the root find's operations (rootfind_ops) and each droplet's
    growth terms and set-up at the float32 rate."""
    arrays = [kw[k] for k in G_ARRAYS]
    live = arrays[0] > 0
    ops, brk, n_live = rootfind_ops(kw["dt"], arrays, kw["RH_max"], live)
    per_sd = arrays + ([kw["dt"]] if isinstance(kw["dt"], torch.Tensor)
                       else [])
    rw2_b = arrays[0].element_size()
    n = arrays[0].numel()
    moved = (n_live * (sum(a.element_size() for a in per_sd) + rw2_b)
             + (n - n_live) * 2 * rw2_b)
    print(f"G cond_sd: {brk / max(n_live, 1):.4f} of the {n_live} droplets "
          f"with rw2 > 0 bracketed in the first main substep; "
          f"{n - n_live} slots with rw2 <= 0")
    return bound(moved, ops + n_live * (OPS_GROWTH + OPS_DROP))


def _form_bytes(kw):
    """What G's two forms must move: a live SD's nine arrays in and five
    out, a dead slot's n, and its rw2 in and out, each cell's arrays once,
    and the flat layout's order and ends, at the memory rate."""
    sd, cells, seg = kw["sd"], kw["cells"], kw.get("seg")
    n = sd[0]
    live, b = int((n > 0).sum()), n.element_size()
    moved = live * 14 * b + (n.numel() - live) * 3 * b \
        + sum(nbytes(a) for a in cells)
    if seg is not None:
        moved += nbytes(seg[1], seg[2])
    return moved


def _plain_order(kw, a):
    """An SD array in the order the forms' plain versions take it (the
    flat SDs sorted by cell; the dense rows ravelled)."""
    seg = kw.get("seg")
    return (a[seg[1]] if seg is not None else a).reshape(-1)


def cond_sd_fixed_bound(kw):
    """G's fixed-count form's bound on its arguments ``kw``
    (perparticle_fixed's): _form_bytes, against sstp_cond times the root
    finds of the first substep's data (rootfind_ops on what its plain
    version hands the one-substep entry, over the SDs it advances), each
    advanced SD's closure, growth terms and feedback, and its set-up, at
    the float32 rate; the butterfly's float64 sums at the float64 rate."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    cfg = kw["cfg"]
    g1 = capture(cond_ops, "advance_rw2",
                 lambda: cond_ops.perparticle_fixed(**kw, plain=True), 0)
    n, rw2 = (_plain_order(kw, a) for a in kw["sd"][:2])
    advanced = (n > 0) | (rw2 > 0)
    ops1, brk, n_adv = rootfind_ops(g1["dt"], [g1[k] for k in G_ARRAYS],
                                    g1["RH_max"], advanced)
    sstp = cfg.sstp_cond
    n_cell = kw["cells"][0].numel()
    ops = sstp * (ops1 + n_adv * (OPS_CLOSURE + OPS_GROWTH + OPS_FEEDBACK)) \
        + n_adv * OPS_DROP
    ops_f64 = sstp * n_cell * OPS_BUTTERFLY if cfg.sstp_cond_mix else 0
    print(f"G cond_sd_fixed: {brk / max(n_adv, 1):.4f} of the {n_adv} SDs it "
          f"advances bracketed in the first substep; {n.numel() - n_adv} "
          f"slots copied through")
    return bound(_form_bytes(kw), ops, ops_f64)


def cond_sd_adaptive_bound(kw):
    """G's adaptive form's bound on its arguments ``kw``
    (perparticle_adaptive's): _form_bytes, against the work this data
    needs, read off what its plain version hands the one-substep entry:
    each try's root finds over the live SDs not yet converged, the
    critical radius' solve (50 evaluations of its Koehler function, 48
    iterations) for every live SD where sstp_cond_act > 1, and each phase-B
    substep's root finds over the SDs within their own count (not the
    first of one that reuses its converged try), with each such SD's
    closure, growth terms and (in phase B) feedback, at the float32 rate.
    Prints how many SDs take each substep count."""
    from libcloudphxx_tpu_torch.common import kappa_koehler
    from libcloudphxx_tpu_torch.lgrngn import condensation as cnd
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    cfg = kw["cfg"]
    calls = capture(cond_ops, "advance_rw2", lambda:
                    cond_ops.perparticle_adaptive(**kw, plain=True),
                    None)
    tries = cnd.adaptive_tries(cfg.sstp_cond)
    sstp_max, act = max(cfg.sstp_cond, 1), max(cfg.sstp_cond_act, 1)
    sd, cells, seg = kw["sd"], kw["cells"], kw.get("seg")
    n, rw2, rd3, kpa = (_plain_order(kw, a) for a in sd[:4])
    T = cells[7][seg[0]] if seg is not None \
        else cells[7][:, None].expand(sd[0].shape).reshape(-1)
    live = n > 0
    grow = lambda call, need: rootfind_ops(
        call["dt"], [call[k] for k in G_ARRAYS], call["RH_max"], need)[0]
    per_sd = OPS_CLOSURE + OPS_GROWTH
    done = torch.zeros_like(live)
    sstp = torch.full(n.shape, sstp_max, dtype=torch.int32, device=n.device)
    drw2 = torch.zeros_like(rw2)
    ops = 0
    for t, call in zip(tries, calls):
        need = live & ~done
        ops += grow(call, need) + int(need.sum()) * per_sd
        drw2_t = cond_ops.advance_rw2(**call, plain=True) - rw2
        if t == 1:
            drw2 = drw2_t
            continue
        conv = (torch.abs(drw2_t * 2 - drw2)
                <= cfg.sstp_cond_adapt_drw2_eps * rw2) \
            & (torch.abs(drw2) < cfg.sstp_cond_adapt_drw2_max * rw2)
        newly = conv & ~done
        sstp = torch.where(newly, t // 2, sstp)
        done = done | newly
        drw2 = torch.where(done, drw2, drw2_t)
    first = done | (sstp_max == 1)
    if act > 1:
        rc2 = kappa_koehler.rw3_cr(torch.clamp(rd3, min=1e-300),
                                   torch.clamp(kpa, min=1e-10),
                                   T) ** (2.0 / 3)
        proj = rw2 + sstp * drw2
        cross = ((rw2 < rc2) & (proj > rc2)) | ((rw2 > rc2) & (proj < rc2))
        sstp = torch.where(cross, act, sstp)
        first = first & ~cross
        ops += int(live.sum()) * (50 * OPS_KOEHLER + 48 * OPS_ITER)
    for s, call in enumerate(calls[len(tries):]):
        active = live & (s < sstp)
        need = active & ~(first & (s == 0))
        ops += grow(call, need) + int(active.sum()) * (per_sd + OPS_FEEDBACK)
    counts = torch.bincount(sstp[live].long()).tolist()
    print(f"G cond_sd_adaptive: {int(live.sum())} live SDs by substep count "
          f"{ {c: k for c, k in enumerate(counts) if k} }")
    return bound(_form_bytes(kw), ops)


def kernel_bounds(cfg, d0, ds, th0, rv0, tha, rva, mp, kc, f_cfg, f_kw,
                  work_e):
    """{kernel: (bound_ms, bound_by)} from the inputs each kernel takes in
    this run: every input read once and every output written once at the
    memory rate, against the operations these inputs need at the float32
    (and float64) rate.  B's and F's growth work is counted on their first
    substep's data and taken sstp_cond times, beside each cell's substeps
    and each live droplet's set-up."""
    n_cell = d0.n.shape[0]
    out = {}
    # A: two fields in, two out, the courants and G
    out["mpdata"] = bound(
        nbytes(th0, rv0, *mp) + nbytes(th0, rv0),
        2 * n_cell * (OPS_DONOR + OPS_ANTIDIFF + OPS_DONOR))
    out["cond"] = cond_bound(cfg, d0, tha, rva)
    out["transport"] = transport_bound(cfg, d0, kc)
    # D: the targets of every slot and the seven planes of the droplets it
    # takes (those alive after C) in, seven planes and the drops out
    slot, live_c = d0.n.element_size(), int((kc[0] > 0).sum())
    out["merge"] = bound(
        nbytes(kc[4]) + 7 * slot * live_c + 7 * nbytes(d0.n)
        + nbytes(d0.rhod), live_c * OPS_MERGE)
    out.update(coal_bounds(cfg, ds, work_e))
    # F: five SD arrays, the cell ends, ten cell fields and the cell order
    # in; rw2 and three cell fields out
    ops_f, brk, live = rootfind_ops(
        f_kw["dt_sub"], flat_first_substep(f_cfg, f_kw), f_kw["RH_max"],
        f_kw["wgt"] > 0)
    print(f"F cond_flat: {brk / live:.4f} of the {live} live droplets "
          f"bracketed in the first substep")
    sd = [f_kw[k] for k in ("rw2", "rd3", "kpa", "vt", "wgt")]
    n_f = f_kw["th"].numel()
    out["cond_flat"] = bound(
        nbytes(*sd, f_kw["ends"], f_kw["rw2"]) + 14 * nbytes(f_kw["th"]),
        f_kw["sstp"] * ops_f + live * OPS_DROP
        + n_f * (f_kw["sstp"] * OPS_CELL_SUBSTEP + OPS_CLOSURE))
    return out


def cond_bound(cfg, d0, tha, rva):
    """Kernel B's bound on the population ``d0`` and the advected fields:
    four planes, nine cell fields and the row order in, one plane and six
    cell fields out; the first substep's growth work sstp_cond times, each
    live droplet's set-up and rebuilt vt, each cell's substeps."""
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp, hskpng_Tpr
    from libcloudphxx_tpu_torch.lgrngn.vterm import vt_in_kernel
    n_cell, live = d0.n.shape[0], d0.n > 0
    live0 = int(live.sum())
    col = lambda a: a[:, None].expand(-1, d0.cap).reshape(-1)
    T0, p0, _, eta0 = hskpng_Tpr(cfg, d0.sstp_tmp_th, d0.sstp_tmp_rv,
                                 d0.rhod, d0.p)
    vt = vt_in_kernel(cfg, d0.rw2, T0[:, None], p0[:, None],
                      d0.rhod[:, None], eta0[:, None])
    th1 = d0.sstp_tmp_th + (tha.reshape(-1) - d0.sstp_tmp_th) / SSTP_COND
    rv1 = d0.sstp_tmp_rv + (rva.reshape(-1) - d0.sstp_tmp_rv) / SSTP_COND
    T1, p1, RH1, eta1 = hskpng_Tpr(cfg, th1, rv1, d0.rhod, d0.p)
    lam_D, lam_K = hskpng_mfp(d0.T, d0.p)
    arrays = (d0.rw2.reshape(-1), d0.rd3.reshape(-1), d0.kpa.reshape(-1),
              vt.reshape(-1), col(d0.rhod), col(rv1), col(T1), col(p1),
              col(RH1), col(eta1), col(lam_D), col(lam_K))
    ops_b, brk, n_live = rootfind_ops(1.0 / SSTP_COND, arrays, 44.0,
                                      live.reshape(-1))
    print(f"B cond: {brk / n_live:.4f} of the {n_live} live droplets "
          f"bracketed in the first substep")
    vt32, vt64 = vt_ops(cfg, d0.rw2[live])
    return bound(
        5 * nbytes(d0.n) + 16 * nbytes(d0.rhod),
        SSTP_COND * ops_b + live0 * OPS_DROP + vt32 + d0.n.numel()
        + n_cell * (SSTP_COND * OPS_CELL_SUBSTEP + 2 * OPS_CLOSURE), vt64)


def transport_bound(cfg, d0, kc):
    """Kernel C's bound on the population ``d0`` and its outputs ``kc``: n
    of every slot, rw2, x and z of the live ones, rd3 of those that fell
    into the puddle, and seven cell fields (p, rhod, eta, the four
    courants; T too under beard76) in; n, x, z, vt, the targets and the
    (n_cell, 8) row info out; each live droplet's vt and transport."""
    from libcloudphxx_tpu_torch.lgrngn import vt_t
    live = d0.n > 0
    live0, slot = int(live.sum()), d0.n.element_size()
    fell = int((live & (kc[0] == 0) & (kc[2] < cfg.z0)).sum())
    cells = 8 if vt_t(cfg.terminal_velocity) == vt_t.beard76 else 7
    vt32, vt64 = vt_ops(cfg, d0.rw2[live])
    return bound(
        nbytes(d0.n) + 3 * slot * live0 + slot * fell
        + cells * nbytes(d0.rhod) + 4 * nbytes(d0.n) + nbytes(kc[4], kc[5]),
        vt32 + live0 * OPS_TRANSPORT, vt64)


def coal_bounds(cfg, ds, work_e):
    """Kernel E's bounds on the population ``ds`` and the work its data
    needs (coal_work, stride and standalone form): six planes and five
    cell fields in, six (standalone: seven) planes and the row flags out;
    vt of each live SD at load and of each droplet a collision changed
    (at the population's mean cost a droplet), and for the standalone form
    of the slots dead at load."""
    live = ds.n > 0
    plane, cell, n_cell = nbytes(ds.n), nbytes(ds.rhod), ds.n.shape[0]
    vt32, vt64 = vt_ops(cfg, ds.rw2[live])
    per32, per64 = vt32 / max(int(live.sum()), 1), \
        vt64 / max(int(live.sum()), 1)
    dead = ds.n.numel() - int(live.sum())

    def ops(work, extra=0):
        vts = work["live"] + work["changed"] + extra
        return coal_ops(work) + vts * per32, vts * per64

    return {"coal": bound(12 * plane + 5 * cell + n_cell, *ops(work_e[0])),
            "coal_standalone": bound(13 * plane + 5 * cell + n_cell,
                                     *ops(work_e[1], dead))}


def vt_ops(cfg, rw2):
    """(float32, float64) operations of the vt of the live droplets
    ``rw2`` under cfg's formula (csrc/physics.cuh vt_formula)."""
    from libcloudphxx_tpu_torch.lgrngn import vt_t
    f, n = vt_t(cfg.terminal_velocity), rw2.numel()
    if f in (vt_t.beard77, vt_t.beard77fast):
        return n * OPS_VT, 0
    if f == vt_t.beard76:
        r, lo, ops = torch.sqrt(rw2), 0.0, 0
        for hi, k in OPS_VT_BEARD76:
            ops += k * int(((r > lo) & (r <= hi)).sum())
            lo = hi
        return ops, 0
    if f == vt_t.undefined:
        return 0, 0
    return 2 * n, OPS_VT_KHV[f.name] * n


def profile(label, start, run, card, steps=20):
    """Device time by kernel over ``steps`` steps (torch.profiler) beside
    their unprofiled wall time: ``start()`` puts the model at the window's
    first step, ``run(n)`` runs n steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    start()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile {label}: {steps} coalescing steps, wall {wall:.3f} "
          f"ms/step unprofiled, device busy {busy:.3f} ms/step, busy share "
          f"{busy / wall:.3f}, device launches {sum(r[2] for r in rows):.1f}"
          f"/step ({card})")
    # the largest rows, and the port's own kernels wherever they rank
    for i, (name, ms, count) in enumerate(rows):
        if i < 14 or "lcp::" in name:
            print(f"  {ms:8.4f} ms/step  {count:6.1f}/step  {name[:70]}")


def profile_both(model_c, dense_init, model_f, flat_init, card, warm=5):
    """profile() of the dense engine's coalescing steps and of the flat
    engine's through the public API, each after the spin-up and ``warm``
    steps; both models are put back at their initial state."""
    model_c.dense_state, model_c.th, model_c.rv = dense_init
    model_c.run_device_lgrngn(SLICE_SPINUP + warm, spinup=SLICE_SPINUP,
                              engine="dense")
    d_warm = (model_c.dense_state, model_c.th, model_c.rv)

    def dense_start():
        model_c.dense_state, model_c.th, model_c.rv = d_warm

    profile("dense", dense_start,
            lambda n: model_c.run_device_lgrngn(n, engine="dense"), card)
    model_c.dense_state, model_c.th, model_c.rv = dense_init
    profile_flat(model_f, flat_init, card, warm)


def profile_front(model_d, front_init, card, warm=5):
    """profile() of the dense front's coalescing steps through the public
    API (Kinematic2D.run), after the spin-up and ``warm`` steps; the model
    is put back at its initial state."""
    model_d.dense_state, model_d.th, model_d.rv = front_init
    model_d.run(SLICE_SPINUP + warm, spinup=SLICE_SPINUP)
    d_warm = (model_d.dense_state, model_d.th, model_d.rv)

    def front_start():
        model_d.dense_state, model_d.th, model_d.rv = d_warm

    profile("dense front, public API", front_start, model_d.run, card)
    model_d.dense_state, model_d.th, model_d.rv = front_init


def profile_dense(model, init, card, label, warm=5):
    """profile() of a dense model's coalescing steps through
    run_device_lgrngn(engine="dense"), after the spin-up and ``warm``
    steps; the model is put back at its initial state."""
    model.dense_state, model.th, model.rv = init
    model.run_device_lgrngn(SLICE_SPINUP + warm, spinup=SLICE_SPINUP,
                            engine="dense")
    d_warm = (model.dense_state, model.th, model.rv)

    def start():
        model.dense_state, model.th, model.rv = d_warm

    profile(label, start, lambda n: model.run_device_lgrngn(n, engine="dense"),
            card)
    model.dense_state, model.th, model.rv = init


def profile_flat(model_f, flat_init, card, warm=5, label="flat, public API"):
    """profile() of the flat engine's coalescing steps through the public
    API (Kinematic2D.run), after the spin-up and ``warm`` steps; the model
    is put back at its initial state."""
    prt = model_f.prtcls
    prt.state, model_f.th, model_f.rv = flat_init
    model_f.run(SLICE_SPINUP + warm, spinup=SLICE_SPINUP)
    f_warm = (prt.state, model_f.th, model_f.rv)

    def flat_start():
        prt.state, model_f.th, model_f.rv = f_warm

    profile(label, flat_start, model_f.run, card)
    prt.state, model_f.th, model_f.rv = flat_init


if __name__ == "__main__":
    sys.exit(main())
