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
     conserving the population per cell, and kernel E's 2-D rows above
     capacity 128 (its warp rows over csrc/coal_y.cuh) at 256 and 512:
     bitwise their plain version, the rows on the one-warp pass, a call's
     time, its device time in the step, its bound and resources
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
     unwrapped form per launch beside its bound; then the mesh under the
     onishi kernel, pred_corr advection and a const-multi population's
     coalescence (and onishi_hall_davis_no_waals at a depth of its own,
     from radii x10):
     from the serial spin-up, 10 coalescing steps on 8 shards and on 1
     lane for lane bitwise the serial engine's (every plane, th, rv, the
     sstp_coal growth), with C's pred_corr form on a slab (the halo-2
     courants) and E's onishi form keyed by the shards' global rows
     launched once a shard a step and each bitwise equal to its plain
     version on the shards' rows; their ms/step beside the serial
     engine's, and both forms' rows beside their bounds
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
 16. the bulk schemes blk_1m and blk_2m in the kinematic model, the
     reference's fig_a bulk case (76x76 cells on the node grid, FCT on):
     kernel A's advect_n on each scheme's 4 and 6 fields, FCT off and on,
     n_iters 1-3, bitwise equal to its plain version and to one advect a
     field; ante_loop (blk_1m) and run_device over 1000 steps (400 of
     them spin-up; the reference runs 9000 and 7200) through the kernels
     in float32, kernel A
     once a step, with the physics checks (finite fields, mixing ratios
     and concentrations >= -1e-10, the total water with the surface
     puddle conserved to 1e-4, rain formed); the kernel path against the
     plain path over 200 steps across a spin-up boundary, run() against
     run_device() (both bitwise); the float64 plain run against the
     float32 kernel run at the end, within the fig_a tolerances (blk_2m's
     rc within 1e-5: BLK_GATES); best of 3 reps of 250 steps from the run's
     end (ms/step, cell-updates/s), kernel A's device time in the step
     beside its bound, and with --profile the launches a step and the
     busy share
 17. the dense engine's other populations and options at full width: (a)
     a const-multi population (sd_const_multi 5.6e8, sd_conc 0), (b)
     sd_conc 64 with the large tail, the vohl_davis_no_waals kernel and
     pred_corr SD advection, (c) bench.py's configuration from the
     reference's mt19937 init (timed); for each: the factory on the card
     gives the dense front; spin-up and coalescing steps through
     run_device_lgrngn(engine="dense") with bench.py's physics checks,
     kernels A, B, D, E (its wide-table form under vohl; above capacity
     128 its warp rows, as (b)'s rows of capacity 256, with the share on
     the one-warp pass; (b) repacked to capacity 128 runs the one-warp
     wide-table form too) and C (its pred_corr form under pred_corr)
     launched, collisions, and in (a)
     whether the sstp_coal growth fired; the dense front bitwise equal to
     it; the kernel path bitwise equal to the plain path from init;
     kernel E's form (lane by lane and the overflow flags row by row) and
     C's form (every slot; on the cloud and on a rain population) bitwise
     equal to their plain versions on what a main step gives them, timed
     beside their bounds (E's counting the table and its lookups, C's the
     staggered courants and the corrector); best-of-3 timing of 50 steps
     from init, and the new forms' device time in the step
 18. the LES slice (an LES host's coupling) through the public API at
     76x76 and sd_conc 64, each step step_sync(opts, th, rv, rhod, Cx, Cz,
     diss_rate=1e-3 everywhere) then step_async(opts) after kernel A's
     MPDATA of th and rv: (a) turb_adve, turb_cond and turb_coal with the
     onishi_hall kernel, diag_incloud_time, sedimentation and recycling
     (kernel F's turb_cond form); (b) the same with exact substepping and
     in-cell mixing (G's fixed-count turb_cond form); (c) with adaptive
     substepping, sstp_cond_act 8 (G's adaptive turb_cond form); (d) (a)
     with the simple aerosol source and the CCN relaxation and without
     recycling (which would fill the slots the sources need); (e)
     turb_adve alone with the hall kernel on the factory's dense front
     (kernel B condenses, the flat engine runs each async phase).  Each:
     the counted run (its form once a step), then best-of-2 timing from
     init (10 steps, 25 for (e)), with on every rep finite fields, water
     conserved with the puddle and what the sources added, |up| of the
     order of sqrt(2/3 TKE), ssp finite and not all zero, the in-cloud
     time >= 0 and 0 far below activation, no SD dropped; each new form
     against its plain version on what a step gives it (F within its cell
     sums' gates with ssp bitwise, G-fixed within B's gates, G-adaptive
     bitwise), timed beside its bound
 19. the parcel (0-D), 1-D and 3-D grids on the flat engine through the
     public API (factory(engine="flat"); on the card the factory's pick
     for the 3-D grid is the dense front, phase 22): (a) the
     GMD case extruded in y, 76x76x76 cells of 20 m, 28,094,464 SDs
     (sd_conc 64), the Setup's profiles on every column, phase 18's
     courants on every y slab and a courant_y of 0.1, sstp_cond =
     sstp_coal = 10, the geometric kernel, sedimentation, each step
     step_sync(opts, th, rv, rhod, Cx, Cy, Cz) and step_async(opts):
     diag_vel_div on every y slab the 2-D field's, 5 counted steps (F
     once a step, no other kernel), F against its plain version on what a
     step gives it (F's gates), the best of 2 reps of 5 steps from init,
     on every rep finite fields, water and dry mass conserved with the
     puddle (1e-3, 1e-4), the live count balanced against coalescence and
     the walls and SDs across the y walls; F timed at this shape beside
     its plain version and bound; (b) a rising adiabatic parcel (4096
     SDs, sstp_cond 10, a dry-adiabatic hydrostatic ascent at 1 m/s for
     300 steps, rhod passed every step) per cell, exactly with mixing and
     adaptively (sstp_cond_act 8), and with turb_cond (120 steps): its
     parcel form of F or G once a step, water a kg conserved to 1e-5, RH
     peaking above 1 and relaxing, the form against its plain version (F
     and G-fixed within B's gates, G-adaptive bitwise; F's and G-fixed's
     cluster forms bitwise from launch to launch) and timed beside its
     bound; a parcel of 65,536 SDs, 2 steps per cell and exactly with
     mixing, each form the same way; F's and G-fixed's cluster forms
     (and their turb_cond forms) timed at 1 SD, their latency floor; the
     reference's lgrngn_cond parcel in float32 through F's
     parcel form with its th and rv gates and the evaporation leg's rv
     return within its float32 bound; (c) 1-D, 76 cells, a courant_x of
     0.2, 20 steps through F with the conservation checks and SDs wrapping

 20. ice through the public API on the flat engine (the factory's pick on
     the card): (a) 76x76 cells of the GMD geometry, sd_conc 64 (369,664
     SDs) of the GMD aerosol with an insoluble core of 1e-7 m, sstp_cond
     = sstp_coal = 10, the geometric kernel, sedimentation, rows from 250
     K at the bottom to 232 K at the top, p hydrostatic from 800 hPa, rv
     saturated over water, phase 18's flow (kernel A's MPDATA of th and
     rv), singular freezing, each step step_sync(opts, th, rv, rhod, Cx,
     Cz) with ice_nucl and step_async(opts): 50 counted steps (kernel A
     twice and F's ice form once a step, no other kernel), finite fields,
     SDs frozen with rw2 0 and ice_a ice_c > 0, the total water (vapour,
     liquid, ice, the puddle's liquid and ice) within 1e-5, the ice form
     against its plain version on what a step gives it (F's gates, the
     axes rel 1e-5), every cell warmed by 50 K for one step (all the ice
     melts, rho_i V_i = rho_w V_w per SD to 1e-5), the best of 3 reps
     from init (timed without the checks' coalescence watch, each rep
     checked after it); (b) (a) with time-dependent freezing (the Philox
     uniforms), its checks; (d) (a) with turb_cond (diss_rate 1e-3), 20
     steps through F's ice turb_cond form, its checks; (c) the parcel of
     tests/test_lgrngn_ice.py (243 K, 800 hPa, 100 SDs, dt 0.1, RH_max
     0.95, 500 steps), singular and time-dependent, and 120 steps with
     turb_cond, with the reference's gates (no NaN, rv >= 0, the ice
     mixing ratio >= 0) through F's parcel ice forms once a step (nothing
     freezes there at 243 K), and the aspect-ratio run (hand-frozen
     prolate spheroids at RH_i > 1 for 20 steps: both axes grow, c/a
     relaxes toward 1, rv falls, th rises) and its turb_cond copy (every
     other SD left liquid).  F's four ice forms each against its plain
     version, timed beside its bound (operations, with the deposition's
     rdrdt_i evaluations): the grid forms on what (a) and (d) give them,
     the parcel forms on the aspect-ratio runs' frozen, growing SDs
 21. aqueous chemistry: Kinematic2D(micro="lgrngn_chem") at 76x76 and
     sd_conc 64 (FCT on) through run(): 10 spin-up and 20 chemistry
     steps, kernel A for th, rv and the six trace gases (8 a step) and F
     once a step; th, rv, the gases and the dissolved masses finite and
     >= 0, the sulfur (SO2 gas, dissolved S(IV) and S(VI), the puddle's)
     conserved in moles within 1e-6, S(VI) made; the kernel path against
     the plain path after 3 steps within F's gates, the gases within 2e-4
     beside a second kernel-path run's (the witness of their own spread);
     the best of 3 reps of the 20 chemistry steps from the spin-up
 22. the dense engine on the 3-D grid and with the onishi kernels: (a)
     phase 19 (a)'s configuration (76x76x76 cells, 28,094,464 SDs at row
     capacity 128) on the factory's pick on the card, the dense front:
     10 counted steps (B, E's y form, C's and D's 3-D forms once a step,
     no other kernel), C's, D's and E's 3-D forms against their plain
     versions on what a full-width step gives them (bitwise, D and E also
     from one launch to the next; E also with radii x10, C also on 1 mm
     rain), C's, D's and E's registers, shared memory and blocks an SM at
     their launch plans (C's bricks and persistent blocks, D's bricks, E's
     warps a row; also in (b) and (c)), C's time a call and in the step
     against its bound, the best of 3 reps of 10 steps from
     init, on every rep finite fields, water and dry mass conserved with
     the puddle, the live count balanced against coalescence and the
     walls, no SD dropped and SDs wrapped in y, the device time of each
     kernel in the step (and B at this shape timed with its plain version
     beside its bound, the main path's B row's "dense3d"); the front
     against the flat engine after one step
     from the same init without coalescence (th, rv, and the per-cell wet
     moments 0 and 3 where both hold as many SDs a cell, DENSE3D_GATES);
     (b) pred_corr with vohl and the large tail, and
     the exact mode with mixing, 3 counted steps each through the front
     (C's 3-D pred_corr form, E's vohl y form, G and D's 3-D exact form),
     the forms against their plain versions; (c) bench.py's case with the
     onishi_hall kernel (kernel_parameters [100], dissipation rate 0):
     spin-up and coalescing steps through run_device_lgrngn(engine=
     "dense") (E's onishi form) with bench.py's checks, the dense front
     bitwise equal to it, E's onishi form against its plain version
     (cloud, radii x10 and x30) and the best of 3 reps of 20 steps
 23. the flat engine's multi-device front (parallel/multi.
     particles_multi_t): (a) bench.py's case through Kinematic2D(...,
     opts_init_kw={"dev_count": 8}).run() on 8 shards of the card, slabs
     10, 10, 10, 10, 9, 9, 9, 9 (the model's n_sd_max, twice the SDs),
     kernel A twice a step and F once a shard a step, the best of 3 reps
     of 10 coalescing steps from init, each with bench.py's physics
     checks, no SD dropped on the ring; the serial flat engine at the same
     n_sd_max timed beside it; (b) the front against the serial flat
     engine from the same init, 5 steps without coalescence: th and rv
     after every step within F's cell-sum gates and the SD count and wet
     moments 0 and 3 a cell alike, outside the cells beside an SD that
     lay within MULTI_NEAR_ULPS float32 ulps of a face after a step
     (slab-local x rounds otherwise; their count at most
     MULTI_NEAR_CELLS); (c) F on the last shard's step inputs, its
     padded column included, bitwise against its plain version; (d)
     pred_corr (the halo-2 courant exchange) and the exact mode (G's
     fixed-count form a shard) on 8 shards, 3 coalescing steps each with
     the physics checks, G bitwise against its plain version on a shard
 24. both multi-device fronts as one program in two processes
     (parallel/twoproc.py's "gmd" case: two fresh interpreters in one gloo
     group, 4 shards each, both on the one card, the ring's messages
     staged through the host): (a) the flat front at bench.py's case (the
     model's 739,328 slots over 8 shards), TWOPROC_STEPS steps of sync_in
     + step_cond + step_async with coalescence, F once a shard a step on
     each rank; (b) the dense mesh on the same population packed at row
     capacity 128, TWOPROC_STEPS steps (B, E, C's unwrapped form and D
     once a shard a step on each rank).  Every shard's tensors, th and rv
     among them, bitwise equal to the same functions run in this process
     on all 8 shards; the totals, the SDs crossed and no overflow alike;
     ms/step of each (rank 0, between barriers) beside the one-process
     run's
 25. the icicle CLI (models/cli.py, ``--micro=lgrngn``) at 76x76 and
     sd_conc 64 on the card: CLI_NT steps (CLI_SPINUP of spin-up), output
     every CLI_OUTFREQ: const, the snapshots and puddle.dat written, every
     dataset finite and (76, 76), the kernels it launched counted (A
     twice a step, B, C and D once, E once a coalescing step), its
     ms/step beside Kinematic2D.run()'s at the same settings
 26. run_device_lgrngn's two switches of the JAX package on bench.py's
     case, TIME_STEPS steps from init with SWITCH_SPINUP of spin-up: the
     default, defer_x (the deferred re-binning: kernel B's merge-prologue
     form in every step but the first, D only at the run's end),
     mpdata_fuse (th and rv advected in D's MPDATA-epilogue form, kernel A
     at each phase's first step) and both, each with bench.py's physics
     checks, its launches of A, B, B's form, D and D's form counted and
     bitwise the default run (every plane, th, rv, the overflow); defer_x
     with the repack policy every SWITCH_REPACK steps bitwise its default
     twin, chunk logs alike; B's merge-prologue form against its plain
     version on a deferred step's inputs (the merged planes and drops
     bitwise, the condensation within B's gates) and D's MPDATA form on a
     fused step's (the planes bitwise D's, th and rv bitwise kernel A's
     and _advect_body's); ms/step, best of TIME_REPS, of each run, the
     device launches and kernel times a step from a profile of
     SWITCH_PROFILE_STEPS coalescing steps, each form timed alone beside
     what it replaces, its plain version and its bound

Every phase prints its seconds (``phase N: s``), and the script the
seconds of phases 3-26 beside the build's.

Run from the repository root: ``python3 chip_smoke.py``; ``--profile``
adds the device-time split of the coalescing steps on the dense engine,
the flat engine, the dense front, the exact slice and the dense exact
slice, and of the bulk schemes', the LES slice's, the grids', the ice's
and the chemistry's steps (torch.profiler).  The last line is {"ok": true, "device": {...}}; the
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
# phase 10's plain path from init: one rep, not TIME_REPS (0.3-0.4 s a step
# on an H100: three reps took about a minute of the script's time), and
# the kernels' plain versions FORM_PLAIN_REPS calls each, not KERNEL_REPS
PLAIN_TIME_REPS = 1

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
# kernel F's ice forms (csrc/cond_cell.cuh IceDep), per frozen live SD and
# substep: two deposition rates (dep_rate: the radius, Re, the two
# transition-regime factors and Nusselt numbers with their shared power,
# rdrdt_i, over 2a), the two forward-Euler updates and clamps, the volume
# change and its weight; per cell and substep: the ice terms (ice_growth:
# the mean free paths, Sc, Pr, p_vsi, RH_i, l_s) and the feedback to rv
# and th
OPS_DEP, OPS_ICE_CELL = 144, 46
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
# with FCT, each corrective iteration's limiter a cell (fct_betas: the
# extrema of the field before and after the donor pass, four donor fluxes,
# the in- and outflows, the two betas; fct_limit: two faces)
OPS_FCT = 64

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
# phase 14's options (mesh_options): the onishi kernel (phase 22 (c)'s),
# pred_corr advection with the geometric kernel and phase 17's const-multi
# population, each from the serial spin-up over MESH_STEPS coalescing
# steps on MESH_SHARDS shards and on 1 against the serial engine lane for
# lane, onishi_hall_davis_no_waals over MESH_STEPS_DNW on MESH_SHARDS
# shards from its spin-up with radii x10 (so that droplets collide in its
# few steps); the ms/step of each, best of TIME_REPS reps of
# MESH_TIME_STEPS; the new forms' device time over MESH_PROFILE_STEPS
# mesh steps (the profiler takes ~3 s a mesh step: ~4,500 host ops)
MESH_OPTIONS = ("onishi_hall", "pred_corr", "const_multi")
MESH_STEPS_DNW = 3
MESH_TIME_STEPS = 10
MESH_PROFILE_STEPS = 1

# phase 16: the bulk schemes' fig_a case (tools/golden_parity_blk.py:1-10,
# the reference's travis_2D_kin_cloud_diff_blk_{1m,2m} runs): its steps and
# spin-up, cut from the reference's 9000 and 7200 (at those the phase took
# 560 s on an H100, most of it the float64 plain runs' ~2,000 launches a
# step; at 3000 and 1200 239 s, and cut again to keep the whole script
# inside its time limit as phases are added: 2000 and 800, then 1000 and
# 400 since the 3-D dense phase 22), the steps of the kernel path
# against the plain path (the spin-up moved to half of them; 200, from 400,
# and a timing rep's 250, from 500, since phase 22), of run() against
# run_device() and of a timing rep
BLK_SCHEMES = ("blk_1m", "blk_2m")
BLK_NT, BLK_SPINUP = 1000, 400
BLK_PLAIN_STEPS, BLK_PLAIN_SPINUP = 200, 100
BLK_RUN_STEPS = 20
BLK_TIME_STEPS = 250
# the fig_a h5diff tolerances at t = 9000 (tools/golden_parity_blk.py:
# 64-77), here float32 against float64 at the run's end: (field, "abs" or
# "rel", bound).  blk_2m's rc bound is 1e-5, not fig_a's 4.5e-6 (a gate
# between two float32 runs of the reference): float32 fields put blk_2m's
# rc 5.8e-6 (t = 9000) to 7.0e-6 (t = 3000) from the float64 run's on an
# H100, and scripts/blk_precision.py finds it as far with the
# microphysics in float64 on float32 fields: the fields' float32 storage
# and advection, which kernel A takes, set it
BLK_GATES = {
    "blk_1m": (("rv", "abs", 2e-5), ("rc", "abs", 2e-5), ("rr", "abs", 2e-5),
               ("th", "abs", 0.1)),
    "blk_2m": (("rv", "rel", 0.02), ("rr", "abs", 12e-6),
               ("rc", "abs", 1e-5), ("th", "abs", 0.4)),
}
# the typical magnitudes of the bulk fields past th and rv (rc, rr or rc,
# nc, rr, nr), for kernel A's inputs in phase 16
BLK_SCALES = {"blk_1m": (1e-3, 1e-4), "blk_2m": (1e-3, 1e8, 1e-4, 1e5)}

# the terminal velocity formulas off the main path (formulas()): the
# steps of their kernel path against their plain path (2 spin-up), and of
# the flat engine through the public API
FORMULAS = ("beard76", "khvorostyanov_spherical",
            "khvorostyanov_nonspherical")
FORMULA_PLAIN_STEPS, FORMULA_PLAIN_SPINUP, FORMULA_FLAT_STEPS = 5, 2, 5

# phase 17: the dense engine's other populations and options at full
# width.  (a) a const-multi population: the 8x8 CPU tests' 1e11 scaled to
# the 76x76 cells' volume, about bench.py's 64 SDs a cell on average; (b)
# sd_conc 64 with the large tail, the vohl kernel and pred_corr advection;
# (c) bench.py's configuration with the reference's mt19937 init.  Each
# case's kernel path against its plain path, and the dense front against
# run_device_lgrngn(engine="dense"), over OPTION_SPINUP spin-up and
# OPTION_MAIN coalescing steps from init
CONST_MULTI = 5.6e8
OPTION_SPINUP, OPTION_MAIN = 10, 10
# kernel E's wide-table lookup a pair (physics.cuh efficiency: two
# eff_node, the bilinear combination of the four corners); kernel C's
# pred_corr form a live SD beside OPS_TRANSPORT (the z clamp, the x wrap
# and the old position's shift, the corrector's two displacements, the two
# means), and its float64 operations (the corrector cell's two divisions
# and floors)
OPS_EFF, OPS_PRED_CORR, OPS_PRED_CORR_F64 = 41, 25, 4
# phase 18: the LES slice at 76x76 and sd_conc 64 through the public API:
# the dissipation rate every cell gets (tests/test_lgrngn_transport.py:181)
# and the onishi kernel's Re_lambda (coalescence_onishi_hall.py); each
# configuration's steps from init (best of LES_REPS reps after the
# counted run; (e) LES_STEPS_E; 20, 50 and 3 reps before the 3-D dense
# phase 22 needed the time); (d)'s source: SRC_SD_CONC SDs a cell of
# the lowest SRC_LEVELS levels every SRC_SUPSTP steps, from the GMD
# distribution scaled by SRC_SCALE a second; its n_sd_max holds the
# sources' and the relaxation's SDs: at most 2 calls of 76 x 10 x 4 and 10
# of 64 bins x 76 levels, 54,720, beside the 369,664 of init
LES_DISS, LES_RE_LAMBDA = 1e-3, 100.0
LES_STEPS, LES_STEPS_E, LES_REPS = 10, 25, 2
SRC_SD_CONC, SRC_LEVELS, SRC_SUPSTP, SRC_SCALE = 4, 10, 10, 0.01
LES_SD_HEADROOM = 65_536

# phase 19: (a) the GMD case extruded in y, GRID_N cubed cells of GRID_D
# metres, a uniform courant_y of GRID_CY, GRID_STEPS counted steps then
# the best of GRID_REPS reps of GRID_STEPS from init, F timed over
# GRID_KERNEL_REPS calls; (b) the rising parcel: PARCEL_SD SDs,
# PARCEL_STEPS steps of a dry-adiabatic ascent at PARCEL_W m/s from
# PARCEL_P0 Pa at dry potential temperature PARCEL_TH and vapour PARCEL_RV
# (RH ~0.95 at the start), PARCEL_TURB_STEPS with the SGS supersaturation,
# PARCEL_LARGE_STEPS of a parcel of PARCEL_SD_LARGE SDs in F's and
# G-fixed's modes (their cluster forms at 8 slots a thread), a launch of
# those forms at 1 SD (their latency floor), and the lgrngn_cond parcel's
# rv-return gate (lgrngn_cond_case); (c) 1-D:
# GRID_N cells, a courant_x of GRID1D_CX, GRID1D_STEPS steps
GRID_N, GRID_D, GRID_CY = 76, 20.0, 0.1
GRID_STEPS, GRID_REPS, GRID_KERNEL_REPS = 5, 2, 5
PARCEL_SD, PARCEL_STEPS, PARCEL_TURB_STEPS = 4096, 300, 120
PARCEL_SD_LARGE, PARCEL_LARGE_STEPS = 65_536, 2
PARCEL_W, PARCEL_P0, PARCEL_TH, PARCEL_RV = 1.0, 100000.0, 289.0, 1.1e-2
PARCEL_RV_RETURN = 7.5e-7
GRID1D_CX, GRID1D_STEPS = 0.2, 20

# phase 20: ice at NX x NZ: rows from ICE_T_BOTTOM K at the bottom to
# ICE_T_TOP at the top, p hydrostatic from ICE_P0 Pa, the aerosol's
# insoluble core ICE_RD_INSOL m; ICE_STEPS counted steps ((d), with
# turb_cond, ICE_TURB_STEPS), the total water to ICE_WATER_GATE (the
# float32 runs read 2.5e-8 to 5.3e-7; 1e-5 of (a)'s 930 kg of water is
# 0.02% of its 51 kg of ice, so a deposition or melt that loses or
# counts twice that much of the ice fails it), the melt at ICE_WARM K
# more; (c) the parcel's ICE_PARCEL_STEPS (the reference's 500),
# ICE_PARCEL_TURB_STEPS with turb_cond, ICE_ASPECT_STEPS of the
# aspect-ratio runs.  Phase 21: the lgrngn_chem model's CHEM_SPINUP
# spin-up and CHEM_STEPS chemistry steps, the sulfur to CHEM_SULFUR_GATE
# (float32 reads 1.0e-7: 10x that, so that a lost 1e-6 of the sulfur, in
# the gas, the drops or the puddle, fails it), CHEM_CHECK_STEPS of the
# kernel path against the plain path, their gases to CHEM_GAS_GATE (two
# runs of the kernel path part by 4.2e-5, the chemistry's index_add_
# cell sums adding in no fixed order on the card; the two paths by
# 5.3e-5: about 4x that)
ICE_T_BOTTOM, ICE_T_TOP, ICE_P0, ICE_RD_INSOL = 250.0, 232.0, 80000.0, 1e-7
ICE_STEPS, ICE_TURB_STEPS, ICE_WATER_GATE, ICE_WARM = 50, 20, 1e-5, 50.0
ICE_PARCEL_STEPS, ICE_PARCEL_TURB_STEPS, ICE_ASPECT_STEPS = 500, 120, 20
CHEM_SPINUP, CHEM_STEPS, CHEM_SULFUR_GATE, CHEM_CHECK_STEPS = \
    10, 20, 1e-6, 3
CHEM_GAS_GATE = 2e-4

# phase 22: the dense front on phase 19 (a)'s 3-D configuration: (a)
# DENSE3D_STEPS counted steps, then the best of DENSE3D_REPS reps of
# DENSE3D_STEPS from init, and the front against the flat engine after one
# step from the same init without coalescence within DENSE3D_GATES, about
# 4x what the H100 reads (th and rv: B's and F's float64 cell sums, read
# 1.05e-7 and 3.15e-7; m0 and m3 on the cells where both engines hold as
# many SDs, read 9.1e-7 and 4.7e-5: the order of the cell sums and B's and
# F's rw2), with at most DENSE3D_MOVED_CELLS cells whose SD count differs
# (read 57: a droplet within an ulp of a face lands on either side, where
# m0 parts by up to 7.4e-2); (b)
# pred_corr with vohl, and the exact mode,
# DENSE3D_FORM_STEPS counted steps each; (c) bench.py's case with
# onishi_hall, SLICE_SPINUP + SLICE_MAIN counted steps, the best of
# TIME_REPS reps of ONISHI_TIME_STEPS
DENSE3D_STEPS, DENSE3D_REPS, DENSE3D_FORM_STEPS = 10, 3, 3
DENSE3D_GATES = {"th": 1e-6, "rv": 2e-6, "m0": 4e-6, "m3": 2e-4}
DENSE3D_MOVED_CELLS = 220               # 5e-4 of the 438,976 cells
ONISHI_TIME_STEPS = 20
# phase 23: the multi-device front over MULTI_SHARDS slabs (MESH_WIDTHS);
# (a) the best of TIME_REPS reps of MULTI_STEPS coalescing steps, (b) the
# gate of MULTI_GATE_STEPS steps without coalescence against the serial
# flat engine, outside the cells beside an SD that lay within
# MULTI_NEAR_ULPS float32 ulps of the domain's size of a cell face after
# any step (slab-local x rounds otherwise than global x, and the next
# step may condense such an SD in either cell), of which there may be
# MULTI_NEAR_CELLS (1.5x the 635 read on an H100): th and rv after every
# step within F's cell-sum gates (read: bitwise), the SD count a cell
# equal, the wet moments 0 and 3 within MULTI_MOM_GATE (4x the readings,
# 6.2e-7 and 6.1e-7: their cell sums are atomic adds, in no fixed order);
# (d) MULTI_FORM_STEPS steps each
MULTI_SHARDS, MULTI_STEPS, MULTI_GATE_STEPS, MULTI_FORM_STEPS = 8, 10, 5, 3
MULTI_NEAR_ULPS, MULTI_NEAR_CELLS = 4, 950
MULTI_MOM_GATE = {0: 2.5e-6, 3: 2.5e-6}
# phase 24: the case of parallel/twoproc.py (bench.py's), the steps of
# each front in two processes and in one, the ranks' time limit, the
# kernels the mesh launches once a shard a step; phase 25: the CLI's
# steps, spin-up steps and output interval
TWOPROC_CASE, TWOPROC_STEPS, TWOPROC_TIMEOUT = "gmd", 5, 300.0
TWOPROC_DENSE = ("cond", "coal", "transport_unwrapped", "merge")
CLI_NT, CLI_SPINUP, CLI_OUTFREQ = 30, 10, 10
# phase 26: run_device_lgrngn's two switches on bench.py's case, TIME_STEPS
# steps from init (SWITCH_SPINUP of spin-up), the repack policy's chunks
# of SWITCH_REPACK steps, and the profiled window's coalescing steps
SWITCHES = {"default": {}, "defer_x": {"defer_x": True},
            "mpdata_fuse": {"mpdata_fuse": True},
            "both": {"defer_x": True, "mpdata_fuse": True}}
SWITCH_SPINUP, SWITCH_REPACK, SWITCH_PROFILE_STEPS = 10, 10, 10
# kernel C's 3-D forms a live SD beside OPS_TRANSPORT: y's advection, wall
# and classification; kernel E's onishi form a pair beside the table
# lookup: Wang's enhancement (onishi.cuh wang_enhancement) and the square
# root of the geometric kernel's square
OPS_TRANSPORT_Y, OPS_WANG = 20, 25

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


def time_cuda(fn, reps, warm=True):
    """Mean device time of fn() in ms over ``reps`` calls after a warm-up
    (``warm``; a call of seconds needs none)."""
    if warm:
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


def time_reps(m, init, steps, plain, totals, dense, reps=TIME_REPS):
    """Best of ``reps`` from-init reps of ``steps`` dense steps of model
    ``m`` (after a 2-step warm-up), bench.py's physics checks against
    ``totals`` (water, dry) on every rep: (seconds, (th, rv, state) of the
    last rep); the model is put back at ``init``."""
    m.run_device_lgrngn(2, plain=plain, engine="dense")  # warm-up
    best = float("inf")
    for _ in range(reps):
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
    vap = float((prtcls._cells("rhod").double()
                 * prtcls._cells("dv").double()
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
    RH_sd = g(RH)
    if kw.get("ssp") is not None:    # turb_cond: RH plus the first ssp
        RH_sd = RH_sd + (kw["ssp"] + kw["dt_sub"] * kw["dot_ssp"])
    return (kw["rw2"], kw["rd3"], kw["kpa"], kw["vt"], g(rhod), g(rv), g(T),
            g(p), RH_sd, g(eta), g(kw["lambda_D"]), g(kw["lambda_K"]))


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
    path, build_s, log = _ext.build(verbose=True)
    print(f"build: {build_s:.1f} s -> {path.name}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _ext.load()
    t_start = time.perf_counter()
    clock = [t_start]

    def phase_done(label):
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        print(f"phase {label}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

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

    phase_done(3)

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

    phase_done(4)

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

    phase_done(5)

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

    phase_done(6)

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

    phase_done(7)

    # ---- 8. the exact per-particle slice through the public API
    exact = exact_slice(Kinematic2D, _ext, c, err)

    phase_done(8)

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
    check(front == dict({k.name: 0 for k in _ext.KERNELS}, mpdata=2 * steps,
                        cond=steps, transport=steps, merge=steps,
                        coal=SLICE_MAIN),
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

    phase_done(9)

    # ---- 10. timing: from-init reps through the kernels and the plain path
    def run_reps(m, init, steps, plain):
        return time_reps(m, init, steps, plain, (water0, dry0), dense,
                         PLAIN_TIME_REPS if plain else TIME_REPS)

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
        for how, t, reps in (("kernels", t_k, TIME_REPS),
                             ("plain", t_p, PLAIN_TIME_REPS)):
            print(f"timing {label}, {how}: {t / steps * 1e3:.3f} ms/step, "
                  f"{n_sd * steps / t:.4g} SD-updates/s ({steps} steps, "
                  f"best of {reps}; {card})")
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
                 _ext.COND_SD_FIXED, _ext.COND_SD_ADAPTIVE,   # 8's, 15's
                 _ext.COAL_VOHL, _ext.TRANSPORT_PRED_CORR,    # 17's
                 _ext.COND_FLAT_TURB, _ext.COND_SD_FIXED_TURB,
                 _ext.COND_SD_ADAPTIVE_TURB,                  # 18's
                 _ext.COND_FLAT_PARCEL, _ext.COND_FLAT_PARCEL_TURB,
                 _ext.COND_SD_FIXED_PARCEL, _ext.COND_SD_FIXED_PARCEL_TURB,
                 _ext.COND_SD_ADAPTIVE_PARCEL,
                 _ext.COND_SD_ADAPTIVE_PARCEL_TURB,           # 19's
                 _ext.COND_FLAT_ICE, _ext.COND_FLAT_ICE_TURB,
                 _ext.COND_FLAT_PARCEL_ICE,
                 _ext.COND_FLAT_PARCEL_ICE_TURB,              # 20's
                 _ext.TRANSPORT_3D, _ext.TRANSPORT_3D_PRED_CORR,
                 _ext.MERGE_3D, _ext.MERGE_3D_EXACT, _ext.COAL_3D,
                 _ext.COAL_VOHL_3D, _ext.COAL_ONISHI,         # 22's
                 _ext.TRANSPORT_PRED_CORR_UNWRAPPED,          # 14's
                 _ext.COND_MERGED, _ext.MERGE_MPDATA,         # 26's
                 _ext.COAL_WARP_ROWS,                         # 12's
                 _ext.COAL_VOHL_WARP_ROWS):                   # 17's
            continue
        ms = time_cuda(lambda: calls[k.name](False), KERNEL_REPS)
        plain_ms = time_cuda(lambda: calls[k.name](True), FORM_PLAIN_REPS)
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

    phase_done(10)

    # ---- 11. the sustained run: SUSTAINED_r05.json's shape on the card
    sustained(Kinematic2D, dense, _ext, card, dense_ms["coalescence on"])

    phase_done(11)

    # ---- 12. the repack policy forced to retarget at full width
    rows.append(forced_retargets(Kinematic2D, dense, _ext, card))

    phase_done(12)

    # ---- 13. the terminal velocity formulas off the main path
    vt_rows = formulas(Kinematic2D, dense, _ext, c, card, err)
    print("timing, dense, coalescence on, by formula: " + ", ".join(
        f"{k} {v['ms']:.3f} ms/step" for k, v in vt_rows.items())
        + f"; the flat public API (beard77fast) {flat_ms:.3f} ({card})",
        flush=True)

    phase_done(13)

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
    t14 = time.perf_counter()
    opt_rows, opt_err = mesh_options(Kinematic2D, dense, _ext, step, card)
    for kr in rows:                 # E and C on the options' shards too
        kr["max_abs_err"] = max(kr["max_abs_err"],
                                opt_err.get(kr["name"], 0.0))
    rows += opt_rows
    print(f"phase 14, the mesh's options: {time.perf_counter() - t14:.1f} s",
          flush=True)

    phase_done(14)

    # ---- 15. exact and adaptive condensation on the dense engine
    dx_rows, dx = dense_exact(Kinematic2D, dense, _ext, step, card, exact_ms,
                              dense_ms["coalescence on"])
    rows += dx_rows

    phase_done(15)

    # ---- 16. the bulk schemes (kernel A's FCT form on 4 and 6 fields)
    blk = bulk_phase(Kinematic2D, mpdata, _ext, card, opts.profile)
    for kr in rows:
        if kr["name"] == "mpdata":
            kr["max_abs_err"] = max(kr["max_abs_err"], *(
                v["max_abs_err"] for v in blk.values()))
            kr["blk"] = {micro: {k: v[k] for k in (
                "launches", "ms", "in_step_ms", "plain_ms", "bound_ms",
                "bound_by")} for micro, v in blk.items()}
    phase_done(16)

    # ---- 17. const-multi, vohl with pred_corr, the reference init
    opt_rows, opt_err = dense_options(Kinematic2D, dense, _ext, step, coal,
                                      card)
    for kr in rows:                 # E and C on phase 17's populations too
        kr["max_abs_err"] = max(kr["max_abs_err"],
                                opt_err.get(kr["name"], 0.0))
    rows += opt_rows
    phase_done(17)

    # ---- 18. the LES slice: SGS turbulence, sources, relaxation
    les_rows, les = les_phase(Kinematic2D, _ext, c, card, opts.profile)
    rows += les_rows
    phase_done(18)

    # ---- 19. the parcel, 1-D and 3-D grids on the flat engine
    grid_rows, grid, err_3d = grid_phase(Kinematic2D, _ext, c, card,
                                         opts.profile)
    for kr in rows:                 # F on the 3-D shape too
        if kr["name"] == "cond_flat":
            kr["max_abs_err"] = max(kr["max_abs_err"], err_3d)
            kr["grid3d"] = {k: grid["3-D"][k] for k in (
                "launches", "cond_flat_ms", "cond_flat_plain_ms",
                "cond_flat_bound_ms", "cond_flat_bound_by", "ms_per_step",
                "sd_updates_per_s")}
    rows += grid_rows
    phase_done(19)

    # ---- 20. ice: freezing, melting, deposition (F's ice forms)
    ice_rows, ice = ice_phase(Kinematic2D, _ext, c, card, opts.profile)
    rows += ice_rows
    phase_done(20)

    # ---- 21. aqueous chemistry: Kinematic2D(micro="lgrngn_chem")
    chem = chem_phase(Kinematic2D, _ext, card, opts.profile)
    phase_done(21)

    # ---- 22. the dense engine on the 3-D grid and with the onishi kernels
    d3_rows, d3, _ = dense3d_phase(Kinematic2D, _ext, dense, c, card,
                                        opts.profile)
    rows += d3_rows
    for kr in rows:                 # B at 76³ (phase 22 (a))
        if kr["name"] == "cond":
            kr["dense3d"] = d3["3-D"]["b"]
    print(f"timing, 3-D: dense front {d3['3-D']['ms_per_step']:.3f} "
          f"ms/step against the flat engine's "
          f"{grid['3-D']['ms_per_step']:.3f} (phase 19 (a)) ({card})")
    phase_done(22)

    # ---- 23. the flat engine's multi-device front on 8 shards
    multi = multi_phase(Kinematic2D, _ext, c, card, opts.profile)
    for kr in rows:                 # A, F and G on the shards too
        part = multi.get(kr["name"])
        if part is not None:
            kr["max_abs_err"] = max(kr["max_abs_err"], part["max_abs_err"])
            kr["multi"] = {k: v for k, v in part.items()
                           if k != "max_abs_err"}
    phase_done(23)

    # ---- 24. both fronts in two processes (gloo) on the one card
    two = twoproc_phase(_ext, card)
    for kr in rows:
        part = two.get(kr["name"])
        if part is not None:
            kr["twoproc"] = part
    phase_done(24)

    # ---- 25. the icicle CLI (models/cli.py) at 76x76
    cli_launches = cli_phase(Kinematic2D, _ext, card)
    for kr in rows:
        if kr["name"] in cli_launches:
            kr["cli_launches"] = cli_launches[kr["name"]]
    phase_done(25)

    # ---- 26. the deferred re-binning and D's MPDATA epilogue
    rows += switches_phase(Kinematic2D, dense, _ext, step, mpdata, card)
    phase_done(26)
    print(f"chip_smoke: phases 3-26 in {time.perf_counter() - t_start:.1f} s "
          f"(the build before them {build_s:.1f} s)", flush=True)

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


def mesh_option_model(Kinematic2D, name):
    """Phase 14's model of option ``name`` (MESH_OPTIONS or
    onishi_hall_davis_no_waals): bench.py's case with coalescence."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    if name == "const_multi":
        return option_model(Kinematic2D, "const_multi")
    if name == "pred_corr":
        return make_model(Kinematic2D, coal=True,
                          adve_scheme=tl.as_t.pred_corr)
    return make_model(Kinematic2D, coal=True, kernel=tl.kernel_t[name],
                      kernel_parameters=[LES_RE_LAMBDA])


def mesh_lane_check(label, r, m, ref):
    """The mesh's state against the serial engine's ``ref`` (state, th,
    rv, sstp_coal growth), lane for lane: every plane, th, rv and the
    growth bitwise (and mesh_population_check's per-cell gates)."""
    from libcloudphxx_tpu_torch.lgrngn import dense
    d_m, d_s = r.state(), ref[0]
    mesh_population_check(label, d_m, m.th, m.rv, d_s, ref[1], ref[2])
    same = {a: bool(torch.equal(getattr(d_m, a), getattr(d_s, a)))
            for a in dense.attrs_of(m.cfg)}
    same.update(th=bool(torch.equal(m.th, ref[1])),
                rv=bool(torch.equal(m.rv, ref[2])),
                growth=m.prtcls._sstp_coal_extra == ref[3])
    print(f"mesh {label}: lane for lane bitwise {same}; sstp_coal growth "
          f"{m.prtcls._sstp_coal_extra} (serial {ref[3]})", flush=True)
    check(all(same.values()), f"mesh {label}: not the serial engine's "
          f"lane for lane: {same}")


def mesh_option_forms(label, step, coal, calls, pc):
    """C's and E's calls of a mesh step (capture_all's "transport" and
    "coal") against their plain versions, bitwise (C: n, x, z, vt, the
    targets and the far flags).  Returns {kernel name: max abs error}."""
    from libcloudphxx_tpu_torch import _ext
    c_kernel = _ext.TRANSPORT_PRED_CORR_UNWRAPPED if pc \
        else _ext.TRANSPORT_UNWRAPPED
    # E's route at the shards' capacity (above 128 its warp rows)
    e_kernel = coal.resident_kernel(calls["coal"][0]["cfg"],
                                    calls["coal"][0]["n"].shape[1])
    err = {c_kernel.name: 0.0, e_kernel.name: 0.0}
    same = {"C": True, "E": True}
    for kw in calls["transport"]:
        kc = _counted(c_kernel, lambda: step.transport(**kw))
        pl = step.transport(**kw, plain=True)
        same["C"] &= all(torch.equal(a, b) for a, b in zip(kc[:5], pl[:5])) \
            and bool(torch.equal(kc[5][:, 4], pl[5][:, 4]))
        err[c_kernel.name] = max(err[c_kernel.name], *(
            max_abs(a, b) for a, b in zip(kc[:4], pl[:4])))
    for kw in calls["coal"]:
        ke = _counted(e_kernel, lambda: coal.coal_resident(**kw))
        pl = coal.coal_resident(**kw, plain=True)
        same["E"] &= all(torch.equal(a, b) for a, b in zip(ke, pl))
        err[e_kernel.name] = max(err[e_kernel.name], *(
            max_abs(a, b) for a, b in zip(ke, pl)))
    rows0 = [int(kw["row0"]) for kw in calls["coal"]]
    print(f"mesh {label}: {c_kernel.name} x{len(calls['transport'])} and "
          f"{e_kernel.name} x{len(calls['coal'])} (first rows {rows0}) "
          f"against their plain versions, bitwise {same}", flush=True)
    check(all(same.values()), f"mesh {label}: a kernel differs from its "
          f"plain version on a shard: {same}")
    return err


def mesh_options(Kinematic2D, dense, _ext, step, card):
    """Phase 14's options: the mesh under MESH_OPTIONS (and
    onishi_hall_davis_no_waals), each from its serial spin-up, against
    the serial dense engine lane for lane on MESH_SHARDS shards and on 1;
    C's pred_corr form on a slab and E's onishi form keyed by the shards'
    global rows against their plain versions on the shards' rows (also
    with radii x10, where droplets collide), their launches counted in the
    MESH_SHARDS-shard run; the ms/step of each beside the serial engine's.
    Returns (the kernel rows of E's onishi form on the shards and C's
    pred_corr form on a slab, the max abs errors of C's and E's forms
    against their plain versions)."""
    from libcloudphxx_tpu_torch.ops import coal
    from libcloudphxx_tpu_torch.parallel import MeshRunner
    err, rows, timing = {}, [], {}
    for name in MESH_OPTIONS + ("onishi_hall_davis_no_waals",):
        t0 = time.perf_counter()
        pc, onishi = name == "pred_corr", name.startswith("onishi")
        steps = MESH_STEPS_DNW if name.endswith("waals") else MESH_STEPS
        m = mesh_option_model(Kinematic2D, name)
        m.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP,
                            engine="dense")
        sp = (m.dense_state, m.th, m.rv)
        if name.endswith("waals"):     # radii x10: droplets collide
            sp = (dataclasses.replace(sp[0], rw2=sp[0].rw2 * 100.0),) \
                + sp[1:]
        totals = dense.water_dry_totals(sp[0], sp[2])

        def restore(s):
            m.dense_state, m.th, m.rv = s
            m.prtcls._sstp_coal_extra = 0

        restore(sp)
        m.run_device_lgrngn(steps, engine="dense")
        ref = (m.dense_state, m.th, m.rv, m.prtcls._sstp_coal_extra)
        lost = collided(sp[0], ref[0])
        c_kernel = _ext.TRANSPORT_PRED_CORR_UNWRAPPED if pc \
            else _ext.TRANSPORT_UNWRAPPED
        # E's route at the capacity (above 128 its warp rows)
        e_kernel = coal.resident_kernel(m.cfg, sp[0].cap)
        shard_counts = (MESH_SHARDS,) if name.endswith("waals") \
            else (MESH_SHARDS, 1)
        for n_shards in shard_counts:
            label = f"{name}, {n_shards} shard{'s' * (n_shards > 1)}, " \
                f"{steps} coalescing steps"
            restore(sp)
            r = MeshRunner(m, n_shards)
            reset(_ext.KERNELS)
            r.run(steps)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in _ext.KERNELS}
            want = {"mpdata": steps, "cond": n_shards * steps,
                    c_kernel.name: n_shards * steps,
                    e_kernel.name: n_shards * steps,
                    "merge": n_shards * steps, "transport": 0}
            got = {k: launches[k] for k in want}
            print(f"mesh {label}: launches {got}; crossed slab edges "
                  f"{int(r.crossed)}; collisions took {lost:.3e} of the "
                  f"multiplicity (serial)", flush=True)
            check(got == want, f"mesh {label}: launches {got}, expected "
                  f"{want}")
            check(lost > 0 and (n_shards == 1 or int(r.crossed) > 0),
                  f"mesh {label}: no collision or no SD crossed a slab edge")
            m.dense_state = r.state()
            physics_checks(m, *totals, dense)
            mesh_lane_check(label, r, m, ref)
            if n_shards == MESH_SHARDS and name in MESH_OPTIONS:
                main = launches
        if name.endswith("waals"):
            print(f"phase 14, {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            continue

        # C's and E's forms on the shards' rows against their plain
        # versions, in a coalescing step and with radii x10
        drizzle = (dataclasses.replace(sp[0], rw2=sp[0].rw2 * 100.0),) \
            + sp[1:]
        r = MeshRunner(m, MESH_SHARDS)
        for st in (sp, drizzle):
            restore(st)
            r.load(*st)
            calls = capture_all({"transport": (step, "transport"),
                                 "coal": (coal, "coal_resident")}, r.step)
            for k, e in mesh_option_forms(name, step, coal, calls,
                                          pc).items():
                err[k] = max(err.get(k, 0.0), e)
            if st is sp:
                kws = calls

        # the ms/step from the spin-up: MESH_SHARDS and 1 shards and the
        # serial engine, in turns
        ms = {}
        for n_shards in (MESH_SHARDS, 1, "serial"):
            best = float("inf")
            run = (lambda k: m.run_device_lgrngn(k, engine="dense")) \
                if n_shards == "serial" else None
            if run is None:
                r = MeshRunner(m, n_shards)
                run = r.run
            for rep in range(TIME_REPS + 1):           # the first warms up
                restore(sp)
                if n_shards != "serial":
                    r.load(*sp)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run(MESH_TIME_STEPS if rep else 2)
                torch.cuda.synchronize()
                if rep:
                    best = min(best, time.perf_counter() - t1)
            ms[n_shards] = best / MESH_TIME_STEPS * 1e3
        timing[name] = ms
        print(f"timing mesh, {name}, from the spin-up ({MESH_TIME_STEPS} "
              f"coalescing steps, best of {TIME_REPS}): {MESH_SHARDS} shards "
              f"{ms[MESH_SHARDS]:.3f} ms/step, 1 shard {ms[1]:.3f} ms/step, "
              f"the serial dense engine {ms['serial']:.3f} ms/step ({card})",
              flush=True)

        if name == "onishi_hall" or pc:
            # the new form's row on shard 1's call (its rows from 10 x 76):
            # the kernel and its plain version timed, its bound, its
            # launches in the MESH_SHARDS-shard run, its device time a step
            restore(sp)
            r = MeshRunner(m, MESH_SHARDS)
            if pc:
                kw = kws["transport"][1]
                kc = step.transport(**kw)
                bnd = transport_pred_corr_bound(kw, kc)
                call = lambda plain: step.transport(**kw, plain=plain)
                kernel, sym, plain_reps = c_kernel, "transport_kernel", 3
            else:
                kw = kws["coal"][1]
                work = coal_work(lambda: coal.coal_resident(
                    **kw, plain=True), kw["n"])
                bnd = coal_y_bound(kw, work, OPS_EFF + OPS_WANG)
                call = lambda plain: coal.coal_resident(**kw, plain=plain)
                kernel, sym, plain_reps = e_kernel, "coal_y_kernel", 1
            row = kernel_row(kernel, main[kernel.name], err, call, bnd,
                             card, plain_reps=plain_reps,
                             where=f"in the {MESH_SHARDS}-shard mesh's "
                                   f"{MESH_STEPS} steps ({name})")
            if onishi:
                row["name"] = "coal_onishi_row0"
                row["row0"] = int(kw["row0"])
            restore(sp)
            r.load(*sp)
            in_step = device_ms(r.run, MESH_PROFILE_STEPS, (sym,))
            row["in_step_ms"] = in_step.get(sym)
            row["launches_a_step"] = main[kernel.name] / MESH_STEPS
            row["mesh_ms_per_step"] = ms
            print(f"kernel {row['name']}: {row['in_step_ms']} ms a mesh "
                  f"step in {MESH_SHARDS} launches ({card})", flush=True)
            rows.append(row)
        print(f"phase 14, {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return rows, err


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
    conserves the population per cell.  Kernel E's 2-D rows above
    capacity 128 (its warp rows, _ext.COAL_WARP_ROWS) at 256 and 512:
    bitwise their plain version on a step's arguments, the rows that take
    the one-warp pass, a call's time and its device time in the step
    (torch.profiler) against their bound.  Returns the kernels row of E's
    warp rows (launches: the policy's runs)."""
    from libcloudphxx_tpu_torch.ops import coal
    m = make_model(Kinematic2D, coal=True, sd_conc=FORCED_SD_CONC)
    d = m.dense_state
    occ0 = occupancy(d)
    print(f"forced retargets: {int((d.n > 0).sum())} SDs, densest cell "
          f"{occ0} = {occ0 / 128:.3f} of capacity 128", flush=True)
    check(0.85 <= occ0 / 128 < 1.0, f"forced: densest cell {occ0}")
    repacks, rows_launched = [], 0
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
            # E's one-warp row up to capacity 128, its warp rows above
            check(launches["coal"] + launches["coal_warp_rows"]
                  == FORCED_EVERY * FORCED_CHUNKS
                  + FORCED_EVERY * sum(e["redo"] for e in log),
                  f"forced {label}: kernel E launches {launches}")
            check(launches["coal_warp_rows"] > 0,
                  f"forced {label}: no capacity above 128 ran ({caps})")
            rows_launched += launches["coal_warp_rows"]
            moved = caps[1] > caps[0] if label == "grow" else \
                caps[1] < caps[0]
            check(moved, f"forced {label}: the policy kept capacity "
                  f"{caps[0]} ({caps})")
            check(int(m.dense_state.overflow) == 0,
                  f"forced {label}: SDs dropped")
        # kernel E's warp rows at the capacities reached: against the plain
        # version on a step's arguments, timed a call and in the step
        fields, err, row = (m.th, m.rv), {}, None
        for at in (256, 512):
            m.dense_state = dense.repack(m.cfg, start, at)
            e_kw = capture(coal, "coal_resident",
                           lambda: m.run_device_lgrngn(1, engine="dense"))
            m.th, m.rv = fields
            check(coal.resident_kernel(m.cfg, at) is _ext.COAL_WARP_ROWS,
                  f"forced: capacity {at} is not on E's warp rows")
            check_e(f"forced, capacity {at}", _ext.COAL_WARP_ROWS, e_kw,
                    err, (("cloud", 1.0, "stride"), ("drizzle", 100.0,
                                                       "sort")))
            n = e_kw["n"]
            one_warp = float((~(n[:, 128:] > 0).any(1)).float().mean())
            work = coal_work(lambda: coal.coal_resident(**e_kw, plain=True),
                             n)
            r = kernel_row(_ext.COAL_WARP_ROWS, rows_launched, err,
                           lambda plain: coal.coal_resident(**e_kw,
                                                            plain=plain),
                           coal_y_bound(e_kw, work), card,
                           where=f"in phase 12's runs (capacity {at})")
            ey_resources(_ext, r, e_kw)
            m.dense_state = dense.repack(m.cfg, start, at)
            r["in_step_ms"] = device_ms(
                lambda k: m.run_device_lgrngn(k, engine="dense"),
                PROFILE_STEPS, ("coal_y_kernel",)).get("coal_y_kernel")
            m.th, m.rv = fields
            r["one_warp_share"] = one_warp
            print(f"kernel E's warp rows, {FORCED_SD_CONC} SDs a cell, "
                  f"capacity {at}: {r['ms']:.4f} ms a call, in the step "
                  + (f"{r['in_step_ms']:.4f}" if r["in_step_ms"] else
                     "not measured")
                  + f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                  f"rows on the one-warp pass {one_warp:.4f} ({card})",
                  flush=True)
            if row is None:
                row = r
            else:
                row[f"cap{at}"] = {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "in_step_ms",
                    "one_warp_share", "resources", "resources_one_warp",
                    "max_abs_err") if k in r}
            del e_kw
    finally:
        unwrap()
    print(f"forced retargets: repacks {repacks}, each conserving every "
          f"cell's SDs", flush=True)
    return row


def form_of(cfg, turb=False):
    """The condensation wrapper in ops/cond.py that a phase of ``cfg``
    calls and the kernel it launches (ops/cond.form_kernel's pick): F
    (cond_flat) per cell, G's fixed-count or adaptive form in exact mode;
    the parcel form where cfg.n_dims == 0, the turb_cond form with
    ``turb``, F's ice form with cfg.ice_switch."""
    from libcloudphxx_tpu_torch.lgrngn import condensation
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    if not condensation.exact_route(cfg):
        fname = "cond_flat"
    elif cfg.adaptive_sstp_cond:
        fname = "perparticle_adaptive"
    else:
        fname = "perparticle_fixed"
    return fname, cond_ops.form_kernel(
        fname, cfg.n_dims == 0, turb,
        ice=fname == "cond_flat" and cfg.ice_switch)


def kw_form(kw):
    """form_of for a wrapper's captured arguments ``kw``."""
    return form_of(kw["cfg"], kw.get("ssp") is not None)


def check_flat_form(label, kernel, kw, err):
    """Kernel F's form ``kernel`` against its plain version on its
    captured arguments ``kw``: the live droplets' rw2, th and rv within
    the cell sums' gates (rel 1e-5, 2e-6, 2e-5), rhod bitwise, the dead
    slots' rw2 copied through; under turb_cond the live droplets' ssp
    bitwise and the dead slots' copied through; with ice (its ice forms)
    the frozen SDs' axes rel 1e-5, the last closure's th and rv within
    the th and rv gates, the frozen SDs without liquid kept at rw2 0 and
    every other slot's axes copied through."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    k = cond_ops.cond_flat(**kw)
    pl = cond_ops.cond_flat(**kw, plain=True)
    torch.cuda.synchronize()
    live = kw["wgt"] > 0
    rel = (max_rel(k[0][live], pl[0][live]), max_rel(k[1], pl[1]),
           max_rel(k[2], pl[2]))
    same = bool(torch.equal(k[3], pl[3])) \
        and bool(torch.equal(k[0][~live], kw["rw2"][~live]))
    errs = [max_abs(k[0][live], pl[0][live]), max_abs(k[1], pl[1]),
            max_abs(k[2], pl[2])]
    if kw.get("ssp") is not None:
        same = same and bool(torch.equal(k[4][live], pl[4][live])) \
            and bool(torch.equal(k[4][~live], kw["ssp"][~live]))
        errs.append(max_abs(k[4][live], pl[4][live]))
    ice = ""
    ok_ice = True
    if kw.get("ice") is not None:
        ia, ic, _ = kw["ice"]
        frz = live & (ia > 0) & (ic > 0)
        axes = [(a[frz], b[frz]) for a, b in zip(k[-4:-2], pl[-4:-2])]
        rel_ice = max((max_rel(a, b) for a, b in axes if a.numel()),
                      default=0.0)
        rel_c = (max_rel(k[-2], pl[-2]), max_rel(k[-1], pl[-1]))
        # a frozen SD without liquid takes none (one that collected drops
        # in a coalescence holds both, as in the JAX package, and grows)
        dry = frz & (kw["rw2"] <= 0)
        same = same and bool(torch.equal(k[0][dry], kw["rw2"][dry])) \
            and bool(torch.equal(k[-4][~frz], ia[~frz])) \
            and bool(torch.equal(k[-3][~frz], ic[~frz]))
        errs += [max_abs(a, b) for a, b in axes if a.numel()]
        ok_ice = rel_ice <= 1e-5 and rel_c[0] <= 2e-6 and rel_c[1] <= 2e-5
        ice = (f"; {int(frz.sum())} frozen, their axes rel {rel_ice:.2e}, "
               f"the last closure's th rel {rel_c[0]:.2e}, rv rel "
               f"{rel_c[1]:.2e}")
    err[kernel.name] = max(err.get(kernel.name, 0.0), *errs)
    print(f"F {kernel.name} {label}: {kw['rw2'].numel()} slots, "
          f"{int(live.sum())} live in {kw['th'].numel()} cells; rw2 rel "
          f"{rel[0]:.2e}, th rel {rel[1]:.2e}, rv rel {rel[2]:.2e}{ice}; "
          f"rhod, dead slots (and ssp, axes) bitwise {same}", flush=True)
    check(same and ok_ice and rel[0] <= 1e-5 and rel[1] <= 2e-6
          and rel[2] <= 2e-5,
          f"{kernel.name} {label}: kernel and plain version differ")


def check_form(label, kw, err):
    """The form that a condensation wrapper's captured arguments ``kw``
    run (kw_form) against its plain version on them: F's as
    check_flat_form; G's with rw2 in every slot and the live SDs' private
    state (and ssp) bitwise; with in-cell mixing (the kernel's butterfly
    sums add in another order) B's and F's gates on rw2 1e-5, th 2e-6 and
    rv 2e-5, the live SDs' private rhod and p and the slots it does not
    advance bitwise.  A dead slot's private values are not compared (the
    kernel keeps them; the plain version may leave 0 * 0 / 0 there).
    Records the largest difference in err[the kernel's name]."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    fname, kernel = kw_form(kw)
    if fname == "cond_flat":
        return check_flat_form(label, kernel, kw, err)
    cfg = kw["cfg"]
    f = getattr(cond_ops, fname)
    k, pl = f(**kw), f(**kw, plain=True)
    torch.cuda.synchronize()
    n, rw2 = kw["sd"][0], kw["sd"][1]
    live = n > 0
    key = kernel.name
    err[key] = max(err.get(key, 0.0), max_abs(k[0], pl[0]),
                   *(max_abs(a[live], b[live]) for a, b in zip(k[1:], pl[1:])))
    if fname == "perparticle_fixed" and cfg.sstp_cond_mix:
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
        what = (f"bitwise equal (rw2 every slot, private state "
                f"{'and ssp ' if len(k) > 5 else ''}live) {ok}")
    moved = float((k[0] != rw2)[live].double().mean())
    print(f"G {key} {label}: {n.numel()} slots, {int(live.sum())} live; "
          f"{what}; {moved:.4f} of the live SDs changed", flush=True)
    check(ok, f"G's {key} form, {label}: kernel and plain version differ")


FORM_BOUNDS = {"cond_flat": lambda kw: cond_flat_bound(kw["cfg"], kw),
               "perparticle_fixed": lambda kw: cond_sd_fixed_bound(kw),
               "perparticle_adaptive": lambda kw: cond_sd_adaptive_bound(kw)}


def form_row(kw, launches, where, err, name=None, reps=None,
             plain_reps=None):
    """The kernel row of the form that ``kw`` (a condensation wrapper's
    captured arguments) runs: a launch timed on them (the mean of
    ``reps``, KERNEL_REPS by default) beside its plain version's (of
    ``plain_reps``, FORM_PLAIN_REPS) and its bound; ``launches`` its
    count in ``where``, ``name`` the row's (the kernel's by default)."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    fname, kernel = kw_form(kw)
    f = getattr(cond_ops, fname)
    ms = time_cuda(lambda: f(**kw), reps or KERNEL_REPS)
    plain_ms = time_cuda(lambda: f(**kw, plain=True),
                         plain_reps or FORM_PLAIN_REPS)
    bound_ms, bound_by = FORM_BOUNDS[fname](kw)
    name = name or kernel.name
    print(f"kernel {name}: {ms:.4f} ms a launch (a phase), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"{launches} launches in {where} ({card_line()})", flush=True)
    check(launches > 0, f"kernel {name} was not launched")
    return {"name": name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches,
            "max_abs_err": err[kernel.name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
        fname, form = form_of(prt.cfg)

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
    variants, their launches in ``out``): form_row."""
    rows = []
    for label in ("mixing", "adaptive"):
        kernel = kw_form(form_kw[label])[1]
        rows.append(form_row(
            form_kw[label], out[label]["launches"][kernel.name],
            f"the {label} variant's {SLICE_SPINUP + SLICE_MAIN} steps", err,
            name=kernel.name + ("_flat" if where == "flat" else "")))
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
        fname, form = form_of(m.cfg)

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


def option_model(Kinematic2D, case):
    """Phase 17's model of ``case``: bench.py's grid and substeps, the
    geometric kernel, coalescence on."""
    from libcloudphxx_tpu_torch.lgrngn import as_t, kernel_t
    kw, oi = dict(sd_conc=SD_CONC), {}
    if case == "const_multi":
        kw["sd_conc"] = 0
        oi.update(sd_const_multi=CONST_MULTI)
    elif case == "vohl_pred_corr":
        oi.update(kernel=kernel_t.vohl_davis_no_waals,
                  adve_scheme=as_t.pred_corr, sd_conc_large_tail=True)
    else:
        kw["reference_rng"] = True
    return Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sstp_cond=SSTP_COND,
        sstp_coal=SSTP_COAL, n_sd_max=2 * SD_CONC * NX * NZ,
        opts_init_kw=oi, device=DEVICE, **kw)


def dense_options(Kinematic2D, dense, _ext, step, coal, card):
    """Phase 17: a const-multi population, sd_conc 64 with the large tail,
    vohl and pred_corr, and the reference's mt19937 init, at full width
    (see the module docstring).  Returns (the kernel rows of E's wide-table
    form and C's pred_corr form, the max abs errors of every form of E and
    C against its plain version here)."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    steps = OPTION_SPINUP + OPTION_MAIN
    err, forms, timing = {}, {}, {}
    for case in ("const_multi", "vohl_pred_corr", "reference_rng"):
        t0 = time.perf_counter()
        m = option_model(Kinematic2D, case)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        check(isinstance(m.prtcls, particles_dense_t),
              f"{case}: the factory on the card gave "
              f"{type(m.prtcls).__name__}, not particles_dense_t")
        init = (m.dense_state, m.th, m.rv)
        d0 = init[0]
        per_cell = (d0.n > 0).sum(1)
        n_sd = int(per_cell.sum())
        totals = dense.water_dry_totals(d0, m.rv)
        e_form = coal.resident_kernel(m.cfg, d0.cap)
        c_form = _ext.TRANSPORT_PRED_CORR if case == "vohl_pred_corr" \
            else _ext.TRANSPORT
        print(f"{case}: init (factory -> init, then pack) {t_init:.2f} s; "
              f"{n_sd} SDs, {n_sd / NX / NZ:.2f} a cell, fullest cell "
              f"{int(per_cell.max())}, emptiest {int(per_cell.min())}, "
              f"capacity {d0.cap}; multiplicities "
              f"{float(d0.n[d0.n > 0].min()):.6g}-"
              f"{float(d0.n.max()):.6g}", flush=True)

        def restore(s):
            m.dense_state, m.th, m.rv = s
            m.prtcls._sstp_coal_extra = 0

        reset(_ext.KERNELS)
        t1 = time.perf_counter()
        m.run_device_lgrngn(OPTION_SPINUP, spinup=OPTION_SPINUP,
                            engine="dense")
        sp = (m.dense_state, m.th, m.rv)
        m.run_device_lgrngn(OPTION_MAIN, engine="dense")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = {k.name: k.launches for k in _ext.KERNELS}
        grew = m.prtcls._sstp_coal_extra
        dw, dd = physics_checks(m, *totals, dense)
        end = (m.dense_state, m.th, m.rv)
        lost = collided(sp[0], end[0])
        print(f"{case}: {OPTION_SPINUP} spin-up + {OPTION_MAIN} main steps "
              f"in {secs:.2f} s; water rel err {dw:.2e}, dry rel err "
              f"{dd:.2e}, multiplicity lost to collisions {lost:.3e}, SDs "
              f"{int((end[0].n > 0).sum())}, sstp_coal growth "
              f"{grew} (sstp_coal {m.cfg.sstp_coal + grew} at the end), "
              f"global re-bins {end[0].rebins}; launches {launches}; "
              f"launches a step {sum(launches.values()) / steps:.1f}",
              flush=True)
        want = {k.name: 0 for k in _ext.KERNELS}
        want.update({"mpdata": steps, "cond": steps, c_form.name: steps,
                     "merge": steps, e_form.name: OPTION_MAIN})
        check(launches == want, f"{case}: launches {launches}, expected "
              f"{want}")
        check(lost > 0.0, f"{case}: no collision in the main steps")
        if case == "vohl_pred_corr":
            big = float(end[0].rw2.max()) ** 0.5
            print(f"{case}: largest droplet {big * 1e6:.1f} um")

        # the dense front's stepwise run from init, bitwise
        restore(init)
        reset(_ext.KERNELS)
        m.run(steps, spinup=OPTION_SPINUP)
        torch.cuda.synchronize()
        front = {k.name: k.launches for k in _ext.KERNELS}
        eq = {"th": bool(torch.equal(m.th, end[1])),
              "rv": bool(torch.equal(m.rv, end[2])),
              "all planes": bool(np.array_equal(population(m.dense_state),
                                                population(end[0]))),
              "sstp_coal growth": m.prtcls._sstp_coal_extra == grew}
        print(f"{case}: dense front, public API: launches {front}; vs "
              f"run_device_lgrngn(engine='dense') bitwise equal {eq}",
              flush=True)
        check(front == dict(want, mpdata=2 * steps),
              f"{case}: dense front launches {front}")
        check(all(eq.values()), f"{case}: the dense front differs from "
              "run_device_lgrngn(engine='dense')")

        # the kernel path against the plain path, from init, bitwise
        res = []
        for plain in (False, True):
            restore(init)
            m.run_device_lgrngn(steps, spinup=OPTION_SPINUP, engine="dense",
                                plain=plain)
            torch.cuda.synchronize()
            res.append((m.dense_state, m.th, m.rv,
                        m.prtcls._sstp_coal_extra))
        (sk, thk, rvk, gk), (sq, thq, rvq, gq) = res
        same = bool(torch.equal(thk, thq) and torch.equal(rvk, rvq)
                    and np.array_equal(population(sk), population(sq))
                    and gk == gq)
        print(f"{case}, kernels vs plain after {steps} steps: th rel "
              f"{max_rel(thk, thq):.2e}, rv rel {max_rel(rvk, rvq):.2e}, "
              f"bitwise equal (th, rv, every plane, growth) {same}",
              flush=True)
        check(same, f"{case}: the kernel path differs from the plain path")

        # E's and C's forms against their plain versions on what a main
        # step gives them
        calls = capture_all({"e": (coal, "coal_resident"),
                             "c": (step, "transport")},
                            lambda: (restore(sp), m.run_device_lgrngn(
                                1, engine="dense")))
        e_kw, c_kw = calls["e"][-1], calls["c"][-1]
        n_in = e_kw["n"]
        if case == "const_multi":
            check(bool(torch.all(n_in[n_in > 0] == CONST_MULTI)),
                  "const_multi: multiplicities are not the constant")
        # the captured population, and with radii x10 (drizzle) and x50
        # (rain, to 0.8 mm: vohl's table past index 126), where droplets
        # collide, and const-multi SDs of equal multiplicity empty
        for pop, scale in (("cloud", 1.0), ("drizzle", 100.0),
                           ("rain", 2500.0)):
            for form in ("stride", "sort"):
                kw = dict(e_kw, pairing=form, rw2=e_kw["rw2"] * scale)
                k_out = _counted(e_form, lambda: coal.coal_resident(**kw))
                p_out = coal.coal_resident(**kw, plain=True)
                lanes = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
                err[e_form.name] = max(err.get(e_form.name, 0.0), *(
                    max_abs(a, b) for a, b in zip(k_out, p_out)))
                lost = float(n_in.double().sum() - k_out[0].double().sum())
                emptied = int(((n_in > 0) & (k_out[0] == 0)).sum())
                print(f"E {e_form.name} {form}, {case}, {pop}: lanes equal "
                      f"{lanes}, flags equal "
                      f"{bool(torch.equal(k_out[-1], p_out[-1]))} "
                      f"({int(k_out[-1].sum())} of {n_in.shape[0]} rows "
                      f"flagged), multiplicity lost {lost:.6g}, SDs emptied "
                      f"{emptied}, largest droplet "
                      f"{float(kw['rw2'].max()) ** 0.5 * 1e6:.1f} um",
                      flush=True)
                check(lanes, f"E {e_form.name} {form}, {case}, {pop}: kernel "
                      f"and plain version differ lane by lane (or in the "
                      f"flags)")
                check(lost > 0.0 or pop == "cloud",
                      f"E {e_form.name} {form}, {case}, {pop}: no collision")
                check(emptied > 0 or pop == "cloud" or case != "const_multi",
                      f"E {form}, const_multi, {pop}: no SD emptied")
        alive = c_kw["n"] > 0
        rain = dict(c_kw, do_sedi=True, n=torch.where(alive, 2.0, 0.0),
                    rw2=torch.where(alive, 1e-6, 0.0),
                    z=torch.where(alive, m.cfg.z0 + 20.0 * (c_kw["z"]
                                                              / m.cfg.z1),
                                  c_kw["z"]))
        for label, kw in (("cloud", c_kw), ("rain", rain)):
            kc = _counted(c_form, lambda: step.transport(**kw))
            pc = step.transport(**kw, plain=True)
            same = all(torch.equal(a, b) for a, b in zip(kc[:5], pc[:5])) \
                and bool(torch.equal(kc[5][:, 4], pc[5][:, 4]))
            pud_k, pud_p = kc[5].sum(0)[:4], pc[5].sum(0)[:4]
            rel_pud = max_rel(pud_k, pud_p) if float(pud_p[3]) else \
                float(pud_k.abs().max())
            err[c_form.name] = max(err.get(c_form.name, 0.0), *(
                max_abs(a, b) for a, b in zip(kc[:4], pc[:4])))
            print(f"C {c_form.name}, {case}, {label}: n/x/z/vt/targets and "
                  f"far flags equal {same}, puddle rel {rel_pud:.2e}, "
                  f"droplets that left their row "
                  f"{int(((kc[4] >= 0) & (kc[4] != _rows_of(kc[4]))).sum())}",
                  flush=True)
            check(same and rel_pud <= 1e-5, f"C {c_form.name}, {case}, "
                  f"{label}: kernel and plain version differ")
        if case == "vohl_pred_corr":
            forms = dict(e=e_kw, c=c_kw, launches=launches)
            forms["narrow"] = vohl_at_128(m, sp, dense, _ext, coal, err)

        # timing: best of TIME_REPS from-init reps of TIME_STEPS steps,
        # bench.py's physics checks on each, the growth reset each rep
        restore(init)
        m.run_device_lgrngn(2, engine="dense")             # warm-up
        best, grown = float("inf"), []
        for _ in range(TIME_REPS):
            restore(init)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m.run_device_lgrngn(TIME_STEPS, engine="dense")
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t2)
            grown.append(m.prtcls._sstp_coal_extra)
            physics_checks(m, *totals, dense)
        timing[case] = best / TIME_STEPS * 1e3
        restore(init)
        in_step = device_ms(lambda k: m.run_device_lgrngn(k, engine="dense"),
                            PROFILE_STEPS, ("coal_kernel", "coal_y_kernel",
                                            "transport_kernel", "WideTable",
                                            "PredCorrGeometry"))
        restore(init)
        print(f"timing {case} (run_device_lgrngn, coalescence on), kernels: "
              f"{timing[case]:.3f} ms/step, "
              f"{n_sd * TIME_STEPS / best:.4g} SD-updates/s ({TIME_STEPS} "
              f"steps, best of {TIME_REPS}; sstp_coal growth by rep "
              f"{grown}); device time in the step [ms] "
              + ", ".join(f"{k} {v:.4f}" for k, v in in_step.items())
              + f" ({card})", flush=True)

    rows = []
    e_kw, c_kw = forms["e"], forms["c"]
    e_form = coal.resident_kernel(e_kw["cfg"], e_kw["n"].shape[1])
    work = coal_work(lambda: coal.coal_resident(**e_kw, plain=True),
                     e_kw["n"])
    one_warp = float((~(e_kw["n"][:, 128:] > 0).any(1)).float().mean())
    print(f"E {e_form.name} work on the vohl_pred_corr population "
          f"(capacity {e_kw['n'].shape[1]}): {work}; rows on the one-warp "
          f"pass {one_warp:.4f}")
    n_kw, n_work, n_launches = forms["narrow"]
    for kernel, call, bnd, n_launch, kw in (
            (e_form, lambda plain: coal.coal_resident(**e_kw, plain=plain),
             coal_wide_bound(e_kw, work), forms["launches"][e_form.name],
             e_kw),
            (_ext.COAL_VOHL,
             lambda plain: coal.coal_resident(**n_kw, plain=plain),
             coal_wide_bound(n_kw, n_work), n_launches, n_kw),
            (_ext.TRANSPORT_PRED_CORR,
             lambda plain: step.transport(**c_kw, plain=plain),
             transport_pred_corr_bound(c_kw, step.transport(**c_kw)),
             forms["launches"][_ext.TRANSPORT_PRED_CORR.name], None)):
        ms = time_cuda(lambda: call(False), KERNEL_REPS)
        plain_ms = time_cuda(lambda: call(True), KERNEL_REPS)
        bound_ms, bound_by = bnd
        print(f"kernel {kernel.name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); {n_launch} launches in "
              f"{steps} steps of vohl_pred_corr"
              + ("" if kw is None else f" at capacity {kw['n'].shape[1]}")
              + f" ({card})")
        check(n_launch > 0, f"kernel {kernel.name} was not launched")
        rows.append({"name": kernel.name, "route": "cuda",
                     "source": kernel.source, "replaces": kernel.replaces,
                     "launches": n_launch, "max_abs_err": err[kernel.name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
        if kernel is _ext.COAL_VOHL_WARP_ROWS:
            rows[-1]["one_warp_share"] = one_warp
            ey_resources(_ext, rows[-1], e_kw)
    print(f"timing, phase 17 (run_device_lgrngn, coalescence on, from "
          f"init): " + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
          + f" ms/step ({card})", flush=True)
    return rows, err


def vohl_at_128(m, sp, dense, _ext, coal, err):
    """Phase 17 (b)'s vohl population after its spin-up, repacked to
    capacity 128 (its rows hold fewer droplets): OPTION_MAIN coalescing
    steps through E's one-warp wide-table form (_ext.COAL_VOHL), which the
    capacity-256 run leaves to the warp rows; the form against its plain
    version on a step's arguments.  Returns (those arguments, the work
    their data needs, the form's launches in the steps)."""
    d, th, rv = sp
    check(occupancy(d) <= 128, f"vohl at 128: densest row {occupancy(d)}")
    m.dense_state, m.th, m.rv = dense.repack(m.cfg, d, 128), th, rv
    reset(_ext.KERNELS)
    m.run_device_lgrngn(OPTION_MAIN, engine="dense")
    torch.cuda.synchronize()
    launches = _ext.COAL_VOHL.launches
    check(launches == OPTION_MAIN and _ext.COAL_VOHL_WARP_ROWS.launches == 0,
          f"vohl at 128: launches {launches}")
    m.dense_state, m.th, m.rv = dense.repack(m.cfg, d, 128), th, rv
    kw = capture(coal, "coal_resident",
                 lambda: m.run_device_lgrngn(1, engine="dense"))
    check_e("vohl at capacity 128", _ext.COAL_VOHL, kw, err,
            (("rain", 2500.0, "stride"), ("rain", 2500.0, "sort")))
    work = coal_work(lambda: coal.coal_resident(**kw, plain=True), kw["n"])
    print(f"vohl at capacity 128: {launches} launches of coal_vohl in "
          f"{OPTION_MAIN} steps; work {work}", flush=True)
    return kw, work, launches


def _counted(kernel, fn):
    """fn()'s result, after checking that it launched ``kernel`` once."""
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    check(kernel.launches == before + 1, f"{kernel.name} was not launched")
    return out


def _rows_of(tgt):
    """Each slot's own row, as an int32 plane like ``tgt``."""
    return torch.arange(tgt.shape[0], device=tgt.device,
                        dtype=tgt.dtype)[:, None].expand(tgt.shape)


def coal_wide_bound(kw, work):
    """Kernel E's wide-table form's bound on its arguments ``kw``
    (coal_resident's) and the work its data needs (coal_work): six planes,
    five cell fields and the (K+2)-square table in, six planes and the row
    flags out; coal_bounds' operations and each pair's table lookup."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence as coal_mod
    n = kw["n"]
    live = n > 0
    plane, cell = nbytes(n), nbytes(kw["rhod"])
    table = coal_mod.clamped_efficiency_table(kw["cfg"].kernel)[0]
    vt32, vt64 = vt_ops(kw["cfg"], kw["rw2"][live])
    per32 = vt32 / max(int(live.sum()), 1)
    per64 = vt64 / max(int(live.sum()), 1)
    vts = work["live"] + work["changed"]
    return bound(12 * plane + 5 * cell + n.shape[0] + table.nbytes,
                 coal_ops(work) + work["pairs"] * OPS_EFF + vts * per32,
                 vts * per64)


def transport_pred_corr_bound(kw, kc):
    """Kernel C's pred_corr form's bound on its arguments ``kw``
    (transport's) and its outputs ``kc``: transport_bound's bytes with the
    staggered courants, and its operations with each live droplet's
    corrector."""
    cfg, n = kw["cfg"], kw["n"]
    live = n > 0
    live0, slot = int(live.sum()), n.element_size()
    fell = int((live & (kc[0] == 0) & (kc[2] < cfg.z0)).sum())
    vt32, vt64 = vt_ops(cfg, kw["rw2"][live])
    return bound(
        nbytes(n) + 3 * slot * live0 + slot * fell + 7 * nbytes(kw["rhod"])
        + 4 * nbytes(n) + nbytes(kc[4], kc[5]) + nbytes(*kw["courants"]),
        vt32 + live0 * (OPS_TRANSPORT + OPS_PRED_CORR),
        vt64 + live0 * OPS_PRED_CORR_F64)


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
    out (under turb_cond also its ssp in, and the adaptive form's dot_ssp
    in and ssp out), a dead slot's n, and its rw2 in and out, each cell's
    arrays once, and the flat layout's order and ends, at the memory
    rate."""
    sd, cells, seg = kw["sd"], kw["cells"], kw.get("seg")
    n = sd[0]
    live, b = int((n > 0).sum()), n.element_size()
    per_live = 14 + (kw.get("ssp") is not None) \
        + 2 * (kw.get("dot_ssp") is not None)
    moved = live * per_live * b + (n.numel() - live) * 3 * b \
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
    out["merge"] = bound(*merge_work(kc[4], kc[0]))
    out.update(coal_bounds(cfg, ds, work_e))
    out["cond_flat"] = cond_flat_bound(f_cfg, f_kw)
    return out


def merge_work(tgt, n):
    """Kernel D's (bytes, operations) on the targets ``tgt`` of kernel C's
    planes, ``n`` their multiplicities: the targets of every slot and the
    seven planes of the droplets it takes (those alive after C) in, seven
    planes and the drops out; each taken droplet's placement."""
    slot, live_c = n.element_size(), int((n > 0).sum())
    return (nbytes(tgt) + 7 * slot * live_c + 7 * nbytes(n)
            + n.shape[0] * slot, live_c * OPS_MERGE)


def cond_flat_bound(f_cfg, f_kw):
    """Kernel F's bound on its arguments ``f_kw`` (cond_flat's): five SD
    arrays, the cell ends, ten cell fields and the cell order in, rw2 and
    three cell fields out (under turb_cond also ssp and dot_ssp in and ssp
    out; with the ice the axes and ice_rho in, the axes and two more cell
    fields out); the first substep's growth work (at each droplet's RH
    plus its ssp under turb_cond) sstp_cond times, each live droplet's
    set-up, each cell's substeps, and with the ice each frozen SD's
    deposition and each cell's ice terms every substep."""
    ops_f, brk, live = rootfind_ops(
        f_kw["dt_sub"], flat_first_substep(f_cfg, f_kw), f_kw["RH_max"],
        f_kw["wgt"] > 0)
    turb = f_kw.get("ssp") is not None
    print(f"F {kw_form(f_kw)[1].name}: {brk / live:.4f} of the {live} live "
          f"droplets bracketed in the first substep")
    sd = [f_kw[k] for k in ("rw2", "rd3", "kpa", "vt", "wgt")]
    if turb:
        sd += [f_kw["ssp"], f_kw["dot_ssp"], f_kw["ssp"]]
    n_f = f_kw["th"].numel()
    ice_ops, cell_rows = 0, 14
    if f_kw.get("ice") is not None:
        # the ice forms: the axes and ice_rho in, the axes out, two more
        # cell rows; each frozen live SD's deposition and each cell's
        # ice terms every substep
        ia, ic, rho = f_kw["ice"]
        sd += [ia, ic, rho, ia, ic]
        frozen = int(((f_kw["wgt"] > 0) & (ia > 0) & (ic > 0)).sum())
        ice_ops = f_kw["sstp"] * (frozen * OPS_DEP + n_f * OPS_ICE_CELL)
        cell_rows = 16
    return bound(
        nbytes(*sd, f_kw["ends"], f_kw["rw2"])
        + cell_rows * nbytes(f_kw["th"]),
        f_kw["sstp"] * ops_f + live * OPS_DROP + ice_ops
        + n_f * (f_kw["sstp"] * OPS_CELL_SUBSTEP + OPS_CLOSURE))


def cond_bound(cfg, d0, tha, rva):
    """Kernel B's bound on the population ``d0`` and the advected fields
    (cond_kw_bound on the arguments the main path gives B)."""
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    lam_D, lam_K = hskpng_mfp(d0.T, d0.p)
    return cond_kw_bound(dict(
        cfg=cfg, sstp_cond=SSTP_COND, dt=1.0, RH_max=44.0, n=d0.n,
        rw2=d0.rw2, rd3=d0.rd3, kpa=d0.kpa, thadv=tha.reshape(-1),
        rvadv=rva.reshape(-1), th0=d0.sstp_tmp_th, rv0=d0.sstp_tmp_rv,
        rhod=d0.rhod, lam_D=lam_D, lam_K=lam_K, p0=d0.p))


def cond_kw_bound(kw):
    """Kernel B's bound on its arguments ``kw`` (step.cond's): four
    planes, nine cell fields and the row order in, one plane and six cell
    fields out; the first substep's growth work sstp_cond times, each live
    droplet's set-up and rebuilt vt, each cell's substeps."""
    return bound(*cond_kw_work(kw))


def cond_kw_work(kw):
    """cond_kw_bound's (bytes, float32 operations, float64 operations)."""
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_Tpr
    from libcloudphxx_tpu_torch.lgrngn.vterm import vt_in_kernel
    cfg, n, sstp = kw["cfg"], kw["n"], kw["sstp_cond"]
    n_cell, cap, live = n.shape[0], n.shape[1], n > 0
    live0 = int(live.sum())
    col = lambda a: a[:, None].expand(-1, cap).reshape(-1)
    rhod, p, th0, rv0 = kw["rhod"], kw["p0"], kw["th0"], kw["rv0"]
    T0, p_0, _, eta0 = hskpng_Tpr(cfg, th0, rv0, rhod, p)
    vt = vt_in_kernel(cfg, kw["rw2"], T0[:, None], p_0[:, None],
                      rhod[:, None], eta0[:, None])
    th1 = th0 + (kw["thadv"] - th0) / sstp
    rv1 = rv0 + (kw["rvadv"] - rv0) / sstp
    T1, p1, RH1, eta1 = hskpng_Tpr(cfg, th1, rv1, rhod, p)
    arrays = (kw["rw2"].reshape(-1), kw["rd3"].reshape(-1),
              kw["kpa"].reshape(-1), vt.reshape(-1), col(rhod), col(rv1),
              col(T1), col(p1), col(RH1), col(eta1), col(kw["lam_D"]),
              col(kw["lam_K"]))
    ops_b, brk, n_live = rootfind_ops(kw["dt"] / sstp, arrays,
                                      kw["RH_max"], live.reshape(-1))
    print(f"B cond: {brk / n_live:.4f} of the {n_live} live droplets "
          f"bracketed in the first substep")
    vt32, vt64 = vt_ops(cfg, kw["rw2"][live])
    return (5 * nbytes(n) + 16 * nbytes(rhod),
            sstp * ops_b + live0 * OPS_DROP + vt32 + n.numel()
            + n_cell * (sstp * OPS_CELL_SUBSTEP + 2 * OPS_CLOSURE), vt64)


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


def blk_fields(m):
    """A bulk model's fields, in BULK_FIELDS order."""
    from libcloudphxx_tpu_torch.models.kinematic_2d import BULK_FIELDS
    return tuple(getattr(m, k) for k in BULK_FIELDS[m.micro])


def blk_set(m, state):
    """Put a bulk model at ``state`` = (fields, puddle_flux, t)."""
    from libcloudphxx_tpu_torch.models.kinematic_2d import BULK_FIELDS
    fields, m.puddle_flux, m.t = state
    for k, v in zip(BULK_FIELDS[m.micro], fields):
        setattr(m, k, v)


def blk_state(m):
    return blk_fields(m), m.puddle_flux, m.t


def blk_water(m):
    """The water a bulk run conserves, per unit of cell volume: the sum of
    G (rv + rc + rr) over the cells less the surface flux that left
    (puddle_flux, negative), in float64."""
    G = m.G.double()
    return float((G * (m.rv.double() + m.rc.double() + m.rr.double()))
                 .sum()) - m.puddle_flux


def mpdata_bound(fields, mp, n_iters, fct):
    """Kernel A's bound on ``fields``: each field in and out, the courants
    and G, against the donor passes, the corrective iterations and their
    limiter (with ``fct``) of every cell and field."""
    return bound(*mpdata_work(fields, mp, n_iters, fct))


def mpdata_work(fields, mp, n_iters, fct):
    """mpdata_bound's (bytes, operations)."""
    n_cell = fields[0].numel()
    return (2 * nbytes(*fields) + nbytes(*mp),
            len(fields) * n_cell * (
                n_iters * OPS_DONOR
                + (n_iters - 1) * (OPS_ANTIDIFF + (OPS_FCT if fct else 0))))


def bulk_phase(Kinematic2D, mpdata, _ext, card, profile_on):
    """Phase 16 (the module docstring): the bulk schemes in the kinematic
    model.  Returns {scheme: kernel A's figures at its shapes}."""
    out = {}
    for micro in BLK_SCHEMES:
        m = Kinematic2D(nx=NX, nz=NZ, micro=micro, grid="node", fct=True,
                        device=DEVICE)
        m.ante_loop()
        init = blk_state(m)
        mp = (m.gc_x, m.gc_z, m.G)

        # (a) kernel A on the scheme's stack of fields: th and rv
        # perturbed, the other fields random with exact zeros (clear air)
        rng = np.random.default_rng(16)
        like = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=DEVICE)
        th0, rv0 = init[0][:2]
        fields = (th0 + like(rng.normal(0.0, 0.5, (NX, NZ))),
                  rv0 * (1.0 + like(rng.uniform(-0.05, 0.05, (NX, NZ))))) \
            + tuple(like(np.where(rng.uniform(size=(NX, NZ)) < 0.5, 0.0,
                                  rng.uniform(0.0, sc, (NX, NZ))))
                    for sc in BLK_SCALES[micro])
        err = 0.0
        for fct in (False, True):
            for n_iters in (1, 2, 3):
                args = mp + (n_iters, fct)
                k = mpdata.advect_n(fields, *args)
                p = mpdata.advect_n(fields, *args, plain=True)
                same = all(torch.equal(a, b) for a, b in zip(k, p))
                alone = all(torch.equal(a, mpdata.advect(f, *args))
                            for a, f in zip(k, fields))
                err = max(err, *(max_abs(a, b) for a, b in zip(k, p)))
                print(f"A advect_n {micro}, {len(fields)} fields, fct={fct} "
                      f"n_iters={n_iters}: bitwise equal to the plain "
                      f"version {same}, to one advect a field {alone}")
                check(same and alone, f"{micro}: advect_n fct={fct} "
                      f"n_iters={n_iters} differs from its plain version "
                      f"or from one advect a field")

        # (b) the fig_a run through the kernels, float32
        water0 = blk_water(m)
        reset(_ext.KERNELS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_device(BLK_NT, spinup=BLK_SPINUP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.KERNELS}
        end = blk_state(m)
        dw = abs(blk_water(m) - water0) / water0
        lows = {k: float(getattr(m, k).min()) for k in ("rv", "rc", "rr",
                                                        "nc", "nr")
                if hasattr(m, k)}
        rr_max = float(m.rr.max())
        print(f"{micro} fig_a run through the kernels: ante_loop, "
              f"{BLK_SPINUP} spin-up + {BLK_NT - BLK_SPINUP} steps in "
              f"{secs:.2f} s ({secs / BLK_NT * 1e3:.3f} ms/step); launches "
              f"{launches}; water rel err {dw:.2e}; minima {lows}; max rc "
              f"{float(m.rc.max()):.4e}, max rr {rr_max:.4e}, puddle_flux "
              f"{m.puddle_flux:.6e}", flush=True)
        check(launches == dict({k.name: 0 for k in _ext.KERNELS},
                               mpdata=BLK_NT),
              f"{micro}: kernel A once a step and no other kernel "
              f"expected, got {launches}")
        check(all(bool(torch.isfinite(f).all()) for f in end[0]),
              f"{micro}: non-finite fields")
        check(min(lows.values()) >= -1e-10,
              f"{micro}: a mixing ratio or concentration below -1e-10: "
              f"{lows}")
        check(dw <= 1e-4, f"{micro}: total water off by {dw:.2e}")
        check(rr_max > 0.0, f"{micro}: no rain after the spin-up")

        # (c) the kernel path against the plain path, across a spin-up
        # boundary
        runs = []
        for plain in (False, True):
            blk_set(m, init)
            m.run_device(BLK_PLAIN_STEPS, spinup=BLK_PLAIN_SPINUP,
                         plain=plain)
            runs.append(blk_fields(m))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"{micro}, kernels vs plain after {BLK_PLAIN_STEPS} steps "
              f"({BLK_PLAIN_SPINUP} spin-up): bitwise equal {same}")
        check(same, f"{micro}: the kernel path differs from the plain path")

        # (d) the stepwise loop against run_device
        runs = []
        for how in ("run", "run_device"):
            blk_set(m, init)
            getattr(m, how)(BLK_RUN_STEPS, spinup=BLK_RUN_STEPS // 2)
            runs.append(blk_fields(m))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"{micro}, run() vs run_device() over {BLK_RUN_STEPS} steps: "
              f"bitwise equal {same}")
        check(same, f"{micro}: run() differs from run_device()")

        # (e) float32 against float64 (the plain path) at the run's end
        m64 = Kinematic2D(nx=NX, nz=NZ, micro=micro, grid="node", fct=True,
                          device=DEVICE, dtype=torch.float64)
        m64.ante_loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m64.run_device(BLK_NT, spinup=BLK_SPINUP, plain=True)
        torch.cuda.synchronize()
        secs64 = time.perf_counter() - t0
        blk_set(m, end)
        diffs = {}
        for field, kind, lim in BLK_GATES[micro]:
            a, b = getattr(m, field), getattr(m64, field)
            diffs[field] = (kind, max_abs(a, b) if kind == "abs"
                            else max_rel(a, b), lim)
        print(f"{micro} at t = {BLK_NT}, float32 kernels vs float64 plain "
              f"({secs64:.2f} s): " + ", ".join(
                  f"{k} max {kind} {v:.3e} (<= {lim:g})"
                  for k, (kind, v, lim) in diffs.items())
              + f"; puddle_flux {m.puddle_flux:.6e} / "
              f"{m64.puddle_flux:.6e}", flush=True)
        check(all(v <= lim for _, v, lim in diffs.values()),
              f"{micro}: float32 outside the fig_a tolerances of float64")

        # (f) timing from the run's end: best of 3 reps, kernel A alone
        # and in the step beside its bound
        best = float("inf")
        for _ in range(TIME_REPS):
            blk_set(m, end)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.run_device(BLK_TIME_STEPS)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        step_ms = best / BLK_TIME_STEPS * 1e3
        call = lambda plain: mpdata.advect_n(end[0], *mp, m.mpdata_iters,
                                             True, plain=plain)
        a_ms, a_plain = time_cuda(lambda: call(False), KERNEL_REPS), \
            time_cuda(lambda: call(True), KERNEL_REPS)
        blk_set(m, end)
        # None where the profiler saw no device time
        in_step = device_ms(lambda n: m.run_device(n), PROFILE_STEPS,
                            ("mpdata_kernel",)).get("mpdata_kernel")
        bound_ms, bound_by = mpdata_bound(end[0], mp, m.mpdata_iters, True)
        print(f"timing {micro}, run_device: {step_ms:.3f} ms/step, "
              f"{NX * NZ * BLK_TIME_STEPS / best:.4g} cell-updates/s "
              f"({BLK_TIME_STEPS} steps, best of {TIME_REPS}); kernel A on "
              f"{len(end[0])} fields with FCT {a_ms:.4f} ms a call, in the "
              f"step " + ("not measured" if in_step is None else
                          f"{in_step:.4f}")
              + f", plain {a_plain:.4f}, bound {bound_ms:.6f} ({bound_by}) "
              f"({card})", flush=True)
        if profile_on:
            profile(f"{micro}, run_device", lambda: blk_set(m, end),
                    lambda n: m.run_device(n), card)
        out[micro] = dict(launches=launches["mpdata"], ms=a_ms,
                          in_step_ms=in_step, plain_ms=a_plain,
                          bound_ms=bound_ms, bound_by=bound_by,
                          step_ms=step_ms, max_abs_err=err)
    return out


def les_model(Kinematic2D, case):
    """Phase 18's model of configuration ``case`` (a)-(e) and its opts
    (the public API's per-step switches)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.models.kinematic_2d import Setup
    setup = Setup()
    oi = dict(turb_adve_switch=True)
    if case == "e":
        oi.update(kernel=tl.kernel_t.hall)
    else:
        oi.update(turb_cond_switch=True, turb_coal_switch=True,
                  diag_incloud_time=True, kernel=tl.kernel_t.onishi_hall,
                  kernel_parameters=[LES_RE_LAMBDA])
    if case == "b":
        oi.update(exact_sstp_cond=True)
    if case == "c":
        oi.update(exact_sstp_cond=True, adaptive_sstp_cond=True,
                  sstp_cond_act=8)
    n_sd = SD_CONC * NX * NZ
    if case == "d":
        dz = setup.Z / NZ
        oi.update(src_type=tl.src_t.simple, src_x0=0.0, src_x1=setup.X,
                  src_z0=0.0, src_z1=SRC_LEVELS * dz, rlx_switch=True,
                  supstp_rlx=2, rlx_bins=64,
                  rlx_dry_distros={setup.kappa: (
                      setup.lognormal_lnrd, (0.0, 2.0), (0.0, setup.Z))})
        n_sd += LES_SD_HEADROOM
    m = Kinematic2D(nx=NX, nz=NZ, micro="lgrngn", sd_conc=SD_CONC,
                    sstp_cond=SSTP_COND, sstp_coal=SSTP_COAL,
                    n_sd_max=n_sd,
                    opts_init_kw=oi, device=DEVICE)
    opts = tl.opts_t()
    opts.turb_adve = True
    opts.turb_cond = opts.turb_coal = case != "e"
    opts.rcyc = case in ("a", "b", "c")
    if case == "d":
        opts.src = opts.rlx = True
        scaled = lambda lnr: SRC_SCALE * setup.lognormal_lnrd(lnr)
        opts.src_dry_distros = {(setup.kappa, 0.0): (scaled, SRC_SD_CONC,
                                                     SRC_SUPSTP)}
    return m, opts


def les_step(m, opts, diss, plain=False):
    """One step of the LES host loop: MPDATA of th and rv (kernel A), then
    step_sync(opts, th, rv, rhod, Cx, Cz, diss_rate) and step_async(opts)."""
    m.advect_scalars(plain=plain)
    th, rv = m.prtcls.step_sync(opts, m.th, m.rv, m.rhod,
                                courant_x=m.C_x, courant_z=m.C_z,
                                diss_rate=diss, plain=plain)
    m.th, m.rv = th.reshape(NX, NZ), rv.reshape(NX, NZ)
    m.prtcls.step_async(opts, plain=plain)


def les_init(m):
    """What les_reset puts back: the flat state and the fields at init."""
    return m.prtcls.state, m.th, m.rv


def les_reset(m, init):
    """Put a phase-18 model back at ``init``: its state, fields, source
    and relaxation counters and their generator, and (the dense front) its
    layout."""
    p = m.prtcls
    p.state, m.th, m.rv = init
    p._src_ctr = p._rlx_ctr = p._sstp_coal_extra = 0
    p._src_rng = np.random.default_rng(p.opts_init.rng_seed + 1)
    if hasattr(p, "_loc"):
        p._loc, p._d, p._riders = "flat", None, {}


def les_water(m, c):
    """(water, dry volume sum, live SDs) through the public API."""
    water, dry = flat_totals(m.prtcls, m.rv, c)
    return water, dry, int((m.prtcls.get_attr("n") > 0).sum())


def les_checks(label, m, opts, totals0, added, made, flow, c):
    """Phase 18's checks on a model after a run: finite fields, water
    conserved with the puddle and what the sources added (``added``: its
    kg), the velocity perturbations of the order of sqrt(2/3 TKE), ssp
    finite and not all zero (turb_cond), the in-cloud time >= 0 and 0 on
    the SDs far below their critical radius, no SD dropped: each of the
    ``made`` SDs the sources made is live after its injection, the live
    count at the end is the count at the start plus ``flow``'s changes
    (the injection, recycling) less its losses (coalescence, the walls),
    recycling fills every slot, and the dense front overflows no row."""
    from libcloudphxx_tpu_torch.common import kappa_koehler
    from libcloudphxx_tpu_torch.lgrngn import condensation
    p = m.prtcls
    water, dry, n_live = les_water(m, c)
    st = p.state
    live = st.n > 0
    check(bool(torch.isfinite(m.th).all() and torch.isfinite(m.rv).all()),
          f"LES {label}: non-finite th/rv")
    check(bool(torch.isfinite(st.rw2[live]).all()
               and (st.rw2[live] > 0).all()), f"LES {label}: bad rw2")
    dw = abs(water - totals0[0] - added) / totals0[0]
    check(dw < 1e-3, f"LES {label}: water conservation off by {dw:.2e}")
    urms = max(np.sqrt(2.0 / 3 * float(st.diss_rate.max())), 1e-30)
    ratio = [float(getattr(st, k)[live].abs().mean()) / urms
             for k in ("up", "wp")]
    check(all(0.1 < r < 2.0 for r in ratio),
          f"LES {label}: mean |up|, |wp| / sqrt(2/3 TKE) {ratio}")
    out = {"water_rel_err": dw, "up_wp_over_urms": ratio, "sds": n_live}
    if opts.turb_cond:
        # the exact fixed-count mode holds ssp, which nothing else advances
        # (the JAX package's cond_perparticle): zero there from init
        ssp = st.ssp[live]
        moves = not (p.cfg.exact_sstp_cond and not p.cfg.adaptive_sstp_cond)
        check(bool(torch.isfinite(ssp).all())
              and bool((ssp != 0).any()) == moves,
              f"LES {label}: ssp non-finite, or zero where it moves")
        out["ssp_abs_max"] = float(ssp.abs().max())
    if p.opts_init.diag_incloud_time:
        T = p._tpr_impl().T[st.ijk]
        rc2 = kappa_koehler.rw3_cr(torch.clamp(st.rd3, min=1e-30),
                                   torch.clamp(st.kpa, min=1e-10),
                                   T) ** (2.0 / 3)
        far = live & (st.rw2 < 0.25 * rc2)
        ict = st.incloud_time
        # the exact modes do not update it (the JAX package's step_cond)
        counts = not condensation.exact_route(p.cfg)
        check(bool((ict >= 0).all()) and bool((ict[far] == 0).all())
              and bool((ict[live] > 0).any()) == counts,
              f"LES {label}: in-cloud time negative, non-zero far below "
              f"activation, or positive where it is not counted")
        out["incloud_share"] = float((ict[live] > 0).double().mean())
    if hasattr(p, "_d") and p._d is not None:
        check(int(p._d.overflow) == 0, f"LES {label}: SDs dropped")
    check(flow["src"] == made and flow["coal"] <= 0 and flow["walls"] <= 0
          and flow["rcyc"] >= 0 and n_live == totals0[2] + sum(flow.values()),
          f"LES {label}: SDs dropped: {totals0[2]} live at the start, "
          f"{n_live} at the end, {made} made by the sources, changes {flow}")
    if opts.rcyc:
        check(n_live == p.cfg.n_sd_max, f"LES {label}: {n_live} SDs live "
              f"after recycling, {p.cfg.n_sd_max} slots")
    out.update(sds_made=made, sds_flow=flow)
    return out


def les_run(m, opts, diss, steps, c, label):
    """``steps`` LES steps from the model's state with the checks; the
    water the sources and the relaxation added is summed from what they
    inject, and each phase that can revive or kill SDs (the injection, the
    coalescence, the walls, recycling) has its change of the live count
    summed on the device.  Returns (seconds, checks)."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence, recycle
    from libcloudphxx_tpu_torch.lgrngn import source as source_mod
    from libcloudphxx_tpu_torch.lgrngn import transport
    totals0 = les_water(m, c)
    added, made = [0.0], [0]
    flow = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
            for k in ("src", "coal", "walls", "rcyc")}

    def tally(key, before, after):
        flow[key] += (after.n > 0).sum() - (before.n > 0).sum()

    real = {(source_mod.StateEngine, "inject"): source_mod.StateEngine.inject,
            (coalescence, "coal"): coalescence.coal,
            (transport, "bcnd"): transport.bcnd,
            (recycle, "rcyc"): recycle.rcyc}

    def inject(eng, new):
        added[0] += 4.0 / 3 * c.pi * c.rho_w * float(
            np.sum(new["n"] * np.asarray(new["rw2"], np.float64) ** 1.5))
        made[0] += int(np.count_nonzero(np.asarray(new["n"]) > 0))
        before = eng.state
        count = real[source_mod.StateEngine, "inject"](eng, new)
        tally("src", before, eng.state)
        return count

    def counted(key, fn):
        def run(cfg, state, *args, **kw):
            out = fn(cfg, state, *args, **kw)
            tally(key, state, out)
            return out
        return run

    source_mod.StateEngine.inject = inject
    coalescence.coal = counted("coal", real[coalescence, "coal"])
    transport.bcnd = counted("walls", real[transport, "bcnd"])
    recycle.rcyc = counted("rcyc", real[recycle, "rcyc"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            les_step(m, opts, diss)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)
    flow = {k: int(v) for k, v in flow.items()}
    return secs, les_checks(label, m, opts, totals0, added[0], made[0],
                            flow, c)


def les_form_check(case, kw, err):
    """A turb_cond form against its plain version on its captured
    arguments (check_form); G's fixed form (b) also with a seeded ssp
    (nothing advances ssp in the fixed-count exact mode: it is zero)."""
    check_form(f"({case})", kw, err)
    if kw_form(kw)[0] == "perparticle_fixed":
        n = kw["sd"][0]
        gen = np.random.default_rng(18)
        ssp = torch.tensor(gen.normal(0.0, 2e-3, n.numel()),
                           dtype=n.dtype, device=n.device).reshape(n.shape)
        check_form(f"({case}), a seeded ssp", dict(kw, ssp=ssp), err)


def les_phase(Kinematic2D, _ext, c, card, profile_on):
    """Phase 18 (the module docstring): the LES slice's five
    configurations and its three turb_cond forms.  Returns (the forms'
    kernel rows, {case: numbers})."""
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    diss = torch.full((NX, NZ), LES_DISS, device=DEVICE)
    out, err, form_kw, rows = {}, {}, {}, []
    for case in "abcde":
        t_case = time.perf_counter()
        m, opts = les_model(Kinematic2D, case)
        p = m.prtcls
        check(isinstance(p, particles_dense_t) == (case == "e"),
              f"LES ({case}): the factory's pick is {type(p).__name__}")
        init = les_init(m)
        steps = LES_STEPS_E if case == "e" else LES_STEPS
        fname, kernel = (None, _ext.COND) if case == "e" \
            else form_of(p.cfg, turb=True)
        # the counted run: its form (B for (e)) once a step
        reset(_ext.KERNELS)
        secs, chk = les_run(m, opts, diss, steps, c, case)
        launches = {k.name: k.launches for k in _ext.KERNELS}
        want = dict({k.name: 0 for k in _ext.KERNELS}, mpdata=2 * steps)
        want[kernel.name] = steps
        print(f"LES ({case}): {steps} steps from init in {secs:.2f} s; "
              f"{chk}; launches {launches} ({card})", flush=True)
        check(launches == want, f"LES ({case}): kernel A twice and "
              f"{kernel.name} once a step expected, got {launches}")
        out[case] = dict(chk, launches=launches[kernel.name],
                         form=kernel.name)
        if fname is not None:
            # the form against its plain version on what a step gives it
            form_kw[case] = capture(cond_ops, fname,
                                    lambda: les_step(m, opts, diss))
            les_form_check(case, form_kw[case], err)
        # best of LES_REPS reps from init
        best = float("inf")
        for _ in range(LES_REPS):
            les_reset(m, init)
            secs, _ = les_run(m, opts, diss, steps, c, case)
            best = min(best, secs)
        n_sd = int((init[0].n > 0).sum())
        out[case].update(ms_per_step=best / steps * 1e3,
                         sd_updates_per_s=n_sd * steps / best)
        print(f"timing, LES ({case}): {best / steps * 1e3:.3f} ms/step, "
              f"{n_sd * steps / best:.4e} SD-updates/s (best of {LES_REPS} "
              f"reps of {steps} steps from init, {n_sd} SDs at init) "
              f"({card})", flush=True)
        if profile_on:
            les_reset(m, init)
            profile(f"LES ({case})", lambda: les_reset(m, init),
                    lambda n: [les_step(m, opts, diss) for _ in range(n)],
                    card)
        if case in ("a", "b", "c"):
            rows.append(form_row(form_kw[case], out[case]["launches"],
                                 f"the {steps} steps of ({case})", err))
        del m, p, init
        torch.cuda.empty_cache()
        print(f"LES ({case}): {time.perf_counter() - t_case:.1f} s",
              flush=True)
    print("timing, LES: " + ", ".join(
        f"({k}) {v['ms_per_step']:.3f} ms/step" for k, v in out.items())
        + f" ({card})", flush=True)
    return rows, out


# ------------------------------------------------------------------ phase 19
def grid3d_fields(Kinematic2D):
    """Phase 19 (a)'s fields: the GMD-2015 case at 76x76 cells of 20 m (a
    1520 m square, the Setup's profiles and stream function on it),
    extruded over GRID_N y slabs: th, rv, rhod (nx, ny, nz), the courants
    of the 2-D field on every slab, a uniform courant_y of GRID_CY (the
    flow stays non-divergent: rhod does not vary in y), and the 2-D model
    that made them."""
    from libcloudphxx_tpu_torch.models.kinematic_2d import Setup
    n = GRID_N
    setup = Setup(X=n * GRID_D, Z=n * GRID_D)
    m2 = Kinematic2D(nx=n, nz=n, setup=setup, sd_conc=1, n_sd_max=n * n,
                     device=DEVICE)
    ext = lambda a: a[:, None, :].expand(a.shape[0], n, a.shape[1]) \
        .contiguous()
    return dict(th=ext(m2.th), rv=ext(m2.rv), rhod=ext(m2.rhod),
                Cx=ext(m2.C_x), Cz=ext(m2.C_z),
                Cy=torch.full((n, n + 1, n), GRID_CY, device=DEVICE)), m2


def grid_oi(m2, n_dims, **over):
    """The opts_init of a phase-19 run: the 2-D model's (its aerosol, vt
    formula, geometric kernel, sstp_cond = sstp_coal = 10), on the grid of
    ``n_dims`` (3: GRID_N cubed cells of GRID_D; 1: GRID_N cells along x;
    0: the parcel), sedimentation as the grid has z."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    oi = tl.opts_init_t()
    oi.__dict__.update(m2.opts_init.__dict__)
    for a in "xyz":
        setattr(oi, "n" + a, 0)
        setattr(oi, "d" + a, 1.0)
        setattr(oi, a + "0", 0.0)
        setattr(oi, a + "1", 1.0)
    axes = {0: "", 1: "x", 3: "xyz"}[n_dims]
    for a in axes:
        setattr(oi, "n" + a, GRID_N)
        setattr(oi, "d" + a, GRID_D)
        setattr(oi, a + "1", GRID_N * GRID_D)
    oi.sd_conc = SD_CONC
    oi.n_sd_max = SD_CONC * GRID_N ** len(axes)
    oi.sstp_cond, oi.sstp_coal = SSTP_COND, SSTP_COAL
    oi.coal_switch = n_dims == 3
    oi.sedi_switch = n_dims == 3
    for k, v in over.items():
        setattr(oi, k, v)
    return oi


def grid_factory(oi, label):
    """The flat particles_t for a phase-19 configuration, pinned with
    factory(engine="flat"), so that F's rows keep their meaning (on the
    card the factory's pick for the 3-D grid is the dense front: phase
    22)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.particles import particles_t
    prt = tl.factory(tl.backend_t.CUDA, oi, device=DEVICE, engine="flat")
    check(type(prt) is particles_t,
          f"{label}: the factory gave {type(prt).__name__}, not particles_t")
    return prt


def grid_run(prt, opts, steps, fields, c):
    """``steps`` steps of step_sync(opts, th, rv, rhod, Cx, Cy, Cz) and
    step_async(opts) from the particles' state, the live count's changes in
    coalescence and at the walls summed on the device, and the SDs that
    cross the y walls.  Returns (seconds, {"coal", "walls", "y_wrap"},
    th, rv)."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence, transport
    th, rv = fields["th"], fields["rv"]
    cfg = prt.cfg
    flow = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
            for k in ("coal", "walls", "y_wrap")}
    real = {(coalescence, "coal"): coalescence.coal,
            (transport, "bcnd"): transport.bcnd}

    def coal(cfg_, state, *args, **kw):
        out = real[coalescence, "coal"](cfg_, state, *args, **kw)
        flow["coal"] += (out.n > 0).sum() - (state.n > 0).sum()
        return out

    def bcnd(cfg_, state, **kw):
        if cfg_.n_dims == 3:
            flow["y_wrap"] += ((state.n > 0) & ((state.y >= cfg_.y1)
                                                | (state.y < cfg_.y0))).sum()
        out = real[transport, "bcnd"](cfg_, state, **kw)
        flow["walls"] += (out.n > 0).sum() - (state.n > 0).sum()
        return out

    coalescence.coal, transport.bcnd = coal, bcnd
    kw = {"courant_" + k[1]: fields[k] for k in ("Cx", "Cy", "Cz")
          if k in fields}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            th, rv = prt.step_sync(opts, th, rv, fields["rhod"], **kw)
            prt.step_async(opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        coalescence.coal, transport.bcnd = real[coalescence, "coal"], \
            real[transport, "bcnd"]
    return secs, {k: int(v) for k, v in flow.items()}, th, rv


def grid_checks(label, prt, th, rv, totals0, flow, c):
    """Phase 19 (a) and (c)'s checks after a run: finite fields, water and
    dry mass conserved with the puddle (1e-3, 1e-4), the live count at
    the end the count at the start plus the changes in coalescence and at
    the walls."""
    check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
          f"{label}: non-finite th/rv")
    st = prt.state
    live = st.n > 0
    check(bool(torch.isfinite(st.rw2[live]).all()
               and (st.rw2[live] > 0).all()), f"{label}: bad rw2")
    water, dry = flat_totals(prt, rv, c)
    n_live = int(live.sum())
    dw = abs(water - totals0[0]) / totals0[0]
    dd = abs(dry - totals0[1]) / totals0[1]
    check(dw < 1e-3, f"{label}: water conservation off by {dw:.2e}")
    check(dd < 1e-4, f"{label}: dry-mass conservation off by {dd:.2e}")
    check(flow["coal"] <= 0 and flow["walls"] <= 0
          and n_live == totals0[2] + flow["coal"] + flow["walls"],
          f"{label}: SDs dropped: {totals0[2]} live at the start, {n_live} "
          f"at the end, changes {flow}")
    return {"water_rel_err": dw, "dry_rel_err": dd, "sds": n_live, **flow}


def grid_totals(prt, rv, c):
    water, dry = flat_totals(prt, rv, c)
    return water, dry, int((prt.state.n > 0).sum())


def grid3d_case(fields, m2, _ext, c, card, profile_on, err):
    """Phase 19 (a): the GMD case extruded to GRID_N cubed cells
    (grid3d_fields' ``fields`` and 2-D model ``m2``) at full width through
    the public API.  Returns its numbers, kernel F's at this shape among
    them."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    oi = grid_oi(m2, 3)
    t0 = time.perf_counter()
    prt = grid_factory(oi, "3-D")
    prt.init(fields["th"], fields["rv"], fields["rhod"], Cx=fields["Cx"],
             Cy=fields["Cy"], Cz=fields["Cz"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init = prt.state
    n_sd = int((init.n > 0).sum())
    print(f"3-D init: {n_sd} SDs in {prt.cfg.n_sd_max} slots on "
          f"{prt.cfg.n_cell} cells in {init_s:.1f} s (factory -> "
          f"particles_t.init) ({card})", flush=True)
    check(n_sd == SD_CONC * GRID_N ** 3, f"3-D: {n_sd} SDs at init")
    opts = tl.opts_t()
    opts.adve = opts.cond = opts.coal = opts.sedi = True
    totals0 = grid_totals(prt, fields["rv"], c)
    # the divergence on every y slab is the 2-D field's (courant_y adds
    # +0.1 - 0.1 in float32: a few ulps)
    prt.diag_vel_div()
    div3 = torch.as_tensor(prt.outbuf()).reshape(GRID_N, GRID_N, GRID_N)
    m2.prtcls.diag_vel_div()
    div2 = torch.as_tensor(m2.prtcls.outbuf()).reshape(GRID_N, 1, GRID_N)
    ddiv = float((div3 - div2).abs().max())
    check(ddiv <= 4 * 2.0 ** -23 * GRID_CY / prt.cfg.dt,
          f"3-D: diag_vel_div differs from the 2-D field's by {ddiv:.2e}")
    # the counted run: F once a step, no other kernel
    reset(_ext.KERNELS)
    secs, flow, th, rv = grid_run(prt, opts, GRID_STEPS, fields, c)
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    chk = grid_checks("3-D", prt, th, rv, totals0, flow, c)
    lost = collided(init, prt.state)
    print(f"3-D: {GRID_STEPS} steps from init in {secs:.2f} s; {chk}; "
          f"multiplicity lost to collisions {lost:.3e}; launches {launches} "
          f"({card})", flush=True)
    check(launches == {"cond_flat": GRID_STEPS},
          f"3-D: kernel F once a step expected, got {launches}")
    check(flow["y_wrap"] > 0, "3-D: no SD crossed the y walls")
    out = dict(chk, launches=launches["cond_flat"], init_s=init_s,
               vel_div_max_abs_diff=ddiv, collided=lost)
    # F against its plain version on what a full-width step gives it
    f_kw = capture(cond_ops, "cond_flat", lambda: grid_run(
        prt, opts, 1, dict(fields, th=th, rv=rv), c))
    t1 = time.perf_counter()
    check_form("(3-D)", f_kw, err)
    out["check_s"] = time.perf_counter() - t1
    # best of GRID_REPS reps of GRID_STEPS steps from init
    best = float("inf")
    for _ in range(GRID_REPS):
        prt.state = init
        totals = grid_totals(prt, fields["rv"], c)
        secs, flow, th, rv = grid_run(prt, opts, GRID_STEPS, fields, c)
        grid_checks("3-D", prt, th, rv, totals, flow, c)
        check(flow["y_wrap"] > 0, "3-D: no SD crossed the y walls")
        best = min(best, secs)
    out.update(ms_per_step=best / GRID_STEPS * 1e3,
               sd_updates_per_s=n_sd * GRID_STEPS / best)
    print(f"timing, 3-D: {out['ms_per_step']:.3f} ms/step, "
          f"{out['sd_updates_per_s']:.4e} SD-updates/s (best of {GRID_REPS} "
          f"reps of {GRID_STEPS} steps from init, {n_sd} SDs); init "
          f"{init_s:.1f} s ({card})", flush=True)
    row = form_row(f_kw, out["launches"], f"the 3-D run's {GRID_STEPS} "
                   "steps", err, name="cond_flat_3d", reps=GRID_KERNEL_REPS,
                   plain_reps=1)
    out.update(cond_flat_ms=row["ms"], cond_flat_plain_ms=row["plain_ms"],
               cond_flat_bound_ms=row["bound_ms"],
               cond_flat_bound_by=row["bound_by"])
    if profile_on:
        prt.state = init
        profile("3-D (a)", lambda: setattr(prt, "state", init),
                lambda k: grid_run(prt, opts, k, fields, c), card, steps=3)
    prt.state = None
    del prt, init, f_kw
    torch.cuda.empty_cache()
    return out


def parcel_rhod(steps):
    """The rising parcel's rhod at the start and after each of ``steps``
    steps: a dry-adiabatic hydrostatic ascent at PARCEL_W m/s from
    PARCEL_P0 (p^kappa = p0^kappa - g p1000^kappa z / (c_pd theta), T =
    theta (p / p1000)^kappa, rhod = p / (R_d T); the vapour's weight left
    out), float64 on the host."""
    from libcloudphxx_tpu_torch.common import constants as c
    kap = c.R_d / c.c_pd
    z = PARCEL_W * np.arange(steps + 1, dtype=np.float64)
    pk = PARCEL_P0 ** kap - c.g * c.p_1000 ** kap * z / (c.c_pd
                                                         * PARCEL_TH)
    p = pk ** (1.0 / kap)
    return p / (c.R_d * PARCEL_TH * (p / c.p_1000) ** kap)


PARCEL_FORMS = {
    "per cell": {},
    "exact, mixing": dict(exact_sstp_cond=True),
    "adaptive": dict(exact_sstp_cond=True, adaptive_sstp_cond=True,
                     sstp_cond_act=8),
}
# the modes whose forms run a cell on a thread-block cluster (F's and
# G-fixed's parcel forms)
PARCEL_CLUSTER_MODES = ("per cell", "exact, mixing")


def parcel_setup(m2, mode, turb, n_sd):
    """A rising parcel of ``n_sd`` SDs in PARCEL_FORMS' ``mode`` (with
    ``turb`` the SGS supersaturation on), initialised at the ascent's
    start: (prt, opts, the dissipation rate or None, the condensation
    wrapper's name, its kernel, th0, rv0, the state after init)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    over = dict(sd_conc=n_sd, n_sd_max=n_sd, **PARCEL_FORMS[mode])
    if turb:
        over.update(turb_cond_switch=True)
    prt = grid_factory(grid_oi(m2, 0, **over), f"parcel ({mode})")
    fname, kernel = form_of(prt.cfg, turb)
    th0 = torch.full((1,), PARCEL_TH, device=DEVICE)
    rv0 = torch.full((1,), PARCEL_RV, device=DEVICE)
    prt.init(th0, rv0, torch.full((1,), parcel_rhod(0)[0], device=DEVICE))
    opts = tl.opts_t()
    opts.cond = True
    opts.turb_cond = turb
    diss = torch.full((1,), LES_DISS, device=DEVICE) if turb else None
    return prt, opts, diss, fname, kernel, th0, rv0, prt.state


def check_repeat(label, kw):
    """Two launches of the form that the captured arguments ``kw`` run
    give the same bits (the cluster forms' cell sums add in a fixed
    order)."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    fname, kernel = kw_form(kw)
    f = getattr(cond_ops, fname)
    a, b = f(**kw), f(**kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"{kernel.name} {label}: two launches bitwise {same}", flush=True)
    check(same, f"{kernel.name} {label}: two launches differ")


def parcel_run(prt, opts, rhods, th0, rv0, diss=None):
    """The rising parcel's host loop: each step lowers rhod to the next of
    ``rhods`` and passes it to step_sync (var_rho).  Returns (seconds, RH
    after each step, total water a kg after each step, th, rv)."""
    from libcloudphxx_tpu_torch.common import constants as c
    th, rv = th0.clone(), rv0.clone()
    rh, water = [], []
    kw = {} if diss is None else {"diss_rate": diss}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in rhods:
        rhod = torch.full((1,), float(r), device=DEVICE)
        th, rv = prt.step_sync(opts, th, rv, rhod, **kw)
        prt.step_async(opts)
        st = prt.state
        rh.append(st.RH[0])
        water.append(rv[0].double() + 4.0 / 3 * c.pi * c.rho_w * (
            st.n.double() * st.rw2.double() ** 1.5).sum())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return secs, torch.stack(rh).double().cpu().numpy(), \
        torch.stack(water).cpu().numpy(), th, rv


def parcel_case(m2, _ext, c, card, err, turb):
    """Phase 19 (b): the rising adiabatic parcel, PARCEL_SD SDs, sstp_cond
    10, PARCEL_STEPS steps of 1 s at PARCEL_W m/s, in each of
    PARCEL_FORMS' modes (with ``turb`` the SGS supersaturation on: opts.
    turb_cond and a dissipation rate, PARCEL_TURB_STEPS steps).  Returns
    (the forms' kernel rows, {mode: numbers})."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    steps = PARCEL_TURB_STEPS if turb else PARCEL_STEPS
    rhods = parcel_rhod(steps)[1:]
    rows, out = [], {}
    for mode in PARCEL_FORMS:
        prt, opts, diss, fname, kernel, th0, rv0, init = parcel_setup(
            m2, mode, turb, PARCEL_SD)
        reset(_ext.KERNELS)
        secs, rh, water, th, rv = parcel_run(prt, opts, rhods, th0, rv0,
                                             diss)
        launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
        dwat = float(np.abs(water / water[0] - 1.0).max())
        label = f"parcel ({mode}{', turb_cond' if turb else ''})"
        ms = secs / steps * 1e3
        print(f"{label}: {steps} steps in {secs:.2f} s ({ms:.3f} ms/step); "
              f"RH peak {rh.max():.5f} at step "
              f"{int(rh.argmax()) + 1}, last {rh[-1]:.5f}; total water a kg "
              f"{water[0]:.6e}, max rel change {dwat:.2e}; th "
              f"{float(th[0]):.4f}, rv {float(rv[0]):.6e}; launches "
              f"{launches} ({card})", flush=True)
        check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
              f"{label}: non-finite th/rv")
        check(launches == {kernel.name: steps},
              f"{label}: {kernel.name} once a step expected, got {launches}")
        check(dwat < 1e-5, f"{label}: water a kg not conserved ({dwat:.2e})")
        if not turb:
            # the supersaturation peaks above cloud base and relaxes
            check(rh.max() > 1.0 and rh[-1] - 1.0 < 0.8 * (rh.max() - 1.0),
                  f"{label}: RH peak {rh.max()}, last {rh[-1]}")
        # the form against its plain version on what a step gives it
        prt.state = init
        kw_f = capture(cond_ops, fname, lambda: parcel_run(
            prt, opts, rhods[:2], th0, rv0, diss))
        check_form(f"({label})", kw_f, err)
        if mode in PARCEL_CLUSTER_MODES:
            check_repeat(label, kw_f)
        rows.append(form_row(kw_f, launches[kernel.name],
                             f"the {steps} steps of {label}", err))
        out[label] = dict(ms_per_step=secs / steps * 1e3,
                          rh_peak=float(rh.max()), rh_last=float(rh[-1]),
                          water_rel_change=dwat, launches=steps)
    return rows, out


def parcel_large_case(m2, _ext, card, err):
    """Phase 19 (b): the rising parcel with PARCEL_SD_LARGE SDs,
    PARCEL_LARGE_STEPS steps through the public API in each of
    PARCEL_CLUSTER_MODES (F's and G-fixed's cluster forms at 8 slots a
    thread): finite th and rv, the water a kg kept, the form once a step,
    the form against its plain version and bitwise from launch to launch
    on a step's arguments, timed.  Returns (the forms' kernel rows,
    {mode: numbers})."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    steps = PARCEL_LARGE_STEPS
    rhods = parcel_rhod(steps)[1:]
    rows, out = [], {}
    for mode in PARCEL_CLUSTER_MODES:
        prt, opts, _, fname, kernel, th0, rv0, init = parcel_setup(
            m2, mode, False, PARCEL_SD_LARGE)
        reset(_ext.KERNELS)
        secs, _, water, th, rv = parcel_run(prt, opts, rhods, th0, rv0)
        launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
        dwat = float(np.abs(water / water[0] - 1.0).max())
        label = f"parcel of {PARCEL_SD_LARGE} SDs ({mode})"
        print(f"{label}: {steps} steps in {secs:.3f} s "
              f"({secs / steps * 1e3:.3f} ms/step); total water a kg max "
              f"rel change {dwat:.2e}; th {float(th[0]):.4f}, rv "
              f"{float(rv[0]):.6e}; launches {launches} ({card})",
              flush=True)
        check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
              f"{label}: non-finite th/rv")
        check(launches == {kernel.name: steps},
              f"{label}: {kernel.name} once a step expected, got {launches}")
        check(dwat < 1e-5, f"{label}: water a kg not conserved ({dwat:.2e})")
        prt.state = init
        kw_f = capture(cond_ops, fname, lambda: parcel_run(
            prt, opts, rhods[:1], th0, rv0))
        check_form(f"({label})", kw_f, err)
        check_repeat(label, kw_f)
        rows.append(form_row(kw_f, launches[kernel.name],
                             f"the {steps} steps of {label}", err,
                             name=f"{kernel.name}_{PARCEL_SD_LARGE}"))
        out[label] = dict(ms_per_step=secs / steps * 1e3,
                          water_rel_change=dwat, launches=steps,
                          kernel_ms=rows[-1]["ms"])
        prt.state = None
        del prt, init, kw_f
        torch.cuda.empty_cache()
    return rows, out


def parcel_floor(m2, card):
    """Phase 19 (b): a launch of each cluster form (PARCEL_CLUSTER_MODES,
    with and without turb_cond) on a parcel of one SD, on the arguments
    its first step gives it: the form's latency floor, one droplet's
    chain of root finds over the sstp_cond substeps.  Returns {kernel
    name: ms a launch}."""
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    out = {}
    for mode in PARCEL_CLUSTER_MODES:
        for turb in (False, True):
            prt, opts, diss, fname, kernel, th0, rv0, _ = parcel_setup(
                m2, mode, turb, 1)
            kw_f = capture(cond_ops, fname, lambda: parcel_run(
                prt, opts, parcel_rhod(1)[1:], th0, rv0, diss))
            f = getattr(cond_ops, fname)
            out[kernel.name] = time_cuda(lambda: f(**kw_f), KERNEL_REPS)
            print(f"kernel {kernel.name}: {out[kernel.name]:.4f} ms a "
                  f"launch on 1 SD, the latency floor ({card})", flush=True)
    return out


def lgrngn_cond_case(m2, _ext, card):
    """Phase 19 (b): the reference's lgrngn_cond.py parcel
    (tests/test_lgrngn_parcel.py:54-95) in float32 through kernel F's
    parcel form, sstp_cond 10, var-p and const-p: 40 steps at 2% vapour
    with its th and rv end-state gates (its supersaturation gate, |ss| <
    4.5e-3 %, is printed: float32's residual supersaturation is not
    held to it), then 40 at 0.2%.  The evaporation
    leg returns the condensed vapour within PARCEL_RV_RETURN: each of its
    80 x 10 substeps rounds rv (~0.02) once in float32, half an ulp
    (9.3e-10) each, so at most 800 x 9.3e-10 = 7.5e-7 (the reference's
    1e-9 is a float64 gate)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.common import theta_dry
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    out = {}
    for constp in (False, True):
        oi = grid_oi(m2, 0, sd_conc=100, n_sd_max=100, RH_max=0.999,
                     sstp_cond=10)
        oi.dry_distros = {(0.61, 0.0): lambda lnr: 60e6 * np.exp(
            -(np.asarray(lnr) - np.log(0.02e-6)) ** 2 / 2 / np.log(1.4) ** 2)
            / np.log(1.4) / np.sqrt(2 * np.pi)}
        rhod, th, rv = 1.0, 300.0, 0.02
        p = None
        if constp:
            T0 = theta_dry.T(f64(th), f64(rhod))
            p = torch.full((1,), float(theta_dry.p(f64(rhod), f64(rv), T0)),
                           device=DEVICE)
            th = float(theta_dry.dry2std(f64(th), f64(rv)))
            oi.const_p, oi.th_dry = True, False
        prt = grid_factory(oi, "lgrngn_cond parcel")
        full = lambda v: torch.full((1,), v, device=DEVICE)
        th_t, rv_t, rhod_t = full(th), full(rv), full(rhod)
        prt.init(th_t, rv_t, rhod_t, p)
        opts = tl.opts_t()
        opts.cond = True
        reset(_ext.KERNELS)
        for _ in range(40):
            th_t, rv_t = prt.step_sync(opts, th_t, rv_t)
            prt.step_async(opts)
        prt.diag_RH()
        ss = (prt.outbuf()[0] - 1) * 100
        th_c, rv_c = float(th_t[0]), float(rv_t[0])
        condensed = rv - rv_c
        rv_t = full(0.002)
        start = float(rv_t[0])
        for _ in range(40):
            th_t, rv_t = prt.step_sync(opts, th_t, rv_t)
            prt.step_async(opts)
        ret = abs(float(rv_t[0]) - start - condensed)
        exp_th, exp_rv = (306.9, 1.628e-2) if constp else (307.78, 1.7e-2)
        launches = _ext.COND_FLAT_PARCEL.launches
        label = f"lgrngn_cond parcel ({'const' if constp else 'var'}-p)"
        print(f"{label}, float32: ss {ss:.2e} %, th {th_c:.4f} (expected "
              f"{exp_th}), rv {rv_c:.6e} (expected {exp_rv}), the "
              f"evaporation leg's rv return off by {ret:.2e} (gate "
              f"{PARCEL_RV_RETURN:.1e}); {launches} launches of "
              f"cond_flat_parcel ({card})", flush=True)
        check(abs(th_c - exp_th) < 1e-4 * exp_th
              and abs(rv_c - exp_rv) < 1e-3 * exp_rv,
              f"{label}: the reference's th and rv end-state gates")
        check(ret < PARCEL_RV_RETURN, f"{label}: rv return off by {ret:.2e}")
        check(launches == 80, f"{label}: {launches} launches of F's parcel "
              "form, 80 expected")
        out[label] = dict(ss=ss, th=th_c, rv=rv_c, rv_return=ret)
    return out


def grid1d_case(m2, _ext, c, card, err):
    """Phase 19 (c): x alone, GRID_N cells of GRID_D, the GMD surface air,
    a uniform courant_x of GRID1D_CX, periodic, GRID1D_STEPS steps of
    condensation and advection through kernel F, with the conservation
    checks and the SDs wrapping."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    prt = grid_factory(grid_oi(m2, 1), "1-D")
    n = GRID_N
    fields = dict(th=m2.th[:, 0].contiguous(), rv=m2.rv[:, 0].contiguous(),
                  rhod=m2.rhod[:, 0].contiguous(),
                  Cx=torch.full((n + 1,), GRID1D_CX, device=DEVICE))
    prt.init(fields["th"], fields["rv"], fields["rhod"], Cx=fields["Cx"])
    x0 = prt.state.x
    opts = tl.opts_t()
    opts.adve = opts.cond = True
    totals0 = grid_totals(prt, fields["rv"], c)
    reset(_ext.KERNELS)
    secs, flow, th, rv = grid_run(prt, opts, GRID1D_STEPS, fields, c)
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    chk = grid_checks("1-D", prt, th, rv, totals0, flow, c)
    st = prt.state
    live = st.n > 0
    wrapped = int((live & (st.x < x0)).sum())
    print(f"1-D: {GRID1D_STEPS} steps in {secs:.2f} s; {chk}; {wrapped} SDs "
          f"wrapped across x; launches {launches} ({card})", flush=True)
    check(launches == {"cond_flat": GRID1D_STEPS},
          f"1-D: kernel F once a step expected, got {launches}")
    check(wrapped > 0 and chk["sds"] == totals0[2],
          "1-D: no SD wrapped, or SDs lost")
    return dict(chk, launches=GRID1D_STEPS, wrapped=wrapped,
                ms_per_step=secs / GRID1D_STEPS * 1e3)


def grid_phase(Kinematic2D, _ext, c, card, profile_on):
    """Phase 19 (the module docstring): the 3-D grid at full width, the
    rising parcel in F's and G's parcel forms (and their turb_cond forms),
    the reference's lgrngn_cond parcel in float32, the 1-D grid.  Returns
    (the parcel forms' kernel rows, {case: numbers}, kernel F's error on
    the 3-D shape)."""
    err = {}
    out = {}
    t = time.perf_counter()
    fields, m2 = grid3d_fields(Kinematic2D)
    out["3-D"] = grid3d_case(fields, m2, _ext, c, card, profile_on, err)
    del fields
    print(f"phase 19 (a): {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    rows, out["parcel"] = parcel_case(m2, _ext, c, card, err, turb=False)
    turb_rows, out["parcel, turb_cond"] = parcel_case(m2, _ext, c, card, err,
                                                      turb=True)
    rows += turb_rows
    large_rows, out["parcel, large"] = parcel_large_case(m2, _ext, card, err)
    rows += large_rows
    out["parcel, 1 SD"] = parcel_floor(m2, card)
    for row in rows:                # the cluster forms' latency floor
        if row["name"] in out["parcel, 1 SD"]:
            row["floor_ms"] = out["parcel, 1 SD"][row["name"]]
    out["lgrngn_cond"] = lgrngn_cond_case(m2, _ext, card)
    print(f"phase 19 (b): {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["1-D"] = grid1d_case(m2, _ext, c, card, err)
    print(f"phase 19 (c): {time.perf_counter() - t:.1f} s", flush=True)
    return rows, out, err.get("cond_flat", 0.0)


# ------------------------------------------------------------------ phase 20
def ice_fields(Kinematic2D):
    """Phase 20's air at NX x NZ cells of the GMD geometry: rows from
    ICE_T_BOTTOM at the bottom to ICE_T_TOP at the top, p hydrostatic from
    ICE_P0, rv = r_vs(T, p) (saturated over water), th = T / exner(p) and
    rhod = theta_std.rhod(p, th, rv), as tests/test_lgrngn_ice.py:101-115
    builds them; the GMD stream function's G-weighted courants (phase 18's
    flow) for kernel A's MPDATA with G = rhod, and divided by rhod at the
    cell centres and z faces for the SDs (the model's rule, kinematic_2d.py
    make_gc).  Returns the fields (nx, nz) and the 2-D model whose
    opts_init the runs copy."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_std
    from libcloudphxx_tpu_torch.common import constants as c
    from libcloudphxx_tpu_torch.models.kinematic_2d import Setup, make_gc
    s = Setup()
    dx, dz = s.X / NX, s.Z / NZ
    lapse = (ICE_T_BOTTOM - ICE_T_TOP) / s.Z

    def air(z):
        T = torch.tensor(ICE_T_BOTTOM - lapse * z, dtype=torch.float64)
        p = ICE_P0 * (T / ICE_T_BOTTOM) ** (c.g / (c.R_d * lapse))
        rv = const_cp.r_vs(T, p)
        th = T / theta_std.exner(p)
        return th, rv, theta_std.rhod(p, th, rv)

    th, rv, rhod = air((np.arange(NZ) + 0.5) * dz)
    rhod_z = air(np.arange(NZ + 1) * dz)[2]
    gc_x, gc_z = make_gc(s, NX, NZ, dx, dz)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=DEVICE)
    col = lambda a: dev(np.broadcast_to(a.numpy(), (NX, NZ)))
    m2 = Kinematic2D(nx=NX, nz=NZ, sd_conc=1, n_sd_max=NX * NZ,
                     device=DEVICE)
    return dict(th=col(th), rv=col(rv), rhod=col(rhod), G=col(rhod),
                gc_x=dev(gc_x), gc_z=dev(gc_z),
                Cx=dev(gc_x / rhod.numpy()[None, :]),
                Cz=dev(gc_z / rhod_z.numpy()[None, :])), m2


def ice_oi(m2, **over):
    """A phase-20 opts_init: the GMD model's (bench.py's: vt formula,
    geometric kernel, sstp_cond = sstp_coal = 10) with its aerosol keyed
    (kappa, ICE_RD_INSOL), an insoluble core as in tests/test_lgrngn_ice.
    py:27, and ice on."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    oi = tl.opts_init_t()
    oi.__dict__.update(m2.opts_init.__dict__)
    oi.dry_distros = {(m2.setup.kappa, ICE_RD_INSOL):
                      m2.setup.lognormal_lnrd}
    oi.sd_conc, oi.n_sd_max = SD_CONC, SD_CONC * NX * NZ
    oi.sstp_cond, oi.sstp_coal = SSTP_COND, SSTP_COAL
    oi.coal_switch = oi.sedi_switch = oi.ice_switch = True
    for k, v in over.items():
        setattr(oi, k, v)
    return oi


def ice_step(prt, opts, f, th, rv, diss=None):
    """One step of phase 20's host loop: kernel A's MPDATA of th and rv,
    then step_sync(opts, th, rv, rhod, Cx, Cz[, diss_rate]) and
    step_async(opts)."""
    from libcloudphxx_tpu_torch.models import mpdata
    th = mpdata.advect(th, f["gc_x"], f["gc_z"], f["G"], 2, False)
    rv = mpdata.advect(rv, f["gc_x"], f["gc_z"], f["G"], 2, False)
    kw = {} if diss is None else {"diss_rate": diss}
    th, rv = prt.step_sync(opts, th, rv, f["rhod"], courant_x=f["Cx"],
                           courant_z=f["Cz"], **kw)
    prt.step_async(opts)
    return th.reshape(NX, NZ), rv.reshape(NX, NZ)


def sd_ice(state):
    """The SDs' ice [kg] (lgrngn/ice.ice_mass), float64, a device scalar."""
    from libcloudphxx_tpu_torch.lgrngn import ice
    return (state.n.double() * ice.ice_mass(
        state.ice_a.double(), state.ice_c.double(),
        state.ice_rho.double())).sum()


def sd_water(state):
    """The SDs' liquid and ice [kg], float64, a device scalar."""
    from libcloudphxx_tpu_torch.common import constants as c
    return 4.0 / 3 * c.pi * c.rho_w * (state.n.double()
                                       * state.rw2.double() ** 1.5).sum() \
        + sd_ice(state)


def ice_run(prt, opts, f, th, rv, steps, diss=None, watch=False):
    """``steps`` of ice_step; with ``watch`` also marking the SDs whose
    rw2 a coalescence call changed (a collector of droplets) and summing
    the water the calls changed: the coalescence ignores the ice, as the
    JAX package's does (a frozen SD that loses multiplicity loses its ice;
    one that collects drops holds liquid and ice).  The watch adds two
    float64 sums over the slots and a compare a step, so the timed runs
    go without it.  Returns (seconds, th, rv, the marks or None, the water
    [kg] coalescence changed or None)."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence
    real = coalescence.coal
    collected = coal_dw = None
    if watch:
        collected = torch.zeros(prt.cfg.n_sd_max, dtype=torch.bool,
                                device=DEVICE)
        coal_dw = torch.zeros((), dtype=torch.float64, device=DEVICE)

        def coal(cfg_, state, *args, **kw):
            out = real(cfg_, state, *args, **kw)
            collected.logical_or_(out.rw2 != state.rw2)
            coal_dw.add_(sd_water(out) - sd_water(state))
            return out

        coalescence.coal = coal
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            th, rv = ice_step(prt, opts, f, th, rv, diss)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        coalescence.coal = real
    return (secs, th, rv, collected,
            None if coal_dw is None else float(coal_dw))


def ice_water(prt, rv, c):
    """Total water [kg] through the public API: vapour, liquid and the
    puddle's liquid (flat_totals), the ice and the puddle's ice."""
    from libcloudphxx_tpu_torch.lgrngn import ice
    water, _ = flat_totals(prt, rv, c)
    n, a, cc, rho = (prt.get_attr(k).astype(np.float64)
                     for k in ("n", "ice_a", "ice_c", "ice_rho"))
    return (water + float(np.sum(n * ice.ice_mass(a, cc, rho)))
            + prt.diag_puddle()["ice_mass"])


def ice_checks(label, prt, th, rv, water0, c, collected, coal_dw):
    """Phase 20's checks after a run: finite fields, SDs frozen, frozen SDs
    with ice_a * ice_c > 0 and, unless a coalescence made them collect
    liquid (``collected``: the JAX package's coalescence moves no ice, so
    such an SD holds both; ROADMAP.md, "Known behaviours"), rw2 0, the
    total water (ice_water) conserved within ICE_WATER_GATE, beside the
    ``coal_dw`` kg the coalescence changed.  After an unwatched run
    (``collected`` None: ice_run) the rw2 check is left out, and the
    coalescence's change, 4.5e-10 of the water in the watched run, is
    inside the gate."""
    st = prt.state
    live = st.n > 0
    frozen = live & (st.ice_a > 0)
    check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
          f"ice {label}: non-finite th/rv")
    check(bool(torch.isfinite(st.rw2[live]).all()
               and torch.isfinite(st.ice_a[live]).all()
               and torch.isfinite(st.ice_c[live]).all()),
          f"ice {label}: non-finite rw2 or axes")
    n_frozen = int(frozen.sum())
    check(n_frozen > 0, f"ice {label}: no SD froze")
    check(bool((st.ice_a[frozen] * st.ice_c[frozen] > 0).all()),
          f"ice {label}: a flat spheroid")
    out = {"frozen": n_frozen, "live": int(live.sum()),
           "ice_kg": float(sd_ice(st)), "water_kg": water0}
    if collected is not None:
        check(bool((st.rw2[frozen & ~collected] == 0).all()),
              f"ice {label}: a frozen SD with liquid it did not collect")
        out.update(frozen_collectors=int((frozen & collected).sum()),
                   coal_water_rel=coal_dw / water0)
    dw = abs(ice_water(prt, rv, c) - water0 - (coal_dw or 0.0)) / water0
    check(dw < ICE_WATER_GATE,
          f"ice {label}: water conservation off by {dw:.2e}")
    out["water_rel_err"] = dw
    return out


def ice_melt(label, prt, f, th, rv, c):
    """Every cell warmed by ICE_WARM K (th scaled so that the th_dry
    closure's T rises by it) for one step of ice_nucl alone: all the ice
    melts, each SD's liquid the mass of its ice, rho_i V_i = rho_w V_w to
    1e-5."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn import ice
    st = prt._tpr_impl()
    frozen = (st.n > 0) & (st.ice_a > 0)
    m_ice = ice.ice_mass(st.ice_a.double(), st.ice_c.double(),
                         st.ice_rho.double())[frozen]
    T = st.T.reshape(NX, NZ)
    th_w = th * ((T + ICE_WARM) / T) ** (1.0 - c.R_d / c.c_pd)
    opts = tl.opts_t()
    opts.cond = opts.coal = opts.sedi = opts.adve = False
    opts.ice_nucl = True
    prt.step_sync(opts, th_w, rv, f["rhod"])
    prt.step_async(opts)
    st = prt.state
    m_liq = (4.0 / 3 * c.pi * c.rho_w * st.rw2.double() ** 1.5)[frozen]
    rel = float(((m_liq - m_ice).abs() / m_ice).max())
    left = int((st.ice_a > 0).sum())
    print(f"ice {label}, warmed by {ICE_WARM} K: {int(frozen.sum())} frozen "
          f"SDs melted, {left} left; rho_w V_w against rho_i V_i rel "
          f"{rel:.2e}", flush=True)
    check(left == 0 and rel <= 1e-5, f"ice {label}: melting left ice or "
          f"changed the mass (rel {rel:.2e})")
    return rel


def ice_grid_case(label, m2, _ext, c, card, f, err, profile_on, timed,
                  **over):
    """Phase 20 (a), (b), (d): the public API at full width with the ice
    (``over``: opts_init's time_dep_ice_nucl, turb_cond_switch), kernel A
    twice and F's ice form once a step (its turb_cond form under
    turb_cond); its checks, the form against its plain version on what a
    step gives it, the melt; with ``timed`` the best of TIME_REPS reps of
    ICE_STEPS steps from init.  Returns (numbers, the form's captured
    arguments, its launches)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.particles import particles_t
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    turb = bool(over.get("turb_cond_switch"))
    prt = tl.factory(tl.backend_t.CUDA, ice_oi(m2, **over), device=DEVICE)
    check(type(prt) is particles_t, f"ice {label}: the factory gave "
          f"{type(prt).__name__}, not particles_t")
    fname, kernel = form_of(prt.cfg, turb)
    t0 = time.perf_counter()
    prt.init(f["th"], f["rv"], f["rhod"], Cx=f["Cx"], Cz=f["Cz"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init = prt.state
    opts = tl.opts_t()
    opts.adve = opts.cond = opts.coal = opts.sedi = opts.ice_nucl = True
    opts.turb_cond = turb
    diss = torch.full((NX, NZ), LES_DISS, device=DEVICE) if turb else None
    steps = ICE_TURB_STEPS if turb else ICE_STEPS
    water0 = ice_water(prt, f["rv"], c)
    reset(_ext.KERNELS)
    secs, th, rv, coll, cdw = ice_run(prt, opts, f, f["th"], f["rv"],
                                      steps, diss, watch=True)
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    chk = ice_checks(label, prt, th, rv, water0, c, coll, cdw)
    n_sd = int((init.n > 0).sum())
    print(f"ice {label}: {n_sd} SDs, init {init_s:.1f} s; {steps} steps "
          f"from init in {secs:.2f} s ({secs / steps * 1e3:.3f} ms/step); "
          f"{chk}; launches {launches} ({card})", flush=True)
    check(launches == {"mpdata": 2 * steps, kernel.name: steps},
          f"ice {label}: kernel A twice and {kernel.name} once a step "
          f"expected, got {launches}")
    out = dict(chk, launches=steps, init_s=init_s, sds=n_sd,
               counted_ms_per_step=secs / steps * 1e3)
    # the form against its plain version on what a step gives it
    f_kw = capture(cond_ops, fname,
                   lambda: ice_step(prt, opts, f, th, rv, diss))
    check_form(f"(ice {label})", f_kw, err)
    st = prt.state
    out["melt_rel_err"] = ice_melt(label, prt, f, st.th.reshape(NX, NZ),
                                   st.rv.reshape(NX, NZ), c)
    if timed:
        best, dws = float("inf"), []
        for _ in range(TIME_REPS):
            prt.state = init
            w0 = ice_water(prt, f["rv"], c)
            secs, th, rv, _, _ = ice_run(prt, opts, f, f["th"], f["rv"],
                                         steps, diss)
            dws.append(ice_checks(label, prt, th, rv, w0, c, None,
                                  None)["water_rel_err"])
            best = min(best, secs)
        out.update(ms_per_step=best / steps * 1e3,
                   sd_updates_per_s=n_sd * steps / best, rep_water_rel=dws)
        print(f"timing, ice {label}: {out['ms_per_step']:.3f} ms/step, "
              f"{out['sd_updates_per_s']:.4e} SD-updates/s (best of "
              f"{TIME_REPS} reps of {steps} steps from init; water rel err "
              f"by rep {', '.join(f'{d:.2e}' for d in dws)}) ({card})",
              flush=True)
        if profile_on:
            profile(f"ice {label}", lambda: setattr(prt, "state", init),
                    lambda k: ice_run(prt, opts, f, f["th"], f["rv"], k,
                                      diss), card, steps=10)
    prt.state = None
    del prt, init
    torch.cuda.empty_cache()
    return out, f_kw, steps


def ice_parcel_fields(T0, p0, rv_scale=1.0):
    """A parcel at T0 and p0: rv = rv_scale r_vs, th = T0 / exner(p0),
    rhod = theta_std.rhod(p0, th, rv) (tests/test_lgrngn_ice.py:101-115),
    as (1,) tensors."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_std
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    rv = rv_scale * float(const_cp.r_vs(f64(T0), f64(p0)))
    th = T0 / float(theta_std.exner(f64(p0)))
    rhod = float(theta_std.rhod(f64(p0), f64(th), f64(rv)))
    full = lambda v: torch.full((1,), v, device=DEVICE)
    return full(th), full(rv), full(rhod)


def ice_parcel_oi(**over):
    """tests/test_lgrngn_ice.py's opts_init: 0.61 with an insoluble core
    of 1e-7 m, no coalescence or sedimentation, with ice."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    oi = tl.opts_init_t()
    oi.dry_distros = {(0.61, ICE_RD_INSOL): lambda lnr: 60e6 * np.exp(
        -(np.asarray(lnr) - np.log(0.02e-6)) ** 2 / 2 / np.log(1.4) ** 2)
        / np.log(1.4) / np.sqrt(2 * np.pi)}
    oi.coal_switch = oi.sedi_switch = False
    oi.RH_max, oi.dt, oi.sd_conc, oi.n_sd_max = 0.999, 1.0, 64, 64
    oi.ice_switch = True
    for k, v in over.items():
        setattr(oi, k, v)
    return oi


def ice_parcel_case(_ext, c, card, err):
    """Phase 20 (c): tests/test_lgrngn_ice.py's reference setup (243 K,
    800 hPa, 100 SDs, dt 0.1, RH_max 0.95, ICE_PARCEL_STEPS steps),
    singular and time-dependent, with its gates (no NaN, rv >= 0, the ice
    mixing ratio >= 0), F's parcel ice form once a step; the same with
    turb_cond over ICE_PARCEL_TURB_STEPS (the parcel ice form's turb_cond
    form).  Nothing freezes there: at 243 K no SD's T_freeze is reached,
    so these runs hold the forms on liquid alone.  The frozen SDs' runs
    are ice_aspect_case's, and the forms' rows come from them.  Returns
    ({form: (its captured arguments, launches, label)}, numbers)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    forms, out = {}, {}
    for label, over, steps in (
            ("singular", {}, ICE_PARCEL_STEPS),
            ("time-dependent", dict(time_dep_ice_nucl=True),
             ICE_PARCEL_STEPS),
            ("singular, turb_cond", dict(turb_cond_switch=True),
             ICE_PARCEL_TURB_STEPS)):
        turb = "turb_cond" in label
        prt = tl.factory(tl.backend_t.CUDA, ice_parcel_oi(
            dt=0.1, sd_conc=100, n_sd_max=100, RH_max=0.95, **over),
            device=DEVICE)
        fname, kernel = form_of(prt.cfg, turb)
        th, rv, rhod = ice_parcel_fields(243.0, 80000.0)
        prt.init(th, rv, rhod)
        opts = tl.opts_t()
        opts.cond = opts.ice_nucl = True
        opts.turb_cond = turb
        kw = {"diss_rate": torch.full((1,), LES_DISS, device=DEVICE)} \
            if turb else {}
        reset(_ext.KERNELS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            th, rv = prt.step_sync(opts, th, rv, rhod, **kw)
            prt.step_async(opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
        prt.diag_all()
        prt.diag_ice_mix_ratio()
        ri = float(prt.outbuf()[0])
        n_frozen = int((prt.get_attr("ice_a") > 0).sum())
        name = f"parcel ({label})"
        print(f"ice {name}: {steps} steps in {secs:.2f} s "
              f"({secs / steps * 1e3:.3f} ms/step); ice mixing ratio "
              f"{ri:.4e}, {n_frozen} frozen, rv {float(rv[0]):.6e}, th "
              f"{float(th[0]):.4f}; launches {launches} ({card})",
              flush=True)
        check(np.isfinite(ri) and ri >= 0 and bool(torch.isfinite(rv).all())
              and float(rv[0]) >= 0, f"ice {name}: the reference's gates")
        check(launches == {kernel.name: steps},
              f"ice {name}: {kernel.name} once a step expected, got "
              f"{launches}")
        kw_f = capture(cond_ops, fname, lambda: (
            prt.step_sync(opts, th, rv, rhod, **kw), prt.step_async(opts)))
        check_form(f"(ice {name})", kw_f, err)
        out[name] = dict(ms_per_step=secs / steps * 1e3, ice_mix_ratio=ri,
                         frozen=n_frozen, launches=steps)
    for turb in (False, True):
        name, res, kw_f = ice_aspect_case(_ext, card, err, turb)
        out[f"aspect{', turb_cond' if turb else ''}"] = res
        forms[kw_form(kw_f)[1].name] = (
            kw_f, ICE_ASPECT_STEPS, f"the {ICE_ASPECT_STEPS} steps of {name}")
    return forms, out


def ice_aspect_case(_ext, card, err, turb):
    """tests/test_lgrngn_ice.py:165-216's aspect-ratio run: prolate
    spheroids (a 2 um, c 6 um) frozen by hand in a parcel at 250 K and
    RH 1.05, ICE_ASPECT_STEPS steps: both axes grow, c/a relaxes toward
    1, rv falls, th rises.  With ``turb`` its turb_cond copy (diss_rate
    LES_DISS), where every other SD stays liquid, so that the droplets'
    growth at RH plus ssp and the deposition share the cell.  F's parcel
    ice form (its turb_cond form) counted once a step, and held against
    its plain version on a step where the ice grows.  Returns (the run's
    name, its numbers, the form's captured arguments)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    name = f"parcel (aspect ratio{', turb_cond' if turb else ''})"
    prt = tl.factory(tl.backend_t.CUDA, ice_parcel_oi(
        sstp_cond=2, turb_cond_switch=turb), device=DEVICE)
    fname, kernel = form_of(prt.cfg, turb)
    th0, rv0, rhod = ice_parcel_fields(250.0, 80000.0, rv_scale=1.05)
    prt.init(th0, rv0, rhod)
    st = prt.state
    hand = st.n > 0
    if turb:
        hand &= torch.arange(hand.numel(), device=DEVICE) % 2 == 0
    prt.state = dataclasses.replace(
        st, ice_a=torch.where(hand, 2e-6, st.ice_a),
        ice_c=torch.where(hand, 6e-6, st.ice_c),
        ice_rho=torch.where(hand, 916.8, st.ice_rho),
        rw2=torch.where(hand, 0.0, st.rw2))
    opts = tl.opts_t()
    opts.cond = opts.ice_nucl = True
    opts.turb_cond = turb
    kw = {"diss_rate": torch.full((1,), LES_DISS, device=DEVICE)} \
        if turb else {}
    th, rv = th0, rv0
    reset(_ext.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ICE_ASPECT_STEPS):
        th, rv = prt.step_sync(opts, th, rv, **kw)
        prt.step_async(opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    st = prt.state
    a1, c1 = st.ice_a[hand], st.ice_c[hand]
    ratio = c1 / a1
    liquid = (st.n > 0) & ~hand
    rw = f"; liquid SDs' rw {float(st.rw2[liquid].sqrt().min()):.3e}-" \
        f"{float(st.rw2[liquid].sqrt().max()):.3e}" if turb else ""
    print(f"ice {name}: {ICE_ASPECT_STEPS} steps in {secs:.2f} s "
          f"({secs / ICE_ASPECT_STEPS * 1e3:.3f} ms/step), "
          f"{int(hand.sum())} frozen by hand; a {float(a1.min()):.3e}-"
          f"{float(a1.max()):.3e}, c/a {float(ratio.min()):.4f}-"
          f"{float(ratio.max()):.4f} (from 3){rw}; rv {float(rv0[0]):.6e} "
          f"-> {float(rv[0]):.6e}, th {float(th0[0]):.4f} -> "
          f"{float(th[0]):.4f}; launches {launches} ({card})", flush=True)
    check(bool((a1 > 2e-6).all() and (c1 > 6e-6).all()
               and (ratio < 3.0).all() and (ratio > 1.0).all())
          and float(rv[0]) < float(rv0[0]) and float(th[0]) > float(th0[0]),
          f"ice {name}: the axes' growth, c/a, rv or th")
    check(launches == {kernel.name: ICE_ASPECT_STEPS},
          f"ice {name}: {kernel.name} once a step expected, got {launches}")
    # the form where the ice grows, against its plain version
    kw_f = capture(cond_ops, fname, lambda: (
        prt.step_sync(opts, th, rv, **kw), prt.step_async(opts)))
    check(int(((kw_f["ice"][0] > 0) & (kw_f["wgt"] > 0)).sum())
          == int(hand.sum()), f"ice {name}: the captured step's frozen SDs")
    check_form(f"(ice {name})", kw_f, err)
    return name, dict(ms_per_step=secs / ICE_ASPECT_STEPS * 1e3,
                      frozen=int(hand.sum()), c_over_a_max=float(ratio.max()),
                      a_max=float(a1.max()), launches=ICE_ASPECT_STEPS), kw_f


def ice_phase(Kinematic2D, _ext, c, card, profile_on):
    """Phase 20 (the module docstring): ice through the public API on the
    flat engine.  Returns (F's four ice forms' kernel rows, {case:
    numbers})."""
    f, m2 = ice_fields(Kinematic2D)
    err, out, rows = {}, {}, []
    forms = {}
    for label, over, timed in (("(a)", {}, True),
                               ("(b) time-dependent",
                                dict(time_dep_ice_nucl=True), False),
                               ("(d) turb_cond",
                                dict(turb_cond_switch=True), False)):
        t_case = time.perf_counter()
        res, f_kw, launches = ice_grid_case(label, m2, _ext, c, card, f, err,
                                            profile_on, timed, **over)
        out[label] = res
        name = kw_form(f_kw)[1].name
        if name not in forms:
            forms[name] = (f_kw, launches, f"the {launches} steps of "
                           f"{label}")
        print(f"phase 20 {label}: {time.perf_counter() - t_case:.1f} s",
              flush=True)
    t_case = time.perf_counter()
    parcel_forms, out["parcel"] = ice_parcel_case(_ext, c, card, err)
    forms.update(parcel_forms)
    print(f"phase 20 (c): {time.perf_counter() - t_case:.1f} s", flush=True)
    for name in ("cond_flat_ice", "cond_flat_ice_turb",
                 "cond_flat_parcel_ice", "cond_flat_parcel_ice_turb"):
        check(name in forms, f"phase 20: {name} was not on a path")
        f_kw, launches, where = forms[name]
        rows.append(form_row(f_kw, launches, where, err))
    return rows, out


# ------------------------------------------------------------------ phase 21
def sulfur(m):
    """The model's sulfur [mol]: SO2 gas (its mixing ratio times each
    cell's dry air), dissolved S(IV) and S(VI) (n times each SD's mass),
    and the puddle's, in float64."""
    from libcloudphxx_tpu_torch.common import chem as cc
    from libcloudphxx_tpu_torch.lgrngn.chemistry import S_VI, SO2
    st = m.prtcls.state
    air = (st.rhod.double() * st.dv.double())
    gas = float((air * m.chem_gases[cc.chem_species_t.SO2].reshape(-1)
                 .double()).sum()) / cc.M_SO2
    n = st.n.double()
    aq = float((n * st.chem[SO2].double()).sum()) / cc.M_SO2_H2O \
        + float((n * st.chem[S_VI].double()).sum()) / cc.M_H2SO4
    pud = float(st.puddle[SO2]) / cc.M_SO2_H2O \
        + float(st.puddle[S_VI]) / cc.M_H2SO4
    return gas + aq + pud


def chem_model(Kinematic2D):
    return Kinematic2D(nx=NX, nz=NZ, micro="lgrngn_chem", sd_conc=SD_CONC,
                       sstp_cond=SSTP_COND, sstp_coal=SSTP_COAL,
                       n_sd_max=SD_CONC * NX * NZ, fct=True, device=DEVICE)


def chem_state(m):
    return (m.prtcls.state, m.th, m.rv, dict(m.chem_gases))


def chem_set(m, state):
    m.prtcls.state, m.th, m.rv, gases = state
    m.chem_gases = dict(gases)


def chem_checks(m, s0):
    """Phase 21's checks: th, rv and the gases finite, the gases and the
    live SDs' dissolved masses finite and >= 0, the sulfur conserved
    within CHEM_SULFUR_GATE."""
    st = m.prtcls.state
    live = st.n > 0
    gases = torch.stack(list(m.chem_gases.values()))
    check(bool(torch.isfinite(m.th).all() and torch.isfinite(m.rv).all()
               and torch.isfinite(gases).all() and (gases >= 0).all()),
          "chem: non-finite th/rv, or a gas non-finite or negative")
    chem = st.chem[:, live]
    check(bool(torch.isfinite(chem).all() and (chem >= 0).all()),
          "chem: a dissolved mass non-finite or negative")
    ds = abs(sulfur(m) - s0) / s0
    check(ds < CHEM_SULFUR_GATE, f"chem: sulfur not conserved ({ds:.2e})")
    return ds


def chem_phase(Kinematic2D, _ext, card, profile_on):
    """Phase 21 (the module docstring): Kinematic2D(micro="lgrngn_chem")
    at full width through run().  Returns its numbers."""
    from libcloudphxx_tpu_torch.common import chem as cc
    from libcloudphxx_tpu_torch.lgrngn.particles import particles_t
    m = chem_model(Kinematic2D)
    check(type(m.prtcls) is particles_t,
          f"chem: the factory gave {type(m.prtcls).__name__}")
    init = chem_state(m)
    s0 = sulfur(m)
    steps = CHEM_SPINUP + CHEM_STEPS
    reset(_ext.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run(CHEM_SPINUP, spinup=CHEM_SPINUP)
    warm = chem_state(m)
    m.run(CHEM_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    ds = chem_checks(m, s0)
    st = m.prtcls.state
    so2 = m.chem_gases[cc.chem_species_t.SO2]
    s6 = float((st.n.double() * st.chem[6].double()).sum())
    s6_0 = float((init[0].n.double() * init[0].chem[6].double()).sum())
    print(f"chem: {steps} steps ({CHEM_SPINUP} spin-up) from init in "
          f"{secs:.2f} s; sulfur rel change {ds:.2e} (gate "
          f"{CHEM_SULFUR_GATE:.0e}); SO2 gas {float(init[3][cc.chem_species_t.SO2].min()):.4e}-"
          f"{float(init[3][cc.chem_species_t.SO2].max()):.4e} -> "
          f"{float(so2.min()):.4e}-{float(so2.max()):.4e}; S(VI) "
          f"{s6_0:.4e} -> {s6:.4e} kg; launches {launches} ({card})",
          flush=True)
    check(launches == {"mpdata": 8 * steps, "cond_flat": steps},
          f"chem: kernel A 8 times and F once a step expected, got "
          f"{launches}")
    check(s6 > s6_0, "chem: no S(VI) made")
    out = dict(sulfur_rel_err=ds, launches=steps,
               counted_ms_per_step=secs / steps * 1e3)
    # the kernel path against the plain path, and a second run of the
    # kernel path: the witness of the gases' own spread on the card (the
    # chemistry's index_add_ cell sums add in no fixed order there)
    paths = []
    for plain in (False, False, True):
        chem_set(m, init)
        m.run(CHEM_CHECK_STEPS, spinup=1, plain=plain)
        paths.append((m.th, m.rv, dict(m.chem_gases)))
    k1, k2, pl = paths
    gas_rel = lambda a, b: max(max_rel(a[2][k], b[2][k]) for k in b[2])
    rel = (max_rel(k1[0], pl[0]), max_rel(k1[1], pl[1]), gas_rel(k1, pl))
    witness = gas_rel(k1, k2)
    print(f"chem: kernel path against plain path after {CHEM_CHECK_STEPS} "
          f"steps: th rel {rel[0]:.2e}, rv rel {rel[1]:.2e}, gases rel "
          f"{rel[2]:.2e} (gate {CHEM_GAS_GATE:.0e}); two kernel-path runs' "
          f"gases rel {witness:.2e}, th and rv bitwise "
          f"{torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])}",
          flush=True)
    check(rel[0] <= 2e-6 and rel[1] <= 2e-5 and rel[2] <= CHEM_GAS_GATE
          and witness <= CHEM_GAS_GATE,
          "chem: the kernel path and the plain path differ")
    out.update(path_th_rel=rel[0], path_rv_rel=rel[1], path_gas_rel=rel[2],
               gas_witness_rel=witness)
    # best of TIME_REPS reps of CHEM_STEPS chemistry steps from the spin-up
    best = float("inf")
    for _ in range(TIME_REPS):
        chem_set(m, warm)
        s_w = sulfur(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(CHEM_STEPS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        chem_checks(m, s_w)
    n_sd = int((init[0].n > 0).sum())
    out.update(ms_per_step=best / CHEM_STEPS * 1e3,
               sd_updates_per_s=n_sd * CHEM_STEPS / best)
    print(f"timing, chem: {out['ms_per_step']:.3f} ms/step, "
          f"{out['sd_updates_per_s']:.4e} SD-updates/s (best of {TIME_REPS} "
          f"reps of {CHEM_STEPS} steps after the spin-up) ({card})",
          flush=True)
    if profile_on:
        profile("chem", lambda: chem_set(m, warm), m.run, card, steps=10)
    chem_set(m, (None, None, None, {}))
    del m, init, warm
    torch.cuda.empty_cache()
    return out


def dense3d_factory(oi, label):
    """The factory's pick on the card for a phase-22 configuration: the
    dense front (particles_dense_t), packed."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    prt = tl.factory(tl.backend_t.CUDA, oi, device=DEVICE)
    check(type(prt) is particles_dense_t,
          f"{label}: the factory gave {type(prt).__name__}, not "
          "particles_dense_t")
    return prt


def dense3d_init(prt, fields, label, card):
    """init (factory -> particles_dense_t.init, then the pack) on phase
    19's fields; returns (the packed DenseState, seconds)."""
    t0 = time.perf_counter()
    prt.init(fields["th"], fields["rv"], fields["rhod"], Cx=fields["Cx"],
             Cy=fields["Cy"], Cz=fields["Cz"])
    prt._ensure_dense()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = prt._d
    per_row = (d.n > 0).sum(1)
    print(f"{label}: init {int(per_row.sum())} SDs on {d.n_cell} rows of "
          f"capacity {d.cap} (fullest {int(per_row.max())}) in {secs:.1f} s "
          f"(factory -> init -> pack) ({card})", flush=True)
    return d, secs


def dense3d_run(prt, opts, steps, fields):
    """grid_run on the dense front: ``steps`` steps of step_sync(opts, th,
    rv, rhod, Cx, Cy, Cz) and step_async(opts), the live count's changes
    in coalescence (kernel E's wrapper) and at the walls (kernel C's), and
    the SDs that wrapped in y, summed on the device.  Returns (seconds,
    {"coal", "walls", "y_wrap"}, th, rv)."""
    from libcloudphxx_tpu_torch.ops import coal, step
    th, rv = fields["th"], fields["rv"]
    cfg = prt.cfg
    half = (cfg.y1 - cfg.y0) / 2.0
    flow = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
            for k in ("coal", "walls", "y_wrap")}
    real_e, real_c = coal.coal_resident, step.transport

    def e(*args, **kw):
        out = real_e(*args, **kw)
        flow["coal"] += (out[0] > 0).sum() - (args[6] > 0).sum()
        return out

    def c(*args, **kw):
        out = real_c(*args, **kw)
        if out[4] is not None:          # some transport ran
            flow["walls"] += (out[0] > 0).sum() - (args[3] > 0).sum()
            flow["y_wrap"] += ((out[0] > 0) & (
                (out[6] - kw["y3"][0]).abs() > half)).sum()
        return out

    coal.coal_resident, step.transport = e, c
    kw = {"courant_" + k[1]: fields[k] for k in ("Cx", "Cy", "Cz")}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            th, rv = prt.step_sync(opts, th, rv, fields["rhod"], **kw)
            prt.step_async(opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        coal.coal_resident, step.transport = real_e, real_c
    return secs, {k: int(v) for k, v in flow.items()}, th, rv


def wet_moments(prt):
    """The per-cell SD count and wet moments 0 and 3 through the public
    API, float64."""
    out = []
    for k in (None, 0, 3):
        prt.diag_all()
        if k is None:
            prt.diag_sd_conc()
        else:
            prt.diag_wet_mom(k)
        out.append(torch.as_tensor(prt.outbuf()).double().reshape(-1))
    return out


def dense3d_totals(prt, rv, dense):
    water, dry = dense.water_dry_totals(prt._d, rv)
    return water, dry, int((prt._d.n > 0).sum())


def dense3d_checks(label, prt, th, rv, totals0, flow, dense):
    """grid_checks on the dense front's population: finite fields, water
    and dry mass with the puddle (1e-3, 1e-4), the live count at the end
    the count at the start plus the changes in coalescence and at the
    walls, no SD dropped on a full row."""
    d = prt._d
    check(bool(torch.isfinite(th).all() and torch.isfinite(rv).all()),
          f"{label}: non-finite th/rv")
    live = d.n > 0
    check(bool(torch.isfinite(d.rw2[live]).all() and (d.rw2[live] > 0).all()),
          f"{label}: bad rw2")
    water, dry, n_live = dense3d_totals(prt, rv, dense)
    dw = abs(water - totals0[0]) / totals0[0]
    dd = abs(dry - totals0[1]) / totals0[1]
    check(dw < 1e-3, f"{label}: water conservation off by {dw:.2e}")
    check(dd < 1e-4, f"{label}: dry-mass conservation off by {dd:.2e}")
    check(int(d.overflow) == 0, f"{label}: {int(d.overflow)} SDs dropped on "
          "full rows")
    check(flow["coal"] <= 0 and flow["walls"] <= 0
          and n_live == totals0[2] + flow["coal"] + flow["walls"],
          f"{label}: SDs lost: {totals0[2]} live at the start, {n_live} at "
          f"the end, changes {flow}")
    return {"water_rel_err": dw, "dry_rel_err": dd, "sds": n_live,
            "global_rebins": d.rebins, **flow}


def check_c3d(label, kernel, c_kw, err):
    """Kernel C's 3-D form against its plain version on ``c_kw``
    (transport's arguments), on them and with the droplets made 1 mm
    rain: every slot, y and the far flags bitwise, the puddle partials rel
    1e-5.  Returns the kernel's outputs on ``c_kw``."""
    from libcloudphxx_tpu_torch.ops import step
    alive = c_kw["n"] > 0
    rain = dict(c_kw, do_sedi=True, rw2=torch.where(alive, 1e-6, 0.0))
    first = None
    for pop, kw in (("cloud", c_kw), ("rain", rain)):
        kc = _counted(kernel, lambda: step.transport(**kw))
        pc = step.transport(**kw, plain=True)
        same = all(torch.equal(a, b) for a, b in zip(kc[:5] + kc[6:],
                                                     pc[:5] + pc[6:])) \
            and bool(torch.equal(kc[5][:, 4], pc[5][:, 4]))
        pud_k, pud_p = kc[5].sum(0)[:4], pc[5].sum(0)[:4]
        rel_pud = max_rel(pud_k, pud_p) if float(pud_p[3]) else \
            float(pud_k.abs().max())
        err[kernel.name] = max(err.get(kernel.name, 0.0), *(
            max_abs(a, b) for a, b in zip(kc[:4] + kc[6:], pc[:4] + pc[6:])))
        moved = int(((kc[4] >= 0) & (kc[4] != _rows_of(kc[4]))).sum())
        print(f"C {kernel.name}, {label}, {pop}: n/x/z/vt/targets/y and far "
              f"flags equal {same}, puddle rel {rel_pud:.2e}, droplets that "
              f"left their row {moved}, far rows "
              f"{int(kc[5][:, 4].sum())}", flush=True)
        check(same and rel_pud <= 1e-5, f"C {kernel.name}, {label}, {pop}: "
              "kernel and plain version differ")
        first = first or kc
    return first


def check_d3d(label, kernel, d_kw, err):
    """Kernel D's 3-D form against its plain version on ``d_kw``
    (rebin_x's arguments): every plane and the drops bitwise, and a second
    launch the same bits."""
    from libcloudphxx_tpu_torch.ops import step
    kd = _counted(kernel, lambda: step.rebin_x(**d_kw))
    again = _counted(kernel, lambda: step.rebin_x(**d_kw))
    pd = step.rebin_x(**d_kw, plain=True)
    same = all(torch.equal(a, b) for a, b in zip(kd, pd))
    repeat = all(torch.equal(a, b) for a, b in zip(kd, again))
    err[kernel.name] = max(err.get(kernel.name, 0.0),
                           *(max_abs(a, b) for a, b in zip(kd, pd)))
    print(f"D {kernel.name}, {label}: {len(kd) - 1} planes and the drops "
          f"equal {same}, a second launch the same bits {repeat}; droplets "
          f"placed {int((kd[0] > 0).sum())}, dropped "
          f"{float(kd[-1].sum()):.0f}", flush=True)
    check(same, f"D {kernel.name}, {label}: kernel and plain version differ")
    check(repeat, f"D {kernel.name}, {label}: two launches differ")


def check_e(label, kernel, e_kw, err, cases):
    """Kernel E's form ``kernel`` against its plain version on ``e_kw``
    (coal_resident's arguments) in each of ``cases`` ((name, rw2 factor,
    pairing)): every plane (y too) lane by lane and the overflow flags
    row by row bitwise, a second launch the same bits; the scaled
    populations collide."""
    from libcloudphxx_tpu_torch.ops import coal
    n_in = e_kw["n"]
    for pop, scale, form in cases:
        kw = dict(e_kw, pairing=form, rw2=e_kw["rw2"] * scale)
        k_out = _counted(kernel, lambda: coal.coal_resident(**kw))
        again = _counted(kernel, lambda: coal.coal_resident(**kw))
        p_out = coal.coal_resident(**kw, plain=True)
        lanes = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        repeat = all(torch.equal(a, b) for a, b in zip(k_out, again))
        err[kernel.name] = max(err.get(kernel.name, 0.0), *(
            max_abs(a, b) for a, b in zip(k_out, p_out)))
        lost = float(n_in.double().sum() - k_out[0].double().sum())
        print(f"E {kernel.name} {form}, {label}, {pop}: lanes equal "
              f"{lanes} ({len(k_out) - 1} planes and the flags; "
              f"{int(k_out[-1].sum())} of {n_in.shape[0]} rows flagged), "
              f"a second launch the same bits {repeat}, multiplicity lost "
              f"{lost:.6g}", flush=True)
        check(lanes, f"E {kernel.name} {form}, {label}, {pop}: kernel "
              "and plain version differ")
        check(repeat, f"E {kernel.name} {form}, {label}, {pop}: two "
              "launches differ")
        check(lost > 0.0 or scale == 1.0,
              f"E {kernel.name} {form}, {label}, {pop}: no collision")


def form_resources(_ext, row, query, *args, **plan):
    """The card's attributes of a kernel form (_ext.attributes of the C
    query ``query`` with ``args``), printed and kept in the kernels row
    ``row`` with the launch plan ``plan``."""
    a = _ext.attributes(query, *args)
    rows = (f", {a['warps_a_row']} warps a row of {a['slots_a_lane']} "
            f"register slots a lane" if a["warps_a_row"] else "")
    print(f"resources {row['name']} {query}{args} {plan}: {a['registers']} "
          f"registers a thread, {a['static_shared']} B static and "
          f"{a['dynamic_shared']} B dynamic shared memory, {a['local']} B "
          f"local memory, {a['blocks_per_sm']} blocks of {a['threads']} "
          f"threads an SM{rows}", flush=True)
    row["resources"] = dict(a, **plan)


def d3d_resources(_ext, row, kernel, d_kw):
    """form_resources of kernel D's 3-D form ``kernel`` at the plan
    rebin_x takes for ``d_kw`` (its arguments), in the layout the launch
    takes at its capacity."""
    from libcloudphxx_tpu_torch.ops import step
    cap = d_kw["n"].shape[1]
    plan = step.merge3d_plan(cap, d_kw["cfg"].nz)
    form_resources(_ext, row, kernel.symbol + "_attrs", int(cap % 128 == 0),
                   plan.brick, cap, brick=plan.brick, bricks=plan.bricks)


def ey_resources(_ext, row, e_kw):
    """form_resources of kernel E's y or onishi form at ``e_kw``'s (its
    arguments') formula, pairing and capacity: the plan's row, and above
    cap 128 also the one-warp pass (``resources_one_warp``)."""
    from libcloudphxx_tpu_torch.lgrngn import vt_t
    cap = e_kw["n"].shape[1]
    args = (vt_t(e_kw["cfg"].terminal_velocity).value,
            int(e_kw.get("pairing", "stride") == "sort"), cap)
    if cap > 128:
        form_resources(_ext, row, "lcp_coal_y_attrs", *args, 1)
        row["resources_one_warp"] = row.pop("resources")
    form_resources(_ext, row, "lcp_coal_y_attrs", *args, 0)


def c3_resources(_ext, row, c_kw):
    """form_resources of kernel C's 3-D streaming kernel at ``c_kw``'s (its
    arguments') form, formula and capacity, with the plan transport takes
    there (ops/step.py transport3d_plan)."""
    from libcloudphxx_tpu_torch.lgrngn import as_t, vt_t
    from libcloudphxx_tpu_torch.ops import step
    cfg, (n_cell, cap) = c_kw["cfg"], c_kw["n"].shape
    pc = c_kw["do_adve"] and as_t(cfg.adve_scheme) == as_t.pred_corr
    vt = vt_t(cfg.terminal_velocity).value
    plan = step.transport3d_plan(cap, n_cell,
                                 step.card_transport3d(pc, vt, cap))
    form_resources(_ext, row, "lcp_transport_3d_attrs", vt, int(pc), cap,
                   brick=plan.brick, blocks=plan.blocks)


def c3_line(row, card):
    """Print kernel C's 3-D form's row: a call's time and its device time
    in the step against its bound."""
    step_ms = row.get("in_step_ms")
    print(f"C {row['name']}: {row['ms']:.4f} ms a call, in the step "
          + (f"{step_ms:.4f}" if step_ms else "not measured")
          + f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{row['bound_ms'] / (step_ms or row['ms']):.3f} of it ({card})",
          flush=True)


def kernel_row(kernel, launches, err, call, bnd, card, reps=KERNEL_REPS,
               plain_reps=1, where=""):
    """A ``kernels`` row: ``call(plain)`` timed through the kernel (reps)
    and its plain version (plain_reps), beside the bound ``bnd``."""
    ms = time_cuda(lambda: call(False), reps)
    plain_ms = time_cuda(lambda: call(True), plain_reps,
                         warm=plain_reps > 1)
    bound_ms, bound_by = bnd
    print(f"kernel {kernel.name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {launches} launches {where} "
          f"({card})", flush=True)
    check(launches > 0, f"kernel {kernel.name} was not launched")
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches,
            "max_abs_err": err.get(kernel.name, 0.0), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def transport3d_bound(kw, kc):
    """Kernel C's 3-D forms' bound on their arguments ``kw`` (transport's)
    and outputs ``kc``: transport_bound's bytes with y read for the live
    droplets and written for every slot, the two y courants a row (and
    under pred_corr the staggered courants), and its operations with y's
    advection and wall (OPS_TRANSPORT_Y a live droplet; under pred_corr
    the corrector of three axes)."""
    cfg, n = kw["cfg"], kw["n"]
    live = n > 0
    live0, slot = int(live.sum()), n.element_size()
    fell = int((live & (kc[0] == 0) & (kc[2] < cfg.z0)).sum())
    vt32, vt64 = vt_ops(cfg, kw["rw2"][live])
    from libcloudphxx_tpu_torch.lgrngn import as_t
    pc = kw["do_adve"] and as_t(cfg.adve_scheme) == as_t.pred_corr
    extra = nbytes(*kw["courants"]) if pc else 0
    ops = live0 * (OPS_TRANSPORT + OPS_TRANSPORT_Y
                   + (3 * OPS_PRED_CORR // 2 if pc else 0))
    return bound(
        nbytes(n) + 4 * slot * live0 + slot * fell + 9 * nbytes(kw["rhod"])
        + 5 * nbytes(n) + nbytes(kc[4], kc[5]) + extra,
        vt32 + ops, vt64 + (live0 * 3 * OPS_PRED_CORR_F64 // 2 if pc else 0))


def merge3d_bound(kw):
    """Kernel D's 3-D forms' bound on their arguments ``kw`` (rebin_x's):
    the targets of every slot and the planes of the droplets taken (those
    alive after C) in, every plane and the drops out, against the
    27-source merge of each taken droplet."""
    n, tgt = kw["n"], kw["tgt"]
    planes = 7 + len(kw["extra"])
    live = int((tgt >= 0).sum())
    slot = n.element_size()
    return bound(nbytes(tgt) + planes * slot * live + planes * nbytes(n)
                 + slot * n.shape[0], live * OPS_MERGE)


def coal_y_bound(kw, work, table_ops=0):
    """Kernel E's y and onishi forms' bound on their arguments ``kw``
    (coal_resident's) and the work their data needs (coal_work): seven
    planes (six without y) and five cell fields in, as many planes and the
    row flags out, the efficiency table where the kernel reads one;
    coal_bounds' operations, and ``table_ops`` a pair (a table lookup, and
    the onishi value's Wang enhancement)."""
    from libcloudphxx_tpu_torch.lgrngn import coalescence as coal_mod
    n = kw["n"]
    live = n > 0
    planes = 6 + (kw.get("y") is not None)
    table = coal_mod.clamped_efficiency_table(kw["cfg"].kernel)
    vt32, vt64 = vt_ops(kw["cfg"], kw["rw2"][live])
    per32 = vt32 / max(int(live.sum()), 1)
    per64 = vt64 / max(int(live.sum()), 1)
    vts = work["live"] + work["changed"]
    return bound(2 * planes * nbytes(n) + 5 * nbytes(kw["rhod"])
                 + n.shape[0] + (table[0].nbytes if table else 0),
                 coal_ops(work) + work["pairs"] * table_ops + vts * per32,
                 vts * per64)


def dense3d_case(fields, m2, _ext, dense, c, card, profile_on, err):
    """Phase 22 (a): phase 19 (a)'s configuration at full width on the
    factory's pick on the card, the dense front.  Returns (its numbers,
    the kernel rows of C's, D's and E's 3-D forms)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.ops import coal, step
    oi = grid_oi(m2, 3)
    prt = dense3d_factory(oi, "3-D dense")
    init, init_s = dense3d_init(prt, fields, "3-D dense", card)
    n_sd = int((init.n > 0).sum())
    check(n_sd == SD_CONC * GRID_N ** 3, f"3-D dense: {n_sd} SDs at init")
    opts = tl.opts_t()
    opts.adve = opts.cond = opts.coal = opts.sedi = True
    totals0 = dense3d_totals(prt, fields["rv"], dense)
    # the counted run: B, E's y form, C's and D's 3-D forms once a step
    reset(_ext.KERNELS)
    secs, flow, th, rv = dense3d_run(prt, opts, DENSE3D_STEPS, fields)
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    chk = dense3d_checks("3-D dense", prt, th, rv, totals0, flow, dense)
    lost = collided(init, prt._d)
    print(f"3-D dense: {DENSE3D_STEPS} steps from init in {secs:.2f} s; "
          f"{chk}; multiplicity lost to collisions {lost:.3e}; launches "
          f"{launches} ({card})", flush=True)
    want = dict.fromkeys(("cond", "coal_3d", "transport_3d", "merge_3d"),
                         DENSE3D_STEPS)
    check(launches == want, f"3-D dense: launches {launches}, expected "
          f"{want}")
    check(flow["y_wrap"] > 0, "3-D dense: no SD wrapped in y")
    out = dict(chk, launches=launches, init_s=init_s, collided=lost)
    # C's, D's and E's 3-D forms against their plain versions on what a
    # full-width step gives them
    calls = capture_all({"e": (coal, "coal_resident"),
                         "c": (step, "transport"), "d": (dense, "rebin_x"),
                         "b": (step, "cond")},
                        lambda: dense3d_run(prt, opts, 1, dict(
                            fields, th=th, rv=rv)))
    e_kw, c_kw, d_kw = calls["e"][-1], calls["c"][-1], calls["d"][-1]
    # B at this shape (a row of its own: its bound, the kernel and the
    # plain version timed on the step's arguments)
    b_kw = calls["b"][-1]
    b_row = kernel_row(_ext.COND, launches["cond"], err,
                       lambda plain: step.cond(**b_kw, plain=plain),
                       cond_kw_bound(b_kw), card, reps=3,
                       where="in (a)'s counted steps")
    del b_kw
    t1 = time.perf_counter()
    kc = check_c3d("3-D dense", _ext.TRANSPORT_3D, c_kw, err)
    check_d3d("3-D dense", _ext.MERGE_3D, d_kw, err)
    check_e("3-D dense", _ext.COAL_3D, e_kw, err,
            (("cloud", 1.0, "stride"), ("drizzle", 100.0, "sort")))
    out["check_s"] = time.perf_counter() - t1
    work = coal_work(lambda: coal.coal_resident(**e_kw, plain=True),
                     e_kw["n"])
    rows = [kernel_row(
        _ext.TRANSPORT_3D, launches["transport_3d"], err,
        lambda plain: step.transport(**c_kw, plain=plain),
        transport3d_bound(c_kw, kc), card, where="in (a)'s counted steps"),
        kernel_row(_ext.MERGE_3D, launches["merge_3d"], err,
                   lambda plain: step.rebin_x(**d_kw, plain=plain),
                   merge3d_bound(d_kw), card,
                   where="in (a)'s counted steps"),
        kernel_row(_ext.COAL_3D, launches["coal_3d"], err,
                   lambda plain: coal.coal_resident(**e_kw, plain=plain),
                   coal_y_bound(e_kw, work), card, reps=5,
                   where="in (a)'s counted steps")]
    c3_resources(_ext, rows[0], c_kw)
    d3d_resources(_ext, rows[1], _ext.MERGE_3D, d_kw)
    ey_resources(_ext, rows[2], e_kw)
    del calls, e_kw, c_kw, d_kw, kc
    # best of DENSE3D_REPS reps of DENSE3D_STEPS steps from init
    best = float("inf")
    for _ in range(DENSE3D_REPS):
        prt.adopt(init)
        totals = dense3d_totals(prt, fields["rv"], dense)
        secs, flow, th, rv = dense3d_run(prt, opts, DENSE3D_STEPS, fields)
        dense3d_checks("3-D dense", prt, th, rv, totals, flow, dense)
        check(flow["y_wrap"] > 0, "3-D dense: no SD wrapped in y")
        best = min(best, secs)
    out.update(ms_per_step=best / DENSE3D_STEPS * 1e3,
               sd_updates_per_s=n_sd * DENSE3D_STEPS / best)
    prt.adopt(init)
    in_step = device_ms(lambda k: dense3d_run(prt, opts, k, fields),
                        PROFILE_STEPS, ("cond_kernel", "coal_y_kernel",
                                        "transport3d_kernel", "merge3d"))
    out["in_step_ms"] = in_step
    print(f"timing, 3-D dense: {out['ms_per_step']:.3f} ms/step, "
          f"{out['sd_updates_per_s']:.4e} SD-updates/s (best of "
          f"{DENSE3D_REPS} reps of {DENSE3D_STEPS} steps from init, {n_sd} "
          f"SDs); device time in the step [ms] " + ", ".join(
              f"{k} {v:.4f}" for k, v in in_step.items()) + f" ({card})",
          flush=True)
    for r in rows:
        r["in_step_ms"] = in_step.get(
            {"transport_3d": "transport3d_kernel", "merge_3d": "merge3d",
             "coal_3d": "coal_y_kernel"}[r["name"]])
    c3_line(rows[0], card)
    b_row["in_step_ms"] = in_step.get("cond_kernel")
    out["b"] = {k: b_row[k] for k in ("launches", "ms", "in_step_ms",
                                      "plain_ms", "bound_ms", "bound_by")}
    if profile_on:
        profile("3-D dense (a)", lambda: prt.adopt(init),
                lambda k: dense3d_run(prt, opts, k, fields), card, steps=3)
    # the dense front against the flat engine after one step from the same
    # init without coalescence: th, rv and the per-cell moments
    opts.coal = False
    prt.adopt(init)
    _, _, th_d, rv_d = dense3d_run(prt, opts, 1, fields)
    m_d = wet_moments(prt)
    prt.state = None
    del prt, init
    torch.cuda.empty_cache()
    flat = grid_factory(oi, "3-D flat")
    flat.init(fields["th"], fields["rv"], fields["rhod"], Cx=fields["Cx"],
              Cy=fields["Cy"], Cz=fields["Cz"])
    _, _, th_f, rv_f, = grid_run(flat, opts, 1, fields, c)
    m_f = wet_moments(flat)
    flat.state = None
    del flat
    torch.cuda.empty_cache()
    # a droplet within an ulp of a cell face may land on either side (C's
    # row-broadcast courants against the flat engine's gathers): the
    # moments are held where both hold the same SDs a cell
    same = m_d[0] == m_f[0]
    moved = int((~same).sum())
    rel = {"th": max_rel(th_d, th_f), "rv": max_rel(rv_d, rv_f),
           "m0": max_rel(m_d[1][same], m_f[1][same]),
           "m3": max_rel(m_d[2][same], m_f[2][same])}
    out["vs_flat"] = dict(rel, cells_other_count=moved,
                          m0_all_cells=max_rel(m_d[1], m_f[1]))
    print(f"3-D dense front against the flat engine after one step without "
          f"coalescence: max rel " + ", ".join(
              f"{k} {v:.3e}" for k, v in rel.items())
          + f" (m0, m3 on the cells of equal SD counts); cells whose SD count "
          f"differs {moved} of {same.numel()} (m0 there up to "
          f"{out['vs_flat']['m0_all_cells']:.3e}); gates {DENSE3D_GATES}, "
          f"at most {DENSE3D_MOVED_CELLS} cells", flush=True)
    check(all(rel[k] <= DENSE3D_GATES[k] for k in rel)
          and moved <= DENSE3D_MOVED_CELLS,
          "3-D dense: the dense front and the flat engine part")
    return out, rows


def dense3d_forms(fields, m2, _ext, dense, c, card, err):
    """Phase 22 (b): pred_corr with vohl and the large tail, and the exact
    mode with mixing, on the 3-D grid at full width through the dense
    front, DENSE3D_FORM_STEPS counted steps each.  Returns (numbers, the
    kernel rows of C's 3-D pred_corr form, E's vohl y form and D's 3-D
    exact form)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.ops import coal, step
    cases = {
        "pred_corr, vohl": (dict(
            adve_scheme=tl.as_t.pred_corr,
            kernel=tl.kernel_t.vohl_davis_no_waals,
            sd_conc_large_tail=True), {
            "cond": 1, "coal_vohl_3d": 1, "transport_3d_pred_corr": 1,
            "merge_3d": 1}),
        "exact": (dict(exact_sstp_cond=True), {
            "cond_sd_fixed": 1, "coal_3d": 1, "transport_3d": 1,
            "merge_3d_exact": 1})}
    out, rows = {}, []
    for label, (over, per_step) in cases.items():
        t0 = time.perf_counter()
        oi = grid_oi(m2, 3, n_sd_max=2 * SD_CONC * GRID_N ** 3, **over)
        prt = dense3d_factory(oi, label)
        init, init_s = dense3d_init(prt, fields, label, card)
        opts = tl.opts_t()
        opts.adve = opts.cond = opts.coal = opts.sedi = True
        totals0 = dense3d_totals(prt, fields["rv"], dense)
        reset(_ext.KERNELS)
        secs, flow, th, rv = dense3d_run(prt, opts, DENSE3D_FORM_STEPS,
                                         fields)
        launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
        chk = dense3d_checks(label, prt, th, rv, totals0, flow, dense)
        want = {k: v * DENSE3D_FORM_STEPS for k, v in per_step.items()}
        print(f"3-D dense, {label}: {DENSE3D_FORM_STEPS} steps from init in "
              f"{secs:.2f} s ({secs / DENSE3D_FORM_STEPS * 1e3:.3f} "
              f"ms/step); {chk}; launches {launches} ({card})", flush=True)
        check(launches == want, f"3-D dense, {label}: launches {launches}, "
              f"expected {want}")
        check(flow["y_wrap"] > 0, f"3-D dense, {label}: no SD wrapped in y")
        calls = capture_all({"e": (coal, "coal_resident"),
                             "c": (step, "transport"),
                             "d": (dense, "rebin_x")},
                            lambda: dense3d_run(prt, opts, 1, dict(
                                fields, th=th, rv=rv)))
        e_kw, c_kw, d_kw = calls["e"][-1], calls["c"][-1], calls["d"][-1]
        if label == "exact":
            check_d3d(label, _ext.MERGE_3D_EXACT, d_kw, err)
            rows.append(kernel_row(
                _ext.MERGE_3D_EXACT, launches["merge_3d_exact"], err,
                lambda plain: step.rebin_x(**d_kw, plain=plain),
                merge3d_bound(d_kw), card, reps=5,
                where=f"in (b) {label}'s counted steps"))
            d3d_resources(_ext, rows[-1], _ext.MERGE_3D_EXACT, d_kw)
        else:
            kc = check_c3d(label, _ext.TRANSPORT_3D_PRED_CORR, c_kw, err)
            # rain to 0.8 mm: vohl's table past index 126
            check_e(label, _ext.COAL_VOHL_3D, e_kw, err,
                    (("rain", 2500.0, "stride"),))
            work = coal_work(lambda: coal.coal_resident(**e_kw, plain=True),
                             e_kw["n"])
            c_row = kernel_row(
                _ext.TRANSPORT_3D_PRED_CORR,
                launches["transport_3d_pred_corr"], err,
                lambda plain: step.transport(**c_kw, plain=plain),
                transport3d_bound(c_kw, kc), card, reps=5,
                where=f"in (b) {label}'s counted steps")
            c3_resources(_ext, c_row, c_kw)
            c3_line(c_row, card)
            rows += [c_row,
                kernel_row(_ext.COAL_VOHL_3D, launches["coal_vohl_3d"], err,
                           lambda plain: coal.coal_resident(**e_kw,
                                                            plain=plain),
                           coal_y_bound(e_kw, work, OPS_EFF), card, reps=5,
                           where=f"in (b) {label}'s counted steps")]
            ey_resources(_ext, rows[-1], e_kw)
        out[label] = dict(chk, launches=launches, init_s=init_s,
                          ms_per_step=secs / DENSE3D_FORM_STEPS * 1e3,
                          seconds=time.perf_counter() - t0)
        prt.state = None
        del prt, init, calls, e_kw, c_kw, d_kw
        torch.cuda.empty_cache()
    return out, rows


def onishi_case(Kinematic2D, _ext, dense, c, card, err):
    """Phase 22 (c): bench.py's case with onishi_hall at kernel_parameters
    [LES_RE_LAMBDA] on the dense engine (dissipation rate 0), through
    run_device_lgrngn(engine="dense") and the dense front.  Returns
    (numbers, the kernel row of E's onishi form)."""
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn.dense_front import particles_dense_t
    from libcloudphxx_tpu_torch.ops import coal
    m = make_model(Kinematic2D, coal=True, kernel=tl.kernel_t.onishi_hall,
                   kernel_parameters=[LES_RE_LAMBDA])
    check(isinstance(m.prtcls, particles_dense_t),
          f"onishi: the factory on the card gave {type(m.prtcls).__name__}")
    init = (m.dense_state, m.th, m.rv)
    n_sd = int((init[0].n > 0).sum())
    totals = dense.water_dry_totals(init[0], m.rv)
    steps = SLICE_SPINUP + SLICE_MAIN

    def restore(s):
        m.dense_state, m.th, m.rv = s

    reset(_ext.KERNELS)
    m.run_device_lgrngn(SLICE_SPINUP, spinup=SLICE_SPINUP, engine="dense")
    sp = (m.dense_state, m.th, m.rv)
    m.run_device_lgrngn(SLICE_MAIN, engine="dense")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    dw, dd = physics_checks(m, *totals, dense)
    end = (m.dense_state, m.th, m.rv)
    lost = collided(sp[0], end[0])
    print(f"onishi: {SLICE_SPINUP} spin-up + {SLICE_MAIN} main steps; water "
          f"rel err {dw:.2e}, dry rel err {dd:.2e}, multiplicity lost to "
          f"collisions {lost:.3e}; launches {launches}", flush=True)
    want = {"mpdata": steps, "cond": steps, "transport": steps,
            "merge": steps, "coal_onishi": SLICE_MAIN}
    check(launches == want, f"onishi: launches {launches}, expected {want}")
    # the dense front's stepwise run from init, bitwise
    restore(init)
    m.run(steps, spinup=SLICE_SPINUP)
    torch.cuda.synchronize()
    same = bool(torch.equal(m.th, end[1]) and torch.equal(m.rv, end[2])
                and np.array_equal(population(m.dense_state),
                                   population(end[0])))
    print(f"onishi: dense front vs run_device_lgrngn bitwise equal {same}",
          flush=True)
    check(same, "onishi: the dense front differs from run_device_lgrngn")
    # E's onishi form against its plain version on what a main step gives
    # it, and with radii x10 and x30, where droplets collide
    e_kw = capture(coal, "coal_resident", lambda: (restore(sp),
                   m.run_device_lgrngn(1, engine="dense")))
    check_e("onishi", _ext.COAL_ONISHI, e_kw, err, tuple(
        (pop, scale, form) for pop, scale in (
            ("cloud", 1.0), ("drizzle", 100.0), ("rain", 900.0))
        for form in ("stride", "sort")))
    work = coal_work(lambda: coal.coal_resident(**e_kw, plain=True),
                     e_kw["n"])
    row = kernel_row(_ext.COAL_ONISHI, launches["coal_onishi"], err,
                     lambda plain: coal.coal_resident(**e_kw, plain=plain),
                     coal_y_bound(e_kw, work, OPS_EFF + OPS_WANG), card,
                     reps=KERNEL_REPS, plain_reps=3,
                     where=f"in (c)'s {SLICE_MAIN} coalescing steps")
    ey_resources(_ext, row, e_kw)
    # best of TIME_REPS reps of ONISHI_TIME_STEPS steps from init
    restore(init)
    m.run_device_lgrngn(2, engine="dense")                 # warm-up
    best = float("inf")
    for _ in range(TIME_REPS):
        restore(init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_device_lgrngn(ONISHI_TIME_STEPS, engine="dense")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        physics_checks(m, *totals, dense)
    restore(init)
    in_step = device_ms(lambda k: m.run_device_lgrngn(k, engine="dense"),
                        PROFILE_STEPS, ("coal_y_kernel",))
    row["in_step_ms"] = in_step.get("coal_y_kernel")
    out = {"ms_per_step": best / ONISHI_TIME_STEPS * 1e3,
           "sd_updates_per_s": n_sd * ONISHI_TIME_STEPS / best,
           "collided": lost, "water_rel_err": dw, "dry_rel_err": dd}
    print(f"timing, onishi (run_device_lgrngn, coalescence on): "
          f"{out['ms_per_step']:.3f} ms/step, "
          f"{out['sd_updates_per_s']:.4g} SD-updates/s ({ONISHI_TIME_STEPS} "
          f"steps, best of {TIME_REPS}); E's onishi form in the step "
          f"{row['in_step_ms']} ms ({card})", flush=True)
    return out, row


def dense3d_phase(Kinematic2D, _ext, dense, c, card, profile_on):
    """Phase 22: the dense engine on the 3-D grid and with the onishi
    kernels.  Returns (the kernel rows, the numbers, the max abs errors of
    the forms against their plain versions)."""
    err = {}
    fields, m2 = grid3d_fields(Kinematic2D)
    t0 = time.perf_counter()
    a, rows = dense3d_case(fields, m2, _ext, dense, c, card, profile_on,
                           err)
    print(f"phase 22 (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    b, b_rows = dense3d_forms(fields, m2, _ext, dense, c, card, err)
    print(f"phase 22 (b): {time.perf_counter() - t0:.1f} s", flush=True)
    del fields, m2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cc, c_row = onishi_case(Kinematic2D, _ext, dense, c, card, err)
    print(f"phase 22 (c): {time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows + b_rows + [c_row]:
        r["max_abs_err"] = err.get(r["name"], 0.0)
    return rows + b_rows + [c_row], {"3-D": a, "forms": b, "onishi": cc}, err


# ------------------------------------------------------------------ phase 23
def multi_model(Kinematic2D, coal, shards=MULTI_SHARDS, **oi_kw):
    """bench.py's model at Kinematic2D's own n_sd_max (twice the SDs):
    the multi-device front of ``shards`` slabs, or the serial flat engine
    for ``shards`` 1."""
    kw = {"coal_switch": coal, **oi_kw}
    if shards > 1:
        kw["dev_count"] = shards
    return Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=SD_CONC, sstp_cond=SSTP_COND,
        sstp_coal=SSTP_COAL, opts_init_kw=kw,
        engine="auto" if shards > 1 else "flat", device=DEVICE)


def multi_start(m):
    """A model's state to restore: the population (a shard list for the
    multi-device front), th and rv."""
    return m.prtcls.state, m.th, m.rv


def multi_restore(m, start):
    m.prtcls.state, m.th, m.rv = start


def multi_run(m, _ext, steps, c, totals, label):
    """``steps`` of Kinematic2D.run() with the launches counted from 0 and
    bench.py's physics checks after them, no SD sent past a full
    migration buffer and the live count not grown.  Returns (seconds,
    {kernel: launches})."""
    n0 = int((m.prtcls.get_attr("n") > 0).sum())
    reset(_ext.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run(steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
    flat_physics_checks(m, *totals, c)
    n1 = int((m.prtcls.get_attr("n") > 0).sum())
    ovf = m.prtcls.migration_overflow() \
        if hasattr(m.prtcls, "migration_overflow") else 0.0
    check(ovf == 0 and n1 <= n0, f"{label}: {ovf:.0f} SDs past a full "
          f"migration buffer, live SDs {n0} -> {n1}")
    return secs, launches


def near_face_cells(prt):
    """The (NX, NZ) cells on both sides of a face (x or z) that an SD of
    ``prt`` lies within MULTI_NEAR_ULPS float32 ulps of the domain's size
    of (the SDs' x and z through get_attr, in global coordinates)."""
    n = prt.get_attr("n")
    x, z = (prt.get_attr(k).astype(np.float64)[n > 0] for k in ("x", "z"))
    dx, dz = prt.cfg.dx, prt.cfg.dz
    eps = float(np.finfo(np.float32).eps) * MULTI_NEAR_ULPS
    out = np.zeros((NX, NZ), bool)
    rx, rz = x / dx, z / dz
    ix, iz = np.rint(rx).astype(int), np.rint(rz).astype(int)
    i = np.clip(np.floor(rx).astype(int), 0, NX - 1)
    k = np.clip(np.floor(rz).astype(int), 0, NZ - 1)
    near = np.abs(rx - ix) * dx <= eps * NX * dx
    for side in (ix - 1, ix):
        out[side[near] % NX, k[near]] = True
    near = np.abs(rz - iz) * dz <= eps * NZ * dz
    for side in (iz - 1, iz):
        out[i[near], np.clip(side[near], 0, NZ - 1)] = True
    return out


def multi_gate(Kinematic2D, _ext, c, card):
    """Phase 23 (b): the front against the serial flat engine from the
    same init, MULTI_GATE_STEPS steps without coalescence.  Returns the
    readings."""
    ms, mf = (multi_model(Kinematic2D, False, shards=s)
              for s in (MULTI_SHARDS, 1))
    by_step, near = [], np.zeros((NX, NZ), bool)
    for _ in range(MULTI_GATE_STEPS):
        # the cells beside an SD near a face after a step: the next step
        # may condense it in either
        near |= near_face_cells(ms.prtcls) | near_face_cells(mf.prtcls)
        for m in (ms, mf):
            m.run(1)
        far = torch.as_tensor(~near, device=DEVICE)
        by_step.append((max_rel(ms.th[far], mf.th[far]),
                        max_rel(ms.rv[far], mf.rv[far])))
    torch.cuda.synchronize()
    near |= near_face_cells(ms.prtcls) | near_face_cells(mf.prtcls)
    counts = [m.diag_lgrngn("sd_conc") for m in (ms, mf)]
    moved = counts[0] != counts[1]
    far = torch.as_tensor(~near.reshape(-1), device=DEVICE)
    rel = lambda a, b, sel: float(max_rel(
        a.reshape(-1)[sel], b.reshape(-1)[sel])) if bool(sel.any()) else 0.0
    th = (rel(ms.th, mf.th, far), rel(ms.th, mf.th, ~far))
    rv = (rel(ms.rv, mf.rv, far), rel(ms.rv, mf.rv, ~far))
    moms = {}
    for k in (0, 3):
        vals = []
        for m in (ms, mf):
            m.prtcls.diag_all()
            m.prtcls.diag_wet_mom(k)
            vals.append(m.prtcls.outbuf().reshape(NX, NZ))
        same = (~near) & (counts[0] == counts[1]) & (vals[1] > 0)
        moms[k] = float(np.max(np.abs(vals[0] - vals[1])[same]
                               / vals[1][same]))
    out = dict(th_rv_rel_by_step=by_step, th_rel=th[0], rv_rel=rv[0],
               th_rel_near=th[1], rv_rel_near=rv[1],
               near_cells=int(near.sum()),
               moved_cells=int(moved.sum()),
               moved_outside_near=int((moved & ~near).sum()),
               m0_rel=moms[0], m3_rel=moms[3])
    print(f"multi-device front vs serial flat, {MULTI_GATE_STEPS} steps "
          f"without coalescence: {out} ({card})", flush=True)
    check(max(b[0] for b in by_step) <= 2e-6
          and max(b[1] for b in by_step) <= 2e-5,
          "multi gate: th or rv beyond F's cell-sum gates")
    check(out["moved_outside_near"] == 0
          and out["near_cells"] <= MULTI_NEAR_CELLS,
          "multi gate: SD counts differ away from the faces, or too many "
          "cells beside one")
    check(moms[0] <= MULTI_MOM_GATE[0] and moms[3] <= MULTI_MOM_GATE[3],
          f"multi gate: wet moments beyond {MULTI_MOM_GATE}")
    return out


def multi_phase(Kinematic2D, _ext, c, card, profile_on):
    """Phase 23 (the module docstring).  Returns {kernel row name: the
    numbers for its "multi" entry, with max_abs_err}."""
    from libcloudphxx_tpu_torch.lgrngn import as_t
    from libcloudphxx_tpu_torch.ops import cond as cond_ops
    from libcloudphxx_tpu_torch.parallel import particles_multi_t
    err, out = {}, {}
    t0 = time.perf_counter()
    mm = multi_model(Kinematic2D, True)
    prt = mm.prtcls
    check(type(prt) is particles_multi_t and prt.widths == MESH_WIDTHS,
          f"phase 23: the factory gave {type(prt).__name__}, slabs "
          f"{getattr(prt, 'widths', None)}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    start = multi_start(mm)
    totals = flat_totals(prt, mm.rv, c)
    n_sd = int((prt.get_attr("n") > 0).sum())
    print(f"multi-device front: {n_sd} SDs on {prt.n_shards} shards of "
          f"{prt._cap} slots, init {init_s:.1f} s", flush=True)
    # (a) the timed reps, the launches of the first
    best, launches = float("inf"), None
    for _ in range(TIME_REPS):
        multi_restore(mm, start)
        secs, got = multi_run(mm, _ext, MULTI_STEPS, c, totals,
                              "phase 23 (a)")
        launches = launches or got
        best = min(best, secs)
    check(launches == {"mpdata": 2 * MULTI_STEPS,
                       "cond_flat": MULTI_SHARDS * MULTI_STEPS},
          f"phase 23 (a): kernel A twice a step and F once a shard a step "
          f"expected, got {launches}")
    ms_step = best / MULTI_STEPS * 1e3
    mf = multi_model(Kinematic2D, True, shards=1)
    f_start, f_tot = multi_start(mf), flat_totals(mf.prtcls, mf.rv, c)
    f_best = float("inf")
    for _ in range(TIME_REPS):
        multi_restore(mf, f_start)
        f_best = min(f_best, multi_run(mf, _ext, MULTI_STEPS, c, f_tot,
                                       "serial flat")[0])
    f_ms = f_best / MULTI_STEPS * 1e3
    print(f"timing multi-device front (8 shards, public API, coalescence "
          f"on): {ms_step:.3f} ms/step, {n_sd * MULTI_STEPS / best:.4g} "
          f"SD-updates/s; the serial flat engine at the same n_sd_max "
          f"{f_ms:.3f} ms/step, {n_sd * MULTI_STEPS / f_best:.4g} "
          f"SD-updates/s ({MULTI_STEPS} steps, best of {TIME_REPS}; "
          f"launches {launches}; {card})", flush=True)
    if profile_on:
        profile("multi-device front, 8 shards",
                lambda: multi_restore(mm, start), mm.run, card, steps=3)
        profile("serial flat at the same n_sd_max",
                lambda: multi_restore(mf, f_start), mf.run, card, steps=5)
    del mf
    # (c) F on the last shard's inputs (a padded column) against its plain
    multi_restore(mm, start)
    f_kw = capture(cond_ops, "cond_flat", lambda: mm.run(1), which=None)
    check(len(f_kw) == MULTI_SHARDS, f"phase 23 (c): {len(f_kw)} F calls "
          f"in a step")
    kw = f_kw[-1]
    check_form("(a shard of the multi-device front)", kw, err)
    k, pl = cond_ops.cond_flat(**kw), cond_ops.cond_flat(**kw, plain=True)
    pad = torch.arange(kw["th"].numel(), device=DEVICE) \
        >= prt.doms[-1].nxl * NZ
    live_pad = int((kw["wgt"] > 0)[pad[kw["sijk"]]].sum())
    same_pad = bool(torch.equal(k[1][pad], pl[1][pad])
                    and torch.equal(k[2][pad], pl[2][pad]))
    same = float(((k[1] == pl[1]) & (k[2] == pl[2])).double().mean())
    live = kw["wgt"] > 0
    same_sd = bool(torch.equal(k[0][live], pl[0][live]))
    print(f"F on shard {MULTI_SHARDS - 1}: {int(pad.sum())} padded cells, "
          f"{live_pad} live SDs there, their th and rv bitwise the plain "
          f"version's {same_pad}; {same:.4f} of the cells bitwise, the live "
          f"SDs' rw2 bitwise {same_sd}", flush=True)
    check(live_pad == 0 and same_pad, "phase 23 (c): an SD in a padded "
          "cell, or F's padded cells differ from its plain version's")
    check(same == 1.0 and same_sd, "phase 23 (c): F on a shard is not "
          "bitwise its plain version")
    out["cond_flat"] = form_row(
        kw, launches["cond_flat"], f"phase 23 (a)'s {MULTI_STEPS} steps "
        f"({MULTI_SHARDS} shards)", err)
    out["cond_flat"]["ms_per_step"] = ms_step
    out["cond_flat"]["serial_flat_ms_per_step"] = f_ms
    out["cond_flat"]["sd_updates_per_s"] = n_sd * MULTI_STEPS / best
    out["mpdata"] = dict(launches=launches["mpdata"], max_abs_err=0.0)
    del mm, prt, start
    torch.cuda.empty_cache()
    print(f"phase 23 (a), (c): {time.perf_counter() - t0:.1f} s", flush=True)
    # (b) the gate against the serial flat engine
    t0 = time.perf_counter()
    out["cond_flat"]["gate"] = multi_gate(Kinematic2D, _ext, c, card)
    torch.cuda.empty_cache()
    print(f"phase 23 (b): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # (d) pred_corr and the exact mode
    for label, kw_oi, kernel in (
            ("pred_corr", dict(adve_scheme=as_t.pred_corr), _ext.COND_FLAT),
            ("exact", dict(exact_sstp_cond=True), _ext.COND_SD_FIXED)):
        m = multi_model(Kinematic2D, True, **kw_oi)
        tot = flat_totals(m.prtcls, m.rv, c)
        secs, got = multi_run(m, _ext, MULTI_FORM_STEPS, c, tot,
                              f"phase 23 (d) {label}")
        print(f"multi-device front, {label}: {MULTI_FORM_STEPS} steps in "
              f"{secs:.2f} s ({secs / MULTI_FORM_STEPS * 1e3:.3f} ms/step); "
              f"launches {got} ({card})", flush=True)
        check(got == {"mpdata": 2 * MULTI_FORM_STEPS,
                      kernel.name: MULTI_SHARDS * MULTI_FORM_STEPS},
              f"phase 23 (d) {label}: kernel A twice a step and "
              f"{kernel.name} once a shard a step expected, got {got}")
        if label == "exact":
            g_kw = capture(cond_ops, "perparticle_fixed", lambda: m.run(1),
                           which=None)
            check(len(g_kw) == MULTI_SHARDS, "phase 23 (d): G not once a "
                  "shard")
            check_form("(a shard of the multi-device front, exact)",
                       g_kw[-1], err)
            k = cond_ops.perparticle_fixed(**g_kw[-1])
            pl = cond_ops.perparticle_fixed(**g_kw[-1], plain=True)
            live = g_kw[-1]["sd"][0] > 0
            check(bool(torch.equal(k[0], pl[0])) and all(
                torch.equal(a[live], b[live]) for a, b in zip(k[1:], pl[1:])),
                "phase 23 (d): G on a shard is not bitwise its plain version")
            out["cond_sd_fixed_flat"] = form_row(
                g_kw[-1], got[kernel.name], f"phase 23 (d)'s "
                f"{MULTI_FORM_STEPS} exact steps ({MULTI_SHARDS} shards)",
                err, name="cond_sd_fixed_flat")
        out["cond_flat"][f"{label}_ms_per_step"] = \
            secs / MULTI_FORM_STEPS * 1e3
        del m
        torch.cuda.empty_cache()
    print(f"phase 23 (d): {time.perf_counter() - t0:.1f} s", flush=True)
    for name, part in out.items():
        part["max_abs_err"] = err.get(
            "cond_sd_fixed" if name == "cond_sd_fixed_flat" else name, 0.0)
        for k in ("name", "route", "source", "replaces"):
            part.pop(k, None)
    return out


# ------------------------------------------------------------------ phase 24
def twoproc_phase(_ext, card):
    """Phase 24 (the module docstring): parallel/twoproc.py's TWOPROC_CASE,
    two gloo ranks of 4 shards each on the one card, against the same
    functions run here on all 8.  Returns {kernel row name: its
    "twoproc" entry}."""
    import shutil
    import tempfile
    from pathlib import Path

    from libcloudphxx_tpu_torch.parallel import twoproc
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_twoproc_"))
    try:
        t0 = time.perf_counter()
        ranks = twoproc.launch(
            out / "two", case=TWOPROC_CASE, device=DEVICE, dtype="float32",
            steps=TWOPROC_STEPS, dense_steps=TWOPROC_STEPS,
            timeout=TWOPROC_TIMEOUT, group_timeout=TWOPROC_TIMEOUT / 2)
        t_two = time.perf_counter() - t0
        (out / "one").mkdir()
        t0 = time.perf_counter()
        _, flat = twoproc.run_flat(TWOPROC_CASE, device=DEVICE,
                                   dtype=torch.float32, steps=TWOPROC_STEPS,
                                   out=out / "one")
        dense = twoproc.run_dense(TWOPROC_CASE, device=DEVICE,
                                  dtype=torch.float32, steps=TWOPROC_STEPS,
                                  out=out / "one")
        t_one = time.perf_counter() - t0
        names = [f"{k}_{s}.pt" for k in ("flat", "dense")
                 for s in range(twoproc.N_SHARDS)]
        diff = twoproc.same_files(out / "two", out / "one", names)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    f0, d0 = ranks[0]["flat"], ranks[0]["dense"]
    for r in ranks:
        print(f"twoproc rank {r['rank']} (shards {r['flat']['shards']}): "
              f"flat {r['flat']}; dense {r['dense']}", flush=True)
    print(f"twoproc one process (8 shards): flat {flat}; dense {dense}",
          flush=True)
    print(f"timing two processes x 4 shards on one card (gloo, rank 0 "
          f"between barriers): flat front {f0['ms_per_step']:.3f} ms/step, "
          f"dense mesh {d0['ms_per_step']:.3f} ms/step; one process x 8 "
          f"shards: flat {flat['ms_per_step']:.3f}, dense "
          f"{dense['ms_per_step']:.3f} ms/step ({TWOPROC_STEPS} steps each; "
          f"SDs crossed {d0['crossed']}; the ranks' {t_two:.1f} s, "
          f"interpreters and inits included, the one-process runs' "
          f"{t_one:.1f} s; {card})", flush=True)
    check(not diff, f"phase 24: the two-process shards differ from the "
          f"one-process run's: {diff[:12]}")
    for r in ranks:
        f, d = r["flat"], r["dense"]
        check(all(f[k] == flat[k] for k in ("total0", "total1", "finite"))
              and f["finite"] and f["migration_overflow"] == 0.0
              and 0 < f["total1"] <= f["total0"],
              f"phase 24 (a): rank {r['rank']}'s totals {f} against the "
              f"one-process {flat}")
        check(all(d[k] == dense[k] for k in ("total0", "total1", "crossed"))
              and d["finite"] and d["overflow"] == 0.0 and d["crossed"] > 0,
              f"phase 24 (b): rank {r['rank']}'s readings {d} against the "
              f"one-process {dense}")
        half = TWOPROC_STEPS * twoproc.N_SHARDS // 2
        check(f["launches"] == {"cond_flat": half},
              f"phase 24 (a): F once a shard a step on rank {r['rank']} "
              f"expected, got {f['launches']}")
        check(all(d["launches"].get(k) == half for k in TWOPROC_DENSE),
              f"phase 24 (b): {TWOPROC_DENSE} once a shard a step on rank "
              f"{r['rank']} expected, got {d['launches']}")
    out = {"cond_flat": dict(
        launches_per_rank=[r["flat"]["launches"]["cond_flat"]
                           for r in ranks],
        ms_per_step=f0["ms_per_step"],
        one_process_ms_per_step=flat["ms_per_step"], steps=TWOPROC_STEPS)}
    for k in TWOPROC_DENSE:
        out[k] = dict(launches_per_rank=[r["dense"]["launches"][k]
                                         for r in ranks],
                      mesh_ms_per_step=d0["ms_per_step"],
                      one_process_mesh_ms_per_step=dense["ms_per_step"],
                      steps=TWOPROC_STEPS)
    return out


# ------------------------------------------------------------------ phase 25
def _snapshot(path):
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path) as f:
            return {k: f[k][:] for k in f.keys()}
    with np.load(path) as f:
        return {k: f[k] for k in f.files if not k.startswith("attr_")}


def cli_phase(Kinematic2D, _ext, card):
    """Phase 25 (the module docstring): the icicle CLI at 76x76 on the
    card, its output checked; Kinematic2D.run() at the same settings timed
    beside it.  Returns the CLI's launches by kernel."""
    import os
    import shutil
    import tempfile

    from libcloudphxx_tpu_torch.lgrngn import vt_t
    from libcloudphxx_tpu_torch.models import cli
    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        reset(_ext.KERNELS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main([
            "--micro=lgrngn", f"--nx={NX}", f"--nz={NZ}",
            f"--sd_conc={SD_CONC}", f"--nt={CLI_NT}",
            f"--spinup={CLI_SPINUP}", f"--outfreq={CLI_OUTFREQ}",
            f"--outdir={out}", f"--device={DEVICE}"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.KERNELS if k.launches}
        names = sorted(os.listdir(out))
        want = [f"timestep{t:010d}" for t in range(0, CLI_NT + 1,
                                                     CLI_OUTFREQ)]
        snaps = [n for n in names if n.startswith("timestep")]
        check([n.rsplit(".", 1)[0] for n in snaps] == want
              and any(n.startswith("const.") for n in names)
              and "puddle.dat" in names,
              f"phase 25: the CLI wrote {names}, not const, {want} and "
              f"puddle.dat")
        with open(os.path.join(out, "puddle.dat")) as f:
            puddle = f.read().split("\n\n")
        check(len([b for b in puddle if b.strip()]) == len(want),
              "phase 25: puddle.dat does not hold a block a snapshot")
        bad = []
        for n in snaps:
            f = _snapshot(os.path.join(out, n))
            need = {"th", "rv", "sd_conc", "rd_rng000_mom0",
                    "rw3ofrd_rng000_mom3"} | {
                f"rw_rng000_mom{k}" for k in range(4)} | {
                f"rw_rng001_mom{k}" for k in (0, 3, 6)}
            bad += [f"{n}: missing {sorted(need - set(f))}"] \
                if not need <= set(f) else []
            bad += [f"{n}:{k}" for k, v in f.items()
                    if v.shape != (NX, NZ) or not np.isfinite(v).all()]
        check(not bad, f"phase 25: snapshots malformed: {bad[:10]}")
        last = _snapshot(os.path.join(out, snaps[-1]))
        fmt = os.path.splitext(snaps[-1])[1]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check(launches.get("mpdata") == 2 * CLI_NT
          and launches.get("cond") == CLI_NT
          and launches.get("coal") == CLI_NT - CLI_SPINUP
          and set(launches) == {"mpdata", "cond", "coal", "transport",
                                "merge"},
          f"phase 25: kernels A twice a step, B once, E once a coalescing "
          f"step, C and D expected, got {launches}")
    m = Kinematic2D(nx=NX, nz=NZ, micro="lgrngn", grid="node", fct=True,
                    sd_conc=SD_CONC, n_sd_max=NX * NZ * SD_CONC,
                    kernel_parameters=[0.5],
                    terminal_velocity=vt_t.khvorostyanov_spherical,
                    rng_seed=44, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run(CLI_NT, spinup=CLI_SPINUP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    print(f"CLI (icicle, --micro=lgrngn {NX}x{NZ}, sd_conc {SD_CONC}, nt "
          f"{CLI_NT}, spinup {CLI_SPINUP}, outfreq {CLI_OUTFREQ}, {fmt} "
          f"output): {secs:.2f} s in all, the time loop "
          f"{res['loop_s'] / CLI_NT * 1e3:.3f} ms/step with its output; "
          f"Kinematic2D.run() at the same settings "
          f"{run_s / CLI_NT * 1e3:.3f} ms/step; launches {launches}; "
          f"last snapshot sd_conc sum {float(last['sd_conc'].sum()):.0f}, "
          f"rw_rng001_mom0 max {float(last['rw_rng001_mom0'].max()):.4g} "
          f"({card})", flush=True)
    return launches


# ------------------------------------------------------------------ phase 26
def switch_launches(steps, spinup, kw):
    """The launches of kernels A, B, B's merge-prologue form, D and D's
    MPDATA form that run_device_lgrngn(steps, spinup, engine="dense",
    **kw) makes from a flushed state without far movers: one of A, B and D
    a step by default; defer_x moves every step's merge but the last into
    the next step's B (the run's end flushes the last), mpdata_fuse moves
    A into D's launch but at each phase's first step, and with both A
    runs after every deferred step and at each phase's first."""
    defer, fuse = kw.get("defer_x", False), kw.get("mpdata_fuse", False)
    phases = 2 if 0 < spinup < steps else 1
    return {"mpdata": (phases if fuse else 0)
            + (steps if defer or not fuse else 0),
            "cond": 1 if defer else steps,
            "cond_merged": steps - 1 if defer else 0,
            "merge": 1 if defer else (0 if fuse else steps),
            "merge_mpdata": steps if fuse and not defer else 0}


def same_run(a, b):
    """Whether two (DenseState, th, rv) are bitwise equal: every plane and
    cell field, th, rv and the overflow."""
    (da, tha, rva), (db, thb, rvb) = a, b
    fields = [f.name for f in dataclasses.fields(da)
              if isinstance(getattr(da, f.name), torch.Tensor)]
    return (torch.equal(tha, thb) and torch.equal(rva, rvb)
            and all(torch.equal(getattr(da, f), getattr(db, f))
                    for f in fields))


def switch_profile(m, start, kw, steps=SWITCH_PROFILE_STEPS):
    """Device launches and time a step of ``steps`` coalescing steps of
    run_device_lgrngn(**kw) from ``start`` (torch.profiler): (launches of
    every kernel, launches of the port's kernels, busy ms, {kernel: ms})
    a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    m.dense_state, m.th, m.rv = start
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        m.run_device_lgrngn(steps, engine="dense", **kw)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    mine = {k.split("(")[0].replace("void ", ""): ms for k, ms, _ in rows
            if "lcp::" in k}
    return (sum(r[2] for r in rows), sum(r[2] for r in rows
                                         if "lcp::" in r[0]),
            sum(r[1] for r in rows), mine)


def switches_phase(Kinematic2D, dense, _ext, step, mpdata, card):
    """Phase 26 (the module docstring): run_device_lgrngn's defer_x and
    mpdata_fuse on bench.py's case.  Returns the kernel rows of B's
    merge-prologue form and D's MPDATA-epilogue form."""
    from libcloudphxx_tpu_torch.models.mpdata import _advect_body
    m = make_model(Kinematic2D, coal=True)
    init = (m.dense_state, m.th, m.rv)
    totals = dense.water_dry_totals(init[0], init[2])
    err, runs, got = {}, {}, {}
    # (a) the four runs from init, their launches counted
    for label, kw in SWITCHES.items():
        m.dense_state, m.th, m.rv = init
        reset(_ext.KERNELS)
        m.run_device_lgrngn(TIME_STEPS, spinup=SWITCH_SPINUP, engine="dense",
                            **kw)
        torch.cuda.synchronize()
        physics_checks(m, *totals, dense)
        runs[label] = (m.dense_state, m.th, m.rv)
        want = switch_launches(TIME_STEPS, SWITCH_SPINUP, kw)
        got[label] = {k.name: k.launches for k in _ext.KERNELS
                      if k.name in want}
        same = label == "default" or same_run(runs[label], runs["default"])
        print(f"phase 26 (a) {label}: {SWITCH_SPINUP} spin-up + "
              f"{TIME_STEPS - SWITCH_SPINUP} steps, launches {got[label]}, "
              f"the default run's bits {same}", flush=True)
        check(got[label] == want, f"phase 26 {label}: launches {got[label]}, "
              f"expected {want}")
        check(same, f"phase 26 {label}: the run differs from the default")
    # (b) defer_x with the repack policy: chunk ends on pending merges
    logs = {}
    for defer in (False, True):
        m.dense_state, m.th, m.rv = init
        log = []
        m.run_device_lgrngn(TIME_STEPS, spinup=SWITCH_SPINUP, engine="dense",
                            repack_every=SWITCH_REPACK, chunk_log=log,
                            defer_x=defer)
        logs[defer] = ([{k: v for k, v in e.items() if k != "seconds"}
                        for e in log], (m.dense_state, m.th, m.rv))
    same = logs[True][0] == logs[False][0] and same_run(logs[True][1],
                                                        logs[False][1])
    print(f"phase 26 (b) defer_x, repack_every={SWITCH_REPACK}: "
          f"{len(logs[True][0])} chunks, the default twin's bits and chunk "
          f"log {same}", flush=True)
    check(same, "phase 26: defer_x with the repack policy differs from its "
          "default twin")

    # (c) each form against its plain version on what a step gives it
    m.dense_state, m.th, m.rv = init
    m.run_device_lgrngn(SWITCH_SPINUP, spinup=SWITCH_SPINUP, engine="dense")
    s_sp = (m.dense_state, m.th, m.rv)

    def set_state(s):
        m.dense_state, m.th, m.rv = s

    b_kw = capture(step, "cond", lambda: (
        set_state(s_sp), m.run_device_lgrngn(2, engine="dense",
                                             defer_x=True)))
    check(b_kw.get("pending_tgt") is not None,
          "phase 26: the second deferred step's B had no pending merge")
    kb, pb = step.cond(**b_kw), step.cond(**b_kw, plain=True)
    torch.cuda.synchronize()
    live = pb[7] > 0
    planes_same = all(torch.equal(a, b) for a, b in zip(kb[7:], pb[7:]))
    rel = (max_rel(kb[1], pb[1]), max_rel(kb[2], pb[2]),
           max_rel(kb[0][live], pb[0][live]))
    err["cond_merged"] = max(max_abs(kb[0][live], pb[0][live]),
                             *(max_abs(a, b) for a, b in zip(kb[1:], pb[1:])))
    moved = int((b_kw["pending_tgt"] != torch.arange(
        b_kw["n"].shape[0], device=live.device)[:, None])[
            b_kw["n"] > 0].sum())
    print(f"B cond_merged: {int(live.sum())} SDs, {moved} of them merged "
          f"from another row; merged planes and drops bitwise "
          f"{planes_same}; th rel {rel[0]:.2e}, rv rel {rel[1]:.2e}, rw2 "
          f"rel {rel[2]:.2e}", flush=True)
    check(planes_same and rel[0] <= 2e-6 and rel[1] <= 2e-5
          and rel[2] <= 1e-5,
          "B's merge-prologue form disagrees with its plain version")
    calls = capture(dense, "rebin_x", lambda: (
        set_state(s_sp), m.run_device_lgrngn(1, engine="dense",
                                             mpdata_fuse=True)), which=None)
    d_kw = [c for c in calls if c.get("mpdata") is not None]
    check(len(d_kw) == 1, f"phase 26: {len(d_kw)} D calls with the "
          f"epilogue in a fused step")
    d_kw = d_kw[0]
    th, rv, gc_x, gc_z, G, n_iters, fct = d_kw["mpdata"]
    kd, pd = step.rebin_x(**d_kw), step.rebin_x(**d_kw, plain=True)
    d_plain_kw = {a: v for a, v in d_kw.items() if a != "mpdata"}
    d_only = step.rebin_x(**d_plain_kw)
    a_k = mpdata.advect2(th.reshape(NX, NZ), rv.reshape(NX, NZ), gc_x, gc_z,
                         G, n_iters=n_iters, fct=fct)
    a_p = tuple(_advect_body(f.reshape(NX, NZ), gc_x, gc_z, G, n_iters, fct)
                for f in (th, rv))
    torch.cuda.synchronize()
    same_d = all(torch.equal(a, b) and torch.equal(a, c)
                 for a, b, c in zip(kd[:8], pd[:8], d_only))
    same_a = all(torch.equal(a, b) and torch.equal(a, c)
                 for a, b, c in zip(kd[8:], a_k, a_p))
    err["merge_mpdata"] = max(max_abs(a, b) for a, b in zip(kd, pd))
    print(f"D merge_mpdata: planes and drops bitwise D's and the plain "
          f"version's {same_d}; th and rv bitwise kernel A's and "
          f"_advect_body's {same_a} (n_iters {n_iters}, fct {fct})",
          flush=True)
    check(same_d and same_a, "D's MPDATA-epilogue form disagrees")

    # (d) ms/step, best of TIME_REPS from init, and (e) the profile
    ms_step, prof = {}, {}
    for label, kw in SWITCHES.items():
        m.dense_state, m.th, m.rv = init
        m.run_device_lgrngn(2, engine="dense", **kw)       # warm-up
        best = float("inf")
        for _ in range(TIME_REPS):
            m.dense_state, m.th, m.rv = init
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.run_device_lgrngn(TIME_STEPS, engine="dense", **kw)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            physics_checks(m, *totals, dense)
        ms_step[label] = best / TIME_STEPS * 1e3
        prof[label] = switch_profile(m, s_sp, kw)
        n_all, n_mine, busy, mine = prof[label]
        print(f"timing {label}: {ms_step[label]:.3f} ms/step ({TIME_STEPS} "
              f"steps from init, best of {TIME_REPS}); profile of "
              f"{SWITCH_PROFILE_STEPS} coalescing steps: {n_all:.1f} device "
              f"launches a step, {n_mine:.1f} of the port's kernels, busy "
              f"{busy:.4f} ms; " + ", ".join(
                  f"{name} {v:.4f}" for name, v in sorted(mine.items()))
              + f" ms a step ({card})", flush=True)
    m.dense_state, m.th, m.rv = init

    # (f) the forms alone and what they replace, (g) their bounds
    merged_kw = {a: v for a, v in b_kw.items()
                 if a not in ("pending_tgt", "vt", "x", "z")}
    merged_kw.update(n=pb[7], rw2=pb[8], rd3=pb[9], kpa=pb[10])
    d_bytes, d_ops = merge_work(b_kw["pending_tgt"], b_kw["n"])
    b_bytes, b_ops, b_ops64 = cond_kw_work(merged_kw)
    dm_bytes, dm_ops = merge_work(d_kw["tgt"], d_kw["n"])
    a_bytes, a_ops = mpdata_work((th, rv), (gc_x, gc_z, G), n_iters, fct)
    bounds = {"cond_merged": bound(b_bytes + d_bytes, b_ops + d_ops, b_ops64),
              "merge_mpdata": bound(dm_bytes + a_bytes, dm_ops + a_ops)}
    timed = {
        "cond_merged": (lambda plain: step.cond(**b_kw, plain=plain),
                        "B alone on the merged rows",
                        lambda: step.cond(**merged_kw)),
        "merge_mpdata": (lambda plain: step.rebin_x(**d_kw, plain=plain),
                         "D alone",
                         lambda: step.rebin_x(**d_plain_kw))}
    a_ms = time_cuda(lambda: mpdata.advect2(
        th.reshape(NX, NZ), rv.reshape(NX, NZ), gc_x, gc_z, G,
        n_iters=n_iters, fct=fct), KERNEL_REPS)
    kernel_names = {"cond_merged": "cond_kernel", "merge_mpdata":
                    "merge_mpdata_kernel"}
    launches = {"cond_merged": got["defer_x"]["cond_merged"],
                "merge_mpdata": got["mpdata_fuse"]["merge_mpdata"]}
    where = {"cond_merged": "defer_x", "merge_mpdata": "mpdata_fuse"}
    rows = []
    for name, (call, alone, other) in timed.items():
        kernel = getattr(_ext, name.upper())
        ms = time_cuda(lambda: call(False), KERNEL_REPS)
        plain_ms = time_cuda(lambda: call(True), FORM_PLAIN_REPS)
        other_ms = time_cuda(other, KERNEL_REPS)
        in_step = sum(v for k, v in prof[where[name]][3].items()
                      if kernel_names[name] in k
                      and (name != "cond_merged" or "MergePrologue" in k))
        bound_ms, bound_by = bounds[name]
        print(f"kernel {name}: {ms:.4f} ms a call, in the step "
              f"{in_step:.4f} ms; {alone} {other_ms:.4f} ms"
              + (f", A alone {a_ms:.4f} ms" if name == "merge_mpdata"
                 else "") + f"; plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}); {launches[name]} launches "
              f"in the {where[name]} run ({card})", flush=True)
        check(launches[name] > 0, f"kernel {name} was not launched")
        rows.append({"name": name, "route": "cuda", "source": kernel.source,
                     "replaces": kernel.replaces,
                     "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "in_step_ms": in_step, "ms_per_step": ms_step})
    return rows


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
    print(f"profile {label}: {steps} steps, wall {wall:.3f} "
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
