#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libcloudphxx_tpu_torch) on one GPU.

Drives the port's main path, the GMD-2015 kinematic lgrngn case at 76x76
cells and 64 super-droplets a cell (bench.py's configuration) with
coalescence off, and checks it:

  1. device: the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build: compile the kernels from csrc/
  3. kernels against their plain PyTorch versions, on the card, at the main
     path's shapes, from the real initial population
  4. the slice: spin-up steps, then steps with sedimentation, through the
     kernels; bench.py's physics checks; every kernel launched
  5. timing: best of 3 from-init reps through the kernels and through the
     plain versions, and each kernel against its plain version

Run from the repository root: ``python3 chip_smoke.py``.  The last line is
{"ok": true, "device": {...}}; the line before it the card's name and power
limit; before that one JSON object with a row per kernel.  Any failed check
raises, and the script exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NX = NZ = 76
SD_CONC = 64
SSTP_COND = 10
SSTP_COAL = 10
SLICE_SPINUP, SLICE_MAIN = 10, 10
TIME_STEPS, TIME_REPS = 50, 3
KERNEL_REPS = 20


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


def make_model(Kinematic2D):
    return Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=SD_CONC, sstp_cond=SSTP_COND,
        sstp_coal=SSTP_COAL, n_sd_max=SD_CONC * NX * NZ,
        opts_init_kw={"coal_switch": False}, device="cuda")


def physics_checks(model, water0, dry0, dense):
    """bench.py:45-96 on the port's state."""
    d = model.state
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


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from libcloudphxx_tpu_torch import Kinematic2D, _ext
    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    from libcloudphxx_tpu_torch.lgrngn.state import OUT_PRTCL_NUM
    from libcloudphxx_tpu_torch.models import mpdata
    from libcloudphxx_tpu_torch.ops import step

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build
    path, secs, log = _ext.build(verbose=True)
    print(f"build: {secs:.1f} s -> {path.name}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _ext.load()

    # ---- 3. kernels against plain versions
    t0 = time.perf_counter()
    model = make_model(Kinematic2D)
    torch.cuda.synchronize()
    d0, th0, rv0 = model.state, model.th, model.rv
    cfg = model.cfg
    n_sd = int((d0.n > 0).sum())
    print(f"init: {n_sd} SDs, cap {d0.cap}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    err = {}

    # A: MPDATA, 1 and 2 fields, FCT off and on, on perturbed fields
    rng = np.random.default_rng(0)
    like = lambda a: torch.as_tensor(a, dtype=th0.dtype, device=th0.device)
    th_p = th0 + like(rng.normal(0.0, 0.5, (NX, NZ)))
    rv_p = rv0 * (1.0 + like(rng.uniform(-0.05, 0.05, (NX, NZ))))
    err["mpdata"] = 0.0
    for fct in (False, True):
        for n_iters in (2, 3):
            mp = (model.gc_x, model.gc_z, model.G, n_iters, fct)
            k1 = mpdata.advect(th_p, *mp)
            p1 = mpdata.advect(th_p, *mp, plain=True)
            k2 = mpdata.advect2(th_p, rv_p, *mp)
            p2 = mpdata.advect2(th_p, rv_p, *mp, plain=True)
            rel = max(max_rel(k1, p1), max_rel(k2[0], p2[0]),
                      max_rel(k2[1], p2[1]))
            err["mpdata"] = max(err["mpdata"], max_abs(k1, p1),
                                max_abs(k2[0], p2[0]), max_abs(k2[1], p2[1]))
            print(f"A mpdata fct={fct} n_iters={n_iters}: max rel {rel:.2e}")
            check(rel <= 1e-5, f"mpdata fct={fct} n_iters={n_iters}: "
                  f"rel {rel:.2e} > 1e-5")

    # B: condensation, post-spin-up RH cap, from the initial population
    tha, rva = mpdata.advect2(th0, rv0, model.gc_x, model.gc_z, model.G)
    lam_D, lam_K = hskpng_mfp(d0.T, d0.p)
    cond_args = (cfg, SSTP_COND, 1.0, 44.0, d0.n, d0.rw2, d0.rd3, d0.kpa,
                 tha.reshape(-1), rva.reshape(-1), d0.sstp_tmp_th,
                 d0.sstp_tmp_rv, d0.rhod, d0.dv, lam_D, lam_K, d0.p)
    kb = step.cond(*cond_args)
    pb = step.cond(*cond_args, plain=True)
    rel_th, rel_rv = max_rel(kb[1], pb[1]), max_rel(kb[2], pb[2])
    rel_rw2 = max_rel(kb[0][d0.n > 0], pb[0][d0.n > 0])
    err["cond"] = max_abs(kb[0], pb[0])
    print(f"B cond: th rel {rel_th:.2e}, rv rel {rel_rv:.2e}, rw2 rel "
          f"{rel_rw2:.2e} (per lane)")
    check(rel_th <= 2e-6 and rel_rv <= 2e-5 and rel_rw2 <= 1e-5,
          "cond kernel disagrees with its plain version")

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
        tgt_same = bool(torch.equal(kc[4], pc[4]))
        err["transport"] = max(err["transport"], max_abs(kc[1], pc[1]),
                               max_abs(kc[2], pc[2]), max_abs(kc[3], pc[3]))
        kd = step.rebin_x(cfg, kc[0], w2, d0.rd3, d0.kpa, kc[3], kc[1], kc[2],
                          kc[4])
        pd = step.rebin_x(cfg, pc[0], w2, d0.rd3, d0.kpa, pc[3], pc[1], pc[2],
                          pc[4], plain=True)
        mk = multiset(kd[0], (kd[2], kd[3], kd[1], kd[5], kd[6]))
        mp = multiset(pd[0], (pd[2], pd[3], pd[1], pd[5], pd[6]))
        check(mk.shape == mp.shape, f"{label}: SD counts differ")
        check(np.array_equal(mk[:, :4], mp[:, :4]),
              f"{label}: cells / n / rd3 / kappa differ")
        check(mk.shape[0] > 0, f"{label}: no SD left")
        rel_ms = float(np.max(np.abs(mk[:, 4:] - mp[:, 4:])
                              / np.maximum(np.abs(mp[:, 4:]), 1e-300)))
        err["merge"] = max(err["merge"],
                           float(np.max(np.abs(mk[:, 4:] - mp[:, 4:]))))
        ovf_k, ovf_p = float(kd[7].sum()), float(pd[7].sum())
        pud_k, pud_p = kc[5].sum(0), pc[5].sum(0)
        rel_pud = max_rel(pud_k[:4], pud_p[:4]) if float(pud_p[3]) else \
            float(pud_k[:4].abs().max())
        lanes = all(torch.equal(a, b) for a, b in zip(kd[:7], pd[:7]))
        print(f"C+D {label}: {mk.shape[0]} SDs, targets equal {tgt_same}, "
              f"multiset rw2/x/z rel {rel_ms:.2e}, lanes equal {lanes}, "
              f"overflow {ovf_k:.0f}/{ovf_p:.0f}, far {float(pud_k[4]):.0f}/"
              f"{float(pud_p[4]):.0f}, puddle prt_num {float(pud_k[3]):.6g} "
              f"rel {rel_pud:.2e}")
        check(rel_ms <= 1e-6, f"{label}: rw2/x/z rel {rel_ms:.2e} > 1e-6")
        check(ovf_k == ovf_p, f"{label}: overflow differs")
        check(float(pud_k[4]) == float(pud_p[4]), f"{label}: far flag differs")
        check(rel_pud <= 1e-5, f"{label}: puddle rel {rel_pud:.2e} > 1e-5")
    check(float(pc[5].sum(0)[3]) > 0, "rain case: nothing reached the puddle")

    # ---- 4. the slice through the kernels
    water0, dry0 = dense.water_dry_totals(d0, rv0)
    for k in _ext.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    model.run_device_lgrngn(SLICE_SPINUP + SLICE_MAIN, spinup=SLICE_SPINUP)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.KERNELS}
    dw, dd = physics_checks(model, water0, dry0, dense)
    puddle = model.state.puddle
    print(f"slice: {SLICE_SPINUP} spin-up + {SLICE_MAIN} main steps in "
          f"{secs:.2f} s; water rel err {dw:.2e}, dry rel err {dd:.2e}, "
          f"overflow {int(model.state.overflow)}, SDs "
          f"{int((model.state.n > 0).sum())}, max occupancy "
          f"{int((model.state.n > 0).sum(1).max())}/{model.state.cap}, "
          f"puddle particles {float(puddle[OUT_PRTCL_NUM]):.6g}; launches "
          f"{launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")

    # ---- 5. timing: from-init reps through the kernels and the plain path
    def run_reps(plain):
        model.run_device_lgrngn(2, plain=plain)  # warm-up
        best = float("inf")
        for _ in range(TIME_REPS):
            model.state, model.th, model.rv = d0, th0, rv0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.run_device_lgrngn(TIME_STEPS, plain=plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            physics_checks(model, water0, dry0, dense)
        out = (model.th, model.rv, model.state)
        model.state, model.th, model.rv = d0, th0, rv0
        return best, out

    t_k, (th_k, rv_k, s_k) = run_reps(False)
    t_p, (th_p2, rv_p2, s_p) = run_reps(True)
    rel_th, rel_rv = max_rel(th_k, th_p2), max_rel(rv_k, rv_p2)
    wk = dense.water_dry_totals(s_k, rv_k)[0]
    wp = dense.water_dry_totals(s_p, rv_p2)[0]
    for label, t in (("kernels", t_k), ("plain", t_p)):
        print(f"timing {label}: {t / TIME_STEPS * 1e3:.3f} ms/step, "
              f"{n_sd * TIME_STEPS / t:.4g} SD-updates/s ({TIME_STEPS} steps, "
              f"best of {TIME_REPS}; {card})")
    print(f"kernels vs plain after {TIME_STEPS} steps: th rel {rel_th:.2e}, "
          f"rv rel {rel_rv:.2e}, total water rel {abs(wk - wp) / wp:.2e}")
    check(rel_th <= 1e-4 and rel_rv <= 1e-3,
          "the kernel path drifted from the plain path")

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
    }
    rows = []
    for k in _ext.KERNELS:
        ms = time_cuda(lambda: calls[k.name](False), KERNEL_REPS)
        plain_ms = time_cuda(lambda: calls[k.name](True), KERNEL_REPS)
        print(f"kernel {k.name}: {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": err[k.name], "ms": ms,
                     "plain_ms": plain_ms})

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
