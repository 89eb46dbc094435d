"""Kernels C's, D's and E's 3-D forms and E's onishi form at the shapes of
chip_smoke.py phase 22, and E's 2-D rows above capacity 128 at the shapes
of phases 12 and 17 (b), as a record two trees can be compared by: the
76^3 dense front from the factory (phase 19's fields) with the geometric
kernel (C's implicit form, D's eight planes and E's y form at capacity
128), with vohl, pred_corr and the large tail (C's pred_corr form and E's
vohl y form at capacity 256) and in the exact mode (D's twelve planes);
bench.py's 76x76 case with onishi_hall on the dense engine (E's onishi
form); phase 12's 118 SDs a cell at capacities 256 and 512, and through
the repack policy from 128 (E's 2-D rows there); phase 17 (b)'s vohl,
pred_corr and large tail at 76x76 (E's vohl rows at capacity 256).  Each
3-D case runs WARM steps, then one step whose calls of transport, rebin_x
and coal_resident are captured; on those arguments each kernel is timed
(CUDA events over REPS calls) and its results are digested (SHA-256 of
every output); then the device time a step of each kernel (torch.profiler
over PROFILE steps) and the ms/step of STEPS steps, and the state's digest
after them.  The 2-D cases do the same for coal_resident.

It runs the package and chip_smoke.py of the tree it sits in
(``scripts/..``), on the card:

    python3 scripts/dense3d_forms.py OUT_DIR

writes OUT_DIR/report.json, and

    python3 scripts/dense3d_forms.py --compare DIR_A DIR_B [DIR_C ...]

prints each kernel's times side by side and whether the digests agree
(the same inputs from the same seed: both trees' kernels bitwise the
plain versions' give the same bits).  For an A/B against another commit,
``git archive`` it into ``_archive/`` (ignored), copy this script into
its ``scripts/``, and run it there and here in one chip call (parent,
this, this, parent).
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARM, REPS, PROFILE, STEPS = 2, 10, 3, 5


def _digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _kernels(cs, calls, reps):
    """{wrapper: {"ms", "digest"}} of the captured ``calls`` ({name:
    (fn, kwargs)})."""
    out = {}
    for name, (fn, kw) in calls.items():
        digest = _digest(fn(**kw))
        out[name] = {"ms": cs.time_cuda(lambda: fn(**kw), reps),
                     "digest": digest}
    return out


def _front_case(cs, label, fields, m2, over):
    """One 3-D case on the dense front: its kernels' record."""
    import torch

    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.ops import coal, step
    oi = cs.grid_oi(m2, 3, **over)
    prt = cs.dense3d_factory(oi, label)
    init, _ = cs.dense3d_init(prt, fields, label, "")
    opts = tl.opts_t()
    opts.adve = opts.cond = opts.coal = opts.sedi = True
    cs.dense3d_run(prt, opts, WARM, fields)
    got = cs.capture_all({"e": (coal, "coal_resident"),
                          "d": (dense, "rebin_x"),
                          "c": (step, "transport")},
                         lambda: cs.dense3d_run(prt, opts, 1, fields))
    rec = {"cap": int(prt._d.cap), "kernels": _kernels(cs, {
        "transport": (step.transport, got["c"][-1]),
        "rebin_x": (step.rebin_x, got["d"][-1]),
        "coal_resident": (coal.coal_resident, got["e"][-1])}, REPS)}
    del got
    prt.adopt(init)
    rec["in_step_ms"] = cs.device_ms(
        lambda k: cs.dense3d_run(prt, opts, k, fields), PROFILE,
        ("cond", "coal", "transport", "merge3d"))
    prt.adopt(init)
    secs, _, _, _ = cs.dense3d_run(prt, opts, STEPS, fields)
    rec["ms_per_step"] = secs / STEPS * 1e3
    rec["state"] = _digest(getattr(prt._d, a)
                           for a in dense.attrs_of(prt.cfg))
    prt.state = None
    del prt, init
    torch.cuda.empty_cache()
    return rec


def _onishi_case(cs, Kinematic2D):
    """bench.py's case with onishi_hall on the dense engine: E's onishi
    form's record."""
    import torch

    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.ops import coal
    m = cs.make_model(Kinematic2D, coal=True, kernel=tl.kernel_t.onishi_hall,
                      kernel_parameters=[cs.LES_RE_LAMBDA])
    init = (m.dense_state, m.th, m.rv)
    m.run_device_lgrngn(cs.SLICE_SPINUP, spinup=cs.SLICE_SPINUP,
                        engine="dense")
    kw = cs.capture(coal, "coal_resident",
                    lambda: m.run_device_lgrngn(1, engine="dense"))
    rec = {"cap": int(kw["n"].shape[1]), "kernels": _kernels(
        cs, {"coal_resident": (coal.coal_resident, kw)}, 20)}
    m.dense_state, m.th, m.rv = init
    rec["in_step_ms"] = cs.device_ms(
        lambda k: m.run_device_lgrngn(k, engine="dense"), 5, ("coal",))
    m.dense_state, m.th, m.rv = init
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_device_lgrngn(20, engine="dense")
    torch.cuda.synchronize()
    rec["ms_per_step"] = (time.perf_counter() - t0) / 20 * 1e3
    rec["state"] = _digest(getattr(m.dense_state, a) for a in dense.ATTRS)
    del m, init, kw
    torch.cuda.empty_cache()
    return rec


def _rows2d_case(cs, m, init, kw):
    """E's record on a 76x76 model ``m`` from ``init`` (state, th, rv):
    coal_resident on ``kw`` (a step's arguments), its device time a step,
    the ms/step of STEPS * 4 steps and the state's digest after them."""
    import torch

    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.ops import coal

    def restore():
        m.dense_state, m.th, m.rv = init

    rec = {"cap": int(kw["n"].shape[1]), "one_warp_rows": float(
        (~(kw["n"][:, 128:] > 0).any(1)).float().mean()), "kernels":
        _kernels(cs, {"coal_resident": (coal.coal_resident, kw)}, 20)}
    restore()
    rec["in_step_ms"] = cs.device_ms(
        lambda k: m.run_device_lgrngn(k, engine="dense"), 5, ("coal",))
    restore()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_device_lgrngn(4 * STEPS, engine="dense")
    torch.cuda.synchronize()
    rec["ms_per_step"] = (time.perf_counter() - t0) / (4 * STEPS) * 1e3
    rec["state"] = _digest(getattr(m.dense_state, a) for a in dense.ATTRS)
    return rec


def _forced_cases(cs, Kinematic2D):
    """Phase 12's population (118 SDs a cell): E's 2-D rows at capacities
    256 and 512, and the repack policy's run from 128 (its end state)."""
    import torch

    from libcloudphxx_tpu_torch.lgrngn import dense
    from libcloudphxx_tpu_torch.ops import coal
    m = cs.make_model(Kinematic2D, coal=True, sd_conc=cs.FORCED_SD_CONC)
    d0, th0, rv0 = m.dense_state, m.th, m.rv
    out = {}
    for cap in (256, 512):
        init = (dense.repack(m.cfg, d0, cap), th0, rv0)
        m.dense_state, m.th, m.rv = init
        kw = cs.capture(coal, "coal_resident",
                        lambda: m.run_device_lgrngn(1, engine="dense"))
        out[f"forced_{cap}"] = _rows2d_case(cs, m, init, kw)
    m.dense_state, m.th, m.rv = d0, th0, rv0
    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_device_lgrngn(3 * cs.FORCED_EVERY, engine="dense",
                        repack_every=cs.FORCED_EVERY,
                        repack_margin=cs.REPACK_MARGIN, chunk_log=log)
    torch.cuda.synchronize()
    out["forced_grow"] = {
        "cap": [e["cap"] for e in log], "kernels": {}, "in_step_ms": {},
        "ms_per_step": (time.perf_counter() - t0) / (3 * cs.FORCED_EVERY)
        * 1e3,
        "state": _digest(getattr(m.dense_state, a) for a in dense.ATTRS)}
    del m
    torch.cuda.empty_cache()
    return out


def _vohl2d_case(cs, Kinematic2D):
    """Phase 17 (b)'s vohl, pred_corr and large tail at 76x76 after its
    spin-up: E's vohl rows at capacity 256."""
    from libcloudphxx_tpu_torch.ops import coal
    m = cs.option_model(Kinematic2D, "vohl_pred_corr")
    m.run_device_lgrngn(cs.OPTION_SPINUP, spinup=cs.OPTION_SPINUP,
                        engine="dense")
    init = (m.dense_state, m.th, m.rv)
    kw = cs.capture(coal, "coal_resident",
                    lambda: m.run_device_lgrngn(1, engine="dense"))
    return _rows2d_case(cs, m, init, kw)


def run(out_dir):
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from libcloudphxx_tpu_torch import Kinematic2D, _ext
    from libcloudphxx_tpu_torch import lgrngn as tl
    if not torch.cuda.is_available():
        raise SystemExit("dense3d_forms.py needs a CUDA card")
    out_dir.mkdir(parents=True, exist_ok=True)
    _, build_s, _ = _ext.build()
    _ext.load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    fields, m2 = cs.grid3d_fields(Kinematic2D)
    wide = 2 * cs.SD_CONC * cs.GRID_N ** 3
    cases = {"3d": {}, "3d_vohl": dict(
        n_sd_max=wide, adve_scheme=tl.as_t.pred_corr,
        kernel=tl.kernel_t.vohl_davis_no_waals, sd_conc_large_tail=True),
        "3d_exact": dict(n_sd_max=wide, exact_sstp_cond=True)}
    report = {"tree": str(ROOT), "card": card, "build_s": build_s,
              "cases": {}}
    for label, over in cases.items():
        t0 = time.perf_counter()
        report["cases"][label] = _front_case(cs, label, fields, m2, over)
        print(f"{label}: {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(report['cases'][label])}", flush=True)
    del fields, m2
    torch.cuda.empty_cache()
    report["cases"]["onishi"] = _onishi_case(cs, Kinematic2D)
    for label, rec in _forced_cases(cs, Kinematic2D).items():
        report["cases"][label] = rec
    report["cases"]["vohl_2d"] = _vohl2d_case(cs, Kinematic2D)
    print(json.dumps({k: report["cases"][k] for k in (
        "forced_256", "forced_512", "forced_grow", "vohl_2d")}), flush=True)
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"tree": report["tree"], "card": card,
                      "build_s": build_s}))


def compare(dirs):
    reps = [json.loads((d / "report.json").read_text()) for d in dirs]
    rows, differ = {}, []
    for label, case in reps[0]["cases"].items():
        for name in case["kernels"]:
            k = [r["cases"][label]["kernels"][name] for r in reps]
            if len({x["digest"] for x in k}) != 1:
                differ.append(f"{label} {name}")
            rows[f"{label} {name} ms"] = [x["ms"] for x in k]
        for key, _ in case["in_step_ms"].items():
            rows[f"{label} in step {key}"] = [
                r["cases"][label]["in_step_ms"].get(key) for r in reps]
        rows[f"{label} ms/step"] = [r["cases"][label]["ms_per_step"]
                                    for r in reps]
        if len({r["cases"][label]["state"] for r in reps}) != 1:
            differ.append(f"{label} state")
    print(json.dumps({"trees": [r["tree"] for r in reps],
                      "cards": sorted({r["card"] for r in reps}),
                      "bitwise": not differ, "differ": differ,
                      "rows": rows}, indent=1))
    return 0 if not differ else 1


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--compare", action="store_true")
    opts = ap.parse_args(argv)
    if opts.compare:
        return compare(opts.dirs)
    run(opts.dirs[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
