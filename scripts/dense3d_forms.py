"""Kernel D's 3-D forms and kernel E's y and onishi forms at the shapes of
chip_smoke.py phase 22, as a record two trees can be compared by: the 76^3
dense front from the factory (phase 19's fields) with the geometric kernel
(D's eight planes and E's y form at capacity 128), with vohl, pred_corr
and the large tail (E's vohl y form at capacity 256) and in the exact mode
(D's twelve planes), and bench.py's 76x76 case with onishi_hall on the
dense engine (E's onishi form).  Each case runs WARM steps, then one step
whose calls of rebin_x and coal_resident are captured; on those arguments
each kernel is timed (CUDA events over REPS calls) and its results are
digested (SHA-256 of every output); then the device time a step of each
kernel (torch.profiler over PROFILE steps) and the ms/step of STEPS steps.

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
                          "d": (dense, "rebin_x")},
                         lambda: cs.dense3d_run(prt, opts, 1, fields))
    rec = {"cap": int(prt._d.cap), "kernels": _kernels(cs, {
        "rebin_x": (step.rebin_x, got["d"][-1]),
        "coal_resident": (coal.coal_resident, got["e"][-1])}, REPS)}
    del got
    prt.adopt(init)
    rec["in_step_ms"] = cs.device_ms(
        lambda k: cs.dense3d_run(prt, opts, k, fields), PROFILE,
        ("cond", "coal", "transport_kernel", "merge3d"))
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
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"tree": report["tree"], "card": card,
                      "build_s": build_s}))


def compare(dirs):
    reps = [json.loads((d / "report.json").read_text()) for d in dirs]
    rows, same = {}, True
    for label, case in reps[0]["cases"].items():
        for name in case["kernels"]:
            k = [r["cases"][label]["kernels"][name] for r in reps]
            same &= len({x["digest"] for x in k}) == 1
            rows[f"{label} {name} ms"] = [x["ms"] for x in k]
        for key, _ in case["in_step_ms"].items():
            rows[f"{label} in step {key}"] = [
                r["cases"][label]["in_step_ms"].get(key) for r in reps]
        rows[f"{label} ms/step"] = [r["cases"][label]["ms_per_step"]
                                    for r in reps]
        same &= len({r["cases"][label]["state"] for r in reps}) == 1
    print(json.dumps({"trees": [r["tree"] for r in reps],
                      "cards": sorted({r["card"] for r in reps}),
                      "bitwise": same, "rows": rows}, indent=1))
    return 0 if same else 1


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
