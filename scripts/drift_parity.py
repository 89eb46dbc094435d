"""Long-run parity of the port with the JAX package: DRIFT_1000_r03.json's
case on the CPU through both packages at float64.

The case (tools/drift_1000step.py:48-51): the GMD-2015 kinematic lgrngn
model at 48x48 cells on the reference icicle's node grid with the FCT
limiter, sd_conc 32, sstp_cond = sstp_coal = 5, run_device_lgrngn(1000,
spinup=800) on the flat engine.  Both runs start from the same population
(the same numpy draws).  The 800 spin-up steps have no coalescence and
compare deterministically; the last 200 draw the port's Philox numbers
and JAX's jax.random ones, two streams that never agree draw for draw, so
there the comparison is a statistical one: the same metrics and the
domain means, against DRIFT_1000_r03.json's float32-against-float64
envelope of one code (same code, same draws).  For th, rv, sd_conc and the
wet third moment it reports max_abs, max_rel and rms_rel (JAX's field the
reference), as DRIFT_1000_r03.json does, after the spin-up and at the
end, and whether each lies inside the envelope.

    python scripts/drift_parity.py [--nx 48] [--nt 1000] [--spinup 800]
                                   [--out DRIFT_PORT_1000.json]

Run from the repository root; it imports both packages, so it needs JAX
(this is not part of the tier-1 tests: at 48x48 it runs for several
minutes).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FIELDS = ("th", "rv", "sd_conc", "wet_mom3")


def fields(m):
    """The compared fields of a model (either package) as float64 numpy."""
    p = m.prtcls
    p.diag_all()
    p.diag_sd_conc()
    sd = np.array(p.outbuf())
    p.diag_all()
    p.diag_wet_mom(3)
    m3 = np.array(p.outbuf())
    as_np = lambda a: a.numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return dict(th=as_np(m.th).reshape(-1), rv=as_np(m.rv).reshape(-1),
                sd_conc=sd, wet_mom3=m3)


def metrics(ref, got):
    """DRIFT_1000_r03.json's metrics of ``got`` against ``ref``, and the
    domain means of both."""
    d = np.abs(got - ref)
    rel = d / np.maximum(np.abs(ref), 1e-30)
    return {"max_abs": float(d.max()), "max_rel": float(rel.max()),
            "rms_rel": float(np.sqrt(np.mean(rel ** 2))),
            "mean_ref": float(ref.mean()), "mean_port": float(got.mean())}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--nt", type=int, default=1000)
    ap.add_argument("--spinup", type=int, default=800)
    ap.add_argument("--out", type=Path, default=ROOT / "DRIFT_PORT_1000.json")
    opts = ap.parse_args(argv)
    from libcloudphxx_tpu.models import Kinematic2D as JaxKinematic2D
    from libcloudphxx_tpu_torch import Kinematic2D
    n = opts.nx
    kw = dict(nx=n, nz=n, micro="lgrngn", sd_conc=32, sstp_cond=5,
              sstp_coal=5, n_sd_max=n * n * 32, grid="node", fct=True)
    out, secs = {}, {}
    for name, make in (
            ("jax", lambda: JaxKinematic2D(**kw)),
            ("port", lambda: Kinematic2D(**kw, device="cpu",
                                         dtype=torch.float64))):
        t0 = time.perf_counter()
        m = make()
        m.run_device_lgrngn(opts.spinup, spinup=opts.spinup)
        spun = fields(m)
        m.run_device_lgrngn(opts.nt - opts.spinup)
        out[name] = (spun, fields(m))
        secs[name] = time.perf_counter() - t0
        print(f"{name}: {opts.nt} steps in {secs[name]:.1f} s", flush=True)
    envelope = json.loads((ROOT / "DRIFT_1000_r03.json").read_text())
    env = envelope["fields"]
    report = {}
    for stage, i in (("after_spinup", 0), ("end", 1)):
        report[stage] = {}
        for k in FIELDS:
            r = metrics(out["jax"][i][k], out["port"][i][k])
            r["inside_envelope"] = bool(r["max_rel"] <= env[k]["max_rel"]
                                        and r["rms_rel"] <= env[k]["rms_rel"])
            report[stage][k] = r
            print(stage, k, r, flush=True)
    doc = {
        "nx": n, "nt": opts.nt, "spinup": opts.spinup,
        "comparison": "the port (libcloudphxx_tpu_torch, plain PyTorch "
                      "float64) against the JAX package (float64), same "
                      "case and initial population, CPU, flat engine "
                      "run_device_lgrngn",
        "after_spinup": "deterministic: no coalescence, the same arithmetic "
                        "in two libraries",
        "end": "statistical: the last nt - spinup steps coalesce with the "
               "port's Philox draws and JAX's jax.random draws",
        "envelope": "DRIFT_1000_r03.json: float32 against float64 of one "
                    "code with the same draws",
        "seconds": secs, "fields": report}
    opts.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
