"""The dense engine's main path on one card, as a record two trees can be
compared by: bench.py's case (76x76 cells, sd_conc 64, sstp_cond =
sstp_coal = 10, geometric kernel), 10 spin-up and 10 coalescing steps of
Kinematic2D.run_device_lgrngn(engine="dense") from the seed, then the best
of 3 from-init reps of 50 coalescing steps, and the device time a step of
each kernel over 20 coalescing steps (torch.profiler).  It also reports,
from the built kernel library, each kernel's registers, stack and local
memory (cuobjdump -res-usage) and a digest of its SASS (cuobjdump -sass),
keeping cuobjdump's output beside the report.

It runs the package of the tree it sits in (``scripts/..``):

    python3 scripts/dense_main_path.py OUT_DIR

writes OUT_DIR/state.npz and OUT_DIR/report.json, and

    python3 scripts/dense_main_path.py --compare DIR_A DIR_B

says whether two such runs ended in bitwise the same state and which
kernels' SASS or resources differ.  Kernel names are compared with the
template arguments that only select a form off the main path removed
(kernel E's ``GridRows``, kernel C's ``Geometry``, kernel B's
``NoMerge``).
"""

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PLANES = ("n", "rw2", "rd3", "kpa", "vt", "x", "z", "puddle")
# the template arguments that select a form off the main path
_FORM_ARGS = (", lcp::GridRows", ", lcp::Geometry>", ", lcp::NoMerge")


def kernel_name(demangled):
    """A kernel's name without its parameters and form-only arguments."""
    name = demangled.split("(", 1)[0].strip()
    for arg in _FORM_ARGS:
        name = name.replace(arg, ">" if arg.endswith(">") else "")
    return name


def _demangle(names):
    """c++filt, one name a line (CUDA kernels mangle as C++ functions)."""
    out = subprocess.run(["c++filt"], input="\n".join(names) + "\n",
                         text=True, capture_output=True, check=True).stdout
    lines = out.splitlines()
    if len(lines) != len(names):
        raise RuntimeError(f"c++filt gave {len(lines)} names for "
                           f"{len(names)}")
    return dict(zip(names, lines))


def kernel_report(lib, cuda_bin, out_dir):
    """{kernel: {"reg", "stack", "local", "sass"}} of the library ``lib``
    (each of its cubins, one a source, extracted and dumped);
    cuobjdump's own output is kept in ``out_dir`` (gzip)."""
    import gzip
    import tempfile
    tool = str(cuda_bin / "cuobjdump")
    tmp = tempfile.TemporaryDirectory()
    subprocess.run([tool, "-xelf", "all", str(lib)], cwd=tmp.name,
                   capture_output=True, check=True)
    cubins = sorted(Path(tmp.name).glob("*.cubin")) or [lib]

    def dump(flag):
        text = "".join(subprocess.run(
            [tool, flag, str(c)], text=True, capture_output=True,
            check=True).stdout for c in cubins)
        with gzip.open(out_dir / f"cuobjdump{flag}.txt.gz", "wt") as f:
            f.write(f"# {len(cubins)} cubins: {[c.name for c in cubins]}\n")
            f.write(text)
        return text

    res = {}
    for m in re.finditer(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) "
                         r"SHARED:\d+ LOCAL:(\d+)", dump("-res-usage")):
        res[m.group(1)] = dict(reg=int(m.group(2)), stack=int(m.group(3)),
                               local=int(m.group(4)))
    sass = {}
    for block in dump("-sass").split("Function : ")[1:]:
        mangled, body = block.split("\n", 1)
        sass[mangled.strip()] = hashlib.sha256(
            body.split("....", 1)[0].encode()).hexdigest()[:16]
    tmp.cleanup()
    names = _demangle(sorted(set(res) | set(sass)))
    report = {}
    for k in names:
        key = kernel_name(names[k])
        while key in report:       # the same kernel in two objects
            key += "#"
        report[key] = dict(res.get(k, {}), sass=sass.get(k))
    return report


def device_ms(m, steps):
    """Device time a coalescing step by kernel name [ms]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.run_device_lgrngn(steps, engine="dense")
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            key = kernel_name(e.key)
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3 / steps
    return out


def run(out_dir):
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    from libcloudphxx_tpu_torch import Kinematic2D, _ext
    out_dir.mkdir(parents=True, exist_ok=True)
    lib, _, _ = _ext.build()
    _ext.load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    m = Kinematic2D(nx=76, nz=76, sd_conc=64, sstp_cond=10, sstp_coal=10,
                    n_sd_max=64 * 76 * 76, opts_init_kw={"coal_switch": True})
    init = (m.dense_state, m.th, m.rv)
    m.run_device_lgrngn(20, spinup=10, engine="dense")
    d = m.dense_state
    state = {k: getattr(d, k).cpu().numpy() for k in PLANES}
    state["th"], state["rv"] = m.th.cpu().numpy(), m.rv.cpu().numpy()
    np.savez(out_dir / "state.npz", **state)
    best = float("inf")
    for _ in range(3):
        m.dense_state, m.th, m.rv = init
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_device_lgrngn(50, engine="dense")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    m.dense_state, m.th, m.rv = init
    report = {"tree": str(ROOT), "card": card,
              "ms_per_step": best / 50 * 1e3,
              "device_ms": device_ms(m, 20),
              "kernels": kernel_report(lib, Path(CUDA_HOME) / "bin",
                                       out_dir)}
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"tree": report["tree"], "card": card,
                      "ms_per_step": report["ms_per_step"],
                      "kernels": len(report["kernels"])}))


def compare(a_dir, b_dir):
    a, b = (np.load(d / "state.npz") for d in (a_dir, b_dir))
    same = {k: bool(np.array_equal(a[k], b[k])) for k in a.files}
    ra, rb = (json.loads((d / "report.json").read_text())
              for d in (a_dir, b_dir))
    ka, kb = ra["kernels"], rb["kernels"]
    shared = sorted(set(ka) & set(kb))
    differ = [k for k in shared if ka[k] != kb[k]]
    da, db = ra["device_ms"], rb["device_ms"]
    print(json.dumps({
        "bitwise": all(same.values()), "planes": same,
        "ms_per_step": [ra["ms_per_step"], rb["ms_per_step"]],
        "kernels_shared": len(shared), "kernels_differ": differ,
        "only_a": sorted(set(ka) - set(kb)),
        "only_b": sorted(set(kb) - set(ka)),
        "device_ms": {k: [da.get(k), db.get(k)]
                      for k in sorted(set(da) | set(db)) if "lcp::" in k},
        "card": ra["card"]}))
    return 0 if all(same.values()) and not differ else 1


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--compare", action="store_true")
    opts = ap.parse_args(argv)
    if opts.compare:
        return compare(*opts.dirs)
    run(opts.dirs[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
