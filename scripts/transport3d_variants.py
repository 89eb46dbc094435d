"""Kernel C's 3-D streaming kernel (csrc/transport3d.cuh) in variants of its
constants, on the arguments of chip_smoke.py phase 22's steps (76^3: the
implicit form at capacity 128, the pred_corr form with vohl and the large
tail at 256), as the record its constants were chosen by.

Each variant is a copy of csrc/ with constants of transport3d.cuh
changed, transport3d.cu and util.cu compiled alone into a library (about
a minute, all variants at once) and its entries called with ctypes: every
variant's outputs against the plain version (bitwise, the far flags too),
its registers, local memory and blocks an SM, and a call's time (CUDA
events, two rounds in opposite orders).  With ``--parent DIR`` (a tree
of an earlier commit, e.g. ``git archive`` into an ignored directory)
the parent's 3-D entries are timed beside them, and the SASS of the
kernels that source files of both trees share (E's wide-table forms,
coal_vohl.cu; C's scalar layout, transport3d.cu) is compared, compiled
alone.  On the card:

    python3 scripts/transport3d_variants.py OUT_DIR [--parent DIR]

writes OUT_DIR/report.json and prints a line a case.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REPS = 20
# the constants of each variant that differ from transport3d.cuh's
VARIANTS = {
    "as built": {},
    "chunk 4": {"kC3Chunk": 4},
    "2 blocks an SM": {"kC3MinBlocks": 2},
    "4 blocks an SM": {"kC3MinBlocks": 4},
    "n 4 rows ahead": {"kC3Ahead": 4},
    "chunk 1": {"kC3Chunk": 1},
}


def _compile(nvcc, flags, out, sources):
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", str(out),
                             *map(str, sources)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _sass(cuobjdump, path):
    """{mangled name: [instructions]} of cuobjdump -sass."""
    txt = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def run(out_dir, parent):
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from libcloudphxx_tpu_torch import Kinematic2D, _ext
    from libcloudphxx_tpu_torch import lgrngn as tl
    from libcloudphxx_tpu_torch.lgrngn import as_t, vt_t
    from libcloudphxx_tpu_torch.ops import step
    if not torch.cuda.is_available():
        raise SystemExit("transport3d_variants.py needs a CUDA card")
    out_dir.mkdir(parents=True, exist_ok=True)
    work = out_dir / "build"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    csrc = ROOT / "libcloudphxx_tpu_torch" / "csrc"
    nvcc = _ext._nvcc()
    flags = list(_ext.NVCC_FLAGS)
    t0 = time.perf_counter()
    procs = {}
    for name, over in VARIANTS.items():
        d = work / str(len(procs))
        shutil.copytree(csrc, d)
        h = (d / "transport3d.cuh").read_text()
        for k, v in over.items():
            h, n = re.subn(r"constexpr int " + k + r" = \d+;",
                           f"constexpr int {k} = {v};", h)
            if n != 1:
                raise SystemExit(f"{k} not found in transport3d.cuh")
        (d / "transport3d.cuh").write_text(h)
        procs[name] = (d / "lib.so", _compile(
            nvcc, flags, d / "lib.so", (d / "transport3d.cu", d / "util.cu")))
    if parent:
        psrc = parent / "libcloudphxx_tpu_torch" / "csrc"
        procs["parent"] = (work / "parent.so", _compile(
            nvcc, flags, work / "parent.so",
            (psrc / "transport3d.cu", psrc / "util.cu")))
        objs = {}
        for who, src in (("parent", psrc), ("this", csrc)):
            for f in ("coal_vohl.cu", "transport3d.cu"):
                o = work / f"{who}_{f}.o"
                objs[who, f] = (o, subprocess.Popen(
                    [nvcc, *flags, "-c", "-o", str(o), str(src / f)]))
    for name, (_, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    report = {"card": cs.card_line(), "variants": VARIANTS,
              "build_s": time.perf_counter() - t0}
    if parent:
        for _, p in objs.values():
            p.wait()
        cuobjdump = str(Path(nvcc).parent / "cuobjdump")
        for f in ("coal_vohl.cu", "transport3d.cu"):
            a = _sass(cuobjdump, objs["parent", f][0])
            b = _sass(cuobjdump, objs["this", f][0])
            shared = sorted(set(a) & set(b))
            report[f"sass {f}"] = {"shared": len(shared), "equal": sum(
                a[k] == b[k] for k in shared)}

    _P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    base = _ext.TRANSPORT.argtypes[:-1] + [_P, _P, _I, _D, _D, _D]
    libs = {}
    for name, (path, _) in procs.items():
        lib, new = ctypes.CDLL(str(path)), name != "parent"
        fns = {}
        for sym, extra in (("lcp_transport_3d", []),
                           ("lcp_transport_3d_pred_corr", [_P] * 3)):
            fn = getattr(lib, sym)
            fn.argtypes = base + ([_I, _I] if new else []) + extra + [_P]
            fn.restype = _I
            fns[sym] = fn
        if new:
            fns["attrs"] = lib.lcp_transport_3d_attrs
            fns["attrs"].argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
            fns["attrs"].restype = _I
        libs[name] = fns
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def attrs(name, vt, pc, cap):
        a = (_I * len(_ext.ATTRS))()
        if libs[name]["attrs"](vt, pc, cap, a):
            raise SystemExit(f"{name}: the attribute query failed")
        return dict(zip(_ext.ATTRS, list(a)))

    def call(name, kw):
        """``name``'s entry on transport's arguments ``kw`` (3-D)."""
        cfg, n = kw["cfg"], kw["n"]
        n_cell, cap = n.shape
        y, C_f, C_h = kw["y3"]
        pc = kw["do_adve"] and as_t(cfg.adve_scheme) == as_t.pred_corr
        w = kw.get("w_cells")
        vt = vt_t(cfg.terminal_velocity).value
        cells = torch.stack([kw["T"], kw["p"], kw["rhod"], kw["eta"],
                             kw["C_l"], kw["C_r"], kw["C_b"], kw["C_a"], C_f,
                             C_h] + ([w] if w is not None else []))
        outs = [torch.empty_like(n) for _ in range(5)]
        tgt = torch.empty((n_cell, cap), dtype=torch.int32, device=n.device)
        info = torch.empty((n_cell, 8), dtype=n.dtype, device=n.device)
        n_out, x_out, z_out, vt_out, y_out = outs
        args = [n.data_ptr(), kw["rw2"].data_ptr(), kw["rd3"].data_ptr(),
                kw["x"].data_ptr(), kw["z"].data_ptr(), cells.data_ptr(),
                n_out.data_ptr(), x_out.data_ptr(), z_out.data_ptr(),
                vt_out.data_ptr(), tgt.data_ptr(), info.data_ptr(), n_cell,
                cap, cfg.nx, cfg.nz, cfg.dx, cfg.dz, float(kw["dt"]),
                cfg.x0, cfg.x1, cfg.z0, cfg.z1,
                int(as_t(cfg.adve_scheme) == as_t.implicit),
                int(kw["do_adve"]), int(kw["do_sedi"]), int(w is not None),
                int(cfg.open_side_walls), int(cfg.periodic_topbot_walls), vt,
                y.data_ptr(), y_out.data_ptr(), cfg.ny, cfg.dy, cfg.y0,
                cfg.y1]
        if name != "parent":
            per_sm = attrs(name, vt, int(pc), cap)["blocks_per_sm"]
            args += list(step.transport3d_plan(cap, n_cell,
                                               per_sm * sms)[:2])
        sym = "lcp_transport_3d" + ("_pred_corr" if pc else "")
        if pc:
            args += [a.data_ptr() for a in kw["courants"]]
        err = libs[name][sym](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: launch failed, CUDA error {err}")
        return (n_out, x_out, z_out, vt_out, tgt, info, y_out)

    fields, m2 = cs.grid3d_fields(Kinematic2D)
    wide = 2 * cs.SD_CONC * cs.GRID_N ** 3
    for label, over in (("implicit, capacity 128", {}),
                        ("pred_corr with vohl, capacity 256", dict(
                            n_sd_max=wide, adve_scheme=tl.as_t.pred_corr,
                            kernel=tl.kernel_t.vohl_davis_no_waals,
                            sd_conc_large_tail=True))):
        oi = cs.grid_oi(m2, 3, **over)
        prt = cs.dense3d_factory(oi, label)
        cs.dense3d_init(prt, fields, label, "")
        opts = tl.opts_t()
        opts.adve = opts.cond = opts.coal = opts.sedi = True
        cs.dense3d_run(prt, opts, 2, fields)
        kw = cs.capture(step, "transport",
                        lambda: cs.dense3d_run(prt, opts, 1, fields))
        plain = step.transport(**kw, plain=True)
        res = {}
        names = list(libs)
        for name in names:
            got = call(name, kw)
            torch.cuda.synchronize()
            res[name] = {"bitwise": all(
                torch.equal(a, b) for a, b in zip(got[:5] + got[6:],
                                                  plain[:5] + plain[6:]))
                and bool(torch.equal(got[5][:, 4], plain[5][:, 4]))}
            if name != "parent":
                res[name]["attrs"] = attrs(
                    name, vt_t(kw["cfg"].terminal_velocity).value,
                    int(label.startswith("pred")), kw["n"].shape[1])
        del plain
        for order in (names, names[::-1]):
            for name in order:
                res[name].setdefault("ms", []).append(
                    cs.time_cuda(lambda: call(name, kw), REPS))
        report[label] = res
        print(label, json.dumps(res), flush=True)
        prt.state = None
        del prt, kw
        torch.cuda.empty_cache()
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({k: v for k, v in report.items()
                      if k in ("card", "build_s") or k.startswith("sass")}))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--parent", type=Path, default=None)
    opts = ap.parse_args(argv)
    run(opts.out, opts.parent and opts.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
