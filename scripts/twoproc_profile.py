#!/usr/bin/env python3
"""Where a step of the multi-device layer goes in two processes against
one (parallel/twoproc.py's cases), by torch.profiler.

Two ranks (fresh interpreters in one gloo group, 4 shards each) and then
this process (all 8 shards) each run the front's step ``--warm`` times,
then ``--steps`` steps timed without the profiler (between barriers), then
``--steps`` more under torch.profiler.  Each prints its ms/step, its
device time and busy share, and the host time of the layer's pieces
(labelled with record_function: the dense mesh's shard step, re-binning,
ring exchange, all-reduce, merge, injection and packing; the flat front's
condensation and async phases, its ring exchanges and migration) and of
gloo's operations and the host syncs.

Run from the repository root, on the card: ``python3
scripts/twoproc_profile.py [--front dense|flat] [--case gmd]``; on the
CPU (no device times) add ``--device cpu --case dryrun``.
"""

import argparse
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the labelled pieces: (module path under the package, the names its
# callers look up there)
PIECES = {
    "dense": (("lgrngn.dense", ("step_fused_shard", "merge",
                                "_rebin_global")),
              ("parallel.dense_mesh", ("rebin_sharded", "ring_exchange",
                                       "group_sum", "_inject", "_pack"))),
    "flat": (("parallel.decomp", ("ring_exchange", "migrate",
                                  "xchng_courants", "group_sum",
                                  "step_cond_body", "step_async_body")),),
}
HOST_OPS = ("gloo", "aten::item", "aten::_local_scalar_dense", "Memcpy",
            "cudaStreamSynchronize", "cudaMemcpy")


def label(front):
    """Wrap the front's pieces in record_function labels ("## name")."""
    import importlib
    for mod_name, names in PIECES[front]:
        mod = importlib.import_module(f"libcloudphxx_tpu_torch.{mod_name}")
        for name in names:
            fn = getattr(mod, name)

            def wrap(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(f"## {_name}"):
                    return _fn(*a, **k)

            setattr(mod, name, wrap)


def measure(args, rank=None, store=None):
    from libcloudphxx_tpu_torch.parallel import twoproc
    device = args.device
    group = None
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    if rank is not None:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=300))
        group = dist.group.WORLD
    label(args.front)
    if args.front == "dense":
        run = twoproc.DenseMeshRun(args.case, device, torch.float32,
                                   group).step
    else:
        run = twoproc.setup_flat(args.case, device, torch.float32, group)[2]

    def timed(k):
        return twoproc._timed(device, group, lambda: run(k))[0] / k * 1e3

    run(args.warm)
    wall = timed(args.steps)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        pwall = timed(args.steps)
    ev = prof.key_averages()
    n = args.steps
    # the labels also appear on the device's timeline as spans: leave
    # them out of the device time
    on_dev = [e for e in ev if e.self_device_time_total > 0
              and not e.key.startswith("## ")]
    dev = sum(e.self_device_time_total for e in on_dev) / n / 1e3
    tag = "one process" if rank is None else f"rank {rank}"
    print(f"{args.front} {tag}: {wall:.3f} ms/step unprofiled, "
          f"{pwall:.3f} profiled; device time {dev:.3f} ms/step, busy "
          f"share {dev / pwall:.3f}; device ops "
          f"{sum(e.count for e in on_dev) / n:.1f} a step", flush=True)
    host = sorted((e for e in ev if e.cpu_time_total > 0 and (
        e.key.startswith("## ") or any(h in e.key for h in HOST_OPS))),
        key=lambda e: -e.cpu_time_total)
    for e in host[:14]:
        print(f"  {tag} host | {e.key[:44]:44s} calls/step "
              f"{e.count / n:8.1f} ms/step {e.cpu_time_total / n / 1e3:9.3f}",
              flush=True)
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {tag} device | {e.key[:42]:42s} calls/step "
              f"{e.count / n:8.1f} ms/step "
              f"{e.self_device_time_total / n / 1e3:9.3f}", flush=True)
    if group is not None:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--front", choices=("dense", "flat"), default="dense")
    ap.add_argument("--case", choices=("gmd", "dryrun"), default="gmd")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        measure(args, args.rank, args.store)
        return
    if args.device == "cuda":
        from libcloudphxx_tpu_torch import _ext
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        print(out.stdout.strip(), flush=True)
        _ext.load()             # built once, before the ranks start
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, __file__] + sys.argv[1:] + [
            "--store", f"{tmp}/store"]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for pr in procs:
            print(pr.communicate(timeout=900)[0][-8000:], flush=True)
    measure(args)


if __name__ == "__main__":
    main()
