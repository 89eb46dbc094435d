"""The multi-device layer in two processes: the counterpart of
tools/dryrun_2proc.py, the JAX package's multi-controller check (and of
the reference's MPI test run oversubscribed on one node,
tests/mpi/mpi_adve_test.cpp:69-110).

Two fresh interpreters (subprocess: never a fork of a process that has
started CUDA) join one torch.distributed gloo group through a FileStore,
and each holds half the shards of one 8-shard mesh (decomp.owned_shards:
rank 0 shards 0-3, rank 1 shards 4-7).  Each rank runs what the JAX tool
runs:

  - the flat front (parallel/multi.particles_multi_t over the group): the
    whole-domain init on every rank, each keeping its own shards, then
    steps of sync_in + step_cond (no sync-out) + step_async, the courant
    halos and the SD migration crossing between the ranks;
  - the dense mesh (dense_mesh.dense_step_sharded over the group) on the
    same initial population packed, its mover payloads crossing between
    the ranks.

Each rank writes its shards' tensors and its readings (the total
multiplicity before and after, finiteness, the overflow counts, the
kernels launched, ms a step between barriers) to the caller's directory,
so that the caller can hold the shards against the same functions run in
one process (run_flat and run_dense with no group; same_files).

The cases: "dryrun" is the JAX tool's configuration (19 x 8 cells of 100
m, sd_conc 4, n_sd_max 8 a cell, the geometric kernel, beard77fast,
sstp_cond = sstp_coal = 2, Cx 0.3, Cz 0.05; the dense mesh at row capacity
16, buf 32); "dryrun_pred_corr" the same with pred_corr advection (the
halo-2 courant exchange crossing between the ranks, on both fronts);
"gmd" is bench.py's full-width case
(Kinematic2D at 76 x 76, sd_conc 64, sstp_cond = sstp_coal = 10, the
model's n_sd_max of 739,328 slots; the dense mesh at row capacity 128
and MeshRunner's buf).

With a card every rank's shards sit on cuda:0 (gloo carries the ring's
messages, staged through the host: decomp.ring_exchange).

Usage: python -m libcloudphxx_tpu_torch.parallel.twoproc [--case dryrun]
[--device cuda] [--dtype float32] [--steps 2] [--dense-steps 2]
[--no-coal] [--out DIR]: spawns the two ranks, runs the same in this
process, and checks that every shard is bitwise the one-process run's
(``--device cpu --dtype float64`` on the CPU).
"""

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import decomp

N_SHARDS = 8
CASES = ("dryrun", "dryrun_pred_corr", "gmd")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _lognormal(lnr):
    """The dryrun's aerosol (tools/dryrun_2proc.py)."""
    return (60e6 * np.exp(-(np.asarray(lnr) - np.log(0.02e-6)) ** 2
                          / 2 / np.log(1.4) ** 2)
            / np.log(1.4) / np.sqrt(2 * np.pi))


def dryrun_opts_init(dev_count, case="dryrun"):
    """tools/dryrun_2proc.py's opts_init (with pred_corr advection for
    the "dryrun_pred_corr" case)."""
    from ..lgrngn import as_t, kernel_t, opts_init_t, vt_t
    nx, nz = 19, 8
    oi = opts_init_t()
    oi.nx, oi.nz = nx, nz
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = nx * oi.dx, nz * oi.dz
    oi.dt = 1.0
    oi.sd_conc = 4
    oi.n_sd_max = nx * nz * 8
    oi.dry_distros = {(0.61, 0.0): _lognormal}
    oi.kernel = kernel_t.geometric
    oi.terminal_velocity = vt_t.beard77fast
    oi.sstp_cond = 2
    oi.sstp_coal = 2
    oi.dev_count = dev_count
    if case == "dryrun_pred_corr":
        oi.adve_scheme = as_t.pred_corr
    return oi


def dryrun_fields():
    """The dryrun's fields: th, rv, rhod and the courants (numpy)."""
    nx, nz = 19, 8
    return dict(th=np.full((nx, nz), 293.0), rv=np.full((nx, nz), 8e-3),
                rhod=np.full((nx, nz), 1.12),
                Cx=0.3 * np.ones((nx + 1, nz)),
                Cz=0.05 * np.ones((nx, nz + 1)))


def _gmd_model(device, dtype):
    """bench.py's case on one device (the flat engine), initialised."""
    from ..models import Kinematic2D
    return Kinematic2D(nx=76, nz=76, micro="lgrngn", sd_conc=64,
                       sstp_cond=10, sstp_coal=10, engine="flat",
                       device=device, dtype=dtype)


def make_front(case, device, dtype, group=None):
    """The case's flat multi-device front of N_SHARDS shards over
    ``group``, initialised; returns (front, the fields sync_in takes each
    step).  For "gmd" the model's opts_init and fields, on N_SHARDS."""
    from ..lgrngn import backend_t, factory
    if case == "gmd":
        m = _gmd_model(device, dtype)
        oi = copy.copy(m.opts_init)
        oi.dev_count = N_SHARDS
        f = dict(th=m.th, rv=m.rv, rhod=m.rhod, Cx=m.C_x, Cz=m.C_z)
    else:
        oi, f = dryrun_opts_init(N_SHARDS, case), dryrun_fields()
    prt = factory(backend_t.multi_CUDA, oi, device=device, dtype=dtype,
                  group=group)
    prt.init(f["th"], f["rv"], f["rhod"], Cx=f["Cx"], Cz=f["Cz"])
    return prt, dict(th=f["th"], rv=f["rv"], rhod=f["rhod"])


def make_serial(case, device, dtype):
    """The case's population on the serial flat engine, for the dense
    mesh: (front, th, rv) with th and rv (nx, nz) tensors."""
    if case == "gmd":
        m = _gmd_model(device, dtype)
        return m.prtcls, m.th, m.rv
    from ..lgrngn import backend_t, factory
    prt = factory(backend_t.serial, dryrun_opts_init(0, case),
                  device=device, dtype=dtype, engine="flat")
    f = dryrun_fields()
    prt.init(f["th"], f["rv"], f["rhod"], Cx=f["Cx"], Cz=f["Cz"])
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return prt, put(f["th"]), put(f["rv"])


def _kernels(device):
    """The port's kernel counters (none run off the card)."""
    if torch.device(device).type != "cuda":
        return ()
    from .. import _ext
    return _ext.KERNELS


def _timed(device, group, run):
    """run() between two barriers of ``group``, with the kernels' launches
    counted from 0: (seconds, {kernel: launches})."""
    kernels = _kernels(device)
    for k in kernels:
        k.launches = 0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    if group is not None:
        dist.barrier(group)
    t0 = time.perf_counter()
    run()
    if cuda:
        torch.cuda.synchronize()
    if group is not None:
        dist.barrier(group)
    secs = time.perf_counter() - t0
    return secs, {k.name: k.launches for k in kernels if k.launches}


def _save(obj, path, **extra):
    """The tensors (on the host) and numbers of a State or DenseState."""
    out = dict(extra)
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.cpu() if isinstance(v, torch.Tensor) else v
    torch.save(out, path)


def setup_flat(case, device, dtype, group=None, coal=True):
    """The case's flat front over ``group``, initialised: (front, the
    fields it syncs in, step(k)), step(k) running k steps of sync_in +
    step_cond + step_async on the shards this process owns."""
    from ..lgrngn import opts_t
    prt, fields = make_front(case, device, dtype, group)
    opts = opts_t()
    opts.chem_dsl = False
    opts.coal = coal

    def step(k):
        for _ in range(k):
            # no th/rv out: a sharded front does not fetch them to a host
            prt.sync_in(**fields)
            prt.step_cond(opts)
            prt.step_async(opts)

    return prt, fields, step


class DenseMeshRun:
    """The case's dense mesh over ``group``: the serial engine's initial
    population packed and scattered to the shards this process owns
    (``shards``, with the padded ``th`` and ``rv`` slabs); step(k) runs k
    mesh steps on them, each step's SDs crossed appended to ``crossed``.
    "gmd" takes the dense front's row capacity and MeshRunner's buf."""

    def __init__(self, case, device, dtype, group=None):
        from ..lgrngn import dense
        from ..lgrngn.dense_front import initial_capacity
        from . import dense_mesh
        prt, th, rv = make_serial(case, device, dtype)
        cfg, st = prt.cfg, prt.state
        if case == "gmd":
            counts = torch.bincount(st.ijk[st.n > 0], minlength=cfg.n_cell)
            cap = initial_capacity(int(counts.max()))
            buf, sstp_coal = cfg.nz * cap, 10
        else:
            cap, buf, sstp_coal = 16, 32, 2
        doms = decomp.shard_domains(cfg, decomp.make_mesh(N_SHARDS, device))
        own = decomp.local_domains(doms, group)
        nx_pad = max(d.nxl for d in doms)
        self.cap, self.buf, self.group, self.dt = cap, buf, group, cfg.dt
        self.shards = dense_mesh.scatter_dense(cfg, dense.pack(cfg, st, cap),
                                               doms, group)
        self.th = decomp.pad_cell_field(cfg, th.reshape(-1), own, nx_pad)
        self.rv = decomp.pad_cell_field(cfg, rv.reshape(-1), own, nx_pad)
        self.params = [float(v) for v in prt.opts_init.kernel_parameters]
        self.crossed = []
        self._step = dense_mesh.dense_step_sharded(
            cfg, doms, sstp_coal, buf, True, True, 44.0, group=group)

    def step(self, k):
        for _ in range(k):
            self.shards, self.th, self.rv, c, _ = self._step(
                self.shards, self.th, self.rv, self.params, self.dt)
            self.crossed.append(c)

    def group_total(self, per_shard):
        """The sum of ``per_shard(shard)`` over every shard of the group."""
        return float(decomp.group_sum(sum(
            per_shard(d).double().cpu() for d in self.shards), self.group))


def run_flat(case, *, device="cuda", dtype=torch.float32, steps=2,
             coal=True, group=None, out=None):
    """The flat front's part of the check: ``steps`` of setup_flat's step
    on the shards this process owns (all of them without a group), each
    shard's State written to ``out``/flat_<s>.pt.  Returns ((the front,
    the fields it syncs in), the readings)."""
    prt, fields, step = setup_flat(case, device, dtype, group, coal)
    total0 = prt.total_multiplicity()
    secs, launches = _timed(device, group, lambda: step(steps))
    owned = list(decomp.owned_shards(prt.n_shards, group))
    if out is not None:
        for s, st in zip(owned, prt.state):
            _save(st, Path(out) / f"flat_{s}.pt")
    readings = dict(shards=owned, total0=total0,
                    total1=prt.total_multiplicity(), finite=prt.all_finite(),
                    migration_overflow=prt.migration_overflow(),
                    ms_per_step=secs / steps * 1e3, launches=launches)
    return (prt, fields), readings


def run_dense(case, *, device="cuda", dtype=torch.float32, steps=2,
              group=None, out=None):
    """The dense mesh's part: ``steps`` of DenseMeshRun's step on the
    initial th and rv, each shard's DenseState and th, rv written to
    ``out``/dense_<s>.pt.  Returns the readings."""
    run = DenseMeshRun(case, device, dtype, group)
    total = lambda: run.group_total(lambda d: d.n.double().sum())
    total0 = total()
    secs, launches = _timed(device, group, lambda: run.step(steps))
    if out is not None:
        for s, d, t, r in zip(decomp.owned_shards(N_SHARDS, group),
                              run.shards, run.th, run.rv):
            _save(d, Path(out) / f"dense_{s}.pt", th=t.cpu(), rv=r.cpu())
    bad = lambda d: (~torch.isfinite(d.rw2)).sum() + (~torch.isfinite(
        d.x)).sum()
    return dict(cap=run.cap, buf=run.buf, total0=total0, total1=total(),
                overflow=run.group_total(lambda d: d.overflow),
                finite=run.group_total(bad) == 0,
                crossed=int(sum(int(c) for c in run.crossed)),
                ms_per_step=secs / steps * 1e3, launches=launches)


def _refusals(prt, fields, case, device, dtype, group, out):
    """What a front spread over the group refuses: {call: the error}."""
    from ..lgrngn import backend_t, factory, opts_t
    got = {}

    def attempt(name, fn):
        try:
            fn()
            got[name] = None
        except (NotImplementedError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"

    attempt("get_attr", lambda: prt.get_attr("n"))
    attempt("outbuf", prt.outbuf)
    attempt("diag_sd_conc", lambda: (prt.diag_all(), prt.diag_sd_conc()))
    attempt("save", lambda: prt.save(str(Path(out) / "refused.npz")))
    # what the sources and the relaxation act through
    attempt("sources", prt._src_engine)

    def sync_out():
        prt.sync_in(**fields)
        prt.step_cond(opts_t(), th=np.zeros(prt.cfg.n_cell),
                      rv=np.zeros(prt.cfg.n_cell))

    attempt("sync_out", sync_out)
    if case != "gmd":
        # 3 shards over 2 processes
        attempt("three_shards", lambda: factory(
            backend_t.multi_CUDA, dryrun_opts_init(3), device=device,
            dtype=dtype, group=group))
    return got


def worker(rank, args):
    """One rank: joins the group, runs the flat front and the dense mesh,
    writes its readings to ``args.out``/rank<r>.json."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=args.group_timeout))
    group = dist.group.WORLD
    device = "cuda:0" if args.device == "cuda" else args.device
    dtype = _DTYPES[args.dtype]
    try:
        (prt, fields), flat = run_flat(
            args.case, device=device, dtype=dtype, steps=args.steps,
            coal=args.coal, group=group, out=args.out)
        res = dict(rank=rank, flat=flat)
        if args.dense_steps:
            res["dense"] = run_dense(args.case, device=device, dtype=dtype,
                                     steps=args.dense_steps, group=group,
                                     out=args.out)
        res["refusals"] = _refusals(prt, fields, args.case, device, dtype,
                                    group, args.out)
        (Path(args.out) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _parser():
    ap = argparse.ArgumentParser(
        description="the multi-device layer in two processes (gloo)")
    ap.add_argument("--case", choices=CASES, default="dryrun")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=tuple(_DTYPES), default="float32")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dense-steps", type=int, default=2)
    ap.add_argument("--no-coal", dest="coal", action="store_false")
    ap.add_argument("--out", default=None,
                    help="the directory the ranks write to (a temporary "
                         "one by default)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the two ranks may take")
    ap.add_argument("--group-timeout", type=float, default=60.0,
                    help="seconds a collective may wait")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap


def launch(out, *, case="dryrun", device="cuda", dtype="float32", steps=2,
           dense_steps=2, coal=True, timeout=600.0, group_timeout=60.0):
    """Run the two ranks (fresh interpreters, this module's worker) into
    the directory ``out``; returns their readings, rank 0's first.
    Raises with the ranks' output where one fails or the pair outlasts
    ``timeout`` seconds (both are then killed)."""
    out = Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    if store.exists():
        store.unlink()
    # the package's parent directory: ``-m`` finds the package there
    root = Path(__file__).resolve().parents[2]
    cmd = [sys.executable, "-m", __spec__.name, "--case", case,
           "--device", device, "--dtype", dtype, "--steps", str(steps),
           "--dense-steps", str(dense_steps), "--out", str(out),
           "--store", str(store), "--group-timeout", str(group_timeout)]
    if not coal:
        cmd.append("--no-coal")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + timeout
    logs = [""] * 2
    try:
        for r, pr in enumerate(procs):
            logs[r] = pr.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
        tails = [pr.communicate()[0][-3000:] for pr in procs]
        raise RuntimeError(f"twoproc: the ranks outlasted {timeout} s:\n"
                           + "\n".join(tails)) from None
    failed = [r for r, pr in enumerate(procs) if pr.returncode]
    if failed:
        raise RuntimeError("twoproc: " + "; ".join(
            f"rank {r} exited {procs[r].returncode}:\n{logs[r][-4000:]}"
            for r in failed))
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


def same_files(a, b, names):
    """The files ``names`` of the directories ``a`` and ``b`` (_save's):
    the keys whose values differ (tensors bitwise), as "file:key"."""
    diff = []
    for name in names:
        x, y = (torch.load(Path(d) / name) for d in (a, b))
        for k in sorted(set(x) | set(y)):
            u, v = x.get(k), y.get(k)
            same = torch.equal(u, v) if isinstance(u, torch.Tensor) \
                and isinstance(v, torch.Tensor) else u == v
            if not same:
                diff.append(f"{name}:{k}")
    return diff


def main(argv=None):
    """Spawn the two ranks, run the same in this process (every shard,
    no group), and check the ranks' shards bitwise against it and the
    dryrun's invariants.  Returns 0, or raises."""
    args = _parser().parse_args(argv)
    if args.rank is not None:
        worker(args.rank, args)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        two, one = out / "two", out / "one"
        one.mkdir(parents=True, exist_ok=True)
        ranks = launch(two, case=args.case, device=args.device,
                       dtype=args.dtype, steps=args.steps,
                       dense_steps=args.dense_steps, coal=args.coal,
                       timeout=args.timeout,
                       group_timeout=args.group_timeout)
        dtype = _DTYPES[args.dtype]
        _, flat = run_flat(args.case, device=args.device, dtype=dtype,
                           steps=args.steps, coal=args.coal, out=one)
        names = [f"flat_{s}.pt" for s in range(N_SHARDS)]
        if args.dense_steps:
            dense = run_dense(args.case, device=args.device, dtype=dtype,
                              steps=args.dense_steps, out=one)
            names += [f"dense_{s}.pt" for s in range(N_SHARDS)]
        diff = same_files(two, one, names)
        for r in ranks:
            print(f"rank {r['rank']}: {json.dumps(r)}")
        print(f"one process: flat {json.dumps(flat)}"
              + (f", dense {json.dumps(dense)}" if args.dense_steps else ""))
        f0 = ranks[0]["flat"]
        if diff:
            raise RuntimeError(f"twoproc: the two-process shards differ from "
                               f"the one-process run's: {diff[:20]}")
        if not (f0["finite"] and 0 < f0["total1"] <= f0["total0"]
                and f0["total1"] > 0.9 * f0["total0"]):
            raise RuntimeError(f"twoproc: the dryrun's invariants fail: {f0}")
        print(f"twoproc: {len(names)} shard files bitwise equal to the "
              f"one-process run's; total multiplicity {f0['total0']:.6e} -> "
              f"{f0['total1']:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
