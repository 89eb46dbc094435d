"""particles_multi_t: the multi-device front of the flat engine
(libcloudphxx_tpu/parallel/multi.py; the reference's multi_CUDA backend,
src/impl_multi_gpu/particles_multi_gpu_impl.ipp:35-227 and the diagnostic
reductions of particles_multi_gpu_diag.ipp).

The domain is split into x slabs (decomp.slab_widths, the remainder from
the left), each a shard: a flat-engine State of the padded slab in local
coordinates (decomp.local_config) on a torch device of its own (every
shard on the one card by default).  The population is initialised
globally, as the serial engine does, then scattered to the slabs.  A step
runs on every shard: the courant-halo refresh and the serial condensation
body (kernel F a cell, or G in exact mode, on the shard's padded slab),
then the whole async process set with walls in y and z alone, and the
ring migration of the SDs that left their slab (decomp.migrate).  The
diagnostics run per shard and are stitched; the sources and the
relaxation keep the serial engine's global semantics (MeshSrcEngine).

With a torch.distributed process ``group`` the front is one program in
several processes, as the JAX package's multi-controller run
(tools/dryrun_2proc.py): every rank initialises the whole domain (the
init is deterministic) and keeps its own shards (decomp.owned_shards),
the steps run on them over the process ring (decomp.ring_exchange), and
the migration and coalescence overflow flags, the total multiplicity and
the finiteness sweep are summed over the ranks (decomp.group_sum).  What
would fetch the whole population to one process (get_attr, outbuf and
the diagnostics, save and load, th and rv synced out by step_cond) raises
NotImplementedError, as such fetches are not addressable in the JAX
package's run either (tools/dryrun_2proc.py:84-85); so do the sources and
the relaxation, which read and write the global population on the host.

Shard s draws its coalescence, SGS and freezing numbers with its own key
word (ops/philox.shard_key), as the JAX package folds the shard index into
each shard's key: no two shards, and no shard and the serial engine,
share a stream.
"""

import dataclasses
import math

import numpy as np
import torch

from ..lgrngn import source as source_mod
from ..lgrngn.enums import as_t
from ..lgrngn.particles import particles_t, state_arrays, state_from_arrays
from ..lgrngn.state import (N_PUDDLE, OUT_COAL_OVERFLOW,
                            OUT_MIGRATION_OVERFLOW, PUDDLE_KEYS,
                            TENSOR_FIELDS)
from ..utils import debug
from . import decomp


class particles_multi_t(particles_t):
    """particles_t over ``n_devices`` x-slab shards (opts_init.dev_count,
    else every visible card).  ``device`` is one device or a list that
    the shards spread over (decomp.make_mesh); ``state`` is the list of
    the shards' States.  Unlike the JAX package, which needs a device a
    shard, any number of shards may share a device.  ``group`` is the
    torch.distributed process group the shards are spread over (the
    module docstring; None: one process holds them all); ``self.doms``
    are every shard's domains, ``self.state`` this process's shards."""

    def __init__(self, backend, opts_init, n_devices=None, *, device="cuda",
                 dtype=torch.float32, group=None, debug=False):
        devices = [device] if isinstance(device, (str, torch.device)) \
            else list(device)
        super().__init__(backend, opts_init, device=devices[0], dtype=dtype,
                         debug=debug)
        n_dev = n_devices or int(opts_init.dev_count) \
            or torch.cuda.device_count()
        if n_dev < 2:
            raise ValueError("particles_multi_t: need at least 2 devices")
        if opts_init.nx < n_dev:
            raise ValueError("particles_multi_t: nx smaller than the mesh")
        mesh = decomp.make_mesh(n_dev, devices)
        if any(d.type == "cuda" for d in mesh) \
                and not torch.cuda.is_available():
            raise RuntimeError(
                "particles_multi_t: a 'cuda' device asked for, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU")
        self.widths = decomp.slab_widths(self.cfg.nx, n_dev)
        if self.cfg.adve_scheme == as_t.pred_corr.value \
                and min(self.widths) < 2:
            # the halo-2 exchange needs two live faces a slab
            # (decomp.xchng_courants_pc; reference particles_impl.ipp:
            # 361-371 sizes its halos the same way)
            raise RuntimeError(
                "libcloudphxx: pred_corr on a device mesh needs every x slab "
                "at least 2 cells wide")
        # the shard capacity, n_sd_max rounded up to a multiple of the
        # shard count
        self._cap = math.ceil(self.cfg.n_sd_max / n_dev)
        self.cfg_global = dataclasses.replace(self.cfg,
                                              n_sd_max=self._cap * n_dev)
        self.n_shards = n_dev
        self.offs = np.concatenate([[0], np.cumsum(self.widths)])[:-1]
        self.cfg_l = decomp.local_config(self.cfg_global, n_dev, self.widths)
        self.nx_pad = self.cfg_l.nx
        self.doms = decomp.shard_domains(self.cfg_global, mesh, self.widths)
        self.group = group if decomp.rank_and_size(group)[1] > 1 else None
        self._own = decomp.local_domains(self.doms, self.group)

    # --------------------------------------------------------- sharding
    def _shard_state(self, g):
        """A global State -> this process's shards (decomp.shard_state)."""
        return decomp.shard_state(self.cfg, g, self.doms, self._cap,
                                  self.group)

    def _gather_state(self):
        """The shards -> one global State (decomp.gather_flat)."""
        self._refuse_fetch("gathering the shards")
        return decomp.gather_flat(self.cfg, self.state, self.doms)

    def _refuse_fetch(self, what):
        """Raise where ``what`` needs every shard in one process and the
        shards are spread over a process group."""
        if self.group is not None:
            raise NotImplementedError(
                f"particles_multi_t: {what} would fetch the whole "
                "population to one process; the shards are spread over a "
                "process group (sharded->host fetches are not addressable "
                "in a multi-controller run, tools/dryrun_2proc.py:84-85)")

    def init(self, *args, **kwargs):
        """particles_t.init on the whole domain (the serial engine's
        population), then the population scattered to its slabs."""
        super().init(*args, **kwargs)
        self.state = self._shard_state(self.state)

    def _put_fields(self, shards, upd):
        """Sync the global fields ``upd`` into the shards: the cell fields
        and trace gases padded, the courants sliced with their halo
        face."""
        per = [{} for _ in shards]
        cour = [k for k in ("courant_x", "courant_y", "courant_z")
                if k in upd]
        if cour:
            empty = shards[0].courant_x.new_zeros(0)
            cut = decomp.pad_courants(
                self.cfg, *(upd.get(k, empty) for k in (
                    "courant_x", "courant_y", "courant_z")), self._own,
                self.nx_pad)
            for p, c in zip(per, cut):
                p.update({k: v for k, v in zip(
                    ("courant_x", "courant_y", "courant_z"), c) if k in cour})
        for k, v in upd.items():
            if k not in cour:
                for p, f in zip(per, decomp.pad_cell_field(
                        self.cfg, v, self._own, self.nx_pad)):
                    p[k] = f
        return [dataclasses.replace(st, **p) for st, p in zip(shards, per)]

    # ------------------------------------------------ the per-shard hooks
    def _map(self, fn, *args):
        args = [a if isinstance(a, list) else [a] * len(self._own)
                for a in args]
        out = []
        for dom, a in zip(self._own, zip(*args)):
            with decomp.on_device(dom.device):
                out.append(fn(self.cfg_l, *a))
        return out

    def _cell_to_host(self, arr):
        self._refuse_fetch("a diagnostic")
        return decomp.unpad_cell_field(self.cfg, arr, self.doms) \
            .double().cpu().numpy()

    def _sd_to_host(self, arr):
        self._refuse_fetch("an attribute dump")
        return np.concatenate([a.cpu().numpy() for a in arr])

    def _cells(self, name):
        self._refuse_fetch(f"syncing {name} out")
        return decomp.unpad_cell_field(
            self.cfg, [getattr(st, name) for st in self.state], self.doms)

    def _step_cond_impl(self, state, dt, RH_max, var_rho, turb_cond, plain,
                        **ice_kw):
        """The courant-halo refresh, then the serial condensation body on
        every shard (multi.py:322-344)."""
        step = decomp.sharded_sync_step(self._cfg_for_dt(dt, self.cfg_l),
                                        self.group)
        return step(state, self.doms, dt, RH_max, var_rho, turb_cond,
                    plain, chem=False, **ice_kw)

    def _step_async_impl(self, sstp, switches, state, params, w_LS, dt,
                         plain):
        """The async process set on every shard, then the ring migration
        (multi.py:369-388), ``buf`` max(16, cap / 4) a direction."""
        step = decomp.sharded_async_step(self.cfg_l, sstp,
                                         max(16, self._cap // 4), switches,
                                         self.group)
        return step(state, self.doms, params, w_LS, self.sgs_mix_len(), dt)

    def step_cond(self, opts, th=None, rv=None, ambient_chem=None, *,
                  plain=False):
        """particles_t.step_cond; a front spread over a process group
        syncs no th or rv out (the dryrun's sync_in + step_cond)."""
        if th is not None or rv is not None:
            self._refuse_fetch("syncing th and rv out")
        return super().step_cond(opts, th, rv, ambient_chem, plain=plain)

    def _nancheck(self, phase):
        """The debug sweep of every shard this process holds."""
        for s, st in zip(decomp.owned_shards(self.n_shards, self.group),
                         self.state):
            debug.nancheck_state(st, f"{phase} (shard {s})")

    def _state_arrays(self):
        """Every shard's arrays, stacked on a leading shard axis."""
        self._refuse_fetch("a checkpoint")
        per = [state_arrays(st) for st in self.state]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    def _put_state(self, arrays):
        self._refuse_fetch("restoring a checkpoint")
        return [state_from_arrays({k: arrays[k][s] for k in
                                   TENSOR_FIELDS + ("__rng__",)}, st)
                for s, st in enumerate(self.state)]

    # ---------------------------------------------- the global readings
    def diag_puddle(self):
        """The puddles summed over the shards
        (particles_multi_gpu_diag.ipp:14-68)."""
        self._require_init()
        vals = self._sum_shards(lambda st: st.puddle)
        return dict(zip(PUDDLE_KEYS, vals.tolist()))

    def migration_overflow(self):
        """The SDs the shards could not send for want of buffer room (the
        reference hard-asserts its buffer sizes)."""
        return float(self._sum_shards(
            lambda st: st.puddle[OUT_MIGRATION_OVERFLOW]))

    def _sum_shards(self, fn):
        """fn(State) summed over every shard of every process, a float64
        host tensor."""
        return decomp.group_sum(sum(fn(st).double().cpu()
                                    for st in self.state), self.group)

    def total_multiplicity(self):
        """The multiplicity summed over every shard (the dryrun's
        conservation check)."""
        return float(self._sum_shards(lambda st: st.n.double().sum()))

    def all_finite(self):
        """Whether th, rv and rw2 are finite on every shard."""
        return float(self._sum_shards(lambda st: sum(
            (~torch.isfinite(getattr(st, k))).sum()
            for k in ("th", "rv", "rw2")))) == 0.0

    def get_attr(self, name):
        """particles_t.get_attr over the shards, slot by slot (n_sd_max
        rounded up to the shard count); x in global coordinates, 0 in a
        dead slot."""
        self._refuse_fetch("get_attr")
        v = super().get_attr(name)
        if name == "x":
            n = self._sd_to_host([st.n for st in self.state])
            off = np.repeat(self.offs * self.cfg.dx, self._cap)
            v = np.where(n > 0, v + off.astype(v.dtype), 0.0).astype(v.dtype)
        return v

    def consume_coal_overflow(self):
        """A request of any shard (of every process) grows sstp_coal by
        one; every shard's flag is cleared."""
        if float(self._sum_shards(
                lambda st: (st.puddle[OUT_COAL_OVERFLOW] > 0).sum())) > 0:
            self._sstp_coal_extra += 1
            clear = torch.ones(N_PUDDLE, dtype=self.state[0].puddle.dtype)
            clear[OUT_COAL_OVERFLOW] = 0.0
            self.state = [dataclasses.replace(
                st, puddle=st.puddle * clear.to(st.puddle.device))
                for st in self.state]

    # --------------------------------------- the sources and relaxation
    def outbuf(self):
        self._refuse_fetch("outbuf")
        return super().outbuf()

    def _src_engine(self):
        if self.group is not None:
            raise NotImplementedError(
                "particles_multi_t: the sources and the relaxation read and "
                "write the global population on the host, which a front "
                "spread over a process group does not hold (the JAX "
                "package's multi-controller run, tools/dryrun_2proc.py, "
                "runs neither)")
        self.state = self._tpr_impl()
        return MeshSrcEngine(self)

    def _inject_sharded(self, new):
        """The candidate SDs ``new`` (host arrays, global coordinates) into
        their owner shards' dead slots, in candidate order, one injection a
        shard (multi.py:570-639).  Returns their count."""
        n_new = int(np.asarray(new["n"]).size)
        if n_new == 0:
            return 0
        cfg, nyz = self.cfg, self.cfg.ny * self.cfg.nz
        cells = np.asarray(new["ijk"], np.int64)
        shard = np.searchsorted(np.cumsum(self.widths), cells // nyz,
                                side="right")
        counts = np.bincount(shard, minlength=self.n_shards)
        dead = [int((st.n <= 0).sum()) for st in self.state]
        for s in range(self.n_shards):
            if counts[s] > dead[s]:
                raise RuntimeError(
                    f"lgrngn source: shard {s} needs {counts[s]} free slots "
                    f"but has {dead[s]} (n_sd_max too small)")
        out = []
        for s, (st, dom) in enumerate(zip(self.state, self.doms)):
            mine = shard == s
            if mine.any():
                sub = {k: np.asarray(v)[mine] for k, v in new.items()}
                if "x" in sub:
                    sub["x"] = sub["x"] - dom.col0 * cfg.dx
                sub["ijk"] = sub["ijk"] - dom.col0 * nyz
                st, _ = source_mod._inject(st, sub, self.cfg_l)
            out.append(st)
        self.state = out
        return n_new


class MeshSrcEngine:
    """The sources' and the relaxation's access to the shards
    (multi.py:674-722; the contract of source.StateEngine): the cell
    fields stitched into global host arrays, the population statistics
    summed over the shards (integer-valued float64 sums, exact in any
    order), the new SDs injected into their owner shards.  The host
    generator's draws are the serial engine's, so serial and multi-device
    runs create the same SDs."""

    def __init__(self, prt):
        self.prt = prt
        self.cfg = prt.cfg
        self._cached = {}

    @property
    def state(self):
        return self.prt.state

    def cell(self, name):
        if name not in self._cached:
            self._cached[name] = self.prt._cell_to_host(
                [getattr(st, name) for st in self.prt.state])
        return self._cached[name]

    def inject(self, new):
        new = source_mod.StateEngine._augment_fresh(self, self.cfg, new)
        return self.prt._inject_sharded(new)

    def rlx_counts(self, kappa_rng, rd3_edges):
        return sum(source_mod.StateEngine(self.prt.cfg_l, st).rlx_counts(
            kappa_rng, rd3_edges) for st in self.prt.state)

    def percell_population(self):
        """(n, rd3, kpa, global ijk) over the shards' slots, as
        add_multiplicity indexes them."""
        prt = self.prt
        nyz = prt.cfg.ny * prt.cfg.nz
        host = lambda a: np.concatenate([getattr(st, a).double().cpu()
                                         .numpy() for st in prt.state])
        ijk = np.concatenate([st.ijk.cpu().numpy() + dom.col0 * nyz
                              for st, dom in zip(prt.state, prt.doms)])
        return host("n"), host("rd3"), host("kpa"), ijk.astype(np.int64)

    def add_multiplicity(self, updates):
        prt = self.prt
        prt.state = [dataclasses.replace(st, n=st.n + torch.as_tensor(
            u, dtype=st.n.dtype, device=st.n.device)) for st, u in zip(
                prt.state, np.asarray(updates).reshape(prt.n_shards, -1))]
