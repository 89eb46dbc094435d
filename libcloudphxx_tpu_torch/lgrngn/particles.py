"""The particles_t API: the Euler-Lagrange coupling surface of the flat
super-droplet engine (libcloudphxx_tpu/lgrngn/particles.py; reference
include/libcloudph++/lgrngn/particles.hpp:16-134 and
src/particles_{ctor,init,step,diag}.ipp).

The public contract is the reference's three-phase stepping: ``init``
once, then ``step_sync`` (= ``sync_in`` + ``step_cond``) and
``step_async`` in turn, with the reference's call-order state machine
(particles_impl.ipp:32, particles_step.ipp:44-47,169-175,343-345).  The
numerics are functions over the flat State (lgrngn/state.py), each step
returning a new one.

Two array ABIs: numpy arrays passed to ``init``/``step_sync`` are copied
in, and ``step_cond`` writes th/rv back into them (the reference's
arrinfo_t, arrinfo.hpp:10-49); torch tensors are handles, so no copy is
made and ``step_cond`` returns the new (th, rv) as flat tensors on the
engine's device.

The port runs the engine on every grid the JAX flat engine runs: the
parcel (0-D: one cell of 1 kg of dry air, no transport), 1-D (x), 2-D
(x, z) and 3-D (x, y, z), with the per-cell and the exact and adaptive
per-particle condensation substepping, every SD init mode, what an LES
host couples through: the SGS turbulence (turb_adve, turb_cond,
turb_coal with the onishi kernels; diss_rate through sync_in),
diag_incloud_time, the aerosol sources, the CCN relaxation and the
recycling; the ice (ice_switch: singular or time-dependent freezing,
melting, and deposition in the per-cell condensation; lgrngn/ice.py) and
the aqueous chemistry (chem_switch: the trace gases through
``ambient_chem``, opts.chem_dsl/dsc/rct; lgrngn/chemistry.py).
Fields a host passes as (nx, ny, nz) arrays are ravelled C-order, i
outermost.
On a CUDA device the condensation runs kernel F (per cell) or kernel G
(per particle; ops/cond.py), under turb_cond their turb_cond forms, in a
parcel their parcel forms, with ice_switch F's ice forms; nothing falls
back to the CPU.
The factory hands out this flat engine, on a CUDA device the dense front
(lgrngn/dense_front.py), which overrides the _step_cond_impl and
_step_async_impl hooks, or for dev_count > 1 the multi-device front
(parallel/multi.py), which holds a list of shard States and overrides the
per-shard hooks (_map and the hooks over it, libcloudphxx_tpu/lgrngn/
particles.py:255-300).
"""

import dataclasses
import math

import numpy as np
import torch

from ..common import constants as c
from ..common import kappa_koehler
from ..common import turbulence as ga17
from ..common.chem import chem_gas_n
from ..utils import debug as debug_mod
from . import chemistry, coalescence, condensation, hskpng, ice, recycle
from . import relax
from . import source as source_mod
from . import transport, turbulence
from . import init as init_mod
from .enums import backend_t, kernel_t, src_t
from .ice import ice_mass
from .opts import opts_init_t, opts_t
from .state import (OUT_COAL_OVERFLOW, PUDDLE_KEYS, TENSOR_FIELDS, State,
                    StaticConfig, empty_state)
from .vterm import hskpng_vterm_all


def step_cond_body(cfg: StaticConfig, state: State, dt, RH_max,
                   var_rho: bool = False, turb_cond: bool = False,
                   ice_nucl: bool = False, do_cond: bool = True, *,
                   plain=False) -> State:
    """The condensation phase (libcloudphxx_tpu/lgrngn/particles.py:70-120):
    mean free paths from the previous step's T/p, the cell closure, with
    ``ice_nucl`` (ice_switch) the freezing and melting and the closure
    again, then, with ``do_cond``, the exact per-particle substepping
    (adaptive or fixed; kernel G on the card) where exact_sstp_cond asks
    for more than one substep, else the in-cloud time (diag_incloud_time)
    and the per-cell substepping (kernel F on the card, its ice form with
    ice_switch), and sstp_save.  ``turb_cond`` adds each SD's SGS
    supersaturation perturbation to its RH (the kernels' turb_cond forms).
    ``plain`` runs the kernels' plain versions on any device."""
    # the mean free paths come from the T/p before the closure
    stale = (state.T, state.p)
    state = hskpng.hskpng_Tpr_state(cfg, state)
    if cfg.ice_switch and ice_nucl:
        # freezing and melting (particles_step.ipp:183-185)
        state = ice.ice_nucl_melt(cfg, state, dt, cfg.time_dep_ice_nucl)
        state = hskpng.hskpng_Tpr_state(cfg, state)
    if not do_cond:
        return state
    if condensation.exact_route(cfg):
        # exact per-particle substepping (particles_step.ipp:199-236),
        # which deposits no ice, as in the JAX package
        cond = condensation.cond_perparticle_adaptive \
            if cfg.adaptive_sstp_cond else condensation.cond_perparticle
        state = cond(cfg, state, dt, RH_max, stale, turb_cond, plain=plain)
        return condensation.sstp_save(state, exact=True)
    lam = hskpng.hskpng_mfp(*stale)
    if cfg.diag_incloud_time:
        # (particles_impl_update_incloud_time.ipp:38-66)
        state = condensation.update_incloud_time(cfg, state, dt)
    state = condensation.cond_percell(cfg, state, dt, RH_max, lam,
                                      var_rho=var_rho, turb_cond=turb_cond,
                                      plain=plain)
    return condensation.sstp_save(state, exact=cfg.exact_sstp_cond)


def step_async_body(cfg: StaticConfig, sstp_coal: int, switches, state: State,
                    params, w_LS, dt, sgs_mix_len=None, *,
                    adve=transport.adve, x_walls=True) -> State:
    """The transport phase (libcloudphxx_tpu/lgrngn/particles.py:144-179;
    reference particles_step.ipp:339-494), warm: closure, vt, the
    coalescence substeps, the SGS block (the TKE, the velocity
    perturbations, the supersaturation perturbation's tendency),
    advection, the turbulent displacement, sedimentation, subsidence, the
    walls, recycling and the re-bin.  ``switches`` = (do_coal, do_adve,
    do_sedi, do_subs[, do_turb_adve, do_turb_cond, do_rcyc,
    do_turb_coal]), the last four False where left out; ``sgs_mix_len``
    the per-level SGS mixing length (a tensor) the SGS block takes.  A
    shard of the multi-device front (parallel/decomp.sharded_async_step)
    passes its ``adve`` and ``x_walls`` False: its x walls and re-bin are
    the ring migration's."""
    (do_coal, do_adve, do_sedi, do_subs, do_turb_adve, do_turb_cond,
     do_rcyc, do_turb_coal) = tuple(switches) + (False,) * (8 - len(switches))
    state = hskpng.hskpng_Tpr_state(cfg, state)
    state = hskpng_vterm_all(cfg, state)
    if do_coal:
        state = coalescence.coal(cfg, state, params, dt, sstp_coal,
                                 turb_coal=do_turb_coal)
    if do_turb_adve or do_turb_cond:
        # the SGS block (particles_step.ipp:406-426)
        state = turbulence.hskpng_tke(cfg, state, sgs_mix_len)
        state = turbulence.hskpng_turb_vel(cfg, state, sgs_mix_len, dt,
                                           only_vertical=not do_turb_adve)
        if do_turb_cond:
            state = turbulence.hskpng_turb_dot_ss(cfg, state)
    if do_adve:
        state = adve(cfg, state)
    if do_turb_adve:
        state = turbulence.turb_adve(cfg, state, dt)
    if do_sedi:
        state = transport.sedi(state, dt)
    if do_subs:
        state = transport.subs(cfg, state, w_LS, dt)
    state = transport.bcnd(cfg, state, x_walls=x_walls)
    if do_rcyc:
        state = recycle.rcyc(cfg, state)
    return transport.post_step(cfg, state) if x_walls else state


def take_coal_overflow(puddle):
    """The const-multi coalescence's request for one more substep (where
    a pair asked for more than one collision; particles_step.ipp:394-400):
    (whether the puddle's flag is set, the puddle with it cleared).  One
    host read."""
    if float(puddle[OUT_COAL_OVERFLOW]) > 0:
        pud = puddle.clone()
        pud[OUT_COAL_OVERFLOW] = 0.0
        return True, pud
    return False, puddle


class particles_t:
    """The reference's particles_proto_t (particles.hpp:16-134) over the
    flat engine.  ``device`` is where the state lives (the card unless the
    caller asks for the CPU) and ``dtype`` its working precision (float32
    on the card: kernels F and G take float32 only).  ``debug`` sweeps
    the state for NaN and Inf after step_cond and after step_async and
    raises FloatingPointError with the array and the phase named (the
    JAX package's LIBCLOUD_DEBUG; utils/debug.py)."""

    def __init__(self, backend: backend_t, opts_init: opts_init_t, *,
                 device="cuda", dtype=torch.float32, debug=False):
        self.backend = backend
        self.opts_init = opts_init
        if opts_init.n_sd_max == 0:
            raise ValueError("lgrngn: n_sd_max == 0")
        if opts_init.dt <= 0:
            raise ValueError("lgrngn: opts_init.dt must be positive")
        if opts_init.th_dry == opts_init.const_p:
            raise ValueError(
                "lgrngn: exactly one of th_dry/const_p must be true")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "particles_t: device 'cuda' asked for, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU")
        self.dtype = dtype
        self.debug = debug
        self.cfg = StaticConfig.from_opts_init(opts_init)
        self.state = empty_state(self.cfg, dtype, self.device,
                                 rng_seed=opts_init.rng_seed)
        # call-order state machine (reference particles_impl.ipp:32)
        self._init_called = False
        self._should_now_run_async = False
        self._should_now_run_cond = False
        self._var_rho = False
        # diag selection (the reference's n_filtered temp vector)
        self._n_filtered = None
        self._outbuf = np.zeros(self.cfg.n_cell)
        # adaptive coalescence substep growth on const-multi collision
        # overflow (reference coal.ipp:224-227 + particles_step.ipp:394-400)
        self._sstp_coal_extra = 0
        self._async_consts = None
        self._sgs_mix_len = None
        # the source and relaxation super-step counters, and their host
        # generator (particles_step.ipp:451-479; the JAX package's, so that
        # both draw the same numbers)
        self._src_ctr = 0
        self._rlx_ctr = 0
        self._src_rng = np.random.default_rng(opts_init.rng_seed + 1)

    def _cfg_for_dt(self, dt, cfg=None):
        """Variable-dt substep rescale (reference
        particles_impl_adjust_timesteps.ipp:17-21) of ``cfg`` (the
        engine's by default): substep counts > 1 scale by ceil(sstp * dt /
        opts_init.dt)."""
        cfg = cfg or self.cfg
        if dt == self.cfg.dt:
            return cfg
        adj = lambda s: int(math.ceil(s * dt / self.cfg.dt)) if s > 1 else s
        return dataclasses.replace(cfg, sstp_cond=adj(cfg.sstp_cond),
                                   sstp_cond_act=adj(cfg.sstp_cond_act),
                                   sstp_chem=adj(cfg.sstp_chem))

    # ---- the engine's hooks: the dense front (lgrngn/dense_front.py)
    # overrides them (libcloudphxx_tpu/lgrngn/particles.py:255-264)
    def _step_cond_impl(self, state, dt, RH_max, var_rho, turb_cond, plain,
                        **ice_kw):
        """The condensation phase on ``state``; returns the new State.
        ``ice_kw``: step_cond_body's ice_nucl and do_cond, with
        ice_switch."""
        return step_cond_body(self._cfg_for_dt(dt), state, dt, RH_max,
                              var_rho, turb_cond, plain=plain, **ice_kw)

    def _step_async_impl(self, sstp, switches, state, params, w_LS, dt,
                         plain):
        """The transport phase on ``state``; returns the new State (the
        flat engine's async phase runs no kernel, so ``plain`` changes
        nothing here)."""
        return step_async_body(self.cfg, sstp, switches, state, params, w_LS,
                               dt, self.sgs_mix_len())

    def _step_chem_impl(self, state, dt, dsl, dsc, rct):
        """The chemistry substeps on ``state`` (particles_step.ipp:272-310);
        returns the new State."""
        def fn(cfg, st):
            cfg = self._cfg_for_dt(dt, cfg)
            return chemistry.sstp_chem_loop(
                cfg, hskpng.hskpng_Tpr_state(cfg, st), dt, dsl, dsc, rct)

        return self._map(fn, state)

    # ---- the per-shard hooks (libcloudphxx_tpu/lgrngn/particles.py:
    # 255-300): the multi-device front (parallel/multi.py) holds a list of
    # shard States and runs each on every shard
    def _map(self, fn, *args):
        """fn(cfg, *args) on the engine: ``args`` are the engine's values (a
        State, a tensor over its SDs or cells); the multi-device front
        passes and gets back a list, one a shard."""
        return fn(self.cfg, *args)

    def _cell_to_host(self, arr):
        """A cell field (a value of _map) as a (n_cell,) float64 numpy
        array in the host's layout."""
        return arr.double().cpu().numpy()

    def _sd_to_host(self, arr):
        """A per-SD attribute (a value of _map) as a numpy array."""
        return arr.cpu().numpy()

    def _cells(self, name):
        """The State's cell field ``name`` as one global tensor."""
        return getattr(self.state, name)

    def _put_fields(self, state, upd):
        """``state`` with the global fields ``upd`` (cell fields, courants,
        the trace gases) synced in."""
        return dataclasses.replace(state, **upd)

    def _tpr_impl(self):
        """The State with its closure (T, p, RH, eta) refreshed."""
        return self._map(hskpng.hskpng_Tpr_state, self.state)

    def _moms_calc_impl(self, power, n_filtered, attr):
        """The specific moment of ``attr(state)`` over ``n_filtered``, a
        cell."""
        return self._map(lambda cfg, st, nf: hskpng.segment_moment(
            cfg, nf, attr(st), power, st.ijk, st.dv, st.rhod), self.state,
            n_filtered)

    def _sd_count_impl(self, n_filtered):
        return self._map(lambda cfg, st, nf: hskpng.sd_count_per_cell(
            cfg, nf, st.ijk), self.state, n_filtered)

    def _mass_dens_impl(self, n_filtered, rad, sig0):
        """The kernel-density estimate of diag_wet_mass_dens
        (particles_impl_mass_dens.ipp:8-113)."""
        def fn(cfg, st, nf):
            seg = lambda v: torch.zeros(cfg.n_cell, dtype=v.dtype,
                                        device=v.device).index_add_(
                0, st.ijk, v)
            count = seg((st.n > 0).to(st.rw2.dtype))
            sig = (sig0 / torch.clamp(count, min=1.0) ** 0.2)[st.ijk]
            x = torch.clamp(st.rw2, min=1e-300)
            vals = nf / sig * x ** 1.5 * torch.exp(
                -((0.5 * torch.log(x) - math.log(rad)) / sig) ** 2 / 2.0)
            pre = 4.0 / 3.0 * c.rho_w * math.sqrt(c.pi / 2.0)
            return pre * seg(vals) / st.dv

        return self._map(fn, self.state, n_filtered)

    def _segment_max_impl(self, vals):
        """The largest of ``vals`` (over the SDs) a cell, 0 where none."""
        return self._map(lambda cfg, st, v: torch.zeros(
            cfg.n_cell, dtype=v.dtype, device=v.device).scatter_reduce_(
                0, st.ijk, v, "amax"), self.state, vals)

    def _precip_rate_impl(self, ice: bool):
        """1st non-specific moment of (rw^3 | the ice mass) * vt of the
        selected SDs, vt refreshed (particles_diag.ipp:561-607)."""
        def fn(cfg, st, nf):
            st = hskpng_vterm_all(cfg, st)
            vals = ice_mass(st.ice_a, st.ice_c, st.ice_rho) if ice \
                else st.rw2 ** 1.5
            vals = nf * vals * st.vt
            return torch.zeros(cfg.n_cell, dtype=vals.dtype,
                               device=vals.device).index_add_(0, st.ijk, vals)

        return self._map(fn, self._tpr_impl(), self._n_filtered)

    def _state_arrays(self):
        """The State's arrays for a checkpoint (save)."""
        return state_arrays(self.state)

    def _put_state(self, arrays):
        """The State from a checkpoint's ``arrays`` (load)."""
        return state_from_arrays(arrays, self.state)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _as_flat(self, arr, size, name):
        """A caller's field as a flat tensor of the engine: a tensor is
        used as it is (a view, on the engine's device and dtype), a numpy
        array is copied (the reference's sync is a copy,
        particles_impl_sync.ipp:15-69)."""
        if arr is None:
            return None
        if isinstance(arr, torch.Tensor):
            a = arr.reshape(-1)
        else:
            a = np.array(arr, dtype=np.float64).reshape(-1)
        if a.shape[0] != size:
            raise ValueError(
                f"lgrngn: {name} has {a.shape[0]} elements, expected {size}")
        return self._tensor(a)

    def _courant_updates(self, courant_x, courant_y, courant_z):
        """Validate and flatten the Arakawa-C staggered courant fields
        ((nx+1, ny, nz), (nx, ny+1, nz), (nx, ny, nz+1), C order)."""
        cfg = self.cfg
        nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
        upd = {}
        for name, arr, size in (
                ("courant_x", courant_x, (nx + 1) * ny * nz),
                ("courant_y", courant_y, nx * (ny + 1) * nz),
                ("courant_z", courant_z, nx * ny * (nz + 1))):
            a = self._as_flat(arr, size, name)
            if a is not None:
                upd[name] = a
        return upd

    def _chem_updates(self, ambient_chem):
        """The {chem_species: array} trace-gas map as a (6, n_cell) tensor
        (None where it is empty), checked against chem_switch as the
        reference checks it (particles_step.ipp:68-72, :146-153)."""
        if self.cfg.chem_switch:
            if not ambient_chem or len(ambient_chem) != chem_gas_n:
                raise RuntimeError(
                    "libcloudphxx: chemistry was not switched off and "
                    "ambient_chem is empty")
        elif ambient_chem:
            raise RuntimeError(
                "libcloudphxx: chemistry was switched off and ambient_chem "
                "is not empty")
        if not ambient_chem:
            return None
        rows = [None] * chem_gas_n
        for key, arr in ambient_chem.items():
            rows[int(key)] = self._as_flat(arr, self.cfg.n_cell,
                                           f"ambient_chem[{int(key)}]")
        return torch.stack(rows)

    def _chem_sync_out(self, ambient_chem):
        """Write the cells' trace gases back into the caller's numpy arrays
        (particles_step.ipp:319-327); tensors are the caller's to read from
        ``state.ambient_chem``."""
        if not ambient_chem:
            return
        dev = self._cells("ambient_chem").double().cpu().numpy()
        for key, arr in ambient_chem.items():
            if not isinstance(arr, torch.Tensor):
                np.asarray(arr).reshape(-1)[:] = dev[int(key)]

    # ------------------------------------------------------------------ init
    def init(self, th, rv, rhod, p=None, courant_x=None, courant_y=None,
             courant_z=None, ambient_chem=None, Cx=None, Cy=None, Cz=None):
        """(reference src/particles_init.ipp:16-131).  ``Cx``/``Cy``/``Cz``
        are binding-style aliases for the courant fields."""
        courant_x = courant_x if courant_x is not None else Cx
        courant_y = courant_y if courant_y is not None else Cy
        courant_z = courant_z if courant_z is not None else Cz
        if self._init_called:
            raise RuntimeError("libcloudphxx: init() may be called just once")
        self._init_called = True
        oi, cfg = self.opts_init, self.cfg
        gases = self._chem_updates(ambient_chem)
        n_cell = cfg.n_cell
        rhod_t = self._as_flat(rhod, n_cell, "rhod")
        p_t = self._as_flat(p, n_cell, "p")
        if cfg.const_p and p_t is None:
            raise ValueError("lgrngn: const_p requires a pressure profile")
        # the cropped cell volumes (init_grid.ipp dv_eval:33-52); a
        # parcel's, 1 kg of dry air, comes from the closure
        dv = self._tensor(init_mod.cell_dv(cfg)) if cfg.n_dims > 0 \
            else self.state.dv
        st = dataclasses.replace(
            self.state, th=self._as_flat(th, n_cell, "th"),
            rv=self._as_flat(rv, n_cell, "rv"), rhod=rhod_t,
            p=p_t if p_t is not None else torch.zeros_like(rhod_t),
            dv=dv, rng_seed=oi.rng_seed, rng_step=0,
            **self._courant_updates(courant_x, courant_y, courant_z))
        st = hskpng.hskpng_Tpr_state(cfg, st)
        # SD creation with the init seed (particles_init.ipp:30-32, :130)
        if not oi.no_ccn_at_init:
            seed = oi.rng_seed_init if oi.rng_seed_init_switch \
                else oi.rng_seed
            rhod_host = rhod_t.double().cpu().numpy()
            if oi.reference_rng_init:
                from .refinit import init_SD_reference
                pop = init_SD_reference(
                    cfg, oi, seed, rhod_host, 1.0 / rhod_host
                    if cfg.n_dims == 0 else init_mod.cell_dv(cfg))
            else:
                pop = init_mod.init_SD(cfg, oi, np.random.default_rng(seed),
                                       rhod_host)
            st = init_mod.init_wet_state(init_mod.init_SD_state(cfg, st, pop),
                                         oi.RH_max)
        if cfg.chem_switch:
            # the initial NH4HSO4 aerosol (init_chem.ipp:178-225)
            st = chemistry.sstp_save_chem(dataclasses.replace(
                st, ambient_chem=gases, chem=torch.where(
                    st.n > 0, chemistry.init_chem_aq(st.rd3, cfg.chem_rho),
                    0.0)))
        self.state = condensation.sstp_save(st, exact=cfg.exact_sstp_cond)
        self._should_now_run_cond = False
        self._should_now_run_async = False

    # ------------------------------------------------------------- stepping
    def sync_in(self, th=None, rv=None, rhod=None, courant_x=None,
                courant_y=None, courant_z=None, ambient_chem=None,
                diss_rate=None):
        """(reference particles_step.ipp:32-158)"""
        if not self._init_called:
            raise RuntimeError(
                "libcloudphxx: please call init() before calling step_sync()")
        if self._should_now_run_async:
            raise RuntimeError(
                "libcloudphxx: please call step_async() before calling "
                "step_sync() again")
        n_cell = self.cfg.n_cell
        upd = {}
        for name, arr in (("th", th), ("rv", rv), ("rhod", rhod),
                          ("diss_rate", diss_rate)):
            a = self._as_flat(arr, n_cell, name)
            if a is not None:
                upd[name] = a
        upd.update(self._courant_updates(courant_x, courant_y, courant_z))
        if self.cfg.chem_switch or ambient_chem:
            gases = self._chem_updates(ambient_chem)
            if gases is not None:
                upd["ambient_chem"] = gases
        if upd:
            self.state = self._put_fields(self.state, upd)
        # var_rho: the host passed a (possibly changing) density this sync
        # (reference particles_step.ipp:100)
        self._var_rho = rhod is not None
        self._should_now_run_cond = True

    def _step_dt(self, opts: opts_t):
        if opts.dt > 0 and not self.opts_init.variable_dt_switch:
            # reference adjust_timesteps.ipp:16
            raise RuntimeError(
                "libcloudphxx: opts.dt specified, but "
                "opts_init.variable_dt_switch is false")
        return float(opts.dt) if opts.dt > 0 else self.cfg.dt

    def step_cond(self, opts: opts_t, th=None, rv=None, ambient_chem=None,
                  *, plain=False):
        """(reference particles_step.ipp:161-336).  Writes the new th/rv
        back into numpy arrays; for tensor callers (th/rv passed as
        tensors) returns them instead, as flat tensors.  ``plain`` runs
        the plain version of kernel F or G, for comparisons and timings."""
        if not self._should_now_run_cond:
            raise RuntimeError(
                "libcloudphxx: please call sync_in() before calling "
                "step_cond()")
        self._should_now_run_cond = False
        dt = self._step_dt(opts)
        if opts.turb_cond and not self.cfg.turb_cond_switch:
            raise RuntimeError(
                "libcloudphxx: turb_cond_switch=False, but turb_cond==True")
        do_chem = opts.chem_dsl or opts.chem_dsc or opts.chem_rct
        if do_chem and not self.cfg.chem_switch:
            raise RuntimeError(
                "libcloudphxx: all chemistry was switched off in opts_init")
        device_io = isinstance(th, torch.Tensor) \
            or isinstance(rv, torch.Tensor)
        ice_nucl = bool(opts.ice_nucl and self.cfg.ice_switch)
        if opts.cond or ice_nucl:
            ice_kw = dict(ice_nucl=ice_nucl, do_cond=bool(opts.cond)) \
                if self.cfg.ice_switch else {}
            self.state = self._step_cond_impl(
                self.state, dt, float(opts.RH_max), self._var_rho,
                bool(opts.turb_cond), plain, **ice_kw)
            if not device_io:
                for arr, name in ((th, "th"), (rv, "rv")):
                    if arr is not None:
                        np.asarray(arr).reshape(-1)[:] = \
                            self._cells(name).cpu().numpy()
        if do_chem:
            # the chemistry substeps (particles_step.ipp:272-310)
            self.state = self._step_chem_impl(
                self.state, dt, bool(opts.chem_dsl), bool(opts.chem_dsc),
                bool(opts.chem_rct))
            if opts.chem_dsl:
                self._chem_sync_out(ambient_chem)
        if self.debug:
            self._nancheck("step_cond")
        self._should_now_run_async = True
        if device_io:
            return self._cells("th"), self._cells("rv")
        return None

    def step_sync(self, opts: opts_t, th, rv, rhod=None, courant_x=None,
                  courant_y=None, courant_z=None, ambient_chem=None,
                  diss_rate=None, *, plain=False):
        """step_sync = sync_in + step_cond (reference
        particles_step.ipp:15-29).  Returns the new (th, rv) for tensor
        callers (see step_cond), None for numpy ones."""
        self.sync_in(th=th, rv=rv, rhod=rhod, courant_x=courant_x,
                     courant_y=courant_y, courant_z=courant_z,
                     ambient_chem=ambient_chem, diss_rate=diss_rate)
        return self.step_cond(opts, th=th, rv=rv, ambient_chem=ambient_chem,
                              plain=plain)

    def async_consts(self):
        """The kernel parameters and the subsidence profile (a tensor),
        made once."""
        if self._async_consts is None:
            oi, cfg = self.opts_init, self.cfg
            w_LS = oi.w_LS if len(oi.w_LS) else np.zeros(cfg.nz)
            self._async_consts = ([float(v) for v in oi.kernel_parameters],
                                  self._tensor(np.asarray(w_LS, float)))
        return self._async_consts

    def sgs_mix_len(self):
        """The per-level SGS mixing length (a tensor, made once):
        opts_init.SGS_mix_len, or dz at every level (SGS_length_scale.hpp's
        vertical choice, the reference's default)."""
        if self._sgs_mix_len is None:
            oi, cfg = self.opts_init, self.cfg
            mix = oi.SGS_mix_len if len(oi.SGS_mix_len) \
                else np.full(cfg.nz, ga17.length_vertical(cfg.dx, cfg.dz))
            self._sgs_mix_len = self._tensor(np.asarray(mix, float))
        return self._sgs_mix_len

    def step_async(self, opts: opts_t, *, plain=False):
        """The transport phase (reference particles_step.ipp:339-494), with
        the reference's call-order bookkeeping.  ``plain`` runs the plain
        version of every kernel the phase launches."""
        if not self._should_now_run_async:
            raise RuntimeError(
                "libcloudphxx: please call step_sync() before calling "
                "step_async() again")
        self._should_now_run_async = False
        dt = self._step_dt(opts)
        cfg = self.cfg
        do_coal = bool(opts.coal and cfg.coal_switch)
        if do_coal and cfg.kernel == kernel_t.undefined.value:
            raise RuntimeError(
                "libcloudphxx: opts.coal == True requires opts_init.kernel")
        if opts.turb_coal and not self.opts_init.turb_coal_switch:
            raise RuntimeError(
                "libcloudphxx: turb_coal_switch=False, but turb_coal==True")
        # a parcel has no transport (particles_step.ipp:339-494)
        do_sedi = bool(opts.sedi and cfg.sedi_switch and cfg.n_dims > 0)
        if do_sedi and cfg.terminal_velocity == 0:
            raise RuntimeError(
                "libcloudphxx: opts.sedi requires opts_init.terminal_velocity")
        oi = self.opts_init
        # the substep count follows a variable dt (adjust_timesteps.ipp:
        # 14-24), plus any growth from const-multi collision overflow
        sstp = oi.sstp_coal
        if opts.dt > 0 and sstp > 1:
            sstp = math.ceil(sstp * dt / cfg.dt)
        sstp += self._sstp_coal_extra
        params, w_LS = self.async_consts()
        # the aerosol source every supstp steps, then the CCN relaxation
        # every supstp_rlx steps (particles_step.ipp:451-479), on the host
        if opts.src and (opts.src_dry_distros or opts.src_dry_sizes):
            self._src_ctr += 1
            self._apply_sources(opts, dt)
        if opts.rlx and oi.rlx_switch and oi.rlx_dry_distros:
            self._rlx_ctr += 1
            if self._rlx_ctr % int(oi.supstp_rlx) == 0:
                eng = self._src_engine()
                relax.rlx_dry_distros(cfg, oi, eng, dt, self._src_rng)
                self.state = eng.state
        grid = cfg.n_dims > 0
        switches = (do_coal, bool(opts.adve and grid), do_sedi,
                    bool(opts.subs and grid),
                    bool(opts.turb_adve and oi.turb_adve_switch),
                    bool(opts.turb_cond and cfg.turb_cond_switch),
                    bool(opts.rcyc), bool(opts.turb_coal))
        if any(switches[:7]):
            self.state = self._step_async_impl(int(sstp), switches,
                                               self.state, params, w_LS, dt,
                                               plain)
        if do_coal and cfg.pure_const_multi:
            self.consume_coal_overflow()
        if self.debug:
            self._nancheck("step_async")

    def _nancheck(self, phase):
        """The debug sweep after ``phase`` (utils/debug.nancheck_state;
        libcloudphxx_tpu/lgrngn/particles.py:522-524, :639-641)."""
        debug_mod.nancheck_state(self.state, phase)

    def _src_engine(self):
        """The sources' and the relaxation's access to the State
        (source.StateEngine), its T and RH refreshed first: they read the
        current closure."""
        return source_mod.StateEngine(self.cfg, self._tpr_impl())

    def _apply_sources(self, opts, dt):
        """The aerosol sources due this step (each distribution and size
        every its own supstp steps; particles_step.ipp:451-462)."""
        eng = self._src_engine()
        oi = self.opts_init
        due = {k: v for k, v in opts.src_dry_distros.items()
               if self._src_ctr % int(v[2]) == 0}
        if due:
            src = source_mod.src_matching_distros \
                if oi.src_type == src_t.matching \
                else source_mod.src_simple_distros
            src(self.cfg, oi, eng, due, dt, self._src_rng, oi.RH_max)
        sizes = {k: {r: spec for r, spec in v.items()
                     if self._src_ctr % int(spec[2]) == 0}
                 for k, v in opts.src_dry_sizes.items()}
        sizes = {k: v for k, v in sizes.items() if v}
        if sizes:
            source_mod.src_dry_sizes(self.cfg, oi, eng, sizes, dt,
                                     self._src_rng, oi.RH_max)
        self.state = eng.state

    def consume_coal_overflow(self):
        """Consume the const-multi coalescence's request (take_coal_overflow):
        sstp_coal grows by one for every later step."""
        grew, pud = take_coal_overflow(self.state.puddle)
        if grew:
            self._sstp_coal_extra += 1
            self.state = dataclasses.replace(self.state, puddle=pud)

    # ----------------------------------------------------------- diagnostics
    def _require_init(self):
        if not self._init_called:
            raise RuntimeError("libcloudphxx: init() has not been called")

    def _set_outbuf(self, per_cell):
        self._outbuf = self._cell_to_host(per_cell)

    def _cell_diag(self, name):
        """Output a field of the refreshed closure."""
        self._require_init()
        self._set_outbuf(self._map(lambda cfg, st: getattr(st, name),
                                   self._tpr_impl()))

    def diag_pressure(self):
        self._cell_diag("p")

    def diag_temperature(self):
        self._cell_diag("T")

    def diag_RH(self):
        self._cell_diag("RH")

    # selection filters (reference particles_diag.ipp:224-340)
    def _select(self, sel, state=None):
        """Select the SDs that ``sel(state)`` marks (the State's by
        default): n_filtered is their multiplicity, 0 elsewhere."""
        self._n_filtered = self._map(
            lambda cfg, st: torch.where(sel(st), st.n, 0.0),
            self.state if state is None else state)

    def _cons(self, sel):
        """Narrow the current selection by ``sel(state)`` (the reference's
        consecutive filters, particles_diag.ipp:254-340)."""
        if self._n_filtered is None:
            raise RuntimeError("libcloudphxx: consecutive filter without "
                               "a previous selection")
        self._n_filtered = self._map(
            lambda cfg, st, nf: torch.where(sel(st), nf, 0.0), self.state,
            self._n_filtered)

    def diag_all(self):
        self._require_init()
        self._n_filtered = self._map(lambda cfg, st: st.n, self.state)

    def diag_dry_rng(self, r_min, r_max):
        self._require_init()
        self._select(lambda st: (st.rd3 >= r_min ** 3)
                     & (st.rd3 < r_max ** 3))

    def diag_wet_rng(self, r_min, r_max):
        self._require_init()
        self._select(lambda st: (st.rw2 >= r_min ** 2)
                     & (st.rw2 < r_max ** 2))

    def diag_kappa_rng(self, k_min, k_max):
        self._require_init()
        self._select(lambda st: (st.kpa >= k_min) & (st.kpa < k_max))

    def diag_dry_rng_cons(self, r_min, r_max):
        self._require_init()
        self._cons(lambda st: (st.rd3 >= r_min ** 3) & (st.rd3 < r_max ** 3))

    def diag_wet_rng_cons(self, r_min, r_max):
        self._require_init()
        self._cons(lambda st: (st.rw2 >= r_min ** 2) & (st.rw2 < r_max ** 2))

    def diag_kappa_rng_cons(self, k_min, k_max):
        self._require_init()
        self._cons(lambda st: (st.kpa >= k_min) & (st.kpa < k_max))

    def diag_rw_ge_rc(self):
        """Select the activated SDs: rw at or above the critical radius
        (reference particles_diag.ipp:384-409)."""
        self._require_init()
        self._select(lambda st: st.rw2 >= kappa_koehler.rw3_cr(
            torch.clamp(st.rd3, min=1e-300), torch.clamp(st.kpa, min=1e-10),
            st.T[st.ijk]) ** (2.0 / 3), self._tpr_impl())

    def diag_RH_ge_Sc(self):
        """Select the SDs whose cell's RH reaches their critical
        saturation (reference particles_diag.ipp:353-381)."""
        self._require_init()
        self._select(lambda st: st.RH[st.ijk] >= kappa_koehler.S_cr(
            torch.clamp(st.rd3, min=1e-300), torch.clamp(st.kpa, min=1e-10),
            st.T[st.ijk]), self._tpr_impl())

    def _check_selected(self):
        if self._n_filtered is None:
            raise RuntimeError(
                "libcloudphxx: please select SDs before calling a moment "
                "diag")

    def _moms(self, power, attr):
        """Output the moment ``power`` of ``attr(state)`` over the
        selection."""
        self._set_outbuf(self._moms_calc_impl(power, self._n_filtered, attr))

    def diag_sd_conc(self):
        """SD count (not multiplicity) per cell of the selected population
        (reference particles_diag.ipp:196-219)."""
        self._check_selected()
        self._set_outbuf(self._sd_count_impl(self._n_filtered))

    def diag_dry_mom(self, n):
        self._check_selected()
        self._moms(n / 3.0, lambda st: st.rd3)

    def diag_wet_mom(self, n):
        self._check_selected()
        self._moms(n / 2.0, lambda st: st.rw2)

    def diag_kappa_mom(self, n):
        self._check_selected()
        self._moms(float(n), lambda st: st.kpa)

    def diag_wet_mass_dens(self, rad, sig0):
        """Kernel-density estimate of the selected SDs' mass density at wet
        radius ``rad``, bandwidth ``sig0`` over the fifth root of the
        cell's SD count (reference particles_diag.ipp:494-499,
        particles_impl_mass_dens.ipp:8-113)."""
        self._check_selected()
        self._set_outbuf(self._mass_dens_impl(self._n_filtered, float(rad),
                                              float(sig0)))

    def diag_vel_div(self):
        """Divergence of the flow of each cell [1/s] from the courants
        (reference particles_diag.ipp:501-556)."""
        self._require_init()

        def fn(cfg, st):
            ijk = torch.arange(cfg.n_cell, device=st.th.device)
            (lft, rgt), (fre, hnd), (blw, abv) = transport.courant_indices(
                cfg, ijk)
            div = torch.zeros(cfg.n_cell, dtype=st.th.dtype,
                              device=st.th.device)
            if cfg.n_dims >= 1:
                div = div + st.courant_x[rgt] - st.courant_x[lft]
            if cfg.n_dims == 3:
                div = div + st.courant_y[hnd] - st.courant_y[fre]
            if cfg.n_dims > 1:
                div = div + st.courant_z[abv] - st.courant_z[blw]
            return div / cfg.dt

        self._set_outbuf(self._map(fn, self.state))

    def diag_precip_rate(self):
        """1st non-specific moment of rw^3 * vt of the selected SDs
        (reference particles_diag.ipp:561-588)."""
        self._check_selected()
        self._set_outbuf(self._precip_rate_impl(False))

    # the ice and liquid selections and the ice moments (reference
    # particles_diag.ipp:276-607; libcloudphxx_tpu/lgrngn/particles.py:
    # 766-846)
    def _require_ice(self):
        if not self.opts_init.ice_switch:
            raise RuntimeError(
                "libcloudphxx: ice is switched off in opts_init, but "
                "diag_ice was called")

    def diag_ice(self):
        """Select the frozen SDs (particles_diag.ipp:276-283)."""
        self._require_ice()
        self._select(lambda st: st.ice_a > 0)

    def diag_water(self):
        """Select the liquid SDs (particles_diag.ipp:285-290)."""
        self._require_init()
        self._select(lambda st: st.rw2 > 0)

    def diag_ice_cons(self):
        self._require_ice()
        self._cons(lambda st: st.ice_a > 0)

    def diag_water_cons(self):
        self._require_init()
        self._cons(lambda st: st.rw2 > 0)

    def diag_ice_a_rng(self, a_min, a_max):
        self._require_ice()
        self._select(lambda st: (st.ice_a >= a_min) & (st.ice_a < a_max))

    def diag_ice_c_rng(self, c_min, c_max):
        self._require_ice()
        self._select(lambda st: (st.ice_c >= c_min) & (st.ice_c < c_max))

    def diag_ice_a_rng_cons(self, a_min, a_max):
        self._require_ice()
        self._cons(lambda st: (st.ice_a >= a_min) & (st.ice_a < a_max))

    def diag_ice_c_rng_cons(self, c_min, c_max):
        self._require_ice()
        self._cons(lambda st: (st.ice_c >= c_min) & (st.ice_c < c_max))

    def diag_ice_a_mom(self, n):
        self._require_ice()
        self._check_selected()
        self._moms(float(n), lambda st: st.ice_a)

    def diag_ice_c_mom(self, n):
        self._require_ice()
        self._check_selected()
        self._moms(float(n), lambda st: st.ice_c)

    def diag_ice_mix_ratio(self):
        """The selected SDs' specific ice mass per cell
        (particles_diag.ipp:443-454)."""
        self._require_ice()
        self._check_selected()
        self._moms(1.0, lambda st: ice_mass(st.ice_a, st.ice_c, st.ice_rho))

    def diag_precip_rate_ice_mass(self):
        """1st non-specific moment of the ice mass * vt of the selected SDs
        (particles_diag.ipp:590-607)."""
        self._require_ice()
        self._check_selected()
        self._set_outbuf(self._precip_rate_impl(True))

    def diag_chem(self, species):
        """The selected SDs' specific mass of a dissolved species per cell
        (reference particles_diag.ipp diag_chem, moms_calc over
        chem_bgn)."""
        self._require_init()
        if not self.cfg.chem_switch:
            raise RuntimeError(
                "libcloudphxx: all chemistry was switched off in opts_init")
        self._check_selected()
        self._moms(1.0, lambda st: st.chem[int(species)])

    def diag_max_rw(self):
        """Largest wet radius per cell (reference particles_diag.ipp:
        609-643)."""
        self._require_init()
        rw = self._map(lambda cfg, st: torch.where(
            st.n > 0, torch.sqrt(torch.clamp(st.rw2, min=0.0)), 0.0),
            self.state)
        self._set_outbuf(self._segment_max_impl(rw))

    def diag_incloud_time_mom(self, n):
        """The selected SDs' moment of their in-cloud time (reference
        particles_diag.ipp:484-492)."""
        if not self.opts_init.diag_incloud_time:
            raise RuntimeError(
                "libcloudphxx: diag_incloud_time_mom called, but "
                "opts_init.diag_incloud_time == false")
        self._check_selected()
        self._moms(float(n), lambda st: st.incloud_time)

    def diag_up_mom(self, n):
        """The selected SDs' moment of their SGS x-velocity perturbation
        (reference particles.hpp:117)."""
        self._check_selected()
        self._moms(float(n), lambda st: st.up)

    def diag_vp_mom(self, n):
        """(reference particles.hpp:118; zero off the 3-D grid)"""
        self._check_selected()
        self._moms(float(n), lambda st: st.vp)

    def diag_wp_mom(self, n):
        """(reference particles.hpp:119)"""
        self._check_selected()
        self._moms(float(n), lambda st: st.wp)

    def diag_puddle(self):
        """(reference particles_impl_bcnd.ipp puddle accumulators)"""
        self._require_init()
        vals = self.state.puddle.double().cpu().numpy()
        return dict(zip(PUDDLE_KEYS, vals.tolist()))

    def outbuf(self):
        """The last diagnostic, as a (n_cell,) float64 numpy array
        (reference particles.hpp outbuf + fill_outbuf.ipp:13-37)."""
        return np.array(self._outbuf)

    def get_attr(self, name):
        """Raw per-SD attribute dump (reference fill_outbuf.ipp:39-100),
        as numpy; a position the grid lacks reads zero, as the JAX
        package's does."""
        self._require_init()
        if name in ("ice_a", "ice_c", "ice_rho", "rd2_insol", "T_freeze") \
                and not self.opts_init.ice_switch:
            raise RuntimeError(
                "libcloudphxx: ice attribute requested with ice_switch off")
        if name not in ATTR_NAMES:
            raise ValueError(f"lgrngn: unknown attribute {name!r}")
        field = "kpa" if name == "kappa" else name
        return self._sd_to_host(self._map(lambda cfg, st: getattr(st, field),
                                          self.state))

    # -------------------------------------------------- checkpoint/resume
    def save(self, path):
        """Full-state checkpoint: every State field, the random stream and
        the call-order machine, to one npz."""
        self._require_init()
        leaves = self._state_arrays()
        leaves["__flags__"] = np.array([
            self._init_called, self._should_now_run_cond,
            self._should_now_run_async], dtype=bool)
        leaves["__counters__"] = np.array([self._sstp_coal_extra,
                                           self._src_ctr, self._rlx_ctr])
        np.savez_compressed(path, **leaves)

    def load(self, path):
        """Restore a checkpoint written by save() into this instance
        (opts_init must match the one used at save time)."""
        with np.load(path) as d:
            arrays = dict(d)
        self.state = self._put_state(arrays)
        flags, ctrs = arrays["__flags__"], arrays["__counters__"]
        self._sstp_coal_extra = int(ctrs[0])
        self._src_ctr, self._rlx_ctr = (int(v) for v in ctrs[1:3])
        self._init_called = bool(flags[0])
        self._should_now_run_cond = bool(flags[1])
        self._should_now_run_async = bool(flags[2])


# get_attr's names ("kappa" is kpa, the reference's spelling)
ATTR_NAMES = ("rd3", "rw2", "kpa", "kappa", "n", "x", "y", "z", "vt",
              "incloud_time", "up", "vp", "wp", "rd2_insol", "T_freeze",
              "ice_a", "ice_c", "ice_rho")


def state_arrays(st: State) -> dict:
    """A State's tensors as numpy arrays, and its random stream (seed,
    step, key word) as ``__rng__``: a checkpoint's leaves."""
    leaves = {k: getattr(st, k).cpu().numpy() for k in TENSOR_FIELDS}
    leaves["__rng__"] = np.array([st.rng_seed, st.rng_step, st.rng_key],
                                 dtype=np.int64)
    return leaves


def state_from_arrays(arrays: dict, like: State) -> State:
    """The inverse of state_arrays, each tensor of ``like``'s dtype and
    device and checked against its shape; a checkpoint without a key word
    (``__rng__`` of two) has the serial engine's, 0."""
    leaves = {}
    for k in TENSOR_FIELDS:
        ref, a = getattr(like, k), arrays[k]
        if a.shape != tuple(ref.shape):
            raise ValueError(
                f"lgrngn load: shape mismatch for {k} ({a.shape} vs "
                f"{tuple(ref.shape)}): was the checkpoint written with "
                "other opts_init?")
        leaves[k] = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    seed, step, *key = (int(v) for v in arrays["__rng__"])
    return State(**leaves, rng_seed=seed, rng_step=step,
                 rng_key=key[0] if key else 0)


def factory(backend: backend_t, opts_init: opts_init_t, *, device="cuda",
            dtype=torch.float32, engine="auto", group=None,
            debug=False) -> particles_t:
    """Runtime backend dispatch (reference src/lib.cpp:12-44;
    libcloudphxx_tpu/lgrngn/particles.py:1028-1052): the public API on
    ``device``.  ``engine`` "auto" gives the dense front
    (lgrngn/dense_front.particles_dense_t) on a CUDA device for every
    configuration the dense engine runs (dense_front.dense_capable), as
    the JAX factory does on its accelerator, and the flat particles_t
    otherwise (on the CPU always); "dense" asks for the dense front (it
    raises for a configuration it does not run) and "flat" for
    particles_t.  The keyword takes the place of the JAX package's
    LIBCLOUD_ENGINE: the port reads no environment variables.
    ``opts_init.dev_count`` > 1, or multi_CUDA where more than one card is
    visible, gives the multi-device front (parallel/multi.
    particles_multi_t) of dev_count shards (every visible card where it
    is 0) on ``device``, one device or a list, whatever ``engine`` says:
    it runs the flat engine on each shard, as the JAX package's does;
    ``group``, a torch.distributed process group, spreads its shards over
    the group's processes (parallel/multi.py).  ``debug`` is particles_t's
    NaN sweep."""
    if engine not in ("auto", "dense", "flat"):
        raise ValueError(f"factory: engine must be 'auto', 'dense' or "
                         f"'flat', got {engine!r}")
    dev_count = int(opts_init.dev_count)
    if dev_count > 1 or (backend == backend_t.multi_CUDA
                         and torch.cuda.device_count() > 1):
        from ..parallel.multi import particles_multi_t
        return particles_multi_t(backend, opts_init,
                                 n_devices=dev_count or None, device=device,
                                 dtype=dtype, group=group, debug=debug)
    from . import dense
    from .dense_front import dense_capable, particles_dense_t
    cfg = StaticConfig.from_opts_init(opts_init)
    if engine == "auto" and (torch.device(device).type != "cuda"
                             or not dense_capable(cfg)):
        engine = "flat"
    if group is not None:
        raise ValueError("factory: a process group takes the multi-device "
                         "front (opts_init.dev_count > 1)")
    if engine == "flat":
        return particles_t(backend, opts_init, device=device, dtype=dtype,
                           debug=debug)
    dense.supported(cfg)
    return particles_dense_t(backend, opts_init, device=device, dtype=dtype,
                             debug=debug)
