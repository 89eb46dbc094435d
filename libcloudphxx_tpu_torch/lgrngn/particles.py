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

The port runs the warm 2-D engine, with the per-cell and the exact and
adaptive per-particle condensation substepping: ice, chemistry, SGS
turbulence, diag_incloud_time, sources, relaxation, recycling and the
multi-device front-end raise NotImplementedError (ROADMAP.md, Queue 1).
On a CUDA device the condensation runs kernel F (per cell) or kernel G
(per particle; ops/cond.py); nothing falls back to the CPU.
The factory hands out this flat engine or, on a CUDA device, the dense
front (lgrngn/dense_front.py), which overrides the _step_cond_impl and
_step_async_impl hooks.
"""

import dataclasses
import math

import numpy as np
import torch

from . import coalescence, condensation, hskpng, transport
from . import init as init_mod
from .enums import backend_t, kernel_t
from .opts import opts_init_t, opts_t
from .state import (OUT_COAL_OVERFLOW, PUDDLE_KEYS, TENSOR_FIELDS, State,
                    StaticConfig, empty_state)
from .vterm import hskpng_vterm_all


def step_cond_body(cfg: StaticConfig, state: State, dt, RH_max,
                   var_rho: bool = False, *, plain=False) -> State:
    """The condensation phase (libcloudphxx_tpu/lgrngn/particles.py:70-120):
    mean free paths from the previous step's T/p, the cell closure, then
    the exact per-particle substepping (adaptive or fixed; kernel G on the
    card) where exact_sstp_cond asks for more than one substep, else the
    per-cell substepping (kernel F on the card), and sstp_save.  ``plain``
    runs the kernels' plain versions on any device."""
    if condensation.exact_route(cfg):
        # exact per-particle substepping (particles_step.ipp:199-236);
        # the mean free paths from the T/p before the closure
        stale = (state.T, state.p)
        state = hskpng.hskpng_Tpr_state(cfg, state)
        cond = condensation.cond_perparticle_adaptive \
            if cfg.adaptive_sstp_cond else condensation.cond_perparticle
        state = cond(cfg, state, dt, RH_max, stale, plain=plain)
        return condensation.sstp_save(state, exact=True)
    lam = condensation.stale_mfp(state)
    state = hskpng.hskpng_Tpr_state(cfg, state)
    state = condensation.cond_percell(cfg, state, dt, RH_max, lam,
                                      var_rho=var_rho, plain=plain)
    return condensation.sstp_save(state, exact=cfg.exact_sstp_cond)


def step_async_body(cfg: StaticConfig, sstp_coal: int, switches, state: State,
                    params, w_LS, dt) -> State:
    """The transport phase (libcloudphxx_tpu/lgrngn/particles.py:144-179;
    reference particles_step.ipp:339-494), warm: closure, vt, the
    coalescence substeps, advection, sedimentation, subsidence, the walls
    and the re-bin.  ``switches`` = (do_coal, do_adve, do_sedi, do_subs)."""
    do_coal, do_adve, do_sedi, do_subs = switches
    state = hskpng.hskpng_Tpr_state(cfg, state)
    state = hskpng_vterm_all(cfg, state)
    if do_coal:
        state = coalescence.coal(cfg, state, params, dt, sstp_coal)
    if do_adve:
        state = transport.adve(cfg, state)
    if do_sedi:
        state = transport.sedi(state, dt)
    if do_subs:
        state = transport.subs(cfg, state, w_LS, dt)
    state = transport.bcnd(cfg, state)
    return transport.post_step(cfg, state)


def _require_ported(oi: opts_init_t):
    """Raise NotImplementedError for what the port's flat engine does not
    run."""
    off = [name for name in (
        "ice_switch", "chem_switch", "turb_cond_switch", "turb_adve_switch",
        "turb_coal_switch", "diag_incloud_time") if getattr(oi, name)]
    if off:
        raise NotImplementedError(
            f"particles_t: {', '.join(off)} is not ported (ROADMAP.md, "
            "Queue 1, \"The flat engine's remaining features\")")
    if oi.n_dims != 2 or oi.ny > 0:
        raise NotImplementedError(
            "particles_t: only the 2-D (x, z) grid is ported (ROADMAP.md, "
            "Queue 1, \"The flat engine's remaining features\")")


class particles_t:
    """The reference's particles_proto_t (particles.hpp:16-134) over the
    flat engine.  ``device`` is where the state lives (the card unless the
    caller asks for the CPU) and ``dtype`` its working precision (float32
    on the card: kernels F and G take float32 only)."""

    def __init__(self, backend: backend_t, opts_init: opts_init_t, *,
                 device="cuda", dtype=torch.float32):
        self.backend = backend
        self.opts_init = opts_init
        if opts_init.n_sd_max == 0:
            raise ValueError("lgrngn: n_sd_max == 0")
        if opts_init.dt <= 0:
            raise ValueError("lgrngn: opts_init.dt must be positive")
        if opts_init.th_dry == opts_init.const_p:
            raise ValueError(
                "lgrngn: exactly one of th_dry/const_p must be true")
        _require_ported(opts_init)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "particles_t: device 'cuda' asked for, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU")
        self.dtype = dtype
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

    def _cfg_for_dt(self, dt):
        """Variable-dt substep rescale (reference
        particles_impl_adjust_timesteps.ipp:17-21): substep counts > 1 scale
        by ceil(sstp * dt / opts_init.dt)."""
        cfg = self.cfg
        if dt == cfg.dt:
            return cfg
        adj = lambda s: int(math.ceil(s * dt / cfg.dt)) if s > 1 else s
        return dataclasses.replace(cfg, sstp_cond=adj(cfg.sstp_cond),
                                   sstp_cond_act=adj(cfg.sstp_cond_act),
                                   sstp_chem=adj(cfg.sstp_chem))

    # ---- the engine's hooks: the dense front (lgrngn/dense_front.py)
    # overrides them (libcloudphxx_tpu/lgrngn/particles.py:255-264)
    def _step_cond_impl(self, state, dt, RH_max, var_rho, plain):
        """The condensation phase on ``state``; returns the new State."""
        return step_cond_body(self._cfg_for_dt(dt), state, dt, RH_max,
                              var_rho, plain=plain)

    def _step_async_impl(self, sstp, switches, state, params, w_LS, dt,
                         plain):
        """The transport phase on ``state``; returns the new State (the
        flat engine's async phase runs no kernel, so ``plain`` changes
        nothing here)."""
        return step_async_body(self.cfg, sstp, switches, state, params, w_LS,
                               dt)

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
        """Validate and flatten the Arakawa-C staggered courant fields."""
        if courant_y is not None:
            raise NotImplementedError(
                "particles_t: courant_y (3-D) is not ported (ROADMAP.md, "
                "Queue 1, \"The flat engine's remaining features\")")
        cfg = self.cfg
        upd = {}
        for name, arr, size in (
                ("courant_x", courant_x, (cfg.nx + 1) * cfg.nz),
                ("courant_z", courant_z, cfg.nx * (cfg.nz + 1))):
            a = self._as_flat(arr, size, name)
            if a is not None:
                upd[name] = a
        return upd

    def _no_chem(self, ambient_chem):
        if ambient_chem:
            raise RuntimeError(
                "libcloudphxx: chemistry was switched off and ambient_chem "
                "is not empty")

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
        self._no_chem(ambient_chem)
        n_cell = cfg.n_cell
        rhod_t = self._as_flat(rhod, n_cell, "rhod")
        p_t = self._as_flat(p, n_cell, "p")
        if cfg.const_p and p_t is None:
            raise ValueError("lgrngn: const_p requires a pressure profile")
        st = dataclasses.replace(
            self.state, th=self._as_flat(th, n_cell, "th"),
            rv=self._as_flat(rv, n_cell, "rv"), rhod=rhod_t,
            p=p_t if p_t is not None else torch.zeros_like(rhod_t),
            dv=self._tensor(init_mod.cell_dv(cfg)), rng_seed=oi.rng_seed,
            rng_step=0,
            **self._courant_updates(courant_x, courant_y, courant_z))
        st = hskpng.hskpng_Tpr_state(cfg, st)
        # SD creation with the init seed (particles_init.ipp:30-32, :130)
        if not oi.no_ccn_at_init:
            seed = oi.rng_seed_init if oi.rng_seed_init_switch \
                else oi.rng_seed
            st = init_mod.init_SD_state(
                cfg, oi, st, np.random.default_rng(seed),
                rhod_t.double().cpu().numpy())
            st = init_mod.init_wet_state(st, oi.RH_max)
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
        self._no_chem(ambient_chem)
        if diss_rate is not None:
            raise NotImplementedError(
                "particles_t: diss_rate (SGS turbulence) is not ported "
                "(ROADMAP.md, Queue 1, \"The flat engine's remaining "
                "features\")")
        n_cell = self.cfg.n_cell
        upd = {}
        for name, arr in (("th", th), ("rv", rv), ("rhod", rhod)):
            a = self._as_flat(arr, n_cell, name)
            if a is not None:
                upd[name] = a
        upd.update(self._courant_updates(courant_x, courant_y, courant_z))
        if upd:
            self.state = dataclasses.replace(self.state, **upd)
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
        if opts.chem_dsl or opts.chem_dsc or opts.chem_rct:
            raise RuntimeError(
                "libcloudphxx: all chemistry was switched off in opts_init")
        self._no_chem(ambient_chem)
        device_io = isinstance(th, torch.Tensor) \
            or isinstance(rv, torch.Tensor)
        if opts.cond:
            self.state = self._step_cond_impl(
                self.state, dt, float(opts.RH_max), self._var_rho, plain)
            if not device_io:
                for arr, new in ((th, self.state.th), (rv, self.state.rv)):
                    if arr is not None:
                        np.asarray(arr).reshape(-1)[:] = new.cpu().numpy()
        self._should_now_run_async = True
        if device_io:
            return self.state.th, self.state.rv
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
        do_sedi = bool(opts.sedi and cfg.sedi_switch)
        if do_sedi and cfg.terminal_velocity == 0:
            raise RuntimeError(
                "libcloudphxx: opts.sedi requires opts_init.terminal_velocity")
        unported = [name for name in ("rcyc", "src", "rlx")
                    if getattr(opts, name)]
        if unported:
            raise NotImplementedError(
                f"particles_t: opts.{', opts.'.join(unported)} (recycling, "
                "sources, relaxation) is not ported (ROADMAP.md, Queue 1, "
                "\"The flat engine's remaining features\")")
        # the substep count follows a variable dt (adjust_timesteps.ipp:
        # 14-24), plus any growth from const-multi collision overflow
        sstp = self.opts_init.sstp_coal
        if opts.dt > 0 and sstp > 1:
            sstp = math.ceil(sstp * dt / cfg.dt)
        sstp += self._sstp_coal_extra
        params, w_LS = self.async_consts()
        switches = (do_coal, bool(opts.adve), do_sedi, bool(opts.subs))
        if any(switches):
            self.state = self._step_async_impl(int(sstp), switches,
                                               self.state, params, w_LS, dt,
                                               plain)
        if do_coal and cfg.pure_const_multi:
            # consume the adaptive-substep request (particles_step.ipp:
            # 394-400)
            pud = self.state.puddle
            if float(pud[OUT_COAL_OVERFLOW]) > 0:
                self._sstp_coal_extra += 1
                pud = pud.clone()
                pud[OUT_COAL_OVERFLOW] = 0.0
                self.state = dataclasses.replace(self.state, puddle=pud)

    # ----------------------------------------------------------- diagnostics
    def _require_init(self):
        if not self._init_called:
            raise RuntimeError("libcloudphxx: init() has not been called")

    def _set_outbuf(self, per_cell):
        self._outbuf = per_cell.double().cpu().numpy()

    def _tpr(self):
        return hskpng.hskpng_Tpr_state(self.cfg, self.state)

    def diag_pressure(self):
        self._require_init()
        self._set_outbuf(self._tpr().p)

    def diag_temperature(self):
        self._require_init()
        self._set_outbuf(self._tpr().T)

    def diag_RH(self):
        self._require_init()
        self._set_outbuf(self._tpr().RH)

    # selection filters (reference particles_diag.ipp:224-340)
    def diag_all(self):
        self._require_init()
        self._n_filtered = self.state.n

    def diag_dry_rng(self, r_min, r_max):
        self._require_init()
        rd3 = self.state.rd3
        sel = (rd3 >= r_min ** 3) & (rd3 < r_max ** 3)
        self._n_filtered = torch.where(sel, self.state.n, 0.0)

    def diag_wet_rng(self, r_min, r_max):
        self._require_init()
        rw2 = self.state.rw2
        sel = (rw2 >= r_min ** 2) & (rw2 < r_max ** 2)
        self._n_filtered = torch.where(sel, self.state.n, 0.0)

    def _check_selected(self):
        if self._n_filtered is None:
            raise RuntimeError(
                "libcloudphxx: please select SDs before calling a moment "
                "diag")

    def _moms(self, power, attr):
        st = self.state
        return hskpng.segment_moment(self.cfg, self._n_filtered, attr, power,
                                     st.ijk, st.dv, st.rhod)

    def diag_sd_conc(self):
        """SD count (not multiplicity) per cell of the selected population
        (reference particles_diag.ipp:196-219)."""
        self._check_selected()
        self._set_outbuf(hskpng.sd_count_per_cell(
            self.cfg, self._n_filtered, self.state.ijk))

    def diag_dry_mom(self, n):
        self._check_selected()
        self._set_outbuf(self._moms(n / 3.0, self.state.rd3))

    def diag_wet_mom(self, n):
        self._check_selected()
        self._set_outbuf(self._moms(n / 2.0, self.state.rw2))

    def diag_precip_rate(self):
        """1st non-specific moment of rw^3 * vt of the selected SDs
        (reference particles_diag.ipp:561-588)."""
        self._check_selected()
        st = hskpng_vterm_all(self.cfg, self._tpr())
        vals = self._n_filtered * st.rw2 ** 1.5 * st.vt
        out = torch.zeros(self.cfg.n_cell, dtype=vals.dtype,
                          device=vals.device)
        self._set_outbuf(out.index_add_(0, st.ijk, vals))

    def diag_max_rw(self):
        """Largest wet radius per cell (reference particles_diag.ipp:
        609-643)."""
        self._require_init()
        st = self.state
        rw = torch.where(st.n > 0, torch.sqrt(torch.clamp(st.rw2, min=0.0)),
                         0.0)
        out = torch.zeros(self.cfg.n_cell, dtype=rw.dtype, device=rw.device)
        self._set_outbuf(out.scatter_reduce_(0, st.ijk, rw, "amax"))

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
        as numpy; y reads zero on the 2-D grid, as the JAX package's
        does."""
        self._require_init()
        st = self.state
        held = {"rd3": st.rd3, "rw2": st.rw2, "kpa": st.kpa,
                "kappa": st.kpa, "n": st.n, "x": st.x, "z": st.z,
                "vt": st.vt}
        if name in ("ice_a", "ice_c", "ice_rho", "rd2_insol", "T_freeze"):
            raise RuntimeError(
                "libcloudphxx: ice attribute requested with ice_switch off")
        if name == "y":
            return np.zeros(self.cfg.n_sd_max, dtype=np.float64
                            if self.dtype == torch.float64 else np.float32)
        if name not in held:
            raise ValueError(f"lgrngn: unknown attribute {name!r}")
        return held[name].cpu().numpy()

    # -------------------------------------------------- checkpoint/resume
    def save(self, path):
        """Full-state checkpoint: every State field, the random stream and
        the call-order machine, to one npz."""
        self._require_init()
        st = self.state
        leaves = {k: getattr(st, k).cpu().numpy() for k in TENSOR_FIELDS}
        leaves["__rng__"] = np.array([st.rng_seed, st.rng_step],
                                     dtype=np.int64)
        leaves["__flags__"] = np.array([
            self._init_called, self._should_now_run_cond,
            self._should_now_run_async], dtype=bool)
        leaves["__counters__"] = np.array([self._sstp_coal_extra])
        np.savez_compressed(path, **leaves)

    def load(self, path):
        """Restore a checkpoint written by save() into this instance
        (opts_init must match the one used at save time)."""
        cur = self.state
        with np.load(path) as d:
            leaves = {}
            for k in TENSOR_FIELDS:
                ref = getattr(cur, k)
                a = d[k]
                if a.shape != tuple(ref.shape):
                    raise ValueError(
                        f"lgrngn load: shape mismatch for {k} ({a.shape} vs "
                        f"{tuple(ref.shape)}): was the checkpoint written "
                        "with other opts_init?")
                leaves[k] = torch.as_tensor(a, dtype=ref.dtype,
                                            device=ref.device)
            seed, step = (int(v) for v in d["__rng__"])
            flags = d["__flags__"]
            self._sstp_coal_extra = int(d["__counters__"][0])
        self.state = State(**leaves, rng_seed=seed, rng_step=step)
        self._init_called = bool(flags[0])
        self._should_now_run_cond = bool(flags[1])
        self._should_now_run_async = bool(flags[2])


def factory(backend: backend_t, opts_init: opts_init_t, *, device="cuda",
            dtype=torch.float32, engine="auto") -> particles_t:
    """Runtime backend dispatch (reference src/lib.cpp:12-44;
    libcloudphxx_tpu/lgrngn/particles.py:1028-1052): the public API on
    ``device``.  ``engine`` "auto" gives the dense front
    (lgrngn/dense_front.particles_dense_t) on a CUDA device for every
    configuration the dense engine runs (dense_front.dense_capable), as
    the JAX factory does on its accelerator, and the flat particles_t
    otherwise (on the CPU always); "dense" asks for the dense front (it
    raises for a configuration it does not run) and "flat" for
    particles_t.  The keyword takes the place of the JAX package's
    LIBCLOUD_ENGINE: the port reads no environment variables.  The
    multi-device front-end is not ported."""
    if engine not in ("auto", "dense", "flat"):
        raise ValueError(f"factory: engine must be 'auto', 'dense' or "
                         f"'flat', got {engine!r}")
    if int(opts_init.dev_count) > 1 or (
            backend == backend_t.multi_CUDA and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "factory: the multi-device front-end is not ported (ROADMAP.md, "
            "Queue 1, \"Multi-device: the flat front\"); the dense engine "
            "runs on an x-slab mesh through libcloudphxx_tpu_torch.parallel")
    from . import dense
    from .dense_front import dense_capable, particles_dense_t
    cfg = StaticConfig.from_opts_init(opts_init)
    if engine == "auto" and (torch.device(device).type != "cuda"
                             or not dense_capable(cfg)):
        engine = "flat"
    if engine == "flat":
        return particles_t(backend, opts_init, device=device, dtype=dtype)
    dense.supported(cfg)
    return particles_dense_t(backend, opts_init, device=device, dtype=dtype)
