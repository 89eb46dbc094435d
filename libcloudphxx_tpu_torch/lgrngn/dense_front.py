"""The public API over the dense cell-major engine
(libcloudphxx_tpu/lgrngn/dense_front.py).

``particles_dense_t`` is a particles_t whose stepping hooks run on the
(n_cell, cap) occupancy matrix of lgrngn/dense.py: step_cond runs the
condensation phase of the resident step (kernel B on the card; with
exact_sstp_cond the per-particle substepping, kernel G a substep) and
step_async the rest of it (kernels E, C and D), the same kernels
Kinematic2D.run_device_lgrngn(engine="dense") runs, while every
diagnostic, get_attr and checkpoint reads the flat layout.  The factory
hands it out on a CUDA device for every configuration the dense engine
runs (dense_capable: the 2-D and the 3-D grid, every collision kernel);
the others run on the flat engine.

Residency protocol:
  - ``_loc``           where the authoritative population lives, "flat" or
                       "dense";
  - ``_ensure_dense``  packs the flat state (one global sort) before dense
                       stepping;
  - ``_ensure_flat``   unpacks (in exact mode the private planes become the
                       flat State's per-SD snapshot) before any reader of
                       the flat layout: it is
                       hooked into ``_require_init``, where every diagnostic
                       starts, and raises if rows overflowed meanwhile (the
                       deferred overflow check: the stepping loop does not
                       read the device counter).
A switch costs one global sort each way, paid only where the caller
interleaves stepping with diagnostics.

The SGS switches an LES host turns on go to the flat engine call by call,
as in the JAX package (libcloudphxx_tpu/lgrngn/dense_front.py:176-240):
turb_cond runs its condensation there, and turb_adve, turb_cond, turb_coal
and recycling their async phases; the sources and the relaxation read and
write the flat layout.  Under turb_adve_switch (the dense engine runs the
configuration: kernel B condenses) the SDs' velocity perturbations ride
each pack and unpack beside the planes (``_riders``), and every async
phase runs on the flat engine, so that no dense phase moves an SD away
from them; the JAX front leaves them in the pre-pack order.
"""

import dataclasses

import torch

from . import dense
from .particles import particles_t

# the per-SD attributes that the dense layout carries; the others keep the
# flat layout's stale order once dense stepping has run, so get_attr
# refuses them rather than hand them out
_CARRIED = {"n", "rw2", "rd3", "kpa", "kappa", "x", "y", "z", "vt"}


def dense_capable(cfg) -> bool:
    """Whether the dense engine runs this configuration (dense.supported)."""
    try:
        dense.supported(cfg)
        return True
    except NotImplementedError:
        return False


def initial_capacity(max_count):
    """Row capacity of a population whose densest cell holds ``max_count``
    SDs: twice that, 8-lane aligned, then a power of two, which kernel E
    needs (128 at the GMD case's 64 SDs a cell)."""
    cap = max(8, int(-(-2 * int(max_count) // 8) * 8))
    return 1 << (cap - 1).bit_length()


class particles_dense_t(particles_t):
    """particles_t with the dense engine behind step_cond and step_async.
    ``coal_pairing`` is the coalescence pairing of kernel E ("stride" or
    "sort", ops/coal.py)."""

    coal_pairing = "stride"

    def init(self, th, rv, rhod, *args, **kwargs):
        super().init(th, rv, rhod, *args, **kwargs)
        st = self.state
        counts = torch.bincount(st.ijk[st.n > 0], minlength=self.cfg.n_cell)
        self._cap = initial_capacity(int(counts.max()))
        self._loc = "flat"
        self._d = None
        self._riders = {}
        self._dense_stepped = False
        # the density the engine last saw, and the caller's tensor it came
        # from (see sync_in)
        self._rhod_handle = rhod if isinstance(rhod, torch.Tensor) else None
        self._last_rhod = st.rhod
        self._rhod_changed = False

    # ------------------------------------------------ residency switching
    def _rider_names(self):
        """The per-SD attributes the dense layout does not carry that
        ride a pack and unpack: the velocity perturbations under
        turb_adve_switch."""
        return ("up", "wp") if self.opts_init.turb_adve_switch else ()

    def _ensure_dense(self):
        if self._loc != "dense":
            st = self.state
            if self._rider_names():
                # unpack puts the live SDs first in pack's order: the
                # stable sort of their cells
                live = st.n > 0
                order = torch.argsort(torch.where(live, st.ijk,
                                                  self.cfg.n_cell),
                                      stable=True)[:int(live.sum())]
                self._riders = {k: getattr(st, k)[order]
                                for k in self._rider_names()}
            d = dense.pack(self.cfg, self.state, self._cap)
            if int(d.overflow):
                raise RuntimeError(
                    f"lgrngn dense engine: the population exceeds row "
                    f"capacity {self._cap}")
            self._d, self._loc = d, "dense"

    def _check_overflow(self):
        """The deferred row-overflow check, at every flat-sync point: SDs
        dropped on a full row never pass silently."""
        if self._d is not None and self._loc == "dense":
            dropped = int(self._d.overflow)
            if dropped:
                raise RuntimeError(
                    f"lgrngn dense engine: {dropped} SDs dropped on row "
                    f"overflow (capacity {self._d.cap})")

    def _ensure_flat(self):
        if self._loc == "dense":
            self._check_overflow()
            st = dense.unpack(self.cfg, self._d, self.state)
            if self._riders:
                back = {}
                for k, v in self._riders.items():
                    a = torch.zeros_like(getattr(st, k))
                    a[:v.shape[0]] = v
                    back[k] = a
                st = dataclasses.replace(st, **back)
                self._riders = {}
            self.state = st
            self._loc = "flat"

    def adopt(self, d):
        """Make the DenseState ``d`` the authoritative population (a dense
        run of the model hands its result back here)."""
        self._d, self._loc, self._cap = d, "dense", d.cap
        self._dense_stepped, self._riders = True, {}

    def _require_init(self):
        super()._require_init()
        self._ensure_flat()

    def _src_engine(self):
        self._ensure_flat()
        return super()._src_engine()

    def get_attr(self, name):
        if self._dense_stepped and name not in _CARRIED \
                and name not in self._rider_names():
            raise RuntimeError(
                f"lgrngn dense engine: attribute {name!r} is not carried "
                f"through the dense layout (carried: {sorted(_CARRIED)})")
        return super().get_attr(name)

    def load(self, path):
        super().load(path)
        # the restored flat state is authoritative; drop any dense copy
        self._loc, self._d, self._riders = "flat", None, {}

    # ------------------------------------------------------ sync tracking
    def sync_in(self, th=None, rv=None, rhod=None, **kwargs):
        """particles_t.sync_in, noting whether the density changed.  The
        same tensor handle means the same values (no device read); a numpy
        array or another tensor is compared with the density the engine
        last saw, the one given to init included."""
        super().sync_in(th=th, rv=rv, rhod=rhod, **kwargs)
        if rhod is None:
            self._rhod_changed = False
            return
        if isinstance(rhod, torch.Tensor) and rhod is self._rhod_handle:
            self._rhod_changed = False
        else:
            self._rhod_changed = not torch.equal(self.state.rhod,
                                                 self._last_rhod)
        self._rhod_handle = rhod if isinstance(rhod, torch.Tensor) else None
        self._last_rhod = self.state.rhod

    def consume_coal_overflow(self):
        """particles_t's, with the flag cleared in the dense copy too,
        whose puddle the next async phase starts from (the JAX dense front
        clears it in the flat state only, so there the request, once made,
        grows sstp_coal every later step)."""
        grew = self._sstp_coal_extra
        super().consume_coal_overflow()
        if self._sstp_coal_extra != grew and self._loc == "dense":
            self._d = dataclasses.replace(self._d, puddle=self.state.puddle)

    # --------------------------------------------------------- step hooks
    def _step_cond_impl(self, state, dt, RH_max, var_rho, turb_cond, plain):
        if turb_cond or (var_rho and self._rhod_changed):
            # the SGS supersaturation, or the density changed (the
            # substepped density of sstp_percell_step.ipp:17-20): the flat
            # engine's condensation for this step (the async phase follows
            # it there)
            synced = {k: getattr(state, k) for k in (
                "th", "rv", "rhod", "courant_x", "courant_y", "courant_z",
                "diss_rate")}
            self._ensure_flat()
            return super()._step_cond_impl(
                dataclasses.replace(self.state, **synced), dt, RH_max,
                var_rho, turb_cond, plain)
        self._ensure_dense()
        d = dataclasses.replace(self._d, rhod=state.rhod,
                                courant_x=state.courant_x,
                                courant_z=state.courant_z)
        if self.cfg.n_dims == 3:
            d = dataclasses.replace(d, courant_y=state.courant_y)
        d, th, rv = dense.step_cond_resident(
            self._cfg_for_dt(dt), d, state.th, state.rv, dt, RH_max,
            plain=plain)
        self._d, self._dense_stepped = d, True
        # in exact mode the flat snapshot is per SD: the private planes
        # hold it until the next unpack
        saved = {} if self.cfg.exact_sstp_cond else dict(
            sstp_tmp_th=d.sstp_tmp_th, sstp_tmp_rv=d.sstp_tmp_rv)
        return dataclasses.replace(state, th=th, rv=rv, T=d.T, p=d.p,
                                   RH=d.RH, eta=d.eta, **saved)

    def _step_async_impl(self, sstp, switches, state, params, w_LS, dt,
                         plain):
        if self._loc != "dense" or any(switches[4:]) \
                or self._rider_names():
            # condensation ran on the flat engine this step (the layouts do
            # not interleave within a step), or an SGS switch or recycling
            # is on: the flat engine's async phase, on the population
            # unpacked with the step's synced fields
            self._ensure_flat()
            return super()._step_async_impl(sstp, switches, self.state,
                                            params, w_LS, dt, plain)
        do_coal, do_adve, do_sedi, do_subs = switches[:4]
        d = dense.step_async_resident(
            self.cfg, self._d, params, dt, sstp, do_coal, do_sedi, do_adve,
            do_subs, w_LS, coal_pairing=self.coal_pairing, plain=plain)
        self._d, self._dense_stepped = d, True
        # the overflow check waits for the next flat-sync point
        return dataclasses.replace(state, puddle=d.puddle,
                                   rng_step=d.rng_step)

