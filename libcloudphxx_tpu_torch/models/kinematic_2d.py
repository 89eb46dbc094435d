"""The 2-D prescribed-flow kinematic cloud model ("icicle") with the
Lagrangian microphysics (libcloudphxx_tpu/models/kinematic_2d.py).

The GMD-2015 / 8th ICMW case-1 setup (reference
models/kinematic_2D/src/opts_common.hpp:48-66, cases/icmw8_case1.hpp):
MPDATA advection of th/rv (models/mpdata.py) and the super-droplet
microphysics through the public particles_t API (lgrngn/particles.py), on
the cell-centred grid: the stepwise loop (step, run) calls step_sync and
step_async, run_device_lgrngn runs the flat engine's step functions or
the dense cell-major engine (lgrngn/dense.py), the latter with the
occupancy-aware repack policy of long runs.  The port runs the lgrngn
scheme only.
"""

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from ..common import hydrostatic, theta_dry, theta_std
from ..lgrngn import dense
from ..lgrngn.dense_front import initial_capacity as dense_capacity
from ..lgrngn.dense_front import particles_dense_t
from ..lgrngn.enums import backend_t, kernel_t, vt_t
from ..lgrngn.opts import opts_init_t, opts_t
from ..lgrngn.particles import factory, step_async_body, step_cond_body
from ..ops.coal import MAX_CAP
from . import mpdata


@dataclasses.dataclass
class Setup:
    """ICMW8 case 1 defaults (reference opts_common.hpp:48-66)."""
    th_0: float = 289.0        # [K] standard potential temperature
    rv_0: float = 7.5e-3       # [kg/kg]
    p_0: float = 101500.0      # [Pa]
    w_max: float = 0.6         # [m/s]
    z_0: float = 0.0
    X: float = 1500.0          # [m]
    Z: float = 1500.0          # [m]
    dt: float = 1.0            # [s]
    mean_rd1: float = 0.02e-6
    mean_rd2: float = 0.075e-6
    sdev_rd1: float = 1.4
    sdev_rd2: float = 1.6
    n1_stp: float = 60e6
    n2_stp: float = 40e6
    kappa: float = 0.61

    def lognormal_lnrd(self, lnr):
        """Bimodal aerosol n(ln rd) @STP (icmw8_case1.hpp:61-78)."""
        out = 0.0
        for mean, sdev, n_tot in (
            (self.mean_rd1, self.sdev_rd1, self.n1_stp),
            (self.mean_rd2, self.sdev_rd2, self.n2_stp),
        ):
            out = out + (
                n_tot
                * np.exp(-((lnr - np.log(mean)) ** 2) / (2 * np.log(sdev) ** 2))
                / np.log(sdev) / np.sqrt(2 * np.pi)
            )
        return out


def rhod_profile(setup: Setup, z):
    """Hydrostatic dry-air density at heights ``z`` (a float64 tensor)
    (icmw8_case1.hpp:119-136)."""
    p = hydrostatic.p(z, setup.th_0, setup.rv_0, setup.z_0, setup.p_0)
    return theta_std.rhod(p, setup.th_0, setup.rv_0)


def make_gc(setup: Setup, nx, nz, dx, dz):
    """G-weighted courant fields from the discrete streamfunction
    (icmw8_case1.hpp:174-219); exactly divergence-free by telescoping.
    Returns float64 numpy arrays gc_x (nx+1, nz) and gc_z (nx, nz+1)."""
    A = setup.w_max * setup.X / (2 * np.pi)
    psi = lambda xX, zZ: -np.sin(np.pi * zZ) * np.cos(2 * np.pi * xX)

    xe = np.arange(nx + 1) * dx / setup.X       # x of x-faces
    zc = (np.arange(nz + 1)) * dz / setup.Z     # z of cell corners
    gc_x = (
        -A
        * (psi(xe[:, None], zc[None, 1:]) - psi(xe[:, None], zc[None, :-1]))
        / dz * setup.dt / dx
    )
    xc = np.arange(nx + 1) * dx / setup.X
    gc_z = (
        A
        * (psi(xc[None, 1:], zc[:, None]) - psi(xc[None, :-1], zc[:, None]))
        / dx * setup.dt / dz
    ).T
    return gc_x, gc_z


class Kinematic2D(nn.Module):
    """End-to-end kinematic cloud model with super-droplet microphysics
    (reference models/kinematic_2D/src/icicle.cpp + kin_cloud_2d_lgrngn.hpp).

    Every tensor is made on ``device``: the card unless the caller asks for
    the CPU.  ``dtype`` is the working precision of the fields and the
    population (float32 on the card; the kernels take float32 only).  The
    courant and density fields are buffers; th and rv (nx, nz) are
    attributes that each step replaces.  The microphysics is the public
    API (``prtcls``) that lgrngn.factory gives for ``engine`` ("auto": the
    dense front, lgrngn/dense_front.py, on a CUDA device, the flat
    particles_t on the CPU; or "dense" or "flat"); run_device_lgrngn runs
    the same population on the flat or the dense engine and hands it
    back."""

    def __init__(self, nx=76, nz=76, setup: Setup = None, micro="lgrngn",
                 sd_conc=64, sstp_cond=1, sstp_coal=1, n_sd_max=None,
                 mpdata_iters=2, grid="cell", fct=False,
                 terminal_velocity=None,
                 rng_seed=None, opts_init_kw=None, coal_pairing="stride", *,
                 engine="auto", device="cuda", dtype=torch.float32):
        super().__init__()
        if micro != "lgrngn":
            raise NotImplementedError(
                f"Kinematic2D: micro={micro!r} is not ported; only 'lgrngn' "
                "(ROADMAP.md, Queue 1)")
        if grid != "cell":
            raise NotImplementedError(
                f"Kinematic2D: grid={grid!r} is not ported; only 'cell' "
                "(ROADMAP.md, Queue 1)")
        self.setup = s = setup or Setup()
        self.nx, self.nz = nx, nz
        self.dx, self.dz = s.X / nx, s.Z / nz
        self.mpdata_iters = mpdata_iters
        self.fct = fct
        self.coal_pairing = coal_pairing
        self.device = torch.device(device)
        self.dtype = dtype

        z_scalar = (np.arange(nz) + 0.5) * self.dz
        z_zface = np.arange(nz + 1) * self.dz
        gc_x, gc_z = make_gc(s, nx, nz, self.dx, self.dz)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
        rhod_col = rhod_profile(s, f64(z_scalar)).numpy()
        rhod = np.broadcast_to(rhod_col, (nx, nz)).copy()
        # plain courants for the SDs: G-weighted ones divided by rhod
        # (kin_cloud_2d_lgrngn.hpp:180-196)
        C_x = gc_x / rhod_col[None, :]
        C_z = gc_z / rhod_profile(s, f64(z_zface)).numpy()[None, :]

        oi = opts_init_t()
        oi.dry_distros = {(s.kappa, 0.0): s.lognormal_lnrd}
        oi.nx, oi.nz = nx, nz
        oi.dx, oi.dz = self.dx, self.dz
        oi.x1, oi.z1 = s.X, s.Z
        oi.dt = s.dt
        oi.sd_conc = sd_conc
        oi.n_sd_max = n_sd_max or 2 * sd_conc * nx * nz
        oi.sstp_cond = sstp_cond
        oi.sstp_coal = sstp_coal
        if rng_seed is not None:
            oi.rng_seed = rng_seed
        oi.kernel = kernel_t.geometric
        oi.terminal_velocity = (terminal_velocity
                                if terminal_velocity is not None
                                else vt_t.beard77fast)
        for k, v in (opts_init_kw or {}).items():
            if not hasattr(oi, k):
                raise ValueError(
                    f"kinematic_2d: unknown opts_init field {k!r}")
            setattr(oi, k, v)
        if oi.const_p or not oi.th_dry:
            raise NotImplementedError(
                "Kinematic2D: the port drives th_dry with variable pressure "
                "only (ROADMAP.md, Queue 1)")
        self.opts_init = oi
        self.prtcls = factory(backend_t.CUDA, oi, device=self.device,
                              dtype=dtype, engine=engine)
        if isinstance(self.prtcls, particles_dense_t):
            self.prtcls.coal_pairing = coal_pairing
        self.cfg = self.prtcls.cfg

        dev = lambda a: torch.as_tensor(
            a, dtype=dtype, device=self.device).contiguous()
        self.register_buffer("gc_x", dev(gc_x))
        self.register_buffer("gc_z", dev(gc_z))
        self.register_buffer("G", dev(rhod))
        self.register_buffer("rhod", dev(rhod))
        self.register_buffer("C_x", dev(C_x))
        self.register_buffer("C_z", dev(C_z))
        # uniform dry-theta / vapour initial state (icmw8_case1.hpp:166-168)
        th = np.full((nx, nz), float(theta_dry.std2dry(s.th_0, s.rv_0)))
        rv = np.full((nx, nz), s.rv_0)
        self.th, self.rv = dev(th), dev(rv)
        # the float64 host fields, as the JAX model passes them: init_SD
        # scales the multiplicities by this rhod
        self.prtcls.init(th, rv, rhod, Cx=C_x, Cz=C_z)
        self.opts = opts_t()
        # the population in the dense layout and the flat state it stands
        # for (see dense_state)
        self._dense = None
        self.t = 0.0

    # -------------------------------------------------- the stepwise loop
    def advect_scalars(self, *, plain=False):
        """The Eulerian part of one step: MPDATA of th and rv, one field a
        call (kernel A on the card; ``plain``, its plain version)."""
        mp = (self.gc_x, self.gc_z, self.G, self.mpdata_iters, self.fct)
        self.th = mpdata.advect(self.th, *mp, plain=plain)
        self.rv = mpdata.advect(self.rv, *mp, plain=plain)

    def micro_step(self, spinup=False, *, plain=False):
        """The microphysics of one step through the public API, th/rv (and
        rhod) passed as device tensors.  During spin-up coalescence and
        sedimentation are off and RH is capped at 1.01 (set_rain,
        kin_cloud_2d_lgrngn.hpp:121-126)."""
        opts = self.opts
        opts.sedi = opts.coal = not spinup
        opts.RH_max = 1.01 if spinup else 44.0
        th, rv = self.prtcls.step_sync(opts, self.th, self.rv, self.rhod,
                                       plain=plain)
        self.th = th.reshape(self.nx, self.nz)
        self.rv = rv.reshape(self.nx, self.nz)
        self.prtcls.step_async(opts, plain=plain)

    def step(self, spinup=False, *, plain=False):
        """One model step: MPDATA of th/rv, then step_sync and step_async
        (reference icicle.cpp:77 + hook_post_step)."""
        self.advect_scalars(plain=plain)
        self.micro_step(spinup=spinup, plain=plain)
        self.t += self.setup.dt

    def run(self, nt, spinup=0, *, plain=False):
        """``nt`` steps of the stepwise loop, the first ``spinup`` of them
        spin-up steps."""
        for i in range(nt):
            self.step(spinup=i < spinup, plain=plain)

    # ------------------------------------------- the device-resident loops
    def _does_coal(self, spinup):
        return (not spinup) and self.cfg.coal_switch \
            and self.cfg.kernel != kernel_t.undefined.value

    def _flat_step(self, state, th, rv, spinup, plain):
        """One step of the flat engine as a function over (State, th, rv)
        (libcloudphxx_tpu/models/kinematic_2d.py:501-538): MPDATA of th and
        rv, the condensation phase, the transport phase."""
        cfg, dt = self.cfg, self.setup.dt
        mp = (self.gc_x, self.gc_z, self.G, self.mpdata_iters, self.fct)
        th = mpdata.advect(th, *mp, plain=plain)
        rv = mpdata.advect(rv, *mp, plain=plain)
        state = dataclasses.replace(state, th=th.reshape(-1),
                                    rv=rv.reshape(-1))
        state = step_cond_body(cfg, state, dt, 1.01 if spinup else 44.0,
                               plain=plain)
        th = state.th.reshape(self.nx, self.nz)
        rv = state.rv.reshape(self.nx, self.nz)
        switches = (self._does_coal(spinup), True,
                    (not spinup) and cfg.sedi_switch, False)
        params, w_LS = self.prtcls.async_consts()
        state = step_async_body(cfg, cfg.sstp_coal, switches, state, params,
                                w_LS, dt)
        return state, th, rv

    def _dense_step(self, d, spinup, plain):
        """One step of the dense engine: MPDATA of th/rv, then the fused
        microphysics step (lgrngn/dense.step_fused).  During spin-up
        coalescence and sedimentation are off and RH is capped at 1.01."""
        cfg = self.cfg
        th, rv = mpdata.advect2(self.th, self.rv, self.gc_x, self.gc_z,
                                self.G, n_iters=self.mpdata_iters,
                                fct=self.fct, plain=plain)
        d, th, rv = dense.step_fused(
            cfg, d, th.reshape(-1), rv.reshape(-1),
            self.opts_init.kernel_parameters, self.setup.dt,
            1.01 if spinup else 44.0, cfg.sstp_coal, self._does_coal(spinup),
            (not spinup) and cfg.sedi_switch,
            coal_pairing=self.coal_pairing, plain=plain)
        self.th, self.rv = th.reshape(self.nx, self.nz), \
            rv.reshape(self.nx, self.nz)
        return d

    @property
    def dense_state(self):
        """The population in the dense cell-major layout
        (lgrngn/dense.DenseState): the dense front's own copy where that is
        the authoritative one; else the one the last dense run left while
        the flat state is still the one it wrote back; else packed from
        the flat state at the row capacity dense_capacity gives."""
        p = self.prtcls
        if isinstance(p, particles_dense_t) and p._loc == "dense":
            return p._d
        st = p.state
        if self._dense is None or self._dense[1] is not st:
            counts = torch.bincount(st.ijk[st.n > 0],
                                    minlength=self.cfg.n_cell)
            self._dense = (dense.pack(self.cfg, st, dense_capacity(
                int(counts.max()))), st)
        return self._dense[0]

    @dense_state.setter
    def dense_state(self, d):
        """Hand a dense population back to the public API: the dense front
        adopts it, the flat engine gets it written back into its state
        (dense.unpack), so that the diagnostics read it."""
        p = self.prtcls
        if isinstance(p, particles_dense_t):
            p.adopt(d)
            return
        p.state = dense.unpack(self.cfg, d, p.state)
        self._dense = (d, p.state)

    def run_device_lgrngn(self, nt, spinup=0, engine="flat", repack_every=0,
                          repack_margin=1.25, chunk_log=None, *,
                          plain=False):
        """``nt`` model steps, the first ``spinup`` of them spin-up steps,
        with the population on the device throughout
        (libcloudphxx_tpu/models/kinematic_2d.py:721).  engine="flat" runs
        the flat engine's step functions without the public API's
        bookkeeping; engine="dense" runs the fused dense step on the
        population in the dense layout (dense_state) and hands it back,
        raising if a full row dropped SDs.

        ``repack_every`` > 0 turns on the occupancy-aware repack policy of
        long dense runs (the flat engine ignores it, as the JAX package's
        does): the steps run in chunks of that many; after each the
        densest row's occupancy is read, and the population moves to the
        smallest admissible capacity of at least ``repack_margin`` times
        it when the capacity has less than 10% headroom (grow), or when
        that capacity holds 1.5 times the occupancy (shrink).  A chunk
        that dropped SDs is run again from its start at the capacity for
        its initial occupancy plus 16, at most 3 times.  Admissible
        capacities are 8-lane aligned, and on a CUDA device powers of two
        up to ops/coal.MAX_CAP (what kernel E takes); a population that
        needs more raises.  ``chunk_log``, a list, gets a dict a chunk
        (spinup, steps, occ, cap, seconds, redo: the chunk's runs before
        it kept every SD).  ``plain`` runs the plain PyTorch version of
        every kernel (comparisons and timings)."""
        if engine not in ("flat", "dense"):
            raise ValueError(f"run_device_lgrngn: engine must be 'flat' or "
                             f"'dense', got {engine!r}")
        p = self.prtcls
        if engine == "dense":
            d = self._run_dense(self.dense_state, nt, spinup, repack_every,
                                repack_margin, chunk_log, plain)
            dropped = int(d.overflow)
            if dropped:
                raise RuntimeError(
                    f"dense engine: {dropped} SDs dropped on row overflow "
                    f"(capacity {d.cap}); raise cap")
            self.dense_state = d
        else:
            if isinstance(p, particles_dense_t):
                p._ensure_flat()
            state, th, rv = p.state, self.th, self.rv
            for i in range(nt):
                state, th, rv = self._flat_step(state, th, rv, i < spinup,
                                                plain)
            p.state, self.th, self.rv = state, th, rv
        p._should_now_run_cond = False
        p._should_now_run_async = False
        self.t += nt * self.setup.dt

    def _run_dense(self, d, nt, spinup, repack_every, margin, chunk_log,
                   plain):
        """The dense steps of run_device_lgrngn with its repack policy
        (libcloudphxx_tpu/models/kinematic_2d.py:772-846).  Returns the
        final DenseState."""
        def occupancy(d):
            return int((d.n > 0).sum(1).max())

        for n, sp in ((min(spinup, nt), True), (max(0, nt - spinup), False)):
            done = redo = 0
            while done < n:
                t0 = time.perf_counter()
                k = min(repack_every, n - done) if repack_every else n - done
                prev = (d, self.th, self.rv)
                for _ in range(k):
                    d = self._dense_step(d, sp, plain)
                if repack_every and int(d.overflow) > int(prev[0].overflow):
                    # a row outgrew the capacity within the chunk: run it
                    # again from its start at a larger one
                    redo += 1
                    if redo > 3:
                        raise RuntimeError(
                            f"dense engine: row overflow persists after "
                            f"{redo} capacity retargets")
                    d = dense.repack(self.cfg, prev[0], admissible_cap(
                        occupancy(prev[0]) + 16, margin, d.n.device))
                    self.th, self.rv = prev[1:]
                    continue
                done += k
                ahead = (n - done) + (nt - spinup if sp else 0)
                if repack_every and ahead > 0:
                    occ = occupancy(d)
                    new_cap = admissible_cap(occ, margin, d.n.device)
                    if (occ * 1.10 > d.cap and new_cap > d.cap) or (
                            new_cap < d.cap and occ * 1.5 <= new_cap):
                        d = dense.repack(self.cfg, d, new_cap)
                    if chunk_log is not None:
                        chunk_log.append(dict(
                            spinup=sp, steps=k, occ=occ, cap=d.cap,
                            seconds=time.perf_counter() - t0, redo=redo))
                redo = 0
        return d


def admissible_cap(occ, margin, device):
    """The smallest row capacity the dense engine takes for a densest row
    of ``occ`` SDs with ``margin`` applied (libcloudphxx_tpu/models/
    kinematic_2d.py:772-782): 8-lane aligned, and on a CUDA device, where
    the kernels run, a power of two up to ops/coal.MAX_CAP (what kernel E
    takes); past that it raises, with the occupancy in the message."""
    want = max(8, int(-(-int(occ * margin) // 8) * 8))
    if torch.device(device).type == "cuda":
        want = 1 << (want - 1).bit_length()
        if want > MAX_CAP:
            raise RuntimeError(
                f"dense engine: a row holds {occ} SDs, which needs capacity "
                f"{want}; kernel E takes at most {MAX_CAP}")
    return want
