"""The 2-D prescribed-flow kinematic cloud model ("icicle")
(libcloudphxx_tpu/models/kinematic_2d.py).

The GMD-2015 / 8th ICMW case-1 setup (reference
models/kinematic_2D/src/opts_common.hpp:48-66, cases/icmw8_case1.hpp):
MPDATA advection (models/mpdata.py) driving either scheme family, on the
cell-centred grid or on the node-centred one of libmpdata++ (the
reference icicle's, ``grid="node"``):

* ``micro="lgrngn"``: the super-droplet microphysics through the public
  particles_t API (lgrngn/particles.py): the stepwise loop (step, run)
  calls step_sync and step_async, run_device_lgrngn runs the flat
  engine's step functions or the dense cell-major engine
  (lgrngn/dense.py), the latter with the occupancy-aware repack policy of
  long runs;
* ``micro="lgrngn_chem"``: the same with the aqueous chemistry
  (kin_cloud_2d_lgrngn_chem.hpp): six trace gases (``chem_gases``)
  advected beside th and rv and passed to step_sync, in the stepwise loop
  on the flat engine;
* ``micro="blk_1m"`` / ``"blk_2m"``: the bulk schemes (blk_1m/, blk_2m/)
  on the field tensors, all fields advected in one MPDATA launch a step:
  the stepwise loop (step, run) and the device-resident run_device.
"""

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from .. import blk_1m as blk_1m_mod
from .. import blk_2m as blk_2m_mod
from ..common import chem
from ..common import constants as c
from ..common import hydrostatic, theta_dry, theta_std
from ..lgrngn import dense
from ..lgrngn.dense_front import initial_capacity as dense_capacity
from ..lgrngn.dense_front import particles_dense_t
from ..lgrngn.enums import backend_t, kernel_t, vt_t
from ..lgrngn.opts import opts_init_t, opts_t
from ..lgrngn.particles import (factory, step_async_body, step_cond_body,
                                take_coal_overflow)
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
    chem_b: float = 0.55       # blk_2m's aerosol solubility parameter
    # the trace gases' volume mixing ratios and the aerosol's density of
    # lgrngn_chem (reference opts_common.hpp:64-103)
    SO2_g_0: float = 0.2e-9
    O3_g_0: float = 50e-9
    H2O2_g_0: float = 0.5e-9
    CO2_g_0: float = 360e-6
    NH3_g_0: float = 0.1e-9
    HNO3_g_0: float = 0.1e-9
    chem_rho: float = 1.8e3
    # th/rv relaxation (reference opts_common.hpp:65-66, 96-97)
    tau_rlx: float = 300.0
    z_rlx: float = 200.0

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

    def lognormal_lnrd_f32(self, lnr):
        """The reference's log_dry_radii functor in float32
        (icmw8_case1.hpp:63-78 with real_t=float; lognormal::n_e computes
        the exponent in double, as C++ pow(float, int) promotes), with
        glibc's logf: the distribution of reference_rng_init, whose
        multiplicities it gives bit for bit."""
        from ..lgrngn.refinit import logf
        f32 = np.float32
        lnr = np.asarray(lnr, f32)
        out = np.zeros_like(lnr)
        for mean, sdev, n_tot in (
            (self.mean_rd1, self.sdev_rd1, self.n1_stp),
            (self.mean_rd2, self.sdev_rd2, self.n2_stp),
        ):
            lm = logf(f32(mean))[()]
            ls = logf(f32(sdev))[()]
            d = (lnr - lm).astype(np.float64)
            e = f32(np.exp(-(d ** 2) / np.float64(f32(2))
                           / np.float64(ls) ** 2))
            out = f32(out + f32(n_tot) * e / ls
                      / f32(np.sqrt(f32(2) * f32(np.pi))))
        return out


def rhod_profile(setup: Setup, z):
    """Hydrostatic dry-air density at heights ``z`` (a float64 tensor)
    (icmw8_case1.hpp:119-136)."""
    p = hydrostatic.p(z, setup.th_0, setup.rv_0, setup.z_0, setup.p_0)
    return theta_std.rhod(p, setup.th_0, setup.rv_0)


def mixr_helper_profile(setup: Setup, z):
    """Moles of air per kg of dry air at heights ``z`` (a float64 tensor):
    what turns the trace gases' volume mixing ratios into mass mixing
    ratios (icmw8_case1.hpp mixr_helper:139-163)."""
    p = hydrostatic.p(z, setup.th_0, setup.rv_0, setup.z_0, setup.p_0)
    rhod = theta_std.rhod(p, setup.th_0, setup.rv_0)
    T = theta_dry.T(theta_dry.std2dry(setup.th_0, setup.rv_0), rhod)
    return p / c.kaBoNA / T / rhod


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


def make_gc_node(setup: Setup, nx, nz, dx, dz):
    """G-weighted courants on the libmpdata++ node-centred grid
    (icmw8_case1.hpp intcond:174-219): scalar points at (i*dx, j*dz) with
    dx = X/(nx-1); x faces at (c-1/2)*dx (c = 0..nx), z faces at
    (c-1/2)*dz.  psi is differenced over one cell width centred on the
    face.  Returns float64 numpy arrays gc_x (nx+1, nz) and gc_z
    (nx, nz+1)."""
    A = setup.w_max * (nx - 1) * dx / np.pi / 2.0
    psi = lambda xX, zZ: -np.sin(np.pi * zZ) * np.cos(2 * np.pi * xX)

    cx = np.arange(nx + 1)          # x-face index c <-> physical (c-.5)*dx
    j = np.arange(nz)
    gc_x = (
        -A
        * (psi((cx[:, None] - .5) / (nx - 1), (j[None, :] + .5) / (nz - 1))
           - psi((cx[:, None] - .5) / (nx - 1), (j[None, :] - .5) / (nz - 1)))
        / dz * setup.dt / dx
    )
    i = np.arange(nx)
    cz = np.arange(nz + 1)
    gc_z = (
        A
        * (psi((i[:, None] + .5) / (nx - 1), (cz[None, :] - .5) / (nz - 1))
           - psi((i[:, None] - .5) / (nx - 1), (cz[None, :] - .5) / (nz - 1)))
        / dx * setup.dt / dz
    )
    return gc_x, gc_z


# the bulk schemes' fields, in the order run_device carries them
BULK_FIELDS = {"blk_1m": ("th", "rv", "rc", "rr"),
               "blk_2m": ("th", "rv", "rc", "nc", "rr", "nr")}


class Kinematic2D(nn.Module):
    """End-to-end kinematic cloud model (reference
    models/kinematic_2D/src/icicle.cpp + kin_cloud_2d_{lgrngn,blk_1m,
    blk_2m}.hpp).

    Every tensor is made on ``device``: the card unless the caller asks for
    the CPU.  ``dtype`` is the working precision of the fields and the
    population (float32 on the card; the kernels take float32 only).  The
    courant and density fields are buffers; the scalar fields (th and rv,
    and the bulk schemes' rc, rr, nc, nr, each (nx, nz)) are attributes
    that each step replaces.

    ``grid="cell"``: the cell-centred grid (dx = X/nx); ``grid="node"``:
    the libmpdata++ node-centred interpretation the reference icicle uses
    (dx = X/(nx-1), scalar points at j*dz, the SD domain cropped to
    [dx/2, (nx-.5)dx) — kin_cloud_2d_lgrngn.hpp:162-170, icmw8_case1.hpp
    setopts:171-176).  ``fct`` turns on the MPDATA non-oscillatory limiter
    (reference opts::fct, icicle.cpp:85).  ``relax_th_rv`` relaxes th and
    rv toward their horizontal means after the spin-up, in the stepwise
    loop only (kin_cloud_2d_common.hpp:52-117).

    ``reference_rng`` initialises the SDs with the reference's mt19937
    draws and float32 arithmetic (lgrngn/refinit.py; th then takes the
    reference's float32 value); ``kernel_parameters`` are
    opts_init.kernel_parameters (the geometric kernel's multiplier);
    ``opts_init_kw`` sets any other opts_init field last (a const-multi
    population: sd_conc=0 and {"sd_const_multi": ...}).

    For lgrngn the microphysics is the public API (``prtcls``) that
    lgrngn.factory gives for ``engine`` ("auto": the dense front,
    lgrngn/dense_front.py, on a CUDA device, the flat particles_t on the
    CPU; or "dense" or "flat"); run_device_lgrngn runs the same population
    on the flat or the dense engine and hands it back.  The bulk schemes
    build no particles: ``opts`` is their opts_t, and ``puddle_flux`` the
    accumulated surface rain flux (a float).  ``backend`` is
    lgrngn.factory's (multi_CUDA takes the multi-device front where more
    than one card is visible; CUDA where it is None); ``debug`` is the
    public API's NaN sweep after each step phase (particles_t)."""

    def __init__(self, nx=76, nz=76, setup: Setup = None, micro="lgrngn",
                 sd_conc=64, sstp_cond=1, sstp_coal=1, n_sd_max=None,
                 mpdata_iters=2, grid="cell", fct=False, reference_rng=False,
                 kernel_parameters=None, terminal_velocity=None,
                 rng_seed=None, opts_init_kw=None, coal_pairing="stride", *,
                 relax_th_rv=False, engine="auto", device="cuda",
                 dtype=torch.float32, backend=None, debug=False):
        super().__init__()
        if micro not in ("lgrngn", "lgrngn_chem", "blk_1m", "blk_2m"):
            raise ValueError(f"Kinematic2D: unknown micro {micro!r}")
        if grid not in ("cell", "node"):
            raise ValueError(f"Kinematic2D: unknown grid {grid!r}; 'cell' "
                             f"or 'node'")
        self.setup = s = setup or Setup()
        self.nx, self.nz = nx, nz
        self.micro = micro
        self.mpdata_iters = mpdata_iters
        self.fct = fct
        self.coal_pairing = coal_pairing
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Kinematic2D: device 'cuda' asked for, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU")

        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
        if grid == "node":
            self.dx, self.dz = s.X / (nx - 1), s.Z / (nz - 1)
            z_scalar = np.arange(nz) * self.dz      # scalar points at j*dz
            gc_x, gc_z = make_gc_node(s, nx, nz, self.dx, self.dz)
        else:
            self.dx, self.dz = s.X / nx, s.Z / nz
            z_scalar = (np.arange(nz) + 0.5) * self.dz
            gc_x, gc_z = make_gc(s, nx, nz, self.dx, self.dz)
        rhod_col = rhod_profile(s, f64(z_scalar)).numpy()
        rhod = np.broadcast_to(rhod_col, (nx, nz)).copy()
        # plain courants for the SDs: G-weighted ones divided by rhod
        # (kin_cloud_2d_lgrngn.hpp:180-196).  On the node grid the
        # reference divides by rhod at z = j METRES: libmpdata++'s grid
        # step dj, which icicle never sets, stays 1 (the JAX package's
        # kinematic_2d.py:220-238 reproduces that, and so does the port)
        if grid == "node":
            div_x = rhod_profile(s, f64(np.arange(nz, dtype=float))).numpy()
            div_z = rhod_profile(s, f64(np.arange(nz + 1) - 0.5)).numpy()
        else:
            div_x = rhod_col
            div_z = rhod_profile(s, f64(np.arange(nz + 1) * self.dz)).numpy()
        C_x = gc_x / div_x[None, :]
        C_z = gc_z / div_z[None, :]

        dev = lambda a: torch.as_tensor(
            a, dtype=dtype, device=self.device).contiguous()
        self.register_buffer("gc_x", dev(gc_x))
        self.register_buffer("gc_z", dev(gc_z))
        self.register_buffer("G", dev(rhod))
        self.register_buffer("rhod", dev(rhod))
        self.register_buffer("C_x", dev(C_x))
        self.register_buffer("C_z", dev(C_z))
        # uniform dry-theta / vapour initial state (icmw8_case1.hpp:166-168)
        if reference_rng:
            # the reference's real_t=float value (289.99197 in the fig_a
            # refdata)
            f = np.float32
            th_d = float(f(s.th_0) * np.power(
                f(1) + f(s.rv_0) * f(c.R_v) / f(c.R_d), f(c.R_d) / f(c.c_pd),
                dtype=f))
        else:
            th_d = float(theta_dry.std2dry(s.th_0, s.rv_0))
        th = np.full((nx, nz), th_d)
        rv = np.full((nx, nz), s.rv_0)
        self.th, self.rv = dev(th), dev(rv)
        self.t = 0.0
        self.puddle_flux = 0.0
        self.chem_gases = None
        # th/rv relaxation toward the post-spinup horizontal means
        # (kin_cloud_2d_common.hpp:61-77, update_rhs:90-117)
        self.relax_th_rv = relax_th_rv
        self._th_eq = self._rv_eq = None
        self._tau_rlx = dev(s.tau_rlx * np.exp(z_scalar / s.z_rlx))

        if micro == "blk_1m":
            self.opts = blk_1m_mod.opts_t()
        elif micro == "blk_2m":
            self.opts = blk_2m_mod.opts_t(dry_distros=tuple(
                blk_2m_mod.lognormal_mode_t(mean, sdev, n, s.chem_b)
                for mean, sdev, n in ((s.mean_rd1, s.sdev_rd1, s.n1_stp),
                                      (s.mean_rd2, s.sdev_rd2, s.n2_stp))))
        if micro in BULK_FIELDS:
            for k in BULK_FIELDS[micro][2:]:
                setattr(self, k, torch.zeros_like(self.th))
            return

        oi = opts_init_t()
        oi.dry_distros = {(s.kappa, 0.0): s.lognormal_lnrd_f32
                          if reference_rng else s.lognormal_lnrd}
        oi.nx, oi.nz = nx, nz
        oi.dx, oi.dz = self.dx, self.dz
        if grid == "node":
            # libmpdata grid interpretation: half-cell crop on each side
            # (kin_cloud_2d_lgrngn.hpp:167-170)
            oi.x0, oi.z0 = self.dx / 2, self.dz / 2
            oi.x1, oi.z1 = (nx - 0.5) * self.dx, (nz - 0.5) * self.dz
        else:
            oi.x1, oi.z1 = s.X, s.Z
        oi.dt = s.dt
        oi.sd_conc = sd_conc
        oi.n_sd_max = n_sd_max or 2 * sd_conc * nx * nz
        oi.sstp_cond = sstp_cond
        oi.sstp_coal = sstp_coal
        oi.reference_rng_init = reference_rng
        if rng_seed is not None:
            oi.rng_seed = rng_seed
        oi.kernel = kernel_t.geometric
        oi.kernel_parameters = list(kernel_parameters or [])
        oi.terminal_velocity = (terminal_velocity
                                if terminal_velocity is not None
                                else vt_t.beard77fast)
        for k, v in (opts_init_kw or {}).items():
            if not hasattr(oi, k):
                raise ValueError(
                    f"kinematic_2d: unknown opts_init field {k!r}")
            setattr(oi, k, v)
        if oi.const_p or not oi.th_dry:
            # the JAX model cannot run it either: its init passes no
            # pressure profile, and particles_t.init raises "lgrngn: const_p
            # requires a pressure profile" (the public API takes th_std and
            # const_p on both engines)
            raise NotImplementedError(
                "Kinematic2D: the model drives th_dry with variable pressure "
                "only, as the JAX package's (ROADMAP.md, \"Known behaviours "
                "of the reference\")")
        gases = None
        if micro == "lgrngn_chem":
            # the trace gases from their volume mixing ratios
            # (kin_cloud_2d_lgrngn_chem.hpp hook_ante_loop:101-128)
            oi.chem_switch = True
            oi.chem_rho = s.chem_rho
            mixr = mixr_helper_profile(s, f64(z_scalar)).numpy()
            cs = chem.chem_species_t
            gases = {sp: np.broadcast_to(mixr * v * m, (nx, nz)).copy()
                     for sp, v, m in (
                         (cs.SO2, s.SO2_g_0, chem.M_SO2),
                         (cs.O3, s.O3_g_0, chem.M_O3),
                         (cs.H2O2, s.H2O2_g_0, chem.M_H2O2),
                         (cs.CO2, s.CO2_g_0, chem.M_CO2),
                         (cs.NH3, s.NH3_g_0, chem.M_NH3),
                         (cs.HNO3, s.HNO3_g_0, chem.M_HNO3))}
        self.opts_init = oi
        self.prtcls = factory(backend or backend_t.CUDA, oi,
                              device=self.device, dtype=dtype,
                              engine=engine, debug=debug)
        if isinstance(self.prtcls, particles_dense_t):
            self.prtcls.coal_pairing = coal_pairing
        self.cfg = self.prtcls.cfg
        # the float64 host fields, as the JAX model passes them: init_SD
        # scales the multiplicities by this rhod
        self.prtcls.init(th, rv, rhod, Cx=C_x, Cz=C_z, ambient_chem=gases)
        self.opts = opts_t()
        if gases is not None:
            # the gases as the model's fields, (nx, nz) tensors in the
            # species order of the JAX model's dict
            self.chem_gases = {sp: dev(v) for sp, v in gases.items()}
            self.opts.chem_dsl = self.opts.chem_dsc = True
            self.opts.chem_rct = True
        # the population in the dense layout and the flat state it stands
        # for (see dense_state)
        self._dense = None

    # -------------------------------------------------- the stepwise loop
    def advect_scalars(self, *, plain=False):
        """The Eulerian part of one step: MPDATA of th and rv, and of the
        six trace gases for lgrngn_chem, one field a call (kernel A on the
        card; ``plain``, its plain version)."""
        mp = (self.gc_x, self.gc_z, self.G, self.mpdata_iters, self.fct)
        self.th = mpdata.advect(self.th, *mp, plain=plain)
        self.rv = mpdata.advect(self.rv, *mp, plain=plain)
        if self.chem_gases is not None:
            for sp, v in self.chem_gases.items():
                self.chem_gases[sp] = mpdata.advect(v, *mp, plain=plain)

    def micro_step(self, spinup=False, *, plain=False):
        """The microphysics of one step through the public API, th/rv (and
        rhod, and for lgrngn_chem the trace gases) passed as device
        tensors.  During spin-up coalescence and sedimentation are off and
        RH is capped at 1.01 (set_rain, kin_cloud_2d_lgrngn.hpp:121-126),
        and lgrngn_chem oxidises nothing."""
        opts = self.opts
        opts.sedi = opts.coal = not spinup
        opts.RH_max = 1.01 if spinup else 44.0
        gases = self.chem_gases
        if gases is not None:
            # no oxidation in the spin-up (set_chem,
            # kin_cloud_2d_lgrngn_chem.hpp:89-99)
            opts.chem_rct = not spinup
        th, rv = self.prtcls.step_sync(opts, self.th, self.rv, self.rhod,
                                       ambient_chem=gases, plain=plain)
        self.th = th.reshape(self.nx, self.nz)
        self.rv = rv.reshape(self.nx, self.nz)
        if gases is not None:
            amb = self.prtcls._cells("ambient_chem")
            for sp in gases:
                gases[sp] = amb[int(sp)].reshape(self.nx, self.nz)
        self.prtcls.step_async(opts, plain=plain)

    def _relax_hooks(self, spinup):
        """hook_ante_step: capture the relaxation goals at the end of the
        spin-up; returns whether the relaxation applies this step
        (kin_cloud_2d_common.hpp:52-77)."""
        if not self.relax_th_rv:
            return False
        if not spinup and self._th_eq is None:
            self._th_eq = self.th.mean(0)
            self._rv_eq = self.rv.mean(0)
        return self._th_eq is not None and not spinup

    def _apply_relax(self):
        """Per-cell relaxation toward the saved horizontal means, tau
        growing exponentially with altitude (update_rhs:90-117)."""
        dt, tau = self.setup.dt, self._tau_rlx
        self.th = self.th + dt * (self._th_eq - self.th) / tau
        self.rv = self.rv + dt * (self._rv_eq - self.rv) / tau

    def step(self, spinup=False, *, plain=False):
        """One model step: MPDATA advection of the scalar fields, the
        relaxation where it applies, then the microphysics (reference
        icicle.cpp:77 + hook_post_step).  A bulk step adds its surface
        rain flux into ``puddle_flux`` on the host, as the JAX package's
        step does."""
        do_relax = self._relax_hooks(spinup)
        if self.micro in ("lgrngn", "lgrngn_chem"):
            self.advect_scalars(plain=plain)
            if do_relax:
                # reference order: mpdata_rhs applies the relaxation before
                # the microphysics hook (hook_post_step parent call)
                self._apply_relax()
            self.micro_step(spinup=spinup, plain=plain)
        else:
            names = BULK_FIELDS[self.micro]
            fields = self._blk_advect(
                tuple(getattr(self, k) for k in names), plain)
            for k, v in zip(names, fields):
                setattr(self, k, v)
            if do_relax:
                self._apply_relax()
            fields, flux = self._blk_micro(
                tuple(getattr(self, k) for k in names), spinup)
            self.puddle_flux += float(flux.sum()) * self.setup.dt
            for k, v in zip(names, fields):
                setattr(self, k, v)
        self.t += self.setup.dt

    def run(self, nt, spinup=0, *, plain=False):
        """``nt`` steps of the stepwise loop, the first ``spinup`` of them
        spin-up steps."""
        for i in range(nt):
            self.step(spinup=i < spinup, plain=plain)

    def ante_loop(self):
        """blk_1m deals with initial supersaturation by one saturation
        adjustment before the time loop (kin_cloud_2d_blk_1m.hpp
        hook_ante_loop:49-58 condevap); the other schemes do nothing."""
        if self.micro != "blk_1m":
            return
        self.th, self.rv, self.rc, self.rr = blk_1m_mod.adj_cellwise(
            self.opts, self.rhod, torch.zeros_like(self.th), self.th,
            self.rv, self.rc, self.rr, self.setup.dt)

    # ------------------------------------------------ the bulk schemes
    def _blk_advect(self, fields, plain):
        """MPDATA of all the bulk fields in one kernel A launch."""
        return mpdata.advect_n(fields, self.gc_x, self.gc_z, self.G,
                               self.mpdata_iters, self.fct, plain=plain)

    def _blk_micro(self, fields, spinup):
        """The bulk microphysics of one step on the advected fields
        (libcloudphxx_tpu/models/kinematic_2d.py:875-928): blk_1m's
        saturation adjustment, its cellwise and columnwise rhs; blk_2m's
        cellwise and columnwise rhs; the rhs applied unclamped, like
        libmpdata++'s euler_b psi += dt*rhs.  During the spin-up
        autoconversion is off, and for blk_2m activation is capped at RH
        1.01 (set_rain, kin_cloud_2d_blk_1m.hpp:46-47,
        kin_cloud_2d_blk_2m.hpp:96-101).  Returns (the fields, the
        surface rain flux of each column)."""
        dt, dz, rhod, o = self.setup.dt, self.dz, self.rhod, self.opts
        if self.micro == "blk_1m":
            if spinup:
                o = dataclasses.replace(o, conv=False)
            th, rv, rc, rr = fields
            pz = torch.zeros_like(th)
            th, rv, rc, rr = blk_1m_mod.adj_cellwise(o, rhod, pz, th, rv, rc,
                                                     rr, dt)
            zero = torch.zeros_like(th)
            if o.adj_nwtrph:
                dth, drv, drc, drr = blk_1m_mod.rhs_cellwise_revap(
                    o, zero, zero, zero, zero, rhod, pz, th, rv, rc, rr, dt)
            else:
                dth, drv = zero, zero
                drc, drr = blk_1m_mod.rhs_cellwise(o, zero, zero, rc, rr)
            drr, flux = blk_1m_mod.rhs_columnwise(o, drr, rhod, rr, dz)
            return (th + dt * dth, rv + dt * drv, rc + dt * drc,
                    rr + dt * drr), flux
        o = dataclasses.replace(o, acnv=o.acnv and not spinup,
                                RH_max=1.01 if spinup else 44.0)
        th, rv, rc, nc, rr, nr = fields
        zero = torch.zeros_like(th)
        dth, drv, drc, dnc, drr, dnr = blk_2m_mod.rhs_cellwise(
            o, zero, zero, zero, zero, zero, zero,
            rhod, th, rv, rc, nc, rr, nr, dt)
        drr, dnr, flux = blk_2m_mod.rhs_columnwise(o, drr, dnr, rhod, rr, nr,
                                                   dt, dz)
        return (th + dt * dth, rv + dt * drv, rc + dt * drc, nc + dt * dnc,
                rr + dt * drr, nr + dt * dnr), flux

    def run_device(self, nt, spinup=0, *, plain=False):
        """``nt`` bulk steps, the first ``spinup`` of them spin-up steps,
        with no host transfer between steps
        (libcloudphxx_tpu/models/kinematic_2d.py:932): the surface rain
        flux adds up in a device scalar of the fields' dtype, read into
        ``puddle_flux`` at the end.  ``plain`` runs the plain version of
        kernel A (comparisons and timings)."""
        if self.micro not in BULK_FIELDS:
            raise ValueError(f"run_device: unsupported micro {self.micro}; "
                             f"lgrngn runs run_device_lgrngn")
        if self.relax_th_rv:
            raise NotImplementedError(
                "relax_th_rv is only supported in the stepwise run() path")
        names = BULK_FIELDS[self.micro]
        fields = tuple(getattr(self, k) for k in names)
        pf = torch.full((), self.puddle_flux, dtype=self.dtype,
                        device=self.device)
        dt = self.setup.dt
        for i in range(nt):
            fields, flux = self._blk_micro(self._blk_advect(fields, plain),
                                           i < spinup)
            pf = pf + flux.sum() * dt
        for k, v in zip(names, fields):
            setattr(self, k, v)
        self.puddle_flux = float(pf)
        self.t += nt * dt

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
        state = step_async_body(cfg, self._sstp_coal(), switches, state,
                                params, w_LS, dt)
        state = dataclasses.replace(
            state, puddle=self._consume_overflow(state.puddle, spinup))
        return state, th, rv

    def _sstp_coal(self):
        """The coalescence substeps of a step: opts_init's and the growth
        that a const-multi population's collisions asked for."""
        return self.cfg.sstp_coal + self.prtcls._sstp_coal_extra

    def _consume_overflow(self, puddle, spinup):
        """After a coalescing step of a const-multi population, its request
        for one more substep (take_coal_overflow, one host read) grows
        sstp_coal for the steps after it, as the public API's step_async
        does; the JAX package's run_device_lgrngn keeps sstp_coal fixed.
        Returns the puddle, the flag cleared."""
        if not (self._does_coal(spinup) and self.cfg.pure_const_multi):
            return puddle
        grew, puddle = take_coal_overflow(puddle)
        self.prtcls._sstp_coal_extra += int(grew)
        return puddle

    def _mp(self):
        """Kernel A's arguments after the fields: (gc_x, gc_z, G, n_iters,
        fct)."""
        return self.gc_x, self.gc_z, self.G, self.mpdata_iters, self.fct

    def _advect(self, plain):
        """MPDATA of th and rv (kernel A, one launch)."""
        gc_x, gc_z, G, n_iters, fct = self._mp()
        return mpdata.advect2(self.th, self.rv, gc_x, gc_z, G,
                              n_iters=n_iters, fct=fct, plain=plain)

    def _dense_step(self, d, spinup, plain, defer=False, adv=None):
        """One step of the dense engine: MPDATA of th/rv, then the fused
        microphysics step (lgrngn/dense.step_fused; in exact mode the
        per-particle substepping first, its private planes riding the
        re-binning).  During spin-up coalescence and sedimentation are off
        and RH is capped at 1.01.  ``defer`` defers the step's re-binning
        (step_fused's).  With ``adv``, the th and rv that the previous step
        advected, the step takes them and advects its own th and rv for the
        next step (step_fused's mp: kernel D's MPDATA epilogue, the JAX
        package's 5-carry, models/kinematic_2d.py:586-607).  Returns (d,
        the advected pair or None)."""
        cfg = self.cfg
        th, rv = self._advect(plain) if adv is None else adv
        d, th, rv, *adv = dense.step_fused(
            cfg, d, th.reshape(-1), rv.reshape(-1),
            self.opts_init.kernel_parameters, self.setup.dt,
            1.01 if spinup else 44.0, self._sstp_coal(),
            self._does_coal(spinup), (not spinup) and cfg.sedi_switch,
            None if adv is None else self._mp(),
            coal_pairing=self.coal_pairing, defer=defer, plain=plain)
        d = dataclasses.replace(d, puddle=self._consume_overflow(d.puddle,
                                                                 spinup))
        self.th, self.rv = th.reshape(self.nx, self.nz), \
            rv.reshape(self.nx, self.nz)
        return d, tuple(adv) or None

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
                          defer_x=False, mpdata_fuse=False, plain=False):
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
        up to ops/coal.MAX_CAP (what kernel E takes; exact mode too, where
        the JAX package's XLA coalescence takes any capacity); a
        population that needs more raises.  The repacks carry the exact
        mode's private planes (dense.repack).  ``chunk_log``, a list, gets a dict a chunk
        (spinup, steps, occ, cap, seconds, redo: the chunk's runs before
        it kept every SD).  ``plain`` runs the plain PyTorch version of
        every kernel (comparisons and timings).  On a const-multi
        population a step whose coalescence asked for more than one
        collision in a pair grows sstp_coal by one for the steps after it,
        on either engine, as the public API's step_async does (one host
        read a coalescing step; the count is the public API's, so run()
        and run_device_lgrngn share it).

        The dense engine's two switches of the JAX package (which reads them
        from its environment; the port reads none): ``defer_x``
        (LIBCLOUD_DEFER_X) defers each step's re-binning into the next
        step's first launch where dense.defer_ok (step_fused's defer; the
        run flushes the pending merge at its end and before the repack
        policy reads the occupancy or the overflow), and ``mpdata_fuse``
        (LIBCLOUD_MPDATA_FUSE) advects th and rv for the next step in the
        step's launch of kernel D (step_fused's mp; the first step of each
        chunk advects with kernel A).  Both leave the results bitwise as
        they are without them."""
        if engine not in ("flat", "dense"):
            raise ValueError(f"run_device_lgrngn: engine must be 'flat' or "
                             f"'dense', got {engine!r}")
        if self.micro == "lgrngn_chem":
            raise NotImplementedError(
                "run_device_lgrngn: lgrngn_chem runs in the stepwise loop "
                "(run)")
        if self.micro != "lgrngn":
            raise ValueError(f"run_device_lgrngn: micro is {self.micro!r}; "
                             f"the bulk schemes run run_device")
        if self.relax_th_rv:
            raise NotImplementedError(
                "relax_th_rv is only supported in the stepwise run() path")
        p = self.prtcls
        if isinstance(p.state, list):
            # the JAX package's run_device_lgrngn steps the multi-device
            # front's sharded state with the global config, which does not
            # reproduce its serial run (ROADMAP.md, "Known behaviours of
            # the reference")
            raise NotImplementedError(
                "run_device_lgrngn: the multi-device front (dev_count > 1) "
                "steps through run()")
        if engine == "dense":
            d = self._run_dense(self.dense_state, nt, spinup, repack_every,
                                repack_margin, chunk_log, plain, defer_x,
                                mpdata_fuse)
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
                   plain, defer_x=False, mpdata_fuse=False):
        """The dense steps of run_device_lgrngn with its repack policy
        (libcloudphxx_tpu/models/kinematic_2d.py:772-846) and its switches.
        Returns the final DenseState, its merge run."""
        def occupancy(d):
            return int((d.n > 0).sum(1).max())

        for n, sp in ((min(spinup, nt), True), (max(0, nt - spinup), False)):
            done = redo = 0
            while done < n:
                t0 = time.perf_counter()
                k = min(repack_every, n - done) if repack_every else n - done
                prev = (d, self.th, self.rv)
                # the chunk's prologue: kernel A advects its first step's
                # th and rv (the JAX runner's, kinematic_2d.py:626-631)
                adv = self._advect(plain) if mpdata_fuse else None
                for _ in range(k):
                    d, adv = self._dense_step(d, sp, plain, defer_x, adv)
                if repack_every:
                    # the policy reads the rows and the overflow merged
                    d = dense.flush_merge(self.cfg, d, plain=plain)
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
        return dense.flush_merge(self.cfg, d, plain=plain)

    # ------------------------------------------------------- diagnostics
    def diag_lgrngn(self, what="rc"):
        """Cloud ("rc", wet radii 0.5-25 um) or rain ("rr", above 25 um)
        water mixing ratio from the SDs' wet third moment, or the SD count
        a cell ("sd_conc"), as (nx, nz) float64 numpy arrays, through the
        public API's diagnostics (kin_cloud_2d_lgrngn.hpp:33-95)."""
        p = self.prtcls
        if what == "rc":
            p.diag_wet_rng(0.5e-6, 25e-6)
        elif what == "rr":
            p.diag_wet_rng(25e-6, 1.0)
        elif what == "sd_conc":
            p.diag_all()
            p.diag_sd_conc()
            return p.outbuf().reshape(self.nx, self.nz)
        else:
            raise ValueError(what)
        p.diag_wet_mom(3)
        mom3 = p.outbuf().reshape(self.nx, self.nz)
        return 4.0 / 3 * np.pi * c.rho_w * mom3


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
