"""The 2-D prescribed-flow kinematic cloud model ("icicle") with the
Lagrangian microphysics (libcloudphxx_tpu/models/kinematic_2d.py).

The GMD-2015 / 8th ICMW case-1 setup (reference
models/kinematic_2D/src/opts_common.hpp:48-66, cases/icmw8_case1.hpp):
MPDATA advection of th/rv (models/mpdata.py) and the super-droplet
microphysics on the dense cell-major layout (lgrngn/dense.py), on the
cell-centred grid.  The port runs the lgrngn scheme only.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from ..common import hydrostatic, theta_dry, theta_std
from ..lgrngn import dense, init
from ..lgrngn.enums import kernel_t, vt_t
from ..lgrngn.hskpng import hskpng_Tpr
from ..lgrngn.opts import opts_init_t
from ..lgrngn.state import StaticConfig
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

    ``device`` is required: every tensor is made there.  ``dtype`` is the
    working precision of the fields and the population (float32 on the
    card; the kernels take float32 only).  The courant and density fields
    are buffers; th, rv (nx, nz) and the population ``state``
    (lgrngn/dense.DenseState) are attributes that each run replaces."""

    def __init__(self, nx=76, nz=76, setup: Setup = None, micro="lgrngn",
                 sd_conc=64, sstp_cond=1, sstp_coal=1, n_sd_max=None,
                 mpdata_iters=2, grid="cell", fct=False,
                 terminal_velocity=None,
                 rng_seed=None, opts_init_kw=None, coal_pairing="stride", *,
                 device, dtype=torch.float32):
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

        dev = lambda a: torch.as_tensor(
            a, dtype=dtype, device=self.device).contiguous()
        self.register_buffer("gc_x", dev(gc_x))
        self.register_buffer("gc_z", dev(gc_z))
        self.register_buffer("G", dev(rhod))
        self.register_buffer("rhod", dev(rhod))
        self.register_buffer("C_x", dev(C_x))
        self.register_buffer("C_z", dev(C_z))
        # uniform dry-theta / vapour initial state (icmw8_case1.hpp:166-168)
        self.th = dev(np.full((nx, nz), float(theta_dry.std2dry(s.th_0, s.rv_0))))
        self.rv = dev(np.full((nx, nz), s.rv_0))

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
        oi.terminal_velocity = terminal_velocity or vt_t.beard77fast
        for k, v in (opts_init_kw or {}).items():
            if not hasattr(oi, k):
                raise ValueError(f"kinematic_2d: unknown opts_init field {k!r}")
            setattr(oi, k, v)
        self.opts_init = oi
        self.cfg = StaticConfig.from_opts_init(oi)
        self.state = self._init_lgrngn(rhod)
        self.t = 0.0

    def _init_lgrngn(self, rhod_host):
        """The lgrngn init sequence (particles.py:358-430): cell closure,
        SD creation from the seeded numpy generator, equilibrium wet radii,
        sstp_save; then the pack into the dense layout."""
        cfg, oi = self.cfg, self.opts_init
        if cfg.const_p or not cfg.th_dry:
            raise NotImplementedError(
                "Kinematic2D: the port drives th_dry with variable pressure "
                "only (ROADMAP.md, Queue 1)")
        dev = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        th, rv = self.th.reshape(-1), self.rv.reshape(-1)
        rhod = self.rhod.reshape(-1)
        T, p, RH, eta = hskpng_Tpr(cfg, th, rv, rhod, torch.zeros_like(rhod))

        seed = oi.rng_seed_init if oi.rng_seed_init_switch else oi.rng_seed
        pop = init.init_SD(cfg, oi, np.random.default_rng(seed),
                           rhod_host.reshape(-1))
        sd = {k: dev(pop[k]) for k in ("n", "rd3", "kpa", "x", "z")}
        sd["ijk"] = torch.as_tensor(pop["ijk"], device=self.device)
        rw2 = init.init_wet(sd["rd3"], sd["kpa"], RH[sd["ijk"]],
                            T[sd["ijk"]], oi.RH_max)
        sd["rw2"] = torch.where(sd["n"] > 0, rw2, 0.0)
        sd["vt"] = torch.zeros_like(rw2)
        cells = dict(rhod=rhod, p=p, T=T, RH=RH, eta=eta,
                     dv=dev(init.cell_dv(cfg)),
                     sstp_tmp_th=th, sstp_tmp_rv=rv,  # sstp_save
                     courant_x=self.C_x.reshape(-1),
                     courant_z=self.C_z.reshape(-1))
        counts = np.bincount(pop["ijk"][pop["n"] > 0], minlength=cfg.n_cell)
        return dense.pack(cfg, sd, cells, dense_capacity(counts.max()),
                          rng_seed=oi.rng_seed)

    def _step(self, spinup, plain):
        """One model step: MPDATA of th/rv, then the microphysics step.
        During spin-up coalescence and sedimentation are off and RH is
        capped at 1.01 (set_rain, kin_cloud_2d_lgrngn.hpp:121-126)."""
        cfg = self.cfg
        th, rv = mpdata.advect2(self.th, self.rv, self.gc_x, self.gc_z,
                                self.G, n_iters=self.mpdata_iters,
                                fct=self.fct, plain=plain)
        self.state, th, rv = dense.step_fused(
            cfg, self.state, th.reshape(-1), rv.reshape(-1),
            self.opts_init.kernel_parameters, self.setup.dt,
            1.01 if spinup else 44.0, cfg.sstp_coal, self._does_coal(spinup),
            (not spinup) and cfg.sedi_switch,
            coal_pairing=self.coal_pairing, plain=plain)
        self.th, self.rv = th.reshape(self.nx, self.nz), \
            rv.reshape(self.nx, self.nz)

    def _does_coal(self, spinup):
        return (not spinup) and self.cfg.coal_switch \
            and self.cfg.kernel != kernel_t.undefined.value

    def run_device_lgrngn(self, nt, spinup=0, engine="dense", repack_every=0,
                          *, plain=False):
        """``nt`` model steps, the first ``spinup`` of them spin-up steps,
        on the dense engine, with the population on the device throughout.
        ``plain`` runs the plain PyTorch version of every kernel (kernel
        timings and comparisons).  Raises on SDs dropped at a full row."""
        if engine != "dense":
            raise NotImplementedError(
                f"run_device_lgrngn: engine={engine!r} is not ported; only "
                "'dense' (ROADMAP.md, Queue 1)")
        if repack_every:
            raise NotImplementedError(
                "run_device_lgrngn: the repack policy is not ported "
                "(ROADMAP.md, Queue 1)")
        for i in range(nt):
            self._step(i < spinup, plain)
        dropped = int(self.state.overflow)
        if dropped:
            raise RuntimeError(
                f"dense engine: {dropped} SDs dropped on row overflow "
                f"(capacity {self.state.cap}); raise cap")
        self.t += nt * self.setup.dt


def dense_capacity(max_count):
    """Row capacity: twice the densest initial cell, rounded up to 8 lanes
    and then to a power of two (128 at the GMD case's 64 SDs a cell)."""
    cap = max(8, int(-(-2 * int(max_count) // 8) * 8))
    return 1 << (cap - 1).bit_length()
