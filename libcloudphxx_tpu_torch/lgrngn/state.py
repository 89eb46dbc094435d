"""The static run configuration, the flat engine's state and the puddle
slots (libcloudphxx_tpu/lgrngn/state.py: StaticConfig, State, empty_state,
PUDDLE_KEYS, OUT_*).

The flat ``State`` holds the engine on any grid (the parcel, 1-D, 2-D
and 3-D): per-SD arrays of length n_sd_max, where multiplicity n == 0
marks a dead slot (the SGS turbulence's velocity and supersaturation
perturbations, the in-cloud time and the ice attributes among them, zero
unless their switches are on; the insoluble core's radius always), the
per-cell Eulerian mirrors with the dissipation rate, and the aqueous
chemistry's rows (zero-width when chem_switch is off).  Its random stream is the run's seed and a step counter
(the coalescence draws are Philox numbers, ops/philox.py), so restoring a
state restores its draws.  The dense engine keeps the same population in
its cell-major layout (lgrngn/dense.DenseState).
"""

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class StaticConfig:
    """Snapshot of the opts_init fields that shape a run (grid geometry,
    substep counts, formula selections).  Same fields as the JAX package's
    StaticConfig, so convert.static_config_from_numpy can carry one over."""

    n_dims: int
    nx: int
    ny: int
    nz: int
    n_cell: int
    n_sd_max: int
    dx: float
    dy: float
    dz: float
    x0: float
    x1: float
    y0: float
    y1: float
    z0: float
    z1: float
    dt: float
    sstp_cond: int
    sstp_coal: int
    th_dry: bool
    const_p: bool
    RH_formula: int
    adve_scheme: int
    terminal_velocity: int
    kernel: int
    exact_sstp_cond: bool
    variable_dt: bool
    sedi_switch: bool
    coal_switch: bool
    turb_cond_switch: bool
    open_side_walls: bool
    periodic_topbot_walls: bool
    diag_incloud_time: bool = False
    rc2_T: float = 10.0
    ice_switch: bool = False
    time_dep_ice_nucl: bool = False
    chem_switch: bool = False
    sstp_chem: int = 1
    chem_rho: float = 0.0
    adaptive_sstp_cond: bool = False
    sstp_cond_act: int = 1
    sstp_cond_adapt_drw2_eps: float = 1e-4
    sstp_cond_adapt_drw2_max: float = 4.0
    sstp_cond_mix: bool = True
    pure_const_multi: bool = False

    @classmethod
    def from_opts_init(cls, oi):
        return cls(
            n_dims=oi.n_dims,
            nx=max(1, oi.nx), ny=max(1, oi.ny), nz=max(1, oi.nz),
            n_cell=oi.n_cell,
            n_sd_max=int(oi.n_sd_max),
            dx=float(oi.dx), dy=float(oi.dy), dz=float(oi.dz),
            x0=float(oi.x0), x1=float(oi.x1),
            y0=float(oi.y0), y1=float(oi.y1),
            z0=float(oi.z0), z1=float(oi.z1),
            dt=float(oi.dt),
            sstp_cond=int(oi.sstp_cond),
            sstp_coal=int(oi.sstp_coal),
            th_dry=bool(oi.th_dry),
            const_p=bool(oi.const_p),
            RH_formula=oi.RH_formula.value,
            adve_scheme=oi.adve_scheme.value,
            terminal_velocity=oi.terminal_velocity.value,
            kernel=oi.kernel.value,
            exact_sstp_cond=bool(oi.exact_sstp_cond),
            variable_dt=bool(oi.variable_dt_switch),
            sedi_switch=bool(oi.sedi_switch),
            coal_switch=bool(oi.coal_switch),
            turb_cond_switch=bool(oi.turb_cond_switch),
            open_side_walls=bool(oi.open_side_walls),
            periodic_topbot_walls=bool(oi.periodic_topbot_walls),
            diag_incloud_time=bool(oi.diag_incloud_time),
            rc2_T=float(oi.rc2_T),
            ice_switch=bool(oi.ice_switch),
            time_dep_ice_nucl=bool(oi.time_dep_ice_nucl),
            chem_switch=bool(oi.chem_switch),
            sstp_chem=int(oi.sstp_chem),
            chem_rho=float(oi.chem_rho),
            adaptive_sstp_cond=bool(oi.adaptive_sstp_cond),
            sstp_cond_act=int(oi.sstp_cond_act),
            sstp_cond_adapt_drw2_eps=float(oi.sstp_cond_adapt_drw2_eps),
            sstp_cond_adapt_drw2_max=float(oi.sstp_cond_adapt_drw2_max),
            sstp_cond_mix=bool(oi.sstp_cond_mix),
            pure_const_multi=bool(
                oi.sd_conc == 0
                and (oi.sd_const_multi > 0 or len(oi.dry_sizes) > 0)),
        )


def _empty():
    return torch.zeros(0)


@dataclass
class State:
    """The flat engine's state (reference src/impl/particles_impl.ipp:
    66-146): per-SD arrays (n_sd_max,), cell arrays (n_cell,)
    ravelled i outermost and k innermost ((i*ny + j)*nz + k), the
    staggered courants of the grid's axes ((nx+1)*ny*nz, nx*(ny+1)*nz,
    nx*ny*(nz+1); empty for an axis the grid lacks).  In a parcel (no
    axis) the one cell holds 1 kg of dry air: dv is 1/rhod.  Every step
    returns a new State; none is updated in place."""

    # per-SD attributes
    n: torch.Tensor       # multiplicity; 0 == dead slot
    rd3: torch.Tensor     # dry radius cubed [m3]
    rw2: torch.Tensor     # wet radius squared [m2]
    kpa: torch.Tensor     # kappa hygroscopicity
    x: torch.Tensor
    z: torch.Tensor
    vt: torch.Tensor      # terminal velocity [m/s]
    ijk: torch.Tensor     # int64 cell index (i*ny + j)*nz + k; dead: 0
    # Eulerian mirrors
    th: torch.Tensor
    rv: torch.Tensor
    rhod: torch.Tensor
    p: torch.Tensor
    courant_x: torch.Tensor
    courant_z: torch.Tensor
    # diagnosed cell fields
    T: torch.Tensor
    RH: torch.Tensor
    eta: torch.Tensor
    dv: torch.Tensor      # cell volume [m3]
    # condensation substepping snapshot (sstp_save): per cell (n_cell,),
    # or per SD (n_sd_max,) in exact_sstp_cond mode, where sstp_tmp_p is
    # per SD too (and empty otherwise; sstp_save.ipp:13-34)
    sstp_tmp_th: torch.Tensor
    sstp_tmp_rv: torch.Tensor
    sstp_tmp_rh: torch.Tensor
    sstp_tmp_p: torch.Tensor
    puddle: torch.Tensor  # (N_PUDDLE,), slots as PUDDLE_KEYS
    # the LES slice's per-SD attributes: the time spent activated [s], the
    # SGS velocity perturbations, the supersaturation perturbation and its
    # tendency (particles_impl.ipp:80-84); and per cell the TKE
    # dissipation rate [m2/s3] the host syncs in, overwritten by the TKE in
    # the async phase's SGS block (hskpng_tke).  empty_state sizes them;
    # a State made by hand without them holds empty tensors
    incloud_time: torch.Tensor = dataclasses.field(default_factory=_empty)
    up: torch.Tensor = dataclasses.field(default_factory=_empty)
    vp: torch.Tensor = dataclasses.field(default_factory=_empty)
    wp: torch.Tensor = dataclasses.field(default_factory=_empty)
    ssp: torch.Tensor = dataclasses.field(default_factory=_empty)
    dot_ssp: torch.Tensor = dataclasses.field(default_factory=_empty)
    diss_rate: torch.Tensor = dataclasses.field(default_factory=_empty)
    # the y position of each SD (zero off the 3-D grid) and the staggered
    # y courants (nx*(ny+1)*nz on the 3-D grid, empty on any other)
    y: torch.Tensor = dataclasses.field(default_factory=_empty)
    courant_y: torch.Tensor = dataclasses.field(default_factory=_empty)
    # the ice attributes (particles_impl.ipp:93-99): the spheroid's
    # equatorial and polar semi-axes [m] and apparent density [kg/m3]
    # (all zero for a liquid SD; a frozen one has rw2 == 0 and ice_a *
    # ice_c > 0), the singular freezing temperature [K] and the squared
    # radius of the insoluble core [m2]
    ice_a: torch.Tensor = dataclasses.field(default_factory=_empty)
    ice_c: torch.Tensor = dataclasses.field(default_factory=_empty)
    ice_rho: torch.Tensor = dataclasses.field(default_factory=_empty)
    T_freeze: torch.Tensor = dataclasses.field(default_factory=_empty)
    rd2_insol: torch.Tensor = dataclasses.field(default_factory=_empty)
    # the aqueous chemistry (particles_impl.ipp chem vectors): each SD's
    # dissolved masses [kg] (8, n_sd_max) in common/chem.py's species
    # order, the cells' trace-gas mixing ratios (6, n_cell) and their
    # sstp_chem snapshot; (8, 0) and (6, 0) when chem_switch is off
    chem: torch.Tensor = dataclasses.field(default_factory=_empty)
    ambient_chem: torch.Tensor = dataclasses.field(default_factory=_empty)
    sstp_tmp_chem: torch.Tensor = dataclasses.field(default_factory=_empty)
    # the coalescence draws: Philox key (opts_init.rng_seed) and the step
    # counter, advanced by every coalescence call; the key's second word,
    # 0 on the serial engine and a shard's own on the multi-device front
    # (ops/philox.shard_key)
    rng_seed: int = 44
    rng_step: int = 0
    rng_key: int = 0

    @property
    def n_sd_max(self):
        return self.n.shape[0]

    @property
    def n_cell(self):
        return self.th.shape[0]


# the State's tensor fields, in declaration order
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(State)
                      if f.name not in ("rng_seed", "rng_step", "rng_key"))


def empty_state(cfg: StaticConfig, dtype, device, rng_seed=44) -> State:
    """An all-dead-slot state for a config of any grid (the staggered
    courants of its axes sized as the JAX package's empty_state sizes
    them); the substepping snapshot per SD in exact_sstp_cond mode; the
    chemistry's rows zero-width unless chem_switch is on."""
    zsd = torch.zeros(cfg.n_sd_max, dtype=dtype, device=device)
    zc = torch.zeros(cfg.n_cell, dtype=dtype, device=device)
    z = lambda m: torch.zeros(m, dtype=dtype, device=device)
    tmp = zsd if cfg.exact_sstp_cond else zc
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    return State(
        n=zsd, rd3=zsd, rw2=zsd, kpa=zsd, x=zsd, y=zsd, z=zsd, vt=zsd,
        ijk=torch.zeros(cfg.n_sd_max, dtype=torch.int64, device=device),
        incloud_time=zsd, up=zsd, vp=zsd, wp=zsd, ssp=zsd, dot_ssp=zsd,
        ice_a=zsd, ice_c=zsd, ice_rho=zsd, T_freeze=zsd, rd2_insol=zsd,
        chem=z((8, cfg.n_sd_max if cfg.chem_switch else 0)),
        ambient_chem=z((6, cfg.n_cell if cfg.chem_switch else 0)),
        sstp_tmp_chem=z((6, cfg.n_cell if cfg.chem_switch else 0)),
        th=zc, rv=zc, rhod=zc, p=zc,
        courant_x=z((nx + 1) * ny * nz if cfg.n_dims >= 1 else 0),
        courant_y=z(nx * (ny + 1) * nz if cfg.n_dims == 3 else 0),
        courant_z=z(nx * ny * (nz + 1) if cfg.n_dims >= 2 else 0),
        T=zc, RH=zc, eta=zc,
        dv=torch.ones(cfg.n_cell, dtype=dtype, device=device), diss_rate=zc,
        sstp_tmp_th=tmp, sstp_tmp_rv=tmp, sstp_tmp_rh=tmp,
        sstp_tmp_p=zsd if cfg.exact_sstp_cond else z(0),
        puddle=z(N_PUDDLE), rng_seed=int(rng_seed))


# puddle accumulator slots, mirroring common/output.hpp:8-42 output_t (the
# JAX package's two trailing internal slots included, so puddles convert
# one to one)
PUDDLE_KEYS = (
    "HNO3", "NH3", "CO2", "SO2", "H2O2", "O3", "S_VI", "H",
    "liquid_volume", "dry_volume", "particle_number", "ice_mass",
    "liquid_number", "ice_number",
)
OUT_LIQ_VOL = PUDDLE_KEYS.index("liquid_volume")
OUT_DRY_VOL = PUDDLE_KEYS.index("dry_volume")
OUT_PRTCL_NUM = PUDDLE_KEYS.index("particle_number")
OUT_ICE_MASS = PUDDLE_KEYS.index("ice_mass")
OUT_LIQ_NUM = PUDDLE_KEYS.index("liquid_number")
OUT_ICE_NUM = PUDDLE_KEYS.index("ice_number")
# the SDs a shard of the multi-device front could not send for want of
# room in the migration buffer (parallel/decomp.migrate)
OUT_MIGRATION_OVERFLOW = len(PUDDLE_KEYS)
# sticky flag: a coalescence pair asked for more than one collision in a
# substep (the reference's increase_sstp_coal request)
OUT_COAL_OVERFLOW = len(PUDDLE_KEYS) + 1
N_PUDDLE = len(PUDDLE_KEYS) + 2
