"""The static run configuration, the flat engine's state and the puddle
slots (libcloudphxx_tpu/lgrngn/state.py: StaticConfig, State, empty_state,
PUDDLE_KEYS, OUT_*).

The flat ``State`` holds the warm 2-D engine: per-SD arrays of length
n_sd_max, where multiplicity n == 0 marks a dead slot, and the per-cell
Eulerian mirrors.  Its random stream is the run's seed and a step counter
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


@dataclass
class State:
    """The flat engine's state (reference src/impl/particles_impl.ipp:
    66-146), warm and 2-D: per-SD arrays (n_sd_max,), cell arrays
    (n_cell,), the staggered courants ((nx+1)*nz and nx*(nz+1)).  Every
    step returns a new State; none is updated in place."""

    # per-SD attributes
    n: torch.Tensor       # multiplicity; 0 == dead slot
    rd3: torch.Tensor     # dry radius cubed [m3]
    rw2: torch.Tensor     # wet radius squared [m2]
    kpa: torch.Tensor     # kappa hygroscopicity
    x: torch.Tensor
    z: torch.Tensor
    vt: torch.Tensor      # terminal velocity [m/s]
    ijk: torch.Tensor     # int64 cell index i*nz + k; dead slots cell 0
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
    # the coalescence draws: Philox key (opts_init.rng_seed) and the step
    # counter, advanced by every coalescence call
    rng_seed: int = 44
    rng_step: int = 0

    @property
    def n_sd_max(self):
        return self.n.shape[0]

    @property
    def n_cell(self):
        return self.th.shape[0]


# the State's tensor fields, in declaration order
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(State)
                      if f.name not in ("rng_seed", "rng_step"))


def empty_state(cfg: StaticConfig, dtype, device, rng_seed=44) -> State:
    """An all-dead-slot state for a 2-D config; the substepping snapshot
    per SD in exact_sstp_cond mode."""
    zsd = torch.zeros(cfg.n_sd_max, dtype=dtype, device=device)
    zc = torch.zeros(cfg.n_cell, dtype=dtype, device=device)
    z = lambda m: torch.zeros(m, dtype=dtype, device=device)
    tmp = zsd if cfg.exact_sstp_cond else zc
    return State(
        n=zsd, rd3=zsd, rw2=zsd, kpa=zsd, x=zsd, z=zsd, vt=zsd,
        ijk=torch.zeros(cfg.n_sd_max, dtype=torch.int64, device=device),
        th=zc, rv=zc, rhod=zc, p=zc,
        courant_x=z((cfg.nx + 1) * cfg.nz), courant_z=z(cfg.nx * (cfg.nz + 1)),
        T=zc, RH=zc, eta=zc,
        dv=torch.ones(cfg.n_cell, dtype=dtype, device=device),
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
OUT_LIQ_NUM = PUDDLE_KEYS.index("liquid_number")
# sticky flag: a coalescence pair asked for more than one collision in a
# substep (the reference's increase_sstp_coal request)
OUT_COAL_OVERFLOW = len(PUDDLE_KEYS) + 1
N_PUDDLE = len(PUDDLE_KEYS) + 2
