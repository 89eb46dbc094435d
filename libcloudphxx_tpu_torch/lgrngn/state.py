"""The static run configuration and the puddle slots
(libcloudphxx_tpu/lgrngn/state.py: StaticConfig, PUDDLE_KEYS, OUT_*).

The port keeps the population only in the dense cell-major layout
(lgrngn/dense.DenseState), so the flat ``State`` container is not ported.
"""

from dataclasses import dataclass


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
N_PUDDLE = len(PUDDLE_KEYS) + 2
