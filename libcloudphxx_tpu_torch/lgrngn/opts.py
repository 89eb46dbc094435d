"""Construction-time and per-step options of the SDM engine — a copy of
libcloudphxx_tpu/lgrngn/opts.py, which is pure Python (importing it from
the JAX package would load jax).

Reference: include/libcloudph++/lgrngn/opts_init.hpp:28-253 and
opts.hpp:19-50.  Both are mutable attribute containers (host models
configure them imperatively, reference-style); ``StaticConfig.
from_opts_init`` snapshots the fields that shape a run.

``dry_distros`` maps (kappa, rd_insol) -> callable n(ln rd) [1/m3 @ STP],
mirroring reference distro_t.hpp:9-57.  ``dry_sizes`` maps (kappa, rd_insol)
-> {radius: (concentration [1/m3 @STP], SD count)}.
"""

from .enums import RH_formula_t, as_t, kernel_t, src_t, vt_t


class opts_init_t:
    def __init__(self):
        # aerosol init (reference opts_init.hpp:31-35)
        self.dry_distros = {}
        self.dry_sizes = {}

        # Eulerian grid (opts_init.hpp:38-39, defaults :195-199)
        self.nx = 0
        self.ny = 0
        self.nz = 0
        self.dx = 1.0
        self.dy = 1.0
        self.dz = 1.0
        self.dt = 0.0

        # substep counts (opts_init.hpp:42-49)
        self.sstp_cond = 1
        self.sstp_coal = 1
        self.sstp_chem = 1
        self.sstp_cond_act = 1

        # Lagrangian domain extents (opts_init.hpp:53)
        self.x0 = 0.0
        self.y0 = 0.0
        self.z0 = 0.0
        self.x1 = 1.0
        self.y1 = 1.0
        self.z1 = 1.0

        # SD init mode (opts_init.hpp:56-73)
        self.sd_conc = 0
        self.sd_conc_large_tail = False
        # opt-in replica of the reference serial backend's mt19937/float32
        # init sampling (positions/radii/multiplicities bit-compatible with
        # real_t=float builds) — used by the golden-parity regression
        self.reference_rng_init = False
        self.aerosol_independent_of_rhod = False
        self.variable_dt_switch = False
        self.sd_const_multi = 0
        self.n_sd_max = 0

        # physics selections (opts_init.hpp:75-87)
        self.kernel = kernel_t.undefined
        self.terminal_velocity = vt_t.undefined
        self.adve_scheme = as_t.implicit
        self.RH_formula = RH_formula_t.pv_cc
        self.kernel_parameters = []

        # process switches (opts_init.hpp:92-106)
        self.chem_switch = False
        self.coal_switch = True
        self.sedi_switch = True
        self.subs_switch = False
        self.rlx_switch = False
        self.turb_adve_switch = False
        self.turb_cond_switch = False
        self.turb_coal_switch = False
        self.ice_switch = False
        self.exact_sstp_cond = False
        self.sstp_cond_mix = True
        self.adaptive_sstp_cond = False
        self.time_dep_ice_nucl = False

        self.sstp_cond_adapt_drw2_eps = 1e-4
        self.sstp_cond_adapt_drw2_max = 4.0

        self.chem_rho = 0.0
        self.diag_incloud_time = False

        # RH cap for the equilibrium init condition (opts_init.hpp:118)
        self.RH_max = 0.95

        # RNG seeds (opts_init.hpp:121-126)
        self.rng_seed = 44
        self.rng_seed_init = 44
        self.rng_seed_init_switch = False

        # device selection kept for API parity; ignored (the port takes an
        # explicit torch device instead)
        self.dev_count = 0
        self.dev_id = -1

        # profiles (opts_init.hpp:135-143)
        self.w_LS = []
        self.SGS_mix_len = []
        self.aerosol_conc_factor = []

        # init dry-radius range; negative = automatic detection
        # (opts_init.hpp:145)
        self.rd_min = -1.0
        self.rd_max = -1.0

        self.no_ccn_at_init = False
        self.open_side_walls = False
        self.periodic_topbot_walls = False
        self.rc2_T = 10.0

        # aerosol source (opts_init.hpp:153-163)
        self.src_type = src_t.off
        self.src_x0 = 0.0
        self.src_x1 = 0.0
        self.src_y0 = 0.0
        self.src_y1 = 0.0
        self.src_z0 = 0.0
        self.src_z1 = 0.0
        self.supstp_src = 1
        self.src_dry_distros = {}
        self.src_dry_sizes = {}

        # aerosol relaxation (opts_init.hpp:166-190)
        self.rlx_dry_distros = {}
        self.rlx_bins = 0
        self.rlx_sd_per_bin = 0.0
        self.supstp_rlx = 1
        self.rlx_timescale = 1.0

        # theta convention (opts_init.hpp:192-194)
        self.th_dry = True
        self.const_p = False

    # number of spatial dimensions, as in reference particles_impl.ipp:334-358
    @property
    def n_dims(self):
        return int(self.nx > 0) + int(self.ny > 0) + int(self.nz > 0)

    @property
    def n_cell(self):
        return max(1, self.nx) * max(1, self.ny) * max(1, self.nz)


class opts_t:
    """Per-step process toggles (reference opts.hpp:19-50)."""

    def __init__(self):
        self.adve = True
        self.sedi = True
        self.subs = False
        self.cond = True
        self.coal = True
        self.src = False
        self.rlx = False
        self.rcyc = False
        self.chem_dsl = False
        self.chem_dsc = False
        self.chem_rct = False
        self.turb_adve = False
        self.turb_cond = False
        self.turb_coal = False
        self.ice_nucl = False
        self.RH_max = 44.0      # no-limit default, as reference opts.hpp:37
        self.dt = -1.0          # <=0 means use opts_init.dt
        # per-step source definitions (reference opts.hpp:40-48):
        # {(kappa, rd_insol): (fun, src_sd_conc, supstp)} and
        # {(kappa, rd_insol): {radius: (conc_per_s, sd_count, supstp)}}
        self.src_dry_distros = {}
        self.src_dry_sizes = {}
