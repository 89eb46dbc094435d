"""Options of the double-moment bulk scheme — a copy of
libcloudphxx_tpu/blk_2m/options.py, which is pure Python (importing it
from the JAX package would load jax).

Reference: include/libcloudph++/blk_2m/options.hpp:17-52.  Frozen
dataclasses: process switches, and the aerosol spectrum as a tuple of
lognormal modes.
"""

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class lognormal_mode_t:
    mean_rd: float   # [m]
    sdev_rd: float   # [1]
    N_stp: float     # [m^-3] at STP
    chem_b: float    # [1] solubility parameter


@dataclass(frozen=True)
class opts_t:
    acti: bool = True   # activation
    cond: bool = True   # condensation
    acnv: bool = True   # autoconversion
    accr: bool = True   # accretion
    sedi: bool = True   # sedimentation

    RH_max: float = 44.0  # RH limit for activation

    # Khairoutdinov & Kogan 2000 autoconversion parameters (eq. 29)
    acnv_A: float = 1350.0
    acnv_b: float = 2.47
    acnv_c: float = -1.79

    dry_distros: Tuple[lognormal_mode_t, ...] = field(default_factory=tuple)

    # thermodynamic convention, same contract as blk_1m (options.hpp:49-51)
    th_dry: bool = True
    const_p: bool = False

    def validate_theta_convention(self):
        if self.th_dry == self.const_p:
            raise ValueError(
                "blk_2m: exactly one of opts.th_dry and opts.const_p must be true"
            )
