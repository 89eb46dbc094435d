"""Mean free paths (libcloudphxx_tpu/common/mean_free_path.py; reference
mean_free_path.hpp)."""

import torch

from . import constants as c


def lambda_D(T):
    """Condensation mean free path [m] (mean_free_path.hpp:14-30)."""
    return 2.0 * c.D_0 / torch.sqrt(2.0 * c.R_v * T)


def lambda_K(T, p):
    """Thermal mean free path [m] (mean_free_path.hpp:32-51)."""
    return 0.8 * (c.K_0 * T / p) / torch.sqrt(2.0 * c.R_d * T)
