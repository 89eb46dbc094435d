"""Lognormal aerosol size distributions (Seinfeld & Pandis 1997 eqs
7.33-7.34; libcloudphxx_tpu/common/lognormal.py, reference
include/libcloudph++/common/lognormal.hpp), on tensors."""

import math

import torch


def n_e(mean_r, stdev, n_tot, lnr):
    """dN/dln(r) [m^-3] at ``lnr`` = ln(r) (reference
    lognormal.hpp:24-37)."""
    ln_sdev = math.log(stdev)
    return (n_tot
            * torch.exp(-((lnr - math.log(mean_r)) ** 2)
                        / (2 * ln_sdev ** 2))
            / ln_sdev / math.sqrt(2 * math.pi))


def n(mean_r, stdev, n_tot, r):
    """dN/dr [m^-4] at radius ``r`` (lognormal.hpp:39-52)."""
    ln_sdev = math.log(stdev)
    return (n_tot / r
            * torch.exp(-(torch.log(r / mean_r) ** 2) / (2 * ln_sdev ** 2))
            / ln_sdev / math.sqrt(2 * math.pi))
