"""The exp/log forms of cube root and power
(libcloudphxx_tpu/common/fastmath.py).  The condensation kernel computes
cbrt and pow this way, so its plain version does too."""

import torch


def cbrt_pos(x):
    """Cube root for x >= 0 (x == 0 maps to 0 via exp(-inf))."""
    return torch.exp(torch.log(x) / 3.0)


def pow_pos(x, p):
    """x ** p for x >= 0 (x == 0 maps to 0 for p > 0)."""
    return torch.exp(torch.log(x) * p)
