"""The per-droplet condensation root find on flat SD arrays, in place of the
TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel (advance_rw2_pallas).

On the card it runs as kernel F (csrc/cond_sd.cu), beside its plain
PyTorch version, lgrngn/condensation._advance_rw2_core.  Dispatch is by
device, as in ops/step.py: CPU tensors run the plain version, CUDA tensors
launch the kernel (float32, contiguous, 1-D, all of one length, at any
length, or the wrapper raises), and ``plain=True`` runs the plain version
on any device, for comparisons and timings.
"""

import torch

from .. import _ext
from ..lgrngn import condensation


def advance_rw2(dt, rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K,
                RH_max, *, plain=False):
    """Backward-Euler advance of every droplet's rw^2 over ``dt``: kernel F,
    or its plain version (condensation._advance_rw2_core).  The 12 arrays
    are 1-D and of one length, the cell values already gathered to the
    droplets; returns the new rw2."""
    arrays = (rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K)
    if _ext.use_plain("cond_sd", rw2, plain):
        return condensation._advance_rw2_core(dt, *arrays, RH_max)
    for a in arrays:
        if a.dim() != 1 or a.shape != rw2.shape:
            raise ValueError("cond_sd: the SD arrays must be 1-D and of one "
                             f"length {tuple(rw2.shape)}, got "
                             f"{tuple(a.shape)}")
    _ext.check("cond_sd", *arrays)
    out = torch.empty_like(rw2)
    if out.numel() == 0:
        return out
    _ext.COND_SD.launch(*(a.data_ptr() for a in arrays), out.data_ptr(),
                        rw2.numel(), float(dt), float(RH_max),
                        condensation._root_iters(rw2.dtype))
    return out
