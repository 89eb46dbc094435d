"""libcloudphxx_tpu_torch: the PyTorch/CUDA port of libcloudphxx_tpu.

Plain tensor code is PyTorch; each TPU (Pallas) kernel of the ported path
has a CUDA C++ counterpart for Hopper (sm_90a) under csrc/, built at first
use by _ext.py, with a plain PyTorch version beside it that CPU tensors
run.  The JAX package stays the reference; this package imports neither
jax nor libcloudphxx_tpu.

Ported so far: the GMD-2015 kinematic lgrngn case on the dense engine
without coalescence (models.Kinematic2D.run_device_lgrngn).
"""

from .models import Kinematic2D

__all__ = ["Kinematic2D"]
