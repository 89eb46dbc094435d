"""Port parity: the flat engine's per-droplet root find
(lgrngn/condensation._advance_rw2_core, which kernel F's plain version
ops/cond.cond_flat_plain runs every substep) against the TPU kernel it
replaces, libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas, run in
interpret mode on the CPU, at float32.

The populations are tests/test_pallas_cond.py's (haze to cloud droplets,
every seventh slot dead, cells from sub- to supersaturated), n = 100,
1024 and 5000 in blocks of 8 x 128.  Tolerance: the documented float32
cross-library bound of ROADMAP.md, Queue 3 (XLA's and PyTorch's float32
transcendentals differ in the last ulps, and the 12-iteration root find
carries that to ~3e-5 on rw2): rtol 1e-4 for every live droplet; dead
slots exact.  This file runs JAX Pallas kernels in interpret mode, so it
stands apart from the other port tests.
"""

import numpy as np
import pytest
import torch
from test_pallas_cond import _population
from torch_parity import t

from libcloudphxx_tpu.lgrngn.condensation import _advance_rw2_core
from libcloudphxx_tpu.ops.pallas_cond import advance_rw2_pallas
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond


@pytest.mark.parametrize("RH_max", [1.01, 44.0])
@pytest.mark.parametrize("n", [100, 1024, 5000])
def test_advance_rw2_matches_pallas_interpret(n, RH_max):
    a = _population(n)
    want = np.asarray(advance_rw2_pallas(
        _advance_rw2_core, 0.1, *a.values(), RH_max, block_rows=8,
        interpret=True))
    got = tcond._advance_rw2_core(
        0.1, *(t(v, torch.float32) for v in a.values()), RH_max).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    live = np.asarray(a["rw2"]) > 0
    assert (~live).any()
    np.testing.assert_array_equal(got[~live], want[~live])
    np.testing.assert_allclose(got[live], want[live], rtol=1e-4)
    # the step grows some droplets and evaporates others
    d = got[live] - np.asarray(a["rw2"])[live]
    assert (d > 0).any() and (d < 0).any()
