"""Port parity: kernel G's entry (ops/cond.advance_rw2, the per-droplet
root find at each droplet's own ambient conditions, the exact and adaptive
per-particle substepping's call) against the TPU kernel it replaces,
libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas, run in interpret mode
on the CPU, at float32.  On CPU tensors the entry runs G's plain version.

Two populations: tests/test_pallas_cond.py's (haze to cloud droplets,
every seventh slot dead, ambient conditions from sub- to supersaturated,
drawn droplet by droplet) and tests/test_torch_cond.py's (droplets of
every size in cells up to 2% supersaturated, some evaporating by an order
of magnitude in the step), with slots of rw2 < 0 added; RH capped at
1.01 and 44.  Tolerances: the float32 cross-library bounds of ROADMAP.md,
Queue 3 (XLA's and PyTorch's float32 transcendentals differ in the last
ulps, and the 12-iteration root find carries that to ~3e-5 on rw2):
rtol 3e-5 for every live droplet that keeps at least half of its rw2;
rtol 1e-2 (tests/test_torch_cond.py's bound) for those that lose more,
whose root find has not converged in 12 float32 iterations on either
side (here up to 9e-3, on a droplet that keeps 7% of its rw2); dead and
rw2 <= 0 slots exact.  This file runs JAX Pallas kernels in interpret
mode, so it stands apart from the other port tests.
"""

import numpy as np
import pytest
import torch
from test_pallas_cond import _population
from test_torch_cond import ARGS
from test_torch_cond import _population as _evaporating
from torch_parity import t

from libcloudphxx_tpu.lgrngn.condensation import _advance_rw2_core
from libcloudphxx_tpu.ops.pallas_cond import advance_rw2_pallas
from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.ops import cond as cond_ops


def _case(name, n):
    if name == "pallas":
        a = {k: np.array(v, np.float32) for k, v in _population(n).items()}
    else:
        pop = _evaporating()
        a = {k: pop[k][:n].astype(np.float32) for k in ARGS}
    a["rw2"][5::13] = -1e-14
    return a


@pytest.mark.parametrize("RH_max", [1.01, 44.0])
@pytest.mark.parametrize("name,n", [("pallas", 1), ("pallas", 1000),
                                    ("pallas", 5000), ("evaporating", 2048)])
def test_advance_rw2_matches_pallas_interpret(name, n, RH_max):
    a = _case(name, n)
    dt = 0.1 if name == "pallas" else 1.0 / 3
    want = np.asarray(advance_rw2_pallas(
        _advance_rw2_core, dt, *a.values(), RH_max, block_rows=8,
        interpret=True))
    before = _ext.COND_SD.launches
    got = cond_ops.advance_rw2(dt, *(t(v, torch.float32)
                                     for v in a.values()), RH_max).numpy()
    assert _ext.COND_SD.launches == before        # the plain version ran
    assert got.dtype == np.float32 and got.shape == (n,)
    rw2 = a["rw2"]
    live = rw2 > 0
    np.testing.assert_array_equal(got[~live], want[~live])
    np.testing.assert_array_equal(got[~live], rw2[~live])
    evap = live & (want < 0.5 * rw2)
    keep = live & ~evap
    np.testing.assert_allclose(got[keep], want[keep], rtol=3e-5)
    np.testing.assert_allclose(got[evap], want[evap], rtol=1e-2)
    if n > 1:
        d = got[live] - rw2[live]
        assert (d > 0).any() and (d < 0).any()
    if name == "evaporating":
        assert (live & (want < 0.1 * rw2)).any()
