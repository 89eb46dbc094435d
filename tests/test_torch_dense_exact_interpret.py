"""Port parity: one substep of the dense engine's exact condensation, the
root find at each droplet's own ambient state over the ravelled (n_cell,
cap) planes (lgrngn/dense.step_cond_exact's call of kernel G's entry,
ops/cond.advance_rw2), against the TPU kernel the JAX package's dense
callers reach, libcloudphxx_tpu/ops/pallas_cond.advance_rw2_pallas, run in
interpret mode on the CPU, at float32.

The inputs are tests/test_torch_dense_exact.py's population (8x8 cells,
row capacity 16, half the slots dead with rw2 == 0, a third of the SDs
holding a neighbouring cell's snapshot) after its first substep's
increment and per-droplet closure, computed at float64 and rounded to
float32 for both sides; RH capped at 1.01 and 44.  Tolerances as
tests/test_torch_cond_sd_interpret.py (the float32 cross-library bounds
of ROADMAP.md, Queue 3): rtol 3e-5 for every live droplet that keeps at
least half of its rw2, 1e-2 for those that lose more; the dead slots
exact.  This file runs JAX Pallas kernels in interpret mode, so it stands
apart from the other port tests.
"""

import numpy as np
import pytest
import torch
from test_torch_dense_exact import CAP, _jax_case
from torch_parity import t

from libcloudphxx_tpu.lgrngn.condensation import _advance_rw2_core
from libcloudphxx_tpu.ops.pallas_cond import advance_rw2_pallas
from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.lgrngn import condensation as tcond
from libcloudphxx_tpu_torch.lgrngn import dense as tdense
from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp, hskpng_Tpr
from libcloudphxx_tpu_torch.ops import cond as cond_ops


def _first_substep():
    """The 12 droplet arrays of step_cond_exact's first advance_rw2 call,
    ravelled, as float64 numpy, and dt_sub."""
    _, _, pcfg, ps, th, rv = _jax_case("mix")
    d = tdense.pack(pcfg, ps, CAP)
    th, rv = t(th), t(rv)
    sstp = pcfg.sstp_cond
    col = lambda a: a[:, None]
    lam_D, lam_K = (col(a).expand(d.n.shape) for a in hskpng_mfp(d.T, d.p))
    _, p, _, _ = hskpng_Tpr(pcfg, th, rv, d.rhod, d.p)
    rv_s = d.sd_rv + (col(rv) - d.sd_rv) / sstp
    th_s = d.sd_th + (col(th) - d.sd_th) / sstp
    rh_s = d.sd_rh + (col(d.rhod) - d.sd_rh) / sstp
    T, pp, RH, eta = tcond._perparticle_thermo(pcfg, th_s, rv_s, rh_s,
                                               d.sd_p)
    arrays = (d.rw2, d.rd3, d.kpa, d.vt, rh_s, rv_s, T, pp, RH, eta, lam_D,
              lam_K)
    return [a.reshape(-1).numpy() for a in arrays], d.n.reshape(-1).numpy(), \
        1.0 / sstp


@pytest.mark.parametrize("RH_max", [1.01, 44.0])
def test_dense_substep_matches_pallas_interpret(RH_max):
    arrays, n, dt = _first_substep()
    # a dead slot's private state is th/sstp, rv/sstp at rhod/sstp: its RH
    # overflows float32 (to inf, on the card too); G skips the slot
    with np.errstate(over="ignore"):
        a = [v.astype(np.float32) for v in arrays]
    want = np.asarray(advance_rw2_pallas(_advance_rw2_core, dt, *a, RH_max,
                                         block_rows=8, interpret=True))
    before = _ext.COND_SD.launches
    got = cond_ops.advance_rw2(dt, *(t(v, torch.float32) for v in a),
                               RH_max).numpy()
    assert _ext.COND_SD.launches == before        # the plain version ran
    assert got.dtype == np.float32 and got.shape == (64 * CAP,)
    rw2 = a[0]
    live = rw2 > 0
    assert (n > 0).sum() == live.sum() < live.size     # dead slots: rw2 0
    np.testing.assert_array_equal(got[~live], want[~live])
    np.testing.assert_array_equal(got[~live], rw2[~live])
    evap = live & (want < 0.5 * rw2)
    keep = live & ~evap
    np.testing.assert_allclose(got[keep], want[keep], rtol=3e-5)
    np.testing.assert_allclose(got[evap], want[evap], rtol=1e-2)
    assert (got[live] != rw2[live]).any()
