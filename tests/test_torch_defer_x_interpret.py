"""Port parity of the deferred re-binning at float32: the port's deferred
dense.step_fused (plain versions on the CPU) against the JAX package's
deferred-x pipeline, its resident Pallas kernel with the x-merge prologue
run in TPU interpret mode, as tests/test_pallas_step.py's
test_deferred_xmerge_matches_dense_xla runs it (coalescence off).

Kept in a file of its own: interpret-mode kernels in one process with the
rest of the suite have crashed it before (ROADMAP.md, Queue 3).

* Three deferred steps on both sides from the same population (JAX's with
  an all-stay xkey), then both flushed (dense.flush_merge, flush_xmerge):
  per cell as multisets, cells and multiplicities exact, x and z at rtol
  1e-5, th and rv at 1e-6 (the JAX test's own tolerances; lane order
  within a row differs: JAX's x pass compacts its own way); rw2 at rtol
  5e-5, the port-against-JAX float32 gate of
  tests/test_torch_step_interpret.py: the two libraries' float32 exp/log
  differ in the last ulps, which the root find carries to ~3e-5 on some
  droplets (2.8e-5 here, on haze droplets of rw2 ~1e-17).
* A JAX state after one deferred step, its x pass pending, converted
  (convert.dense_state_from_numpy: xkey to pending targets) and flushed by
  the port, against the JAX package's flush of it: the same per-cell
  populations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import multiset, port_cfg, port_state, t

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as jdense
from libcloudphxx_tpu.lgrngn import vterm as jvterm
from libcloudphxx_tpu.models import Kinematic2D
from libcloudphxx_tpu_torch.convert import dense_state_from_numpy
from libcloudphxx_tpu_torch.lgrngn import dense as tdense

STEPS = 3
F32 = torch.float32


@pytest.fixture(scope="module")
def case():
    m = Kinematic2D(nx=8, nz=8, micro="lgrngn", sd_conc=24, sstp_cond=3,
                    sstp_coal=2, n_sd_max=24 * 8 * 8,
                    terminal_velocity=lgrngn.vt_t.beard77)
    cfg = m.prtcls.cfg
    d = jdense.pack(cfg, m.prtcls.state, 32)
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d = dataclasses.replace(d, **{f.name: f32(getattr(d, f.name))
                                  for f in dataclasses.fields(d)
                                  if f.name != "key"})
    c = lambda a: a[:, None]
    d = dataclasses.replace(d, vt=jvterm.vt_of(cfg, d.rw2, c(d.T), c(d.p),
                                               c(d.rhod), c(d.eta)))
    th = jnp.asarray(m.th, jnp.float32).reshape(-1)
    rv = jnp.asarray(m.rv, jnp.float32).reshape(-1)
    return cfg, d, th, rv, float(m.setup.dt)


def _jax_steps(cfg, d, th, rv, dt, k):
    """k deferred JAX steps (an all-stay xkey switches the pipeline on)."""
    d = dataclasses.replace(d, xkey=jnp.where(d.n > 0, jnp.float32(2.0),
                                              jnp.float32(3.0)))
    with pltpu.force_tpu_interpret_mode():
        for _ in range(k):
            d, th, rv = jdense.step_fused(
                cfg, d, th, rv, jnp.zeros((0,), jnp.float32), dt, 44.0, 2,
                False, True)
    return d, th, rv


def _cells(a, b, rtol_rw2=5e-5):
    """Per-cell multisets (cell, n, rw2, x, z): cells and n exact, rw2 at
    ``rtol_rw2``, x and z at the JAX test's 1e-5."""
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :2], b[:, :2])   # cells, n
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=rtol_rw2)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-5)


def _ms(d):
    return multiset(d.n, (d.rw2, d.x, d.z))


def test_deferred_steps_match_the_pallas_prologue(case):
    cfg, d, th, rv, dt = case
    jd, jth, jrv = _jax_steps(cfg, d, th, rv, dt, STEPS)
    assert jd.xkey.size                        # the x pass is pending
    with pltpu.force_tpu_interpret_mode():
        jd = jdense.flush_xmerge(cfg, jd)
    pcfg = port_cfg(cfg)
    pd, pth, prv = port_state(d, F32), t(th, F32), t(rv, F32)
    for _ in range(STEPS):
        pd, pth, prv = tdense.step_fused(pcfg, pd, pth, prv, (), dt, 44.0, 2,
                                         False, True, defer=True)
    assert pd.pending_tgt.numel()
    pd = tdense.flush_merge(pcfg, pd)
    np.testing.assert_allclose(pth.numpy(), np.asarray(jth), rtol=1e-6)
    np.testing.assert_allclose(prv.numpy(), np.asarray(jrv), rtol=1e-6)
    _cells(_ms(pd), _ms(jd))
    assert int(pd.overflow) == int(jd.overflow) == 0


def test_pending_jax_state_converts_and_flushes(case):
    cfg, d, th, rv, dt = case
    jd, _, _ = _jax_steps(cfg, d, th, rv, dt, 1)
    arrays = {f.name: np.asarray(getattr(jd, f.name))
              for f in dataclasses.fields(jd)}
    xkey = arrays["xkey"]
    assert ((xkey == 0) | (xkey == 1)).any()   # some droplets move in x
    with pytest.raises(ValueError, match="cfg"):
        dense_state_from_numpy(arrays, "cpu", F32)
    pcfg = port_cfg(cfg)
    pd = dense_state_from_numpy(arrays, "cpu", F32, cfg=pcfg)
    assert pd.pending_tgt.shape == pd.n.shape
    assert pd.pending_tgt.dtype == torch.int32
    with pltpu.force_tpu_interpret_mode():
        jf = jdense.flush_xmerge(cfg, jd)
    pf = tdense.flush_merge(pcfg, pd)
    _cells(_ms(pf), _ms(jf), rtol_rw2=1e-5)
    assert int(pf.overflow) == int(jf.overflow) == 0
