"""Why two of the parcel comparisons are held as they are, on the CPU.

1. The rising parcel (tests/test_torch_parcel_rising.py) through the port
   and the JAX package at float64: at the packages' own 32 root-find
   iterations, th and rv agree to ~1e-13 but a few droplets' rw2 only to
   ~4e-10.  Printed per mode: those droplets with their dry and wet radii
   and their distance from the critical supersaturation; two witnesses
   on the order of the cell sum (each package against itself with the
   droplets permuted); the JAX package's own distance from its converged
   solve (RISE_ITERS iterations); the two packages at RISE_ITERS; and,
   per step, the largest rw2 difference of the per-cell mode.
2. Kernel F's parcel form takes weights per kg of air.  On the cell-volume
   weights of tests/torch_parity.flat_cond_case (dv rhod ~ 440 kg of air
   a cell) it runs outside physics: printed per case, the plain version
   at float32 against itself at float64, the substep after which rv first
   drops below 0, the liquid water a kg of air, and the first substep's
   largest change of T; beside it the same with the weights per kg.

    JAX_PLATFORMS=cpu python scripts/parcel_witness.py

Run from the repository root; it imports both packages (not part of the
tier-1 tests).
"""

import dataclasses
import os
import sys

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "tests"),
                os.path.join(os.path.dirname(__file__), "..")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_parcel import factory, make_opts, make_opts_init  # noqa
from test_torch_parcel_rising import (RISE_DRHO, RISE_ITERS,  # noqa: E402
                                      RISE_STEPS, RISING_MODES, _root_iters)
from torch_parity import flat_cond_case  # noqa: E402

from libcloudphxx_tpu import lgrngn as jl  # noqa: E402
from libcloudphxx_tpu_torch import lgrngn as tl  # noqa: E402
from libcloudphxx_tpu_torch.common import kappa_koehler as kk  # noqa: E402
from libcloudphxx_tpu_torch.lgrngn import hskpng  # noqa: E402
from libcloudphxx_tpu_torch.ops import cond as cond_ops  # noqa: E402

N_SD = 100


def rise(pkg, mode, perm=None):
    """tests/test_torch_parcel_rising.py's _rise, the droplets permuted by
    ``perm`` after init (and put back in the results).  Returns (th, rv,
    rw2 after each step, rd3, kpa, RH at the end)."""
    oi = make_opts_init(pkg, sstp_cond=10, **RISING_MODES[mode])
    opts = make_opts(pkg)
    rhod, th, rv = np.array([1.1]), np.array([290.0]), np.array([0.007])
    prt = factory(oi, pkg)
    prt.init(th, rv, rhod)
    if perm is not None:
        st = prt.state
        idx = perm if pkg is jl else torch.as_tensor(perm)
        prt.state = dataclasses.replace(st, **{
            f.name: getattr(st, f.name)[idx] for f in dataclasses.fields(st)
            if getattr(getattr(st, f.name), "shape", ()) == (N_SD,)})
    back = np.argsort(perm) if perm is not None else slice(None)
    rw2 = []
    for _ in range(RISE_STEPS):
        rhod = rhod * (1.0 - RISE_DRHO)
        prt.step_sync(opts, th, rv, rhod)
        prt.step_async(opts)
        rw2.append(np.asarray(prt.get_attr("rw2"))[back])
    prt.diag_RH()
    return (th[0], rv[0], np.array(rw2), np.asarray(prt.get_attr("rd3"))[back],
            np.asarray(prt.get_attr("kpa"))[back], float(prt.outbuf()[0]))


def rel(a, b):
    return np.abs(a - b) / np.abs(b)


def rising():
    perm = np.random.default_rng(5).permutation(N_SD)
    for mode in RISING_MODES:
        th, rv, rw2, rd3, kpa, RH = rise(tl, mode)
        jth, jrv, jrw2, *_ = rise(jl, mode)
        d = rel(rw2[-1], jrw2[-1])
        print(f"rising parcel, {mode}, 32 iterations: th rel "
              f"{rel(th, jth):.1e}, rv rel {rel(rv, jrv):.1e}, rw2 max rel "
              f"{d.max():.2e} ({int((d > 1e-10).sum())} of {N_SD} droplets "
              f"over 1e-10); RH at the end {RH:.6f}")
        pw = rel(rise(tl, mode, perm)[2][-1], rw2[-1]).max()
        jw = rel(rise(jl, mode, perm)[2][-1], jrw2[-1]).max()
        print(f"  the droplets permuted (the cell sum in another order): "
              f"port against port rw2 max rel {pw:.1e}, JAX against JAX "
              f"{jw:.1e}")
        with _root_iters(RISE_ITERS):
            _, _, crw2, *_ = rise(tl, mode)
            cth, crv, cjrw2, *_ = rise(jl, mode)
        u = rel(jrw2[-1], cjrw2[-1])
        print(f"  JAX at 32 against JAX at {RISE_ITERS} iterations: rw2 max "
              f"rel {u.max():.2e}; at {RISE_ITERS}, port against JAX: rw2 "
              f"max rel {rel(crw2[-1], cjrw2[-1]).max():.2e}; every droplet "
              f"within 1e-10 plus JAX's own distance: "
              f"{bool(np.all(d <= 1e-10 + u))}")
        T = torch.tensor(290.0, dtype=torch.float64)
        for i in np.argsort(-d)[:3]:
            r3, k = (torch.tensor(v, dtype=torch.float64)
                     for v in (rd3[i], kpa[i]))
            scr = float(kk.S_cr(r3, k, T))
            print(f"  droplet {i}: rd {rd3[i] ** (1 / 3):.3e} m, rw "
                  f"{rw2[-1][i] ** 0.5:.3e} m, rw_cr "
                  f"{float(kk.rw3_cr(r3, k, T)) ** (1 / 3):.3e} m, S_cr - 1 "
                  f"{scr - 1:.3e}, RH - S_cr {RH - scr:.3e}; port against "
                  f"JAX {d[i]:.2e}, JAX's own distance {u[i]:.2e}")
        if mode == "percell":
            steps = rel(rw2, jrw2).max(axis=1)
            print("  per-cell, rw2 max rel a step (port against JAX, 32 "
                  "iterations): " + " ".join(f"{x:.1e}" for x in steps))


FLAT_CASES = {"gmd": ([64, 57, 0, 71, 64, 90, 33, 64], 0),
              "long_cell": ([64, 0, 700, 64, 5, 64, 64, 64], 0),
              "dead_cell0": ([64, 64, 0, 64, 70, 64, 58, 64], 5000)}


def flat(cfg, kw, dtype, substeps=False):
    kw = {k: v.to(dtype) if isinstance(v, torch.Tensor)
          and v.is_floating_point() else v for k, v in kw.items()}
    if not substeps:
        return cond_ops.cond_flat_plain(cfg, RH_max=44.0, **kw)
    # the phase substep by substep: sstp calls of one substep each
    s = kw["sstp"]
    k1 = dict(kw, sstp=1, **{d: kw[d] / s for d in
                             ("delta_th", "delta_rv", "delta_rh")})
    out = []
    for _ in range(s):
        o = cond_ops.cond_flat_plain(cfg, RH_max=44.0, **k1)
        k1.update(rw2=o[0], th=o[1], rv=o[2], rhod=o[3])
        out.append(o)
    return out


def flat_weights():
    for case, (sizes, dead0) in FLAT_CASES.items():
        for conf, over in (("th_dry", {}), ("var_rho", {}),
                           ("const_p", dict(const_p=True))):
            cfg, kw = flat_cond_case(sizes, dead0, 0, "cpu", torch.float64,
                                     **over)
            kw["var_rho"] = conf == "var_rho"
            pcfg = dataclasses.replace(cfg, n_dims=0)
            live = kw["wgt"] > 0
            per_kg = dict(kw, wgt=kw["wgt"]
                          / (kw["dv"] * kw["rhod"])[kw["sijk"]])
            line = f"F parcel form, {case}, {conf}:"
            for name, k in (("cell-volume weights", kw),
                            ("weights per kg", per_kg)):
                a, b = flat(pcfg, k, torch.float32), flat(pcfg, k,
                                                          torch.float64)
                subs = flat(pcfg, k, torch.float64, substeps=True)
                neg = next((i + 1 for i, o in enumerate(subs)
                            if not bool((o[2] > 0).all())), None)
                T0 = hskpng.hskpng_Tpr(pcfg, k["th"], k["rv"], k["rhod"],
                                       k["p"])[0]
                T1 = hskpng.hskpng_Tpr(pcfg, *subs[0][1:4], k["p"])[0]
                lwc = float((k["wgt"][live] * k["rw2"][live] ** 1.5).sum()
                            / len(sizes))
                line += (f" | {name}: float32 against float64 th rel "
                         f"{float(rel(a[1].double(), b[1]).max()):.1e}, rv "
                         f"rel {float(rel(a[2].double(), b[2]).max()):.1e}; "
                         f"rv not above 0 first after substep {neg}; liquid "
                         f"{lwc:.2e} kg a kg of air; first substep's |dT| "
                         f"max {float((T1 - T0).abs().max()):.2e} K")
            print(line)


if __name__ == "__main__":
    rising()
    flat_weights()
