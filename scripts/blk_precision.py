#!/usr/bin/env python3
"""How far the bulk schemes' float32 run lies from the float64 run in the
fig_a case, and where the distance comes from.

Runs Kinematic2D(76, 76, micro, grid="node", fct=True) from ante_loop
through run_device(nt, spinup) three ways, all through the plain path
(which kernel A equals bitwise on the card):

  float32             the fields and the microphysics in float32
  float32, micro f64  the fields stored and advected in float32, each
                      step's microphysics computed in float64 (the fields
                      cast up before it, the results cast back after)
  float64             everything in float64

and prints the largest absolute difference of th, rv, rc and rr (and nc,
nr for blk_2m) of the first two from the third.  If the second is as far
as the first, the float32 storage and advection of the fields set the
distance, not the schemes' arithmetic.

    python3 scripts/blk_precision.py --micro blk_2m --nt 3000 --spinup 1200
    python3 scripts/blk_precision.py --device cuda     # on the card
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from libcloudphxx_tpu_torch import Kinematic2D  # noqa: E402
from libcloudphxx_tpu_torch.models.kinematic_2d import BULK_FIELDS  # noqa


class MicroInFloat64(Kinematic2D):
    """Kinematic2D whose bulk microphysics runs in float64 on fields kept
    in the model's dtype."""

    def _blk_micro(self, fields, spinup):
        rhod = self.rhod
        self.rhod = rhod.double()
        try:
            out, flux = super()._blk_micro(tuple(f.double() for f in fields),
                                           spinup)
        finally:
            self.rhod = rhod
        return tuple(f.to(self.dtype) for f in out), flux.to(self.dtype)


def run(cls, micro, dtype, nt, spinup, device):
    m = cls(nx=76, nz=76, micro=micro, grid="node", fct=True, device=device,
            dtype=dtype)
    m.ante_loop()
    t0 = time.perf_counter()
    m.run_device(nt, spinup=spinup, plain=True)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {k: getattr(m, k).double() for k in BULK_FIELDS[micro]}, secs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", default="blk_2m", choices=sorted(BULK_FIELDS))
    ap.add_argument("--nt", type=int, default=3000)
    ap.add_argument("--spinup", type=int, default=1200)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    ref, secs = run(Kinematic2D, a.micro, torch.float64, a.nt, a.spinup,
                    a.device)
    print(f"{a.micro}, t = {a.nt} ({a.spinup} spin-up), {a.device}: "
          f"float64 in {secs:.1f} s", flush=True)
    for label, cls in (("float32", Kinematic2D),
                       ("float32, micro f64", MicroInFloat64)):
        out, secs = run(cls, a.micro, torch.float32, a.nt, a.spinup,
                        a.device)
        diffs = ", ".join(f"{k} {float((out[k] - ref[k]).abs().max()):.3e}"
                          for k in BULK_FIELDS[a.micro])
        print(f"  {label} ({secs:.1f} s): max |x - x_float64|: {diffs}",
              flush=True)


if __name__ == "__main__":
    main()
