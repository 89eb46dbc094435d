"""Batched bracketed root finding (libcloudphxx_tpu/ops/rootfind.py).

A fixed-iteration Anderson-Bjoerck regula falsi with a bisection safeguard:
every element runs the same number of steps, so the whole population is
solved with one instruction stream (reference: per-element TOMS-748,
include/libcloudph++/common/detail/toms748.hpp).  The condensation kernel
runs the same iteration per droplet (csrc/cond_cell.cuh advance_slots).
"""

import torch


def solve_bracketed(f, a, b, *, iters=32):
    """Find roots of the elementwise callable ``f`` within ``[a, b]``.

    A sign change inside the bracket is assumed; without one the iteration
    collapses toward the endpoint with the smaller |f| — callers that need
    a fallback (condensation's explicit Euler) detect that themselves."""
    fa = f(a)
    fb = f(b)
    for _ in range(iters):
        denom = fb - fa
        mid = 0.5 * (a + b)
        sec = torch.where(
            denom != 0,
            (a * fb - b * fa) / torch.where(denom == 0, 1.0, denom), mid)
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        x = torch.where((sec > lo) & (sec < hi), sec, mid)
        fx = f(x)
        left = fa * fx <= 0  # root now in [a, x]
        # Anderson-Bjoerck scaling of the retained endpoint
        m_l = 1 - fx / torch.where(fb == 0, 1.0, fb)
        m_r = 1 - fx / torch.where(fa == 0, 1.0, fa)
        m_l = torch.where(m_l > 0, m_l, 0.5)
        m_r = torch.where(m_r > 0, m_r, 0.5)
        na = torch.where(left, a, x)
        nfa = torch.where(left, fa * m_l, fx)
        nb = torch.where(left, x, b)
        nfb = torch.where(left, fx, fb * m_r)
        # an element that hit fx == 0 keeps a collapsed bracket
        a = torch.where(fx == 0, x, na)
        b = torch.where(fx == 0, x, nb)
        fa, fb = nfa, nfb
    return torch.where(torch.abs(fa) < torch.abs(fb), a, b)
