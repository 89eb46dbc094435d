"""Column-wise (sedimentation) right-hand-side terms of the single-moment
bulk scheme (libcloudphxx_tpu/blk_1m/rhs_columnwise.py; reference
include/libcloudph++/blk_1m/rhs_columnwise.hpp).

The reference walks each column top-down carrying an edge flux; here the
walk is shifted-tensor arithmetic over the whole grid.  The vertical is the
LAST axis, index 0 the lowest level.
"""

import enum

import torch

from . import formulae
from .options import opts_t


class ice_t(enum.Enum):
    iceA = 0
    iceB = 1


def _sediment(dot_r, rhod, r, dz, momentum):
    """Upstream sedimentation given per-cell terminal momenta rhod*v
    (reference rhs_columnwise.hpp:22-90 and :93-189).

    ``momentum[..., k]`` is rhod*v_term at cell k.  The downward flux through
    the bottom edge of cell k (k>=1) uses the edge-averaged momentum and the
    content of the cell above the edge; the bottom cell uses its mid-cell
    momentum.  Returns (dot_r updated, flux out of the domain [kg/m3/s],
    negative = downward)."""
    edge = -0.5 * (momentum[..., :-1] + momentum[..., 1:]) * r[..., 1:] / dz
    bottom = -momentum[..., 0:1] * r[..., 0:1] / dz
    flux_out = torch.cat([bottom, edge], dim=-1)
    # inflow from above = outflow of the cell above; zero above the top
    flux_in = torch.cat([flux_out[..., 1:], torch.zeros_like(bottom)], dim=-1)
    dot_r = dot_r - (flux_in - flux_out) / rhod
    return dot_r, flux_out[..., 0]


def rhs_columnwise(opts: opts_t, dot_rr, rhod, rr, dz):
    """Rain sedimentation with Kessler/Beard terminal velocity
    (reference rhs_columnwise.hpp:22-90).
    Returns (dot_rr updated, surface rain flux [kg/m3/s], negative=down)."""
    if not opts.sedi:
        return dot_rr, rr.new_zeros(rr.shape[:-1])
    rhod_0 = rhod[..., 0:1]
    momentum = rhod * formulae.v_term(rr, rhod, rhod_0)
    return _sediment(dot_rr, rhod, rr, dz, momentum)


def rhs_columnwise_ice(opts: opts_t, dot_ri, rhod, ri, dz, ice_type: ice_t):
    """Ice A/B sedimentation (reference rhs_columnwise.hpp:93-189).
    Returns (dot_ri updated, surface ice flux [kg/m3/s])."""
    if not opts.sedi:
        return dot_ri, ri.new_zeros(ri.shape[:-1])
    if ice_type == ice_t.iceA:
        v = formulae.velocity_iceA(ri, rhod)
    else:
        v = formulae.velocity_iceB(ri, rhod)
    return _sediment(dot_ri, rhod, ri, dz, rhod * v)
