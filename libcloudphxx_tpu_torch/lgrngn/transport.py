"""Super-droplet transport on the flat engine, 2-D: advection,
sedimentation, subsidence, the walls with the puddle, the re-bin
(libcloudphxx_tpu/lgrngn/transport.py; reference
src/impl/advection/particles_impl_adve.ipp, sedimentation/, subsidence/,
boundary_conditions/particles_impl_bcnd.ipp).

Courant fields are Arakawa-C staggered and C-order flattened: courant_x
(nx+1, nz), courant_z (nx, nz+1); the gather indices reproduce the
reference's lft/rgt/blw/abv neighbour vectors (init_grid.ipp:94-155).
Each function returns a new State.
"""

import dataclasses

import torch

from ..common import constants as c
from .enums import as_t
from .hskpng import ijk_of_xyz
from .state import (OUT_DRY_VOL, OUT_LIQ_NUM, OUT_LIQ_VOL, OUT_PRTCL_NUM,
                    State, StaticConfig)


def courant_indices(cfg: StaticConfig, ijk):
    """Indices into courant_x (left, right faces) and courant_z (below,
    above) of the cells ``ijk``."""
    i = ijk // cfg.nz
    return (ijk, ijk + cfg.nz), (ijk + i, ijk + i + 1)


def _axis_implicit(x, dx, idx, C_l, C_r):
    """Backward-Euler interpolated advance (adve.ipp:28-61); positions are
    absolute, idx = floor(x / dx)."""
    dC = C_r - C_l
    return (x + dx * (C_l - idx * dC)) / (1.0 - dC)


def _euler_disp(x, dx, idx, C_l, C_r):
    """Forward-Euler interpolated displacement (adve.ipp:64-93)."""
    dC = C_r - C_l
    return dC * (x - dx * idx) + dx * C_l


def _axis_euler(x, dx, idx, C_l, C_r):
    return x + _euler_disp(x, dx, idx, C_l, C_r)


def _advance(cfg, state, ijk, x, z, scheme_fn):
    (lft, rgt), (blw, abv) = courant_indices(cfg, ijk)
    i = (ijk // cfg.nz).to(x.dtype)
    k = (ijk % cfg.nz).to(x.dtype)
    cx, cz = state.courant_x, state.courant_z
    return (scheme_fn(x, cfg.dx, i, cx[lft], cx[rgt]),
            scheme_fn(z, cfg.dz, k, cz[blw], cz[abv]))


def _wrap(x, a, b):
    """Periodic wrap a + (x - a) mod (b - a), the remainder taking the
    sign of the divisor (bcnd.ipp detail::periodic:99-110)."""
    w = torch.full((), b - a, dtype=x.dtype, device=x.device)
    r = torch.fmod(x - a, w)
    return a + torch.where((r != 0) & ((r < 0) != (w < 0)), r + w, r)


def adve(cfg: StaticConfig, state: State) -> State:
    """SD advection by the implicit, euler or pred_corr scheme
    (reference adve.ipp:169-304)."""
    scheme = as_t(cfg.adve_scheme)
    if scheme == as_t.implicit:
        x, z = _advance(cfg, state, state.ijk, state.x, state.z,
                        _axis_implicit)
        return dataclasses.replace(state, x=x, z=z)
    if scheme == as_t.euler:
        x, z = _advance(cfg, state, state.ijk, state.x, state.z, _axis_euler)
        return dataclasses.replace(state, x=x, z=z)
    # predictor-corrector (adve.ipp:184-304): a forward-Euler predictor,
    # z kept inside the domain, x wrapped with its old position shifted
    # alike, then the mean of the two displacements
    x_old, z_old = state.x, state.z
    x, z = _advance(cfg, state, state.ijk, x_old, z_old, _axis_euler)
    z = torch.clamp(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    x_wr = _wrap(x, cfg.x0, cfg.x1)
    x_old = x_old + (x_wr - x)
    x = x_wr
    dx_, dz_ = _advance(cfg, state, ijk_of_xyz(cfg, x, z), x, z, _euler_disp)
    return dataclasses.replace(state, x=(x + x_old + dx_) / 2.0,
                               z=(z + z_old + dz_) / 2.0)


def sedi(state: State, dt) -> State:
    """z -= dt * vt (reference sedi.ipp:13-24)."""
    return dataclasses.replace(state, z=state.z - dt * state.vt)


def subs(cfg: StaticConfig, state: State, w_LS, dt) -> State:
    """Large-scale subsidence from the per-level profile ``w_LS`` (a
    tensor, positive downwards; reference subs.ipp:39-51)."""
    return dataclasses.replace(state,
                               z=state.z - dt * w_LS[state.ijk % cfg.nz])


def bcnd(cfg: StaticConfig, state: State) -> State:
    """The walls and the puddle (reference bcnd.ipp:214-365): periodic or
    open side walls; periodic top and bottom, or droplets above the top
    removed and those below the bottom added to the puddle and removed."""
    x, z, n = state.x, state.z, state.n
    if not cfg.open_side_walls:
        x = _wrap(x, cfg.x0, cfg.x1)
    else:
        n = torch.where((x >= cfg.x1) | (x < cfg.x0), 0.0, n)
    puddle = state.puddle
    if cfg.periodic_topbot_walls:
        z = _wrap(z, cfg.z0, cfg.z1)
    else:
        n = torch.where(z >= cfg.z1, 0.0, n)
        fell = (z < cfg.z0) & (n > 0)
        nf = torch.where(fell, n, 0.0)
        rw2 = state.rw2
        fold = torch.zeros_like(puddle)
        fold[OUT_LIQ_VOL] = torch.sum(
            4.0 / 3 * c.pi * nf * rw2 * torch.sqrt(torch.clamp(rw2, min=0.0)))
        fold[OUT_DRY_VOL] = torch.sum(4.0 / 3 * c.pi * nf * state.rd3)
        fold[OUT_LIQ_NUM] = torch.sum(torch.where(rw2 > 0, nf, 0.0))
        fold[OUT_PRTCL_NUM] = torch.sum(nf)
        puddle = puddle + fold
        n = torch.where(fell, 0.0, n)
    return dataclasses.replace(state, x=x, z=z, n=n, puddle=puddle)


def post_step(cfg: StaticConfig, state: State) -> State:
    """Re-bin every SD into the cell of its position (the reference's
    post_copy hskpng_ijk, post_copy.ipp:18-36); dead slots go to cell 0."""
    ijk = ijk_of_xyz(cfg, state.x, state.z)
    return dataclasses.replace(state,
                               ijk=torch.where(state.n > 0, ijk, 0))
