"""Super-droplet transport on the flat engine: advection, sedimentation,
subsidence, the walls with the puddle, the re-bin
(libcloudphxx_tpu/lgrngn/transport.py; reference
src/impl/advection/particles_impl_adve.ipp, sedimentation/, subsidence/,
boundary_conditions/particles_impl_bcnd.ipp), on the grid's axes: x on
the 1-D grid, x and z on the 2-D, x, y and z on the 3-D; a parcel has
none, and there advection, the walls and the re-bin leave the State as
it is.

Courant fields are Arakawa-C staggered and C-order flattened: courant_x
(nx+1, ny, nz), courant_y (nx, ny+1, nz), courant_z (nx, ny, nz+1); the
gather indices reproduce the reference's lft/rgt/fre/hnd/blw/abv
neighbour vectors (init_grid.ipp:94-155).  Each function returns a new
State.
"""

import dataclasses

import torch

from ..common import constants as c
from .enums import as_t
from .hskpng import ijk_of_xyz
from .ice import ice_mass
from .state import (OUT_DRY_VOL, OUT_ICE_MASS, OUT_ICE_NUM, OUT_LIQ_NUM,
                    OUT_LIQ_VOL, OUT_PRTCL_NUM, State, StaticConfig)


def _decompose(cfg: StaticConfig, ijk):
    """(i, j, k) of the cells ``ijk``, ravelled i outermost
    (init_grid.ipp:41-44)."""
    return ijk // (cfg.ny * cfg.nz), (ijk // cfg.nz) % cfg.ny, ijk % cfg.nz


def courant_indices(cfg: StaticConfig, ijk):
    """Indices of the cells ``ijk``'s faces in courant_x (left, right),
    courant_y (front, hind) and courant_z (below, above)."""
    i, j, _ = _decompose(cfg, ijk)
    fre = ijk + i * cfg.nz
    blw = ijk + i * cfg.ny + j
    return ((ijk, ijk + cfg.ny * cfg.nz), (fre, fre + cfg.nz),
            (blw, blw + 1))


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


def _advance(cfg, state, ijk, x, y, z, scheme_fn):
    """``scheme_fn`` along each axis of the grid at the positions (x, y,
    z) of SDs in the cells ``ijk``: x always, y on the 3-D grid, z on the
    2-D and 3-D; the other positions come back as they are."""
    i, j, k = _decompose(cfg, ijk)
    (lft, rgt), (fre, hnd), (blw, abv) = courant_indices(cfg, ijk)
    x = scheme_fn(x, cfg.dx, i.to(x.dtype), state.courant_x[lft],
                  state.courant_x[rgt])
    if cfg.n_dims == 3:
        y = scheme_fn(y, cfg.dy, j.to(y.dtype), state.courant_y[fre],
                      state.courant_y[hnd])
    if cfg.n_dims > 1:
        z = scheme_fn(z, cfg.dz, k.to(z.dtype), state.courant_z[blw],
                      state.courant_z[abv])
    return x, y, z


def _wrap(x, a, b):
    """Periodic wrap a + (x - a) mod (b - a), the remainder taking the
    sign of the divisor (bcnd.ipp detail::periodic:99-110)."""
    w = torch.full((), b - a, dtype=x.dtype, device=x.device)
    r = torch.fmod(x - a, w)
    return a + torch.where((r != 0) & ((r < 0) != (w < 0)), r + w, r)


def adve(cfg: StaticConfig, state: State) -> State:
    """SD advection by the implicit, euler or pred_corr scheme
    (reference adve.ipp:169-304); none in a parcel."""
    if cfg.n_dims == 0:
        return state
    scheme = as_t(cfg.adve_scheme)
    pos = (state.x, state.y, state.z)
    if scheme in (as_t.implicit, as_t.euler):
        fn = _axis_implicit if scheme == as_t.implicit else _axis_euler
        x, y, z = _advance(cfg, state, state.ijk, *pos, fn)
        return dataclasses.replace(state, x=x, y=y, z=z)
    # predictor-corrector (adve.ipp:184-304): a forward-Euler predictor,
    # z kept inside the domain, x (and y) wrapped with the old position
    # shifted alike, then the mean of the two displacements
    x_old, y_old, z_old = pos
    x, y, z = _advance(cfg, state, state.ijk, *pos, _axis_euler)
    if cfg.n_dims > 1:
        z = torch.clamp(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    x_wr = _wrap(x, cfg.x0, cfg.x1)
    x_old = x_old + (x_wr - x)
    x = x_wr
    if cfg.n_dims == 3:
        y_wr = _wrap(y, cfg.y0, cfg.y1)
        y_old = y_old + (y_wr - y)
        y = y_wr
    dx_, dy_, dz_ = _advance(cfg, state, ijk_of_xyz(cfg, x, y, z), x, y, z,
                             _euler_disp)
    upd = dict(x=(x + x_old + dx_) / 2.0)
    if cfg.n_dims == 3:
        upd["y"] = (y + y_old + dy_) / 2.0
    if cfg.n_dims > 1:
        upd["z"] = (z + z_old + dz_) / 2.0
    return dataclasses.replace(state, **upd)


def sedi(state: State, dt) -> State:
    """z -= dt * vt (reference sedi.ipp:13-24)."""
    return dataclasses.replace(state, z=state.z - dt * state.vt)


def subs(cfg: StaticConfig, state: State, w_LS, dt) -> State:
    """Large-scale subsidence from the per-level profile ``w_LS`` (a
    tensor, positive downwards; reference subs.ipp:39-51)."""
    return dataclasses.replace(state,
                               z=state.z - dt * w_LS[state.ijk % cfg.nz])


def bcnd(cfg: StaticConfig, state: State, x_walls=True) -> State:
    """The walls and the puddle (reference bcnd.ipp:214-365): periodic or
    open side walls (x, and y on the 3-D grid); on the 2-D and 3-D grids
    periodic top and bottom, or droplets above the top removed and those
    below the bottom added to the puddle (with ice_switch the frozen ones'
    mass and number too, with chem_switch their dissolved masses) and
    removed.  None in a parcel.  ``x_walls`` False leaves x to a shard's
    ring migration (libcloudphxx_tpu/parallel/decomp.py:335-379)."""
    if cfg.n_dims == 0:
        return state
    x, y, z, n = state.x, state.y, state.z, state.n
    if not cfg.open_side_walls:
        if x_walls:
            x = _wrap(x, cfg.x0, cfg.x1)
        if cfg.n_dims == 3:
            y = _wrap(y, cfg.y0, cfg.y1)
    else:
        if x_walls:
            n = torch.where((x >= cfg.x1) | (x < cfg.x0), 0.0, n)
        if cfg.n_dims == 3:
            n = torch.where((y >= cfg.y1) | (y < cfg.y0), 0.0, n)
    puddle = state.puddle
    if cfg.n_dims > 1 and cfg.periodic_topbot_walls:
        z = _wrap(z, cfg.z0, cfg.z1)
    elif cfg.n_dims > 1:
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
        if cfg.ice_switch:
            # frozen SDs reaching the ground (bcnd.ipp:301-327)
            nfi = torch.where(state.ice_a > 0, nf, 0.0)
            fold[OUT_ICE_MASS] = torch.sum(nfi * ice_mass(
                state.ice_a, state.ice_c, state.ice_rho))
            fold[OUT_ICE_NUM] = torch.sum(nfi)
        if cfg.chem_switch:
            # the dissolved masses rain out too (bcnd.ipp:330-340)
            fold[:8] = torch.sum(nf * state.chem, dim=1)
        puddle = puddle + fold
        n = torch.where(fell, 0.0, n)
    return dataclasses.replace(state, x=x, y=y, z=z, n=n, puddle=puddle)


def post_step(cfg: StaticConfig, state: State) -> State:
    """Re-bin every SD into the cell of its position (the reference's
    post_copy hskpng_ijk, post_copy.ipp:18-36); dead slots go to cell 0.
    None in a parcel."""
    if cfg.n_dims == 0:
        return state
    ijk = ijk_of_xyz(cfg, state.x, state.y, state.z)
    return dataclasses.replace(state,
                               ijk=torch.where(state.n > 0, ijk, 0))
