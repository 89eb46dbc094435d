"""MPDATA advection on a 2-D (x, z) cell-centred grid
(libcloudphxx_tpu/models/mpdata.py).

A donor-cell pass followed by antidiffusive corrective iterations
(Smolarkiewicz 1984), with a density-like G factor, periodic x and rigid
z walls, and an optional non-oscillatory (FCT) limiter.  The port takes the
JAX package's defaults and has no switches for its A/B variants: the exact
zero test in the ratio guard, the edge-copy z halo, no antidiffusive flux
through the walls, FCT extrema over both the field before and after the
donor pass.

Fields: psi (nx, nz) cell-centred; gc_x (nx+1, nz) and gc_z (nx, nz+1)
G-weighted Courant numbers on the staggered faces; G (nx, nz).

On the card ``advect``/``advect2``/``advect_n`` launch kernel A
(csrc/mpdata.cu) once for all their fields, one thread-block cluster a
field as ``launch_plan`` lays it out; on the CPU they run
``_advect_body``, its plain version, a field at a time.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _ext

# dynamic shared memory one CTA can opt into on sm_90 (227 KB)
SMEM_LIMIT = 232448
# the largest cluster kernel A asks for (a non-portable size on sm_90)
MAX_CLUSTER = 16


def _frac(num, den):
    """where(den > 0, num / den, 0): libmpdata++'s positive-definite frac,
    an exact zero test."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _donor_flux(psi_l, psi_r, gc):
    """Upwind flux through a face with G-weighted courant gc."""
    return torch.clamp(gc, min=0.0) * psi_l + torch.clamp(gc, max=0.0) * psi_r


def _pad_x(psi):
    """Periodic halo in x (axis 0)."""
    return torch.cat([psi[-1:], psi, psi[:1]], dim=0)


def _pad_z(psi):
    """Zero-gradient (edge copy) halo in z (axis 1)."""
    return torch.cat([psi[:, :1], psi, psi[:, -1:]], dim=1)


def _advect_once(psi, gc_x, gc_z, G):
    """One upwind pass: psi_new = psi - (dF_x + dF_z) / G."""
    px = _pad_x(psi)
    fx = _donor_flux(px[:-1], px[1:], gc_x)
    pz = _pad_z(psi)
    fz = _donor_flux(pz[:, :-1], pz[:, 1:], gc_z)
    return psi - ((fx[1:] - fx[:-1]) + (fz[:, 1:] - fz[:, :-1])) / G


def _antidiff_gc(psi, gc_x, gc_z, G):
    """Antidiffusive pseudo-velocities (Smolarkiewicz 1984 eqs. 13-14)."""
    px = _pad_x(psi)
    pz = _pad_z(psi)

    # x faces (nx+1, nz)
    A_x = _frac(px[1:] - px[:-1], px[1:] + px[:-1])
    Gx = 0.5 * (_pad_x(G)[:-1] + _pad_x(G)[1:])
    pxz = _pad_z(px)
    up = pxz[1:, 2:] + pxz[:-1, 2:]
    dn = pxz[1:, :-2] + pxz[:-1, :-2]
    B_x = 0.5 * _frac(up - dn, up + dn)
    gcz_p = torch.cat([gc_z[-1:], gc_z, gc_z[:1]], dim=0)
    gcz_at_x = 0.25 * (
        gcz_p[:-1, :-1] + gcz_p[:-1, 1:] + gcz_p[1:, :-1] + gcz_p[1:, 1:])
    gc_x2 = torch.abs(gc_x) * (1.0 - torch.abs(gc_x) / Gx) * A_x \
        - gc_x * gcz_at_x / Gx * B_x

    # z faces (nx, nz+1)
    A_z = _frac(pz[:, 1:] - pz[:, :-1], pz[:, 1:] + pz[:, :-1])
    Gz = 0.5 * (_pad_z(G)[:, :-1] + _pad_z(G)[:, 1:])
    pzx = _pad_x(pz)
    right = pzx[2:, 1:] + pzx[2:, :-1]
    left = pzx[:-2, 1:] + pzx[:-2, :-1]
    B_z = 0.5 * _frac(right - left, right + left)
    gcx_p = torch.cat([gc_x[:, :1], gc_x, gc_x[:, -1:]], dim=1)
    gcx_at_z = 0.25 * (
        gcx_p[:-1, :-1] + gcx_p[1:, :-1] + gcx_p[:-1, 1:] + gcx_p[1:, 1:])
    gc_z2 = torch.abs(gc_z) * (1.0 - torch.abs(gc_z) / Gz) * A_z \
        - gc_z * gcx_at_z / Gz * B_z
    # no antidiffusive flux through the top and bottom walls
    col = torch.arange(gc_z2.shape[1], device=gc_z2.device)
    wall = (col == 0) | (col == gc_z2.shape[1] - 1)
    return gc_x2, torch.where(wall, 0.0, gc_z2)


def _fct_limit(psi_n, psi, gc_x, gc_z, G):
    """Non-oscillatory limiting of the antidiffusive courants
    (Smolarkiewicz & Grabowski 1990 eqs. 14-20).  psi_n is the field
    before the donor-cell pass, psi the field after it."""
    def extrema(f):
        pf, pz = _pad_x(f), _pad_z(f)
        mx = torch.maximum(torch.maximum(pf[:-2], pf[2:]),
                           torch.maximum(torch.maximum(pz[:, :-2], pz[:, 2:]),
                                         f))
        mn = torch.minimum(torch.minimum(pf[:-2], pf[2:]),
                           torch.minimum(torch.minimum(pz[:, :-2], pz[:, 2:]),
                                         f))
        return mx, mn

    mx, mn = extrema(psi)
    mx_n, mn_n = extrema(psi_n)
    psi_max = torch.maximum(mx, mx_n)
    psi_min = torch.minimum(mn, mn_n)

    px, pz = _pad_x(psi), _pad_z(psi)
    fx = _donor_flux(px[:-1], px[1:], gc_x)
    fz = _donor_flux(pz[:, :-1], pz[:, 1:], gc_z)
    pos = lambda a: torch.clamp(a, min=0.0)
    neg = lambda a: torch.clamp(a, max=0.0)
    f_in = pos(fx[:-1]) - neg(fx[1:]) + pos(fz[:, :-1]) - neg(fz[:, 1:])
    f_out = pos(fx[1:]) - neg(fx[:-1]) + pos(fz[:, 1:]) - neg(fz[:, :-1])

    beta_up = _frac((psi_max - psi) * G, f_in)
    beta_dn = _frac((psi - psi_min) * G, f_out)
    bup_x, bdn_x = _pad_x(beta_up), _pad_x(beta_dn)
    bup_z, bdn_z = _pad_z(beta_up), _pad_z(beta_dn)
    one = lambda a: torch.clamp(a, max=1.0)
    lim_x = torch.where(gc_x >= 0.0,
                        one(torch.minimum(bdn_x[:-1], bup_x[1:])),
                        one(torch.minimum(bup_x[:-1], bdn_x[1:])))
    lim_z = torch.where(gc_z >= 0.0,
                        one(torch.minimum(bdn_z[:, :-1], bup_z[:, 1:])),
                        one(torch.minimum(bup_z[:, :-1], bdn_z[:, 1:])))
    return gc_x * lim_x, gc_z * lim_z


def _advect_body(psi, gc_x, gc_z, G, n_iters, fct):
    """Plain version of kernel A for one field."""
    psi_prev = psi
    psi = _advect_once(psi, gc_x, gc_z, G)
    for _ in range(n_iters - 1):
        gc_x, gc_z = _antidiff_gc(psi, gc_x, gc_z, G)
        if fct:
            gc_x, gc_z = _fct_limit(psi_prev, psi, gc_x, gc_z, G)
        psi_prev = psi
        psi = _advect_once(psi, gc_x, gc_z, G)
    return psi


class LaunchPlan(NamedTuple):
    """Kernel A's launch for one field: a cluster of ``ctas`` CTAs, each
    owning ``cols`` x columns (the last one possibly fewer) and the whole
    z extent, with ``smem`` bytes of shared memory."""
    ctas: int
    cols: int
    smem: int


def launch_plan(nx, nz, fct, max_cluster=MAX_CLUSTER):
    """Kernel A's plan for an nx x nz grid: at most ``max_cluster`` CTAs
    and never more than nx, columns split by ceiling and the cluster cut to
    the slabs that hold a column.  A CTA keeps its slab and a halo column a
    side: psi before and after, G, the z courants twice, its x faces twice,
    and with ``fct`` the two betas (csrc/mpdata.cu smem_bytes).  Raises if
    that does not fit a CTA's shared memory."""
    ctas = max(1, min(max_cluster, nx))
    cols = -(-nx // ctas)
    ctas = -(-nx // cols)
    cells, x_faces, z_faces = (cols + 2) * nz, (cols + 1) * nz, \
        (cols + 2) * (nz + 1)
    smem = 4 * ((5 if fct else 3) * cells + 2 * x_faces + 2 * z_faces)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"mpdata: a {nx}x{nz} grid needs {smem} bytes of shared memory a "
            f"CTA ({cols} columns of {nx} in each of {ctas} CTAs), a Hopper "
            f"CTA takes at most {SMEM_LIMIT}")
    return LaunchPlan(ctas, cols, smem)


@functools.lru_cache(maxsize=None)
def _card_plan(nx, nz, fct):
    """launch_plan with a cluster of 16 CTAs where the card holds one, else
    of 8 (the portable size)."""
    plan = launch_plan(nx, nz, fct)
    if plan.ctas > 8:
        count = ctypes.c_int(0)
        _ext.load().lcp_mpdata_clusters(nx, nz, int(fct), *plan,
                                        ctypes.byref(count))
        if count.value < 1:
            plan = launch_plan(nx, nz, fct, max_cluster=8)
    return plan


def _mpdata_cuda(fields, gc_x, gc_z, G, n_iters, fct):
    """Kernel A on a (nfields, nx, nz) stack of fields."""
    nf, nx, nz = fields.shape
    _ext.check("mpdata", fields, gc_x, gc_z, G)
    if gc_x.shape != (nx + 1, nz) or gc_z.shape != (nx, nz + 1) \
            or G.shape != (nx, nz):
        raise ValueError(
            f"mpdata: courants {tuple(gc_x.shape)}/{tuple(gc_z.shape)} and G "
            f"{tuple(G.shape)} do not fit a {nx}x{nz} grid")
    if n_iters < 1:
        raise ValueError(f"mpdata: n_iters must be >= 1, got {n_iters}")
    plan = _card_plan(nx, nz, bool(fct))
    out = torch.empty_like(fields)
    _ext.MPDATA.launch(fields.data_ptr(), out.data_ptr(), gc_x.data_ptr(),
                       gc_z.data_ptr(), G.data_ptr(), nf, nx, nz,
                       int(n_iters), int(fct), *plan)
    return out


def _dispatch(fields, gc_x, gc_z, G, n_iters, fct, plain):
    G = torch.broadcast_to(torch.as_tensor(G, dtype=fields[0].dtype,
                                           device=fields[0].device),
                           fields[0].shape)
    if _ext.use_plain("mpdata", fields[0], plain):
        return tuple(_advect_body(f, gc_x, gc_z, G, n_iters, fct)
                     for f in fields)
    out = _mpdata_cuda(torch.stack(fields), gc_x, gc_z, G.contiguous(),
                       n_iters, fct)
    return tuple(out.unbind(0))


def advect(psi, gc_x, gc_z, G, n_iters=2, fct=False, *, plain=False):
    """MPDATA advection of a positive-definite scalar; n_iters=1 is plain
    upwind, 2 adds one antidiffusive correction (libmpdata++ default);
    ``fct`` applies the non-oscillatory limiter.  ``plain`` runs the plain
    version on any device (kernel comparisons and timings)."""
    return _dispatch((psi,), gc_x, gc_z, G, n_iters, fct, plain)[0]


def advect2(psi_a, psi_b, gc_x, gc_z, G, n_iters=2, fct=False, *,
            plain=False):
    """Advect two scalars sharing the same courants (th and rv of the
    kinematic step) in one kernel launch."""
    return _dispatch((psi_a, psi_b), gc_x, gc_z, G, n_iters, fct, plain)


def advect_n(fields, gc_x, gc_z, G, n_iters=2, fct=False, *, plain=False):
    """Advect a tuple of scalars sharing the same courants (the bulk
    schemes' th, rv, rc, rr and for blk_2m nc, nr) in one kernel launch;
    returns a tuple.  Each field is advected on its own (its own cluster on
    the card), so each comes out bitwise equal to a lone ``advect`` of
    it."""
    return _dispatch(tuple(fields), gc_x, gc_z, G, n_iters, fct, plain)
