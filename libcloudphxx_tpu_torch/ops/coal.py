"""The coalescence substep loop, in place of the coal phase of the resident
TPU kernel (libcloudphxx_tpu/ops/pallas_step.py:233-336) and of the
standalone one (libcloudphxx_tpu/ops/pallas_coal.py:99).

On the card both run as kernel E (csrc/coal.cu), beside its plain PyTorch
version:

  coal_resident / coal_resident_plain      the phase of the resident step,
      between condensation and transport.  "stride" pairing (the default):
      one shuffle every n_strides substeps, then lane i pairs with lane
      i ^ 2**(substep % n_strides).  "sort" pairing: a shuffle every
      substep and adjacent pairs; a lane id rides the shuffles in place of
      x/z, and one final unsort puts every SD back in its lane.
  coal_standalone / coal_standalone_plain  the loop of dense.coal: vt
      refreshed before every shuffle, x/z/vt ride it, adjacent pairs, no
      unsort.

The random numbers are Philox draws (ops/philox.py) keyed by (seed, row)
with the counter (step, substep, kind, lane); on a shard of the x-slab
mesh the resident form's ``row0`` makes the row the global one, so that
the shards draw what the serial step draws.  The shuffle sorts each row
on a key that cannot tie, (bits << 16 | lane) with dead lanes keyed above
every live one, so that any correct sort (torch.sort here, a bitonic
network in the kernel) gives the same permutation.

Dispatch is by device, as in ops/step.py: CPU tensors run the plain
version, CUDA tensors launch the kernel (float32, contiguous, a power-of-
two row capacity up to MAX_CAP, or the wrapper raises), and ``plain=True``
runs the plain version on any device.  Under vohl_davis_no_waals, whose
efficiency table is wider than the hall family's 128 (wide_table), the
resident form launches E's wide-table form (_ext.COAL_VOHL).  On the 3-D
grid the resident form carries the y plane (``y``), which rides as x and
z do: E's y forms _ext.COAL_3D and _ext.COAL_VOHL_3D, a row over
coal_y_plan's warps (csrc/coal_y.cuh).  The 2-D rows above capacity 128
take the same warp rows without the y plane (_ext.COAL_WARP_ROWS and
_ext.COAL_VOHL_WARP_ROWS, row r drawing as row0 + r): a one-warp pass over
the rows whose droplets lie in their first 128 slots, cap / 128 warps for
the others (resident_kernel names each route).  Under the
turbulent kernels (onishi_hall, onishi_hall_davis_no_waals) it launches
E's onishi form, _ext.COAL_ONISHI (the y plane riding on the 3-D grid):
the hall table's efficiency times Wang's enhancement times the
geometric kernel, at dissipation rate 0, as the JAX dense engine
computes them in XLA (libcloudphxx_tpu/lgrngn/dense.py:606, :738; its
TPU kernel refuses them, :1221-1225).  Every form returns a per-row
overflow flag: some pair of the row asked for more than one collision
in a substep (lane 6 of the TPU kernel's per-block flags,
pallas_step.py:527).
"""

from typing import NamedTuple

import torch

from .. import _ext
from ..common import constants as c
from ..lgrngn import coalescence as coal_mod
from ..lgrngn import dense
from ..lgrngn.enums import kernel_t, vt_t
from ..lgrngn.vterm import vt_in_kernel
from . import philox

MAX_CAP = 512        # kernel E: 16 register slots a lane of a warp a row
PAIRINGS = ("stride", "sort")
Y_ROW_SLOTS = 128    # kernel E's y and onishi forms: the slots of a warp


class CoalYPlan(NamedTuple):
    """How kernel E's y and onishi forms (csrc/coal_y.cuh) lay a row out:
    over ``warps`` warps of ``slots`` register slots a lane, row slot j in
    warp j // 128, lane j % 32, register slot (j % 128) // 32."""
    warps: int
    slots: int


def coal_y_plan(cap):
    """The y and onishi forms' row at row capacity ``cap`` (a power of two
    up to MAX_CAP): one warp of cap / 32 register slots (at least 1) up to
    cap 128, the one-warp row of E's other forms; above it cap / 128 warps
    of 4, so that a lane holds no more than 4 slots and a stride pair (the
    partner j ^ 2**k, k < 6) or a sort pair (2i, 2i + 1) never crosses a
    warp.  The kernels pick the same from cap (coal_y.cuh with_y_form).
    Above cap 128 a row whose droplets all lie in its first 128 slots runs
    first, as a one-warp row of 4 slots a lane over those 128 (its dead
    slots past them never move: the same bits), and only the others take
    this plan's warps (a second launch over the rows the first queued)."""
    if cap < 1 or cap & (cap - 1) or cap > MAX_CAP:
        raise ValueError(f"coal: the row capacity must be a power of two up "
                         f"to {MAX_CAP}, got {cap}")
    return CoalYPlan(max(1, cap // Y_ROW_SLOTS),
                     max(1, min(cap, Y_ROW_SLOTS) // 32))


def n_strides_of(cap):
    """How many XOR strides (1, 2, 4, ...) a shuffle serves: up to cap/4
    and at most 6 (pallas_step.py:252-255); 6 at cap 128."""
    n = 1
    while (1 << n) <= cap // 4 and n < 6:
        n += 1
    return n


def shuffle_key(bits, alive):
    """The tie-free shuffle key of each lane: the 32 random bits above the
    lane index, dead lanes above every live one."""
    lane = torch.arange(bits.shape[-1], device=bits.device)
    return (torch.where(alive, bits, 1 << 32) << 16) | lane


def shuffle_rows(key, planes):
    """Sort each row ascending by ``key`` (no ties) with ``planes`` riding
    (the counterpart of pallas_coal.bitonic_sort_rows).  Returns
    (sorted key, planes)."""
    key, order = torch.sort(key, dim=1)
    return key, tuple(torch.gather(p, 1, order) for p in planes)


def _draws(seed, step, like, row0=0):
    n_cell, cap = like.shape
    return lambda s, kind: philox.draw(seed, step, s, kind, n_cell, cap,
                                       like.device, row0)


def coal_resident_plain(cfg, params, sstp_coal, dt, seed, step, n, rw2, rd3,
                        kpa, x, z, T, p, rhod, eta, dv, pairing="stride",
                        row0=0, y=None):
    """The coalescence phase of the resident step (pallas_step.py:233-336):
    ``sstp_coal`` substeps of dt/sstp_coal on the (n_cell, cap) planes,
    with the cell fields (n_cell,) after condensation, in ``pairing``
    "stride" or "sort"; row r draws as row ``row0`` + r.  On the 3-D grid
    the y plane ``y`` rides with x and z (libcloudphxx_tpu/lgrngn/
    dense.py:801-804).  Returns (n, rw2, rd3, kpa, x, z, overflow), with
    ``y`` (n, rw2, rd3, kpa, x, z, y, overflow)."""
    col = lambda a: a[:, None]
    T, p, rhod, eta, dv = (col(a) for a in (T, p, rhod, eta, dv))
    dt_sub = dt / sstp_coal
    coal_mod.require_resident(cfg.kernel)
    eff = coal_mod.efficiency(cfg.kernel, n.dtype, n.device)
    draw = _draws(seed, step, n, row0)
    ovf = torch.zeros(n.shape[0], dtype=torch.bool, device=n.device)
    pos = (x, z) + (() if y is None else (y,))
    if pairing == "stride":
        n_strides = n_strides_of(n.shape[1])
        for s in range(sstp_coal):
            if s % n_strides == 0:
                key = shuffle_key(draw(s, philox.SHUFFLE), n > 0)
                _, (n, rw2, rd3, kpa, *pos) = shuffle_rows(
                    key, (n, rw2, rd3, kpa, *pos))
            vt = vt_in_kernel(cfg, rw2, T, p, rhod, eta)
            u = philox.u01(draw(s, philox.BERNOULLI), n.dtype)
            n, rw2, rd3, kpa, o = dense.pair_and_collide_stride(
                cfg, params, (n, rw2, rd3, kpa, vt), 1 << (s % n_strides),
                dv, rhod, eta, dt_sub, u, eff)
            ovf = ovf | o
        return (n, rw2, rd3, kpa, *pos, ovf)
    lane_id = torch.arange(n.shape[1], device=n.device).expand(n.shape)
    for s in range(sstp_coal):
        key = shuffle_key(draw(s, philox.SHUFFLE), n > 0)
        _, (n, rw2, rd3, kpa, lane_id) = shuffle_rows(
            key, (n, rw2, rd3, kpa, lane_id))
        vt = vt_in_kernel(cfg, rw2, T, p, rhod, eta)
        count = torch.sum(n > 0, dim=1, keepdim=True).to(n.dtype)
        u = philox.u01(draw(s, philox.BERNOULLI), n.dtype)
        n, rw2, rd3, kpa, o = dense.pair_and_collide(
            cfg, params, (n, rw2, rd3, kpa, vt), count, dv, rhod, eta,
            dt_sub, u, eff)
        ovf = ovf | o
    _, (n, rw2, rd3, kpa) = shuffle_rows(lane_id, (n, rw2, rd3, kpa))
    return (n, rw2, rd3, kpa, *pos, ovf)


def coal_standalone_plain(cfg, params, sstp_coal, dt, seed, step, n, rw2,
                          rd3, kpa, x, z, T, p, rhod, eta, dv):
    """The standalone loop (pallas_coal.py:99-152): per substep vt from
    rw2, a shuffle with vt, x and z riding, adjacent pairs.  Returns (n,
    rw2, rd3, kpa, vt, x, z, overflow), vt refreshed after the last
    substep."""
    col = lambda a: a[:, None]
    T, p, rhod, eta, dv = (col(a) for a in (T, p, rhod, eta, dv))
    dt_sub = dt / sstp_coal
    coal_mod.require_resident(cfg.kernel)
    eff = coal_mod.efficiency(cfg.kernel, n.dtype, n.device)
    draw = _draws(seed, step, n)
    ovf = torch.zeros(n.shape[0], dtype=torch.bool, device=n.device)
    for s in range(sstp_coal):
        vt = vt_in_kernel(cfg, rw2, T, p, rhod, eta)
        key = shuffle_key(draw(s, philox.SHUFFLE), n > 0)
        _, (n, rw2, rd3, kpa, vt, x, z) = shuffle_rows(
            key, (n, rw2, rd3, kpa, vt, x, z))
        count = torch.sum(n > 0, dim=1, keepdim=True).to(n.dtype)
        u = philox.u01(draw(s, philox.BERNOULLI), n.dtype)
        n, rw2, rd3, kpa, o = dense.pair_and_collide(
            cfg, params, (n, rw2, rd3, kpa, vt), count, dv, rhod, eta,
            dt_sub, u, eff)
        ovf = ovf | o
    vt = vt_in_kernel(cfg, rw2, T, p, rhod, eta)
    return n, rw2, rd3, kpa, vt, x, z, ovf


def wide_table(cfg):
    """Whether kernel E reads the collision kernel's efficiencies in its
    wide-table form (vohl_davis_no_waals: a table wider than the hall
    family's 128, at row stride K + 2)."""
    t = coal_mod.clamped_efficiency_table(kernel_t(cfg.kernel))
    return t is not None and t[0].shape[1] != coal_mod.NARROW


def resident_kernel(cfg, cap, three=False):
    """The kernel coal_resident launches for ``cfg``'s collision kernel at
    row capacity ``cap`` (on the 3-D grid with ``three``): the onishi form
    under the turbulent kernels; the y forms on the 3-D grid; above
    capacity 128 the 2-D warp rows of coal_y.cuh; else E's one-warp row
    (csrc/coal.cuh), each in its narrow or its wide-table (vohl) form."""
    if kernel_t(cfg.kernel) in coal_mod.TURBULENT:
        return _ext.COAL_ONISHI
    wide = wide_table(cfg)
    if three:
        return _ext.COAL_VOHL_3D if wide else _ext.COAL_3D
    if cap > Y_ROW_SLOTS:
        return _ext.COAL_VOHL_WARP_ROWS if wide else _ext.COAL_WARP_ROWS
    return _ext.COAL_VOHL if wide else _ext.COAL


def _launch(kernel, cfg, params, sstp_coal, dt, seed, step, planes, cells,
            n_outs, *mode):
    """Check what kernel E takes, launch it and return its n_outs planes
    and the overflow flags.  A y form's ``mode`` ends with the y plane in
    and out (or None twice), which the wrapper checks."""
    n_cell, cap = planes[0].shape
    _ext.check_planes(kernel.name, cap, *planes)
    if cap & (cap - 1) or cap > MAX_CAP:
        raise ValueError(f"{kernel.name}: the row capacity must be a power of "
                         f"two up to {MAX_CAP}, got {cap}")
    kern = kernel_t(cfg.kernel)
    coal_mod.require_resident(kern)
    eff = coal_mod.efficiency(kern, torch.float32, planes[0].device)
    cells = torch.stack(cells)
    if cells.shape != (5, n_cell):
        raise ValueError(f"{kernel.name}: cell fields must be ({n_cell},)")
    _ext.check(kernel.name, *planes, cells)
    # golovin's pi * 4/3 * b, geometric's multiplier, the onishi kernels'
    # params[0] (the dissipation rate of Wang's table, physics.cuh
    # CollisionKernel)
    coef = 1.0
    if kern == kernel_t.golovin:
        coef = c.pi * 4.0 / 3.0 * float(params[0])
    elif kern == kernel_t.geometric and len(params):
        coef = float(params[0])
    elif kern in coal_mod.TURBULENT:
        coef = float(params[0])
    outs = tuple(torch.empty_like(planes[0]) for _ in range(n_outs))
    ovf = torch.empty(n_cell, dtype=torch.bool, device=cells.device)
    kernel.launch(
        *(a.data_ptr() for a in planes), cells.data_ptr(),
        eff.table.data_ptr() if eff else None,
        *(o.data_ptr() for o in outs), ovf.data_ptr(), n_cell, cap,
        int(sstp_coal), dt / sstp_coal, kern.value, coef,
        eff.r_max_um - 1e-6 if eff else 0.0, eff.clamp if eff else 0,
        int(seed) & philox.MASK, int(step) & philox.MASK,
        vt_t(cfg.terminal_velocity).value, *mode)
    return outs + (ovf,)


def coal_resident(cfg, params, sstp_coal, dt, seed, step, n, rw2, rd3, kpa,
                  x, z, T, p, rhod, eta, dv, *, pairing="stride", row0=0,
                  y=None, plain=False):
    """Kernel E in the resident step's form, or coal_resident_plain (same
    arguments and results): on the 3-D grid (``y``) its y forms, under the
    turbulent kernels its onishi form, above capacity 128 its 2-D warp
    rows (resident_kernel).  Row r draws as the global row ``row0`` + r (a
    shard's of the x-slab mesh) in every form but the y forms, which run
    on the grid's own rows."""
    if pairing not in PAIRINGS:
        raise ValueError(f"coal: pairing must be one of {PAIRINGS}, got "
                         f"{pairing!r}")
    args = (cfg, params, sstp_coal, dt, seed, step, n, rw2, rd3, kpa, x, z,
            T, p, rhod, eta, dv)
    if not 0 <= int(row0) <= philox.MASK - n.shape[0]:
        raise ValueError(f"coal: row0 {row0} out of range")
    if _ext.use_plain("coal", n, plain):
        return coal_resident_plain(*args, pairing=pairing, row0=row0, y=y)
    kernel = resident_kernel(cfg, n.shape[1], three=y is not None)
    planes, cells = (n, rw2, rd3, kpa, x, z), (T, p, rhod, eta, dv)
    sort = int(pairing == "sort")
    if kernel in (_ext.COAL, _ext.COAL_VOHL):
        return _launch(kernel, cfg, params, sstp_coal, dt, seed, step,
                       planes, cells, 6, sort, int(row0))
    # coal_y.cuh's warp rows: the y forms on the grid's rows only (the
    # x-slab mesh is 2-D); above capacity 128 the queue's scratch
    if row0 and y is not None:
        raise ValueError("coal: the y forms take no row0")
    if y is not None:
        _ext.check_planes("coal", n.shape[1], n, y)
        _ext.check("coal", n, y)
    y_out = None if y is None else torch.empty_like(y)
    queue = torch.empty(n.shape[0] + 1, dtype=torch.int32, device=n.device) \
        if n.shape[1] > Y_ROW_SLOTS else None
    ptr = lambda a: None if a is None else a.data_ptr()
    # the y forms take no row0, the 2-D warp rows no y plane
    three = kernel in (_ext.COAL_3D, _ext.COAL_VOHL_3D)
    mode = (sort,) + (() if three else (int(row0),)) + (
        () if kernel in (_ext.COAL_WARP_ROWS, _ext.COAL_VOHL_WARP_ROWS)
        else (ptr(y), ptr(y_out))) + (ptr(queue),)
    *outs, ovf = _launch(kernel, cfg, params, sstp_coal, dt, seed, step,
                         planes, cells, 6, *mode)
    return (*outs,) + (() if y is None else (y_out,)) + (ovf,)


def coal_standalone(cfg, params, sstp_coal, dt, seed, step, n, rw2, rd3, kpa,
                    x, z, T, p, rhod, eta, dv, *, plain=False):
    """Kernel E in the standalone form, or coal_standalone_plain (same
    arguments and results)."""
    args = (cfg, params, sstp_coal, dt, seed, step, n, rw2, rd3, kpa, x, z,
            T, p, rhod, eta, dv)
    if _ext.use_plain("coal_standalone", n, plain):
        return coal_standalone_plain(*args)
    if wide_table(cfg) or kernel_t(cfg.kernel) in coal_mod.TURBULENT:
        raise NotImplementedError(
            f"coal_standalone: the standalone form of kernel E computes the "
            f"formula kernels and the hall family's 128-wide tables only, "
            f"not {kernel_t(cfg.kernel).name} (the resident step's forms, "
            f"coal_resident, compute it)")
    *outs, ovf = _launch(_ext.COAL_STANDALONE, cfg, params, sstp_coal, dt,
                         seed, step, (n, rw2, rd3, kpa, x, z),
                         (T, p, rhod, eta, dv), 7)
    n, rw2, rd3, kpa, x, z, vt = outs
    return n, rw2, rd3, kpa, vt, x, z, ovf
