"""Dense cell-major SD layout and the fused model step
(libcloudphxx_tpu/lgrngn/dense.py).

The population lives in a dense occupancy matrix of shape (n_cell, cap):
row (i*ny + j)*nz + k holds the super-droplets of cell (i, j, k) (ny = 1
and j = 0 on the 2-D grid, whose row is i*nz + k), and multiplicity
n == 0 marks an empty slot.  Per-cell reductions are row reductions; only
the re-binning after transport moves droplets between rows.  On the 3-D
grid each SD also carries its y (the plane after z, as in the JAX
package's attrs_of).

The state is never updated in place: every step returns a new DenseState,
so a caller may keep an old one (a benchmark restores its initial state).
Its random stream goes with it: the coalescence draws are Philox numbers
keyed by the state's seed and step counter (ops/philox.py), so restoring a
state restores the draws that follow it.
The per-cell closure (the JAX package's dense._Tpr) is hskpng.hskpng_Tpr.

With exact_sstp_cond the population also carries each SD's private
ambient state (its th, rv, rhod and p at the last sstp_save) as four more
planes, sd_th, sd_rv, sd_rh and sd_p (attrs_of): the per-particle
substepping reads them (step_cond_exact, step_cond_adaptive: kernel G's
fixed-count or adaptive form on the card, one launch a phase over the
rows), and they ride every re-binning, so that an SD that moved keeps its
old cell's snapshot.

A step may defer its re-binning (step_fused(..., defer=True), the JAX
package's deferred-x pipeline, LIBCLOUD_DEFER_X): the state then carries
kernel C's planes and each slot's target row (DenseState.pending_tgt),
and the next step's condensation merges the rows first (kernel B's
merge-prologue form), so that a steady deferred step launches no kernel D.
flush_merge runs the pending merge (kernel D); repack, unpack and every
phase that is not a deferred step flush first.  The merge's inputs are
the immediate path's, so a deferred run, once flushed, is bitwise the
default run.
"""

import dataclasses

import torch

from ..common import constants as c
from ..ops import coal as coal_ops
from ..ops import cond as cond_ops
from ..ops.step import rebin_x, step_resident
from . import coalescence as coal_mod
from .condensation import apply_drv_to_th_rv, exact_route, third_moment
from .enums import as_t, kernel_t
from .hskpng import T_p, hskpng_mfp, hskpng_Tpr, ijk_of_xyz
from .state import (OUT_COAL_OVERFLOW, OUT_DRY_VOL, OUT_LIQ_NUM, OUT_LIQ_VOL,
                    OUT_PRTCL_NUM, State, StaticConfig)

ATTRS = ("n", "rw2", "rd3", "kpa", "vt", "x", "z")
# the 3-D grid's plane (libcloudphxx_tpu/lgrngn/dense.py:211-216)
Y_ATTRS = ("y",)
# the exact mode's private ambient planes, and the flat State's names for
# them (libcloudphxx_tpu/lgrngn/dense.py:205-216)
EXACT_ATTRS = ("sd_th", "sd_rv", "sd_rh", "sd_p")
_FLAT_NAME = {"sd_th": "sstp_tmp_th", "sd_rv": "sstp_tmp_rv",
              "sd_rh": "sstp_tmp_rh", "sd_p": "sstp_tmp_p"}


def attrs_of(cfg: StaticConfig):
    """The per-SD planes of the dense layout for ``cfg``: ATTRS, y on the
    3-D grid, and in exact_sstp_cond mode the four private ambient
    planes."""
    return ATTRS + (Y_ATTRS if cfg.n_dims == 3 else ()) \
        + (EXACT_ATTRS if cfg.exact_sstp_cond else ())


def supported(cfg: StaticConfig):
    """The dense engine's capability matrix: raise NotImplementedError,
    with the reason, for a configuration it does not run.  It is the JAX
    package's (libcloudphxx_tpu/lgrngn/dense.py:116 _supported), on what
    kernels B-E and G take: the 2-D and the 3-D grid, warm, every
    condensation substepping mode (percell, exact fixed-count with or
    without in-cell mixing, adaptive), every SD advection scheme
    (implicit, euler, pred_corr: kernel C's forms, each in 2-D and 3-D),
    every terminal velocity formula, and every collision kernel: the
    formula kernels and the hall family, vohl (kernel E's wide-table
    form) and the turbulent onishi kernels at dissipation rate 0, as the
    JAX dense engine computes them (its XLA coalescence, dense.py:606,
    :738; kernel E's onishi form), on any population, const-multi
    included.  SGS supersaturation (turb_cond_switch) and
    diag_incloud_time go to the flat engine, as in the JAX package
    (lgrngn/dense_front.dense_capable); the front hands the other SGS
    switches' async phases to it step by step.  The parcel and the 1-D
    grid run on the flat engine in both packages."""
    if cfg.n_dims not in (2, 3):
        raise NotImplementedError(
            "dense engine: 2-D/3-D only (the parcel and the 1-D grid run on "
            "the flat engine, as in the JAX package)")
    if cfg.ice_switch or cfg.chem_switch or cfg.turb_cond_switch:
        raise NotImplementedError("dense engine: ice/chem/SGS not supported")
    if cfg.diag_incloud_time:
        raise NotImplementedError("dense engine: diag_incloud_time off only")


def defer_ok(cfg: StaticConfig):
    """Whether step_fused(..., defer=True) defers the re-binning for
    ``cfg``: where the JAX package's deferred-x pipeline runs, the static
    part of its eligibility (libcloudphxx_tpu/lgrngn/dense.py:1209
    resident_static_ok): the 2-D grid with the merge's distinct columns (nx
    >= 3), no exact mode, implicit or euler advection, and with
    coalescence the golovin, geometric or long kernel or a table of the
    hall family (vohl's wider table and the onishi kernels excluded).
    Elsewhere the switch runs the ordinary step, as the JAX package
    ignores LIBCLOUD_DEFER_X there."""
    kern = kernel_t(cfg.kernel)
    if cfg.coal_switch and kern not in (
            kernel_t.golovin, kernel_t.geometric, kernel_t.long):
        table = coal_mod.clamped_efficiency_table(kern)
        if kern in coal_mod.TURBULENT or table is None \
                or table[0].shape[1] != coal_mod.NARROW:
            return False
    return (cfg.n_dims == 2 and cfg.nx >= 3 and not cfg.exact_sstp_cond
            and as_t(cfg.adve_scheme) in (as_t.implicit, as_t.euler))


def _no_plane():
    return torch.zeros((0, 0))


def _no_tgt():
    return torch.zeros((0, 0), dtype=torch.int32)


@dataclasses.dataclass
class DenseState:
    """Cell-major SD population and per-cell thermodynamics.

    SD planes (n_cell, cap); cell fields (n_cell,); courants in the
    flattened staggered layout ((nx+1)*ny*nz, nx*(ny+1)*nz and
    nx*ny*(nz+1), with ny = 1 on the 2-D grid).  Slot order within a row
    carries no meaning.  The y plane is (n_cell, cap) on the 3-D grid and
    courant_y the y courants there; both are empty otherwise.  The
    private ambient planes sd_th, sd_rv, sd_rh and sd_p are (n_cell, cap)
    in exact_sstp_cond mode and empty (0, 0) otherwise.  A shard of the
    x-slab mesh under pred_corr advection also carries its courants in the
    halo-2 layout (halo_cx, halo_cz: parallel/decomp.xchng_courants_pc),
    which its corrector reads; they are empty otherwise.

    ``pending_tgt`` is empty unless the step that made the state deferred
    its re-binning (step_fused(..., defer=True)): it is then kernel C's
    int32 target row of every slot (-1 for none), the planes are C's, not
    yet merged, and ``overflow`` does not yet count the merge's drops.  It
    is the counterpart of the JAX package's ``xkey``, the x classification
    that its deferred x pass carries (lgrngn/dense.py DenseState.xkey);
    flush_merge runs the merge."""

    n: torch.Tensor
    rw2: torch.Tensor
    rd3: torch.Tensor
    kpa: torch.Tensor
    vt: torch.Tensor
    x: torch.Tensor
    z: torch.Tensor
    rhod: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    RH: torch.Tensor
    eta: torch.Tensor
    dv: torch.Tensor
    sstp_tmp_th: torch.Tensor
    sstp_tmp_rv: torch.Tensor
    courant_x: torch.Tensor
    courant_z: torch.Tensor
    puddle: torch.Tensor      # (N_PUDDLE,), slots as state.PUDDLE_KEYS
    overflow: torch.Tensor    # 0-d int64: SDs dropped because a row was full
    y: torch.Tensor = dataclasses.field(default_factory=_no_plane)
    courant_y: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(0))
    sd_th: torch.Tensor = dataclasses.field(default_factory=_no_plane)
    sd_rv: torch.Tensor = dataclasses.field(default_factory=_no_plane)
    sd_rh: torch.Tensor = dataclasses.field(default_factory=_no_plane)
    sd_p: torch.Tensor = dataclasses.field(default_factory=_no_plane)
    halo_cx: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(0))
    halo_cz: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(0))
    # the coalescence draws: Philox key (opts_init.rng_seed) and the step
    # counter, host integers advanced by every coalescence call
    rng_seed: int = 44
    rng_step: int = 0
    pending_tgt: torch.Tensor = dataclasses.field(default_factory=_no_tgt)
    # how many times the global re-bin (the far-mover repair) ran on this
    # population
    rebins: int = 0

    @property
    def cap(self):
        return self.n.shape[1]

    @property
    def n_cell(self):
        return self.n.shape[0]


def _distribute(n_cell, cap, cell, vals):
    """Stable-sort flat SD slots by target cell and scatter them into
    (n_cell, cap) planes; cell == n_cell marks slots to drop.  Returns
    (planes, number of SDs that did not fit their row)."""
    cell_s, order = torch.sort(cell, stable=True)
    counts = torch.bincount(cell_s, minlength=n_cell + 1)
    starts = torch.cumsum(counts, 0) - counts
    lane = torch.arange(cell.numel(), device=cell.device) - starts[cell_s]
    in_dom = cell_s < n_cell
    fits = in_dom & (lane < cap)
    # slots that do not land go to one extra dump element, cut off below
    dst = torch.where(fits, cell_s * cap + lane, n_cell * cap)
    planes = []
    for v in vals:
        out = torch.zeros(n_cell * cap + 1, dtype=v.dtype, device=v.device)
        out.scatter_(0, dst, v[order])
        planes.append(out[:-1].reshape(n_cell, cap))
    return planes, torch.sum(in_dom & (lane >= cap))


def pack(cfg: StaticConfig, state: State, cap: int) -> DenseState:
    """Flat State -> DenseState (one stable sort by cell + scatter; dead
    slots are dropped).  The cell fields, the puddle and the random stream
    carry over.  In exact_sstp_cond mode the flat State's snapshot is per
    SD and becomes the sd_* planes; the cell fields sstp_tmp_th/rv then
    take the State's th and rv (the JAX package carries the per-SD arrays
    there, dense.py:219-236, which no dense phase reads)."""
    attrs = attrs_of(cfg)
    cell = torch.where(state.n > 0, state.ijk, cfg.n_cell)
    planes, overflow = _distribute(
        cfg.n_cell, cap, cell,
        [getattr(state, _FLAT_NAME.get(a, a)) for a in attrs])
    cells = {k: getattr(state, k) for k in (
        "rhod", "p", "T", "RH", "eta", "dv", "sstp_tmp_th", "sstp_tmp_rv",
        "courant_x", "courant_z", "puddle")}
    if cfg.n_dims == 3:
        cells["courant_y"] = state.courant_y
    if cfg.exact_sstp_cond:
        cells.update(sstp_tmp_th=state.th, sstp_tmp_rv=state.rv)
    return DenseState(
        **dict(zip(attrs, planes)), **cells, overflow=overflow,
        rng_seed=state.rng_seed, rng_step=state.rng_step)


def repack(cfg: StaticConfig, d: DenseState, new_cap: int) -> DenseState:
    """The population in a new row capacity (libcloudphxx_tpu/lgrngn/
    dense.py:239; one stable sort by row and a scatter, as pack): each
    row keeps its droplets in their lane order, and the droplets a row
    cannot hold are added to ``overflow``.  The occupancy-aware repack
    policy of Kinematic2D.run_device_lgrngn uses it so that the capacity
    follows the population.  A pending merge runs first (flush_merge; the
    JAX package's repack flushes its deferred x pass, dense.py:245-258)."""
    d = flush_merge(cfg, d)
    n_cell, cap = d.n.shape
    attrs = attrs_of(cfg)
    flat = [getattr(d, a).reshape(-1) for a in attrs]
    rows = torch.arange(n_cell, device=d.n.device).repeat_interleave(cap)
    planes, overflow = _distribute(n_cell, new_cap,
                                   torch.where(flat[0] > 0, rows, n_cell),
                                   flat)
    return dataclasses.replace(d, overflow=d.overflow + overflow,
                               **dict(zip(attrs, planes)))


def unpack(cfg: StaticConfig, d: DenseState, state: State) -> State:
    """DenseState -> flat State (libcloudphxx_tpu/lgrngn/dense.py:262): the
    live SDs first, in row order, then dead slots, n_sd_max of them; th/rv
    are the values saved at the end of the last step, and the random
    stream carries over.  In exact_sstp_cond mode the sd_* planes become
    the State's per-SD snapshot; otherwise the snapshot is the saved cell
    values.  Stepping never creates SDs, so the live ones fit.  A pending
    merge runs first (flush_merge)."""
    d = flush_merge(cfg, d)
    n_cell, cap = d.n.shape
    attrs = attrs_of(cfg)
    flat = {a: getattr(d, a).reshape(-1) for a in attrs}
    alive = flat["n"] > 0
    rows = torch.arange(n_cell, device=d.n.device).repeat_interleave(cap)
    _, order = torch.sort((~alive).to(torch.int8), stable=True)
    n_sd = state.n_sd_max
    keep = order[:n_sd]
    pad = n_sd - keep.numel()

    def take(a):
        out = a[keep]
        return torch.cat([out, out.new_zeros(pad)]) if pad > 0 else out

    upd = {_FLAT_NAME.get(a, a): take(flat[a]) for a in attrs}
    upd["ijk"] = take(torch.where(alive, rows, 0))
    if not cfg.exact_sstp_cond:
        upd.update(sstp_tmp_th=d.sstp_tmp_th, sstp_tmp_rv=d.sstp_tmp_rv,
                   sstp_tmp_rh=d.rhod)
    return dataclasses.replace(
        state, **upd, th=d.sstp_tmp_th, rv=d.sstp_tmp_rv, p=d.p, T=d.T,
        RH=d.RH, eta=d.eta, puddle=d.puddle, rng_seed=d.rng_seed,
        rng_step=d.rng_step)


def _row_courants(cfg: StaticConfig, d: DenseState):
    """Per-cell left/right/below/above courants (n_cell,) sliced from the
    staggered fields (reference init_grid.ipp:94-155; libcloudphxx_tpu/
    lgrngn/dense.py:894-906); the columns are d's rows (a mesh shard holds
    fewer than cfg.nx)."""
    ny, nz = cfg.ny, cfg.nz
    nx = d.n_cell // (ny * nz)
    cx = d.courant_x.reshape(nx + 1, ny * nz)
    cz = d.courant_z.reshape(nx * ny, nz + 1)
    return (cx[:-1].reshape(-1), cx[1:].reshape(-1),
            cz[:, :-1].reshape(-1), cz[:, 1:].reshape(-1))


def _y_axis(cfg: StaticConfig, d: DenseState):
    """On the 3-D grid (y, C_f, C_h): the y plane and each row's
    front/hind courants, sliced from the staggered courant_y (nx, ny+1,
    nz), as kernel C's 3-D forms take them (ops/step.transport ``y3``);
    None on the 2-D grid."""
    if cfg.n_dims != 3:
        return None
    cy = d.courant_y.reshape(cfg.nx, cfg.ny + 1, cfg.nz)
    return (d.y, cy[:, :-1].reshape(-1), cy[:, 1:].reshape(-1))


def _rebin_global(cfg: StaticConfig, d: DenseState, tgt=None) -> DenseState:
    """Exact re-bin of every SD to the cell of its position (one global
    sort): the repair after SDs moved more than one cell on an axis.
    ``tgt``, the row of every slot (d.n_cell where dead), is computed from
    the positions unless given (a shard of the x-slab mesh gives its
    own)."""
    if tgt is None:
        y = d.y if cfg.n_dims == 3 else None
        tgt = torch.where(d.n > 0, ijk_of_xyz(cfg, d.x, y, d.z), d.n_cell)
    attrs = attrs_of(cfg)
    planes, overflow = _distribute(
        d.n_cell, d.cap, tgt.reshape(-1),
        [getattr(d, a).reshape(-1) for a in attrs])
    return dataclasses.replace(d, overflow=d.overflow + overflow,
                               rebins=d.rebins + 1,
                               **dict(zip(attrs, planes)))


# --------------------------------------------------------------- cond ----
def _rows(shape, *cells):
    """The (n_cell,) cell fields ``cells`` as contiguous (n_cell, cap)
    planes, made in one copy."""
    planes = torch.stack(cells)[:, :, None].expand(len(cells), *shape)
    return planes.contiguous().unbind(0)


def _close_rows(cfg: StaticConfig, d: DenseState, rw2, th, rv, p, live):
    """The nomixing cell closure (condensation.apply_drv_to_th_rv): the
    change of each row's specific third moment between d.rw2 and ``rw2``
    over its live SDs, the row sums in float64
    (libcloudphxx_tpu/lgrngn/dense.py:386-388), leaves rv, and theta
    follows."""
    wgt = d.n / (d.dv * d.rhod)[:, None]
    rowsum = lambda a: torch.sum(a, dim=1, dtype=torch.float64)
    mom3 = lambda r: third_moment(wgt, r, live, rowsum)
    drv = ((mom3(rw2) - mom3(d.rw2)) * (4.0 / 3) * c.pi * c.rho_w).to(
        th.dtype)
    return apply_drv_to_th_rv(cfg, th, rv, d.rhod, p, drv)


def _sstp_save(cfg: StaticConfig, d: DenseState, rw2, th, rv, p):
    """The exact mode's sstp_save (libcloudphxx_tpu/lgrngn/dense.py:
    409-423): the private planes take the updated cell th/rv and rhod,
    sd_p the pre-condensation ``p``; the cell T/p/RH/eta the
    post-condensation closure."""
    T2, p2, RH2, eta2 = hskpng_Tpr(cfg, th, rv, d.rhod, d.p)
    sd_th, sd_rv, sd_rh, sd_p = _rows(d.n.shape, th, rv, d.rhod, p)
    return dataclasses.replace(
        d, rw2=rw2, T=T2, p=p2, RH=RH2, eta=eta2, sstp_tmp_th=th,
        sstp_tmp_rv=rv, sd_th=sd_th, sd_rv=sd_rv, sd_rh=sd_rh, sd_p=sd_p)


def _private(d: DenseState):
    """The planes kernel G's two forms take (ops/cond.py SD_NAMES)."""
    return (d.n, d.rw2, d.rd3, d.kpa, d.vt, d.sd_th, d.sd_rv, d.sd_rh,
            d.sd_p)


def step_cond(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max, *,
              plain=False):
    """The per-particle condensation phase on the dense layout
    (libcloudphxx_tpu/lgrngn/dense.py:305-314 in exact mode with more
    than one substep, exact_route): step_cond_adaptive with
    adaptive_sstp_cond, else step_cond_exact.  ``th``/``rv`` are the
    advected cell fields; returns (DenseState, th, rv), th/rv the
    post-condensation cell values.  The per-cell modes run in kernel B
    (_resident_step)."""
    if not exact_route(cfg):
        raise ValueError("dense.step_cond: per-particle substepping needs "
                         "exact_sstp_cond and sstp_cond (or sstp_cond_act) "
                         "> 1; the per-cell modes run in step_resident")
    f = step_cond_adaptive if cfg.adaptive_sstp_cond else step_cond_exact
    return f(cfg, d, th, rv, dt, RH_max, plain=plain)


def step_cond_exact(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max, *,
                    plain=False):
    """Exact per-particle condensation substepping, cell-major
    (libcloudphxx_tpu/lgrngn/dense.py:317-424): kernel G's fixed-count
    form over the (n_cell, cap) rows, one launch (ops/cond.py
    perparticle_fixed; its plain version the flat engine's
    condensation.perparticle_fixed_core over the planes, sstp_cond_mix's
    row sums of drv and dth in float64).  The cell then takes, with
    mixing, the largest private value among its live SDs (values that
    agree to rounding), without it the change of its liquid water.  Dead
    slots are masked out of every row sum.  Ends with the exact-mode
    sstp_save."""
    # the closure of the advected fields; the mean free paths come from
    # the previous step's T/p, as the flat step_cond_body's
    _, p = T_p(cfg, th, rv, d.rhod, d.p)
    live = d.n > 0
    rw2, tmp_rv, tmp_th, _, _ = cond_ops.perparticle_fixed(
        cfg, dt, RH_max, _private(d), (th, rv, d.rhod, p, d.dv, d.T, d.p),
        plain=plain)
    if cfg.sstp_cond_mix:
        # the cell takes its SDs' common private state (update_state,
        # particles_impl_update_th_rv.ipp:283-297)
        any_live = live.any(1)
        pick = lambda v, cell: torch.where(
            any_live, torch.where(live, v, -float("inf")).amax(1), cell)
        th_c, rv_c = pick(tmp_th, th), pick(tmp_rv, rv)
    else:
        th_c, rv_c = _close_rows(cfg, d, rw2, th, rv, p, live)
    return _sstp_save(cfg, d, rw2, th_c, rv_c, p), th_c, rv_c


def step_cond_adaptive(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max,
                       *, plain=False):
    """Adaptive per-SD condensation substepping on the dense layout
    (libcloudphxx_tpu/lgrngn/dense.py:427-488): kernel G's adaptive form
    over the (n_cell, cap) rows, one launch (ops/cond.py
    perparticle_adaptive; its plain version the flat engine's
    condensation.perparticle_adaptive_core over the ravelled planes), the
    cell closes on the change of its liquid water, and the exact-mode
    sstp_save follows."""
    T, p = T_p(cfg, th, rv, d.rhod, d.p)
    rw2, *_ = cond_ops.perparticle_adaptive(
        cfg, dt, RH_max, _private(d), (th, rv, d.rhod, p, d.dv, d.T, d.p, T),
        plain=plain)
    th_c, rv_c = _close_rows(cfg, d, rw2, th, rv, p, d.n > 0)
    return _sstp_save(cfg, d, rw2, th_c, rv_c, p), th_c, rv_c


# --------------------------------------------------------------- coal ----
def _lshift(a):
    """a[:, i+1] with the last lane repeated."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _rshift(a):
    """a[:, i-1] with the first lane repeated."""
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _rshift_mask(m):
    """m[:, i-1] with False injected at lane 0."""
    return torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], dim=1)


def _turb(cfg, rhod_row, eta_row):
    """What the turbulent (onishi) kernels read of a row: its density and
    viscosity at dissipation rate 0, as the JAX dense engine gives them
    (libcloudphxx_tpu/lgrngn/dense.py:606, :738); None for the other
    kernels."""
    if kernel_t(cfg.kernel) in coal_mod.TURBULENT:
        return (rhod_row, eta_row, 0.0)
    return None


def pair_and_collide(cfg, params, sorted_vals, count, dv_row, rhod_row,
                     eta_row, dt, u01, eff=None):
    """Adjacent pairing after the shuffle and the Shima collision math on
    (rows, cap) planes (libcloudphxx_tpu/lgrngn/dense.py:574; reference
    particles_impl_coal.ipp:98-546).  ``sorted_vals`` is (n, rw2, rd3, kpa,
    vt) in shuffled lane order with the live SDs first, ``count`` (rows, 1)
    the live SDs of each row, ``u01`` the Bernoulli draws; lane 2j pairs
    with lane 2j+1 and takes the draw of lane 2j.  ``eff`` the hall
    family's efficiencies (coalescence.efficiency); ``rhod_row`` and
    ``eta_row`` the rows' density and viscosity, which the turbulent
    kernels read (_turb).  Returns (n, rw2, rd3, kpa, overflow), overflow
    (rows,) True where a pair asked for more than one collision."""
    n_a, rw2_a, rd3_a, kpa_a, vt_a = sorted_vals
    # Shima 2009 sec 5.1.3 scale factor (coal.ipp:99-107)
    half = torch.floor(count / 2)
    scale = torch.where(count > 1, count * (count - 1) / 2.0 / half, 0.0)
    lane = torch.arange(n_a.shape[-1], device=n_a.device)
    is_pair = (lane % 2 == 0) & (lane + 1 < count)
    b = tuple(_lshift(v) for v in sorted_vals)
    a_is_big = n_a >= b[0]
    happened, n_big_new, rw2_new, rd3_new, kpa_new, overflow = \
        coal_mod.shima(cfg, params, sorted_vals, b, a_is_big, is_pair, u01,
                       dt, dv_row, scale, eff, _turb(cfg, rhod_row, eta_row))
    # lane 2j holds the pair's outcome; lane 2j+1 reads it shifted
    hp, bigp = _rshift_mask(happened), _rshift(a_is_big)
    n_s = torch.where(happened & a_is_big, n_big_new, n_a)
    n_s = torch.where(hp & ~bigp, _rshift(n_big_new), n_s)
    out = [n_s]
    for own, new in ((rw2_a, rw2_new), (rd3_a, rd3_new), (kpa_a, kpa_new)):
        v = torch.where(happened & ~a_is_big, new, own)
        out.append(torch.where(hp & bigp, _rshift(new), v))
    return (*out, overflow)


def _xor_partner(a, stride, lane):
    """a[:, lane ^ stride] for a power-of-two ``stride``."""
    fwd = torch.roll(a, -stride, dims=1)
    bwd = torch.roll(a, stride, dims=1)
    return torch.where((lane & stride) == 0, fwd, bwd)


def pair_and_collide_stride(cfg, params, vals, stride, dv_row, rhod_row,
                            eta_row, dt, u01, eff=None):
    """Shima collision math with XOR-stride partners: lane i pairs with
    lane i ^ stride, and the lane with the stride bit clear carries the
    pair's draw (libcloudphxx_tpu/lgrngn/dense.py:673; see
    pair_and_collide_partners).  Returns (n, rw2, rd3, kpa, overflow)."""
    lane = torch.arange(vals[0].shape[-1], device=vals[0].device)
    partners = tuple(_xor_partner(a, stride, lane) for a in vals)
    is_a = (lane & stride) == 0
    u_b = _xor_partner(u01, stride, lane)
    return pair_and_collide_partners(
        cfg, params, vals, partners, is_a, dv_row, rhod_row, eta_row, dt,
        u01, u_b, eff)


def pair_and_collide_partners(cfg, params, vals, partners, is_a, dv_row,
                              rhod_row, eta_row, dt, u01, u01_b, eff=None):
    """The symmetric collision math of pair_and_collide_stride given the
    partner planes (libcloudphxx_tpu/lgrngn/dense.py:711): every lane holds
    one SD of a pair and computes its own outcome; pairs with a dead SD are
    skipped, and the scale k(k-1)/2 / n_pairs over the k live SDs keeps the
    collision count unbiased for any number of pairs.  ``is_a`` marks the
    lane whose draw the pair uses (``u01`` own draws, ``u01_b`` the
    partner's).  Returns (n, rw2, rd3, kpa, overflow)."""
    n_a = vals[0]
    n_b = partners[0]
    alive = n_a > 0
    pair_ok = alive & (n_b > 0)
    one, zero = torch.ones_like(n_a), torch.zeros_like(n_a)
    count = torch.sum(torch.where(alive, one, zero), dim=-1, keepdim=True)
    npairs = torch.sum(torch.where(pair_ok & is_a, one, zero), dim=-1,
                       keepdim=True)
    scale = torch.where((count > 1) & (npairs > 0),
                        count * (count - 1) / 2.0
                        / torch.clamp(npairs, min=1.0), 0.0)
    u_pair = torch.where(is_a, u01, u01_b)
    # roles are symmetric, with an is_a tiebreak on equal n
    self_is_big = (n_a > n_b) | ((n_a == n_b) & is_a)
    happened, n_big_new, rw2_new, rd3_new, kpa_new, overflow = \
        coal_mod.shima(cfg, params, vals, partners, self_is_big, pair_ok,
                       u_pair, dt, dv_row, scale, eff,
                       _turb(cfg, rhod_row, eta_row))
    small = happened & ~self_is_big
    return (torch.where(happened & self_is_big, n_big_new, n_a),
            torch.where(small, rw2_new, vals[1]),
            torch.where(small, rd3_new, vals[2]),
            torch.where(small, kpa_new, vals[3]), overflow)


def coal(cfg: StaticConfig, d: DenseState, params, dt, sstp_coal: int, *,
         plain=False) -> DenseState:
    """The sstp_coal coalescence loop with the terminal velocity refreshed
    every substep, on its own (libcloudphxx_tpu/lgrngn/dense.py:855): kernel
    E in its standalone form (ops/coal.coal_standalone; the TPU's
    pallas_coal kernel), on the 2-D grid (no y plane rides it; the step's
    coalescence, ops/coal.coal_resident, carries it).  The overflow flag
    is folded into the puddle."""
    if cfg.n_dims == 3:
        raise NotImplementedError(
            "dense.coal: the standalone coalescence loop carries no y plane "
            "(the 3-D grid's coalescence runs in step_fused and "
            "step_async_resident)")
    d = flush_merge(cfg, d)
    n, rw2, rd3, kpa, vt, x, z, ovf = coal_ops.coal_standalone(
        cfg, params, sstp_coal, dt, d.rng_seed, d.rng_step, d.n, d.rw2,
        d.rd3, d.kpa, d.x, d.z, d.T, d.p, d.rhod, d.eta, d.dv, plain=plain)
    return dataclasses.replace(
        d, n=n, rw2=rw2, rd3=rd3, kpa=kpa, vt=vt, x=x, z=z,
        puddle=_fold_coal_overflow(d.puddle, ovf.any()),
        rng_step=d.rng_step + 1)


def _fold_coal_overflow(puddle, flag):
    """The sticky coalescence overflow flag in its puddle slot (the
    reference's increase_sstp_coal request, coal.ipp:224-227)."""
    slot = torch.zeros_like(puddle)
    slot[OUT_COAL_OVERFLOW] = flag.to(puddle.dtype)
    return torch.maximum(puddle, slot)


def step_fused(cfg: StaticConfig, d: DenseState, th_adv, rv_adv, params, dt,
               RH_max, sstp_coal: int, do_coal: bool, do_sedi: bool, mp=None,
               *, coal_pairing="stride", defer=False, plain=False):
    """One whole microphysics step (libcloudphxx_tpu/lgrngn/dense.py:1283):
    condensation substeps, coalescence substeps, transport and walls
    (step_resident), the re-binning merge (rebin_x), the puddle fold and,
    when some SD moved more than one cell on an axis, the global re-bin.
    In exact mode with more than one substep the condensation is
    step_cond's per-particle substepping, where the JAX package runs its
    XLA step_cond and step_async (dense.py:1232, :1650).
    Same phase order as the reference step_sync + step_async
    (particles_step.ipp:161-494).  ``params`` are
    opts_init.kernel_parameters; ``coal_pairing`` "stride" (the default) or
    "sort" (ops/coal.coal_resident).  Returns (DenseState, th, rv).

    ``defer`` (the JAX package's LIBCLOUD_DEFER_X) leaves the re-binning
    pending where defer_ok(cfg): the state carries C's targets in
    pending_tgt, the next deferred step merges the rows in its first
    launch (kernel B's merge-prologue form), and flush_merge, repack,
    unpack or any other phase runs the merge (kernel D); a far mover
    flushes and re-bins at once, as the JAX package's repair does
    (dense.py:1581-1594).

    ``mp`` = (gc_x, gc_z, G, n_iters, fct) (the JAX package's mp=,
    LIBCLOUD_MPDATA_FUSE) also advects the step's th and rv for the next
    step, and the result is (DenseState, th, rv, th_adv, rv_adv) with the
    advected fields (nx, nz): in kernel D's MPDATA-epilogue form where the
    step launches D's seven-plane form, else kernel A (_mp_apply), as on
    the deferred path."""
    return _resident_phases(
        cfg, d, th_adv, rv_adv, params, dt, RH_max, sstp_coal,
        do_cond=True, do_coal=do_coal, do_adve=True, do_sedi=do_sedi,
        w_cells=None, coal_pairing=coal_pairing, defer=defer, mp=mp,
        plain=plain)


def step_fused_shard(cfg: StaticConfig, d: DenseState, th_adv, rv_adv, params,
                     dt, RH_max, sstp_coal: int, do_coal: bool, do_sedi: bool,
                     slab, *, coal_pairing="stride", plain=False):
    """step_fused less the re-binning, with x left unwrapped: the body of a
    shard of the dense x-slab mesh (libcloudphxx_tpu/lgrngn/dense.py:1303
    step_fused_shard and :1337 _shard_phase; parallel/dense_mesh.py).
    ``cfg`` is the global configuration; ``d`` holds the shard's rows, the
    global columns col0, col0 + 1, ... with ``slab`` = (col0, ncol) the
    first ncol of them its own, and x in global coordinates.  Condensation,
    coalescence (its draws keyed by the global row, E's onishi form too)
    and kernel C's unwrapped form, which gives the droplets that leave the
    slab target -1 (under pred_corr its pred_corr form on a slab, which
    reads d's halo-2 courants), and the puddle fold; no merge and no far-mover repair: the mesh's
    re-binning (parallel/dense_mesh.rebin_sharded) does both.  Returns (d,
    th, rv, tgt, far): d with the positions after transport, tgt the local
    target row of every slot and far the number of rows with a far mover
    (a 0-d tensor, for the caller to read with the other shards')."""
    return _resident_step(
        cfg, d, th_adv, rv_adv, params, dt, RH_max, sstp_coal, do_cond=True,
        do_coal=do_coal, do_adve=True, do_sedi=do_sedi, w_cells=None,
        coal_pairing=coal_pairing, plain=plain, slab=slab)


def step_cond_resident(cfg: StaticConfig, d: DenseState, th_adv, rv_adv, dt,
                       RH_max, *, plain=False):
    """The condensation phase alone (libcloudphxx_tpu/lgrngn/dense.py:1400),
    the cond half of step_fused for the public API's step_cond
    (lgrngn/dense_front): kernel B and the cell closure, or in exact mode
    step_cond's per-particle substepping; positions, vt and the
    multiplicities stay.  Returns (DenseState, th, rv) with the
    post-condensation cell values, saved in sstp_tmp_th/rv for the async
    phase."""
    return _resident_phases(
        cfg, d, th_adv, rv_adv, (), dt, RH_max, 1, do_cond=True,
        do_coal=False, do_adve=False, do_sedi=False, w_cells=None,
        plain=plain)


def step_async_resident(cfg: StaticConfig, d: DenseState, params, dt,
                        sstp_coal: int, do_coal: bool, do_sedi: bool,
                        do_adve: bool = True, do_subs: bool = False,
                        w_LS=None, *, coal_pairing="stride",
                        plain=False) -> DenseState:
    """The async phase alone (libcloudphxx_tpu/lgrngn/dense.py:1414), the
    rest of step_fused for the public API's step_async: the closure of the
    saved post-condensation th/rv, the coalescence substeps, then vt and
    the advection, sedimentation and subsidence (``w_LS``, the
    positive-downwards profile by level) with the walls, the puddle and the
    re-binning; with none of the three only the vt refresh."""
    w_cells = None
    if do_subs and w_LS is not None:
        k = torch.arange(cfg.n_cell, device=d.n.device) % cfg.nz
        w_cells = torch.as_tensor(w_LS, dtype=d.n.dtype,
                                  device=d.n.device)[k]
    d, _, _ = _resident_phases(
        cfg, d, d.sstp_tmp_th, d.sstp_tmp_rv, params, dt, 44.0, sstp_coal,
        do_cond=False, do_coal=do_coal, do_adve=do_adve, do_sedi=do_sedi,
        w_cells=w_cells, coal_pairing=coal_pairing, plain=plain)
    return d


def _resident_phases(cfg: StaticConfig, d: DenseState, th_adv, rv_adv,
                     params, dt, RH_max, sstp_coal: int, *, do_cond: bool,
                     do_coal: bool, do_adve: bool, do_sedi: bool, w_cells,
                     coal_pairing="stride", defer=False, mp=None,
                     plain=False):
    """The dispatcher behind step_fused, step_cond_resident and
    step_async_resident (libcloudphxx_tpu/lgrngn/dense.py:1444-1631): one
    step_resident call with the phase flags, then, where anything moved,
    the puddle fold, the merge (rebin_x) and the far-mover repair.
    ``w_cells`` (n_cell,) is the subsidence velocity of each row, or None.
    ``defer`` and ``mp`` are step_fused's.  Returns (DenseState, th, rv),
    and with ``mp`` the advected th and rv after them."""
    moves = do_adve or do_sedi or w_cells is not None
    deferring = defer and do_cond and moves and defer_ok(cfg)
    if not deferring:
        d = flush_merge(cfg, d, plain=plain)
    d, th, rv, tgt, far = _resident_step(
        cfg, d, th_adv, rv_adv, params, dt, RH_max, sstp_coal,
        do_cond=do_cond, do_coal=do_coal, do_adve=do_adve, do_sedi=do_sedi,
        w_cells=w_cells, coal_pairing=coal_pairing, plain=plain)
    if tgt is None:
        return _mp_apply(mp, cfg, d, th, rv, plain)
    if cfg.nx < 3 or (cfg.n_dims == 3 and cfg.ny < 3):
        # the merge needs distinct left, own and right columns (and front,
        # own and hind rows of columns); as in the JAX package's rebin,
        # dense.py:1162-1165
        return _mp_apply(mp, cfg, _rebin_global(cfg, d), th, rv, plain)
    adv = ()
    if deferring:
        # the merge waits for the next step's first launch (or a flush);
        # the advected pair then comes from kernel A, as the JAX package's
        # deferred path does (dense.py:1596-1607)
        d = dataclasses.replace(d, pending_tgt=tgt)
    elif mp is not None and len(attrs_of(cfg)) == len(ATTRS):
        # the pair rides D's launch (its MPDATA-epilogue form)
        d, *adv = merge(cfg, d, tgt, mpdata=(th, rv) + tuple(mp),
                        plain=plain)
    else:
        d = merge(cfg, d, tgt, plain=plain)
    if bool(far > 0):  # one host sync a step: far movers are rare
        d = _rebin_global(cfg, flush_merge(cfg, d, plain=plain))
    if adv:
        return (d, th, rv) + tuple(adv)
    return _mp_apply(mp, cfg, d, th, rv, plain)


def _mp_apply(mp, cfg: StaticConfig, d: DenseState, th, rv, plain):
    """(d, th, rv), and with ``mp`` = (gc_x, gc_z, G, n_iters, fct) th and
    rv advected for the next step by kernel A after them: the paths
    without D's MPDATA-epilogue form (libcloudphxx_tpu/lgrngn/dense.py:1429
    _mp_apply)."""
    if mp is None:
        return d, th, rv
    from ..models import mpdata
    gc_x, gc_z, G, n_iters, fct = mp
    tha, rva = mpdata.advect2(
        th.reshape(cfg.nx, cfg.nz), rv.reshape(cfg.nx, cfg.nz), gc_x, gc_z,
        G, n_iters=int(n_iters), fct=bool(fct), plain=plain)
    return d, th, rv, tha, rva


def flush_merge(cfg: StaticConfig, d: DenseState, *, plain=False):
    """Run a deferred step's pending merge (kernel D) and clear
    pending_tgt: the counterpart of the JAX package's flush_xmerge
    (libcloudphxx_tpu/lgrngn/dense.py:1634).  A no-op when nothing is
    pending."""
    if d.pending_tgt.numel() == 0:
        return d
    return dataclasses.replace(merge(cfg, d, d.pending_tgt, plain=plain),
                               pending_tgt=_no_tgt())


def merge(cfg: StaticConfig, d: DenseState, tgt, *, mpdata=None,
          plain=False):
    """Each row takes the droplets whose target ``tgt`` it is (rebin_x,
    kernel D: on the 3-D grid its 3-D form, from 27 rows with the y plane
    riding; in exact mode the forms with the private planes riding); the
    droplets a full row cannot hold are added to ``overflow``.  With
    ``mpdata`` (rebin_x's: D's MPDATA-epilogue form) returns (d, th_adv,
    rv_adv)."""
    attrs = attrs_of(cfg)
    out = rebin_x(
        cfg, *(getattr(d, a) for a in ATTRS), tgt,
        extra=tuple(getattr(d, a) for a in attrs[len(ATTRS):]),
        mpdata=mpdata, plain=plain)
    drops = out[len(attrs)]
    d = dataclasses.replace(
        d, overflow=d.overflow + drops.sum().to(d.overflow.dtype),
        **dict(zip(attrs, out)))
    return d if mpdata is None else (d,) + tuple(out[len(attrs) + 1:])


def _resident_step(cfg: StaticConfig, d: DenseState, th_adv, rv_adv, params,
                   dt, RH_max, sstp_coal: int, *, do_cond: bool,
                   do_coal: bool, do_adve: bool, do_sedi: bool, w_cells,
                   coal_pairing, plain, slab=None):
    """_resident_phases up to the re-binning: the step_resident call and
    the puddle fold; in exact mode with more than one substep step_cond
    first and step_resident without its condensation.  Returns (d, th,
    rv, tgt, far): with transport d holds
    the positions after it, tgt the target row of every slot and far the
    number of rows with a far mover (a 0-d tensor); with none tgt and far
    are None.  ``slab`` is a mesh shard's (step_fused_shard)."""
    closure = None
    if do_cond and exact_route(cfg):
        # the per-particle substepping (kernel G a substep), then the rest
        # of the step as the async phase: the closure of the saved
        # post-condensation th/rv, E and C (the JAX package runs its XLA
        # step_cond and step_async here, dense.py:1650)
        d, th, rv = step_cond(cfg, d, th_adv, rv_adv, dt, RH_max,
                              plain=plain)
        if not (do_coal or do_adve or do_sedi or w_cells is not None):
            return d, th, rv, None, None
        do_cond = False
        # the async phase's closure of the saved th/rv is the one the
        # sstp_save just computed, but under th_std with a variable
        # pressure (there it starts from the new p)
        if cfg.th_dry or cfg.const_p:
            closure = (d.T, d.p, d.RH, d.eta)
    # mean free paths from the previous step's T/p (dense.py:1519)
    lam_D, lam_K = hskpng_mfp(d.T, d.p) if do_cond else (None, None)
    y3 = _y_axis(cfg, d)
    # a deferred merge rides this step's first launch (kernel B's
    # merge-prologue form); _resident_phases flushed it unless the step
    # defers, which implies condensation
    pending = d.pending_tgt if d.pending_tgt.numel() else None
    (n, rw2, rd3, kpa, vt, x, z, tgt, th, rv, T, p, RH, eta, rowinfo,
     *y) = step_resident(
        cfg, cfg.sstp_cond, dt, RH_max, do_sedi, d.n, d.rw2, d.rd3, d.kpa,
        d.x, d.z, th_adv, rv_adv, d.sstp_tmp_th, d.sstp_tmp_rv, d.rhod, d.dv,
        lam_D, lam_K, *_row_courants(cfg, d), d.p, do_cond=do_cond,
        do_coal=do_coal, do_adve=do_adve, w_cells=w_cells, params=params,
        sstp_coal=sstp_coal, rng=(d.rng_seed, d.rng_step),
        coal_pairing=coal_pairing, slab=slab, closure=closure,
        courants=(d.halo_cx, d.halo_cz) if slab is not None else (
            (d.courant_x, d.courant_z)
            + ((d.courant_y,) if y3 is not None else ())),
        y3=y3, pending_tgt=pending, vt=d.vt, plain=plain)
    puddle, overflow = d.puddle, d.overflow
    if rowinfo is not None:
        info = rowinfo.sum(dim=0).to(puddle.dtype)
        fold = torch.zeros_like(puddle)
        fold[[OUT_LIQ_VOL, OUT_DRY_VOL, OUT_LIQ_NUM, OUT_PRTCL_NUM]] = \
            info[:4]
        puddle = puddle + fold
        if do_coal:
            puddle = _fold_coal_overflow(puddle, info[6] > 0)
        if pending is not None:  # the merge's drops (rowinfo's lane 5)
            overflow = overflow + rowinfo[:, 5].sum().to(overflow.dtype)
    exact = {}
    if do_cond and cfg.exact_sstp_cond:
        # exact mode at one substep ran the per-cell kernel B: the private
        # planes take the new cell values (dense.py:540-548)
        exact = dict(zip(EXACT_ATTRS, _rows(n.shape, th, rv, d.rhod, p)))
    # no transport: no walls, no re-bin; after condensation alone the stale
    # vt plane stays (dense.py:1550-1558)
    d = dataclasses.replace(
        d, n=n, rw2=rw2, rd3=rd3, kpa=kpa, vt=d.vt if vt is None else vt,
        x=x, z=z, T=T, p=p, RH=RH, eta=eta, sstp_tmp_th=th, sstp_tmp_rv=rv,
        puddle=puddle, overflow=overflow, pending_tgt=_no_tgt(),
        rng_step=d.rng_step + int(do_coal), **exact,
        **dict(zip(Y_ATTRS, y)))
    return d, th, rv, tgt, None if tgt is None else info[4]


def moment(d: DenseState, rng_lo2, rng_hi2, power, specific=True):
    """Per-cell wet-radius moment over an rw^2 range, a row reduction
    (the dense diag_wet_rng + diag_wet_mom, particles_impl_moms.ipp).
    The rows must be merged (flush_merge)."""
    if d.pending_tgt.numel():
        raise ValueError("moment: the state's re-binning is pending; "
                         "dense.flush_merge it first")
    sel = (d.n > 0) & (d.rw2 >= rng_lo2) & (d.rw2 < rng_hi2)
    nf = torch.where(sel, d.n, 0.0)
    if power == 0:
        vals = nf
    else:
        vals = nf * torch.where(sel, d.rw2, 1.0) ** (power / 2.0)
    mom = torch.sum(vals, dim=1)
    if specific:
        mom = mom / (d.dv * d.rhod)
    return mom


def water_dry_totals(d: DenseState, rv):
    """Total water mass [kg] (vapour + liquid + puddle) and dry-aerosol
    volume sum [n*rd^3] with the puddle, in float64 (the bench.py
    conservation checks)."""
    f = lambda a: a.to(torch.float64)
    vap = torch.sum(f(d.rhod) * f(d.dv) * f(rv).reshape(-1))
    alive = d.n > 0
    liq = (4.0 / 3) * c.pi * c.rho_w * torch.sum(
        torch.where(alive, f(d.n) * f(d.rw2) ** 1.5, 0.0))
    liq = liq + c.rho_w * f(d.puddle[OUT_LIQ_VOL])
    dry = torch.sum(torch.where(alive, f(d.n) * f(d.rd3), 0.0)) \
        + f(d.puddle[OUT_DRY_VOL]) / ((4.0 / 3) * c.pi)
    return float(vap + liq), float(dry)
