"""The flat engine's condensation on the card, in place of the TPU kernel
libcloudphxx_tpu/ops/pallas_cond.py:_kernel (advance_rw2_pallas) at both
kinds of its callers.

Kernel F (csrc/cond_flat.cu, cond_flat) runs the per-cell substep loop of
cond_percell, in place of that kernel and the host loop around it
(libcloudphxx_tpu/lgrngn/condensation.py:312-388): one launch for all
sstp_cond substeps, beside its plain PyTorch version cond_flat_plain, that
host loop.  Both take the SD arrays sorted by cell
(lgrngn/condensation.py _cond_percell_sorted) and the cell fields
(n_cell,).

Kernel G runs the TPU kernel's per-droplet-ambient callers, the exact and
adaptive per-particle substepping, where every super-droplet carries its
own th, rv, rhod and p between substeps.  Its two forms each run a whole
condensation phase in one launch, on either engine's layout (the dense
(n_cell, cap) rows, or the flat engine's cell-sorted segments):
perparticle_fixed (csrc/cond_sd_fixed.cu; cond_perparticle and
dense.step_cond_exact), beside its plain version perparticle_fixed_plain
(lgrngn/condensation.py perparticle_fixed_core), and perparticle_adaptive
(csrc/cond_sd_adaptive.cu; cond_perparticle_adaptive and
dense.step_cond_adaptive), beside perparticle_adaptive_plain
(perparticle_adaptive_core).  Its one-substep entry (csrc/cond_sd.cu,
advance_rw2), the direct counterpart of advance_rw2_pallas, runs one
backward-Euler root find a droplet, beside advance_rw2_plain
(_advance_rw2_core); it advances every slot whose rw2 > 0, as the TPU
kernel does, and keeps the others.  The plain versions of the two forms
call it once a substep (a try), so it is on no path of the card.

Under turb_cond (the SGS supersaturation perturbation ssp added to each
SD's RH) F and G's two forms run their turb_cond forms (csrc/cond_flat.cu
lcp_cond_flat_turb, cond_sd_fixed.cu lcp_cond_sd_fixed_turb,
cond_sd_adaptive.cu lcp_cond_sd_adaptive_turb), which take ssp (and
dot_ssp where it advances) and return it where it changes; their plain
versions are the same plain functions with ssp.

In a parcel (cfg.n_dims == 0: one cell of 1 kg of dry air) F and G's two
forms run their parcel forms (csrc/cond_flat.cu lcp_cond_flat_parcel,
cond_sd_fixed.cu lcp_cond_sd_fixed_parcel, cond_sd_adaptive.cu
lcp_cond_sd_adaptive_parcel, and with turb_cond their _parcel_turb
forms): F weighs a droplet by wgt / (dv rhod) with dv = 1 / rhod at each
substep's rhod, and G feeds an SD's private air the vapour of its
d(rw^3) undivided, where the grid forms take the cell volume dv and
divide by the private air's rhod dv.  Their plain versions are the same
plain functions on a parcel's configuration.

With ice_switch F runs its ice forms (csrc/cond_flat.cu
lcp_cond_flat_ice, _ice_turb, _parcel_ice, _parcel_ice_turb): the TPU
kernel's ice caller, the substep loop with ice deposition after each
substep's root find (libcloudphxx_tpu/lgrngn/condensation.py:248-305);
they take the sorted ice_a, ice_c and ice_rho and return the new axes and
the last substep's closure th and rv.  Their plain version is
cond_flat_plain with the ice.

Dispatch is by device, as in ops/step.py: CPU tensors run the plain
version, CUDA tensors launch the kernel (float32, contiguous, or the
wrapper raises), and ``plain=True`` runs the plain version on any device,
for comparisons and timings.

On the card kernel F leaves the rw2 of a dead slot (n == 0) as it is,
where its plain version advances any slot whose rw2 > 0 (as kernel B and
its plain version do with the dense rows).  A dead slot's weight is zero,
so the cells do not differ, and every other reader of rw2 weighs or masks
it by n: the diagnostics, coalescence (which parks dead slots past the
last cell), transport's puddle, and dense.pack.  Only the raw dumps,
particles_t.get_attr and save, show a dead slot's rw2, which is then the
kernel's or the plain version's.
"""

import torch

from .. import _ext
from ..common import constants as c
from ..common import theta_dry
from ..lgrngn import condensation, hskpng, turbulence
from ..lgrngn import ice as ice_mod


_FORM_KERNELS = {"cond_flat": "COND_FLAT",
                 "perparticle_fixed": "COND_SD_FIXED",
                 "perparticle_adaptive": "COND_SD_ADAPTIVE"}


def form_kernel(form, parcel, turb, ice=False):
    """The kernel that the wrapper ``form`` (cond_flat, perparticle_fixed
    or perparticle_adaptive) launches: its parcel form where ``parcel``
    (cfg.n_dims == 0), its ice form where ``ice`` (cond_flat under
    ice_switch), its turb_cond form where ``turb``."""
    return getattr(_ext, _FORM_KERNELS[form] + ("_PARCEL" if parcel else "")
                   + ("_ICE" if ice else "") + ("_TURB" if turb else ""))


def cond_flat_plain(cfg, sstp, dt_sub, RH_max, var_rho, sijk, ends, rw2,
                    rd3, kpa, vt, wgt, th, rv, rhod, delta_th, delta_rv,
                    delta_rh, p, dv, lambda_D, lambda_K, ssp=None,
                    dot_ssp=None, ice=None):
    """sstp substeps of the cell-sorted droplets' growth, each closed by the
    cells' latent heat (libcloudphxx_tpu/lgrngn/condensation.py:312-388):
    cell sums as a float64 cumulative sum differenced at the cell ends.
    A droplet weighs wgt / (dv rhod) in its cell's sum; in a parcel
    (cfg.n_dims == 0) dv is the volume of 1 kg of dry air at each
    substep's rhod (:366, through hskpng_Tpr), and ``dv`` is not read.
    With ``ssp`` (turb_cond) each droplet's SGS supersaturation advances by
    dt_sub * dot_ssp at the start of every substep and adds to its cell's
    RH (:353-358).  With ``ice`` = (ice_a, ice_c, ice_rho), sorted, each
    substep then grows the frozen live SDs' axes (lgrngn/ice.py dep_axes,
    at the substep's closure and the rv after the liquid's latent heat)
    and takes the ice mass a cell gains, n 4/3 pi ice_rho d(a^2 c) over dv
    rhod (as wgt ice_rho / rho_w d(a^2 c)), from its rv, and the heat of
    deposition into its th (:248-305, lgrngn/ice.py:106-148).  Returns
    (rw2, th, rv, rhod), then ssp with turb_cond, then with ice the new
    ice_a and ice_c and the th and rv that the last substep's closure took
    (that closure is the cells' T, p, RH and eta after the ice loop,
    :300-305)."""
    lamD_s, lamK_s = lambda_D[sijk], lambda_K[sijk]
    parcel = cfg.n_dims == 0
    if ice is not None:
        ice_a, ice_c, ice_rho = ice
        is_ice = (ice_a > 0) & (ice_c > 0) & (wgt > 0)
        rho_ratio = ice_rho / c.rho_w
    if parcel:
        # a parcel's cell is 1 kg of dry air, whatever ``dv`` holds
        dv = hskpng.parcel_dv(rhod)
    if not var_rho:
        wgt = wgt / (dv * rhod)[sijk]

    g = lambda a: a[sijk]
    for _ in range(sstp):
        th = th + delta_th / sstp
        rv = rv + delta_rv / sstp
        if var_rho:
            rhod = rhod + delta_rh / sstp
        if ssp is not None:
            ssp = turbulence.apply_sgs_supersat(ssp, dot_ssp, dt_sub)
        T, p_, RH, eta = hskpng.hskpng_Tpr(cfg, th, rv, rhod, p)
        RH_sd = g(RH) if ssp is None else g(RH) + ssp
        rw2_new = condensation._advance_rw2_core(
            dt_sub, rw2, rd3, kpa, vt, g(rhod), g(rv), g(T), g(p_), RH_sd,
            g(eta), lamD_s, lamK_s, RH_max)
        drw3 = rw2_new * torch.sqrt(rw2_new) \
            - rw2 * torch.sqrt(torch.clamp(rw2, min=0.0))
        if var_rho:
            # a parcel's dv follows rhod: its cell is 1 kg of dry air
            dv_sub = hskpng.parcel_dv(rhod) if parcel else dv
            wsub = wgt / g(dv_sub * rhod)
        else:
            wsub = wgt
        drv = -condensation.cell_sum(wsub * drw3, ends).to(rw2.dtype)
        th_c, rv_c = th, rv
        th = th + drv * theta_dry.d_th_d_rv(T, th)
        rv = rv + drv
        rw2 = rw2_new
        if ice is not None:
            a_new, c_new = ice_mod.dep_axes(is_ice, ice_a, ice_c, vt,
                                            g(rhod), g(rv), g(T), g(p_),
                                            g(eta), dt_sub, RH_max)
            dm = torch.where(is_ice, wsub * (rho_ratio * ice_mod.dep_volume(
                ice_a, ice_c, a_new, c_new)), 0.0)
            d_ice = condensation.cell_sum(dm, ends).to(rw2.dtype)
            rv = rv - d_ice
            th = th - d_ice * theta_dry.d_th_d_rv_dep(T, th)
            ice_a, ice_c = a_new, c_new
    return (rw2, th, rv, rhod) + (() if ssp is None else (ssp,)) \
        + (() if ice is None else (ice_a, ice_c, th_c, rv_c))


def cond_flat(cfg, sstp, dt_sub, RH_max, var_rho, sijk, ends, rw2, rd3, kpa,
              vt, wgt, th, rv, rhod, delta_th, delta_rv, delta_rh, p, dv,
              lambda_D, lambda_K, ssp=None, dot_ssp=None, ice=None, *,
              plain=False):
    """Kernel F, or its plain version cond_flat_plain (same arguments and
    results).  ``sijk`` the sorted cells of the SDs, ``ends`` the last
    sorted position of each cell (condensation.cell_ends); ``rw2`` ...
    ``wgt`` the sorted SD arrays (``wgt`` = n * 4/3 pi rho_w); th, rv and
    rhod the cells at the last sstp_save, the deltas the step's increments,
    ``p`` the pressure the closure takes, ``dv`` the cell volumes.
    ``var_rho`` substeps rhod and the weights with it.  With the sorted
    ``ssp`` and ``dot_ssp`` (turb_cond) it runs F's turb_cond form and
    returns ssp too.  With the sorted ``ice`` = (ice_a, ice_c, ice_rho)
    (ice_switch) it runs F's ice form, which deposits after each substep's
    liquid growth, and returns the new ice_a and ice_c and the last
    substep's closure th and rv too (cond_flat_plain).  Returns (rw2, th,
    rv, rhod[, ssp][, ice_a, ice_c, th_c, rv_c])."""
    turb = ssp is not None
    sd = (sijk, rw2, rd3, kpa, vt, wgt) + ((ssp, dot_ssp) if turb else ()) \
        + (tuple(ice) if ice is not None else ())
    cells = (th, rv, rhod, delta_th, delta_rv, delta_rh, p, dv, lambda_D,
             lambda_K)
    n_sd, n_cell = rw2.shape[0], th.shape[0]
    if any(a.dim() != 1 or a.shape[0] != n_sd for a in sd):
        raise ValueError("cond_flat: the SD arrays must be 1-D and of one "
                         f"length, got {[tuple(a.shape) for a in sd]}")
    if any(a.shape != (n_cell,) for a in cells + (ends,)):
        raise ValueError("cond_flat: the cell fields and ends must be "
                         f"({n_cell},), got "
                         f"{[tuple(a.shape) for a in cells + (ends,)]}")
    parcel = cfg.n_dims == 0
    name = "cond_flat" + ("_parcel" if parcel else "") \
        + ("_ice" if ice is not None else "") + ("_turb" if turb else "")
    if _ext.use_plain(name, rw2, plain):
        return cond_flat_plain(cfg, sstp, dt_sub, RH_max, var_rho, sijk,
                               ends, rw2, rd3, kpa, vt, wgt, th, rv, rhod,
                               delta_th, delta_rv, delta_rh, p, dv, lambda_D,
                               lambda_K, ssp, dot_ssp, ice)
    if n_sd >= 2 ** 31:
        raise ValueError("cond_flat: more than 2**31 - 1 SDs")
    sd = sd[1:]
    _ext.check("cond_flat", *sd)
    _ext.check("cond_flat", ends, dtype=torch.int64)
    cells_in = torch.stack([delta_th, delta_rv, delta_rh, th, rv, rhod, p,
                            dv, lambda_D, lambda_K])
    _ext.check("cond_flat", cells_in)
    rw2_out = torch.empty_like(rw2)
    cells_out = torch.empty((3 if ice is None else 5, n_cell),
                            dtype=rw2.dtype, device=rw2.device)
    pos, buf = _ext.cond_scratch(
        n_sd, rw2.device, rows=6 + (2 if turb else 0)
        + (3 if ice is not None else 0))
    sizes = torch.diff(ends, prepend=ends.new_full((1,), -1))
    order = _ext.longest_first(sizes)
    args = (*(a.data_ptr() for a in (wgt, rw2, rd3, kpa, vt, ends,
                                      cells_in)),
            rw2_out.data_ptr(), cells_out.data_ptr(), pos.data_ptr(),
            buf.data_ptr(), order.data_ptr(), n_cell, n_sd, int(sstp),
            float(dt_sub), float(RH_max), int(cfg.th_dry), int(cfg.const_p),
            int(cfg.RH_formula), int(var_rho),
            condensation._root_iters(rw2.dtype))
    out = ()
    if turb:
        ssp_out = torch.empty_like(ssp)
        args += (ssp.data_ptr(), dot_ssp.data_ptr(), ssp_out.data_ptr())
        out += (ssp_out,)
    if ice is not None:
        ice_out = (torch.empty_like(rw2), torch.empty_like(rw2))
        args += tuple(a.data_ptr() for a in tuple(ice) + ice_out)
    form_kernel("cond_flat", parcel, turb, ice is not None).launch(*args)
    cells = tuple(cells_out.unbind(0))
    out = (rw2_out,) + cells[:3] + out
    return out if ice is None else out + ice_out + cells[3:]


def advance_rw2_plain(dt, rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D,
                      lam_K, RH_max):
    """One backward-Euler step of rw2 for every droplet at its own ambient
    conditions: lgrngn/condensation.py _advance_rw2_core."""
    return condensation._advance_rw2_core(dt, rw2, rd3, kpa, vt, rhod, rv, T,
                                          p, RH, eta, lam_D, lam_K, RH_max)


def advance_rw2(dt, rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K,
                RH_max, *, plain=False):
    """Kernel G, or its plain version advance_rw2_plain (same arguments and
    result): the new rw2 of each droplet after one backward-Euler step of
    ``dt`` (a number, or a tensor of one dt a droplet) at the droplet's own
    rhod, rv, T, p, RH, eta and mean free paths, RH capped at ``RH_max``.
    The 12 droplet arrays are 1-D and of one length."""
    arrays = (rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K)
    n = rw2.shape[0] if rw2.dim() == 1 else -1
    dt_sd = dt if isinstance(dt, torch.Tensor) else None
    if any(a.dim() != 1 or a.shape[0] != n
           for a in arrays + ((dt_sd,) if dt_sd is not None else ())):
        raise ValueError("advance_rw2: the droplet arrays (and a per-droplet "
                         "dt) must be 1-D and of one length, got "
                         f"{[tuple(a.shape) for a in arrays]}")
    if _ext.use_plain("advance_rw2", rw2, plain):
        return advance_rw2_plain(dt, *arrays, RH_max)
    _ext.check("advance_rw2", *arrays,
               *((dt_sd,) if dt_sd is not None else ()))
    out = torch.empty_like(rw2)
    if n == 0:
        return out
    _ext.COND_SD.launch(
        *(a.data_ptr() for a in arrays),
        dt_sd.data_ptr() if dt_sd is not None else None, out.data_ptr(), n,
        0.0 if dt_sd is not None else float(dt), float(RH_max),
        condensation._root_iters(rw2.dtype))
    return out


# ---------------------------------------------------- kernel G, two forms
# The SD arrays the two forms take, in this order (``sd``): n, rw2, rd3,
# kappa, vt, and the private th, rv, rhod and p at the last sstp_save;
# the cells' (``cells``): th, rv, rhod and p (an SD's increment of a step
# is its cell's value minus its private one), dv, T and p at the start of
# the step (the stale mean free paths', hskpng_mfp: the kernels compute
# them once a cell), and for the adaptive form T after the step's
# closure (its activation test's).
SD_NAMES = ("n", "rw2", "rd3", "kpa", "vt", "tmp_th", "tmp_rv", "tmp_rh",
            "tmp_p")
CELL_NAMES = ("th", "rv", "rhod", "p", "dv", "T_mfp", "p_mfp", "T")


def _sd_layout(name, sd, cells, seg):
    """Check the SD arrays ``sd``, the cell arrays ``cells`` and the flat
    layout ``seg`` (None: dense rows) against each other: the dense rows
    are (n_cell, cap) planes; the flat SDs are 1-D in slot order, and
    ``seg`` is (sijk, order, ends): the cell of each sorted position, the
    slot of each (the stable sort of the SDs' cells) and each cell's last
    sorted position (condensation.cell_ends), int64.  Raise on anything
    else."""
    n_cell = cells[0].shape[0] if cells[0].dim() == 1 else -1
    if any(a.shape != (n_cell,) for a in cells):
        raise ValueError(f"{name}: the cell arrays must be 1-D and of one "
                         f"length, got {[tuple(a.shape) for a in cells]}")
    shape = sd[0].shape
    if any(a.shape != shape for a in sd):
        raise ValueError(f"{name}: the SD arrays must be of one shape, got "
                         f"{[tuple(a.shape) for a in sd]}")
    if seg is None:
        if len(shape) != 2 or shape[0] != n_cell:
            raise ValueError(f"{name}: dense rows must be ({n_cell}, cap) "
                             f"planes, got {tuple(shape)}")
        return
    sijk, order, ends = seg
    if len(shape) != 1 or sijk.shape != shape or order.shape != shape \
            or ends.shape != (n_cell,):
        raise ValueError(f"{name}: flat SDs must be 1-D, with sijk and order "
                         f"of their length and ends of the cells' "
                         f"({n_cell},), got {tuple(shape)}, "
                         f"{tuple(sijk.shape)}, {tuple(order.shape)}, "
                         f"{tuple(ends.shape)}")
    if any(a.dtype != torch.int64 for a in seg):
        raise TypeError(f"{name}: sijk, order and ends must be int64")


def _plain_layout(sd, cells, seg):
    """What the plain versions run on: (the SD arrays, a function that
    spreads a cell array over them, a function that puts results back in
    the SDs' layout, the cell-sum spread of sstp_cond_mix).  Dense rows
    broadcast the cell arrays as columns and sum over a row; the flat
    segments sort the SDs (``order``), gather the cells by ``sijk`` and
    sum in float64 cumulative sums differenced at ``ends``."""
    if seg is None:
        def spread(a):
            return torch.sum(a, dim=1, keepdim=True,
                             dtype=torch.float64).to(a.dtype)
        return sd, (lambda a: a[:, None]), (lambda a: a), spread
    sijk, order, ends = seg

    def put(a):
        out = torch.empty_like(a)
        out[order] = a
        return out

    return (tuple(a[order] for a in sd), (lambda a: a[sijk]), put,
            lambda a: condensation.cell_sum(a, ends).to(a.dtype)[sijk])


def perparticle_fixed_plain(cfg, dt, RH_max, sd, cells, seg=None, ssp=None):
    """Kernel G's fixed-count form as plain PyTorch:
    lgrngn/condensation.py perparticle_fixed_core over the SDs in the
    kernel's layout (the flat SDs sorted by cell and put back), the
    one-substep entry advance_rw2 once a substep; ``ssp`` (turb_cond) each
    SD's SGS supersaturation, added to its RH.  Returns (rw2, tmp_rv,
    tmp_th, tmp_rh, tmp_p) in the SDs' layout."""
    extra = () if ssp is None else (ssp,)
    (n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0, *extra), g, put, spread = \
        _plain_layout(tuple(sd) + extra, cells, seg)
    th, rv, rhod, p, dv = cells[:5]
    lam_D, lam_K = hskpng.hskpng_mfp(*cells[5:7])
    # the one-substep entry takes one mean free path an SD
    full = lambda a: g(a).expand(rw2.shape).contiguous()
    out = condensation.perparticle_fixed_core(
        cfg, dt, RH_max, n=n, rw2=rw2, rd3=rd3, kpa=kpa, vt=vt, dv_sd=g(dv),
        lam_D_sd=full(lam_D), lam_K_sd=full(lam_K), dlt_rv=g(rv) - rv0,
        dlt_th=g(th) - th0, dlt_rh=g(rhod) - rh0, dlt_p=g(p) - p0,
        tmp_rv0=rv0, tmp_th0=th0, tmp_rh0=rh0, tmp_p0=p0, spread=spread,
        ssp=extra[0] if extra else None, plain=True)
    return tuple(put(a) for a in out)


def perparticle_adaptive_plain(cfg, dt, RH_max, sd, cells, seg=None,
                               ssp=None, dot_ssp=None):
    """Kernel G's adaptive form as plain PyTorch:
    lgrngn/condensation.py perparticle_adaptive_core over the SDs in the
    kernel's layout, ravelled (the flat SDs sorted by cell and put back),
    the one-substep entry advance_rw2 once a try and a substep; ``ssp`` and
    ``dot_ssp`` (turb_cond) each SD's SGS supersaturation and its
    tendency.  Returns (rw2, tmp_rv, tmp_th, tmp_rh, tmp_p[, ssp]) in the
    SDs' layout."""
    extra = () if ssp is None else (ssp, dot_ssp)
    (n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0, *extra), g, put, _ = \
        _plain_layout(tuple(sd) + extra, cells, seg)
    th, rv, rhod, p, dv, T_mfp, p_mfp, T = cells
    lam_D, lam_K = hskpng.hskpng_mfp(T_mfp, p_mfp)
    if not cfg.const_p:
        p0 = torch.zeros_like(p0)
    shape = rw2.shape
    flat = lambda a: a.reshape(-1)
    full = lambda a: flat(g(a).expand(shape).contiguous())
    out = condensation.perparticle_adaptive_core(
        cfg, dt, RH_max, n=flat(n), rw2=flat(rw2), rd3=flat(rd3),
        kpa=flat(kpa), vt=flat(vt), dv_sd=full(dv), lam_D_sd=full(lam_D),
        lam_K_sd=full(lam_K), dlt_rv=flat(g(rv) - rv0),
        dlt_th=flat(g(th) - th0), dlt_rh=flat(g(rhod) - rh0),
        dlt_p=flat(g(p) - p0) if cfg.const_p else 0.0, tmp_rv0=flat(rv0),
        tmp_th0=flat(th0), tmp_rh0=flat(rh0), tmp_p0=flat(p0), T_sd=full(T),
        ssp0=flat(extra[0]) if extra else None,
        dot_ssp=flat(extra[1]) if extra else None, plain=True)
    return tuple(put(a.reshape(shape)) for a in out)


def _launch_sd(name, kernel, sd, cells, seg, *scalars, sgs=()):
    """Launch one of G's forms on its checked inputs: the outputs (rw2,
    tmp_rv, tmp_th, tmp_rh, tmp_p) in the SDs' layout.  ``sgs`` the
    turb_cond forms' SD arrays (ssp; or ssp and dot_ssp, and then the
    adaptive form's ssp comes out too, after the five)."""
    _ext.check(name, *sd, *cells, *sgs)
    n_slots = sd[1].numel()
    if n_slots >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 - 1 SD slots")
    if seg is not None:
        _ext.check(name, *seg, dtype=torch.int64)
    out = torch.empty((5,) + tuple(sd[1].shape), dtype=sd[1].dtype,
                      device=sd[1].device)
    rw2, th, rv, rh, p = out.unbind(0)
    outs = (rw2, th, rv, rh, p)
    if kernel in (_ext.COND_SD_FIXED, _ext.COND_SD_FIXED_TURB,
                  _ext.COND_SD_FIXED_PARCEL, _ext.COND_SD_FIXED_PARCEL_TURB):
        # its scratch: the ranked positions
        outs += (torch.empty(n_slots, dtype=torch.int32,
                             device=sd[1].device),)
    lay = seg if seg is not None else (None, None, None)
    sijk, order, ends = (a.data_ptr() if a is not None else None
                         for a in lay)
    cap = sd[1].shape[1] if seg is None else 0
    ssp_out = torch.empty_like(sgs[0]) if len(sgs) == 2 else None
    kernel.launch(*(a.data_ptr() for a in sd + cells), order, ends, sijk,
                  *(a.data_ptr() for a in outs), cells[0].shape[0], cap,
                  *scalars, *(a.data_ptr() for a in sgs),
                  *((ssp_out.data_ptr(),) if ssp_out is not None else ()))
    return (rw2, rv, th, rh, p) + ((ssp_out,) if ssp_out is not None else ())


def perparticle_fixed(cfg, dt, RH_max, sd, cells, seg=None, ssp=None, *,
                      plain=False):
    """Kernel G's fixed-count form, or its plain version
    perparticle_fixed_plain (same arguments and results): the whole exact
    per-particle condensation phase (sstp_cond substeps; with
    sstp_cond_mix the cells' vapour and heat shared among their SDs), one
    launch.  ``sd`` the SD arrays (SD_NAMES), ``cells`` the cell arrays
    (CELL_NAMES but T), ``seg`` None for the dense rows or the flat
    layout (sijk, order, ends).  With ``ssp`` (turb_cond: each SD's SGS
    supersaturation, in the SDs' layout, held for the phase) it runs G's
    fixed-count turb_cond form.  Returns (rw2, tmp_rv, tmp_th, tmp_rh,
    tmp_p)."""
    sd, cells = tuple(sd), tuple(cells)
    if len(sd) != len(SD_NAMES) or len(cells) != len(CELL_NAMES) - 1:
        raise ValueError("perparticle_fixed: expected the SD arrays "
                         f"{SD_NAMES} and the cell arrays {CELL_NAMES[:-1]}")
    sgs = () if ssp is None else (ssp,)
    _sd_layout("perparticle_fixed", sd + sgs, cells, seg)
    parcel = cfg.n_dims == 0
    name = "perparticle_fixed" + ("_parcel" if parcel else "") \
        + ("_turb" if sgs else "")
    if _ext.use_plain(name, sd[1], plain):
        return perparticle_fixed_plain(cfg, dt, RH_max, sd, cells, seg, ssp)
    return _launch_sd(
        name, form_kernel("perparticle_fixed", parcel, bool(sgs)), sd,
        cells, seg, int(cfg.sstp_cond), float(dt), float(RH_max),
        int(cfg.th_dry), int(cfg.const_p), int(cfg.RH_formula),
        int(cfg.sstp_cond_mix), condensation._root_iters(sd[1].dtype),
        sgs=sgs)


def perparticle_adaptive(cfg, dt, RH_max, sd, cells, seg=None, ssp=None,
                         dot_ssp=None, *, plain=False):
    """Kernel G's adaptive form, or its plain version
    perparticle_adaptive_plain (same arguments and results): the whole
    adaptive per-particle condensation phase (each SD's tries, its
    activation override and its own count of substeps), one launch.  The
    arguments are perparticle_fixed's, ``cells`` with T (the activation
    test's); without const_p the phase starts every SD's private p at 0
    (perparticle_adaptive_core's convention), whatever ``sd``'s private
    p holds.  With ``ssp`` and ``dot_ssp`` (turb_cond, in the SDs' layout)
    it runs G's adaptive turb_cond form and returns ssp too.  Returns (rw2,
    tmp_rv, tmp_th, tmp_rh, tmp_p[, ssp])."""
    sd, cells = tuple(sd), tuple(cells)
    if len(sd) != len(SD_NAMES) or len(cells) != len(CELL_NAMES):
        raise ValueError("perparticle_adaptive: expected the SD arrays "
                         f"{SD_NAMES} and the cell arrays {CELL_NAMES}")
    sgs = () if ssp is None else (ssp, dot_ssp)
    _sd_layout("perparticle_adaptive", sd + sgs, cells, seg)
    parcel = cfg.n_dims == 0
    name = "perparticle_adaptive" + ("_parcel" if parcel else "") \
        + ("_turb" if sgs else "")
    if _ext.use_plain(name, sd[1], plain):
        return perparticle_adaptive_plain(cfg, dt, RH_max, sd, cells, seg,
                                          ssp, dot_ssp)
    return _launch_sd(
        name, form_kernel("perparticle_adaptive", parcel, bool(sgs)), sd,
        cells, seg, sd[1].numel(), max(int(cfg.sstp_cond), 1),
        max(int(cfg.sstp_cond_act), 1), float(dt), float(RH_max),
        float(cfg.sstp_cond_adapt_drw2_eps),
        float(cfg.sstp_cond_adapt_drw2_max), int(cfg.th_dry),
        int(cfg.const_p), int(cfg.RH_formula),
        condensation._root_iters(sd[1].dtype), sgs=sgs)
