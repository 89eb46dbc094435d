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

Kernel G (csrc/cond_sd.cu, advance_rw2) runs one backward-Euler root find
a droplet at each droplet's own ambient conditions, the TPU kernel's
per-droplet-ambient callers (the exact and adaptive per-particle
substepping, lgrngn/condensation.py cond_perparticle and
perparticle_adaptive_core), beside its plain version advance_rw2_plain
(lgrngn/condensation.py _advance_rw2_core).  It advances every slot whose
rw2 > 0, as the TPU kernel does, and keeps the others.

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
from ..common import theta_dry
from ..lgrngn import condensation, hskpng


def cond_flat_plain(cfg, sstp, dt_sub, RH_max, var_rho, sijk, ends, rw2,
                    rd3, kpa, vt, wgt, th, rv, rhod, delta_th, delta_rv,
                    delta_rh, p, dv, lambda_D, lambda_K):
    """sstp substeps of the cell-sorted droplets' growth, each closed by the
    cells' latent heat (libcloudphxx_tpu/lgrngn/condensation.py:312-388):
    cell sums as a float64 cumulative sum differenced at the cell ends.
    Returns (rw2, th, rv, rhod)."""
    lamD_s, lamK_s = lambda_D[sijk], lambda_K[sijk]
    if not var_rho:
        wgt = wgt / (dv * rhod)[sijk]

    g = lambda a: a[sijk]
    for _ in range(sstp):
        th = th + delta_th / sstp
        rv = rv + delta_rv / sstp
        if var_rho:
            rhod = rhod + delta_rh / sstp
        T, p_, RH, eta = hskpng.hskpng_Tpr(cfg, th, rv, rhod, p)
        rw2_new = condensation._advance_rw2_core(
            dt_sub, rw2, rd3, kpa, vt, g(rhod), g(rv), g(T), g(p_), g(RH),
            g(eta), lamD_s, lamK_s, RH_max)
        drw3 = rw2_new * torch.sqrt(rw2_new) \
            - rw2 * torch.sqrt(torch.clamp(rw2, min=0.0))
        wsub = wgt / g(dv * rhod) if var_rho else wgt
        drv = -condensation.cell_sum(wsub * drw3, ends).to(rw2.dtype)
        th = th + drv * theta_dry.d_th_d_rv(T, th)
        rv = rv + drv
        rw2 = rw2_new
    return rw2, th, rv, rhod


def cond_flat(cfg, sstp, dt_sub, RH_max, var_rho, sijk, ends, rw2, rd3, kpa,
              vt, wgt, th, rv, rhod, delta_th, delta_rv, delta_rh, p, dv,
              lambda_D, lambda_K, *, plain=False):
    """Kernel F, or its plain version cond_flat_plain (same arguments and
    results).  ``sijk`` the sorted cells of the SDs, ``ends`` the last
    sorted position of each cell (condensation.cell_ends); ``rw2`` ...
    ``wgt`` the sorted SD arrays (``wgt`` = n * 4/3 pi rho_w); th, rv and
    rhod the cells at the last sstp_save, the deltas the step's increments,
    ``p`` the pressure the closure takes, ``dv`` the cell volumes.
    ``var_rho`` substeps rhod and the weights with it.  Returns (rw2, th,
    rv, rhod)."""
    sd = (sijk, rw2, rd3, kpa, vt, wgt)
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
    if _ext.use_plain("cond_flat", rw2, plain):
        return cond_flat_plain(cfg, sstp, dt_sub, RH_max, var_rho, sijk,
                               ends, rw2, rd3, kpa, vt, wgt, th, rv, rhod,
                               delta_th, delta_rv, delta_rh, p, dv, lambda_D,
                               lambda_K)
    if n_sd >= 2 ** 31:
        raise ValueError("cond_flat: more than 2**31 - 1 SDs")
    sd = sd[1:]
    _ext.check("cond_flat", *sd)
    _ext.check("cond_flat", ends, dtype=torch.int64)
    cells_in = torch.stack([delta_th, delta_rv, delta_rh, th, rv, rhod, p,
                            dv, lambda_D, lambda_K])
    _ext.check("cond_flat", cells_in)
    rw2_out = torch.empty_like(rw2)
    cells_out = torch.empty((3, n_cell), dtype=rw2.dtype, device=rw2.device)
    pos, buf = _ext.cond_scratch(n_sd, rw2.device)
    sizes = torch.diff(ends, prepend=ends.new_full((1,), -1))
    order = _ext.longest_first(sizes)
    _ext.COND_FLAT.launch(
        *(a.data_ptr() for a in (wgt, rw2, rd3, kpa, vt, ends, cells_in)),
        rw2_out.data_ptr(), cells_out.data_ptr(), pos.data_ptr(),
        buf.data_ptr(), order.data_ptr(), n_cell, n_sd, int(sstp),
        float(dt_sub), float(RH_max), int(cfg.th_dry), int(cfg.const_p),
        int(cfg.RH_formula), int(var_rho),
        condensation._root_iters(rw2.dtype))
    return (rw2_out,) + tuple(cells_out.unbind(0))


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
