"""Aerosol sources: new super-droplets during the run
(libcloudphxx_tpu/lgrngn/source.py; reference src/impl/
sources_and_relaxation_of_SDs/ src_dry_distros_simple.ipp,
src_dry_distros_matching.ipp, src_dry_sizes.ipp, src.ipp).

The sources run once every supstp_src steps, on the host: numpy sampling
with the caller's generator, in the JAX package's draw order, so one seed
gives the JAX package's new SDs draw for draw; the new SDs land in the
State's dead slots in slot order (np.nonzero of n <= 0), as there.  A
source distribution gives the particles created a unit of time at STP
(opts.src_dry_distros = {(kappa, rd_insol): (fun, src_sd_conc,
supstp)}); the time a call covers is supstp * dt.
"""

import dataclasses
import math

import numpy as np
import torch

from ..common import constants as c
from ..common import kappa_koehler
from . import init as init_mod
from .state import State, StaticConfig

# the per-SD attributes a revived slot starts afresh (a copy of the JAX
# package's parallel/decomp.py:44-62 migrating_attrs); exact substepping's
# private copies too
MIGRATING_ATTRS = ("n", "rd3", "rw2", "kpa", "x", "y", "z", "vt",
                   "incloud_time", "up", "vp", "wp", "ssp", "dot_ssp",
                   "ice_a", "ice_c", "ice_rho", "T_freeze", "rd2_insol")
EXACT_ATTRS = ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh", "sstp_tmp_p")


def migrating_attrs(cfg: StaticConfig):
    """The per-SD attributes of a configuration (libcloudphxx_tpu/parallel/
    decomp.py:50)."""
    return MIGRATING_ATTRS + (EXACT_ATTRS if cfg.exact_sstp_cond else ())


def _box_cells(cfg: StaticConfig, oi):
    """The cells inside the source box, rounded to cell boundaries
    (reference opts_init.hpp:156-158): x always, y where ny > 1, z on the
    2-D and 3-D grids (libcloudphxx_tpu/lgrngn/source.py:25-47)."""
    def span(a0, a1, d, n, on):
        if not on:
            return range(1)
        lo = int(np.floor(a0 / d))
        return range(lo, min(max(lo + 1, int(np.ceil(a1 / d))), n))

    return np.asarray(
        [(i * cfg.ny + j) * cfg.nz + k
         for i in span(oi.src_x0, oi.src_x1, cfg.dx, cfg.nx, True)
         for j in span(oi.src_y0, oi.src_y1, cfg.dy, cfg.ny, cfg.ny > 1)
         for k in span(oi.src_z0, oi.src_z1, cfg.dz, cfg.nz, cfg.n_dims > 1)],
        dtype=np.int64)


def _fresh_attr_names(cfg: StaticConfig):
    """The per-SD attributes reset on a slot's revival (a dead slot keeps
    its last occupant's values), so that new SDs start clean like the
    reference's appended vectors."""
    return migrating_attrs(cfg) + ("ijk",)


def _inject(state: State, new, cfg: StaticConfig):
    """Place the new SDs (a dict of host arrays) in the first dead slots;
    the attributes not given start at zero.  Returns (state, count)."""
    n_new = new["n"].size
    if n_new == 0:
        return state, 0
    dead = np.nonzero(state.n.cpu().numpy() <= 0)[0]
    if dead.size < n_new:
        raise RuntimeError(
            f"lgrngn source: {n_new} new SDs but only {dead.size} free slots "
            f"(n_sd_max too small)")
    slots = torch.as_tensor(dead[:n_new], device=state.n.device)
    upd = {}
    for name in _fresh_attr_names(cfg):
        arr = getattr(state, name).clone()
        vals = new.get(name)
        arr[slots] = torch.as_tensor(
            vals if vals is not None else np.zeros(n_new), dtype=arr.dtype,
            device=arr.device)
        upd[name] = arr
    if cfg.chem_switch:
        # a new SD holds no dissolved mass (libcloudphxx_tpu/lgrngn/
        # source.py:84-85)
        chem = state.chem.clone()
        chem[:, slots] = 0.0
        upd["chem"] = chem
    return dataclasses.replace(state, **upd), n_new


class StateEngine:
    """The sources' and the relaxation's access to the flat State
    (libcloudphxx_tpu/lgrngn/source.py:90-163): host views of its cell
    fields and population, and the injection of new SDs."""

    def __init__(self, cfg: StaticConfig, state: State):
        self.cfg = cfg
        self.state = state

    def cell(self, name):
        """A per-cell field as a host array."""
        return getattr(self.state, name).cpu().numpy()

    def _augment_fresh(self, cfg, new):
        """Exact substepping: new SDs take their cell's current ambient
        state as their private copy (reference
        particles_impl_post_adding_SD.ipp:42 -> init_perparticle_sstp)."""
        if cfg.exact_sstp_cond:
            cells = np.asarray(new["ijk"], np.int64)
            for tname, cname in (("sstp_tmp_th", "th"),
                                 ("sstp_tmp_rv", "rv"),
                                 ("sstp_tmp_rh", "rhod"),
                                 ("sstp_tmp_p", "p")):
                new[tname] = self.cell(cname)[cells]
        return new

    def inject(self, new) -> int:
        """Place new SDs (host arrays) in dead slots; returns their count."""
        new = self._augment_fresh(self.cfg, new)
        self.state, added = _inject(self.state, new, self.cfg)
        return added

    def rlx_counts(self, kappa_rng, rd3_edges):
        """The live SDs' multiplicity sums by dry-radius bin and level,
        (n_bins, nz), of those of kappa in [kappa_rng): integer-valued
        float64 sums, exact in any order."""
        nz = self.cfg.nz
        st = self.state
        n = st.n.double().cpu().numpy()
        rd3 = st.rd3.double().cpu().numpy()
        kpa = st.kpa.double().cpu().numpy()
        k = st.ijk.cpu().numpy() % nz
        nb = len(rd3_edges) - 1
        in_k = (n > 0) & (kpa >= kappa_rng[0]) & (kpa < kappa_rng[1])
        b = np.searchsorted(rd3_edges, rd3, side="right") - 1
        ok = in_k & (b >= 0) & (b < nb)
        return np.bincount(b[ok] * nz + k[ok], weights=n[ok],
                           minlength=nb * nz).reshape(nb, nz)

    def percell_population(self):
        """(n, rd3, kpa, ijk) host views, for the matching source."""
        st = self.state
        return (st.n.double().cpu().numpy(), st.rd3.double().cpu().numpy(),
                st.kpa.double().cpu().numpy(),
                st.ijk.cpu().numpy().astype(np.int64))

    def add_multiplicity(self, updates):
        """n += updates, indexed as percell_population's arrays."""
        st = self.state
        self.state = dataclasses.replace(st, n=st.n + torch.as_tensor(
            updates, dtype=st.n.dtype, device=st.n.device))


def _positions_in_cells(cfg: StaticConfig, cells, rng):
    """Uniform positions in each cell, drawn x, then y where ny > 1, then z
    on the 2-D and 3-D grids, as in the JAX package; the axes not drawn
    are 0."""
    i, j, k = cells // (cfg.ny * cfg.nz), (cells // cfg.nz) % cfg.ny, \
        cells % cfg.nz
    x = (i + rng.random(cells.size)) * cfg.dx
    y = (j + rng.random(cells.size)) * cfg.dy if cfg.ny > 1 \
        else np.zeros(cells.size)
    z = (k + rng.random(cells.size)) * cfg.dz if cfg.n_dims > 1 \
        else np.zeros(cells.size)
    return x, y, z


def _equilibrium_rw2(eng, cells, rd3, kappa, RH_max):
    """The wet radius squared in equilibrium at the cell's RH (capped at
    RH_max) and T (the reference's init_wet on the appended SDs), in
    float64 on the host."""
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    RH = np.minimum(eng.cell("RH")[cells], RH_max)
    rw3 = kappa_koehler.rw3_eq(f64(rd3), torch.full((rd3.size,), kappa,
                                                    dtype=torch.float64),
                               f64(RH), f64(eng.cell("T")[cells]))
    return rw3.numpy() ** (2.0 / 3)


def _new_sds(cfg, eng, cells, n, rd3, kappa, rng, RH_max):
    """The dict of new SDs in ``cells`` that _inject takes: positions drawn
    in their cells, the wet radius in equilibrium."""
    x, y, z = _positions_in_cells(cfg, cells, rng)
    return dict(n=n, rd3=rd3, rw2=_equilibrium_rw2(eng, cells, rd3, kappa,
                                                   RH_max),
                kpa=np.full(n.size, kappa), x=x, y=y, z=z,
                vt=np.zeros(n.size), ijk=cells)


def _src_volume(cfg: StaticConfig, rhod_host, cell):
    """The volume a source fills in ``cell``: a grid cell's dx dy dz, a
    parcel's 1 kg of dry air (libcloudphxx_tpu/lgrngn/source.py:194, 247,
    320)."""
    if cfg.n_dims > 0:
        return cfg.dx * cfg.dy * cfg.dz
    return 1.0 / float(rhod_host[cell])


def src_simple_distros(cfg: StaticConfig, oi, eng, src_dry_distros, dt, rng,
                       RH_max):
    """The 'simple' source: fresh SDs sampled from the distribution of the
    particles created a unit of time (src_dry_distros_simple.ipp:20-90).
    Returns the count of new SDs."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    total = 0
    for key, (fun, src_sd_conc, supstp) in src_dry_distros.items():
        kappa = key[0] if isinstance(key, tuple) else key
        log_lo, log_hi, mult = init_mod._dist_analysis_sd_conc(
            fun, src_sd_conc, _src_volume(cfg, rhod_host, 0) * (supstp * dt))
        count = int(src_sd_conc)
        u01 = rng.random((cells.size, count))
        strata = (np.arange(count)[None, :] + u01) / count
        lnrd = log_lo + strata * (log_hi - log_lo)
        n_of = init_mod._eval_distro(fun, lnrd) * mult
        if not oi.aerosol_independent_of_rhod:
            n_of *= rhod_host[cells][:, None] / c.rho_stp
        conc_fac = init_mod.conc_factor_cells(cfg, oi)
        if conc_fac is not None:
            # the aerosol_conc_factor profile scales the source too
            # (init_n.ipp:100-110, shared by src_dry_distros_simple)
            n_of = n_of * conc_fac[cells][:, None]
        multiplicity = np.floor(n_of + 0.5)
        keep = multiplicity.ravel() > 0
        cell_rep = np.repeat(cells, count)[keep]
        new = _new_sds(cfg, eng, cell_rep, multiplicity.ravel()[keep],
                       np.exp(3.0 * lnrd.ravel()[keep]), kappa, rng, RH_max)
        total += eng.inject(new)
    return total


def src_matching_distros(cfg: StaticConfig, oi, eng, src_dry_distros, dt,
                         rng, RH_max):
    """The 'matching' source: the SD of each cell closest in radius to a
    source bin's centre takes the bin's particles; SDs are created only
    for the bins that hold none (src_dry_distros_matching.ipp, with
    closest-in-bin matching as the JAX package's).  Returns the count of
    new SDs."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    n_host, rd3_host, kpa_host, ijk_host = eng.percell_population()
    total = 0
    mult_updates = np.zeros_like(n_host)
    for key, (fun, src_sd_conc, supstp) in src_dry_distros.items():
        kappa = key[0] if isinstance(key, tuple) else key
        log_lo, log_hi, mult = init_mod._dist_analysis_sd_conc(
            fun, src_sd_conc, _src_volume(cfg, rhod_host, 0) * (supstp * dt))
        nbins = int(src_sd_conc)
        edges = np.linspace(log_lo, log_hi, nbins + 1)
        mids = 0.5 * (edges[:-1] + edges[1:])
        n_per_bin_stp = init_mod._eval_distro(fun, mids) * mult
        conc_fac = init_mod.conc_factor_cells(cfg, oi)
        new_n, new_rd3, new_cell = [], [], []
        for cell in cells:
            factor = (1.0 if oi.aerosol_independent_of_rhod
                      else rhod_host[cell] / c.rho_stp)
            if conc_fac is not None:
                factor = factor * conc_fac[cell]
            target = np.floor(n_per_bin_stp * factor + 0.5)
            # the live SDs of this kappa in this cell
            here = np.nonzero((ijk_host == cell) & (n_host > 0)
                              & (np.abs(kpa_host - kappa) < 1e-12))[0]
            lnrd_here = np.log(np.maximum(rd3_host[here], 1e-300)) / 3.0
            bin_of = np.searchsorted(edges, lnrd_here) - 1
            for b in range(nbins):
                if target[b] <= 0:
                    continue
                in_bin = here[bin_of == b]
                if in_bin.size:
                    # the bin's particles go to its SD closest in radius
                    j = in_bin[np.argmin(np.abs(lnrd_here[bin_of == b]
                                                - mids[b]))]
                    mult_updates[j] += target[b]
                else:
                    new_n.append(target[b])
                    new_rd3.append(math.exp(3.0 * mids[b]))
                    new_cell.append(cell)
        if new_n:
            new = _new_sds(cfg, eng, np.asarray(new_cell, dtype=np.int64),
                           np.asarray(new_n), np.asarray(new_rd3), kappa, rng,
                           RH_max)
            total += eng.inject(new)
    if mult_updates.any():
        eng.add_multiplicity(mult_updates)
    return total


def src_dry_sizes(cfg: StaticConfig, oi, eng, src_sizes, dt, rng, RH_max):
    """The source of (radius, concentration) pairs: {(kappa, rd_insol):
    {radius: (conc_per_s, sd_count, supstp)}} (src_dry_sizes.ipp).
    Returns the count of new SDs."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    conc_fac = init_mod.conc_factor_cells(cfg, oi)
    total = 0
    for key, sizes in src_sizes.items():
        kappa = key[0] if isinstance(key, tuple) else key
        for radius, (conc_per_s, sd_count, supstp) in sizes.items():
            sd_count = int(sd_count)
            for cell in cells:
                number = conc_per_s * (supstp * dt) * _src_volume(
                    cfg, rhod_host, cell)
                if not oi.aerosol_independent_of_rhod:
                    number *= rhod_host[cell] / c.rho_stp
                if conc_fac is not None:
                    number *= conc_fac[cell]
                multiplicity = math.floor(number / sd_count + 0.5)
                if multiplicity <= 0:
                    continue
                new = _new_sds(cfg, eng, np.full(sd_count, cell, np.int64),
                               np.full(sd_count, float(multiplicity)),
                               np.full(sd_count, radius ** 3), kappa, rng,
                               RH_max)
                total += eng.inject(new)
    return total
