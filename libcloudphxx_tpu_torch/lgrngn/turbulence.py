"""SGS turbulence (Grabowski & Abade 2017) for the flat SD population
(libcloudphxx_tpu/lgrngn/turbulence.py; reference src/impl/housekeeping/
particles_impl_hskpng_{tke,turb_vel,turb_ss}.ipp and src/impl/advection/
particles_impl_turb_adve.ipp): the TKE of each cell from its dissipation
rate, an Ornstein-Uhlenbeck update of each SD's velocity perturbations
(up, and wp and vp on the grids that have z and y), the tendency of its
supersaturation perturbation (ssp) and the turbulent displacement.  Plain PyTorch, as the JAX package runs them in
XLA.

The velocity draws are Philox normals (ops/philox.normal) keyed by the
state's seed, its step counter and the axis, one a slot; the step
counter advances by one a draw.  The JAX package draws from jax.random:
the two never agree draw for draw, and everything downstream of the
draws is a deterministic function of up and wp."""

import dataclasses

import torch

from ..common import turbulence as ga17
from ..ops import philox
from .state import State, StaticConfig

# the axis of each velocity perturbation in the draws' counter
AXES = {"up": 0, "wp": 1, "vp": 2}


def _mix_len_at_cells(cfg: StaticConfig, sgs_mix_len):
    """The SGS mixing length of each cell from the per-level profile
    (reference hskpng_tke.ipp:34-44)."""
    k = torch.arange(cfg.n_cell, device=sgs_mix_len.device) % cfg.nz
    return sgs_mix_len[k]


def hskpng_tke(cfg: StaticConfig, state: State, sgs_mix_len) -> State:
    """The diss_rate field becomes the TKE of each cell (hskpng_tke.ipp:
    30-45; the JAX package overwrites it too)."""
    lam = _mix_len_at_cells(cfg, sgs_mix_len)
    return dataclasses.replace(state, diss_rate=ga17.tke(state.diss_rate,
                                                         lam))


def turb_vel_names(only_vertical: bool, n_dims: int = 2):
    """The velocity perturbations an update draws for, in draw order: up,
    then wp and vp as the grid has them (up alone in a parcel), or wp
    alone where only turb_cond asks for them (hskpng_turb_vel.ipp:51-97;
    libcloudphxx_tpu/lgrngn/turbulence.py:46)."""
    return ("wp",) if only_vertical else ("up", "wp", "vp")[:max(1, n_dims)]


def hskpng_turb_vel(cfg: StaticConfig, state: State, sgs_mix_len, dt,
                    only_vertical=False) -> State:
    """The OU update of the SDs' velocity perturbations (hskpng_turb_vel.ipp:
    51-97), where diss_rate already holds the TKE."""
    lam = _mix_len_at_cells(cfg, sgs_mix_len)
    tke = state.diss_rate
    tau = ga17.tau(torch.clamp(tke, min=1e-30), lam)
    tau_sd, tke_sd = tau[state.ijk], tke[state.ijk]
    upd = {}
    for name in turb_vel_names(only_vertical, cfg.n_dims):
        r = philox.normal(state.rng_seed, state.rng_step, AXES[name],
                          cfg.n_sd_max, state.rw2.dtype, state.rw2.device,
                          key1=state.rng_key)
        upd[name] = ga17.update_turb_vel(getattr(state, name), tau_sd, dt,
                                         tke_sd, r)
    return dataclasses.replace(state, rng_step=state.rng_step + 1, **upd)


def hskpng_turb_dot_ss(cfg: StaticConfig, state: State) -> State:
    """The supersaturation perturbation's tendency of each SD
    (hskpng_turb_ss.ipp): tau_relax from its cell's first wet moment a
    volume, then dot_ssp = a_1 wp - ssp / tau_relax."""
    rw = torch.sqrt(torch.clamp(state.rw2, min=0.0))
    mom1 = torch.zeros(cfg.n_cell, dtype=rw.dtype, device=rw.device)
    mom1.index_add_(0, state.ijk, state.n * rw)
    tau_rlx = ga17.tau_relax(torch.clamp(mom1 / state.dv, min=1e-30))
    return dataclasses.replace(state, dot_ssp=ga17.dot_turb_ss(
        state.ssp, state.wp, tau_rlx[state.ijk]))


def apply_sgs_supersat(ssp, dot_ssp, dt_sub):
    """ssp after one condensation substep of ``dt_sub``
    (apply_perparticle_sgs_supersat.ipp:7-18)."""
    return ssp + dt_sub * dot_ssp


def turb_adve(cfg: StaticConfig, state: State, dt) -> State:
    """The displacement by the turbulent velocity perturbations
    (turb_adve.ipp:20-36): x, and z and y on the grids that have them."""
    upd = dict(x=state.x + state.up * dt)
    if cfg.n_dims > 1:
        upd["z"] = state.z + state.wp * dt
    if cfg.n_dims == 3:
        upd["y"] = state.y + state.vp * dt
    return dataclasses.replace(state, **upd)
