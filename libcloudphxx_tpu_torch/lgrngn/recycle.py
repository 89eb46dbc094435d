"""Super-droplet recycling: dead slots refilled by splitting large SDs
(libcloudphxx_tpu/lgrngn/recycle.py; reference src/impl/housekeeping/
particles_impl_rcyc.ipp:44-130).

One stable argsort of the multiplicities pairs the k-th dead slot with the
k-th largest SD; the donor's attributes are copied into the dead slot and
its multiplicity split between them (the dead slot takes ceil(n/2), the
donor keeps floor(n/2)).  No two pairs share a slot.  Plain PyTorch, as
the JAX package runs it in XLA.
"""

import dataclasses

import torch

from .state import State, StaticConfig

# what the donor hands the slot (the reference copies every distmem
# vector, rcyc.ipp:90-96; libcloudphxx_tpu/lgrngn/recycle.py:19-21)
RECYCLED_ATTRS = ("rd3", "rw2", "kpa", "x", "y", "z", "vt", "incloud_time",
                  "up", "vp", "wp", "ssp", "dot_ssp", "ice_a", "ice_c",
                  "ice_rho", "T_freeze", "rd2_insol")


def rcyc(cfg: StaticConfig, state: State) -> State:
    """Refill the dead slots (n <= 0) from the SDs of multiplicity above 1,
    the largest first."""
    n_sd = cfg.n_sd_max
    order = torch.argsort(state.n, stable=True)   # dead first, then by n
    k = torch.arange(n_sd, device=state.n.device)
    dead_slot = order
    donor = torch.flip(order, (0,))
    n_donor = state.n[donor]
    valid = (state.n[dead_slot] <= 0) & (n_donor > 1) & (k < n_sd - 1 - k)
    tgt, don = dead_slot[valid], donor[valid]
    upd = {}
    for name in RECYCLED_ATTRS + ("ijk",):
        arr = getattr(state, name).clone()
        arr[tgt] = arr[don]
        upd[name] = arr
    half = torch.floor(n_donor[valid] / 2.0)
    n = state.n.clone()
    n[tgt] = n_donor[valid] - half
    n[don] = half
    return dataclasses.replace(state, n=n, **upd)
