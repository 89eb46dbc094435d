"""Stable in-row stream compaction (libcloudphxx_tpu/ops/pallas_compact.py
stable_partition_rows), as a plain version.

The re-binning needs stable partitions ("taken droplets to the row front,
in order"), not sorts.  On the card the merge kernel compacts with warp
ballots (csrc/merge.cu); this plain version is one stable sort of the
0/1 class key per row.
"""

import torch


def stable_partition_rows(front, planes):
    """Stable partition of each row of a (rows, L) layout: lanes where
    ``front`` is set move to the row front (order preserved), the rest to
    the back (order preserved).  ``planes`` move together.

    Returns (planes_partitioned, n_front) with n_front of shape (rows, 1)."""
    key = (~front.bool()).to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    outs = tuple(torch.gather(p, -1, order) for p in planes)
    return outs, front.sum(dim=-1, keepdim=True)
