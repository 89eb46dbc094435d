"""Philox 4x32-10 counter-based random numbers for the coalescence loop
(in place of the TPU kernel's on-core generator, pallas_coal._u01), the
SGS turbulence's velocity draws (in place of the JAX package's
jax.random normals, lgrngn/turbulence.py:34-53) and the time-dependent
freezing's uniforms.

A draw is a pure function of (seed, row; step, substep, kind, lane): the
key is (seed, row) and the counter (step, substep, kind, lane), where
``kind`` says what the number is for (SHUFFLE, the pairing shuffle's key,
BERNOULLI, the collision draw, or NORMAL, a turbulent velocity's draw,
whose "substep" is the velocity's axis).  Of the four output words the
first is used, and for NORMAL the first two (Box-Muller); FREEZE is the
time-dependent freezing's uniform (lgrngn/ice.py freeze_u01, in place of
the JAX package's jax.random draw, lgrngn/ice.py:49-52).  The flat
engine's draws take the key's second word from the state (``rng_key``): 0
on the serial engine, ``shard_key(s)`` on shard s of the multi-device
front (in place of the JAX package's jax.random.fold_in(key, s),
parallel/multi.py:268-271), so that no two shards, and no shard and the
serial engine, share a stream.  There is no global generator: the same arguments give the same bits on the CPU, on
the card in plain PyTorch, and in kernel E (csrc/philox.cuh, the same
rounds in uint32 arithmetic).

The plain version works in int64 tensors with explicit 32-bit masks; the
32x32-bit products are split into 16-bit halves so that no intermediate
leaves the int64 range.  Reference: Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3" (SC11), and the Random123 known-answer
vectors.
"""

import math

import torch

SHUFFLE, BERNOULLI, NORMAL, FREEZE = 0, 1, 2, 3

M0, M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # key increments (golden ratio, sqrt 3)
MASK = 0xFFFFFFFF
ROUNDS = 10


def shard_key(s):
    """The second key word of shard ``s``'s flat draws: 2**32 - 1 - s, a
    word that neither the serial flat engine (0) nor a dense row (at most
    n_cell - 1) takes."""
    return MASK - int(s)


def _mulhilo(m, a):
    """(hi, lo) 32-bit words of the 64-bit product m * a, for a constant m
    and an int64 tensor a of 32-bit values."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p_lo = a_lo * m                      # < 2**48
    p_hi = a_hi * m                      # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox4x32(ctr, key):
    """Philox 4x32 with 10 rounds.  ``ctr`` four and ``key`` two int64
    tensors (or ints) of 32-bit values, broadcast together; returns the
    four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw(seed, step, substep, kind, n_rows, cap, device="cpu", row0=0):
    """(n_rows, cap) int64 tensor of 32-bit random words: row r, lane l
    holds word 0 of Philox(key=(seed, row0 + r), ctr=(step, substep, kind,
    l)).  ``row0`` is the first row's index in the whole grid, where the
    rows are a shard's of the x-slab mesh."""
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)[:, None]
    lanes = torch.arange(cap, dtype=torch.int64, device=device)[None, :]
    ctr = (int(step) & MASK, int(substep) & MASK, int(kind) & MASK, lanes)
    return philox4x32(ctr, (int(seed) & MASK, rows))[0]


def draw_substeps(seed, step, n_substeps, kind, n, device="cpu", key1=0):
    """(n_substeps, n) int64 tensor of 32-bit random words for a flat
    population: substep s, slot l holds word 0 of Philox(key=(seed, key1),
    ctr=(step, s, kind, l)), what draw(seed, step, s, kind, 1, n,
    row0=key1)[0] gives."""
    subs = torch.arange(n_substeps, dtype=torch.int64, device=device)[:, None]
    slots = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    ctr = (int(step) & MASK, subs, int(kind) & MASK, slots)
    return philox4x32(ctr, (int(seed) & MASK, int(key1) & MASK))[0]


def u01(bits, dtype):
    """Uniforms in [0, 1) in steps of 2**-23 from 32-bit words, as
    pallas_coal._u01 builds them: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1.  Exact in float32 and float64."""
    return (bits >> 9).to(dtype) * 2.0 ** -23


def normal(seed, step, axis, n, dtype, device="cpu", key1=0):
    """(n,) standard normal numbers of ``dtype`` for slots 0 .. n-1: slot l
    takes words 0 and 1 of Philox(key=(seed, key1), ctr=(step, axis,
    NORMAL, l)) as u1 = (w0 + 1) 2**-32 in (0, 1] and u2 = w1 2**-32 in [0, 1),
    and Box-Muller's sqrt(-2 ln u1) cos(2 pi u2), in float64."""
    slots = torch.arange(n, dtype=torch.int64, device=device)
    ctr = (int(step) & MASK, int(axis) & MASK, NORMAL, slots)
    w0, w1, _, _ = philox4x32(ctr, (int(seed) & MASK, int(key1) & MASK))
    u1 = (w0.to(torch.float64) + 1.0) * 2.0 ** -32
    u2 = w1.to(torch.float64) * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)
