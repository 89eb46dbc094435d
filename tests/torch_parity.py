"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Each test makes its inputs from a numpy seed and hands the same arrays to
the JAX package and to the port (libcloudphxx_tpu_torch) on the CPU, where
the port runs the plain PyTorch version of every kernel.  JAX runs with
x64 on (conftest.py), so float32 cases cast explicitly on both sides.

The suite runs in several pytest-xdist worker processes, so each keeps
PyTorch to two threads.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)


def t(a, dtype=torch.float64):
    """numpy / JAX array -> CPU tensor of ``dtype`` (a copy: JAX hands out
    read-only buffers)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def port_cfg(jax_cfg):
    """The port's StaticConfig for a JAX StaticConfig."""
    from libcloudphxx_tpu_torch.convert import static_config_from_numpy
    return static_config_from_numpy(dataclasses.asdict(jax_cfg))


def port_state(jax_dense, dtype=torch.float64):
    """The port's DenseState (CPU) for a JAX DenseState."""
    from libcloudphxx_tpu_torch.convert import dense_state_from_numpy
    arrays = {f.name: np.asarray(getattr(jax_dense, f.name))
              for f in dataclasses.fields(jax_dense)}
    return dense_state_from_numpy(arrays, "cpu", dtype)


def port_shuffle(seed, step, substep, n, row0=0):
    """The port's shuffle of one coalescence substep (ops/coal.py) as a
    numpy gather index: row r's lane j takes the SD of lane perm[r, j]
    (row r drawing as the global row row0 + r)."""
    from libcloudphxx_tpu_torch.ops import coal, philox
    n = np.asarray(n)
    bits = philox.draw(seed, step, substep, philox.SHUFFLE, *n.shape,
                       row0=row0)
    key = coal.shuffle_key(bits, torch.tensor(n > 0))
    return torch.sort(key, dim=1).indices.numpy()


def port_u01(seed, step, substep, shape, row0=0):
    """The port's Bernoulli plane of one coalescence substep, float64."""
    from libcloudphxx_tpu_torch.ops import philox
    bits = philox.draw(seed, step, substep, philox.BERNOULLI, *shape,
                       row0=row0)
    return philox.u01(bits, torch.float64).numpy()


def jax_coal_loop(cfg, params, sstp, dt, seed, step, planes, cells,
                  pairing="stride", eff_table=None, r_max_um=0.0, row0=0):
    """The coalescence phase of the resident step (pallas_step.py:233-336)
    built from the JAX package's functions, fed the port's shuffles and
    Bernoulli planes (the rows drawing as the global rows row0, row0 + 1,
    ...: a shard's of the x-slab mesh).  ``planes`` (n, rw2, rd3, kpa, x,
    z), or with the 3-D grid's y after z, and ``cells`` (T, p, rhod, eta,
    dv) numpy; returns the planes."""
    import jax.numpy as jnp

    from libcloudphxx_tpu.lgrngn import dense as jdense
    from libcloudphxx_tpu.ops.pallas_coal import _vt_in_kernel
    T, p, rhod, eta, dv = (jnp.asarray(a)[:, None] for a in cells)
    jp = jnp.asarray(params, jnp.float64)
    kw = dict(eff_table=eff_table, r_max_um=r_max_um)
    vt_of = lambda rw2: _vt_in_kernel(cfg, rw2, T, p, rhod, eta)
    take = lambda perm, *a: tuple(np.take_along_axis(np.asarray(v), perm, 1)
                                  for v in a)
    n, rw2, rd3, kpa, *pos = planes
    dt_sub = dt / sstp
    if pairing == "stride":
        n_strides = 1          # pallas_step.py:252-255
        while (1 << n_strides) <= n.shape[1] // 4 and n_strides < 6:
            n_strides += 1
        for s in range(sstp):
            if s % n_strides == 0:
                n, rw2, rd3, kpa, *pos = take(
                    port_shuffle(seed, step, s, n, row0), n, rw2, rd3, kpa,
                    *pos)
            n, rw2, rd3, kpa, _ = jdense.pair_and_collide_stride(
                cfg, jp, (n, rw2, rd3, kpa, vt_of(jnp.asarray(rw2))),
                1 << (s % n_strides), dv, rhod, eta, dt_sub,
                port_u01(seed, step, s, n.shape, row0), **kw)
    else:
        ids = np.broadcast_to(np.arange(n.shape[1]), n.shape)
        for s in range(sstp):
            n, rw2, rd3, kpa, ids = take(port_shuffle(seed, step, s, n, row0),
                                         n, rw2, rd3, kpa, ids)
            count = (n > 0).sum(1, keepdims=True).astype(float)
            n, rw2, rd3, kpa, _ = jdense.pair_and_collide(
                cfg, jp, (n, rw2, rd3, kpa, vt_of(jnp.asarray(rw2))), count,
                dv, rhod, eta, dt_sub,
                port_u01(seed, step, s, n.shape, row0), **kw)
        n, rw2, rd3, kpa = take(np.argsort(ids, axis=1), n, rw2, rd3, kpa)
    return tuple(np.asarray(a) for a in (n, rw2, rd3, kpa, *pos))


def khvorostyanov_rtol(rw, rhod, eta, floor):
    """The float64 rtol of a Khvorostyanov vt of radius ``rw`` in a cell of
    ``rhod`` and ``eta``: ``floor``, or 8 ulps of root = sqrt(1 + 0.0902
    sqrt(X)) over root - 1 where the formula's cancellation amplifies
    more.  PyTorch's CPU float64 sqrt rounds some arguments an ulp away
    from the correctly rounded root that JAX's gives (1.0003293317117516
    against ...519 for 1.0006587718828799); root - 1 is 3e-4 at 0.5 um
    (1.35e-12 measured) and 1e-6 at 20 nm (6e-9)."""
    X = (32.0 / 3) * (1e3 - rhod) / rhod * 9.81 * rw**3 / eta**2 * rhod**2
    root = np.sqrt(1.0 + 0.0902 * np.sqrt(X))
    with np.errstate(divide="ignore"):
        return np.maximum(floor, 8 * np.finfo(np.float64).eps / (root - 1.0))


def multiset(n, planes):
    """Alive SDs of an (n_cell, cap) layout as sorted rows
    (cell, n, *planes): the per-cell multiset, whatever the lane order.
    Put a per-droplet constant (rd3) first among ``planes`` so that rows
    pair up droplet by droplet."""
    n = np.asarray(n)
    cap = n.shape[1]
    alive = n.reshape(-1) > 0
    cols = [np.repeat(np.arange(n.shape[0]), cap)[alive],
            n.reshape(-1)[alive]] \
        + [np.asarray(p).reshape(-1)[alive] for p in planes]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], 1)


def port_flat_state(jax_state, dtype=torch.float64):
    """The port's flat State (CPU) for a JAX State; the draws start from
    the config's seed (convert.state_from_numpy)."""
    from libcloudphxx_tpu_torch.convert import state_from_numpy
    arrays = {f.name: np.asarray(getattr(jax_state, f.name))
              for f in dataclasses.fields(jax_state)}
    return state_from_numpy(arrays, "cpu", dtype)


def transport_case(nx, nz, cap, seed=0, device="cpu", dtype=torch.float64):
    """The inputs of ops/step.transport and rebin_x on a synthetic grid of
    nx x nz cells of 20 m at row capacity ``cap``: rows at random
    occupancy, the first all dead, the second and that of cell (1, 0)
    full, the dead slots of every other row scattered among its droplets.
    Each droplet sits in its own cell or in a neighbour's (x-periodic); a
    few sit two rows up or down (far movers) or, in the bottom row (slot 0
    always), under the floor (the puddle); and the rows around cell (1, 1)
    send nine in ten of their droplets there, more than a row holds.  Small
    courants, droplets of 1-50 um.  Returns (cfg, planes (n, rw2, rd3, kpa,
    x, z), cell fields (T, p, rhod, eta, C_l, C_r, C_b, C_a))."""
    from libcloudphxx_tpu_torch.lgrngn import opts_init_t, vt_t
    from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig
    rng = np.random.default_rng(seed + 1000 * cap + 10 * nx + nz)
    oi = opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz = nx, nz, 20.0, 20.0
    oi.x1, oi.z1, oi.dt = 20.0 * nx, 20.0 * nz, 1.0
    oi.terminal_velocity = vt_t.beard77
    cfg = StaticConfig.from_opts_init(oi)
    n_cell = nx * nz
    count = rng.integers(0, cap + 1, n_cell)
    count[:2] = (0, cap)
    count[nz] = cap       # cell (1, 0): a full bottom row
    alive = np.arange(cap)[None, :] < count[:, None]
    alive[1::2] = np.stack([rng.permutation(a) for a in alive[1::2]])
    i = np.repeat(np.arange(n_cell) // nz, cap).reshape(n_cell, cap)
    k = np.repeat(np.arange(n_cell) % nz, cap).reshape(n_cell, cap)
    u = rng.random((n_cell, cap))
    ti = np.where(u < 0.3, i + rng.integers(-1, 2, (n_cell, cap)), i) % nx
    tk = np.clip(np.where(u < 0.3, k + rng.integers(-1, 2, (n_cell, cap)),
                          k), 0, nz - 1)
    far = (u > 0.97) & (nz >= 4)
    tk = np.where(far, np.where(k + 2 < nz, k + 2, k - 2), tk)
    hot = (np.abs(i - 1) <= 1) & (np.abs(k - 1) <= 1) & (u < 0.9)
    ti, tk = np.where(hot, 1, ti), np.where(hot, min(1, nz - 1), tk)
    x = (ti + rng.uniform(0.1, 0.9, (n_cell, cap))) * 20.0
    z = (tk + rng.uniform(0.1, 0.9, (n_cell, cap))) * 20.0
    lane = np.arange(cap)[None, :]
    fall = (k == 0) & (((u > 0.9) & (u < 0.95)) | (lane == 0))
    z = np.where(fall, -1.0 - 5.0 * u, z)
    rw = np.exp(rng.uniform(np.log(1e-6), np.log(5e-5), (n_cell, cap)))
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, (n_cell, cap))),
                 0.0)
    planes = (n, rw ** 2, (rw * rng.uniform(0.01, 0.2, (n_cell, cap))) ** 3,
              rng.uniform(0.1, 1.2, (n_cell, cap)), x, z)
    T = rng.uniform(280.0, 295.0, n_cell)
    cells = (T, rng.uniform(8.5e4, 1e5, n_cell),
             rng.uniform(1.0, 1.2, n_cell),
             1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5) \
        + tuple(rng.uniform(-0.02, 0.02, n_cell) for _ in range(4))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return cfg, tuple(map(as_t, planes)), tuple(map(as_t, cells))


def flat_cond_case(sizes, dead0=0, seed=0, device="cpu", dtype=torch.float64,
                   th_dry=True, const_p=False, sstp=4):
    """The inputs of ops/cond.cond_flat (kernel F) for cells of ``sizes``
    live droplets, cell 0 also holding ``dead0`` dead slots (n == 0) mixed
    in among its droplets, as the flat engine keeps them (half of them
    with the rw2 they died with): haze to cloud droplets in cells from
    sub- to supersaturated, and a host-model increment of th, rv and rhod.
    Returns (cfg, kwargs of cond_flat without RH_max, var_rho and plain)."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_dry
    from libcloudphxx_tpu_torch.common import constants as c
    from libcloudphxx_tpu_torch.lgrngn import opts_init_t
    from libcloudphxx_tpu_torch.lgrngn.condensation import cell_ends
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig
    rng = np.random.default_rng(seed)
    n_cell = len(sizes)
    oi = opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz, oi.x1, oi.z1 = n_cell, 1, 20.0, 20.0, \
        20.0 * n_cell, 20.0
    oi.sstp_cond, oi.th_dry, oi.const_p = sstp, th_dry, const_p
    cfg = StaticConfig.from_opts_init(oi)

    counts = np.array(sizes)
    counts[0] += dead0
    sijk = np.repeat(np.arange(n_cell), counts)
    n_sd = sijk.size
    live = np.ones(n_sd, bool)
    live[rng.permutation(counts[0])[:dead0]] = False
    rw = np.exp(rng.uniform(np.log(2e-8), np.log(3e-5), n_sd))
    rd3 = (rw * rng.uniform(0.05, 0.9, n_sd)) ** 3
    rw2 = np.where(live | (rng.random(n_sd) < 0.5), rw ** 2, 0.0)
    mult = np.where(live, np.floor(10.0 ** rng.uniform(7, 9, n_sd)), 0.0)

    th = rng.uniform(289.0, 300.0, n_cell)
    rhod = rng.uniform(1.0, 1.15, n_cell)
    T = theta_dry.T(torch.tensor(th), torch.tensor(rhod))
    p = theta_dry.p(torch.tensor(rhod), torch.tensor(8e-3), T)
    rv = rng.uniform(0.95, 1.02, n_cell) * const_cp.r_vs(T, p).numpy()
    lam_D, lam_K = (a.numpy() for a in hskpng_mfp(T, p))
    arrays = dict(
        rw2=rw2, rd3=rd3, kpa=rng.uniform(0.1, 1.2, n_sd),
        vt=rng.uniform(0.0, 0.05, n_sd), wgt=mult * (4.0 / 3) * c.pi * c.rho_w,
        th=th, rv=rv, rhod=rhod, delta_th=rng.normal(0.0, 0.05, n_cell),
        delta_rv=rv * rng.uniform(-2e-3, 4e-3, n_cell),
        delta_rh=rhod * rng.uniform(0.0, 2e-3, n_cell), p=p.numpy(),
        dv=np.full(n_cell, 400.0), lambda_D=lam_D, lambda_K=lam_K)
    kw = {k: torch.as_tensor(v, dtype=dtype, device=device)
          for k, v in arrays.items()}
    kw["sijk"] = torch.as_tensor(sijk, device=device)
    kw["ends"] = cell_ends(kw["sijk"], n_cell)
    return cfg, dict(kw, sstp=sstp, dt_sub=1.0 / sstp)


def ambient_population(n, kind="mixed", seed=0, device="cpu",
                       dtype=torch.float32):
    """``n`` droplets at their own ambient conditions, as kernel G
    (ops/cond.advance_rw2) takes them: {name: tensor} of rw2, rd3, kpa,
    vt, rhod, rv, T, p, RH, eta, lam_D, lam_K.  ``kind`` "mixed": haze to
    cloud droplets in air from 70% RH to 5% supersaturation, every seventh
    slot dead (rw2 = 0); "activating": haze droplets of 1.5-6 dry radii in
    air 0.3-2% supersaturated; "evaporating": cloud and drizzle droplets
    of 5-50 um in air at 85-97% RH."""
    from libcloudphxx_tpu_torch.common import vterm
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    if kind == "activating":
        rd = u(0.02e-6, 0.1e-6)
        rw, RH = rd * u(1.5, 6.0), u(1.003, 1.02)
    elif kind == "evaporating":
        rd = u(0.02e-6, 0.5e-6)
        rw, RH = u(5e-6, 50e-6), u(0.85, 0.97)
    else:
        rd = u(0.01e-6, 0.5e-6)
        rw, RH = rd * u(1.1, 30.0), u(0.7, 1.05)
    rw2 = rw ** 2
    if kind == "mixed":
        rw2[::7] = 0.0
    T, p = u(270.0, 300.0), u(7e4, 1.02e5)
    arrays = dict(rw2=rw2, rd3=rd ** 3, kpa=u(0.1, 1.2), vt=u(0.0, 2.0),
                  rhod=p / (287.0 * T), rv=u(5e-3, 1.5e-2), T=T, p=p, RH=RH,
                  eta=vterm.visc(torch.tensor(T)).numpy(),
                  lam_D=u(5e-8, 2e-7), lam_K=u(5e-8, 2e-7))
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in arrays.items()}


def perparticle_case(counts, cap=None, dead0=0, seed=0, device="cpu",
                     dtype=torch.float64, **opts):
    """The inputs of kernel G's two forms (ops/cond.perparticle_fixed,
    perparticle_adaptive) for cells of ``counts`` live SDs: haze to cloud
    droplets in cells from sub- to supersaturated, each SD with a private
    th, rv, rhod and p a host-model increment behind its cell's (a third
    of them a neighbouring cell's values, as after a move).  With ``cap``
    the dense (n_cell, cap) rows: a row's live SDs first, with a hole that
    keeps the rw2 it died with in every row of more than 4, then a dead
    tail of zeros; without it the flat engine's SDs in a shuffled slot
    order, cell 0 also holding ``dead0`` dead slots (half with the rw2
    they died with), and their (sijk, order, ends).  ``opts`` go to
    opts_init (sstp_cond, sstp_cond_mix, const_p, th_dry, adaptive ...).
    Returns (cfg, sd, cells, seg); cells hold T (ops/cond CELL_NAMES)."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_dry
    from libcloudphxx_tpu_torch.lgrngn import opts_init_t
    from libcloudphxx_tpu_torch.lgrngn.condensation import cell_ends
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_Tpr
    from libcloudphxx_tpu_torch.lgrngn.state import StaticConfig
    rng = np.random.default_rng(seed)
    n_cell = len(counts)
    oi = opts_init_t()
    oi.nx, oi.nz, oi.dx, oi.dz, oi.x1, oi.z1 = n_cell, 1, 20.0, 20.0, \
        20.0 * n_cell, 20.0
    oi.exact_sstp_cond = True
    for k, v in dict(dict(sstp_cond=4), **opts).items():
        setattr(oi, k, v)
    cfg = StaticConfig.from_opts_init(oi)

    th = rng.uniform(289.0, 300.0, n_cell)
    rhod = rng.uniform(1.0, 1.15, n_cell)
    T = theta_dry.T(torch.tensor(th), torch.tensor(rhod))
    p = theta_dry.p(torch.tensor(rhod), torch.tensor(8e-3), T)
    rv = rng.uniform(0.95, 1.02, n_cell) * const_cp.r_vs(T, p).numpy()
    T, p, _, _ = hskpng_Tpr(cfg, torch.tensor(th), torch.tensor(rv),
                            torch.tensor(rhod), p)
    # the cells' T and p at the start of the step (the mean free paths')
    T_mfp = T.numpy() - rng.normal(0.1, 0.05, n_cell)
    p_mfp = p.numpy() * (1 + rng.uniform(0.0, 1e-3, n_cell))
    cell_vals = dict(th=th, rv=rv, rhod=rhod, p=p.numpy(),
                     dv=np.full(n_cell, 400.0), T_mfp=T_mfp, p_mfp=p_mfp,
                     T=T.numpy())

    sizes = np.array(counts)
    if cap is None:
        sizes[0] += dead0
    ijk = np.repeat(np.arange(n_cell), sizes)
    n_sd = ijk.size
    live = np.ones(n_sd, bool)
    if cap is None:
        live[rng.permutation(sizes[0])[:dead0]] = False
    rw = np.exp(rng.uniform(np.log(2e-8), np.log(3e-5), n_sd))
    rd3 = (rw * rng.uniform(0.05, 0.9, n_sd)) ** 3
    rw2 = np.where(live | (rng.random(n_sd) < 0.5), rw ** 2, 0.0)
    n = np.where(live, np.floor(10.0 ** rng.uniform(6, 8, n_sd)), 0.0)
    # the private state: a neighbouring cell's for a third of the SDs,
    # and the host model's increment (warmer, moister, denser) behind it
    src = np.where(rng.random(n_sd) < 1 / 3, (ijk + 1) % n_cell, ijk)
    private = dict(
        tmp_th=th[src] - rng.normal(0.2, 0.1, n_sd),
        tmp_rv=rv[src] * (1 - rng.uniform(0.0, 0.03, n_sd)),
        tmp_rh=rhod[src] * (1 - rng.uniform(0.0, 2e-3, n_sd)),
        tmp_p=cell_vals["p"][src] * (1 - rng.uniform(0.0, 1e-3, n_sd)))
    sd = dict(n=n, rw2=rw2, rd3=rd3, kpa=rng.uniform(0.1, 1.2, n_sd),
              vt=rng.uniform(0.0, 0.05, n_sd), **private)
    if cap is None:
        perm = rng.permutation(n_sd)
        sd = {k: v[perm] for k, v in sd.items()}
        ijk = torch.as_tensor(ijk[perm], device=device)
        sijk, order = torch.sort(ijk, stable=True)
        seg = (sijk, order, cell_ends(sijk, n_cell))
    else:
        rows = {k: np.zeros((n_cell, cap)) for k in sd}
        at = np.concatenate([[0], np.cumsum(sizes)])
        for c in range(n_cell):
            for k, v in sd.items():
                rows[k][c, :sizes[c]] = v[at[c]:at[c + 1]]
            if sizes[c] > 4:      # a hole: n == 0, rw2 kept
                rows["n"][c, sizes[c] // 2] = 0.0
        sd, seg = rows, None
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return (cfg, tuple(as_t(v) for v in sd.values()),
            tuple(as_t(v) for v in cell_vals.values()), seg)


def ice_cond_case(sizes, dead0=0, seed=0, device="cpu", dtype=torch.float64,
                  th_dry=True, const_p=False, sstp=4, frozen=0.5):
    """flat_cond_case's inputs in cold air, with ice: the cells at 235-255
    K and 0.9-1.02 of saturation over water (supersaturated over ice), a
    ``frozen`` share of the live SDs frozen (rw2 0, semi-axes of 1-50 um,
    aspect ratios 0.3-3, ice_rho 910 or 916.8 kg/m3), and the dead slots
    holding axes they died with.  Returns (cfg with ice_switch, kwargs of
    cond_flat without RH_max, var_rho and plain, ``ice`` included)."""
    from libcloudphxx_tpu_torch.common import const_cp, theta_dry, theta_std
    from libcloudphxx_tpu_torch.common import constants as c
    from libcloudphxx_tpu_torch.lgrngn.hskpng import hskpng_mfp
    cfg, kw = flat_cond_case(sizes, dead0, seed, "cpu", torch.float64,
                             th_dry, const_p, sstp)
    cfg = dataclasses.replace(cfg, ice_switch=True)
    rng = np.random.default_rng(seed + 1000)
    n_cell, n_sd = kw["th"].shape[0], kw["rw2"].shape[0]
    T = torch.tensor(rng.uniform(235.0, 255.0, n_cell), dtype=torch.float64)
    rhod = kw["rhod"]
    if th_dry:
        # th_dry: T = (th q)^(c_pd / (c_pd - R_d)), q of rhod
        th = T ** (1.0 - c.R_d / c.c_pd) / theta_dry.rhod_factor(rhod)
        p = theta_dry.p(rhod, torch.tensor(1e-3, dtype=torch.float64), T)
    else:
        p = kw["p"]
        th = T / theta_std.exner(p)
    rv = torch.tensor(rng.uniform(0.9, 1.02, n_cell)) * const_cp.r_vs(T, p)
    lam_D, lam_K = hskpng_mfp(T, p)
    live = kw["wgt"] > 0
    ice = torch.tensor(rng.random(n_sd) < frozen) & live
    a = torch.tensor(np.exp(rng.uniform(np.log(1e-6), np.log(5e-5), n_sd)))
    cc = a * torch.tensor(np.exp(rng.uniform(np.log(0.3), np.log(3.0),
                                             n_sd)))
    held = ice | (~live & torch.tensor(rng.random(n_sd) < 0.5))
    kw.update(
        th=th, rv=rv, p=p if not th_dry else kw["p"], lambda_D=lam_D,
        lambda_K=lam_K, delta_th=kw["delta_th"] * 0.2,
        delta_rv=rv * torch.tensor(rng.uniform(-2e-3, 4e-3, n_cell)),
        rw2=torch.where(ice, 0.0, kw["rw2"]),
        ice=(torch.where(held, a, 0.0), torch.where(held, cc, 0.0),
             torch.where(held, torch.tensor(
                 np.where(rng.random(n_sd) < 0.5, 910.0, 916.8)), 0.0)))
    out = {k: (tuple(a.to(device=device, dtype=dtype) for a in v)
               if k == "ice" else v.to(device=device, dtype=dtype)
               if v.is_floating_point() else v.to(device))
           for k, v in kw.items() if isinstance(v, (torch.Tensor, tuple))}
    return cfg, dict(kw, **out)


def dense3d_case(nx, ny, nz, cap, seed=0, device="cpu", dtype=torch.float64,
                 courant=0.6, **oi_kw):
    """A DenseState on a synthetic nx x ny x nz grid of 20 m cells at row
    capacity ``cap`` (the 3-D form of transport_case): rows at random
    occupancy, the first all dead, the second full, the dead slots of the
    odd rows scattered among their droplets; each droplet in its own cell
    or a neighbour's (x and y periodic), a few two levels up or down (far
    movers) or, in the bottom level, under the floor (the puddle); the
    rows around cell (1, 1, 1) send nine in ten of their droplets there,
    more than a row holds; a quarter of the droplets of the edge columns
    and rows of columns within 0.5 m of the side walls; staggered courants
    of all three axes up to ``courant`` (so that pred_corr's predictors
    leave their cells), droplets of 1-50 um.  ``oi_kw`` set opts_init
    fields.  Returns (cfg, DenseState)."""
    from libcloudphxx_tpu_torch.lgrngn import opts_init_t, vt_t
    from libcloudphxx_tpu_torch.lgrngn.dense import DenseState
    from libcloudphxx_tpu_torch.lgrngn.state import N_PUDDLE, StaticConfig
    rng = np.random.default_rng(seed + 1000 * cap + 100 * nx + 10 * ny + nz)
    oi = opts_init_t()
    for a, n in zip("xyz", (nx, ny, nz)):
        setattr(oi, "n" + a, n)
        setattr(oi, "d" + a, 20.0)
        setattr(oi, a + "1", 20.0 * n)
    oi.dt = 1.0
    oi.terminal_velocity = vt_t.beard77
    for k, v in oi_kw.items():
        setattr(oi, k, v)
    cfg = StaticConfig.from_opts_init(oi)
    n_cell = nx * ny * nz
    shape = (n_cell, cap)
    count = rng.integers(0, cap + 1, n_cell)
    count[:2] = (0, cap)
    alive = np.arange(cap)[None, :] < count[:, None]
    alive[1::2] = np.stack([rng.permutation(a) for a in alive[1::2]])
    r = np.repeat(np.arange(n_cell), cap).reshape(shape)
    i, j, k = r // (ny * nz), (r // nz) % ny, r % nz
    u = rng.random(shape)
    step = lambda: rng.integers(-1, 2, shape)
    ti = np.where(u < 0.3, i + step(), i) % nx
    tj = np.where(u < 0.3, j + step(), j) % ny
    tk = np.clip(np.where(u < 0.3, k + step(), k), 0, nz - 1)
    far = (u > 0.97) & (nz >= 4)
    tk = np.where(far, np.where(k + 2 < nz, k + 2, k - 2), tk)
    hot = (np.abs(i - 1) <= 1) & (np.abs(j - 1) <= 1) & (np.abs(k - 1) <= 1) \
        & (u < 0.9)
    ti, tj, tk = (np.where(hot, 1, a) for a in (ti, tj, tk))
    pos = lambda t: (t + rng.uniform(0.1, 0.9, shape)) * 20.0
    x, y, z = pos(ti), pos(tj), pos(tk)
    lane = np.arange(cap)[None, :]
    fall = (k == 0) & (((u > 0.9) & (u < 0.95)) | (lane == 0))
    z = np.where(fall, -1.0 - 5.0 * u, z)
    for a, idx, n in ((x, ti, nx), (y, tj, ny)):
        w = rng.uniform(1e-3, 0.5, shape)
        edge = rng.random(shape) < 0.25
        a[:] = np.where(edge & (idx == 0), w, a)
        a[:] = np.where(edge & (idx == n - 1), 20.0 * n - w, a)
    rw = np.exp(rng.uniform(np.log(1e-6), np.log(5e-5), shape))
    n = np.where(alive, np.floor(10.0 ** rng.uniform(5, 9, shape)), 0.0)
    T = rng.uniform(280.0, 295.0, n_cell)
    c = lambda *s: rng.uniform(-courant, courant, s).reshape(-1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    zero = t(np.zeros(shape))
    d = DenseState(
        n=t(n), rw2=t(rw ** 2), rd3=t((rw * rng.uniform(0.01, 0.2,
                                                        shape)) ** 3),
        kpa=t(rng.uniform(0.1, 1.2, shape)), vt=zero, x=t(x), z=t(z),
        rhod=t(rng.uniform(1.0, 1.2, n_cell)),
        p=t(rng.uniform(8.5e4, 1e5, n_cell)), T=t(T),
        RH=t(np.full(n_cell, 0.99)),
        eta=t(1.72e-5 * (393.0 / (T + 120.0)) * (T / 273.16) ** 1.5),
        dv=t(np.full(n_cell, 8e3)), sstp_tmp_th=t(np.full(n_cell, 289.0)),
        sstp_tmp_rv=t(np.full(n_cell, 8e-3)),
        courant_x=t(c(nx + 1, ny, nz)), courant_z=t(c(nx, ny, nz + 1)),
        puddle=t(np.zeros(N_PUDDLE)),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        y=t(y), courant_y=t(c(nx, ny + 1, nz)))
    return cfg, d
