"""The multi-device layer in two processes (libcloudphxx_tpu_torch/parallel/
twoproc.py, the counterpart of tools/dryrun_2proc.py and
tests/test_multiproc.py) on the CPU in float64: two gloo ranks x 4 shards
= one 8-shard mesh, each rank a fresh interpreter, at the JAX tool's
configuration.

The two-process flat front (coalescence on) and the two-process dense
mesh are held bitwise against the same functions run in this process on
all 8 shards; with coalescence off the gathered two-process flat front is
held against the JAX package's one-process particles_multi_t at
tests/test_torch_multi.py's tolerances (th atol 1e-9, rv atol 1e-12, the
population rtol 1e-9, the SD count a cell equal).  Each launch of the two
ranks has its own 120 s limit.
"""

import numpy as np
import pytest
import torch

from libcloudphxx_tpu import lgrngn as jl
from libcloudphxx_tpu_torch.ops.philox import shard_key
from libcloudphxx_tpu_torch.parallel import decomp, twoproc

RANK_TIMEOUT = 120.0
CPU = dict(device="cpu", dtype=torch.float64)
CPU_NAMES = dict(device="cpu", dtype="float64")
FLAT = [f"flat_{s}.pt" for s in range(twoproc.N_SHARDS)]
DENSE = [f"dense_{s}.pt" for s in range(twoproc.N_SHARDS)]


def _one_process(run, case="dryrun", **kw):
    """A run of this process on every shard, single-threaded as the ranks
    are (the shards' sums then add in the ranks' order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run(case, **CPU, **kw)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coal_run(tmp_path_factory):
    """The dryrun with coalescence in two processes, and in one."""
    out = tmp_path_factory.mktemp("twoproc")
    ranks = twoproc.launch(out / "two", timeout=RANK_TIMEOUT, **CPU_NAMES)
    (out / "one").mkdir()
    _, flat = _one_process(twoproc.run_flat, out=out / "one")
    dense = _one_process(twoproc.run_dense, out=out / "one")
    return out, ranks, flat, dense


def _shard_files(path):
    return [torch.load(path / name) for name in FLAT]


def _gathered_cells(path, name):
    """A cell field of the flat shards written to ``path``, unpadded into
    the global (nx * nz,) field."""
    cfg_g = twoproc.dryrun_opts_init(0)
    widths = decomp.slab_widths(cfg_g.nx, twoproc.N_SHARDS)
    nz = cfg_g.nz
    parts = [f[name].reshape(-1, nz)[:w] for f, w in
             zip(_shard_files(path), widths)]
    return torch.cat(parts).reshape(-1)


def test_flat_front_bitwise_two_processes(coal_run):
    """Every shard's State after 2 steps with coalescence, and the
    gathered th and rv, are bitwise the one-process front's."""
    out, ranks, _, _ = coal_run
    assert [r["flat"]["shards"] for r in ranks] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
    assert twoproc.same_files(out / "two", out / "one", FLAT) == []
    for f in _shard_files(out / "two"):
        assert int((f["n"] > 0).sum()) > 0
    for name in ("th", "rv"):
        assert torch.equal(_gathered_cells(out / "two", name),
                           _gathered_cells(out / "one", name))
    # the shards draw with their global index's key word
    keys = [f["rng_key"] for f in _shard_files(out / "two")]
    assert keys == [shard_key(s) for s in range(twoproc.N_SHARDS)]


def test_flat_front_invariants(coal_run):
    """The dryrun's checks (tools/dryrun_2proc.py:80-91): all finite, the
    total multiplicity only lost to the open z walls and coalescence,
    read alike on both ranks and in one process; no SD past a full
    migration buffer."""
    _, ranks, flat, _ = coal_run
    f0, f1 = ranks[0]["flat"], ranks[1]["flat"]
    for k in ("total0", "total1", "finite", "migration_overflow"):
        assert f0[k] == f1[k] == flat[k], k
    assert f0["finite"]
    assert 0 < f0["total1"] <= f0["total0"]
    assert f0["total1"] > 0.9 * f0["total0"]
    assert f0["migration_overflow"] == 0.0


def test_dense_mesh_bitwise_two_processes(coal_run):
    """The two-process dense mesh (2 steps, buf 32, sstp_coal 2) is
    bitwise the one-process mesh, with no SD dropped and the crossings
    summed over the ranks."""
    out, ranks, _, dense = coal_run
    assert twoproc.same_files(out / "two", out / "one", DENSE) == []
    for r in ranks:
        d = r["dense"]
        assert d["overflow"] == 0.0 and d["finite"]
        for k in ("total0", "total1", "crossed"):
            assert d[k] == dense[k], k
        assert 0 < d["total1"] <= d["total0"]
        assert d["total1"] > 0.9 * d["total0"]
    assert dense["crossed"] > 0


def test_dense_mesh_pred_corr_bitwise_two_processes(tmp_path):
    """The dense mesh under pred_corr advection: its halo-2 courant
    exchange (at the load) and its movers crossing between the ranks, the
    two-process mesh is bitwise the one-process mesh after 2 steps, with
    no SD dropped and the crossings summed over the ranks."""
    ranks = twoproc.launch(tmp_path / "two", case="dryrun_pred_corr",
                           steps=1, timeout=RANK_TIMEOUT, **CPU_NAMES)
    (tmp_path / "one").mkdir()
    dense = _one_process(twoproc.run_dense, "dryrun_pred_corr",
                         out=tmp_path / "one")
    assert twoproc.same_files(tmp_path / "two", tmp_path / "one",
                              DENSE) == []
    for r in ranks:
        d = r["dense"]
        assert d["overflow"] == 0.0 and d["finite"]
        for k in ("total0", "total1", "crossed"):
            assert d[k] == dense[k], k
    assert dense["crossed"] > 0
    assert ranks[0]["dense"]["launches"] == {}      # the CPU runs no kernel


@pytest.mark.parametrize("call", ["get_attr", "outbuf", "diag_sd_conc",
                                  "save", "sync_out", "sources"])
def test_two_process_front_refuses_host_fetches(coal_run, call):
    """What would fetch the whole population to one process raises on
    both ranks, as in the JAX package's multi-controller run, and so do
    the sources and the relaxation, which act on it on the host."""
    for r in coal_run[1]:
        msg = r["refusals"][call]
        assert msg.startswith("NotImplementedError") and \
            "process group" in msg, (call, msg)


def test_pred_corr_bitwise_two_processes(tmp_path):
    """pred_corr advection's halo-2 courant exchange across the ranks: the
    two-process flat front is bitwise the one-process front after 2
    steps."""
    ranks = twoproc.launch(tmp_path / "two", case="dryrun_pred_corr",
                           dense_steps=0, timeout=RANK_TIMEOUT, **CPU_NAMES)
    (tmp_path / "one").mkdir()
    _, flat = _one_process(twoproc.run_flat, "dryrun_pred_corr",
                           out=tmp_path / "one")
    assert twoproc.same_files(tmp_path / "two", tmp_path / "one", FLAT) == []
    for r in ranks:
        f = r["flat"]
        assert f["finite"] and f["migration_overflow"] == 0.0
        assert f["total1"] == flat["total1"]


def test_two_process_front_refuses_an_uneven_split(coal_run):
    for r in coal_run[1]:
        assert r["refusals"]["three_shards"] == (
            "ValueError: multi-device layer: 3 shards do not split evenly "
            "over 2 processes")


class _Group:
    """A stand-in process group of ``size`` ranks on ``backend``."""

    def __init__(self, backend, size, rank=0):
        self.backend, self.size, self.rank = backend, size, rank


@pytest.fixture
def fake_dist(monkeypatch):
    dist = decomp.dist
    monkeypatch.setattr(dist, "get_backend", lambda g: g.backend)
    monkeypatch.setattr(dist, "get_world_size", lambda g: g.size)
    monkeypatch.setattr(dist, "get_rank", lambda g: g.rank)


def test_ownership_blocks_and_refusals(fake_dist):
    """Rank r of P owns the shards [r S / P, (r + 1) S / P); an NCCL group
    and S % P != 0 are refused."""
    assert decomp.owned_shards(8) == range(8)
    assert decomp.owned_shards(8, _Group("gloo", 2, 1)) == range(4, 8)
    assert decomp.owned_shards(8, _Group("gloo", 4, 2)) == range(4, 6)
    with pytest.raises(ValueError, match="do not split evenly"):
        decomp.owned_shards(6, _Group("gloo", 4))
    with pytest.raises(NotImplementedError, match="NCCL, one process a card"):
        decomp.owned_shards(8, _Group("nccl", 2))
    st = torch.zeros(3)
    dom = decomp.ShardDomain(0, 1, torch.device("cpu"), 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="gloo only"):
        decomp.ring_exchange([[st]], [[st]], [dom], _Group("nccl", 2))


def test_ring_exchange_in_one_process_is_the_roll():
    """Without a group every shard gets its left neighbour's right-going
    payload and its right neighbour's left-going one, the ring wrapping."""
    doms = [decomp.ShardDomain(s, 1, torch.device("cpu"), 0.0, 1.0)
            for s in range(4)]
    to_l = [[torch.tensor([10.0 * s]), torch.tensor([s], dtype=torch.int64)]
            for s in range(4)]
    to_r = [[torch.tensor([100.0 + s])] for s in range(4)]
    from_l, from_r = decomp.ring_exchange(to_l, to_r, doms)
    for s in range(4):
        assert torch.equal(from_l[s][0], to_r[(s - 1) % 4][0])
        assert torch.equal(from_r[s][0], to_l[(s + 1) % 4][0])
        assert torch.equal(from_r[s][1], to_l[(s + 1) % 4][1])


def test_ring_messages_round_trip_bitwise():
    """A payload staged as one host message comes back bit for bit, each
    tensor of its dtype and shape (bool lanes, int64 counts, float64
    planes at odd byte offsets, a scalar)."""
    rng = np.random.default_rng(3)
    pay = [torch.tensor(rng.uniform(size=5) > 0.5),
           torch.tensor(rng.normal(size=(3, 7))),
           torch.tensor(7, dtype=torch.int64),
           torch.tensor(rng.normal(size=4), dtype=torch.float32),
           torch.zeros(0)]
    back = decomp._from_bytes(decomp._to_bytes(pay), pay,
                              torch.device("cpu"))
    for a, b in zip(pay, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _jax_opts_init():
    """tools/dryrun_2proc.py's opts_init, for the JAX package."""
    nx, nz = 19, 8
    oi = jl.opts_init_t()
    oi.nx, oi.nz = nx, nz
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = nx * oi.dx, nz * oi.dz
    oi.dt = 1.0
    oi.sd_conc = 4
    oi.n_sd_max = nx * nz * 8
    oi.dry_distros = {(0.61, 0.0): twoproc._lognormal}
    oi.kernel = jl.kernel_t.geometric
    oi.terminal_velocity = jl.vt_t.beard77fast
    oi.sstp_cond = 2
    oi.sstp_coal = 2
    oi.dev_count = twoproc.N_SHARDS
    return oi


def test_flat_front_against_jax(tmp_path):
    """With coalescence off the two-process front, gathered, agrees with
    the JAX package's one-process particles_multi_t after the dryrun's 2
    steps (sync_in + step_cond without sync-out + step_async)."""
    ranks = twoproc.launch(tmp_path, coal=False, dense_steps=0,
                           timeout=RANK_TIMEOUT, **CPU_NAMES)
    assert ranks[0]["flat"]["migration_overflow"] == 0.0
    jm = jl.factory(jl.backend_t.multi_CUDA, _jax_opts_init())
    f = twoproc.dryrun_fields()
    jm.init(f["th"], f["rv"], f["rhod"], Cx=f["Cx"], Cz=f["Cz"])
    opts = jl.opts_t()
    opts.chem_dsl = False
    opts.coal = False
    for _ in range(2):
        jm.sync_in(th=f["th"], rv=f["rv"], rhod=f["rhod"])
        jm.step_cond(opts)
        jm.step_async(opts)
    np.testing.assert_allclose(_gathered_cells(tmp_path, "th").numpy(),
                               jm._cell_to_host(jm.state.th), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_gathered_cells(tmp_path, "rv").numpy(),
                               jm._cell_to_host(jm.state.rv), rtol=0,
                               atol=1e-12)
    cfg = twoproc.dryrun_opts_init(0)
    widths = decomp.slab_widths(cfg.nx, twoproc.N_SHARDS)
    col0 = np.concatenate([[0], np.cumsum(widths)])[:-1]
    cols, cells = [], []
    for sf, c0 in zip(_shard_files(tmp_path), col0):
        live = (sf["n"] > 0).numpy()
        cols.append(np.stack([
            sf["x"].numpy()[live] + c0 * cfg.dx, sf["z"].numpy()[live],
            sf["n"].numpy()[live], sf["rw2"].numpy()[live]]))
        cells.append(sf["ijk"].numpy()[live] + c0 * cfg.nz)
    port = np.concatenate(cols, 1)
    port = port[:, np.lexsort(port)]
    n = jm.get_attr("n")
    live = n > 0
    jax = np.stack([jm.get_attr(k)[live] if k != "n" else n[live]
                    for k in ("x", "z", "n", "rw2")])
    jax = jax[:, np.lexsort(jax)]
    assert port.shape == jax.shape
    np.testing.assert_allclose(port, jax, rtol=1e-9, atol=1e-12)
    jm.diag_all()
    jm.diag_sd_conc()
    np.testing.assert_array_equal(
        np.bincount(np.concatenate(cells), minlength=cfg.nx * cfg.nz),
        jm.outbuf())
