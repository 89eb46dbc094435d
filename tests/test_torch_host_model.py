"""The port's host-model tooling (libcloudphxx_tpu_torch/models/cli.py and
utils/) against the JAX package's, on the CPU: the four cases of
tests/test_host_model.py that test them (the moment-spec mini-language,
the CLI end to end, the debug tier's NaN sweep, StepTimer), the port's
CLI against the JAX CLI snapshot by snapshot, and the debug sweep of the
dense front.

The CLIs are compared at 12x12 over 2 spin-up steps with the reference's
init (--reference_rng), both in float64, for each scheme: the spin-up
turns coalescence and sedimentation off (kinematic_2d.py:366-381), so no
random draw separates them.  The snapshots' datasets are stored as float32 (the
reference's); th and rv must agree to rtol 1e-10 and the moments to 1e-9,
which at float32 storage means the same float32 value, and puddle.dat
line for line.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from libcloudphxx_tpu.models import cli as jcli
from libcloudphxx_tpu_torch import lgrngn as tl
from libcloudphxx_tpu_torch.models import Kinematic2D, cli
from libcloudphxx_tpu_torch.utils import StepTimer, nancheck, nancheck_state

F64 = dict(device="cpu", dtype=torch.float64)


def lognormal(lnr):
    return (60e6 * np.exp(-(lnr - np.log(0.02e-6)) ** 2
                          / 2 / np.log(1.4) ** 2)
            / np.log(1.4) / np.sqrt(2 * np.pi))


def _read(path):
    """A snapshot's datasets (HDF5, or the npz fallback)."""
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path) as f:
            return {k: f[k][:] for k in f.keys()}
    with np.load(path) as f:
        return {k: f[k] for k in f.files if not k.startswith("attr_")}


def test_parse_outmoms():
    # the travis lgrngn spec fragments (opts_common.hpp:68-104)
    spec = ".5e-6:25e-6|0,1,2,3;25e-6:1|0,3"
    out = cli.parse_outmoms(spec)
    assert out == [((0.5e-6, 25e-6), [0, 1, 2, 3]), ((25e-6, 1.0), [0, 3])]
    assert cli.parse_outmoms("0:1|0") == [((0.0, 1.0), [0])]
    assert cli.parse_outmoms("") == []
    for s in (spec, "0:1|0", "", "\"1e-6:2e-6\"",
              ".5e-6:25e-6|0,1,2,3;25e-6:1|0,3,6"):
        assert cli.parse_outmoms(s) == jcli.parse_outmoms(s)


def test_cli_end_to_end(tmp_path):
    """A tiny lgrngn run through the port's CLI on the CPU writes const,
    the timestep snapshots and puddle.dat with the reference's dataset
    naming."""
    outdir = str(tmp_path / "out")
    res = cli.main([
        "--micro=lgrngn", "--nx=12", "--nz=12", "--nt=2", "--spinup=1",
        "--outfreq=2", f"--outdir={outdir}", "--sd_conc=8",
        "--out_wet=.5e-6:25e-6|0,3", "--out_dry=0:1|0", "--device=cpu",
    ])
    assert res["steps"] == 2
    names = sorted(os.listdir(outdir))
    assert any(n.startswith("const") for n in names)
    assert any(n.startswith("timestep0000000000") for n in names)
    assert any(n.startswith("timestep0000000002") for n in names)
    assert "puddle.dat" in names
    snap = [n for n in names if n.startswith("timestep0000000002")][0]
    f = _read(os.path.join(outdir, snap))
    assert {"th", "rv", "sd_conc", "rw_rng000_mom0", "rw_rng000_mom3",
            "rd_rng000_mom0", "rw3ofrd_rng000_mom3"} <= set(f)
    for v in f.values():
        assert v.shape == (12, 12) and np.isfinite(v).all()


def test_cli_debug_and_backend(tmp_path, monkeypatch):
    """--debug reaches the particles' NaN sweep, after step_cond and
    step_async of every step, and --backend reaches lgrngn.factory as the
    JAX CLI passes it (multi_CUDA with one device or none: the one-device
    engine, as the JAX factory gives)."""
    import importlib
    from libcloudphxx_tpu_torch.lgrngn import particles as tparticles
    tkin = importlib.import_module("libcloudphxx_tpu_torch.models."
                                   "kinematic_2d")
    swept, backends = [], []
    monkeypatch.setattr(tparticles.particles_t, "_nancheck",
                        lambda self, phase: swept.append(phase))
    factory = tl.factory

    def spy(backend, *a, **k):
        backends.append(backend)
        return factory(backend, *a, **k)

    monkeypatch.setattr(tkin, "factory", spy)
    args = ["--micro=lgrngn", "--nx=8", "--nz=8", "--nt=2", "--spinup=1",
            "--outfreq=2", "--sd_conc=4", "--device=cpu"]
    cli.main(args + [f"--outdir={tmp_path / 'a'}", "--debug",
                     "--backend=multi_CUDA"])
    assert swept == ["step_cond", "step_async"] * 2
    assert backends == [tl.backend_t.multi_CUDA]
    swept.clear()
    cli.main(args + [f"--outdir={tmp_path / 'b'}"])
    assert swept == [] and backends[-1] == tl.backend_t.serial


def _snapshots(outdir):
    return sorted(n for n in os.listdir(outdir) if n.startswith("timestep"))


# the datasets each scheme's snapshot must hold beside th and rv
SCHEME_KEYS = {"lgrngn": {"sd_conc", "rw_rng000_mom3", "rw3ofrd_rng000_mom3"},
               "lgrngn_chem": {"sd_conc", "chem_S_VI_aq", "chem_SO2_g"},
               "blk_1m": {"rc", "rr"}, "blk_2m": {"rc", "rr", "nc", "nr"}}


@pytest.mark.parametrize("micro", sorted(SCHEME_KEYS))
def test_cli_against_jax(tmp_path, micro):
    """The port's CLI and the JAX CLI, both in float64, over 2 spin-up
    steps (for lgrngn from the reference's init): every dataset of both
    snapshots and puddle.dat agree, for every scheme (the bulk branch and
    record_chem included)."""
    args = [f"--micro={micro}", "--nx=12", "--nz=12", "--nt=2",
            "--spinup=2", "--outfreq=2", "--reference_rng", "--sd_conc=8"]
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    cli.main(args + [f"--outdir={port}", "--device=cpu", "--dtype=float64"])
    jcli.main(args + [f"--outdir={jax}"])
    snaps = _snapshots(port)
    assert snaps == _snapshots(jax) and len(snaps) == 2
    for name in snaps:
        a, b = (_read(os.path.join(d, name)) for d in (port, jax))
        assert set(a) == set(b)
        assert {"th", "rv"} | SCHEME_KEYS[micro] <= set(a)
        for k in a:
            tol = 1e-10 if k in ("th", "rv") else 1e-9
            if k == "sd_conc":
                np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=0,
                                           err_msg=f"{name}:{k}")
    with open(os.path.join(port, "puddle.dat")) as fa, \
            open(os.path.join(jax, "puddle.dat")) as fb:
        assert fa.read().splitlines() == fb.read().splitlines()


def _parcel(debug):
    """tests/test_host_model.py's parcel of 16 SDs."""
    oi = tl.opts_init_t()
    oi.dt = 1.0
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.sd_conc = 16
    oi.n_sd_max = 16
    oi.terminal_velocity = tl.vt_t.beard76
    prt = tl.factory(tl.backend_t.serial, oi, debug=debug, **F64)
    th, rv, rhod = 300.0 * np.ones(1), 0.01 * np.ones(1), np.ones(1)
    prt.init(th.copy(), rv.copy(), rhod)
    return prt, th, rv


def test_debug_nancheck_names_phase():
    """debug=True catches a seeded NaN with the phase named (reference
    checknan.hpp semantics); without it the step runs on."""
    opts = tl.opts_t()
    opts.coal = False
    for debug in (True, False):
        prt, th, rv = _parcel(debug)
        prt.state = dataclasses.replace(
            prt.state, rw2=prt.state.rw2.clone().index_fill_(
                0, torch.tensor([0]), float("nan")))
        if debug:
            with pytest.raises(FloatingPointError, match="after step_cond"):
                prt.step_sync(opts, th, rv)
        else:
            prt.step_sync(opts, th, rv)


def test_debug_sweeps_the_dense_layout():
    """On the dense front the sweep reads the dense layout too: a NaN put
    into its planes after step_cond is named by step_async's sweep;
    Kinematic2D passes debug to its public API."""
    m = Kinematic2D(nx=8, nz=8, sd_conc=8, n_sd_max=8 * 64 * 2,
                    engine="dense", debug=True, **F64)
    assert m.prtcls.debug and type(m.prtcls).__name__ == "particles_dense_t"
    m.run(1, spinup=1)
    p = m.prtcls
    assert p._loc == "dense"
    m.advect_scalars()
    opts = m.opts
    opts.coal = opts.sedi = False
    p.step_sync(opts, m.th, m.rv, m.rhod)
    p._d = dataclasses.replace(p._d, x=torch.full_like(p._d.x, float("nan")))
    with pytest.raises(FloatingPointError,
                       match=r"x after step_async \(dense layout\)"):
        p.step_async(opts)


def test_debug_sweeps_each_shard():
    """On the multi-device front the sweep reads every shard and names
    the one that holds the NaN (by then in its cells too)."""
    oi = tl.opts_init_t()
    oi.nx, oi.nz = 8, 4
    oi.dx = oi.dz = 25.0
    oi.x1, oi.z1 = 200.0, 100.0
    oi.dt = 1.0
    oi.sd_conc = 8
    oi.n_sd_max = 8 * 4 * 8 * 2
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.terminal_velocity = tl.vt_t.beard77fast
    oi.kernel = tl.kernel_t.geometric
    oi.dev_count = 4
    prt = tl.factory(tl.backend_t.multi_CUDA, oi, debug=True, **F64)
    th, rv = np.full((8, 4), 289.99), np.full((8, 4), 7.5e-3)
    prt.init(th, rv, np.full((8, 4), 1.12), Cx=np.full((9, 4), 0.2),
             Cz=np.full((8, 5), 0.05))
    st = prt.state[2]
    prt.state[2] = dataclasses.replace(
        st, rw2=st.rw2.clone().index_fill_(0, torch.tensor([0]),
                                           float("nan")))
    opts = tl.opts_t()
    opts.coal = False
    with pytest.raises(FloatingPointError,
                       match=r"after step_cond \(shard 2\)"):
        prt.step_sync(opts, th, rv)


def test_nancheck_helpers():
    nancheck(np.ones(3), "ok")
    nancheck(torch.zeros(0), "empty")
    with pytest.raises(FloatingPointError, match="2 non-finite value"):
        nancheck(torch.tensor([1.0, float("inf"), float("nan")]), "v")
    st = dataclasses.make_dataclass("S", ["th", "n"])(
        torch.ones(2), torch.tensor([1.0, float("nan")]))
    with pytest.raises(FloatingPointError, match="n after cond"):
        nancheck_state(st, "cond")


def test_step_timer():
    t = StepTimer()
    with t("phase_a"):
        sum(range(1000))
    with t("phase_b", sync=torch.zeros(2)):
        pass
    with t("phase_b", sync="cpu"):
        pass
    rep = t.report()
    assert "phase_a" in rep and "phase_b" in rep
    assert t.counts["phase_b"] == 2
    t.reset()
    assert not t.totals and not t.counts
