"""Kernel F's entry on the CPU (ops/cond.py cond_flat, the flat engine's
per-cell condensation substep loop): the per-cell segment table it reads
against numpy, the wrapper's argument checks and its dispatch to the plain
loop, and the C entry points of every kernel against the argument types
the ctypes bindings pass.

The dispatch is checked bitwise: on a CPU tensor the wrapper runs the plain
version itself.  The plain loop's physics against the JAX package is in
test_torch_flat_engine.py (cond_percell under each closure).
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch_parity import flat_cond_case

from libcloudphxx_tpu_torch import _ext
from libcloudphxx_tpu_torch.lgrngn.condensation import cell_ends
from libcloudphxx_tpu_torch.ops import cond as cond_ops

# cells' sizes (SDs, live and dead): the GMD case's ~64 with an empty cell,
# empty cells before and after the rest, cell 0 holding thousands of dead
# slots, every cell empty, one cell
SEGMENTS = {
    "gmd": [64, 57, 0, 71, 64, 90, 33, 64],
    "empty_head": [0, 0, 5, 3, 0, 9],
    "empty_tail": [4, 2, 7, 0, 0],
    "dead_cell0": [5064, 64, 0, 70],
    "all_empty": [0, 0, 0],
    "one_cell": [300],
}
CONFIGS = {
    "th_dry": dict(), "var_rho": dict(var_rho=True),
    "th_std": dict(th_dry=False), "const_p": dict(const_p=True),
}


@pytest.mark.parametrize("case", list(SEGMENTS))
def test_cell_ends_match_numpy(case):
    """cell_ends on a cell-sorted SD order: the last position of each
    cell, -1 for empty cells before any SD, and each cell's run
    [ends[c-1] + 1, ends[c]] holding that cell alone."""
    sizes = np.array(SEGMENTS[case])
    sijk = np.repeat(np.arange(sizes.size), sizes)
    ends = cell_ends(torch.as_tensor(sijk), sizes.size)
    assert ends.dtype == torch.int64 and ends.shape == (sizes.size,)
    np.testing.assert_array_equal(ends.numpy(), np.cumsum(sizes) - 1)
    begin = 0
    for c, e in enumerate(ends.tolist()):
        assert (sijk[begin:e + 1] == c).all() and e + 1 - begin == sizes[c]
        begin = e + 1


_CTYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint32,
           "double": ctypes.c_double, "long long": ctypes.c_longlong,
           "cudaStream_t": ctypes.c_void_p}


def _c_params(source, symbol):
    """The ctypes type of each parameter of ``symbol`` in a csrc file."""
    text = (_ext.CSRC / source.rsplit("/", 1)[1]).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, f"{symbol} not found in {source}"
    out = []
    for p in m.group(1).split(","):
        decl = " ".join(p.split())
        if "*" in decl:
            out.append(ctypes.c_void_p)
        else:
            out.append(_CTYPES[decl.rsplit(" ", 1)[0].replace("const ", "")])
    return out


@pytest.mark.parametrize("kernel", _ext.KERNELS, ids=lambda k: k.name)
def test_bindings_match_the_c_entry_points(kernel):
    """What the wrapper passes through ctypes is what the C entry point
    takes, parameter for parameter (a mismatch would launch with garbage
    on the card)."""
    assert kernel.argtypes == _c_params(kernel.source, kernel.symbol)


def _case(config, dtype, sizes=SEGMENTS["gmd"], dead0=0):
    over = dict(CONFIGS[config])
    var_rho = over.pop("var_rho", False)
    cfg, kw = flat_cond_case(sizes, dead0, 0, "cpu", dtype, **over)
    return cfg, dict(kw, var_rho=var_rho, RH_max=44.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cond_flat_runs_the_plain_loop_on_the_cpu(config, dtype):
    """On CPU tensors the wrapper is its plain version, with or without
    ``plain``, and launches nothing; the droplets grow, and an empty cell
    takes its increments alone."""
    cfg, kw = _case(config, dtype)
    before = _ext.COND_FLAT.launches
    got = cond_ops.cond_flat(cfg, **kw)
    want = cond_ops.cond_flat_plain(cfg, **kw)
    again = cond_ops.cond_flat(cfg, **kw, plain=True)
    assert _ext.COND_FLAT.launches == before
    for a, b, c in zip(got, want, again):
        assert a.dtype == dtype and torch.equal(a, b) and torch.equal(a, c)
    rw2 = got[0]
    assert float((torch.abs(rw2 - kw["rw2"]) / kw["rw2"]).max()) > 1e-3
    th, rv = kw["th"], kw["rv"]
    for _ in range(kw["sstp"]):
        th = th + kw["delta_th"] / kw["sstp"]
        rv = rv + kw["delta_rv"] / kw["sstp"]
    assert torch.equal(got[1][2], th[2]) and torch.equal(got[2][2], rv[2])
    assert not torch.equal(got[1][0], th[0])
    if kw["var_rho"]:
        assert not torch.equal(got[3], kw["rhod"])
    else:
        assert got[3] is kw["rhod"]


def test_dead_slots_do_not_feed_the_cells():
    """Cell 0's 3,000 dead slots (weight 0) leave the cells as they are,
    whatever rw2 they hold: what lets kernel F skip them."""
    cfg, kw = _case("var_rho", torch.float64, dead0=3000)
    dead = kw["wgt"] == 0
    assert int(dead.sum()) == 3000 and bool((kw["rw2"][dead] > 0).any())
    a = cond_ops.cond_flat(cfg, **kw)
    b = cond_ops.cond_flat(cfg, **dict(kw, rw2=torch.where(dead, 0.0,
                                                            kw["rw2"])))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert torch.equal(a[0][~dead], b[0][~dead])


@pytest.mark.parametrize("bad", ["sd_length", "sd_2d", "cell_field",
                                 "ends", "device"])
def test_cond_flat_refuses_bad_arguments(bad):
    """Shapes are checked before the dispatch, on every device; a device
    that is neither the CPU nor CUDA has no kernel."""
    cfg, kw = _case("th_dry", torch.float32)
    over, match = {
        "sd_length": ({"kpa": kw["kpa"][:-1]}, "one length"),
        "sd_2d": ({"vt": kw["vt"][:, None]}, "1-D"),
        "cell_field": ({"dv": kw["dv"][:-1]}, "cell fields"),
        "ends": ({"ends": kw["ends"][:-1]}, "cell fields and ends"),
        "device": ({k: v.to("meta") for k, v in kw.items()
                    if isinstance(v, torch.Tensor)}, "no kernel"),
    }[bad]
    with pytest.raises(ValueError, match=match):
        cond_ops.cond_flat(cfg, **dict(kw, **over))


def _diag_outputs(prt):
    """The diagnostics that read rw2, as {name: array}."""
    out = {}
    for name, select, diag in (
            ("wet_mom3", lambda: prt.diag_wet_rng(0.0, 1.0),
             lambda: prt.diag_wet_mom(3)),
            ("wet_sd_conc", lambda: prt.diag_wet_rng(1e-6, 1.0),
             prt.diag_sd_conc),
            ("precip", prt.diag_all, prt.diag_precip_rate),
            ("max_rw", prt.diag_all, prt.diag_max_rw)):
        select()
        diag()
        out[name] = np.array(prt.outbuf())
    return out


def test_dead_slots_rw2_reaches_only_the_raw_dumps():
    """Kernels B and F keep a dead slot's rw2 where the plain versions
    advance it.  Nothing reads a dead slot's rw2 but the raw dumps
    (get_attr, save): with dead slots holding rw2 = 0 or random positive
    values, the diagnostics and three coalescing steps of the flat engine
    give the same cells and live droplets, bit for bit."""
    from libcloudphxx_tpu_torch import Kinematic2D
    rng = np.random.default_rng(11)
    runs = []
    for fill in (False, True):
        m = Kinematic2D(nx=4, nz=4, sd_conc=8, n_sd_max=8 * 16 + 24,
                        sstp_cond=2, sstp_coal=2, device="cpu",
                        dtype=torch.float64,
                        opts_init_kw={"kernel_parameters": [100.0]})
        st = m.prtcls.state
        dead = st.n == 0
        assert int(dead.sum()) == 24
        vals = torch.as_tensor(rng.uniform(1e-14, 1e-8, dead.shape)) \
            if fill else torch.zeros_like(st.rw2)
        m.prtcls.state = dataclasses.replace(
            st, rw2=torch.where(dead, vals, st.rw2))
        before = _diag_outputs(m.prtcls)
        m.run(3)
        st = m.prtcls.state
        live = st.n > 0
        runs.append((before, _diag_outputs(m.prtcls), m.th, m.rv, st.n,
                     {k: getattr(st, k)[live]
                      for k in ("rw2", "rd3", "kpa", "x", "z", "vt", "ijk")}))
    (b0, a0, th0, rv0, n0, sd0), (b1, a1, th1, rv1, n1, sd1) = runs
    for d0, d1 in ((b0, b1), (a0, a1)):
        for k in d0:
            np.testing.assert_array_equal(d0[k], d1[k], err_msg=k)
    assert torch.equal(th0, th1) and torch.equal(rv0, rv1)
    assert torch.equal(n0, n1) and float(n0.sum()) > 0
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
