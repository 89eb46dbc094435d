"""Build and load the port's CUDA kernels (csrc/), and count their launches.

The kernels are CUDA C++ for sm_90a with a plain C interface: nvcc compiles
every csrc/*.cu into one shared library at first use, into ``_build/``
beside this file (a directory git ignores), and ctypes loads it.  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import: tests import every module on machines
without nvcc or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


class Kernel:
    """One hand-written kernel: its C entry point, the TPU kernel it
    replaces, and ``launches``, the number of times a wrapper launched it
    (reset it to 0 to count a run)."""

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # the stream comes last
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, *args):
        """Launch on PyTorch's current stream; raise if the launch failed."""
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            msg = load().lcp_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed, CUDA error "
                               f"{err} ({msg})")
        self.launches += 1


MPDATA = Kernel(
    "mpdata", "lcp_mpdata", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
    "libcloudphxx_tpu_torch/csrc/mpdata.cu",
    "libcloudphxx_tpu/models/mpdata.py:256 (advect2; advect :226)")
COND = Kernel(
    "cond", "lcp_cond",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _I, _I, _I, _I],
    "libcloudphxx_tpu_torch/csrc/cond.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, cond phase :191-231)")
TRANSPORT = Kernel(
    "transport", "lcp_transport",
    [_P] * 12 + [_I, _I, _I, _I] + [_D] * 7 + [_I] * 4,
    "libcloudphxx_tpu_torch/csrc/transport.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:115 (_kernel, transport and "
    "re-bin classification :338-487)")
MERGE = Kernel(
    "merge", "lcp_merge", [_P] * 16 + [_I, _I, _I, _I],
    "libcloudphxx_tpu_torch/csrc/merge.cu",
    "libcloudphxx_tpu/ops/pallas_step.py:716 (_xmerge_kernel) and :405 "
    "(_kernel z-merge epilogue)")
KERNELS = (MPDATA, COND, TRANSPORT, MERGE)

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"libcloudphxx_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("building the kernels needs nvcc (the CUDA toolkit); "
                       "none was found")


def build(verbose=False):
    """Compile csrc/ unless the library for these sources exists.  Returns
    (path, seconds spent compiling, compiler output).  With ``verbose`` the
    compiler also reports each kernel's registers and shared memory."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, cu)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def load():
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.lcp_error_string.argtypes = [_I]
        lib.lcp_error_string.restype = ctypes.c_char_p
        lib.lcp_mpdata_smem_bytes.argtypes = [_I, _I, _I]
        lib.lcp_mpdata_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def check(name, *tensors, dtype=torch.float32):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one device — what each kernel takes."""
    dev = tensors[0].device
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors lie on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must lie on one CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
