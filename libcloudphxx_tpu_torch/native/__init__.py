"""The C core of the reference-compatible SD init (refinit_core.c): the
reference serial backend's mt19937 u01 stream and glibc's float32 logf and
expf on whole arrays (the port's copy of libcloudphxx_tpu/native).

At first use the system C compiler builds it into the package's ``_build/``
directory (which git ignores), under a name that carries a hash of the
source, and ctypes loads it.  There is no fallback: without a C compiler
load() raises, since numpy's float32 log and exp differ from glibc's in
the last bit, which the bit-exact init cannot take.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "refinit_core.c"
BUILD = Path(__file__).resolve().parent.parent / "_build"
_LIB = None
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"refinit_core_{digest}.so"


def _build(out: Path):
    """Compile the source into ``out`` (through a temporary file, so that a
    concurrent process never loads a half-written library)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    errors = []
    for cc in ("cc", "gcc", "clang"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            subprocess.run([cc, "-O2", "-fPIC", "-shared", "-o", tmp,
                            str(SRC), "-lm"], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, out)
            return
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cc}: {e}")
            os.unlink(tmp)
    raise RuntimeError("the reference-compatible init needs a C compiler to "
                       "build refinit_core.c; none worked: "
                       + "; ".join(errors))


def load():
    """The loaded library, built first if need be."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.mt19937_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.mt19937_u01.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64]
        lib.vec_logf.argtypes = [_F32P, _F32P, ctypes.c_int64]
        lib.vec_expf.argtypes = [_F32P, _F32P, ctypes.c_int64]
        _LIB = lib
    return _LIB


class MT19937State:
    """An mt19937 state in native memory (624 words and the index), seeded
    as std::mt19937(seed)."""

    def __init__(self, seed: int):
        self._buf = ctypes.create_string_buffer(624 * 4 + 8)
        load().mt19937_seed(ctypes.cast(self._buf, ctypes.c_void_p),
                            ctypes.c_uint32(seed))

    def u01(self, n: int) -> np.ndarray:
        """The next ``n`` float32 draws in [0, 1]: float(u32) / 2^32."""
        out = np.empty(n, np.float32)
        load().mt19937_u01(ctypes.cast(self._buf, ctypes.c_void_p),
                           out.ctypes.data_as(_F32P), ctypes.c_int64(n))
        return out


def _vec(fname, a):
    shape = np.shape(a)  # ascontiguousarray makes a 0-d array 1-d
    a = np.ascontiguousarray(a, np.float32)
    out = np.empty_like(a)
    getattr(load(), fname)(a.ctypes.data_as(_F32P), out.ctypes.data_as(_F32P),
                           ctypes.c_int64(a.size))
    return out.reshape(shape)


def vec_logf(a):
    """glibc logf of every element, float32."""
    return _vec("vec_logf", a)


def vec_expf(a):
    """glibc expf of every element, float32."""
    return _vec("vec_expf", a)
