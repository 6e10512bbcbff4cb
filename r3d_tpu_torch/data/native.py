"""ctypes bindings for the port's native host loader (``native/fastloader.cpp``).

Counterpart of ``r3d_tpu/data/native.py``: ``probe`` reads a .npy header,
``load_sliced`` reads one video's observed window (rows ``[0, observed)``
at a stride, zero-padded to ``out_rows``) straight into a float32 buffer,
``load_batch`` does so for a batch with one thread per item. Each returns
None when the file cannot be read natively (missing, Fortran order, a dtype
other than ``<f4``/``<f8``, a row width other than the one asked for), and
the caller falls back to NumPy for that file.

The library builds at first use with the host's C++ compiler (``$CXX``,
else ``g++``, else ``c++``, as nvcc picks its host compiler) into
``build/native/<hash>/libfastloader.so`` at the root of the checkout
(git-ignored), ``<hash>`` covering the source, the compiler and its flags.
Each build writes a name of its own and renames it into place, so that
processes building at the same moment each see a whole library.

One difference from JAX, kept on purpose: where the library cannot be
built, ``get_lib`` raises ``NativeBuildError`` quoting the compiler, where
JAX's quietly falls back to NumPy for every file. A caller that asked for
the native loader learns that it never ran.

``STATS`` counts, as the kernel wrappers count their launches, the examples
a ``cache='native'`` source served natively (``loads``), those it served
through NumPy (``fallbacks``), and the native examples whose depth file the
loader could not read (``depth_misses``; JAX gives such an example no depth
stream, ``r3d_tpu/data/datasets.py:338-352``). Callers may reset them to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "fastloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    """The native loader's library could not be built or loaded."""


class Stats:
    """Examples served by a ``cache='native'`` source, by path. Loader
    threads count through ``count``, under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.loads = 0
        self.fallbacks = 0
        self.depth_misses = 0

    def count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def as_dict(self) -> dict:
        return {"loads": self.loads, "fallbacks": self.fallbacks,
                "depth_misses": self.depth_misses}


STATS = Stats()

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise NativeBuildError("no C++ compiler: set $CXX, or install g++ or c++")


def lib_path(cxx: Optional[str] = None) -> Path:
    """Where the library for this source, compiler and flags lives."""
    cxx = cxx or compiler()
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfastloader.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``NativeBuildError`` with the compiler's output on failure."""
    cxx = compiler()
    so = lib_path(cxx)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed (rc {out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise NativeBuildError(f"cannot load {so}: {e}") from e
            lib.npy_probe.restype = ctypes.c_int64
            lib.npy_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.load_sliced.restype = ctypes.c_int64
            lib.load_sliced.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.load_batch.restype = ctypes.c_int64
            lib.load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except NativeBuildError:
        return False
    return True


def probe(path: str) -> Optional[Tuple[Tuple[int, ...], int]]:
    """(shape, word size) of a .npy file from its header alone, or None."""
    shape = (ctypes.c_int64 * 8)()
    ws = ctypes.c_int64()
    nd = get_lib().npy_probe(path.encode(), shape, 8, ctypes.byref(ws))
    if nd < 0:
        return None
    return tuple(int(shape[i]) for i in range(nd)), int(ws.value)


def load_sliced(path: str, observed_len: int, stride: int, out_rows: int, row_elems: int,
                transpose: bool = False) -> Optional[Tuple[np.ndarray, int]]:
    """Read, slice, subsample and zero-pad one video into [out_rows,
    row_elems] float32. Returns (array, rows loaded), or None where the file
    cannot be read natively."""
    lib = get_lib()
    out = np.empty((out_rows, row_elems), np.float32)
    n = lib.load_sliced(path.encode(), observed_len, stride,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        out_rows, row_elems, int(transpose))
    if n < 0:
        return None
    return out, int(n)


def load_batch(paths: Sequence[str], observed_lens: Sequence[int], stride: int, out_rows: int,
               row_elems: int, transpose: bool = False
               ) -> Optional[Tuple[np.ndarray, List[int]]]:
    """``load_sliced`` for a batch, one thread per item (up to 8) ->
    ([B, out_rows, row_elems] float32, rows loaded per item), or None if any
    item cannot be read natively."""
    lib = get_lib()
    B = len(paths)
    out = np.empty((B, out_rows, row_elems), np.float32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    c_lens = (ctypes.c_int64 * B)(*observed_lens)
    c_rows = (ctypes.c_int64 * B)()
    failed = lib.load_batch(c_paths, c_lens, stride, B,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            out_rows, row_elems, int(transpose), c_rows)
    if failed != 0:
        return None
    return out, [int(c_rows[i]) for i in range(B)]
