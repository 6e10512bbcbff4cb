"""Build and load the port's CUDA kernels.

Each source in ``r3d_tpu_torch/csrc/`` is compiled by nvcc for ``sm_90a``
into a shared library of its own with a plain C interface, and loaded with
``ctypes``. Builds happen at first use, into ``build/kernels/<hash>/`` at the
root of the checkout (git-ignored), where ``<hash>`` covers every file in
``csrc/`` and the flags, so an unchanged source is built once per checkout.
``build_all`` starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile each named source (e.g. ``"attention.cu"``) that is not built
    yet, one nvcc process each, all started together. Returns source -> path
    of its library. Raises with nvcc's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / (Path(src).stem + ".so") for src in sources}
    procs: List = []
    for src, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{src} (rc {rc}):\n{lib.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


class Kernel:
    """One hand-written CUDA kernel: its source, its exported C launcher and
    the number of times the wrapper has launched it (``launches``, a plain
    integer that callers may reset to 0)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build([self.source])[self.source]))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                lib.r3d_error_string.argtypes = [ctypes.c_int]
                lib.r3d_error_string.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def query(self, symbol: str, argtypes: Sequence):
        """Another exported C function of this kernel's library, one that
        launches nothing (a query of the card, such as its occupancy): not
        counted."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the launcher (it enqueues on the stream passed in ``args``
        and returns the launch's error code); raise unless it is 0."""
        err = self.load()(*args)
        if err != 0:
            msg = self._lib.r3d_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def check_device(fn: str, t) -> None:
    """Raise unless ``t`` is on the CPU or a CUDA card: the port's operators
    are registered for those two only, and a tensor on another device (such
    as ``meta``) must not get their fake implementation as a result."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {t.device}")


def build_all(kernels: Sequence[Kernel]) -> None:
    """Build every kernel's source in parallel, then load each."""
    build([k.source for k in kernels])
    for k in kernels:
        k.load()
