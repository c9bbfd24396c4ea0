"""Build, load and launch the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds). A library is built at its
first use, from the sources in the repository only, into the package's
``_build/`` directory; :func:`build_all` starts every build at once, one
``nvcc`` per source. Nothing here runs at import time, so importing the
package needs neither ``nvcc`` nor a card.

A launch failure is an error: :meth:`CudaLibrary.call` (and
:meth:`CudaLibrary.run`, which counts no launch) raises when the C entry
point returns a nonzero ``cudaError_t``.

A wrapper called while a CUDA graph is captured launches nothing: its
kernel runs at each replay. :func:`launch_counts` and
:func:`move_captured_launches` let the capture take those calls out of the
counters, and :func:`count_replay` adds them back at every replay. Each
library counts its launches in all (``launches``) and per C entry point
(``entry_launches``: the gather's float32 and bf16-value paths apart).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from typing import Dict, List, Sequence

from citizensassemblies_tpu_torch.utils import native_build

CSRC = os.path.join(native_build.PKG_ROOT, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
    """Path of ``nvcc`` (PATH, then ``$CUDA_HOME/bin``, then the default
    toolkit location); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


#: every library of the package, in creation order
LIBRARIES: List["CudaLibrary"] = []


class CudaLibrary:
    """One kernel source, its shared library and its launch counter.

    ``functions`` maps each C entry point to ``(restype, argtypes)``;
    every pointer and the stream are ``ctypes.c_void_p``.
    """

    def __init__(self, name: str, source: str, headers: Sequence[str], functions: Dict):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.functions = functions
        #: kernel launches since the last reset (``chip_smoke.py`` zeroes it
        #: before driving the main path and reads it after)
        self.launches = 0
        #: the same launches per C entry point
        self.entry_launches: Dict[str, int] = {}
        #: ptxas resource report of the build in this process, if it built
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        LIBRARIES.append(self)

    def reset_counts(self) -> None:
        """Zero the launch counters (outside a graph capture)."""
        self.launches = 0
        self.entry_launches.clear()

    def start_build(self):
        cmd = [nvcc()] + NVCC_FLAGS + [f"-I{CSRC}"]
        return native_build.start_build(self.name, [self.source], cmd, self.headers)

    def _load(self, path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for fname, (restype, argtypes) in self.functions.items():
            fn = getattr(lib, fname)
            fn.restype = restype
            fn.argtypes = argtypes
        return lib

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        with self._lock:
            if self._lib is None:
                path, log = native_build.finish_build(*self.start_build())
                self.build_log = log or self.build_log
                self._lib = self._load(path)
            return self._lib

    def call(self, fname: str, *args) -> int:
        """Launch through C entry point ``fname`` and count the launch;
        raises on a nonzero CUDA error code."""
        rc = self.run(fname, *args)
        self.launches += 1
        self.entry_launches[fname] = self.entry_launches.get(fname, 0) + 1
        return rc

    def run(self, fname: str, *args) -> int:
        """Call C entry point ``fname`` without counting a launch (a query,
        or a measurement kernel that is not the library's own); raises on a
        nonzero CUDA error code."""
        rc = getattr(self.lib(), fname)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fname} failed with cudaError_t {rc}")
        return rc


def launch_counts() -> List[Dict[str, int]]:
    """Every library's launch counts per C entry point, in
    :data:`LIBRARIES` order."""
    return [dict(lib.entry_launches) for lib in LIBRARIES]


def move_captured_launches(before: List[Dict[str, int]]) -> List[Dict[str, int]]:
    """The launches counted since ``before`` (:func:`launch_counts` taken
    when a graph capture began), taken back out of the counters: during a
    capture the wrappers only record their kernels. Returns them per
    library and entry point, for :func:`count_replay`."""
    captured = []
    for lib, b in zip(LIBRARIES, before):
        moved = {f: n - b.get(f, 0) for f, n in lib.entry_launches.items() if n != b.get(f, 0)}
        for f, c in moved.items():
            lib.entry_launches[f] -= c
            lib.launches -= c
        captured.append(moved)
    return captured


def count_replay(captured: List[Dict[str, int]]) -> None:
    """Count the launches one replay of a captured graph makes."""
    for lib, moved in zip(LIBRARIES, captured):
        for f, c in moved.items():
            lib.entry_launches[f] = lib.entry_launches.get(f, 0) + c
            lib.launches += c


def build_all(libs: List[CudaLibrary]) -> float:
    """Build every library not yet built, all ``nvcc`` processes at once;
    returns the wall seconds. Raises on the first failed build."""
    t0 = time.perf_counter()
    pending = []
    for lib in libs:
        if lib._lib is None:
            pending.append((lib, lib.start_build()))
    for lib, (path, proc) in pending:
        path, log = native_build.finish_build(path, proc)
        with lib._lock:
            lib.build_log = log
            lib._lib = lib._load(path)
    return time.perf_counter() - t0


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor as ``c_void_p``."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
