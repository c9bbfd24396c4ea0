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
kernel runs at each replay. A capture on a thread runs under
:func:`capturing_launches`, which books that thread's wrapper calls into the
capture's own tally instead of the counters (another thread's launches in
the meantime are counted as launches), and :func:`count_replay` adds the
tally at every replay. Each library counts its launches in all
(``launches``) and per C entry point (``entry_launches``: the gather's
float32 and bf16-value paths apart, and a launch the wrapper marks with a
``variant``, such as the gather's L2 route, under ``entry.variant``),
under one lock: concurrent requests
launch from their own threads. A library build counts as one-time work for
the calling thread's ``utils/guards.CompilationGuard``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from citizensassemblies_tpu_torch.utils import native_build
from citizensassemblies_tpu_torch.utils.guards import note_compile

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

#: guards every library's launch counters
_COUNT_LOCK = threading.Lock()

#: the calling thread's open capture tally (library name → entry → calls)
_CAPTURE = threading.local()


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
        #: the same launches per C entry point (``entry.variant`` for a
        #: launch marked with a variant)
        self.entry_launches: Dict[str, int] = {}
        #: ptxas resource report of the build in this process, if it built
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        LIBRARIES.append(self)

    def reset_counts(self) -> None:
        """Zero the launch counters."""
        with _COUNT_LOCK:
            self.launches = 0
            self.entry_launches.clear()

    def _cmd(self) -> List[str]:
        return [nvcc()] + NVCC_FLAGS + [f"-I{CSRC}"]

    def start_build(self):
        return native_build.start_build(self.name, [self.source], self._cmd(), self.headers)

    def library_path(self) -> str:
        """The content-hashed file this checkout's build of the library has
        (raises without ``nvcc``)."""
        return native_build.library_path(self.name, [self.source] + self.headers, self._cmd())

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
                note_compile("cuda_library_builds")
            return self._lib

    def call(self, fname: str, *args, variant: Optional[str] = None) -> int:
        """Launch through C entry point ``fname`` and count the launch (as
        ``fname.variant`` with a ``variant``); raises on a nonzero CUDA
        error code."""
        rc = self.run(fname, *args)
        key = fname if variant is None else f"{fname}.{variant}"
        tally = getattr(_CAPTURE, "tally", None)
        if tally is not None:
            entries = tally.setdefault(self.name, {})
            entries[key] = entries.get(key, 0) + 1
            return rc
        with _COUNT_LOCK:
            self.launches += 1
            self.entry_launches[key] = self.entry_launches.get(key, 0) + 1
        return rc

    def run(self, fname: str, *args) -> int:
        """Call C entry point ``fname`` without counting a launch (a query,
        or a measurement kernel that is not the library's own); raises on a
        nonzero CUDA error code."""
        rc = getattr(self.lib(), fname)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fname} failed with cudaError_t {rc}")
        return rc


@contextmanager
def capturing_launches():
    """Book the calling thread's wrapper calls in the scope (a graph
    capture) into a tally instead of the launch counters; yields the tally
    (library name → entry point → calls) for :func:`count_replay`."""
    outer = getattr(_CAPTURE, "tally", None)
    tally: Dict[str, Dict[str, int]] = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = outer


def count_replay(captured: Dict[str, Dict[str, int]]) -> None:
    """Count the launches one replay of a captured graph makes."""
    with _COUNT_LOCK:
        for lib in LIBRARIES:
            for f, c in captured.get(lib.name, {}).items():
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
        note_compile("cuda_library_builds")
    return time.perf_counter() - t0


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor as ``c_void_p``."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
