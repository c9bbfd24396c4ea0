"""Build, load and launch the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds). A library is built at its
first use, from the sources in the repository only, into the package's
``_build/`` directory; :func:`build_all` starts every build at once, one
``nvcc`` per source (a library of several translation units compiles each
in a process of its own and links their objects). Nothing here runs at
import time, so importing the package needs neither ``nvcc`` nor a card.

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
import subprocess
import tempfile
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


class _UnitsBuild:
    """The build of a library of several translation units, as
    :func:`native_build.finish_build` waits for one process: an ``nvcc -c``
    per unit, all started at once, then one link of their objects into
    ``tmp_path``."""

    def __init__(self, cmd: List[str], sources: List[str], tmp_path: str):
        self.tmp_path = tmp_path
        self.returncode: Optional[int] = None
        self._link = list(cmd)
        self._objects = [f"{tmp_path}.{i}.o" for i in range(len(sources))]
        compile_cmd = [a for a in cmd if a != "-shared"] + ["-c"]
        self._procs = [
            subprocess.Popen(compile_cmd + ["-o", obj, src], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for obj, src in zip(self._objects, sources)
        ]

    def communicate(self):
        out, err = b"", b""
        try:
            for proc in self._procs:
                o, e = proc.communicate()
                out, err = out + o, err + e
                if proc.returncode != 0 and self.returncode is None:
                    self.returncode = proc.returncode
            if self.returncode is None:
                link = subprocess.run(self._link + ["-o", self.tmp_path] + self._objects,
                                      capture_output=True)
                out, err = out + link.stdout, err + link.stderr
                self.returncode = link.returncode
        finally:
            for obj in self._objects:
                if os.path.exists(obj):
                    os.unlink(obj)
        return out, err


class CudaLibrary:
    """One kernel source, its shared library and its launch counter.

    ``functions`` maps each C entry point to ``(restype, argtypes)``;
    every pointer and the stream are ``ctypes.c_void_p``. ``units`` are
    further sources of the library, each compiled in a process of its own
    beside ``source``.
    """

    def __init__(self, name: str, source: str, headers: Sequence[str], functions: Dict,
                 units: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.units = [os.path.join(CSRC, u) for u in units]
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
        if not self.units:
            return native_build.start_build(self.name, [self.source], self._cmd(), self.headers)
        path = self.library_path()
        if os.path.exists(path):
            return path, None
        os.makedirs(native_build.BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".lib{self.name}-", suffix=".so",
                                   dir=native_build.BUILD_DIR)
        os.close(fd)
        return path, _UnitsBuild(self._cmd(), [self.source] + self.units, tmp)

    def library_path(self) -> str:
        """The content-hashed file this checkout's build of the library has
        (raises without ``nvcc``)."""
        return native_build.library_path(
            self.name, [self.source] + self.units + self.headers, self._cmd()
        )

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


def start_builds(libs: List[CudaLibrary]) -> list:
    """Start building every library not yet built, all ``nvcc`` processes
    at once; returns the pending builds for :func:`finish_builds`, so the
    caller can do other work while they compile."""
    return [(lib, lib.start_build()) for lib in libs if lib._lib is None]


def finish_builds(pending: list) -> None:
    """Wait for :func:`start_builds`' builds and load each library. Raises
    on the first failed build."""
    for lib, (path, proc) in pending:
        path, log = native_build.finish_build(path, proc)
        with lib._lock:
            lib.build_log = log
            lib._lib = lib._load(path)
        note_compile("cuda_library_builds")


def build_all(libs: List[CudaLibrary]) -> float:
    """Build every library not yet built, all ``nvcc`` processes at once;
    returns the wall seconds. Raises on the first failed build."""
    t0 = time.perf_counter()
    finish_builds(start_builds(libs))
    return time.perf_counter() - t0


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor as ``c_void_p``."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
