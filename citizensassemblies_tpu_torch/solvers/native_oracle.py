"""Native exact pricing oracle and slicers: ctypes bindings for
``native/bb_price.cpp``, ``native/slice_repair.cpp`` and ``native/slicer.cpp``.

An exact branch-and-bound over agent *types* (agents with identical feature
vectors are interchangeable up to weights, so the n-variable pricing ILP
collapses to a #types-variable integer program), the aimed slicer's stream
and quota repair, and the water-filling panel slicer.

Each library is compiled on first use with the system ``g++`` into this
package's own build directory (``utils/native_build``: content-hashed names,
compiled to a temporary file and renamed into place, so concurrent test
workers never load a half-written library). When the toolchain is missing,
callers fall back to their scipy/HiGHS or Python paths.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance
from citizensassemblies_tpu_torch.utils import native_build

_NATIVE = os.path.join(native_build.REPO_ROOT, "native")
_SRC = os.path.join(_NATIVE, "bb_price.cpp")
_GXX = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_lib_failed = False

_logger = logging.getLogger("citizensassemblies_tpu_torch.native")
#: libraries whose toolchain failure has already been reported (logged once
#: per process, so a missing g++ shows up instead of silently degrading)
_toolchain_logged: set = set()


def _note_toolchain_failure(name: str, exc: Exception) -> None:
    """Log a native-toolchain compile/load failure ONCE per process."""
    if name in _toolchain_logged:
        return
    _toolchain_logged.add(name)
    _logger.warning(
        "native %s unavailable (%s: %.200s); the scipy/HiGHS or Python "
        "fallback carries its calls for the rest of the process",
        name, type(exc).__name__, str(exc),
    )


def _compile_and_load(src: str, name: str) -> ctypes.CDLL:
    """g++-compile ``src`` into the package build directory (once per
    source content) and load it; raises on any toolchain failure."""
    return ctypes.CDLL(native_build.build(name, [src], _GXX))


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _load() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the shared library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = _compile_and_load(_SRC, "bb_price")
            lib.bb_price.restype = ctypes.c_int
            lib.bb_price.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),  # type_feature
                ctypes.POINTER(ctypes.c_int32),  # msize
                ctypes.POINTER(ctypes.c_double),  # prefix
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),  # lo
                ctypes.POINTER(ctypes.c_int32),  # hi
                ctypes.c_int, ctypes.c_double, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),  # out_counts
                ctypes.POINTER(ctypes.c_double),  # out_value
                ctypes.POINTER(ctypes.c_int64),  # out_nodes
            ]
            _lib = lib
        except Exception as exc:
            _note_toolchain_failure("bb_price", exc)
            _lib_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


class TypeReduction:
    """Group agents by identical feature rows and precompute the per-type
    structure the native search consumes. Reused across pricing calls — only
    the weights change per call."""

    def __init__(self, dense: DenseInstance):
        A = dense.A_np.astype(np.int8)
        self.n, self.F = A.shape
        self.k = int(dense.k)
        self.qmin = dense.qmin_np.astype(np.int32)
        self.qmax = dense.qmax_np.astype(np.int32)
        # category structure: columns of A are grouped by category via the
        # one-hot property (each agent has exactly one feature per category);
        # recover per-agent feature index per category from the dense rows
        _, type_id, counts = np.unique(
            A, axis=0, return_inverse=True, return_counts=True
        )
        self.type_id = type_id  # [n] agent -> type
        self.T = len(counts)
        self.msize = counts.astype(np.int32)
        self.members = [np.nonzero(type_id == t)[0] for t in range(self.T)]
        # [T, n_cats] global feature index per category, from any member's row
        reps = np.array([m[0] for m in self.members])
        rows = A[reps]  # [T, F] one-hot per category block
        feats = [np.nonzero(r)[0].astype(np.int32) for r in rows]
        n_cats = len(feats[0]) if feats else 0
        assert all(len(f) == n_cats for f in feats), "rows must be one-hot per category"
        self.n_cats = n_cats
        self.type_feature = np.stack(feats, axis=0) if n_cats else np.zeros((self.T, 0), np.int32)
        self.maxm = int(self.msize.max()) if self.T else 0

    def prepare(self, weights: np.ndarray):
        """Sort each type's members by weight (desc) and build prefix sums."""
        w = np.asarray(weights, dtype=np.float64)
        order = []  # per type: member ids sorted by weight desc
        prefix = np.zeros((self.T, self.maxm + 1), dtype=np.float64)
        for t, mem in enumerate(self.members):
            o = mem[np.argsort(-w[mem], kind="stable")]
            order.append(o)
            prefix[t, 1 : len(o) + 1] = np.cumsum(w[o])
        return order, prefix


def price_exact(
    reduction: TypeReduction,
    weights: np.ndarray,
    incumbent: float = -1e300,
    max_nodes: int = 20_000_000,
) -> Optional[Tuple[Optional[Tuple[int, ...]], float]]:
    """Certified-exact ``max Σ w_i x_i`` over feasible committees.

    Returns ``(committee, value)``; ``committee is None`` means the incumbent
    value passed in is certified optimal (no feasible committee beats it).
    Returns ``None`` (caller should fall back to HiGHS) when the native
    library is unavailable, the node limit was hit, or no feasible committee
    exists under an unseeded search.
    """
    lib = _load()
    if lib is None:
        return None
    order, prefix = reduction.prepare(weights)
    tf = np.ascontiguousarray(reduction.type_feature, dtype=np.int32)
    msize = np.ascontiguousarray(reduction.msize, dtype=np.int32)
    prefix_c = np.ascontiguousarray(prefix, dtype=np.float64)
    lo = np.ascontiguousarray(reduction.qmin, dtype=np.int32)
    hi = np.ascontiguousarray(reduction.qmax, dtype=np.int32)
    out_counts = np.zeros(reduction.T, dtype=np.int32)
    out_value = ctypes.c_double(0.0)
    out_nodes = ctypes.c_int64(0)

    status = lib.bb_price(
        reduction.T, reduction.n_cats, reduction.F,
        _ptr(tf, ctypes.c_int32), _ptr(msize, ctypes.c_int32),
        _ptr(prefix_c, ctypes.c_double),
        reduction.maxm, _ptr(lo, ctypes.c_int32), _ptr(hi, ctypes.c_int32),
        reduction.k, float(incumbent), int(max_nodes),
        _ptr(out_counts, ctypes.c_int32), ctypes.byref(out_value),
        ctypes.byref(out_nodes),
    )
    if status == 0:
        if out_counts[0] == -1 and np.all(out_counts == -1):
            return None, float(out_value.value)  # incumbent certified optimal
        members = []
        for t in range(reduction.T):
            c = int(out_counts[t])
            if c:
                members.extend(order[t][:c].tolist())
        committee = tuple(sorted(int(i) for i in members))
        return committee, float(out_value.value)
    return None  # status 1 (infeasible unseeded), 2 (node limit), 3 (bad args)


# --- native slice repair (the aimed slicer's host hot loop) -----------------

_REPAIR_SRC = os.path.join(_NATIVE, "slice_repair.cpp")
_repair_lib = None
_repair_failed = False


def _load_repair() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the slice-repair library; None if unavailable."""
    global _repair_lib, _repair_failed
    with _lock:
        if _repair_lib is not None or _repair_failed:
            return _repair_lib
        try:
            lib = _compile_and_load(_REPAIR_SRC, "slice_repair")
            lib.slice_repair.restype = ctypes.c_int
            lib.slice_repair.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),  # type_feature
                ctypes.POINTER(ctypes.c_int32),  # msize
                ctypes.POINTER(ctypes.c_int32),  # lo
                ctypes.POINTER(ctypes.c_int32),  # hi
                ctypes.POINTER(ctypes.c_int32),  # c
                ctypes.POINTER(ctypes.c_int32),  # counts
                ctypes.POINTER(ctypes.c_double),  # need
                ctypes.c_uint32, ctypes.c_int,
            ]
            lib.slice_stream.restype = ctypes.c_int
            lib.slice_stream.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),  # type_feature
                ctypes.POINTER(ctypes.c_int32),  # msize
                ctypes.POINTER(ctypes.c_int32),  # lo
                ctypes.POINTER(ctypes.c_int32),  # hi
                ctypes.c_int,  # k
                ctypes.POINTER(ctypes.c_double),  # x
                ctypes.c_int, ctypes.c_int,  # R, max_passes
                ctypes.c_uint32,  # j0 (tie-stream offset)
                ctypes.POINTER(ctypes.c_int32),  # out [R*T]
            ]
            _repair_lib = lib
        except Exception as exc:
            _note_toolchain_failure("slice_repair", exc)
            _repair_failed = True
            _repair_lib = None
        return _repair_lib


def repair_slice_native(
    reduction: "TypeReduction",
    c: np.ndarray,
    counts: np.ndarray,
    need: np.ndarray,
    seed: int,
    max_passes: int,
) -> Optional[bool]:
    """Native greedy quota repair of one apportionment slice (mutates ``c``
    and ``counts`` in place — same scoring as the python ``swap_repair``
    fallback in ``cg_typespace._slice_relaxation``, ~100× faster at
    T ≈ 1000). Returns None when the library is unavailable."""
    lib = _load_repair()
    if lib is None:
        return None
    # c/counts are mutated in place through raw pointers: anything but
    # contiguous int32 (e.g. the int64 arrays natural elsewhere in
    # _slice_relaxation) would be reinterpreted, silently corrupting the
    # slice — reject rather than guess at a copy-back contract
    for name, arr in (("c", c), ("counts", counts)):
        if arr.dtype != np.int32 or not arr.flags.c_contiguous:
            raise ValueError(
                f"repair_slice_native: {name} must be contiguous int32 "
                f"(got {arr.dtype}, contiguous={arr.flags.c_contiguous})"
            )
    # TypeReduction stores these contiguous int32 already, so the casts are
    # zero-copy views — no per-slice conversion cost
    tf = np.ascontiguousarray(reduction.type_feature, dtype=np.int32)
    msize = np.ascontiguousarray(reduction.msize, dtype=np.int32)
    lo = np.ascontiguousarray(reduction.qmin, dtype=np.int32)
    hi = np.ascontiguousarray(reduction.qmax, dtype=np.int32)
    need = np.ascontiguousarray(need, dtype=np.float64)
    ok = lib.slice_repair(
        reduction.T, reduction.n_cats, reduction.F,
        _ptr(tf, ctypes.c_int32), _ptr(msize, ctypes.c_int32),
        _ptr(lo, ctypes.c_int32), _ptr(hi, ctypes.c_int32),
        _ptr(c, ctypes.c_int32), _ptr(counts, ctypes.c_int32),
        _ptr(need, ctypes.c_double),
        ctypes.c_uint32(seed & 0xFFFFFFFF), int(max_passes),
    )
    return bool(ok)


def slice_stream_native(
    reduction: "TypeReduction",
    x: np.ndarray,
    R: int,
    max_passes: int,
    j0: int = 0,
    chunks: int = 1,
) -> Optional[np.ndarray]:
    """The full aimed-slicer loop in one native call (``slice_stream`` in
    ``native/slice_repair.cpp``): apportionment, gap top-up, quota repair and
    cumulative feedback for all ``R`` slices. A per-slice Python path pays
    ctypes marshalling and numpy bookkeeping for every slice, which grows
    with R ≈ 1000 into a large share of a mid-tier (n ≈ 300-400) solve.

    ``j0`` shifts the apportionment phase and the tie streams (see
    ``slice_stream`` in the C++ source), so repeated calls with different
    offsets emit *different* slices of the same hull. ``chunks > 1`` splits
    the stream into that many independent full streams of ``R // chunks``
    slices (offsets spaced by ``1 << 16``) run on a thread pool — ctypes
    releases the GIL, so the C++ streams run truly in parallel; each chunk's
    mixture still tracks ``x``, to ~chunks/R instead of ~1/R, which hull
    seeding cannot tell apart. Deterministic for fixed (R, j0, chunks).

    Returns the kept slices as int32 [kept, T], or None when the native
    toolchain is unavailable (callers run the per-slice path instead)."""
    lib = _load_repair()
    if lib is None:
        return None
    T = int(reduction.T)
    tf = np.ascontiguousarray(reduction.type_feature, dtype=np.int32)
    msize = np.ascontiguousarray(reduction.msize, dtype=np.int32)
    lo = np.ascontiguousarray(reduction.qmin, dtype=np.int32)
    hi = np.ascontiguousarray(reduction.qmax, dtype=np.int32)
    x64 = np.ascontiguousarray(x, dtype=np.float64)

    def run(r: int, off: int, out: np.ndarray) -> int:
        return int(
            lib.slice_stream(
                T, reduction.n_cats, reduction.F,
                _ptr(tf, ctypes.c_int32), _ptr(msize, ctypes.c_int32),
                _ptr(lo, ctypes.c_int32), _ptr(hi, ctypes.c_int32),
                int(reduction.k), _ptr(x64, ctypes.c_double),
                int(r), int(max_passes), ctypes.c_uint32(off & 0xFFFFFFFF),
                _ptr(out, ctypes.c_int32),
            )
        )

    chunks = max(1, min(int(chunks), int(R)))
    if chunks == 1:
        out = np.empty((int(R), T), dtype=np.int32)
        kept = run(int(R), int(j0), out)
        return out[:kept].copy()

    from concurrent.futures import ThreadPoolExecutor

    sizes = [R // chunks + (1 if i < R % chunks else 0) for i in range(chunks)]
    bufs = [np.empty((r, T), dtype=np.int32) for r in sizes]
    with ThreadPoolExecutor(max_workers=chunks) as pool:
        counts = list(
            pool.map(
                lambda i: run(sizes[i], int(j0) + i * (1 << 16), bufs[i]),
                range(chunks),
            )
        )
    return np.concatenate([bufs[i][: counts[i]] for i in range(chunks)], axis=0)

# --- native water-filling slicer (greedy_decompose's host hot loop) ---------

_SLICER_SRC = os.path.join(_NATIVE, "slicer.cpp")
_slicer_lib = None
_slicer_failed = False


def _load_slicer() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the slicer library; None if unavailable."""
    global _slicer_lib, _slicer_failed
    with _lock:
        if _slicer_lib is not None or _slicer_failed:
            return _slicer_lib
        try:
            lib = _compile_and_load(_SLICER_SRC, "slicer")
            lib.slicer_decompose.restype = ctypes.c_int
            lib.slicer_decompose.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),   # comps
                ctypes.POINTER(ctypes.c_double),  # probs
                ctypes.POINTER(ctypes.c_int32),   # members_flat
                ctypes.POINTER(ctypes.c_int32),   # member_off
                ctypes.POINTER(ctypes.c_int32),   # houses_flat (or NULL)
                ctypes.c_int,                     # n_houses
                ctypes.POINTER(ctypes.c_double),  # needs_flat (in/out)
                ctypes.c_double,                  # delta_cap (<=0: uncapped)
                ctypes.c_int,                     # max_panels
                ctypes.POINTER(ctypes.c_uint8),   # out_panels
                ctypes.POINTER(ctypes.c_double),  # out_probs
                ctypes.POINTER(ctypes.c_int),     # out_count
            ]
            _slicer_lib = lib
        except Exception as exc:
            _note_toolchain_failure("slicer", exc)
            _slicer_failed = True
            _slicer_lib = None
        return _slicer_lib


def greedy_decompose_native(
    reduction: "TypeReduction",
    comps_sorted: np.ndarray,
    probs_sorted: np.ndarray,
    per_type_need: np.ndarray,
    max_panels: int,
    households: Optional[np.ndarray] = None,
    delta_cap: float = 0.0,
):
    """Native water-filling decomposition (``native/slicer.cpp``) with the
    exact semantics of the Python loop in ``compositions.greedy_decompose``
    (same sort keys, cursor rotation, forced-overshoot rule). ``comps_sorted``
    /``probs_sorted`` must already be support-filtered and ordered largest
    mass first; ``per_type_need`` is the initial need per type (equal across
    a type's members). ``households`` (int[n] group ids) makes each slice's
    picks household-disjoint. Returns ``(panels bool [R, n], probs)`` or
    None when the library is unavailable (callers then run the Python
    loop)."""
    lib = _load_slicer()
    if lib is None:
        return None
    T, n = reduction.T, reduction.n
    S = len(probs_sorted)
    comps = np.ascontiguousarray(comps_sorted, dtype=np.int32)
    probs = np.ascontiguousarray(probs_sorted, dtype=np.float64)
    sizes = np.array([len(m) for m in reduction.members], dtype=np.int64)
    member_off = np.zeros(T + 1, dtype=np.int32)
    member_off[1:] = np.cumsum(sizes).astype(np.int32)
    members_flat = (
        np.concatenate(reduction.members).astype(np.int32)
        if T
        else np.zeros(0, np.int32)
    )
    needs_flat = np.repeat(
        np.asarray(per_type_need, dtype=np.float64), sizes
    )
    needs_flat = np.ascontiguousarray(needs_flat)
    if households is not None:
        houses_flat = np.ascontiguousarray(np.asarray(households)[members_flat], dtype=np.int32)
        houses_ptr = _ptr(houses_flat, ctypes.c_int32)
        n_houses = int(np.asarray(households).max()) + 1
    else:
        houses_ptr = None
        n_houses = 0
    out_panels = np.zeros((max_panels, n), dtype=np.uint8)
    out_probs = np.zeros(max_panels, dtype=np.float64)
    out_count = ctypes.c_int(0)
    rc = lib.slicer_decompose(
        T, n, S,
        _ptr(comps, ctypes.c_int32), _ptr(probs, ctypes.c_double),
        _ptr(members_flat, ctypes.c_int32), _ptr(member_off, ctypes.c_int32),
        houses_ptr, n_houses,
        _ptr(needs_flat, ctypes.c_double),
        float(delta_cap), int(max_panels),
        _ptr(out_panels, ctypes.c_uint8), _ptr(out_probs, ctypes.c_double),
        ctypes.byref(out_count),
    )
    if rc != 0:
        return None
    R = int(out_count.value)
    return out_panels[:R].astype(bool), out_probs[:R].copy()
