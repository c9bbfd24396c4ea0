"""The graph store: the one-time work of each core, done once per shape.

The JAX package compiles each hot core once per shape, keeps the program
(jit's cache) and can serialize it into an artifact a later process boots
from (its ``aot/store.py``). The port's one-time work per shape is of two
kinds, and this module keeps both:

* **captured CUDA graphs.** A PDHG block or an ascent chunk is captured
  into a CUDA graph and replayed. A graph cannot be serialized, so what is
  kept is the graph itself, per ``(family, call signature)``, over static
  input buffers, for every later call with that signature in the process
  (:class:`GraphEntry`, in an LRU bounded by :data:`GRAPH_CAP`, each entry
  counting its buffers and its private memory pool in ``nbytes``). Every
  tensor a block reads is such a static input, copied in when another solve
  takes the graph over (:class:`SeededGraph`), so a graph captured for one
  instance computes with the operands of the next. The blocks are rebuilt
  from their family's block factory (:func:`register_block`) and their operands,
  never from a solve's closure;
* **the kernel libraries** under ``_build/`` (content-hashed file names),
  loaded at boot.

The artifact (:func:`save_artifact`) is a versioned JSON manifest: the
schema version, the platform fingerprint (torch version, CUDA runtime,
device name, compute capability), each kernel library's hashed file name
and each recorded entry's family, signature, block factory, statics and operand
specs. Booting (``aot.boot``) re-captures every recorded entry on zero
operands (:meth:`ExecStore.prewarm`), so the first real request pays for no
capture; padded lanes are inert, as the JAX package's prewarm relies on.

The JAX contract is kept: the tri-state ``Config.aot_cache``; the artifact
path from ``Config.aot_cache_path``, then ``CITIZENS_AOT_CACHE``, then a
per-user default file; hit, miss and stale counted, never a crash
(:meth:`ExecStore.stamp` with the JAX keys); a JAX artifact at the path
loads as stale. A request whose config has ``aot_cache=False`` is
store-blind: its solves capture their own graphs and keep none. Families
whose port core is eager torch with no one-time work
(``device_pricing.*``, ``delta.screen``, ``face_decompose.*``) are recorded
(:func:`note_eager`) but count neither a hit nor a miss.

A capture runs under the process's capture lock in ``thread_local`` mode
on a side stream of its thread, with the hand-written kernels' launches
booked to it (``kernels/cuda_lib.capturing_launches``) and counted at each
replay; it counts as one-time work (``utils/guards.CompilationGuard``). A
failed capture raises. A replay holds its entry's lock, waits for the
stream that used the entry last and runs inside the caller's launch
window. On CPU tensors there is no graph: the entry binds the rebuilt block
to its static copies and runs it, the same protocol without the capture
(what the CPU tests hold).
"""

from __future__ import annotations

import hashlib
import importlib
import itertools
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from citizensassemblies_tpu_torch.utils.guards import note_compile
from citizensassemblies_tpu_torch.utils.memo import LRU

#: artifact schema; bump on any layout change (a mismatch is stale in toto)
SCHEMA_VERSION = 1
#: the artifact's kind, so a foreign file at the path is told apart
ARTIFACT_KIND = "citizensassemblies_tpu_torch.graph_store"

#: captured graphs kept in the process, and their device bytes (least
#: recently used evicted past either)
GRAPH_CAP = 64
GRAPH_BYTES_CAP = 8 << 30

_lock = threading.Lock()
#: one capture per signature: a second thread asking for the same graph
#: waits for the first thread's capture
_ACQUIRE_LOCK = threading.Lock()
_STORE: Optional["ExecStore"] = None
_RECORDER: Optional["Recorder"] = None

#: the process's graphs: (family, signature) → GraphEntry
GRAPHS: LRU = LRU(cap=GRAPH_CAP, name="aot_graphs")

#: one capture at a time in the process: a capture holds the caching
#: allocator's capture pool
CAPTURE_LOCK = threading.Lock()
#: one side stream per (thread, device) on which blocks are captured (a
#: graph cannot be captured on the default stream), and the block kinds
#: (factory names) it has run: a kind's first run on a stream does one-time
#: setup (the BLAS handle and workspace of the thread and stream, a
#: library's first use) that must not fall inside a capture
_CAPTURE_STREAMS: dict = {}

#: block factories by name: ``factory(**statics)`` → ``make(*operands)`` →
#: ``block(*args)`` returning a tuple of tensors
_FACTORIES: Dict[str, Callable[..., Callable]] = {}
#: factories whose blocks run collectives: a prewarm on one rank would wait
#: for the others, so it skips them
_COLLECTIVE: set = set()
#: the module that registers each factory name prefix (imported on demand,
#: for a prewarm in a process that has not imported it yet)
_FACTORY_MODULES = {
    "lp_pdhg.": "citizensassemblies_tpu_torch.solvers.lp_pdhg",
    "qp.": "citizensassemblies_tpu_torch.solvers.qp",
    "parallel.": "citizensassemblies_tpu_torch.parallel.solver",
}

#: kernel-library families and the library each loads
LIBRARY_FAMILIES = {
    "kernels.megakernel_two_sided": ("pdhg_megakernel", "KERNEL"),
    "kernels.megakernel_lp": ("pdhg_megakernel", "LP_KERNEL"),
    "kernels.ell_gather": ("ell_matvec", "KERNEL"),
}


def register_block(name: str, collective: bool = False):
    """Register a block factory under ``name`` (a decorator); a
    ``collective`` block is never prewarmed."""

    def deco(fn):
        _FACTORIES[name] = fn
        if collective:
            _COLLECTIVE.add(name)
        return fn

    return deco


def block_factory(name: str) -> Callable[..., Callable]:
    if name not in _FACTORIES:
        for prefix, module in _FACTORY_MODULES.items():
            if name.startswith(prefix):
                importlib.import_module(module)
    return _FACTORIES[name]


# --- call signatures -----------------------------------------------------------


def _spec_of(value: Any) -> Tuple[str, Any]:
    """One operand's key spec: tensors by (shape, dtype, device, strides
    when not contiguous), python scalars by their class, anything else by
    repr."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        dev = str(getattr(value, "device", "cpu"))
        strides = None
        is_contiguous = getattr(value, "is_contiguous", None)
        if callable(is_contiguous) and not is_contiguous():
            strides = tuple(int(s) for s in value.stride())
        return ("arr", (tuple(int(d) for d in shape), str(dtype).replace("torch.", ""), dev, strides))
    if isinstance(value, bool):
        return ("pybool", value)
    if isinstance(value, int):
        return ("pyint", 0)
    if isinstance(value, float):
        return ("pyfloat", 0.0)
    return ("lit", repr(value))


def _sig_token(spec) -> str:
    kind, payload = spec
    if kind == "arr":
        shape, dtype, dev, strides = payload
        return f"{dtype}{list(shape)}@{dev}" + (f"s{list(strides)}" if strides else "")
    if kind == "pybool":
        return f"b{int(payload)}"
    return kind if kind in ("pyint", "pyfloat") else f"={payload}"


def call_signature(args: Sequence[Any], kwargs: Dict[str, Any],
                   static_argnames: Sequence[str] = ()) -> str:
    """The store key fragment for one call: operands by shape, dtype and
    device, static kwargs by value (a static changes the captured kernels,
    so it is part of the key)."""
    parts: List[str] = [_sig_token(_spec_of(a)) for a in args]
    for name in sorted(kwargs):
        v = kwargs[name]
        if name in static_argnames:
            parts.append(f"{name}={v!r}")
        else:
            parts.append(f"{name}:{_sig_token(_spec_of(v))}")
    return ";".join(parts)


def graph_signature(factory: str, statics: Dict[str, Any], operands, args) -> str:
    """The key of a graph: its block factory, statics, operands and arguments."""
    return "|".join([
        factory, call_signature((), dict(statics), tuple(statics)),
        call_signature(tuple(operands), {}), call_signature(tuple(args), {}),
    ])


# --- platform fingerprint and paths --------------------------------------------


def platform_fingerprint(device=None) -> Dict[str, Any]:
    """The environment a recorded entry is valid for: torch version, CUDA
    runtime, device name and compute capability (``cpu`` without a card).
    Loaded against another fingerprint, every entry is stale."""
    import torch

    fp: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available() and (device is None or str(device).startswith("cuda")):
        idx = torch.cuda.current_device()
        fp["device"] = torch.cuda.get_device_name(idx)
        fp["capability"] = list(torch.cuda.get_device_capability(idx))
    else:
        fp["device"] = "cpu"
        fp["capability"] = None
    return fp


def default_cache_path() -> str:
    """``CITIZENS_AOT_CACHE`` when set, else a per-user file of the port's
    own name (a JAX artifact there loads as stale)."""
    env = os.environ.get("CITIZENS_AOT_CACHE", "")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "citizensassemblies_tpu_torch", "graph_store.json"
    )


def resolve_cache_path(cfg=None, path: Optional[str] = None) -> str:
    if path:
        return str(path)
    cfg_path = str(getattr(cfg, "aot_cache_path", "") or "") if cfg is not None else ""
    return cfg_path or default_cache_path()


# --- captured graphs -----------------------------------------------------------


class GraphEntry:
    """One captured block: its static operand and argument buffers, its
    outputs, the replay and the launches one replay makes. :meth:`run`
    copies a solve's operands in when that solve takes the entry over from
    another (``owner``), the arguments on every call, replays, counts the
    launches and returns clones of the outputs, under the entry's lock."""

    def __init__(self, static_ops, static_args, outs, replay: Callable, captured,
                 pool_bytes: int = 0):
        self.static_ops = tuple(static_ops)
        self.static_args = tuple(static_args)
        self.outs = tuple(outs)
        self.replay = replay
        self.captured = captured
        self.pool_bytes = int(pool_bytes)
        self.lock = threading.Lock()
        self.owner: Optional[int] = None
        self._event = None
        self._stream = None
        #: keeps the graph object alive with the entry
        self.graph = None

    @property
    def nbytes(self) -> int:
        """The entry's device bytes: its static buffers and the graph's
        private memory pool (its outputs live there)."""
        own = sum(int(t.numel()) * t.element_size() for t in self.static_ops + self.static_args)
        return own + self.pool_bytes

    def run(self, operands, args, owner: Optional[int] = None):
        from citizensassemblies_tpu_torch.kernels import cuda_lib

        with self.lock:
            stream = None
            if self.static_args and self.static_args[0].is_cuda:
                import torch

                stream = torch.cuda.current_stream(self.static_args[0].device)
                if self._event is not None and self._stream != stream:
                    # the last replay ran on another stream: its reads of
                    # the static buffers finish before this copy-in
                    stream.wait_event(self._event)
            if owner is None or owner != self.owner:
                for s, v in zip(self.static_ops, operands):
                    s.copy_(v)
                self.owner = owner
            for s, v in zip(self.static_args, args):
                s.copy_(v)
            self.replay()
            cuda_lib.count_replay(self.captured)
            out = tuple(o.clone() for o in self.outs)
            if stream is not None:
                import torch

                if self._event is None:
                    self._event = torch.cuda.Event()
                self._event.record(stream)
                self._stream = stream
            return out


def _pool_bytes(graph) -> int:
    """The bytes of a graph's private memory pool (the caching allocator's
    segments of that pool); 0 when the snapshot does not say."""
    try:
        import torch

        pool = graph.pool()
        return sum(
            int(seg.get("total_size", 0)) for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool)
        )
    except Exception:
        return 0


def capture(make: Callable, operands, args, kind: str = "") -> GraphEntry:
    """Capture ``make(*static operands)`` at ``args`` into a graph over
    static copies (CUDA), or bind it to them (CPU). The block runs once on
    the capture stream first when its ``kind`` (the factory's name) has not
    run there yet. Counts one capture as one-time work; a failed capture
    raises."""
    import torch

    from citizensassemblies_tpu_torch.kernels import cuda_lib

    static_ops = tuple(o.clone() for o in operands)
    static_args = tuple(a.clone() for a in args)
    block = make(*static_ops)
    dev = static_args[0].device
    if dev.type != "cuda":
        outs = tuple(o.clone() for o in block(*static_args))

        def replay():
            for o, v in zip(outs, block(*static_args)):
                o.copy_(v)

        note_compile("cuda_graph_captures")
        return GraphEntry(static_ops, static_args, outs, replay, {})
    key = (threading.get_ident(), dev)
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK:
        stream, warmed = _CAPTURE_STREAMS.get(key, (None, frozenset()))
        if stream is None:
            stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            if kind not in warmed:
                block(*static_args)
            with cuda_lib.capturing_launches() as captured:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = block(*static_args)
                finally:
                    # a failed block still ends the capture, so the stream
                    # and the allocator leave capture mode
                    graph.capture_end()
        _CAPTURE_STREAMS[key] = (stream, warmed | {kind})
        torch.cuda.current_stream(dev).wait_stream(stream)
    note_compile("cuda_graph_captures")
    entry = GraphEntry(static_ops, static_args, outs, graph.replay, captured, _pool_bytes(graph))
    entry.graph = graph
    return entry


def _ambient_gate_off() -> bool:
    """True when the ambient request's config has ``aot_cache=False``: its
    solves are store-blind."""
    from citizensassemblies_tpu_torch.service.context import current_context

    ctx = current_context()
    return ctx is not None and getattr(ctx.cfg, "aot_cache", None) is False


def acquire(family: str, factory: str, statics: Dict[str, Any], operands, args) -> GraphEntry:
    """The stored graph of this signature (a hit), else a new capture put
    into the store (a miss); store-blind requests capture their own."""
    make = block_factory(factory)(**statics)
    if _ambient_gate_off():
        return capture(make, operands, args, factory)
    key = (family, graph_signature(factory, statics, operands, args))
    store = _STORE
    entry = GRAPHS.get(key)
    if entry is None:
        with _ACQUIRE_LOCK:
            entry = GRAPHS.get(key)
            if entry is None:
                entry = capture(make, operands, args, factory)
                GRAPHS.put(key, entry)
                _trim()
                if store is not None:
                    store.bump("misses")
                return entry
    if store is not None:
        store.bump("hits")
    return entry


def _trim() -> None:
    """Drop the least recently used graphs while the store holds more than
    :data:`GRAPH_BYTES_CAP` device bytes (the newest always stays)."""
    items = GRAPHS.items()
    total = sum(e.nbytes for _k, e in items)
    for k, e in items[:-1]:
        if total <= GRAPH_BYTES_CAP:
            break
        GRAPHS.pop(k)
        total -= e.nbytes


_OWNERS = itertools.count(1)


class SeededGraph:
    """One solve's block through the store: ``eager`` (the solve's own
    block) on the first ``eager_calls`` calls, then the stored graph of
    ``family`` (:func:`acquire`), rebuilt by the block factory ``factory`` from
    ``statics`` and ``operands``. With ``graph`` false every call is eager.
    The first call is recorded under an installed :class:`Recorder`.

    A caller calls :meth:`prepare` with the call's arguments before it
    opens the launch window the call runs in: a capture, like any legal
    sync, belongs outside every window."""

    def __init__(self, family: str, factory: str, statics: Dict[str, Any], operands,
                 eager: Optional[Callable] = None, graph: bool = True, eager_calls: int = 1):
        self.family = family
        self.factory = factory
        self.statics = dict(statics)
        self.operands = tuple(operands)
        self.graph = bool(graph)
        self.eager_calls = int(eager_calls) if eager is not None else 0
        self.eager = eager
        self._calls = 0
        self._recorded = False
        self._entry: Optional[GraphEntry] = None
        self._owner = next(_OWNERS)

    def prepare(self, *args) -> None:
        """Record the first call and acquire the graph before the call that
        first replays it (a no-op otherwise)."""
        if not self._recorded:
            self._recorded = True
            rec = _RECORDER
            if rec is not None:
                rec.record_graph(self.family, self.factory, self.statics, self.operands, args)
        if self.graph and self._entry is None and self._calls >= self.eager_calls:
            self._entry = acquire(self.family, self.factory, self.statics, self.operands, args)

    def __call__(self, *args):
        self.prepare(*args)
        self._calls += 1
        if self._entry is None:
            return self.eager(*args)
        return self._entry.run(self.operands, args, owner=self._owner)


def note_eager(family: str, args: Sequence[Any] = (), statics: Optional[Dict[str, Any]] = None) -> None:
    """Record a call of an eager family (no one-time work: no hit, no
    miss) under an installed :class:`Recorder`."""
    rec = _RECORDER
    if rec is not None:
        rec.record_eager(family, args, statics or {})


# --- the loaded store ------------------------------------------------------------


class ExecStore:
    """The boot-loaded store: the artifact's recorded entries (to prewarm),
    its libraries, and the serving counters. Thread-safe."""

    def __init__(self, sha: str, status: str = "ok"):
        self.sha = sha
        #: "ok" | "missing" | "corrupt" | "fingerprint_mismatch"
        self.status = status
        #: (family, sig) → the recorded entry (factory, statics, specs)
        self._specs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        #: library family → recorded hashed file name
        self.libraries: Dict[str, str] = {}
        self._clock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.prewarmed = 0

    def __len__(self) -> int:
        return len(self._specs) + len(self.libraries)

    def add_spec(self, entry: Dict[str, Any]) -> None:
        self._specs[(entry["family"], entry["sig"])] = entry

    def bump(self, counter: str, n: int = 1) -> None:
        with self._clock:
            setattr(self, counter, getattr(self, counter) + int(n))

    def stamp(self) -> Dict[str, Any]:
        """The ``aot`` block for request audit stamps and bench rows."""
        with self._clock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "stale": self.stale,
                "prewarmed": self.prewarmed,
                "entries": len(self),
                "cache_sha": self.sha,
                "status": self.status,
            }

    def load_libraries(self) -> int:
        """Load every recorded kernel library whose hashed file is this
        checkout's build of it; a recorded name that is not (the sources
        changed) is stale, and builds at its first use. Returns the
        libraries loaded."""
        import importlib as _il

        loaded = 0
        for family, name in sorted(self.libraries.items()):
            mod, attr = LIBRARY_FAMILIES.get(family, (None, None))
            if mod is None:
                continue
            lib = getattr(_il.import_module(f"citizensassemblies_tpu_torch.kernels.{mod}"), attr)
            try:
                path = lib.library_path()
            except RuntimeError:  # no nvcc: nothing to load
                continue
            if os.path.basename(path) != name or not os.path.exists(path):
                self.bump("stale")
                continue
            lib.lib()
            loaded += 1
        return loaded

    def prewarm(self, families: Optional[Sequence[str]] = None, device=None) -> int:
        """Capture every recorded graph entry (``families``: by family-name
        prefix) on zero operands into the process's store, off the launch
        counters; an entry already captured, an eager family, a collective
        block, an entry of the build's manifest walk (tagged ``manifest``:
        the lint registry's small shapes, which no request dispatches) or
        an entry whose device is not ``device``'s type is skipped,
        and one that fails to capture is counted stale. Returns the entries
        captured."""
        import torch

        from citizensassemblies_tpu_torch.kernels import cuda_lib

        touched = 0
        for (family, sig), spec in sorted(self._specs.items()):
            if spec.get("kind") != "graph" or spec.get("manifest"):
                continue
            if families is not None and not any(family.startswith(p) for p in families):
                continue
            if (family, sig) in GRAPHS:
                continue
            block_factory(spec["factory"])  # registers it
            if spec["factory"] in _COLLECTIVE:
                continue
            if device is not None and torch.device(spec["device"]).type != torch.device(device).type:
                continue
            try:
                ops = [_zeros(s) for s in spec["operands"]]
                args = [_zeros(s) for s in spec["args"]]
                if graph_signature(spec["factory"], spec["statics"], ops, args) != sig:
                    raise ValueError("a rebuilt signature differs from the recorded one")
                make = block_factory(spec["factory"])(**spec["statics"])
                with cuda_lib.capturing_launches():
                    entry = capture(make, ops, args, spec["factory"])
            except Exception:
                self.bump("stale")
                continue
            GRAPHS.put((family, sig), entry)
            touched += 1
        self.bump("prewarmed", touched)
        return touched


def _zeros(spec):
    """A zero tensor of a recorded operand spec, on its recorded device."""
    import torch

    kind, payload = spec
    if kind != "arr":
        raise TypeError(f"a graph operand must be a tensor, not {kind}")
    shape, dtype, dev, strides = payload
    dt = getattr(torch, dtype)
    if strides:
        return torch.empty_strided(shape, strides, dtype=dt, device=dev).zero_()
    return torch.zeros(shape, dtype=dt, device=dev)


def install_store(store: Optional[ExecStore]) -> None:
    """Install (or clear, with ``None``) the process's store."""
    global _STORE
    with _lock:
        _STORE = store


def active_store() -> Optional[ExecStore]:
    return _STORE


# --- build-time recording -----------------------------------------------------------


class Recorder:
    """Collects every graph and eager family the process calls while
    installed: the build's manifest (``aot/build.py``)."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (family, sig) → JSON-able entry
        self.entries: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def record_graph(self, family: str, factory: str, statics, operands, args) -> None:
        sig = graph_signature(factory, statics, operands, args)
        dev = next((str(t.device) for t in tuple(args) + tuple(operands)), "cpu")
        with self._lock:
            self.entries.setdefault((family, sig), {
                "kind": "graph", "family": family, "sig": sig, "factory": factory,
                "statics": dict(statics), "device": dev,
                "operands": [_spec_of(o) for o in operands], "args": [_spec_of(a) for a in args],
            })

    def record_eager(self, family: str, args, statics) -> None:
        sig = call_signature(tuple(args), dict(statics), tuple(statics))
        with self._lock:
            self.entries.setdefault((family, sig), {
                "kind": "eager", "family": family, "sig": sig,
                "args": [_spec_of(a) for a in args],
            })


def install_recorder(rec: Optional[Recorder]) -> None:
    global _RECORDER
    with _lock:
        _RECORDER = rec


# --- artifact save / load ---------------------------------------------------------


def _jsonable_entry(e: Dict[str, Any]) -> Dict[str, Any]:
    return json.loads(json.dumps(e, default=list))


def _artifact_sha(entries: List[Dict[str, Any]], libraries: Dict[str, str]) -> str:
    h = hashlib.sha256()
    for e in sorted(entries, key=lambda e: (e["family"], e["sig"])):
        h.update(f"{e['family']}|{e['sig']}".encode())
    for fam, name in sorted(libraries.items()):
        h.update(f"{fam}={name}".encode())
    return h.hexdigest()[:12]


def library_names(families) -> Dict[str, str]:
    """The hashed file name of each kernel-library family's build (none
    without ``nvcc``)."""
    out: Dict[str, str] = {}
    for family in sorted(families):
        mod, attr = LIBRARY_FAMILIES[family]
        lib = getattr(importlib.import_module(f"citizensassemblies_tpu_torch.kernels.{mod}"), attr)
        try:
            out[family] = os.path.basename(lib.library_path())
        except RuntimeError:
            continue
    return out


def save_artifact(path: str, entries: Sequence[Dict[str, Any]], libraries: Optional[Dict[str, str]] = None,
                  workload: Optional[Dict[str, Any]] = None, device=None) -> str:
    """Write the versioned JSON manifest (temp file + rename); returns its
    content sha. ``entries`` are a :class:`Recorder`'s values."""
    entries = [_jsonable_entry(e) for e in entries]
    libraries = dict(libraries or {})
    sha = _artifact_sha(entries, libraries)
    doc = {
        "schema_version": SCHEMA_VERSION,
        "kind": ARTIFACT_KIND,
        "fingerprint": platform_fingerprint(device),
        "sha": sha,
        "workload": dict(workload or {}),
        "libraries": libraries,
        "entries": entries,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=repr)
    os.replace(tmp, path)
    return sha


def load_store(path: Optional[str] = None, cfg=None, require: bool = False,
               device=None) -> Optional[ExecStore]:
    """Load the artifact into an :class:`ExecStore`.

    ``require=False``: a missing file → ``None``; an unreadable file → an
    empty store with status ``"corrupt"``; a JAX artifact (a pickle) or a
    manifest of another schema or platform → an empty store with status
    ``"fingerprint_mismatch"`` whose entries count stale (a JAX artifact
    counts one: its entries cannot be read without JAX). With ``require``
    (``Config.aot_cache=True``) each of these raises instead."""
    path = resolve_cache_path(cfg, path)
    if not os.path.exists(path):
        if require:
            raise RuntimeError(
                f"aot_cache=True but no artifact at {path}: run "
                "`python -m citizensassemblies_tpu_torch.aot build`"
            )
        return None
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as exc:
        if require:
            raise RuntimeError(f"aot_cache=True but {path} is unreadable: {exc}")
        return ExecStore(sha="", status="corrupt")
    if raw[:1] == b"\x80":
        # a pickle: the JAX package's serialized executables
        if require:
            raise RuntimeError(f"aot_cache=True but {path} is a JAX package artifact")
        store = ExecStore(sha="", status="fingerprint_mismatch")
        store.bump("stale")
        return store
    try:
        doc = json.loads(raw.decode("utf-8"))
        entries = doc["entries"]
        sha = doc["sha"]
        if doc.get("kind") != ARTIFACT_KIND:
            raise ValueError(f"kind {doc.get('kind')!r}")
        if doc["schema_version"] != SCHEMA_VERSION:
            raise ValueError(f"schema {doc['schema_version']} != {SCHEMA_VERSION}")
        fingerprint = doc["fingerprint"]
    except Exception as exc:
        if require:
            raise RuntimeError(f"aot_cache=True but {path} is unreadable: {exc}")
        return ExecStore(sha="", status="corrupt")
    mine = platform_fingerprint(device)
    if fingerprint != mine:
        if require:
            raise RuntimeError(
                f"aot_cache=True but {path} was built for {fingerprint}, this process is {mine}"
            )
        store = ExecStore(sha=sha, status="fingerprint_mismatch")
        store.bump("stale", len(entries) + len(doc.get("libraries", {})))
        return store
    store = ExecStore(sha=sha)
    for e in entries:
        e = dict(e)
        e["operands"] = [_spec_from_json(s) for s in e.get("operands", [])]
        e["args"] = [_spec_from_json(s) for s in e.get("args", [])]
        store.add_spec(e)
    store.libraries = dict(doc.get("libraries", {}))
    return store


def _spec_from_json(spec) -> Tuple[str, Any]:
    kind, payload = spec
    if kind == "arr":
        shape, dtype, dev, strides = payload
        return ("arr", (tuple(shape), dtype, dev, tuple(strides) if strides else None))
    return (kind, payload)
