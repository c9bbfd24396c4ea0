"""Span tracer: nested spans, ambient activation, Chrome export.

The stack's wall-clock attribution used to live in three disconnected
channels — ``RunLog`` phase timers, ``CompilationGuard`` counters and
hand-read bench stamps — none of which could answer "where did THIS
request's 18 seconds go" for one request among many. A :class:`Tracer`
collects **spans**: named intervals with attributes, nested per thread, and
exports them as Chrome trace-event JSON (loadable in ``chrome://tracing`` /
Perfetto / speedscope).

Activation is AMBIENT and opt-in:

* :func:`use_tracer` installs a tracer on the calling thread/task via a
  ``ContextVar`` (the same isolation contract as
  ``service.context.RequestContext`` — and the service installs a
  per-request tracer through exactly that context, so concurrent requests
  produce disjoint traces by construction);
* a ``RunLog`` may carry a ``tracer`` attribute so worker threads that hold
  the request's log (the anchor-pricing overlap thread, the cross-request
  batcher) attribute their spans to the owning request even though
  ``ContextVar`` values do not cross thread boundaries;
* with NO tracer installed every entry point here is a no-op returning
  ``None`` — one ``ContextVar.get`` per call, no allocation, which is the
  ``Config.obs_trace`` "off ⇒ zero overhead" contract.

Span trees are well-nested per thread (spans close LIFO through the
context-manager protocol); :func:`begin_span`/:func:`end_span` additionally
support OPEN intervals that tile a loop without re-indenting its body (the
face-decomposition round spans) — those attach to the current stack top as
parent but do not join the stack, so they may overlap their own children's
siblings; interval-union consumers (:func:`span_coverage`) handle that.

Nothing here imports torch: the tracer is importable from any host-only
path.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterable, List, Optional

#: schema version stamped into every exported trace document (and onto the
#: bench rows' ``obs`` block): bump when the event layout changes shape
TRACE_SCHEMA_VERSION = 1

#: hard cap on retained spans per tracer — a runaway loop must degrade to a
#: counted drop, not an OOM (the drop count is exported with the trace)
MAX_SPANS = 200_000

#: the ambient tracer of the calling thread/task (None = tracing off)
_AMBIENT: ContextVar[Optional["Tracer"]] = ContextVar(
    "citizens_tpu_tracer", default=None
)


@dataclasses.dataclass
class Span:
    """One named interval. ``t0``/``t1`` are ``perf_counter`` seconds on the
    owning tracer's clock; ``t1 is None`` while the span is open."""

    name: str
    span_id: int
    parent_id: Optional[int]
    t0: float
    t1: Optional[float]
    tid: int
    attrs: Dict[str, Any]

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0


class Tracer:
    """Collects spans for ONE run/request.

    ``sample_device=True`` marks the opt-in device-sampling mode
    (``Config.obs_trace = True``): the dispatch hooks
    (``obs.hooks.dispatch_span``) then wait on a CUDA event recorded after
    their outputs, so a dispatch span measures device execution instead of
    the host's enqueue. The numerics are untouched either way (a wait, not
    a transfer), which the obs-off/on bit-identity test holds.
    """

    def __init__(
        self,
        name: str = "run",
        sample_device: bool = False,
        max_spans: int = MAX_SPANS,
    ):
        self.name = name
        self.sample_device = bool(sample_device)
        self.max_spans = int(max_spans)
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._tls = threading.local()
        self._ids = itertools.count(1)
        # epoch pair: monotonic for durations, wall for absolute export ts
        self._epoch_perf = time.perf_counter()
        self._epoch_unix = time.time()

    # --- recording ----------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def begin(self, name: str, stacked: bool = True, **attrs) -> Optional[Span]:
        """Open a span. ``stacked=True`` (the context-manager path) pushes it
        so later spans on this thread nest under it; ``stacked=False`` makes
        an open interval parented at the current stack top that does NOT
        capture later spans (loop tiling)."""
        st = self._stack()
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return None
            sp = Span(
                name=name,
                span_id=next(self._ids),
                parent_id=st[-1].span_id if st else None,
                t0=time.perf_counter(),
                t1=None,
                tid=threading.get_ident(),
                attrs=dict(attrs),
            )
            self._spans.append(sp)
        if stacked:
            st.append(sp)
        return sp

    def end(self, sp: Optional[Span]) -> None:
        """Close a span (idempotent; ``None`` is a no-op)."""
        if sp is None or sp.t1 is not None:
            return
        sp.t1 = time.perf_counter()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()

    @contextmanager
    def span(self, name: str, **attrs):
        sp = self.begin(name, stacked=True, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    # --- reading ------------------------------------------------------------

    @property
    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> List[Span]:
        """Snapshot of recorded spans (the Span objects themselves — treat
        as read-only; open spans have ``t1 is None``)."""
        with self._lock:
            return list(self._spans)

    def chrome_events(self, pid: int = 1) -> List[dict]:
        """Chrome trace-event list for this tracer under process id ``pid``:
        one complete ("X") event per span (open spans are exported as if
        closed now — export never mutates) plus process/thread metadata."""
        now = time.perf_counter()
        spans = self.spans()
        base_us = self._epoch_unix * 1e6 - self._epoch_perf * 1e6
        events: List[dict] = [
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": self.name},
            }
        ]
        tids = sorted({sp.tid for sp in spans})
        tid_map = {t: i + 1 for i, t in enumerate(tids)}
        for t, short in tid_map.items():
            events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": short,
                    "name": "thread_name",
                    "args": {"name": f"thread-{t}"},
                }
            )
        for sp in spans:
            t1 = sp.t1 if sp.t1 is not None else now
            args = {k: _jsonable(v) for k, v in sp.attrs.items()}
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            events.append(
                {
                    "ph": "X",
                    "pid": pid,
                    "tid": tid_map.get(sp.tid, 0),
                    "name": sp.name,
                    "cat": "grafttrace",
                    "ts": base_us + sp.t0 * 1e6,
                    "dur": max(t1 - sp.t0, 0.0) * 1e6,
                    "args": args,
                }
            )
        return events


class DeviceValue:
    """A span attribute that lives on the device until it is read: the
    iterations a fused solve took, say, which its caller does not read back
    at dispatch. :meth:`resolve` reads it (a legal sync, outside every
    launch window) as a Python list; the Chrome export and the roofline
    join resolve it, after the work is done."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor.detach()

    def resolve(self) -> list:
        from citizensassemblies_tpu_torch.utils.guards import readback

        with readback():
            return self.tensor.reshape(-1).tolist()

    def __repr__(self) -> str:
        return f"DeviceValue(shape={tuple(self.tensor.shape)})"


def _jsonable(v):
    if isinstance(v, DeviceValue):
        v = v.resolve()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)) and all(isinstance(x, (int, float)) for x in v):
        return list(v)
    return str(v)


# --- ambient activation ------------------------------------------------------


def current_tracer() -> Optional[Tracer]:
    """The calling thread/task's ambient tracer (None = tracing off)."""
    return _AMBIENT.get()


def activate_tracer(tracer: Optional[Tracer]):
    """Low-level install; returns the reset token (used by
    ``service.context.use_context`` to compose with its own ContextVar)."""
    return _AMBIENT.set(tracer)


def deactivate_tracer(token) -> None:
    _AMBIENT.reset(token)


@contextmanager
def use_tracer(tracer: Optional[Tracer]):
    """Install ``tracer`` as the ambient tracer for the scope (``None`` is a
    passthrough, so callers can wrap unconditionally)."""
    if tracer is None:
        yield None
        return
    token = activate_tracer(tracer)
    try:
        yield tracer
    finally:
        deactivate_tracer(token)


def _resolve(log=None) -> Optional[Tracer]:
    """Tracer resolution shared by the span helpers: the log-carried tracer
    (worker threads) wins, else the ambient one, else None (= off)."""
    if log is not None:
        tr = getattr(log, "tracer", None)
        if tr is not None:
            return tr
    return _AMBIENT.get()


@contextmanager
def span(name: str, log=None, **attrs):
    """Ambient nested span; a no-op yielding ``None`` when tracing is off."""
    tr = _resolve(log)
    if tr is None:
        yield None
        return
    sp = tr.begin(name, stacked=True, **attrs)
    try:
        yield sp
    finally:
        tr.end(sp)


def begin_span(name: str, log=None, **attrs) -> Optional[Span]:
    """Open an UNSTACKED interval (see :meth:`Tracer.begin`); pair with
    :func:`end_span`. Returns ``None`` (and does nothing) when tracing is
    off, so callers never need their own gate."""
    tr = _resolve(log)
    if tr is None:
        return None
    return tr.begin(name, stacked=False, **attrs)


def end_span(sp: Optional[Span], log=None) -> None:
    """Close an interval from :func:`begin_span` (``None``-safe, idempotent)."""
    if sp is None:
        return
    tr = _resolve(log)
    if tr is not None:
        tr.end(sp)
    else:  # tracer uninstalled between begin and end — still stamp the close
        if sp.t1 is None:
            sp.t1 = time.perf_counter()


# --- export / validation -----------------------------------------------------


def export_chrome_trace(
    tracers: Iterable[Tracer], path: Optional[str] = None
) -> dict:
    """Merge one or more tracers into a single Chrome trace document (each
    tracer becomes one ``pid`` — the per-request process lanes of a serve
    trace). Writes JSON to ``path`` when given; returns the document."""
    events: List[dict] = []
    total_dropped = 0
    names = []
    for pid, tr in enumerate(tracers, start=1):
        events.extend(tr.chrome_events(pid=pid))
        total_dropped += tr.dropped
        names.append(tr.name)
    doc = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {
            "producer": "citizensassemblies_tpu_torch.obs",
            "tracers": names,
            "dropped_spans": total_dropped,
        },
    }
    if path is not None:
        import json

        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    return doc


def validate_chrome_trace(doc) -> List[str]:
    """Schema check of an exported trace document; returns the list of
    problems (empty = valid). This is the contract the CI artifacts and the
    smoke assertion rely on, pinned by ``tests/test_obs.py``."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema_version") != TRACE_SCHEMA_VERSION:
        problems.append(
            f"schema_version {doc.get('schema_version')!r} != {TRACE_SCHEMA_VERSION}"
        )
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return problems + ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing/empty name")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: pid/tid must be ints")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
                problems.append(f"event {i}: ts/dur must be numbers")
            elif dur < 0:
                problems.append(f"event {i}: negative duration")
            if not isinstance(ev.get("args", {}), dict):
                problems.append(f"event {i}: args must be an object")
    return problems


def _union_seconds(intervals: List[tuple]) -> float:
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    total += cur_hi - cur_lo
    return total


def span_coverage(tracer: Tracer, root_name: str) -> float:
    """Fraction of the wall time of the first completed span named
    ``root_name`` that is covered by the union of its DIRECT children
    (clipped to the root's interval). The acceptance-criteria number: the
    face-decomposition phase must trace ≥ 0.9 here."""
    spans = tracer.spans()
    root = next(
        (s for s in spans if s.name == root_name and s.t1 is not None), None
    )
    if root is None or root.duration <= 0:
        return 0.0
    ivs = []
    for s in spans:
        if s.parent_id != root.span_id:
            continue
        t1 = s.t1 if s.t1 is not None else root.t1
        lo, hi = max(s.t0, root.t0), min(t1, root.t1)
        if hi > lo:
            ivs.append((lo, hi))
    return _union_seconds(ivs) / root.duration
