"""Typed metrics registry: Counter/Gauge/Timer/Histogram with label sets.

The JAX package's registry, kept as its own copy here (it imports nothing
of JAX, but the port imports nothing of the JAX package). ``RunLog``'s
counters, gauges and timers live in one, and each ``SelectionService``
keeps one for the fleet (rendered as Prometheus text), so both read the
same instruments with optional label sets (tenant, phase, bucket shape).

Bit-compatibility contract: ``RunLog.count``/``gauge``/``timer`` delegate
here, and :meth:`MetricsRegistry.flat_counters` / :meth:`flat_timers`
reproduce the OLD dict semantics exactly —

* counters accumulate (``get + inc``), gauges are latest-wins, and the two
  share one value namespace (the old code kept both in ``_counters``, so a
  gauge write to a counter's name replaces it, and a later ``count`` on
  that name increments from the gauge value);
* timers live in their own namespace and accumulate float seconds;
* both accessors return DEFENSIVE COPIES taken under the registry lock
  (concurrent service requests count into shared engine logs — the
  no-lost-increment contract ``tests/test_service.py`` hammers).

Label cardinality is CAPPED per instrument (``max_label_sets``, wired to
``Config.obs_max_label_sets`` by the service): past the cap, new label sets
fold into a reserved overflow series instead of growing without bound — a
misbehaving label (request id, say) degrades to one series plus a visible
``label_overflow`` count, never an OOM.

Stdlib only: importable from every host-only path.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Dict, List, Tuple

#: the reserved label set absorbing series beyond the cardinality cap
OVERFLOW_LABELS: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)

#: default per-instrument label-set cap (Config.obs_max_label_sets mirrors
#: this default; the service passes its configured value through)
DEFAULT_MAX_LABEL_SETS = 64

#: default histogram bucket boundaries (seconds-flavored; override per
#: instrument) — cumulative counts render Prometheus-style with +Inf
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)

_VALUE_KINDS = ("counter", "gauge")


class _Instrument:
    """One named instrument: a family of label-keyed series.

    ``kind`` ∈ counter|gauge|timer|histogram. Counter and gauge instruments
    of the same name share storage through the registry's value namespace —
    see the bit-compatibility contract in the module docstring.
    """

    __slots__ = ("registry", "kind", "name", "help", "labelnames", "buckets")

    def __init__(self, registry, kind, name, help="", labelnames=(), buckets=None):
        self.registry = registry
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS

    def labels(self, **kv) -> "_Bound":
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple((k, str(kv[k])) for k in self.labelnames)
        return _Bound(self, self.registry._admit(self, key))

    # unlabeled shortcut (the RunLog delegation path)
    def _bound(self) -> "_Bound":
        return _Bound(self, ())

    def inc(self, v: float = 1) -> None:
        self._bound().inc(v)

    def set(self, v) -> None:
        self._bound().set(v)

    def observe(self, v: float) -> None:
        self._bound().observe(v)

    def time(self):
        return self._bound().time()


class _Bound:
    """An instrument bound to one label set."""

    __slots__ = ("inst", "key")

    def __init__(self, inst: _Instrument, key: Tuple[Tuple[str, str], ...]):
        self.inst = inst
        self.key = key

    def inc(self, v: float = 1) -> None:
        if self.inst.kind != "counter":
            raise TypeError(f"{self.inst.name} is a {self.inst.kind}, not a counter")
        self.inst.registry._add_value(self.inst, self.key, v, kind="counter")

    def set(self, v) -> None:
        if self.inst.kind != "gauge":
            raise TypeError(f"{self.inst.name} is a {self.inst.kind}, not a gauge")
        self.inst.registry._set_value(self.inst, self.key, v, kind="gauge")

    def observe(self, v: float) -> None:
        reg = self.inst.registry
        if self.inst.kind == "timer":
            reg._add_timer(self.inst, self.key, float(v))
        elif self.inst.kind == "histogram":
            reg._observe_hist(self.inst, self.key, float(v))
        else:
            raise TypeError(f"{self.inst.name} is a {self.inst.kind}")

    @contextmanager
    def time(self):
        t0 = perf_counter()
        try:
            yield
        finally:
            self.observe(perf_counter() - t0)


class MetricsRegistry:
    """Thread-safe registry of typed instruments; one per ``RunLog`` (the
    request-scoped channel) and one per ``SelectionService`` (the fleet
    channel rendered by :meth:`render_prometheus`)."""

    def __init__(self, max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self.max_label_sets = max(int(max_label_sets), 1)
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str], _Instrument] = {}
        #: counter/gauge shared value namespace: {(name, labelkey): value}
        self._values: Dict[Tuple[str, tuple], Any] = {}
        #: which kind last wrote a value key (flat render + inc semantics)
        self._value_kind: Dict[Tuple[str, tuple], str] = {}
        self._timers: Dict[Tuple[str, tuple], float] = {}
        #: {(name, labelkey): (bucket_counts list, count, sum)}
        self._hists: Dict[Tuple[str, tuple], list] = {}
        #: distinct label sets seen per instrument name (cardinality cap)
        self._label_sets: Dict[str, set] = {}
        self.label_overflow = 0

    # --- instrument constructors -------------------------------------------

    def _get(self, kind: str, name: str, help="", labelnames=(), buckets=None):
        group = "value" if kind in _VALUE_KINDS else kind
        with self._lock:
            inst = self._instruments.get((group, name))
            if inst is None:
                inst = _Instrument(self, kind, name, help, labelnames, buckets)
                self._instruments[(group, name)] = inst
            elif inst.kind != kind:
                # counter↔gauge retype mirrors the old one-dict semantics:
                # the storage survives, the declared kind follows the caller
                inst.kind = kind  # type: ignore[misc]
            return inst

    def counter(self, name: str, help: str = "", labelnames=()) -> _Instrument:
        return self._get("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> _Instrument:
        return self._get("gauge", name, help, labelnames)

    def timer(self, name: str, help: str = "", labelnames=()) -> _Instrument:
        return self._get("timer", name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=None
    ) -> _Instrument:
        return self._get("histogram", name, help, labelnames, buckets)

    # --- storage (all under the lock) --------------------------------------

    def _admit(self, inst: _Instrument, key: tuple) -> tuple:
        """Cardinality cap: a NEW label set beyond ``max_label_sets`` folds
        into the reserved overflow series (counted, never unbounded)."""
        if not key:
            return key
        with self._lock:
            seen = self._label_sets.setdefault(inst.name, set())
            if key in seen:
                return key
            if len(seen) >= self.max_label_sets:
                self.label_overflow += 1
                seen.add(OVERFLOW_LABELS)
                return OVERFLOW_LABELS
            seen.add(key)
            return key

    def _add_value(self, inst, key, v, kind):
        k = (inst.name, key)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + v
            self._value_kind[k] = kind

    def _set_value(self, inst, key, v, kind):
        k = (inst.name, key)
        with self._lock:
            self._values[k] = v
            self._value_kind[k] = kind

    def _add_timer(self, inst, key, dt):
        k = (inst.name, key)
        with self._lock:
            self._timers[k] = self._timers.get(k, 0.0) + dt

    def _observe_hist(self, inst, key, v):
        k = (inst.name, key)
        with self._lock:
            rec = self._hists.get(k)
            if rec is None:
                rec = [[0] * (len(inst.buckets) + 1), 0, 0.0]
                self._hists[k] = rec
            counts, _n, _s = rec
            for i, edge in enumerate(inst.buckets):
                if v <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            rec[1] += 1
            rec[2] += v

    # --- flat (RunLog bit-compat) accessors --------------------------------

    @staticmethod
    def _flat_name(name: str, key: tuple) -> str:
        if not key:
            return name
        return name + "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"

    def flat_counters(self) -> Dict[str, Any]:
        """The old ``RunLog._counters`` dict: counters AND gauges, one flat
        namespace, labeled series rendered ``name{k="v"}``. A defensive
        copy under the lock."""
        with self._lock:
            return {
                self._flat_name(name, key): value
                for (name, key), value in self._values.items()
            }

    def flat_timers(self) -> Dict[str, float]:
        """The old ``RunLog._timers`` dict (defensive copy under the lock)."""
        with self._lock:
            return {
                self._flat_name(name, key): value
                for (name, key), value in self._timers.items()
            }

    # --- snapshot / prometheus rendering ------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Structured snapshot (the service's periodic ``("metrics", …)``
        progress event payload)."""
        with self._lock:
            values = {
                self._flat_name(n, k): v for (n, k), v in self._values.items()
            }
            kinds = {
                self._flat_name(n, k): kind
                for (n, k), kind in self._value_kind.items()
            }
            timers = {
                self._flat_name(n, k): v for (n, k), v in self._timers.items()
            }
            hists = {
                self._flat_name(n, k): {"count": rec[1], "sum": rec[2]}
                for (n, k), rec in self._hists.items()
            }
            overflow = self.label_overflow
        return {
            "schema_version": 1,
            "counters": {n: v for n, v in values.items() if kinds.get(n) == "counter"},
            "gauges": {n: v for n, v in values.items() if kinds.get(n) == "gauge"},
            "timers": timers,
            "histograms": hists,
            "label_overflow": overflow,
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every series — the fleet bench's
        scrape-style dump (``SelectionService.metrics_text``)."""
        lines: List[str] = []
        with self._lock:
            insts = dict(self._instruments)
            values = dict(self._values)
            kinds = dict(self._value_kind)
            timers = dict(self._timers)
            hists = {k: (list(v[0]), v[1], v[2]) for k, v in self._hists.items()}
            overflow = self.label_overflow
        emitted = set()

        def _head(name: str, kind: str, help_: str):
            if name in emitted:
                return
            emitted.add(name)
            if help_:
                lines.append(f"# HELP {_sanitize(name)} {help_}")
            lines.append(f"# TYPE {_sanitize(name)} {kind}")

        for (group, name), inst in sorted(insts.items()):
            if group == "value":
                kind = "counter" if inst.kind == "counter" else "gauge"
                for (vname, key), v in sorted(
                    (kv for kv in values.items() if kv[0][0] == name),
                    key=lambda kv: kv[0][1],
                ):
                    _head(name, kinds.get((vname, key), kind), inst.help)
                    lines.append(
                        f"{_sanitize(name)}{_labels(key)} {_num(v)}"
                    )
            elif group == "timer":
                for (tname, key), v in sorted(
                    (kv for kv in timers.items() if kv[0][0] == name),
                    key=lambda kv: kv[0][1],
                ):
                    _head(name + "_seconds_total", "counter", inst.help)
                    lines.append(
                        f"{_sanitize(name)}_seconds_total{_labels(key)} {_num(v)}"
                    )
            elif group == "histogram":
                for (hname, key), (counts, n, s) in sorted(
                    (kv for kv in hists.items() if kv[0][0] == name),
                    key=lambda kv: kv[0][1],
                ):
                    _head(name, "histogram", inst.help)
                    cum = 0
                    for edge, c in zip(inst.buckets, counts):
                        cum += c
                        lines.append(
                            f"{_sanitize(name)}_bucket"
                            f"{_labels(key + (('le', repr(float(edge))),))} {cum}"
                        )
                    lines.append(
                        f"{_sanitize(name)}_bucket"
                        f"{_labels(key + (('le', '+Inf'),))} {n}"
                    )
                    lines.append(f"{_sanitize(name)}_count{_labels(key)} {n}")
                    lines.append(f"{_sanitize(name)}_sum{_labels(key)} {_num(s)}")
        if overflow:
            lines.append("# TYPE grafttrace_label_overflow_total counter")
            lines.append(f"grafttrace_label_overflow_total {overflow}")
        return "\n".join(lines) + ("\n" if lines else "")


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _num(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    return repr(int(f)) if f == int(f) else repr(f)


# --- in-band rendering (absorbed from utils/profiling) -----------------------


def format_timers(timers: Dict[str, float]) -> str:
    """One-line phase-time attribution, largest first."""
    if not timers:
        return "phase times: (none recorded)"
    parts = [
        f"{name} {secs:.2f}s"
        for name, secs in sorted(timers.items(), key=lambda kv: -kv[1])
    ]
    return "phase times: " + ", ".join(parts)


def format_counters(counters: Dict[str, int]) -> str:
    """One-line phase-event attribution (warm-start hits, overlap harvests,
    cold restarts — the pipelined decomposition's counterpart to the wall
    timers), largest first."""
    if not counters:
        return "phase counters: (none recorded)"
    parts = [
        f"{name} {cnt}"
        for name, cnt in sorted(counters.items(), key=lambda kv: -kv[1])
    ]
    return "phase counters: " + ", ".join(parts)
