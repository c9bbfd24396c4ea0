"""SLO engine: declarative objectives over the serving metrics.

The service reports raw p50/p99 and failure counters; an operator needs the
next layer: "is tenant X inside its latency objective, and how fast is it
burning error budget?" This module turns ``Config.obs_slo_spec`` — a
one-line declarative spec like ``latency_p99:20s,error_rate:0.01`` — into
that evaluation:

* **objectives** — ``latency_pNN:<seconds>`` (the NN-th percentile of
  request sojourn must stay under the target) and ``error_rate:<frac>``
  (the failure fraction must stay under the target). A ``tenant/``-prefixed
  entry (``civic/latency_p99:5s``) overrides the global objective for that
  tenant; every tenant is additionally evaluated against the global
  entries, so per-tenant SLOs need no per-tenant spec lines.
* **multi-window burn rate** — for each objective and each window (1 min /
  5 min / 1 h by default), the ratio of observed badness to the budget the
  objective allows: error burn = observed error rate / target rate;
  latency burn = fraction of requests over the latency target / allowed
  tail fraction (1% for p99). Burn > 1 means the budget is being consumed
  faster than sustainable over that window — the standard multi-window
  alerting shape, computed here rather than in an external system.
* **breaches** — an objective whose full-window observation violates its
  target. The service streams each breach transition as a ``("slo", …)``
  event into every open ResultChannel and counts it
  (``graftserve_slo_breach_total``).

The engine is stdlib-only and lock-guarded (service worker threads record
completions concurrently); the event history is bounded by the largest
window, so a long-lived service cannot grow it without bound.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

SLO_SCHEMA_VERSION = 1

#: default burn-rate windows (seconds): fast / medium / slow
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 300.0, 3600.0)

_LATENCY_RE = re.compile(r"^latency_p(\d{1,2})$")


def _parse_target(objective: str, raw: str) -> float:
    """Target value with unit handling: ``20s``/``150ms`` for latency
    objectives, a bare fraction for rates."""
    raw = raw.strip()
    if raw.endswith("ms"):
        return float(raw[:-2]) / 1e3
    if raw.endswith("s"):
        return float(raw[:-1])
    return float(raw)


def parse_slo_spec(spec: str) -> Dict[Optional[str], Dict[str, float]]:
    """``"latency_p99:20s,error_rate:0.01,civic/latency_p99:5s"`` →
    ``{None: {...global...}, "civic": {...overrides...}}``. Raises
    ``ValueError`` on malformed entries — a typo'd SLO spec must fail the
    service at construction, not silently never gate."""
    out: Dict[Optional[str], Dict[str, float]] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(f"SLO entry {entry!r} has no ':<target>'")
        name, raw = entry.split(":", 1)
        tenant: Optional[str] = None
        if "/" in name:
            tenant, name = name.split("/", 1)
        name = name.strip()
        if name != "error_rate" and not _LATENCY_RE.match(name):
            raise ValueError(
                f"unknown SLO objective {name!r} (want latency_pNN or error_rate)"
            )
        out.setdefault(tenant, {})[name] = _parse_target(name, raw)
    return out


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — the conservative estimator
    for small serving samples; matches the bench's quantile convention."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1, int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


@dataclasses.dataclass
class SloEvent:
    t: float
    tenant: str
    latency_s: float
    ok: bool


class SloEngine:
    """Evaluates a parsed spec over a bounded stream of request outcomes."""

    def __init__(
        self,
        spec: str,
        windows: Tuple[float, ...] = DEFAULT_WINDOWS,
        clock=time.monotonic,
    ):
        self.spec = parse_slo_spec(spec)
        self.windows = tuple(sorted(windows))
        self._clock = clock
        self._events: List[SloEvent] = []
        self._lock = threading.Lock()
        self._breached: set = set()  # (tenant, objective) currently breaching

    def record(self, tenant: str, latency_s: float, ok: bool) -> None:
        """One terminal request outcome (success, failure, or deadline)."""
        now = self._clock()
        horizon = now - self.windows[-1]
        with self._lock:
            self._events.append(
                SloEvent(t=now, tenant=tenant, latency_s=float(latency_s), ok=ok)
            )
            # trim anything older than the slowest window (bounded history)
            if self._events and self._events[0].t < horizon:
                self._events = [e for e in self._events if e.t >= horizon]

    def _objectives_for(self, tenant: str) -> Dict[str, float]:
        merged = dict(self.spec.get(None, {}))
        merged.update(self.spec.get(tenant, {}))
        return merged

    @staticmethod
    def _observe(
        events: List[SloEvent], objective: str, target: float
    ) -> Tuple[float, float]:
        """(observed value, burn rate) of one objective over ``events``."""
        if objective == "error_rate":
            observed = sum(1 for e in events if not e.ok) / max(len(events), 1)
            return observed, observed / max(target, 1e-12)
        q = float(_LATENCY_RE.match(objective).group(1))
        lat = [e.latency_s for e in events]
        observed = _percentile(lat, q)
        allowed_tail = max(1.0 - q / 100.0, 1e-12)
        over = sum(1 for v in lat if v > target) / max(len(lat), 1)
        return observed, over / allowed_tail

    def evaluate(self) -> Dict[str, Any]:
        """The full SLO report: per tenant × objective, the full-history
        observation, per-window burn rates, and the breach verdict."""
        with self._lock:
            events = list(self._events)
        now = self._clock()
        tenants = sorted({e.tenant for e in events})
        report: Dict[str, Any] = {
            "schema_version": SLO_SCHEMA_VERSION,
            "spec": {
                (t if t is not None else "*"): dict(objs)
                for t, objs in self.spec.items()
            },
            "windows_s": list(self.windows),
            "events": len(events),
            "tenants": {},
            "breaches": [],
        }
        for tenant in tenants:
            tenant_events = [e for e in events if e.tenant == tenant]
            objectives = self._objectives_for(tenant)
            tenant_block: Dict[str, Any] = {}
            for objective, target in sorted(objectives.items()):
                observed, _burn = self._observe(tenant_events, objective, target)
                burns = {}
                for win in self.windows:
                    recent = [e for e in tenant_events if e.t >= now - win]
                    if recent:
                        _obs, burn = self._observe(recent, objective, target)
                        burns[f"{int(win)}s"] = round(burn, 4)
                ok = observed <= target
                tenant_block[objective] = {
                    "target": target,
                    "observed": round(observed, 6),
                    "ok": ok,
                    "burn_rates": burns,
                }
                if not ok:
                    report["breaches"].append(
                        {
                            "tenant": tenant,
                            "objective": objective,
                            "target": target,
                            "observed": round(observed, 6),
                            "burn_rates": burns,
                        }
                    )
            report["tenants"][tenant] = tenant_block
        report["slo_ok"] = not report["breaches"]
        return report

    def new_breaches(self) -> List[Dict[str, Any]]:
        """Breaches that TRANSITIONED since the last call — what the service
        streams as ``("slo", …)`` events (steady-state breaching does not
        re-emit every request; recovery re-arms the transition)."""
        report = self.evaluate()
        current = {(b["tenant"], b["objective"]): b for b in report["breaches"]}
        with self._lock:
            fresh = [current[k] for k in sorted(current) if k not in self._breached]
            self._breached = set(current)
        return fresh

    def window_burns(self, window_s: float) -> Dict[Tuple[str, str], float]:
        """Burn rate of every tenant × objective over the last ``window_s``
        seconds only — the fast signal the load-management policy keys on.
        An empty window (no events) yields an empty dict: burns age out with
        their events, so a fully-shedding service can still observe recovery
        without needing fresh terminal outcomes."""
        now = self._clock()
        with self._lock:
            events = [e for e in self._events if e.t >= now - window_s]
        out: Dict[Tuple[str, str], float] = {}
        for tenant in sorted({e.tenant for e in events}):
            tenant_events = [e for e in events if e.tenant == tenant]
            for objective, target in sorted(self._objectives_for(tenant).items()):
                _obs, burn = self._observe(tenant_events, objective, target)
                out[(tenant, objective)] = round(burn, 4)
        return out


class SloLoadPolicy:
    """Load management: the SLO engine closed into an actuator.

    The engine alone only observes — breaches stream as events and an
    operator reacts. A fleet under open-loop load cannot wait for an
    operator: offered rate does not slow down because the service is
    drowning. This policy closes the loop with the two levers the stack
    already certifies:

    * **admission shedding** — while the fast-window burn rate of any
      tenant × objective sits at/above ``serve_shed_burn``, new submissions
      are rejected with a typed ``("error", {"kind": "ShedRejection", …})``
      terminal event carrying an audit stub (tenant, burn, rung,
      timestamp), counted ``graftserve_shed_total``. Shedding load is the
      only move that helps a queue whose arrival rate exceeds service rate.
    * **degradation-ladder descent** — each sustained breach interval walks
      the service-level ladder one rung (in the JAX package megakernel→
      chained, device pricing→host, ELL→dense by default:
      ``serve_shed_max_rungs=3`` stops before the rungs that change the
      batching/mesh execution shape), so surviving requests run the cheaper
      certified path. The port's ladder has no kernel → chained-ops rung (a
      kernel's failure raises, ``robust/policy.py``), so the policy's rung 1
      changes no config here and its rung r applies the port's first r − 1
      rungs: the same capacity rungs at the same rung numbers. Rungs are
      applied to the *service* config for every admitted request,
      independently of the per-request retry ladder.

    Recovery RE-ARMS: when every fast-window burn falls to/below
    ``serve_shed_recover`` (hysteresis band below the shed threshold — or
    the window empties entirely), shedding switches off, the ladder resets
    to rung 0, and the transition is counted
    ``graftserve_shed_rearm_total``. All state transitions happen inside
    :meth:`update`, which both the submit path and the completion path
    call, so recovery does not require fresh terminal outcomes.

    Thread-safe; stdlib-only except a lazy import of the degradation ladder
    table when a rung is actually applied.
    """

    def __init__(self, engine: SloEngine, cfg, clock=time.monotonic):
        self.engine = engine
        self.burn_open = float(getattr(cfg, "serve_shed_burn", 2.0))
        self.burn_close = float(getattr(cfg, "serve_shed_recover", 0.5))
        self.window_s = float(getattr(cfg, "serve_shed_window_s", 60.0))
        self.max_rungs = int(getattr(cfg, "serve_shed_max_rungs", 3))
        #: a sustained breach descends one further rung per cooldown, so a
        #: single burst cannot slam the ladder to the bottom instantly
        self.cooldown_s = max(self.window_s / 4.0, 1e-6)
        self._clock = clock
        self._lock = threading.Lock()
        self.shedding = False
        self.rung = 0
        self.worst_burn = 0.0
        self.shed_total = 0
        self.rearm_total = 0
        self.descend_total = 0
        self._last_descent: Optional[float] = None

    def update(self) -> float:
        """Evaluate the fast window and run the state machine; returns the
        worst observed burn. Called on every submit and every completion."""
        burns = self.engine.window_burns(self.window_s)
        worst = max(burns.values()) if burns else 0.0
        now = self._clock()
        with self._lock:
            self.worst_burn = worst
            if worst >= self.burn_open:
                if not self.shedding:
                    self.shedding = True
                    self._descend(now)
                elif (
                    self._last_descent is not None
                    and now - self._last_descent >= self.cooldown_s
                ):
                    self._descend(now)
            elif worst <= self.burn_close and self.shedding:
                self.shedding = False
                self.rung = 0
                self._last_descent = None
                self.rearm_total += 1
        return worst

    def _descend(self, now: float) -> None:
        if self.rung < self.max_rungs:
            self.rung += 1
            self.descend_total += 1
        self._last_descent = now

    def shed(self, tenant: str, request_id: str) -> Dict[str, Any]:
        """Count one shed admission and return its audit stub — the typed
        rejection ships evidence of WHY, not a bare refusal."""
        with self._lock:
            self.shed_total += 1
            return {
                "tenant": tenant,
                "request_id": request_id,
                "worst_burn": round(self.worst_burn, 4),
                "burn_threshold": self.burn_open,
                "rung": self.rung,
                "window_s": self.window_s,
                "t": self._clock(),
            }

    def degraded(self, cfg, log=None):
        """``cfg`` with the policy's current rungs applied (cumulative, in
        ladder order; rung r is the port's first r − 1 rungs, the JAX
        package's kernel rung having no counterpart). Rungs 0 and 1 return
        ``cfg`` unchanged — the armed-but-idle policy is bit-identical to no
        policy."""
        with self._lock:
            rung = self.rung
        if rung <= 1:
            return cfg
        from citizensassemblies_tpu_torch.robust.policy import DegradationLadder

        ladder = DegradationLadder()
        for _ in range(rung - 1):
            cfg = ladder.degrade(cfg, log)
        return cfg

    def stamp(self) -> Dict[str, Any]:
        """Policy state snapshot for reports and the fleet rollup."""
        with self._lock:
            return {
                "shedding": self.shedding,
                "rung": self.rung,
                "worst_burn": round(self.worst_burn, 4),
                "shed_total": self.shed_total,
                "rearm_total": self.rearm_total,
                "descend_total": self.descend_total,
            }
