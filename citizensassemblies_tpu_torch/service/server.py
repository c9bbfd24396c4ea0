"""The selection service: whole selection jobs served side by side on one card.

One :class:`SelectionService` owns a request queue, a pool of worker threads,
a :class:`~citizensassemblies_tpu_torch.service.batcher.CrossRequestBatcher`
and a :class:`~citizensassemblies_tpu_torch.service.session.TenantRegistry`,
and runs every request on its ``device`` (CUDA unless the caller passes
another; a service built for CUDA on a machine without it raises at
construction). Clients :meth:`~SelectionService.submit` whole selection
instances (pool, quotas, k and an algorithm among legacy, leximin, xmin,
dropout and multi) and get back a :class:`ResultChannel` that streams
progress events while the job runs and delivers the final allocation with a
per-request audit stamp.

Request lifecycle::

    submit(SelectionRequest) ──admission──▶ queued ──worker──▶ running
        │                                                        │
        ▶ AdmissionError when                    RequestContext installed:
          serve_queue_depth in-flight           per-request Config + RunLog,
          requests already exist                tenant session, warm store,
                                                cross-request batcher
                                                         │
    ResultChannel ◀── progress events ── RunLog lines ───┤
    ResultChannel ◀── ("result", RequestResult + audit stamp) on success
    ResultChannel ◀── ("error", message) on failure

Concurrency: ``serve_admission_cap`` worker threads run requests; every
piece of per-request solver state rides the ambient ``RequestContext``
(config, log, warm slots, tracer), so concurrent requests are isolated and
each equals its serial twin bit for bit. Every request's kernels go to the
one current stream of its thread (the legacy default stream), so two
requests' cooperative grids never overlap on the card; the workers run
under ``utils/guards.shared_device``, so a legal sync of one request never
meets another's launch window. Batchable LP fleets of different requests
fuse through the batcher into shared engine calls.

Cold start: the service boots the graph store (``aot/``) under the
tri-state ``Config.aot_cache`` at construction (its kernel libraries
loaded, its recorded graphs captured), prewarms the ``batch_lp.`` families
on each tenant's first admission off-thread (``Config.aot_prewarm``), sets
the gauges ``aot_cache_hit``/``miss``/``stale`` and ``aot_prewarmed`` and
stamps ``audit["aot"]`` whenever a store is installed. The audit's
``xla_compiles`` key counts the port's one-time work per shape
(``utils/guards.CompilationGuard``: graph captures and kernel builds).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from citizensassemblies_tpu_torch.obs.metrics import MetricsRegistry
from citizensassemblies_tpu_torch.service.batcher import CrossRequestBatcher
from citizensassemblies_tpu_torch.service.context import (
    RequestContext,
    _next_request_id,
    use_context,
)
from citizensassemblies_tpu_torch.service.session import TenantRegistry
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog


class AdmissionError(RuntimeError):
    """The service's queue is at ``serve_queue_depth``; retry later."""


@dataclasses.dataclass
class SelectionRequest:
    """One whole selection job: an instance plus how to solve it.

    Pass either ``instance`` (a ``core.generator`` Instance — the service
    featurizes it) or a pre-featurized ``(dense, space)`` pair. ``cfg``
    overrides the service's default config FOR THIS REQUEST only (the
    re-entrancy refactor exists so that this is safe). ``iterations``/
    ``seed`` parameterize the LEGACY Monte-Carlo estimator and are ignored
    by the exact algorithms. ``dropout`` (per-agent no-show probabilities)
    parameterizes the "dropout" scenario algorithm; ``rounds`` the "multi"
    scenario (``None`` → ``Config.scenario_rounds``).
    """

    algorithm: str = "leximin"  # "legacy" | "leximin" | "xmin" | "dropout" | "multi"
    instance: Any = None
    dense: Any = None
    space: Any = None
    households: Optional[np.ndarray] = None
    cfg: Optional[Config] = None
    tenant: str = "default"
    request_id: Optional[str] = None
    iterations: int = 1_000
    seed: int = 0
    dropout: Optional[np.ndarray] = None
    rounds: Optional[int] = None
    #: a ``solvers.delta.ReviseSpec`` (one registry edit against
    #: an identified base solve). Only meaningful with algorithm="leximin";
    #: the service re-certifies incrementally when the tenant session holds
    #: the base certificate, and falls back BIT-IDENTICALLY to from-scratch
    #: when it cannot (cold session, oversized edit, Config.delta_solve=False)
    revise: Any = None


@dataclasses.dataclass
class RequestResult:
    """Terminal payload of a request's channel."""

    request_id: str
    tenant: str
    algorithm: str
    allocation: np.ndarray
    result: Any  # Distribution (leximin/xmin) or LegacyResult (legacy)
    audit: Dict[str, Any]
    seconds: float
    from_memo: bool = False


class ResultChannel:
    """Streamed events of one request: ``("progress", line)`` while the job
    runs, then exactly one terminal ``("result", RequestResult)`` or
    ``("error", message)``. Events are retained, so :meth:`events` and
    :meth:`result` may be called in any order (or repeatedly).

    Retention is CAPPED (``Config.serve_channel_cap``): a long request's
    progress + metrics stream cannot grow without bound — past the cap,
    incoming non-terminal events are dropped and counted
    (:attr:`dropped`); the terminal result + audit stamp is always
    retained."""

    _TERMINAL = ("result", "error")

    def __init__(self, request_id: str, cap: int = 1024):
        self.request_id = request_id
        self._cond = threading.Condition()
        self._events: List[Tuple[str, Any]] = []
        self._done = False
        self._cap = max(int(cap), 8)
        #: non-terminal events dropped by the retention cap
        self.dropped = 0

    def push(self, kind: str, payload: Any) -> None:
        with self._cond:
            if kind not in self._TERMINAL and len(self._events) >= self._cap:
                self.dropped += 1
                return
            self._events.append((kind, payload))
            if kind in self._TERMINAL:
                self._done = True
            self._cond.notify_all()

    def events(self, timeout: Optional[float] = None) -> Iterator[Tuple[str, Any]]:
        """Yield events in order, blocking for new ones until terminal."""
        i = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                while i >= len(self._events):
                    if self._done:
                        return
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"request {self.request_id}: no event within timeout"
                        )
                    self._cond.wait(timeout=remaining)
                event = self._events[i]
            i += 1
            yield event
            if event[0] in self._TERMINAL:
                return

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until the terminal event; raise on request failure."""
        for kind, payload in self.events(timeout=timeout):
            if kind == "result":
                return payload
            if kind == "error":
                raise RuntimeError(
                    f"request {self.request_id} failed: {payload}"
                )
        raise RuntimeError(f"request {self.request_id}: channel closed early")


class _ChannelLog(RunLog):
    """A RunLog that additionally streams every line as a progress event."""

    def __init__(self, channel: ResultChannel):
        super().__init__(echo=False)
        self._channel = channel

    def emit(self, message: str) -> str:
        super().emit(message)
        self._channel.push("progress", message)
        return message


class SelectionService:
    """Persistent async serving layer over the solver stack, on ``device``
    (CUDA unless the caller passes another; raises at construction when
    CUDA is asked for and absent)."""

    def __init__(self, cfg: Optional[Config] = None, device: DeviceLike = None):
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        #: hard cap on in-flight (queued + running) requests; submit()
        #: raises AdmissionError beyond it (Config.serve_queue_depth)
        self.queue_depth = max(int(self.cfg.serve_queue_depth), 1)
        #: worker threads — the number of requests RUNNING concurrently
        #: (Config.serve_admission_cap)
        self.workers = max(int(self.cfg.serve_admission_cap), 1)
        self.batcher = CrossRequestBatcher(self.cfg)
        self.tenants = TenantRegistry(
            cap_per_tenant=int(self.cfg.serve_tenant_memo_cap)
        )
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="selection-service"
        )
        self._lock = threading.Lock()
        self._in_flight = 0
        self._completed = 0
        self._failed = 0
        self._memo_served = 0
        # --- observability (obs/) --------------------------------------------
        #: the fleet-level typed metrics registry: per-tenant request
        #: counters, queue/batcher gauges, request-latency histogram —
        #: rendered by metrics_text() (Prometheus) and streamed as periodic
        #: ("metrics", …) channel events by the snapshot loop below
        self.metrics = MetricsRegistry(
            max_label_sets=int(getattr(self.cfg, "obs_max_label_sets", 64))
        )
        #: open channels the snapshot loop broadcasts into (rid → channel)
        self._channels: Dict[str, ResultChannel] = {}
        #: finished per-request tracers, newest last (bounded retention) —
        #: export_traces() merges them into one Chrome trace document
        self._traces: List[Any] = []
        self._snap_stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        #: drain bookkeeping: rid → (future, channel). Shutdown cancels the
        #: queued-but-unstarted futures and pushes each a typed terminal
        #: rejection; running requests complete (or are deadline-bounded)
        self._futures: Dict[str, Tuple[Any, ResultChannel]] = {}
        self._closed = False
        # --- SLO engine (obs/slo.py) ------------------------------------------
        #: built from Config.obs_slo_spec when non-empty: every terminal
        #: request outcome is recorded, breach TRANSITIONS are streamed as
        #: ("slo", …) events into every open channel and counted
        #: (graftserve_slo_breach_total); a malformed spec fails here, at
        #: construction, not silently at evaluation time
        self.slo = None
        slo_spec = str(getattr(self.cfg, "obs_slo_spec", "") or "")
        if slo_spec:
            from citizensassemblies_tpu_torch.obs.slo import SloEngine

            self.slo = SloEngine(slo_spec)
        # --- load management (obs/slo.py SloLoadPolicy) -----------------------
        #: Config.serve_shed=True closes the SLO loop into an actuator:
        #: sustained fast-window burn turns on admission shedding (typed
        #: ShedRejection terminal events, counted graftserve_shed_total) and
        #: walks the service-level degradation ladder; recovery re-arms.
        #: Off (default) keeps the engine observe-only — pre-fleet behavior.
        self.load_policy = None
        if self.slo is not None and bool(getattr(self.cfg, "serve_shed", False)):
            from citizensassemblies_tpu_torch.obs.slo import SloLoadPolicy

            self.load_policy = SloLoadPolicy(self.slo, self.cfg)
        # --- the graph store (aot/) -------------------------------------------
        #: tri-state Config.aot_cache: None loads an artifact when one exists
        #: (missing → None, each shape's first solve captures), True fails
        #: HERE when the artifact is absent or mismatched, False never loads.
        #: submit() prewarms it on each tenant's first admission; _finish()
        #: stamps its counters on every audit.
        self.aot_store = None
        if getattr(self.cfg, "aot_cache", None) is not False:
            from citizensassemblies_tpu_torch.aot import boot

            self.aot_store = boot(self.cfg, device=self.device)
        self._prewarmed_tenants: set = set()
        self._prewarm_threads: List[threading.Thread] = []

    # --- public API ---------------------------------------------------------

    def submit(self, request: SelectionRequest) -> ResultChannel:
        """Admit one request; returns its streaming channel immediately."""
        # load management first (shutdown still dominates below): the policy
        # re-evaluates the fast window on EVERY submit, so a fully-shedding
        # service recovers by event aging alone — no terminal outcomes needed
        if self.load_policy is not None and not self._closed:
            self.load_policy.update()
            if self.load_policy.shedding:
                return self._shed(request)
        with self._lock:
            if self._closed:
                self.metrics.counter(
                    "graftserve_admission_rejected_total",
                    help="submissions refused by back-pressure",
                ).inc()
                raise AdmissionError("service is shut down")
            if self._in_flight >= self.queue_depth:
                self.metrics.counter(
                    "graftserve_admission_rejected_total",
                    help="submissions refused by back-pressure",
                ).inc()
                raise AdmissionError(
                    f"queue full: {self._in_flight} requests in flight "
                    f"(serve_queue_depth={self.queue_depth})"
                )
            self._in_flight += 1
        rid = request.request_id or _next_request_id()
        cfg = request.cfg or self.cfg
        channel = ResultChannel(
            rid, cap=int(getattr(cfg, "serve_channel_cap", 1024) or 1024)
        )
        with self._lock:
            self._channels[rid] = channel
        self._ensure_snapshot_loop()
        self._maybe_prewarm(request.tenant, cfg)
        # the submission timestamp rides into the worker so the sojourn
        # decomposition can attribute queue wait (worker pickup − submit)
        fut = self._pool.submit(
            self._run_request, request, rid, channel, time.monotonic()
        )
        with self._lock:
            self._futures[rid] = (fut, channel)
        return channel

    def run(self, request: SelectionRequest, timeout: Optional[float] = None):
        """Convenience: submit and block for the result."""
        return self.submit(request).result(timeout=timeout)

    def _maybe_prewarm(self, tenant: str, cfg: Config) -> None:
        """Prewarm on a tenant's FIRST admission: capture the store's
        recorded ``batch_lp.`` graphs off-thread, so the buckets the
        tenant's solves dispatch are captured before its request leaves the
        queue (entries boot already captured are skipped). Tri-state
        ``Config.aot_prewarm``: None and True warm whenever a store is
        installed, False never. The thread runs under
        ``utils/guards.shared_device`` like a worker; ``ExecStore.prewarm``
        counts a failed capture stale and goes on."""
        store = self.aot_store
        if store is None or getattr(cfg, "aot_prewarm", None) is False:
            return
        with self._lock:
            if tenant in self._prewarmed_tenants:
                return
            self._prewarmed_tenants.add(tenant)

        def warm():
            from citizensassemblies_tpu_torch.utils.guards import shared_device

            with shared_device(self.device):
                store.prewarm(families=("batch_lp.",), device=self.device)

        thread = threading.Thread(target=warm, name=f"graph-store-prewarm-{tenant}", daemon=True)
        with self._lock:
            self._prewarm_threads.append(thread)
        thread.start()

    def _shed(self, request: SelectionRequest) -> ResultChannel:
        """Typed load-shed rejection: the channel terminates immediately
        with ``("error", {"kind": "ShedRejection", "audit": …})`` — the
        audit stub records WHY (burn, threshold, rung, window) so a shed is
        evidence, not a bare refusal. Sheds never consume queue depth."""
        rid = request.request_id or _next_request_id()
        cfg = request.cfg or self.cfg
        channel = ResultChannel(
            rid, cap=int(getattr(cfg, "serve_channel_cap", 1024) or 1024)
        )
        stub = self.load_policy.shed(request.tenant, rid)
        self.metrics.counter(
            "graftserve_shed_total",
            help="submissions shed by the SLO load-management policy",
            labelnames=("tenant",),
        ).labels(tenant=request.tenant).inc()
        channel.push(
            "error",
            {
                "kind": "ShedRejection",
                "message": (
                    f"request {rid} shed: fast-window SLO burn "
                    f"{stub['worst_burn']:.2f} ≥ {stub['burn_threshold']:.2f}; "
                    "retry after recovery"
                ),
                "audit": stub,
            },
        )
        return channel

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "in_flight": self._in_flight,
                "completed": self._completed,
                "failed": self._failed,
                "memo_served": self._memo_served,
            }
        out["batcher"] = self.batcher.stats()
        out["tenants"] = self.tenants.all_stats()
        return out

    # --- observability --------------------------------------------------------

    def _ensure_snapshot_loop(self) -> None:
        """Start the periodic metrics-snapshot broadcaster lazily (first
        submission), when ``Config.obs_metrics_interval_s`` > 0. One daemon
        thread per service; every open ResultChannel receives a
        ``("metrics", snapshot)`` progress event per tick, so a streaming
        client sees queue depth / fusion ratio / eviction pressure evolve
        while its own request runs."""
        interval = float(getattr(self.cfg, "obs_metrics_interval_s", 0.0) or 0.0)
        if interval <= 0:
            return
        with self._lock:
            if self._snap_thread is not None:
                return
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop,
                args=(interval,),
                daemon=True,
                name="selection-service-metrics",
            )
            self._snap_thread.start()

    def _snapshot_loop(self, interval: float) -> None:
        while not self._snap_stop.wait(interval):
            snap = self.metrics_snapshot()
            with self._lock:
                channels = list(self._channels.values())
            for ch in channels:
                ch.push("metrics", snap)

    def _refresh_gauges(self) -> None:
        """Fold the service's derived state into the registry's gauges —
        called before every snapshot/render so scrapes are current."""
        st = self.stats()
        m = self.metrics
        m.gauge("graftserve_in_flight", help="admitted, unfinished requests").set(
            st["in_flight"]
        )
        m.gauge("graftserve_queue_depth", help="admission cap (config)").set(
            self.queue_depth
        )
        b = st["batcher"]
        m.gauge(
            "graftserve_batcher_fusion_ratio",
            help="fused dispatches / dispatches (cross-request batching)",
        ).set(
            round(b.get("fused_dispatches", 0) / max(b.get("dispatches", 0), 1), 4)
        )
        m.gauge(
            "graftserve_batcher_solves_per_dispatch",
            help="cross-request occupancy",
        ).set(round(b.get("solves", 0) / max(b.get("dispatches", 0), 1), 2))
        from citizensassemblies_tpu_torch.utils.memo import memo_evictions_by_owner

        for owner, n in memo_evictions_by_owner().items():
            m.gauge(
                "graftserve_tenant_evictions",
                help="LRU evictions attributed per owner",
                labelnames=("owner",),
            ).labels(owner=owner).set(n)
        # graph-store counters (cumulative process gauges): how much of the
        # service's dispatch rides graphs captured before it was needed
        if self.aot_store is not None:
            aot = self.aot_store.stamp()
            m.gauge(
                "aot_cache_hit", help="graph replays served by a stored capture",
            ).set(aot["hits"])
            m.gauge(
                "aot_cache_miss", help="graph signatures the store did not hold (captured)",
            ).set(aot["misses"])
            m.gauge(
                "aot_cache_stale", help="store entries invalidated at load or prewarm",
            ).set(aot["stale"])
            m.gauge(
                "aot_prewarmed", help="graphs captured by prewarming",
            ).set(aot["prewarmed"])
        # load-policy state (cumulative process gauges)
        if self.load_policy is not None:
            ps = self.load_policy.stamp()
            m.gauge(
                "graftserve_shed_active",
                help="1 while the load policy is shedding admissions",
            ).set(int(ps["shedding"]))
            m.gauge(
                "graftserve_degrade_rung",
                help="current service-level degradation-ladder rung",
            ).set(ps["rung"])
            m.gauge(
                "graftserve_shed_rearm_total",
                help="load-policy recovery re-arms (cumulative)",
            ).set(ps["rearm_total"])
            m.gauge(
                "graftserve_shed_burn_worst",
                help="worst fast-window SLO burn at last policy update",
            ).set(ps["worst_burn"])

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Structured fleet snapshot: the typed registry plus the raw
        service/batcher/tenant stats (the periodic channel event payload)."""
        self._refresh_gauges()
        snap = self.metrics.snapshot()
        snap["service"] = self.stats()
        if self.slo is not None:
            snap["slo"] = self.slo.evaluate()
        if self.load_policy is not None:
            snap["load_policy"] = self.load_policy.stamp()
        snap["ts"] = time.time()
        return snap

    def metrics_text(self) -> str:
        """Prometheus text exposition of the fleet registry — the scrape
        dump ``bench.py --serve`` writes next to its row."""
        self._refresh_gauges()
        return self.metrics.render_prometheus()

    def tracers(self) -> List[Any]:
        """The retained per-request tracers (obs_trace=True requests), the
        input of ``obs/roofline.roofline_join``."""
        with self._lock:
            return list(self._traces)

    def export_traces(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Merge the retained per-request tracers (obs_trace=True requests)
        into one Chrome trace document — each request a process lane."""
        from citizensassemblies_tpu_torch.obs.trace import export_chrome_trace

        with self._lock:
            tracers = list(self._traces)
        return export_chrome_trace(tracers, path=path)

    def shutdown(self, wait: bool = True) -> None:
        """Drain semantics: in-flight requests COMPLETE (their channels get
        a normal terminal event), queued-but-unstarted requests get a typed
        ``ServiceShutdown`` rejection, new submissions raise
        ``AdmissionError``, and the snapshot thread is joined — no service
        thread outlives the call (``tests/test_robust.py`` asserts via
        thread enumeration in the JAX package's tests)."""
        with self._lock:
            self._closed = True
        self._snap_stop.set()
        # cancel_futures rejects the queued tail; wait=True drains the
        # running requests to their terminal events first
        self._pool.shutdown(wait=wait, cancel_futures=True)
        with self._lock:
            cancelled = [
                (rid, ch)
                for rid, (fut, ch) in self._futures.items()
                if fut is not None and fut.cancelled()
            ]
            self._futures.clear()
        for rid, ch in cancelled:
            with self._lock:
                self._failed += 1
                self._in_flight -= 1
                self._channels.pop(rid, None)
            self.metrics.counter(
                "graftserve_shutdown_rejected_total",
                help="queued requests rejected by shutdown drain",
            ).inc()
            ch.push(
                "error",
                {
                    "kind": "ServiceShutdown",
                    "message": f"request {rid} cancelled before start: "
                    "service shut down",
                },
            )
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=5.0)
        with self._lock:
            warmers = list(self._prewarm_threads)
        for thread in warmers:
            thread.join(timeout=60.0)

    def __enter__(self) -> "SelectionService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)

    # --- the worker ---------------------------------------------------------

    def _featurize(self, request: SelectionRequest):
        if request.dense is not None:
            return request.dense, request.space
        from citizensassemblies_tpu_torch.core.instance import featurize

        return featurize(request.instance, device=self.device)

    def _slo_record(self, tenant: str, latency_s: float, ok: bool) -> None:
        """Feed one terminal outcome into the SLO engine and stream any
        breach TRANSITIONS into every open channel (steady-state breaching
        does not re-emit per request; recovery re-arms the transition)."""
        if self.slo is None:
            return
        self.slo.record(tenant, latency_s, ok)
        if self.load_policy is not None:
            self.load_policy.update()
        breaches = self.slo.new_breaches()
        if not breaches:
            return
        with self._lock:
            channels = list(self._channels.values())
        for breach in breaches:
            self.metrics.counter(
                "graftserve_slo_breach_total",
                help="SLO breach transitions per tenant and objective",
                labelnames=("tenant", "objective"),
            ).labels(
                tenant=breach["tenant"], objective=breach["objective"]
            ).inc()
            for ch in channels:
                ch.push("slo", breach)

    def _run_request(
        self,
        request: SelectionRequest,
        rid: str,
        channel: ResultChannel,
        t_submit: Optional[float] = None,
    ) -> None:
        from citizensassemblies_tpu_torch.utils.guards import shared_device

        # every torch call of the request outside its own launch windows
        # waits for other requests' windows to close (utils/guards.py)
        with shared_device(self.device):
            self._run_request_scoped(request, rid, channel, t_submit)

    def _run_request_scoped(
        self,
        request: SelectionRequest,
        rid: str,
        channel: ResultChannel,
        t_submit: Optional[float],
    ) -> None:
        import contextlib

        from citizensassemblies_tpu_torch.obs.memory import use_ledger
        from citizensassemblies_tpu_torch.robust.inject import (
            FaultInjected,
            FaultInjector,
        )
        from citizensassemblies_tpu_torch.robust.policy import (
            Deadline,
            DeadlineExceeded,
            DegradationLadder,
            RetryBudget,
        )
        from citizensassemblies_tpu_torch.utils.guards import CompilationGuard

        t0 = time.monotonic()  # worker pickup; queue wait = t0 - t_submit
        if t_submit is None:
            t_submit = t0
        base_cfg = request.cfg or self.cfg
        log = _ChannelLog(channel)
        # an armed load policy runs admitted requests under its
        # CURRENT ladder rungs (rung 0 ≡ unchanged — bit-identical when the
        # policy is idle); the per-request retry ladder below then degrades
        # further from that base on transient faults
        if self.load_policy is not None:
            base_cfg = self.load_policy.degraded(base_cfg, log)
        # --- per-request fault machinery (robust/) ---------------------------
        injector = None
        if getattr(base_cfg, "fault_sites", ""):
            import zlib

            # per-request schedule: derive from the request id so the fleet
            # doesn't fire identical faults in lockstep — still fully
            # deterministic given fault_seed + submission order
            injector = FaultInjector(
                base_cfg.fault_sites,
                seed=int(getattr(base_cfg, "fault_seed", 0))
                + zlib.crc32(rid.encode()),
            )
        dl_s = float(getattr(base_cfg, "serve_deadline_s", 0.0) or 0.0)
        deadline = Deadline(dl_s) if dl_s > 0 else None
        retry = RetryBudget(
            int(getattr(base_cfg, "serve_retry_max", 2)),
            float(getattr(base_cfg, "serve_retry_backoff_s", 0.05)),
        )
        ladder = DegradationLadder()
        cfg = base_cfg
        ctx: Optional[RequestContext] = None
        success = False
        try:
            if injector is not None and injector.fire("queue_stall"):
                # chaos: artificial stall before execution — the deadline
                # accounting (and graceful rejection) must absorb it
                log.count("fault_queue_stall")
                time.sleep(0.25 if dl_s <= 0 else min(0.25, dl_s))
            # per-request tracing: obs_trace=True is the opt-in sampling
            # mode — every request gets its OWN Tracer (disjoint traces by
            # construction), installed ambiently by use_context below and
            # carried on the log so worker threads (anchor pricer, batcher
            # leader) attribute to the owning request
            tracer = None
            if getattr(base_cfg, "obs_trace", None) is True:
                from citizensassemblies_tpu_torch.obs.trace import Tracer

                tracer = Tracer(name=rid, sample_device=True)
                log.tracer = tracer
            # obs_memory=True gives the request its own memory ledger —
            # dispatch hooks snapshot at span boundaries while it is
            # ambient, and the audit stamp carries the summary block
            ledger = None
            if getattr(base_cfg, "obs_memory", None) is True:
                from citizensassemblies_tpu_torch.obs.memory import MemoryLedger

                ledger = MemoryLedger(name=rid, device=self.device)
                ledger.snapshot("request_start")
            session = self.tenants.session(request.tenant)
            dense, space = self._featurize(request)
            fp = self._fingerprint(request, dense, base_cfg)
            memo_hit = session.memo_get((request.algorithm, fp))
            if memo_hit is not None:
                ctx = self._build_context(
                    request, rid, cfg, log, session, tracer, deadline, retry,
                    injector,
                )
                success = True
                with self._lock:
                    self._memo_served += 1
                    self._completed += 1
                    self._in_flight -= 1
                channel.push("progress", f"request {rid}: served from tenant memo")
                t_memo = time.monotonic()
                payload = self._finish(
                    request, rid, memo_hit, t0, ctx, compiles=0,
                    from_memo=True, sojourn=(t_submit, t_memo, t_memo),
                    ledger=ledger,
                )
                self._slo_record(
                    request.tenant, time.monotonic() - t_submit, ok=True
                )
                channel.push("result", payload)
                return
            # --- transient-fault retry loop (robust/policy) ----------------
            # each retry backs off exponentially and walks ONE rung down the
            # certified degradation ladder; the deadline bounds the whole
            # loop (a retry that cannot fit its backoff rejects gracefully)
            t_exec0 = time.monotonic()  # sojourn: the solve window opens
            while True:
                ctx = self._build_context(
                    request, rid, cfg, log, session, tracer, deadline, retry,
                    injector,
                )
                try:
                    if deadline is not None:
                        deadline.check("request start", log=log)
                    # single-use context managers — rebuilt every retry
                    mem_scope = (
                        use_ledger(ledger)
                        if ledger is not None
                        else contextlib.nullcontext()
                    )
                    with use_context(ctx), mem_scope:
                        with CompilationGuard(name=f"serve_{rid}", log=log) as guard:
                            if tracer is not None:
                                with tracer.span(
                                    "request", algorithm=request.algorithm,
                                    tenant=request.tenant,
                                ):
                                    result = self._execute(
                                        request, dense, space, ctx, fp
                                    )
                            else:
                                result = self._execute(request, dense, space, ctx, fp)
                    break
                except FaultInjected as exc:
                    delay = retry.take()
                    if delay is None:
                        raise  # budget exhausted: the fault is the outcome
                    # roll back the failed attempt's request-scoped writes
                    # before retrying (half-written warm state must not
                    # seed the retry), then degrade one rung
                    ctx.teardown(success=False)
                    log.count("robust_retry")
                    cfg = ladder.degrade(cfg, log)
                    log.emit(
                        f"request {rid}: transient fault "
                        f"({exc.site}); retry {retry.used}/{retry.attempts} "
                        f"after {delay * 1000:.0f}ms"
                        + (
                            f", degraded to {ladder.steps[-1]}"
                            if ladder.steps else ""
                        )
                    )
                    if deadline is not None and deadline.remaining() <= delay:
                        deadline.check("retry backoff", log=log)
                    time.sleep(delay)
            t_exec1 = time.monotonic()  # sojourn: the solve window closes
            session.memo_put((request.algorithm, fp), result)
            session.finish_request(rid)
            success = True
            payload = self._finish(
                request, rid, result, t0, ctx, compiles=guard.count,
                sojourn=(t_submit, t_exec0, t_exec1), ledger=ledger,
            )
            if tracer is not None:
                with self._lock:
                    self._traces.append(tracer)
                    del self._traces[:-64]  # bounded retention, newest kept
            self.metrics.counter(
                "graftserve_requests_total",
                help="finished requests per tenant and algorithm",
                labelnames=("tenant", "algorithm"),
            ).labels(tenant=request.tenant, algorithm=request.algorithm).inc()
            self.metrics.histogram(
                "graftserve_request_seconds",
                help="request sojourn time (submit to result)",
            ).observe(time.monotonic() - t0)
            with self._lock:
                self._completed += 1
                self._in_flight -= 1
            # SLO before the terminal event so a breach this request caused
            # is visible on its own channel too (events stop at terminal)
            self._slo_record(
                request.tenant, time.monotonic() - t_submit, ok=True
            )
            channel.push("result", payload)
        except DeadlineExceeded as exc:
            # graceful rejection: a typed terminal event carrying a PARTIAL
            # audit stamp (elapsed, counters, best-so-far evidence from the
            # raising layer) instead of a hang or a bare timeout
            self.metrics.counter(
                "graftserve_deadline_total",
                help="requests rejected by their deadline, per tenant",
                labelnames=("tenant",),
            ).labels(tenant=request.tenant).inc()
            with self._lock:
                self._failed += 1
                self._in_flight -= 1
            self._slo_record(
                request.tenant, time.monotonic() - t_submit, ok=False
            )
            channel.push(
                "error",
                {
                    "kind": "DeadlineExceeded",
                    "message": str(exc),
                    "audit": {
                        "request_id": rid,
                        "tenant": request.tenant,
                        "algorithm": request.algorithm,
                        "deadline_s": dl_s,
                        "elapsed_s": round(time.monotonic() - t0, 3),
                        "degrade_steps": list(ladder.steps),
                        "retries_used": retry.used,
                        "counters": log.counters,
                        **exc.partial,
                    },
                },
            )
        except BaseException as exc:
            self.metrics.counter(
                "graftserve_failed_total", help="failed requests per tenant",
                labelnames=("tenant",),
            ).labels(tenant=request.tenant).inc()
            with self._lock:
                self._failed += 1
                self._in_flight -= 1
            self._slo_record(
                request.tenant, time.monotonic() - t_submit, ok=False
            )
            channel.push("error", f"{type(exc).__name__}: {exc}")
        finally:
            if ctx is not None:
                # non-success exits roll back the request's warm slots and
                # session pack writes (satellite: no half-written tenant
                # state on any failure path)
                ctx.teardown(success=success)
            with self._lock:
                self._channels.pop(rid, None)
                self._futures.pop(rid, None)

    def _build_context(
        self, request, rid, cfg, log, session, tracer, deadline, retry,
        injector,
    ) -> RequestContext:
        return RequestContext(
            cfg=cfg,
            log=log,
            request_id=rid,
            tenant=request.tenant,
            warm_store=session.warm_store_for(rid),
            session=session,
            batcher=self.batcher,
            tracer=tracer,
            deadline=deadline,
            retry=retry,
            injector=injector,
        )

    def _fingerprint(self, request: SelectionRequest, dense, cfg: Config) -> str:
        from citizensassemblies_tpu_torch.utils.checkpoint import problem_fingerprint

        fp = problem_fingerprint(dense, cfg, request.households)
        if request.algorithm == "legacy":
            fp = f"{fp}:{request.iterations}:{request.seed}"
        elif request.algorithm == "dropout":
            # the no-show vector is part of the problem identity: two
            # requests on the same instance with different dropout profiles
            # must not share a memo slot
            import zlib

            d = np.ascontiguousarray(
                np.asarray(request.dropout, dtype=np.float64)
                if request.dropout is not None
                else np.zeros(0)
            )
            fp = f"{fp}:drop{zlib.crc32(d.tobytes()) & 0xFFFFFFFF:08x}"
        elif request.algorithm == "multi":
            fp = f"{fp}:R{request.rounds if request.rounds is not None else cfg.scenario_rounds}"
        return fp

    def _execute(self, request: SelectionRequest, dense, space, ctx, fp: str):
        """Run the request's algorithm with the context installed."""
        from citizensassemblies_tpu_torch.robust import inject

        # chaos: a worker crash at execution start is the canonical
        # transient fault — the retry loop above absorbs it
        inject.raise_if("worker_crash", ctx.log)
        algo = request.algorithm
        if algo == "legacy":
            from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities

            return legacy_probabilities(
                dense, iterations=request.iterations, seed=request.seed,
                cfg=ctx.cfg, households=request.households, device=self.device,
            )
        if algo == "leximin":
            from citizensassemblies_tpu_torch.models.leximin import (
                find_distribution_leximin,
            )

            if request.revise is not None:
                return self._serve_revise(request, dense, space, ctx, fp)
            return find_distribution_leximin(
                dense, space, cfg=ctx.cfg, households=request.households,
                log=ctx.log, device=self.device,
            )
        if algo == "xmin":
            from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin

            # session win: an XMIN request whose LEXIMIN seed was already
            # solved for the SAME problem (fingerprint match) reuses it —
            # the expansion + L2 stage is all that runs
            seed_dist = None
            if ctx.session is not None:
                seed_dist = ctx.session.memo_get(("leximin", fp))
                if seed_dist is not None:
                    ctx.log.emit(
                        "XMIN: reusing the tenant session's LEXIMIN seed "
                        "(fingerprint match)."
                    )
            return find_distribution_xmin(
                dense, space, cfg=ctx.cfg, households=request.households,
                log=ctx.log, leximin=seed_dist, device=self.device,
            )
        if algo == "dropout":
            from citizensassemblies_tpu_torch.scenarios import find_distribution_dropout

            if request.dropout is None:
                raise ValueError(
                    "algorithm 'dropout' requires request.dropout "
                    "(per-agent no-show probabilities)"
                )
            return find_distribution_dropout(
                dense, space, dropout=request.dropout, cfg=ctx.cfg,
                households=request.households, log=ctx.log, device=self.device,
            )
        if algo == "multi":
            from citizensassemblies_tpu_torch.scenarios import find_distribution_multi

            return find_distribution_multi(
                dense, space, rounds=request.rounds, cfg=ctx.cfg,
                households=request.households, log=ctx.log, device=self.device,
            )
        raise ValueError(
            f"unknown algorithm {algo!r} (legacy|leximin|xmin|dropout|multi)"
        )

    def _serve_revise(self, request: SelectionRequest, dense, space, ctx, fp: str):
        """Serve a ``revise`` request by delta re-certification where it can.

        Decision ladder:

        * ``Config.delta_solve=False`` — hard off: run the plain leximin
          path, BIT-IDENTICAL to a request without ``revise`` (pinned by
          test), never touching the delta store;
        * spec inconsistent with the request instance (the edited registry's
          content fingerprint must equal the request's) — from-scratch,
          WITHOUT priming: a wrong spec must never seed future deltas;
        * cold session / edit above ``delta_max_edit_frac`` / household
          quotient — from-scratch answer (``delta_fallback``), then prime
          the delta store with a base certificate so the NEXT edit on this
          instance re-certifies warm;
        * warm — ``recertify`` (cache hit / resume / screened full ladder),
          project the certificate onto the request's reduction, realize the
          panel portfolio, stamp ``delta_cert`` on the audit, store the
          successor state under the post-edit fingerprint.

        Every fallback is the exact from-scratch solver — a delta answer is
        only ever served under a verified certificate.
        """
        from citizensassemblies_tpu_torch.data.registry import apply_edit
        from citizensassemblies_tpu_torch.models.leximin import (
            find_distribution_leximin,
            realize_typespace,
        )
        from citizensassemblies_tpu_torch.solvers import delta as delta_solver
        from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
        from citizensassemblies_tpu_torch.utils.checkpoint import problem_fingerprint

        cfg, log, spec = ctx.cfg, ctx.log, request.revise
        gate = getattr(cfg, "delta_solve", None)

        def from_scratch():
            return find_distribution_leximin(
                dense, space, cfg=cfg, households=request.households,
                log=log, device=self.device,
            )

        if gate is False:
            return from_scratch()

        # fingerprints are computed with the REQUEST's config (the one the
        # memo/delta stores key by), not a retry-degraded ctx.cfg
        cfg0 = request.cfg or self.cfg

        # consistency: the edited registry must BE the request instance —
        # an inconsistent spec can never be served delta results (and never
        # primes the store either)
        try:
            reg_after = apply_edit(spec.reg_before, spec.edit)
            # the fingerprint reads host arrays only
            dense_after, _ = reg_after.to_dense(device="cpu")
            fp_after = problem_fingerprint(
                dense_after, cfg0, request.households
            )
        except Exception as exc:
            log.count("delta_fallback")
            log.emit(f"delta re-certification: invalid revise spec ({exc}); from-scratch.")
            return from_scratch()
        if fp_after != fp:
            log.count("delta_fallback")
            log.emit(
                "delta re-certification: revise spec inconsistent with the request "
                "instance (fingerprint mismatch); from-scratch."
            )
            return from_scratch()

        def fallback(reason: str):
            log.count("delta_fallback")
            if gate is True:
                # delta_solve=True is the LOUD mode: every fallback explains
                # itself in the request log (None falls back silently)
                log.emit(f"delta re-certification: {reason}; serving from-scratch.")
            result = from_scratch()
            # prime the store so the NEXT edit re-certifies warm (consistent
            # spec only — certify_base returns None outside the enumerable
            # delta envelope)
            if ctx.session is not None:
                state = delta_solver.certify_base(
                    reg_after, cfg=cfg, log=log, fingerprint=fp, device=self.device,
                )
                if state is not None:
                    ctx.session.delta_put(
                        fp, state, request_id=ctx.request_id
                    )
            return result

        if request.households is not None:
            # the delta certificate lives in plain type space; the household
            # quotient augments the instance, so it takes the exact path
            return fallback("household quotient not on the delta path")
        base_fp = spec.base_fingerprint
        if not base_fp:
            dense_before, _ = spec.reg_before.to_dense(device="cpu")
            base_fp = problem_fingerprint(
                dense_before, cfg0, request.households
            )
        frac = float(getattr(cfg, "delta_max_edit_frac", 0.05))
        if int(spec.edit.magnitude) > max(1.0, frac * dense.n):
            return fallback(
                f"edit magnitude {spec.edit.magnitude} above "
                f"delta_max_edit_frac ({frac:g} of n={dense.n})"
            )
        state = None
        if ctx.session is not None:
            state = ctx.session.delta_get(base_fp)
        if state is None:
            return fallback("no base certificate in the tenant session")

        outcome = delta_solver.recertify(
            state, spec.edit, spec.reg_before, cfg=cfg, log=log,
            fingerprint=fp, device=self.device,
        )
        if outcome is None:
            return fallback("edit left the delta envelope")
        reduction = TypeReduction(dense)
        ts = delta_solver.project_to_reduction(outcome.state, reduction)
        if ts is None:
            return fallback("certificate does not project onto the instance")
        result = realize_typespace(
            dense, reduction, ts, cfg, log, households=None, enumerated=True,
        )
        result.delta_cert = outcome.cert
        if ctx.session is not None:
            ctx.session.delta_put(
                fp, outcome.state, request_id=ctx.request_id
            )
        return result

    def _finish(
        self,
        request: SelectionRequest,
        rid: str,
        result,
        t0: float,
        ctx: RequestContext,
        compiles: int,
        from_memo: bool = False,
        sojourn: Optional[Tuple[float, float, float]] = None,
        ledger=None,
    ) -> RequestResult:
        """Assemble the terminal payload + per-request audit stamp."""
        from citizensassemblies_tpu_torch.utils.memo import memo_evictions_by_owner

        seconds = time.monotonic() - t0
        allocation = np.asarray(result.allocation)
        counters = ctx.log.counters
        audit: Dict[str, Any] = {
            "request_id": rid,
            "tenant": request.tenant,
            "algorithm": request.algorithm,
            "seconds": round(seconds, 4),
            "from_memo": from_memo,
            "xla_compiles": int(compiles),
            # host↔device round-trip gauge of the decomposition rounds
            # (ROADMAP item 2's measurement prerequisite) — 0 when the
            # request never entered the face loop
            "decomp_host_syncs": int(counters.get("decomp_host_syncs", 0)),
            "counters": counters,
            "timers": {k: round(v, 4) for k, v in ctx.log.timers.items()},
        }
        # exactness stamp: the solver-carried realization deviation and its
        # 1e-3 L∞ contract verdict (legacy is a Monte-Carlo estimate — it
        # carries a draw count instead of a certificate)
        if hasattr(result, "realization_dev"):
            audit["realization_dev"] = float(result.realization_dev)
            audit["contract_ok"] = bool(result.contract_ok)
        if hasattr(result, "draws_attempted"):
            audit["draws_attempted"] = int(result.draws_attempted)
        # scenario models (scenarios/) carry their own audit block — bucket
        # counts, fallback reasons, MC realization stamps, pair gauges
        if hasattr(result, "scenario_audit"):
            audit["scenario"] = dict(result.scenario_audit)
        # how an incremental re-certification obtained this
        # answer (cache_hit | resume | full_ladder) with its screen stats,
        # drift and ε bound — the served certificate, auditable per request
        if hasattr(result, "delta_cert"):
            audit["delta_cert"] = dict(result.delta_cert)
        if ctx.session is not None:
            audit["session"] = ctx.session.stats()
            audit["tenant_memo_evictions"] = memo_evictions_by_owner().get(
                ctx.session.owner, 0
            )
        # fault evidence: retries taken, deadline headroom, and (chaos
        # runs) the injector's deterministic fire schedule — every recovery
        # counter (sentinel_*, robust_*, fault_*) is already in "counters"
        if ctx.retry is not None and ctx.retry.used:
            audit["retries_used"] = int(ctx.retry.used)
        if ctx.deadline is not None:
            audit["deadline_remaining_s"] = round(ctx.deadline.remaining(), 3)
        if ctx.injector is not None:
            audit["faults"] = ctx.injector.stats()
        if ctx.tracer is not None:
            from citizensassemblies_tpu_torch.obs.trace import TRACE_SCHEMA_VERSION

            audit["obs"] = {
                "span_count": ctx.tracer.span_count,
                "dropped_spans": ctx.tracer.dropped,
                "schema_version": TRACE_SCHEMA_VERSION,
            }
        # sojourn decomposition, from MEASURED boundaries:
        # submit → worker pickup (queue wait) → solve window opens
        # (prepare: featurize, fingerprint, memo probe) → solve window
        # closes → audit assembly. The four components partition the
        # sojourn exactly; batch_window (the cross-request fusion wait,
        # from the batcher's timer) is a sub-component of the solve window.
        if sojourn is not None:
            t_submit, t_x0, t_x1 = sojourn
            now = time.monotonic()
            batch_window = float(ctx.log.timers.get("batch_window", 0.0))
            solve = max(t_x1 - t_x0, 0.0)
            audit["sojourn"] = {
                "total_s": round(max(now - t_submit, 0.0), 4),
                "queue_wait_s": round(max(t0 - t_submit, 0.0), 4),
                "prepare_s": round(max(t_x0 - t0, 0.0), 4),
                "solve_s": round(solve, 4),
                "batch_window_s": round(min(batch_window, solve), 4),
                "audit_s": round(max(now - t_x1, 0.0), 4),
            }
        # the graph store's serving counters
        if self.aot_store is not None:
            audit["aot"] = self.aot_store.stamp()
        # the memory ledger: the request's device-memory summary
        if ledger is not None:
            ledger.snapshot("request_end")
            audit["memory"] = ledger.stamp()
        return RequestResult(
            request_id=rid,
            tenant=request.tenant,
            algorithm=request.algorithm,
            allocation=allocation,
            result=result,
            audit=audit,
            seconds=seconds,
            from_memo=from_memo,
        )
