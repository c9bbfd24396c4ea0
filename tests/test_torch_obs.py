"""The port's obs layer against the JAX package's.

The 18 cases of ``tests/test_obs.py`` at ``:69-263``, ``:357-414``,
``:502-551``, ``:684`` and ``:729``, each given to both packages where the
case has a counterpart there: span names, nesting and attributes equal
(timestamps not compared), Prometheus text and metric snapshots equal
exactly, SLO reports and breach streams equal exactly. The memory ledger
reads the CUDA caching allocator, so on the CPU its byte counts are zeros
with ``measured`` False (the JAX package reads live CPU arrays there); its
series, stamp keys, leak verdicts and owner attribution are held. The
trace CLI gives the JAX CLI's analysis on the same document
(``tests/test_obs.py:597``), the profiling re-exports are the port's
renderers, and ``profiler_trace`` writes a Chrome trace naming an
``annotate`` range. The roofline join and the trend gate are held in
``tests/test_torch_roofline.py``.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from citizensassemblies_tpu import obs as jobs
from citizensassemblies_tpu.core.generator import random_instance as j_random_instance
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.obs.slo import SloEngine as JSloEngine
from citizensassemblies_tpu.obs.slo import parse_slo_spec as j_parse_slo_spec
from citizensassemblies_tpu.service import SelectionRequest as JRequest
from citizensassemblies_tpu.service import SelectionService as JService
from citizensassemblies_tpu.service.context import RequestContext as JContext
from citizensassemblies_tpu.service.context import use_context as j_use_context
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog
from citizensassemblies_tpu.utils.memo import LRU as JLRU

from citizensassemblies_tpu_torch import obs
from citizensassemblies_tpu_torch.core.generator import random_instance
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.obs import (
    TRACE_SCHEMA_VERSION,
    MemoryLedger,
    MetricsRegistry,
    Tracer,
    ambient_ledger,
    dispatch_span,
    export_chrome_trace,
    leak_verdict,
    owner_attribution,
    span_coverage,
    use_ledger,
    use_tracer,
    validate_chrome_trace,
)
from citizensassemblies_tpu_torch.obs.slo import SloEngine, parse_slo_spec
from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService
from citizensassemblies_tpu_torch.service.context import RequestContext, use_context
from citizensassemblies_tpu_torch.service.server import ResultChannel
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog
from citizensassemblies_tpu_torch.utils.memo import LRU

torch.set_num_threads(1)


def _tree(tracer):
    """A tracer's spans as (name, parent name, attrs without timing) in
    record order: what both packages must agree on."""
    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    return [
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id else None, dict(s.attrs))
        for s in spans
    ]


def _x_events(doc):
    return sorted(
        (e["name"], e["pid"], e["args"].get("span_id"), e["args"].get("parent_id"))
        for e in doc["traceEvents"] if e["ph"] == "X"
    )


# --- span tracer -----------------------------------------------------------------


def _nested_run(pkg_tracer, pkg_use_tracer):
    tr = pkg_tracer(name="t")
    with pkg_use_tracer(tr):
        with tr.span("root"):
            with tr.span("child_a", phase=1):
                time.sleep(0.01)
            with tr.span("child_b"):
                with tr.span("grandchild"):
                    time.sleep(0.01)
    return tr


def test_span_nesting_schema_and_coverage():
    tr = _nested_run(Tracer, use_tracer)
    jtr = _nested_run(jobs.Tracer, jobs.use_tracer)
    assert _tree(tr) == _tree(jtr)
    spans = {s.name: s for s in tr.spans()}
    for child, parent in (("child_a", "root"), ("child_b", "root"), ("grandchild", "child_b")):
        assert spans[child].parent_id == spans[parent].span_id
        assert spans[child].t0 >= spans[parent].t0
        assert spans[child].t1 <= spans[parent].t1
    assert span_coverage(tr, "root") > 0.9
    doc = export_chrome_trace([tr])
    jdoc = jobs.export_chrome_trace([jtr])
    assert validate_chrome_trace(doc) == [] and jobs.validate_chrome_trace(doc) == []
    assert doc["schema_version"] == TRACE_SCHEMA_VERSION == jobs.TRACE_SCHEMA_VERSION
    assert _x_events(doc) == _x_events(jdoc)
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} == {
        "root", "child_a", "child_b", "grandchild",
    }


def test_trace_schema_validation_catches_corruption():
    tr = Tracer(name="t")
    with tr.span("only"):
        pass
    doc = export_chrome_trace([tr])
    assert validate_chrome_trace(doc) == []
    bad = json.loads(json.dumps(doc))
    bad["traceEvents"].append({"ph": "X", "pid": 1, "tid": 1, "name": ""})
    bad["traceEvents"].append({"ph": "Q", "pid": 1, "tid": 1, "name": "x"})
    bad["schema_version"] = 999
    problems = validate_chrome_trace(bad)
    assert problems == jobs.validate_chrome_trace(bad)
    assert len(problems) >= 3
    assert validate_chrome_trace("not a dict") == ["document is not an object"]


def test_dispatch_span_inert_without_tracer_and_records_with():
    def run(pkg, cfg):
        with pkg.dispatch_span("core.test", cfg=cfg) as ds:
            ds.out = 123
        tr = pkg.Tracer(name="t")
        with pkg.use_tracer(tr):
            with pkg.dispatch_span("core.test", cfg=cfg, bucket="8x8") as ds:
                ds.out = None
            with pkg.dispatch_span("core.off", cfg=cfg.replace(obs_trace=False)) as ds:
                ds.out = None
        return tr

    tr, jtr = run(obs, default_config()), run(jobs, jcfg())
    assert [s.name for s in tr.spans()] == ["core.test"]
    assert tr.spans()[0].attrs["bucket"] == "8x8"
    assert _tree(tr) == _tree(jtr)


def test_runlog_timer_records_spans_only_when_traced():
    def run(log_cls, tracer_cls):
        log = log_cls(echo=False)
        with log.timer("quiet"):
            pass
        tr = tracer_cls(name="t")
        log.tracer = tr
        with tr.span("root"):
            with log.timer("phase_x"):
                time.sleep(0.005)
        return log, tr

    log, tr = run(RunLog, Tracer)
    jlog, jtr = run(JLog, jobs.Tracer)
    spans = {s.name: s for s in tr.spans()}
    assert "quiet" not in spans
    assert spans["phase_x"].parent_id == spans["root"].span_id
    assert set(log.timers) == set(jlog.timers) == {"quiet", "phase_x"}
    assert _tree(tr) == _tree(jtr)


def _isolated_requests(ctx_cls, use_ctx, log_cls, tracer_cls, span_fn, cfg):
    tracers = {}
    barrier = threading.Barrier(2, timeout=10)
    errors = []

    def request(rid):
        try:
            log = log_cls(echo=False)
            tracer = tracer_cls(name=rid)
            log.tracer = tracer
            tracers[rid] = tracer
            ctx = ctx_cls.create(cfg=cfg, log=log, request_id=rid, tenant=rid, tracer=tracer)
            with use_ctx(ctx):
                with tracer.span(f"request_{rid}"):
                    for i in range(5):
                        barrier.wait()
                        with log.timer(f"phase_{i}"):
                            with span_fn(f"core_{rid}", cfg=cfg) as ds:
                                ds.out = None
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=request, args=(r,)) for r in ("A", "B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    return tracers


def test_concurrent_request_trace_isolation():
    tracers = _isolated_requests(
        RequestContext, use_context, RunLog, Tracer, dispatch_span, default_config()
    )
    jtracers = _isolated_requests(
        JContext, j_use_context, JLog, jobs.Tracer, jobs.dispatch_span, jcfg()
    )
    for rid in ("A", "B"):
        other = "B" if rid == "A" else "A"
        spans = tracers[rid].spans()
        names = {s.name for s in spans}
        assert f"core_{other}" not in names and f"request_{other}" not in names
        assert f"core_{rid}" in names
        root = next(s for s in spans if s.name == f"request_{rid}")
        assert all(s.t1 is not None for s in spans)
        for s in spans:
            if s.name.startswith("phase_"):
                assert s.parent_id == root.span_id
        assert _tree(tracers[rid]) == _tree(jtracers[rid])


def test_obs_off_bitwise_identity_tiny_leximin():
    inst = random_instance(n=48, k=6, n_categories=2, seed=3)
    dense, space = featurize(inst, device="cpu")
    cfg_off = default_config().replace(obs_trace=False)
    d_off = find_distribution_leximin(dense, space, cfg=cfg_off, device="cpu")
    tr = Tracer(name="on", sample_device=True)
    log = RunLog(echo=False)
    log.tracer = tr
    with use_tracer(tr):
        d_on = find_distribution_leximin(
            dense, space, cfg=default_config().replace(obs_trace=True), log=log, device="cpu"
        )
    assert np.array_equal(d_off.allocation, d_on.allocation)
    assert np.array_equal(d_off.fixed_probabilities, d_on.fixed_probabilities)
    assert tr.span_count > 0
    led = MemoryLedger(name="off_probe", attribute_owners=False)
    with use_ledger(led):
        d_mem_off = find_distribution_leximin(
            dense, space, cfg=cfg_off.replace(obs_memory=False), device="cpu"
        )
    assert led.records == []
    assert np.array_equal(d_off.allocation, d_mem_off.allocation)
    assert np.array_equal(d_off.fixed_probabilities, d_mem_off.fixed_probabilities)
    # the same pool through the JAX package: the allocations agree within
    # the contract, the phase spans of both runs share their names
    jd, js = j_featurize(j_random_instance(n=48, k=6, n_categories=2, seed=3))
    jtr = jobs.Tracer(name="on", sample_device=True)
    jlog = JLog(echo=False)
    jlog.tracer = jtr
    with jobs.use_tracer(jtr):
        j_on = j_leximin(jd, js, cfg=jcfg().replace(obs_trace=True), log=jlog)
    assert float(np.abs(d_on.allocation - np.asarray(j_on.allocation)).max()) <= 1e-3
    phases = {s.name for s in tr.spans() if s.attrs.get("kind") != "dispatch"}
    jphases = {s.name for s in jtr.spans() if s.attrs.get("kind") != "dispatch"}
    assert phases == set(log.timers) and jphases == set(jlog.timers)
    assert phases == jphases


# --- metrics registry --------------------------------------------------------------


def test_runlog_registry_bitcompat():
    def run(log):
        log.count("hits")
        log.count("hits", 4)
        log.gauge("fill_pct", 37)
        log.gauge("hits", 10)
        log.count("hits")
        with log.timer("t"):
            pass
        with log.timer("t"):
            pass
        return log

    log, jlog = run(RunLog(echo=False)), run(JLog(echo=False))
    counters = log.counters
    assert counters == jlog.counters == {"hits": 11, "fill_pct": 37}
    assert set(log.timers) == set(jlog.timers) == {"t"}
    counters["hits"] = -1
    log.timers["t"] = -1.0
    assert log.counters["hits"] == 11
    assert log.timers["t"] >= 0.0


def test_registry_label_cardinality_cap():
    def run(reg):
        c = reg.counter("req_total", labelnames=("tenant",))
        for i in range(10):
            c.labels(tenant=f"t{i}").inc()
        first = reg.flat_counters()
        c.labels(tenant="t0").inc()
        return first, reg.flat_counters(), reg.label_overflow

    first, after, overflow = run(MetricsRegistry(max_label_sets=3))
    assert (first, after, overflow) == run(jobs.MetricsRegistry(max_label_sets=3))
    assert first['req_total{overflow="true"}'] == 7
    assert sum(1 for k in first if k.startswith("req_total")) == 4
    assert overflow == 7
    assert after['req_total{tenant="t0"}'] == 2


def test_registry_prometheus_render_and_snapshot():
    def run(reg):
        reg.counter("jobs_total", help="done jobs", labelnames=("tenant",)).labels(
            tenant="a"
        ).inc(3)
        reg.gauge("depth").set(7)
        reg.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
        reg.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(5.0)
        reg.timer("phase").observe(0.25)
        return reg.render_prometheus(), reg.snapshot()

    (text, snap), (jtext, jsnap) = run(MetricsRegistry()), run(jobs.MetricsRegistry())
    assert text == jtext
    assert snap == jsnap
    assert "# TYPE jobs_total counter" in text
    assert 'jobs_total{tenant="a"} 3' in text
    assert "depth 7" in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_count 2" in text
    assert "phase_seconds_total" in text
    assert snap["counters"]['jobs_total{tenant="a"}'] == 3
    assert snap["gauges"]["depth"] == 7
    assert snap["histograms"]["lat_seconds"]["count"] == 2
    assert obs.format_timers({"a": 2.0, "b": 1.0}) == jobs.format_timers({"a": 2.0, "b": 1.0})
    assert obs.format_counters({"a": 2, "b": 5}) == jobs.format_counters({"a": 2, "b": 5})


def test_catalog_registers_every_series_the_port_emits():
    """Every literal ``count``/``gauge``/``timer`` name in the port's
    sources is a catalogued series or a registered family (the check the
    JAX package's lint rule R11 makes), and the JAX package's catalogue is
    a part of the port's."""
    import pathlib
    import re

    from citizensassemblies_tpu.obs import catalog as jcatalog

    from citizensassemblies_tpu_torch.obs import catalog

    root = pathlib.Path(catalog.__file__).resolve().parents[1]
    names = {
        m.group(1)
        for path in root.rglob("*.py")
        for m in re.finditer(r"\.(?:count|gauge|timer)\(\s*\"([a-z0-9_]+)\"", path.read_text())
    }
    assert len(names) > 50
    assert sorted(n for n in names if not catalog.is_registered(n)) == []
    assert set(jcatalog.METRIC_SERIES) <= set(catalog.METRIC_SERIES)
    assert jcatalog.METRIC_PREFIXES == catalog.METRIC_PREFIXES


# --- memory ledger -------------------------------------------------------------------


def test_memory_ledger_snapshots_series_and_stamp():
    led = MemoryLedger(name="unit", attribute_owners=False)
    base = led.snapshot("baseline")
    assert base["live_bytes"] >= 0 and base["live_arrays"] >= 0
    held = []
    for i in range(3):
        held.append(torch.zeros(4096 * (i + 1), dtype=torch.float32))
        led.snapshot("warm_rep")
    led.snapshot("teardown")
    series = led.series("warm_rep")
    assert len(series) == 3
    assert len(led.series()) == 5
    assert series[-1] >= series[0]
    assert led.high_watermark_bytes >= max(series)
    stamp = led.stamp()
    jstamp = jobs.MemoryLedger(name="unit", attribute_owners=False)
    jstamp.snapshot("baseline")
    # the JAX package's stamp keys, plus whether the device was measured
    assert set(stamp) == set(jstamp.stamp()) | {"measured"}
    assert stamp["schema_version"] == 1
    assert stamp["snapshots"] == 5
    assert stamp["ledger"] == "unit"
    assert stamp["live_bytes_last"] == led.records[-1]["live_bytes"]
    assert "owners" not in stamp
    # on the CPU the allocator is not read: zeros, and the stamp says so
    assert stamp["measured"] is False and series == [0, 0, 0]
    del held


def test_leak_verdict_requires_strict_monotonic_growth():
    cases = ([100, 200, 300], [100, 200, 300, 400], [100, 200, 200], [100, 300, 200], [], [100, 200])
    assert [leak_verdict(c) for c in cases] == [jobs.leak_verdict(c) for c in cases]
    assert [leak_verdict(c) for c in cases] == [True, True, False, False, False, False]


def test_dispatch_span_snapshots_ambient_ledger_and_hard_off_is_inert():
    def run(pkg, cfg):
        led = pkg.MemoryLedger(name="span_probe", attribute_owners=False)
        with pkg.use_ledger(led):
            assert pkg.ambient_ledger() is led
            with pkg.dispatch_span("core.mem", cfg=cfg) as ds:
                ds.out = None
            phases = [[r["phase"] for r in led.records]]
            with pkg.dispatch_span("core.off", cfg=cfg.replace(obs_memory=False)) as ds:
                ds.out = None
            phases.append([r["phase"] for r in led.records])
            tr = pkg.Tracer(name="t")
            with pkg.use_tracer(tr):
                with pkg.dispatch_span("core.traced", cfg=cfg) as ds:
                    ds.out = None
            phases.append([r["phase"] for r in led.records])
        assert pkg.ambient_ledger() is None
        return phases

    phases = run(obs, default_config())
    assert phases == run(jobs, jcfg())
    assert phases == [["core.mem"], ["core.mem"], ["core.mem", "core.traced"]]
    assert ambient_ledger() is None


def test_owner_attribution_walks_the_lru_registry():
    def run(lru_cls, attribution, ledger_cls, make):
        cache = lru_cls(4, name="unit_cache")
        cache.put("a", make(128), owner="tenant:alpha")
        cache.put("b", make(64))
        owners = attribution()
        stamp = ledger_cls(name="o").stamp()
        return owners, stamp, cache

    for make in (lambda k: np.zeros(k, dtype=np.float64), lambda k: torch.zeros(k, dtype=torch.float64)):
        owners, stamp, cache = run(LRU, owner_attribution, MemoryLedger, make)
        assert owners.get("tenant:alpha", 0) >= 128 * 8
        assert owners.get("unit_cache", 0) >= 64 * 8
        assert stamp["owners"].get("tenant:alpha", 0) >= 128 * 8
        del cache
    jowners, jstamp, jcache = run(
        JLRU, jobs.owner_attribution, jobs.MemoryLedger, lambda k: np.zeros(k, dtype=np.float64)
    )
    assert jowners.get("tenant:alpha", 0) >= 128 * 8 and jowners.get("unit_cache", 0) >= 64 * 8
    del jcache


# --- SLO engine -------------------------------------------------------------------------


def test_parse_slo_spec_grammar_and_errors():
    text = "latency_p99:20s, error_rate:0.01, civic/latency_p99:150ms"
    spec = parse_slo_spec(text)
    assert spec == j_parse_slo_spec(text)
    assert spec[None] == {"latency_p99": 20.0, "error_rate": 0.01}
    assert spec["civic"] == {"latency_p99": 0.15}
    assert parse_slo_spec("") == {}
    assert parse_slo_spec("latency_p50:2.5")[None] == {"latency_p50": 2.5}
    for bad in ("latency_p99", "throughput:5"):
        with pytest.raises(ValueError):
            parse_slo_spec(bad)
        with pytest.raises(ValueError):
            j_parse_slo_spec(bad)


def _slo_drill(engine_cls):
    now = [0.0]
    eng = engine_cls("latency_p99:1s,error_rate:0.25", clock=lambda: now[0])
    out = []
    for _ in range(8):
        eng.record("civic", 0.01, ok=True)
    out += [eng.evaluate(), eng.new_breaches()]
    for _ in range(8):
        eng.record("civic", 0.01, ok=False)
    out += [eng.evaluate(), eng.new_breaches(), eng.new_breaches()]
    now[0] += 3601.0
    for _ in range(4):
        eng.record("civic", 0.01, ok=True)
    out += [eng.evaluate(), eng.new_breaches()]
    for _ in range(4):
        eng.record("civic", 0.01, ok=False)
    out += [eng.new_breaches(), eng.window_burns(60.0)]
    return out


def test_slo_engine_burn_rates_breach_transitions_and_recovery():
    out = _slo_drill(SloEngine)
    assert out == _slo_drill(JSloEngine)
    report, fresh0, report2, fresh, again, report3, recovered, rearmed, _burns = out
    civic = report["tenants"]["civic"]
    assert report["slo_ok"] is True and report["events"] == 8
    assert civic["latency_p99"]["observed"] == 0.01
    assert civic["error_rate"]["burn_rates"]["60s"] == 0.0
    assert report["spec"]["*"]["error_rate"] == 0.25
    assert fresh0 == []
    civic = report2["tenants"]["civic"]
    assert civic["error_rate"]["observed"] == 0.5
    assert civic["error_rate"]["ok"] is False
    assert civic["error_rate"]["burn_rates"]["60s"] == 2.0
    assert [b["objective"] for b in fresh] == ["error_rate"]
    assert again == []
    assert report3["slo_ok"] is True and recovered == []
    assert [b["objective"] for b in rearmed] == ["error_rate"]


def test_slo_tenant_override_applies_only_to_that_tenant():
    def run(engine_cls):
        now = [0.0]
        eng = engine_cls("latency_p99:10s,civic/latency_p99:100ms", clock=lambda: now[0])
        for _ in range(5):
            eng.record("civic", 0.5, ok=True)
            eng.record("other", 0.5, ok=True)
        return eng.evaluate()

    report = run(SloEngine)
    assert report == run(JSloEngine)
    assert report["tenants"]["civic"]["latency_p99"]["target"] == 0.1
    assert report["tenants"]["civic"]["latency_p99"]["ok"] is False
    assert report["tenants"]["other"]["latency_p99"]["ok"] is True
    assert [(b["tenant"], b["objective"]) for b in report["breaches"]] == [("civic", "latency_p99")]


# --- the service's SLO and metrics streams -----------------------------------------------


def _stall_drill(service, request, cfg, instance_of):
    svc = service(cfg)
    try:
        chans = [
            svc.submit(request(instance=instance_of(s), tenant="civic")) for s in range(2)
        ]
        results = [ch.result(timeout=300) for ch in chans]
        breaches = [p for ch in chans for kind, p in ch.events(timeout=1) if kind == "slo"]
        return results, breaches, svc.slo.evaluate(), svc.metrics_text()
    finally:
        svc.shutdown()


def test_service_streams_slo_breach_events_on_queue_stall():
    """A certain ``queue_stall`` fault pushes every sojourn over a 50 ms p99
    target: the engine breaches and the service streams the transition into
    the open channels, in both packages, and the served allocations agree."""
    kw = dict(
        obs_slo_spec="latency_p99:50ms,error_rate:0.9", fault_sites="queue_stall:1.0",
        fault_seed=11, obs_metrics_interval_s=0.0,
    )
    results, breaches, report, text = _stall_drill(
        lambda c: SelectionService(c, device="cpu"), SelectionRequest,
        default_config().replace(**kw),
        lambda s: random_instance(n=40, k=5, n_categories=2, seed=s),
    )
    jresults, jbreaches, jreport, jtext = _stall_drill(
        JService, JRequest, jcfg().replace(aot_cache=False, **kw),
        lambda s: j_random_instance(n=40, k=5, n_categories=2, seed=s),
    )
    assert len(results) == 2
    assert breaches, "no ('slo', …) breach event reached an open channel"
    assert breaches[0]["tenant"] == "civic"
    assert breaches[0]["objective"] == "latency_p99"
    assert breaches[0]["observed"] > breaches[0]["target"]
    assert [(b["tenant"], b["objective"], b["target"]) for b in breaches] == [
        (b["tenant"], b["objective"], b["target"]) for b in jbreaches
    ]
    assert report["slo_ok"] is False and report["events"] == 2
    assert jreport["slo_ok"] is False and jreport["events"] == 2
    assert "graftserve_slo_breach_total" in text and "graftserve_slo_breach_total" in jtext
    for r in results:
        assert r.audit["counters"]["fault_queue_stall"] == 1
    for r, jr in zip(results, jresults):
        assert float(np.abs(r.allocation - np.asarray(jr.allocation)).max()) <= 1e-3


def _metrics_stream(service, request, cfg, instance_of, channel_cls):
    svc = service(cfg)
    try:
        chans = [
            svc.submit(request(instance=instance_of(s), tenant=f"t{s % 2}")) for s in range(3)
        ]
        probe = channel_cls("probe")
        with svc._lock:
            svc._channels["probe"] = probe
        snaps = []
        deadline = time.time() + 10
        while not snaps and time.time() < deadline:
            time.sleep(0.02)
            with probe._cond:
                snaps = [p for k, p in probe._events if k == "metrics"]
        with svc._lock:
            svc._channels.pop("probe", None)
        results = [ch.result(timeout=300) for ch in chans]
        return snaps, results, svc.export_traces(), svc.metrics_text()
    finally:
        svc.shutdown()


def test_service_metrics_stream_and_prometheus(monkeypatch):
    # the eviction gauges render every owner the process ever evicted: an
    # earlier test of the worker (the fused L2 cores' LRU in
    # test_torch_qp.py) would add a family the other package never saw, so
    # both start from no eviction, as each does in a process of its own
    from citizensassemblies_tpu.utils import memo as jmemo

    from citizensassemblies_tpu_torch.utils import memo as tmemo

    monkeypatch.setattr(jmemo, "_EVICTIONS_BY_OWNER", {})
    monkeypatch.setattr(tmemo, "_EVICTIONS_BY_OWNER", {})
    kw = dict(obs_trace=True, obs_metrics_interval_s=0.02, serve_admission_cap=2)
    snaps, results, doc, text = _metrics_stream(
        lambda c: SelectionService(c, device="cpu"), SelectionRequest,
        default_config().replace(**kw),
        lambda s: random_instance(n=40, k=5, n_categories=2, seed=s), ResultChannel,
    )
    from citizensassemblies_tpu.service.server import ResultChannel as JChannel

    jsnaps, jresults, jdoc, jtext = _metrics_stream(
        JService, JRequest, jcfg().replace(aot_cache=False, **kw),
        lambda s: j_random_instance(n=40, k=5, n_categories=2, seed=s), JChannel,
    )
    assert snaps, "no periodic metrics snapshot reached the open channel"
    assert "service" in snaps[0] and "gauges" in snaps[0]
    assert set(snaps[0]) == set(jsnaps[0])
    assert all(r.audit.get("obs", {}).get("span_count", 0) > 0 for r in results)
    assert validate_chrome_trace(doc) == []
    assert len(doc["otherData"]["tracers"]) == 3
    for name in ("graftserve_requests_total", "graftserve_batcher_fusion_ratio"):
        assert name in text and name in jtext
    # the same series families, as the JAX package renders them
    families = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
    jfamilies = {ln.split()[2] for ln in jtext.splitlines() if ln.startswith("# TYPE")}
    assert families == jfamilies
    for r, jr in zip(results, jresults):
        assert float(np.abs(r.allocation - np.asarray(jr.allocation)).max()) <= 1e-3


# --- the trace CLI and profiling ---------------------------------------------------


def _write_trace(tmp_path, name: str, scale: float = 1.0) -> str:
    """The two-lane synthetic Chrome trace of ``tests/test_obs.py``."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "req_A"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "req_B"}},
    ]

    def span(pid, sid, parent, nm, ts, dur):
        ev.append({
            "ph": "X", "pid": pid, "tid": 1, "name": nm, "ts": ts, "dur": dur,
            "args": {"span_id": sid, "parent_id": parent},
        })

    span(1, 1, None, "request", 0.0, 1000.0 * scale)
    span(1, 2, 1, "solve", 100.0, 800.0 * scale)
    span(1, 3, 2, "pdhg", 200.0, 500.0 * scale)
    span(1, 4, 1, "batch_window", 0.0, 90.0)
    span(2, 5, None, "request", 10.0, 400.0)
    span(2, 6, 5, "batch_window", 20.0, 80.0)
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_cli_equals_jax(tmp_path, capsys):
    from citizensassemblies_tpu.obs import __main__ as jcli

    from citizensassemblies_tpu_torch.obs import __main__ as cli

    a = _write_trace(tmp_path, "a.json", scale=1.0)
    b = _write_trace(tmp_path, "b.json", scale=2.0)
    report = cli.analyze(a)
    assert report == jcli.analyze(a)
    assert [h["name"] for h in report["critical_path"]] == ["request", "solve", "pdhg"]
    assert report["self_times"]["request"]["self_ms"] == pytest.approx(0.43)
    (cluster,) = report["fusion_timeline"]
    assert cluster["fused"] is True and cluster["requests"] == ["req_A", "req_B"]
    d = cli.diff(a, b)
    assert d == jcli.diff(a, b) and d["phases"]["pdhg"]["ratio"] == pytest.approx(2.0)
    for argv in ([a, "--json"], [a, "--diff", b, "--json"], [a]):
        assert cli.main(argv) == 0
        mine = capsys.readouterr().out
        assert jcli.main(argv) == 0
        assert mine == capsys.readouterr().out


def test_trace_cli_reads_the_ports_export(tmp_path):
    """The CLI on a trace the port's service exports: spans nest, and a
    deferred device value (the iterations of a fused solve) exports as a
    number list."""
    from citizensassemblies_tpu_torch.obs import __main__ as cli
    from citizensassemblies_tpu_torch.obs.trace import DeviceValue

    tr = Tracer(name="req")
    with use_tracer(tr):
        with obs.trace.span("request"):
            with dispatch_span("lp_pdhg.pdhg_core", nv=4, m1=2, m2=1, check_every=8) as ds:
                ds.note(iters=DeviceValue(torch.tensor([16], dtype=torch.int32)))
    path = tmp_path / "port.json"
    doc = export_chrome_trace([tr], path=str(path))
    assert validate_chrome_trace(doc) == []
    (ev,) = [e for e in doc["traceEvents"] if e.get("name") == "lp_pdhg.pdhg_core"]
    assert ev["args"]["iters"] == [16]
    report = cli.analyze(str(path))
    assert [h["name"] for h in report["critical_path"]] == ["request", "lp_pdhg.pdhg_core"]


def test_profiling_reexports_and_profiler_trace(tmp_path):
    from citizensassemblies_tpu_torch.obs.metrics import format_counters as fc
    from citizensassemblies_tpu_torch.utils import profiling

    assert profiling.format_counters is fc
    assert profiling.format_timers({"a": 2.0, "b": 1.0}).startswith("phase times: a 2.00s")
    with profiling.profiler_trace(None) as prof:
        assert prof is None  # off: nothing profiled, nothing written
    assert list(tmp_path.iterdir()) == []
    with profiling.profiler_trace(str(tmp_path)) as prof:
        with profiling.annotate("graph_store_probe"):
            torch.ones(64).sum()
    written = list(tmp_path.iterdir())
    assert len(written) == 1 and str(written[0]) == prof.trace_path
    trace = json.loads(written[0].read_text())
    assert any(e.get("name") == "graph_store_probe" for e in trace["traceEvents"])
