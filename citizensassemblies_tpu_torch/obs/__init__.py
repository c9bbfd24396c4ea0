"""Observability of the port: spans, typed metrics, memory, SLOs.

The JAX package's ``obs`` layer, kept as the port's own modules (the port
imports nothing of the JAX package):

* ``obs.trace`` — nested span tracer, ambient through a ``ContextVar`` and
  carried by the service's per-request ``RequestContext``; Chrome
  trace-event export and its schema check;
* ``obs.metrics`` — typed metrics registry (Counter/Gauge/Timer/Histogram
  with label sets) behind ``RunLog.count``/``gauge``/``timer``, the
  Prometheus renderer and ``format_timers``/``format_counters``;
* ``obs.hooks`` — ``dispatch_span``, the span around each hot dispatch,
  tri-stated by ``Config.obs_trace`` (its sampling mode waits on a CUDA
  event);
* ``obs.memory`` — the per-phase device-memory ledger over the CUDA caching
  allocator and the LRU registry, tri-stated by ``Config.obs_memory``;
* ``obs.slo`` — the SLO engine (``Config.obs_slo_spec``) with multi-window
  burn rates, breach transitions and the load policy;
* ``obs.catalog`` — the metric-series catalogue;
* ``obs.roofline`` — the join of dispatch spans to the work they did (cost
  functions the port owns, at the card's peaks and ridge);
* ``obs.trend`` — the trend gate over a series of bench records (a
  stdlib copy of the JAX package's);
* ``python -m citizensassemblies_tpu_torch.obs`` — the offline trace CLI
  (critical path, self times, fusion timeline, ``--diff``).
"""

from citizensassemblies_tpu_torch.obs.catalog import (
    METRIC_PREFIXES,
    METRIC_SERIES,
    is_registered,
)
from citizensassemblies_tpu_torch.obs.hooks import DispatchScope, dispatch_span
from citizensassemblies_tpu_torch.obs.memory import (
    MemoryLedger,
    ambient_ledger,
    leak_verdict,
    owner_attribution,
    use_ledger,
)
from citizensassemblies_tpu_torch.obs.metrics import (
    MetricsRegistry,
    format_counters,
    format_timers,
)
from citizensassemblies_tpu_torch.obs.roofline import (
    ROOFLINE_SCHEMA_VERSION,
    RooflineReport,
    RooflineRow,
    dispatch_totals,
    roofline_join,
)
from citizensassemblies_tpu_torch.obs.slo import SloEngine, SloLoadPolicy, parse_slo_spec
from citizensassemblies_tpu_torch.obs.trace import (
    TRACE_SCHEMA_VERSION,
    DeviceValue,
    Span,
    Tracer,
    begin_span,
    current_tracer,
    end_span,
    export_chrome_trace,
    span,
    span_coverage,
    use_tracer,
    validate_chrome_trace,
)
from citizensassemblies_tpu_torch.obs.trend import TrendReport, TrendRow, collect_series, trend_gate

__all__ = [
    "DispatchScope",
    "dispatch_span",
    "MetricsRegistry",
    "format_counters",
    "format_timers",
    "TRACE_SCHEMA_VERSION",
    "Span",
    "Tracer",
    "begin_span",
    "current_tracer",
    "end_span",
    "export_chrome_trace",
    "span",
    "span_coverage",
    "use_tracer",
    "validate_chrome_trace",
    "METRIC_PREFIXES",
    "METRIC_SERIES",
    "is_registered",
    "MemoryLedger",
    "ambient_ledger",
    "leak_verdict",
    "owner_attribution",
    "use_ledger",
    "SloEngine",
    "SloLoadPolicy",
    "parse_slo_spec",
    "DeviceValue",
    "ROOFLINE_SCHEMA_VERSION",
    "RooflineReport",
    "RooflineRow",
    "dispatch_totals",
    "roofline_join",
    "TrendReport",
    "TrendRow",
    "collect_series",
    "trend_gate",
]
