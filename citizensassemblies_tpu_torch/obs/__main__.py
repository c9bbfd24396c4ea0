"""Trace CLI: offline analysis of exported Chrome traces.

``python -m citizensassemblies_tpu_torch.obs <trace.json> [--diff B]
[--json]`` reads the trace documents the port exports
(``obs/trace.export_chrome_trace``, ``SelectionService.export_traces``)
and answers the questions a trace viewer makes you eyeball:

* **critical path** — from the heaviest root span, descend into the
  largest child at every level: the chain of spans that bounds the run's
  wall time, with each hop's share of its parent;
* **self time** — per span-name aggregation of exclusive time (duration
  minus the union of child intervals): where the time actually went, not
  which phase happened to be on the stack;
* **fusion timeline** — the cross-request batcher view: overlapping
  ``batch_window`` spans from different request lanes (pids) are the
  windows in which requests actually fused into one dispatch;
* ``--diff A B`` — phase-by-phase self-time comparison of two traces: the
  trend gate says *that* a row regressed, the diff says *which phase* grew.

A stdlib-only copy of the JAX package's ``obs/__main__.py`` (the same
analysis on the same document, held by ``tests/test_torch_obs.py``), so it
runs anywhere against a saved trace. ``--json`` emits the full analysis as
one machine-readable document.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple


def _load_spans(path: str) -> Tuple[List[dict], Dict[int, str]]:
    """(spans, pid→lane-name) from one exported trace document. Spans keep
    the export's µs clock: ``{pid, tid, name, ts, dur, span_id, parent_id}``."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    lanes: Dict[int, str] = {}
    spans: List[dict] = []
    for ev in events:
        if not isinstance(ev, dict):
            continue
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            lanes[ev.get("pid", 0)] = ev.get("args", {}).get("name", "?")
        elif ev.get("ph") == "X":
            args = ev.get("args", {}) or {}
            spans.append(
                {
                    "pid": ev.get("pid", 0),
                    "tid": ev.get("tid", 0),
                    "name": ev.get("name", "?"),
                    "ts": float(ev.get("ts", 0.0)),
                    "dur": float(ev.get("dur", 0.0)),
                    "span_id": args.get("span_id"),
                    "parent_id": args.get("parent_id"),
                }
            )
    return spans, lanes


def _children_index(spans: List[dict]) -> Dict[Tuple[int, Any], List[dict]]:
    """``(pid, parent span_id) → children`` — span ids are per-tracer, so
    the pid is part of the key."""
    index: Dict[Tuple[int, Any], List[dict]] = {}
    for sp in spans:
        if sp["parent_id"] is not None:
            index.setdefault((sp["pid"], sp["parent_id"]), []).append(sp)
    return index


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    lo, hi = intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo)


def critical_path(spans: List[dict]) -> List[dict]:
    """Heaviest-descent chain from the longest root span: at each node,
    follow the child with the largest duration. Each hop carries its share
    of the parent; the residual (parent minus heaviest child) is that
    level's self + sibling time."""
    roots = [s for s in spans if s["parent_id"] is None]
    if not roots:
        return []
    index = _children_index(spans)
    node = max(roots, key=lambda s: s["dur"])
    path = []
    parent_dur: Optional[float] = None
    while node is not None:
        path.append(
            {
                "name": node["name"],
                "pid": node["pid"],
                "dur_ms": node["dur"] / 1e3,
                "of_parent": (
                    node["dur"] / parent_dur if parent_dur else 1.0
                ),
            }
        )
        parent_dur = node["dur"] or None
        kids = index.get((node["pid"], node["span_id"]), [])
        node = max(kids, key=lambda s: s["dur"]) if kids else None
    return path


def self_times(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    """Per-name aggregation: count, total duration, exclusive (self) time
    in milliseconds."""
    index = _children_index(spans)
    out: Dict[str, Dict[str, float]] = {}
    for sp in spans:
        kids = index.get((sp["pid"], sp["span_id"]), [])
        covered = _union_us(
            [
                (
                    max(k["ts"], sp["ts"]),
                    min(k["ts"] + k["dur"], sp["ts"] + sp["dur"]),
                )
                for k in kids
                if k["ts"] + k["dur"] > sp["ts"] and k["ts"] < sp["ts"] + sp["dur"]
            ]
        )
        agg = out.setdefault(sp["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += sp["dur"] / 1e3
        agg["self_ms"] += max(sp["dur"] - covered, 0.0) / 1e3
    for agg in out.values():
        agg["total_ms"] = round(agg["total_ms"], 3)
        agg["self_ms"] = round(agg["self_ms"], 3)
    return out


def fusion_timeline(
    spans: List[dict], lanes: Dict[int, str], window_name: str = "batch_window"
) -> List[dict]:
    """Clusters of overlapping ``batch_window`` spans across request lanes.
    A cluster spanning ≥ 2 pids is a window in which the cross-request
    batcher actually fused work; single-lane clusters are windows that
    closed alone (the fusion-miss diagnostic)."""
    windows = sorted(
        (s for s in spans if s["name"] == window_name), key=lambda s: s["ts"]
    )
    clusters: List[dict] = []
    for sp in windows:
        end = sp["ts"] + sp["dur"]
        if clusters and sp["ts"] <= clusters[-1]["_end"]:
            cl = clusters[-1]
            cl["_end"] = max(cl["_end"], end)
            cl["lanes"].add(sp["pid"])
            cl["spans"] += 1
        else:
            clusters.append(
                {"_start": sp["ts"], "_end": end, "lanes": {sp["pid"]}, "spans": 1}
            )
    out = []
    for cl in clusters:
        out.append(
            {
                "start_ms": round(cl["_start"] / 1e3, 3),
                "dur_ms": round((cl["_end"] - cl["_start"]) / 1e3, 3),
                "spans": cl["spans"],
                "requests": sorted(lanes.get(p, str(p)) for p in cl["lanes"]),
                "fused": len(cl["lanes"]) >= 2,
            }
        )
    return out


def analyze(path: str) -> Dict[str, Any]:
    spans, lanes = _load_spans(path)
    return {
        "trace": path,
        "spans": len(spans),
        "lanes": len(lanes),
        "critical_path": critical_path(spans),
        "self_times": self_times(spans),
        "fusion_timeline": fusion_timeline(spans, lanes),
    }


def diff(path_a: str, path_b: str) -> Dict[str, Any]:
    """Phase-by-phase self-time comparison (B relative to A)."""
    a = self_times(_load_spans(path_a)[0])
    b = self_times(_load_spans(path_b)[0])
    rows = {}
    for name in sorted(set(a) | set(b)):
        sa = a.get(name, {}).get("self_ms", 0.0)
        sb = b.get(name, {}).get("self_ms", 0.0)
        rows[name] = {
            "a_self_ms": sa,
            "b_self_ms": sb,
            "delta_ms": round(sb - sa, 3),
            "ratio": round(sb / sa, 3) if sa > 0 else None,
        }
    return {"a": path_a, "b": path_b, "phases": rows}


def _print_report(report: Dict[str, Any], limit: int) -> None:
    print(f"trace: {report['trace']}  ({report['spans']} spans, "
          f"{report['lanes']} lanes)")
    print("\ncritical path (heaviest descent):")
    for i, hop in enumerate(report["critical_path"]):
        share = f"{hop['of_parent'] * 100.0:5.1f}%"
        print(f"  {'  ' * i}{hop['name']}  {hop['dur_ms']:.3f} ms  ({share} of parent)")
    ranked = sorted(
        report["self_times"].items(), key=lambda kv: kv[1]["self_ms"], reverse=True
    )
    print(f"\nself time by phase (top {limit}):")
    print(f"  {'phase':40s} {'count':>6s} {'total ms':>10s} {'self ms':>10s}")
    for name, agg in ranked[:limit]:
        print(
            f"  {name:40s} {agg['count']:6d} {agg['total_ms']:10.3f} "
            f"{agg['self_ms']:10.3f}"
        )
    fusion = report["fusion_timeline"]
    if fusion:
        fused = sum(1 for f in fusion if f["fused"])
        print(f"\nbatcher windows: {len(fusion)} ({fused} fused ≥2 requests)")
        for f in fusion:
            tag = "FUSED" if f["fused"] else "alone"
            print(
                f"  +{f['start_ms']:.1f} ms  {f['dur_ms']:.1f} ms  {tag}  "
                f"{', '.join(f['requests'])}"
            )


def _print_diff(report: Dict[str, Any], limit: int) -> None:
    print(f"diff: {report['a']}  →  {report['b']}  (self time per phase)")
    rows = sorted(
        report["phases"].items(),
        key=lambda kv: abs(kv[1]["delta_ms"]),
        reverse=True,
    )
    print(f"  {'phase':40s} {'A ms':>10s} {'B ms':>10s} {'Δ ms':>10s} {'ratio':>7s}")
    for name, row in rows[:limit]:
        ratio = f"{row['ratio']:.2f}" if row["ratio"] is not None else "new"
        print(
            f"  {name:40s} {row['a_self_ms']:10.3f} {row['b_self_ms']:10.3f} "
            f"{row['delta_ms']:+10.3f} {ratio:>7s}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m citizensassemblies_tpu_torch.obs",
        description="offline analyzer for exported grafttrace Chrome traces",
    )
    parser.add_argument("trace", help="trace JSON (export_chrome_trace output)")
    parser.add_argument(
        "--diff", metavar="OTHER", default=None,
        help="compare TRACE against OTHER phase-by-phase (self time)",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON")
    parser.add_argument("--limit", type=int, default=20, help="table row cap")
    ns = parser.parse_args(argv)
    if ns.diff is not None:
        report = diff(ns.trace, ns.diff)
        if ns.json:
            print(json.dumps(report, indent=1))
        else:
            _print_diff(report, ns.limit)
    else:
        report = analyze(ns.trace)
        if ns.json:
            print(json.dumps(report, indent=1))
        else:
            _print_report(report, ns.limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
