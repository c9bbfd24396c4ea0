"""Trend gating: per-row deltas over a committed series of bench records.

The stdlib-only copy of the JAX package's ``obs/trend.py``: the same
loaders, the same gate and the same report schema, so both give the same
verdicts on the same files (``tests/test_torch_roofline.py`` holds that on
the committed ``BENCH_*.json`` files and on synthetic fixtures). Point it at
the port's own records: a directory of the port's bench artifacts, in the
file families below, measured on the card. The committed ``BENCH_*.json``
files at the repository root are the JAX package's TPU and CPU rounds; for
the port they are a parity fixture only and say nothing about its speed.

For every named row whose ``seconds`` appears in ≥ 2 rounds, the latest
value is compared against the best (minimum) of the earlier rounds, and a
ratio beyond the tolerance fails.

Robust parsing, because bench artifacts are heterogeneous:

* ``BENCH_r*.json`` are run wrappers ``{"n", "cmd", "rc", "tail",
  "parsed"}`` where ``parsed`` may be ``null`` and ``tail`` is a truncated
  window of the bench's output — rows are recovered by regex over whichever
  source is available (``"<row>": {"seconds": X``);
* ``BENCH_serve_r*.json`` are raw result lines ``{"metric", "value",
  "detail": {...}}`` — the serve wall-clock and latency quantiles become
  synthetic rows (``serve_wall_s``, ``serve_p50_s``, ``serve_p99_s``);
* ``BENCH_detail_r*.json`` (complete per-round results, when committed)
  parse directly.

Gate semantics (deliberately regression-only — improvements never fail):

* rows with a single data point are recorded as ``insufficient`` and never
  gate (a brand-new row family must land once before it is protected);
* rows whose latest value is under ``min_seconds`` never gate — sub-second
  rows are dispatch-floor noise;
* a row fails when ``latest > tol × min(previous rounds)``. The default
  tolerance is ``Config.obs_trend_tol``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: ``"row_name": {"seconds": 12.3`` anywhere in a (possibly truncated) JSON
#: fragment — the recovery parser for wrapper tails with ``parsed: null``
_ROW_RE = re.compile(r'"([A-Za-z0-9_]+)"\s*:\s*\{\s*"seconds"\s*:\s*([0-9.]+)')

_OFFLINE_RE = re.compile(r"BENCH_r(\d+)\.json$")
_DETAIL_RE = re.compile(r"BENCH_detail_r(\d+)\.json$")
_SERVE_RE = re.compile(r"BENCH_serve_r(\d+)\.json$")
_KERNELS_RE = re.compile(r"BENCH_kernels_r(\d+)\.json$")
_ROOFLINE_RE = re.compile(r"ROOFLINE_r(\d+)\.json$")
_CHURN_RE = re.compile(r"BENCH_churn_r(\d+)\.json$")
_COLDBOOT_RE = re.compile(r"BENCH_coldboot_r(\d+)\.json$")
_FLEET_RE = re.compile(r"BENCH_fleet_r(\d+)\.json$")


@dataclasses.dataclass
class TrendRow:
    """One row's trajectory and verdict."""

    name: str
    points: List[Tuple[int, float]]  # (round, seconds), round-ascending
    status: str  # "ok" | "regression" | "insufficient" | "floor"
    latest: Optional[float] = None
    best_prior: Optional[float] = None
    ratio: Optional[float] = None


@dataclasses.dataclass
class TrendReport:
    rows: List[TrendRow]
    tol: float
    min_seconds: float
    rounds_seen: List[int]

    @property
    def failures(self) -> List[TrendRow]:
        return [r for r in self.rows if r.status == "regression"]

    @property
    def ok(self) -> bool:
        return not self.failures

    def as_json(self) -> dict:
        return {
            "trend_ok": self.ok,
            "tol": self.tol,
            "min_seconds": self.min_seconds,
            "rounds_seen": self.rounds_seen,
            "schema_version": 1,
            "rows": [
                {
                    "name": r.name,
                    "status": r.status,
                    "points": [[rd, v] for rd, v in r.points],
                    "latest": r.latest,
                    "best_prior": r.best_prior,
                    "ratio": r.ratio,
                }
                for r in self.rows
            ],
            "failures": [r.name for r in self.failures],
        }


def _rows_from_text(text: str) -> Dict[str, float]:
    """Regex row recovery over an arbitrary (possibly truncated) fragment.
    Last occurrence wins, matching JSON's duplicate-key behavior."""
    out: Dict[str, float] = {}
    for m in _ROW_RE.finditer(text):
        out[m.group(1)] = float(m.group(2))
    return out


def _load_offline(path: Path) -> Dict[str, float]:
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict):
        return {}
    if isinstance(doc.get("detail"), dict):  # a BENCH_detail/raw result file
        return _rows_from_text(json.dumps(doc["detail"]))
    parsed = doc.get("parsed")
    if isinstance(parsed, dict):
        return _rows_from_text(json.dumps(parsed.get("detail", parsed)))
    tail = doc.get("tail")
    if isinstance(tail, str):
        return _rows_from_text(tail)
    return {}


def _load_serve(path: Path) -> Dict[str, float]:
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict):
        return {}
    if "tail" in doc and not isinstance(doc.get("parsed"), dict):
        # wrapped serve row: recover what the window kept
        text = doc["tail"] if isinstance(doc.get("tail"), str) else ""
        rows = {}
        m = re.search(r'"p50_latency_s"\s*:\s*([0-9.]+)', text)
        if m:
            rows["serve_p50_s"] = float(m.group(1))
        m = re.search(r'"p99_latency_s"\s*:\s*([0-9.]+)', text)
        if m:
            rows["serve_p99_s"] = float(m.group(1))
        return rows
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    detail = doc.get("detail", {}) if isinstance(doc.get("detail"), dict) else {}
    rows: Dict[str, float] = {}
    if isinstance(doc.get("value"), (int, float)):
        rows["serve_wall_s"] = float(doc["value"])
    for src, dst in (
        ("p50_latency_s", "serve_p50_s"),
        ("p99_latency_s", "serve_p99_s"),
    ):
        if isinstance(detail.get(src), (int, float)):
            rows[dst] = float(detail[src])
    return rows


def collect_series(root) -> Tuple[Dict[str, List[Tuple[int, float]]], List[int]]:
    """Scan ``root`` for the committed BENCH artifacts and assemble
    per-row ``[(round, seconds), …]`` series (round-ascending). A
    ``BENCH_detail_rNN.json`` supersedes the run wrapper of the same
    round (it is the complete, untruncated result)."""
    root = Path(root)
    by_round: Dict[int, Dict[str, float]] = {}
    detail_rounds: set = set()
    for path in sorted(root.glob("BENCH_detail_r*.json")):
        m = _DETAIL_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                rnd = int(m.group(1))
                by_round.setdefault(rnd, {}).update(rows)
                detail_rounds.add(rnd)
    for path in sorted(root.glob("BENCH_r*.json")):
        m = _OFFLINE_RE.search(path.name)
        if m and int(m.group(1)) not in detail_rounds:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("BENCH_serve_r*.json")):
        m = _SERVE_RE.search(path.name)
        if m:
            rows = _load_serve(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("BENCH_kernels_r*.json")):
        # kernel microbench family (bench.py --kernels): same
        # {"detail": {row: {"seconds": …}}} schema as the detail files
        m = _KERNELS_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("ROOFLINE_r*.json")):
        # graftscope roofline family (bench.py --roofline): per-core
        # dispatch seconds under {"detail": {"roofline_<core>": …}}
        m = _ROOFLINE_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("BENCH_churn_r*.json")):
        # graftdelta churn family (bench.py --churn): per-edit-class delta
        # medians + the sampled from-scratch arm, same detail schema
        m = _CHURN_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("BENCH_coldboot_r*.json")):
        # graftboot coldboot family (bench.py --coldboot): fresh-process
        # boot-to-first-certified-result wall clock, cached vs uncached
        m = _COLDBOOT_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    for path in sorted(root.glob("BENCH_fleet_r*.json")):
        # graftfleet family (bench.py --fleet): open-loop fleet drive /
        # serial-reference / whole-harness wall clocks, same detail schema
        m = _FLEET_RE.search(path.name)
        if m:
            rows = _load_offline(path)
            if rows:
                by_round.setdefault(int(m.group(1)), {}).update(rows)
    series: Dict[str, List[Tuple[int, float]]] = {}
    for rnd in sorted(by_round):
        for name, value in by_round[rnd].items():
            series.setdefault(name, []).append((rnd, value))
    return series, sorted(by_round)


def trend_gate(
    root,
    tol: Optional[float] = None,
    min_seconds: float = 1.0,
) -> TrendReport:
    """Run the gate over the committed series under ``root``.

    ``tol`` defaults to ``Config.obs_trend_tol`` — the single knob shared
    with the README table (R6)."""
    if tol is None:
        from citizensassemblies_tpu_torch.utils.config import default_config

        tol = float(default_config().obs_trend_tol)
    series, rounds = collect_series(root)
    rows: List[TrendRow] = []
    for name in sorted(series):
        points = series[name]
        if len(points) < 2:
            rows.append(TrendRow(name=name, points=points, status="insufficient"))
            continue
        latest = points[-1][1]
        best_prior = min(v for _r, v in points[:-1])
        ratio = latest / max(best_prior, 1e-9)
        if latest < min_seconds:
            status = "floor"
        elif latest > tol * best_prior:
            status = "regression"
        else:
            status = "ok"
        rows.append(
            TrendRow(
                name=name,
                points=points,
                status=status,
                latest=latest,
                best_prior=best_prior,
                ratio=round(ratio, 3),
            )
        )
    return TrendReport(rows=rows, tol=tol, min_seconds=min_seconds, rounds_seen=rounds)
