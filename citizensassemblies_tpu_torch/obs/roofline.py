"""Roofline attribution: join measured dispatch spans to the work they did.

``obs.trace`` knows how long each dispatch took (``dispatch_span`` wall
time, device-sampled under ``Config.obs_trace=True``); a cost function
knows the floating-point operations and the bytes that dispatch had to do
at the shapes it ran at. Joined, they give the achieved FLOP/s and B/s and
the arithmetic intensity that places each core on the roofline, with a
bytes-bound/compute-bound verdict against the machine-balance ridge
(``Config.obs_roofline_ridge``, FLOPs per byte).

The JAX package reads its costs from XLA's cost analysis of its own
programs (``ANALYSIS_BUDGET.json``), which says nothing about this card.
Here each dispatch-span name maps to a cost function the port owns
(:data:`COSTS`), evaluated on that span's attributes: the shapes the call
ran at (``nv/m1/m2``, ``rows``, ``cols``, ``kp``, ``nnz``, ``lanes``, …)
and, for the iterative solves, the iterations that run's data needed. The
three hand-written kernels' cost functions (:func:`gather_cost`,
:func:`two_sided_cost`, :func:`lp_cost`) are the bounds ``chip_smoke.py``
reports for them; the others count each principal input read once and each
output written once, against one pass of their principal product: a lower
bound of the work, so an achieved share of a peak never exceeds 1 on a
sampled span.

A dispatch span whose name has no cost function is a JOIN MISS (the report
is not ``ok``); cost functions no span fired are listed as ``unexecuted``.
The report schema and the trend-row family are the JAX package's.

No torch here: the join aggregates spans and does arithmetic, so it runs
against a saved tracer anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Union

ROOFLINE_SCHEMA_VERSION = 1

#: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, data sheet: HBM3 bytes/s
#: and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


class Cost(NamedTuple):
    """The work of one dispatch: float32 operations, the bytes each input
    read once and each output written once take, and (iterative solves)
    the bytes of re-reading the operator once per evaluation."""

    flops: float
    bytes: float
    stream_bytes: float = 0.0


def bound(cost: Cost) -> tuple:
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``cost``, the larger of its bytes over the HBM rate and its operations
    over the float32 peak, and which of the two it is (``"bytes"`` or
    ``"operations"``)."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S
    t_ops = cost.flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stream_ms(cost: Cost) -> float:
    """The time to stream the operator from HBM once per evaluation."""
    return 1e3 * cost.stream_bytes / HBM_BYTES_PER_S


# --- the three kernels ---------------------------------------------------------


def gather_cost(C: int, kp: int, T: int, lanes: int = 1, value_bytes: int = 4,
                lane_values: bool = False) -> Cost:
    """The packed gather ``z[b, c] = Σ_s val[c, s]·y[b, idx[c, s]]``: the
    int32 indices and the values (``value_bytes`` each, one set per lane
    with ``lane_values``) read once, each lane's ``y`` read and ``z``
    written once; a multiply and an add per slot and lane."""
    sets = lanes if lane_values else 1
    nbytes = C * kp * 4 + sets * C * kp * value_bytes + lanes * (T * 4 + C * 4)
    return Cost(flops=2.0 * C * kp * lanes, bytes=float(nbytes), stream_bytes=float(nbytes))


def _evals(iters, check_every: int) -> int:
    """Operator evaluations of solves that took ``iters`` iterations: one an
    iteration and two KKT evaluations a block."""
    its = [int(i) for i in (iters if isinstance(iters, (list, tuple)) else [iters])]
    return sum(i + 2 * (i // int(check_every)) for i in its)


def two_sided_cost(C: int, kp: int, T: int, nnz: int, lanes: int, iters,
                   check_every: int) -> Cost:
    """A ``lanes``-lane two-sided solve whose lanes took ``iters``: each
    input read once (the shared indices, every lane's scaled values, the
    lane vectors) and each output written once, against the float32
    operations the iterations need (per iteration and KKT evaluation both
    matvec directions over the nonzeros, a multiply and an add each, and
    about ten operations per entry of the C- and T-length vectors); the
    pack streamed once per evaluation in both layouts (row-major C·kp·8
    bytes, type-major nnz·8 bytes)."""
    nbytes = C * kp * 4 * (1 + lanes) + lanes * (4 * C + 6 * T) * 4
    evals = _evals(iters, check_every)
    flops = evals * (4 * nnz + 10 * (C + 2 * T))
    return Cost(float(flops), float(nbytes), float(evals * (C * kp * 8 + nnz * 8)))


def lp_cost(m1: int, kp: int, nv: int, nnz: int, iters, check_every: int = 128) -> Cost:
    """A generic-LP solve of ``iters`` iterations on an ELL pack of ``m1``
    rows: each input read once (the pack, c, h, A, b, the warm start) and
    each output written once, against the float32 operations the
    iterations need (per iteration and KKT evaluation both matvec
    directions over the nonzeros and about ten operations per entry of the
    nv- and m1-length vectors); the pack streamed once per evaluation in
    both layouts."""
    nbytes = m1 * kp * 8 + (4 * nv + 3 * m1 + 2 * nv + 4) * 4
    evals = _evals(iters, check_every)
    flops = evals * (4 * nnz + 10 * (nv + m1))
    return Cost(float(flops), float(nbytes), float(evals * (m1 * kp * 8 + nnz * 8)))


def dense_lp_cost(m1: int, m2: int, nv: int, iters, check_every: int = 128) -> Cost:
    """A dense generic-LP solve (``G [m1, nv]``, ``A [m2, nv]``): the
    matrices and vectors read once, the iterate written once; per
    evaluation both products over every entry, a multiply and an add
    each."""
    nbytes = (m1 + m2) * nv * 4 + (3 * nv + 2 * (m1 + m2)) * 4
    evals = _evals(iters, check_every)
    flops = evals * (4 * (m1 + m2) * nv + 10 * (nv + m1 + m2))
    return Cost(float(flops), float(nbytes), float(evals * (m1 + m2) * nv * 4))


# --- the cost table ------------------------------------------------------------


def _resolve(value: Any) -> Any:
    """A span attribute's value; a deferred device value
    (``obs.trace.DeviceValue``) is read here."""
    resolve = getattr(value, "resolve", None)
    return resolve() if callable(resolve) else value


def _bucket(text: str) -> List[int]:
    return [int(v) for v in str(text).split("x")]


def _one_pass(nbytes: float, flops: float) -> Cost:
    return Cost(float(flops), float(nbytes))


def _gather_span(a) -> Cost:
    return gather_cost(a["cols"], a["kp"], a["T"], a.get("lanes", 1), a.get("value_bytes", 4),
                       bool(a.get("lane_values", False)))


def _two_sided_span(a) -> Cost:
    return two_sided_cost(a["cols"], a["kp"], a["T"], a["nnz"], a.get("lanes", 1), a["iters"],
                          a["check_every"])


def _lp_span(a) -> Cost:
    return lp_cost(a["m1"], a["kp"], a["nv"], a["nnz"], a["iters"], a["check_every"])


def _dense_lp_span(a) -> Cost:
    return dense_lp_cost(a["m1"], a["m2"], a["nv"], a["iters"], a["check_every"])


def _vmapped_span(a) -> Cost:
    m1, m2, nv, _n = _bucket(a["bucket"])
    iters = a.get("iters") or []
    return dense_lp_cost(m1, m2, nv, list(iters), a["check_every"]) if iters else Cost(0.0, 0.0)


def _polish_span(a) -> Cost:
    T, Cp, B = _bucket(a["bucket"])
    return two_sided_cost(Cp, a["kp"], T, a["nnz"], B, a["iters"], a["check_every"])


def _dense_master_span(a) -> Cost:
    # the dense master is packed on the host and solved by the ELL master
    # (its own span): here, the dense matrix read once
    return _one_pass(a["T"] * a["cols"] * 4.0, 0.0)


def _pricing_span(a) -> Cost:
    # each lane's type weights read once and its composition written once,
    # one operation per weight
    lanes, T = a["lanes"], a["types"]
    return _one_pass(lanes * T * 8.0, lanes * T)


def _l2_fused_span(a) -> Cost:
    # the portfolio read once (dense C·n·4 bytes, or the pack's C·kp·8),
    # one product over it
    cells = a["rows"] * (a["kp"] if "kp" in a else a["n"])
    return _one_pass(cells * (8.0 if "kp" in a else 4.0), 2.0 * cells)


def _l2_ascent_span(a) -> Cost:
    # the portfolio read once; both products over it each iteration
    cells = a["rows"] * (a["kp"] if "kp" in a else a["n"])
    return _one_pass(cells * (8.0 if "kp" in a else 4.0), 4.0 * cells * a["iters"])


def _screen_span(a) -> Cost:
    # one candidate pair (or row) read and its verdict written
    return _one_pass(8.0 * a.get("pairs", a.get("rows", 0)), a.get("pairs", a.get("rows", 0)))


def _delta_span(a) -> Cost:
    # the stage duals and the portfolio's columns read once
    return _one_pass(4.0 * a["cols"] * a["stages"], a["cols"] * a["stages"])


def _sampler_span(a) -> Cost:
    # each chain writes one panel of k members over the n agents
    return _one_pass(4.0 * a["chains"] * a["n"], a["chains"] * a["n"])


def _dropout_span(a) -> Cost:
    # each draw seats a panel of k agents
    return _one_pass(4.0 * a["draws"] * a["k"], a["draws"] * a["k"])


def _sharded_span(a) -> Cost:
    # this rank's rows of the operator read once, one product over them
    cells = a["rows"] * a.get("kp", a.get("nv", 1))
    return _one_pass(cells * (8.0 if "kp" in a else 4.0), 2.0 * cells)


def _sweep_span(a) -> Cost:
    # each instance's chains write their panels
    return _one_pass(4.0 * a["instances"] * a["chains"] * a["n"],
                     a["instances"] * a["chains"] * a["n"])


CostFn = Callable[[Mapping[str, Any]], Cost]

#: dispatch-span name → its cost function over the span's attributes
COSTS: Dict[str, CostFn] = {
    "kernels.ell_gather": _gather_span,
    "kernels.pdhg_megakernel_two_sided": _two_sided_span,
    "kernels.pdhg_megakernel_lp": _lp_span,
    "lp_pdhg.two_sided_core": _dense_master_span,
    "lp_pdhg.two_sided_core_ell": _two_sided_span,
    "lp_pdhg.pdhg_core": _dense_lp_span,
    "lp_pdhg.pdhg_core_ell": _lp_span,
    "batch_lp.vmapped_core": _vmapped_span,
    "batch_lp.polish_screen_ell": _polish_span,
    "device_pricing.exact_dp": _pricing_span,
    "device_pricing.greedy_lanes": _pricing_span,
    "delta.screen": _delta_span,
    "qp.l2_fused_core": _l2_fused_span,
    "qp.l2_fused_core_ell": _l2_fused_span,
    "qp.l2_dual_ascent": _l2_ascent_span,
    "qp.l2_dual_ascent_ell": _l2_ascent_span,
    "face_decompose.move_screen": _screen_span,
    "face_decompose.fused_screen": _screen_span,
    "legacy.scan_sampler": _sampler_span,
    "mc.dropout_realization": _dropout_span,
    "parallel.sharded_dual_lp": _sharded_span,
    "parallel.sharded_dual_lp_ell": _sharded_span,
    "sweep.alloc_core": _sweep_span,
}

#: a cost entry: a function of the span's attributes, or one fixed
#: ``{"flops", "bytes"}`` per call (a budget-file entry)
CostEntry = Union[CostFn, Mapping[str, float]]


def span_cost(entry: CostEntry, attrs: Mapping[str, Any]) -> Cost:
    """One call's cost under ``entry``."""
    if callable(entry):
        return entry({k: _resolve(v) for k, v in attrs.items()})
    return Cost(float(entry.get("flops", 0.0)), float(entry.get("bytes", 0.0)))


# --- the join --------------------------------------------------------------------


@dataclasses.dataclass
class RooflineRow:
    """One core's placement on the roofline for one run."""

    core: str
    calls: int
    seconds: float  # summed (device-sampled) wall time across calls
    flops: float  # per call (the mean over the calls)
    bytes: float  # per call (the mean over the calls)
    achieved_gflops_s: float
    achieved_gbytes_s: float
    intensity_flops_per_byte: float
    bound: str  # "bytes-bound" | "compute-bound"
    sampled: bool  # True when every call blocked on its outputs

    @property
    def finite(self) -> bool:
        return (
            self.seconds > 0.0
            and self.achieved_gflops_s >= 0.0
            and self.achieved_gbytes_s >= 0.0
            and self.achieved_gflops_s == self.achieved_gflops_s  # not NaN
        )

    def peak_shares(self) -> Dict[str, float]:
        """The achieved rates as shares of the card's HBM and float32
        peaks (:data:`HBM_BYTES_PER_S`, :data:`F32_FLOPS_PER_S`)."""
        return {
            "hbm": self.achieved_gbytes_s * 1e9 / HBM_BYTES_PER_S,
            "f32": self.achieved_gflops_s * 1e9 / F32_FLOPS_PER_S,
        }


@dataclasses.dataclass
class RooflineReport:
    rows: List[RooflineRow]
    misses: List[str]  # dispatch-span names with no cost function
    unexecuted: List[str]  # cost functions no span fired (informational)
    ridge_flops_per_byte: float
    budget_provenance: Dict[str, Any]

    @property
    def ok(self) -> bool:
        return not self.misses and all(r.finite for r in self.rows)

    def as_json(self) -> dict:
        return {
            "schema_version": ROOFLINE_SCHEMA_VERSION,
            "roofline_ok": self.ok,
            "ridge_flops_per_byte": self.ridge_flops_per_byte,
            "budget": self.budget_provenance,
            "misses": list(self.misses),
            "unexecuted": list(self.unexecuted),
            "rows": {
                r.core: {
                    "calls": r.calls,
                    "seconds": r.seconds,
                    "flops_per_call": r.flops,
                    "bytes_per_call": r.bytes,
                    "achieved_gflops_s": r.achieved_gflops_s,
                    "achieved_gbytes_s": r.achieved_gbytes_s,
                    "intensity_flops_per_byte": r.intensity_flops_per_byte,
                    "bound": r.bound,
                    "sampled": r.sampled,
                }
                for r in self.rows
            },
        }

    def trend_detail(self) -> Dict[str, Dict[str, float]]:
        """``{"roofline_<core>": {"seconds": …}}`` rows for a
        ``ROOFLINE_r*.json`` family — the trend loader only admits
        ``[A-Za-z0-9_]`` names, so core dots become underscores."""
        return {
            "roofline_" + r.core.replace(".", "_"): {"seconds": round(r.seconds, 6)}
            for r in self.rows
        }


def dispatch_totals(tracers: Sequence) -> Dict[str, Dict[str, Any]]:
    """Aggregate ``kind="dispatch"`` spans by name across tracers:
    ``{name: {"calls", "seconds", "sampled"}}``. ``sampled`` stays True
    only if every call blocked on device outputs (``sampled`` span attr) —
    an unsampled call means the span timed host enqueue, not execution."""
    out: Dict[str, Dict[str, Any]] = {}
    for tracer in tracers:
        for sp in tracer.spans():
            if sp.attrs.get("kind") != "dispatch" or sp.t1 is None:
                continue
            agg = out.setdefault(sp.name, {"calls": 0, "seconds": 0.0, "sampled": True})
            agg["calls"] += 1
            agg["seconds"] += sp.duration
            agg["sampled"] = agg["sampled"] and bool(sp.attrs.get("sampled"))
    return out


def _dispatch_spans(tracers: Sequence) -> Dict[str, List[Any]]:
    out: Dict[str, List[Any]] = {}
    for tracer in tracers:
        for sp in tracer.spans():
            if sp.attrs.get("kind") == "dispatch" and sp.t1 is not None:
                out.setdefault(sp.name, []).append(sp)
    return out


def roofline_join(
    tracers: Sequence,
    costs: Optional[Mapping[str, CostEntry]] = None,
    ridge: Optional[float] = None,
) -> RooflineReport:
    """Join the tracers' dispatch spans against ``costs`` (default
    :data:`COSTS`): each call's cost is evaluated on its own span's
    attributes and summed per span name."""
    if ridge is None:
        from citizensassemblies_tpu_torch.utils.config import default_config

        ridge = float(default_config().obs_roofline_ridge)
    table = COSTS if costs is None else costs
    totals = dispatch_totals(tracers)
    spans = _dispatch_spans(tracers)
    rows: List[RooflineRow] = []
    misses: List[str] = []
    for name in sorted(totals):
        agg = totals[name]
        entry = table.get(name)
        if entry is None:
            misses.append(name)
            continue
        calls = agg["calls"]
        per_call = [span_cost(entry, sp.attrs) for sp in spans[name]]
        total_flops = sum(c.flops for c in per_call)
        total_bytes = sum(c.bytes for c in per_call)
        flops, nbytes = total_flops / calls, total_bytes / calls
        seconds = float(agg["seconds"])
        gflops_s = (total_flops / seconds) / 1e9 if seconds > 0 else float("nan")
        gbytes_s = (total_bytes / seconds) / 1e9 if seconds > 0 else float("nan")
        intensity = flops / nbytes if nbytes > 0 else float("inf")
        rows.append(
            RooflineRow(
                core=name,
                calls=calls,
                seconds=round(seconds, 6),
                flops=flops,
                bytes=nbytes,
                achieved_gflops_s=round(gflops_s, 4),
                achieved_gbytes_s=round(gbytes_s, 4),
                intensity_flops_per_byte=round(intensity, 4),
                bound="bytes-bound" if intensity < ridge else "compute-bound",
                sampled=bool(agg["sampled"]),
            )
        )
    unexecuted = sorted(set(table) - set(totals))
    return RooflineReport(
        rows=rows,
        misses=misses,
        unexecuted=unexecuted,
        ridge_flops_per_byte=float(ridge),
        budget_provenance={
            "source": "citizensassemblies_tpu_torch.obs.roofline" if costs is None else "given",
            "entries": len(table),
            "card": "NVIDIA H100 80GB HBM3, 700 W",
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "f32_flops_per_s": F32_FLOPS_PER_S,
        },
    )
