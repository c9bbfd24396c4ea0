"""The IR pass: aten-level checks of the registered cores, with a cost
ratchet.

The AST rules see source text; this pass sees what a core runs. Each core
of the registry (``lint/registry.py``) is built and called once on CPU
tensors, its plain route (``graph=False``: the kernels' plain versions, no
graph replay), under a ``TorchDispatchMode`` that records every aten op
(name, operand and result sizes and dtypes) and a ``TorchFunctionMode`` that
sees the tensor methods that leave the device (``.item()``, ``.tolist()``,
``.numpy()``, ``.cpu()``, ``bool()``/``float()``/``int()`` of a tensor).
Four checks run over the record:

* **IR1 host-read-in-core**: nothing reads a value to the host:
  ``aten._local_scalar_dense``, an op whose output shape depends on the
  data (``aten.nonzero``, ``aten.masked_select``, ``aten.unique…``), or one
  of the methods above. A core is the device work between two host reads,
  so a read inside one is a sync inside a launch window.
* **IR2 f64-in-core**: no float64 result unless the core is tagged
  ``allow_f64``; a tagged core instead fails on a float64 → float32
  narrowing.
* **IR3 in-place-update**: the number of inputs whose ``_version`` moved
  equals the declared ``donate_expected`` (fewer: a declared update was
  dropped; more: an undeclared one mutates a caller's tensor).
* **IR4 cost-budget**: FLOPs (``torch.utils.flop_counter``'s formulas for
  the matrix products; one operation per result element of a floating
  pointwise op and per input element of a reduction, which counts a
  multiply and an add per slot of a gather, as the roofline's cost
  functions do), bytes (each op's operand and result sizes) and the aten
  op histogram, against the port's own ``lint/analysis_budget.json`` with
  the JAX package's default tolerance of 0.25. A missing or stale entry
  fails; ``--update-budget`` rewrites the file. For the three kernel cores
  the entry also records the ``obs/roofline`` bound at the registered
  shape (the kernels are ctypes calls, invisible to a dispatch mode: the
  trace sees their plain versions only); the gather's plain FLOPs must
  equal ``gather_cost``'s, and the block kernels' ratio of plain to bound
  FLOPs is recorded.

The traces are of CPU tensors whatever ``device`` says (the plain versions
run only there), so the budget is the same on every machine; ``device=
"cuda"`` also builds each core on the card and runs it once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from citizensassemblies_tpu_torch.lint.engine import Violation
from citizensassemblies_tpu_torch.lint.registry import CoreEntry, IRCase, collect, sparse_pairs

#: headroom of the cost ratchet: measured ≤ budget × (1 + tolerance), the
#: JAX package's default
DEFAULT_TOLERANCE = 0.25

#: the port's committed budget, beside this module
BUDGET_PATH = Path(__file__).resolve().parent / "analysis_budget.json"

#: aten ops that read a value to the host, or whose output shape does
_HOST_READ_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique", "_unique2",
    "unique_consecutive", "unique_dim",
})

#: tensor methods that leave the device
_HOST_READ_METHODS = frozenset({
    "item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__", "__index__",
})

#: floating pointwise ops counted as one operation per result element
_POINTWISE = frozenset({
    "add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_", "neg", "abs", "sqrt", "rsqrt",
    "exp", "log", "pow", "clamp", "clamp_", "clamp_min", "clamp_max", "maximum", "minimum",
    "reciprocal", "square", "addcmul", "addcdiv", "lerp", "exponential_",
})

#: reductions counted as one operation per input element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "norm", "linalg_vector_norm", "prod", "cumsum",
    "segment_reduce", "index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_",
})

@dataclasses.dataclass
class Trace:
    """What one call of a core ran."""

    ops: List[Tuple[str, int, int, Tuple[str, ...], Tuple[str, ...]]]  # name, in/out bytes, dtypes
    host_reads: List[str]
    flops: float
    versions_moved: int
    outputs: Any


@dataclasses.dataclass
class CoreReport:
    name: str
    path: str
    line: int
    violations: List[Violation] = dataclasses.field(default_factory=list)
    measured: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclasses.dataclass
class IRReport:
    cores: List[CoreReport]
    budget_path: str
    tolerance: float
    updated: bool = False

    @property
    def violations(self) -> List[Violation]:
        return [v for c in self.cores for v in c.violations]

    @property
    def ok(self) -> bool:
        return not self.violations


# --- tracing ----------------------------------------------------------------------


def tensor_leaves(value) -> List[Any]:
    """Every tensor inside ``value`` (tuples, lists, dicts, dataclasses)."""
    import torch

    out: List[Any] = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))

    walk(value)
    return out


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _op_flops(name: str, args, outs) -> float:
    import torch

    floats = [t for t in outs if t.is_floating_point()]
    if not floats:
        return 0.0
    if name in _POINTWISE:
        return float(sum(t.numel() for t in floats))
    if name in _REDUCTIONS:
        ins = [t for t in tensor_leaves(args) if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if name.startswith(("index_add", "scatter")):
            ins = ins[-1:]  # the source values, not the destination
        return float(max((t.numel() for t in ins), default=0))
    return 0.0


def trace_call(fn, args, kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under the recording modes."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    ops: List[Tuple[str, int, int, Tuple[str, ...], Tuple[str, ...]]] = []
    host_reads: List[str] = []
    counted = [0.0]

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            name = func.overloadpacket.__name__
            ins = [t for t in tensor_leaves((a, kw or {})) if isinstance(t, torch.Tensor)]
            outs = [t for t in tensor_leaves(out) if isinstance(t, torch.Tensor)]
            ops.append((str(func), sum(_nbytes(t) for t in ins), sum(_nbytes(t) for t in outs),
                        tuple(str(t.dtype) for t in ins), tuple(str(t.dtype) for t in outs)))
            if name in _HOST_READ_OPS or (name.startswith("index") and any(
                    t.dtype == torch.bool for t in ins[1:])):
                # a bool mask index sizes its result by the mask's values
                host_reads.append(str(func))
            if func.overloadpacket not in torch.utils.flop_counter.flop_registry:
                counted[0] += _op_flops(name, (a, kw or {}), outs)
            return out

    class Methods(TorchFunctionMode):
        def __torch_function__(self, func, types, a=(), kw=None):
            name = getattr(func, "__name__", "")
            if name in _HOST_READ_METHODS and a and isinstance(a[0], torch.Tensor):
                host_reads.append(f"Tensor.{name}")
            return func(*a, **(kw or {}))

    before = [(t, t._version) for t in tensor_leaves((args, kwargs))]
    flop_mode = FlopCounterMode(display=False)
    with Methods(), flop_mode, Ops():
        outputs = fn(*args, **kwargs)
    moved = sum(1 for t, v in before if t._version != v)
    return Trace(ops=ops, host_reads=host_reads,
                 flops=float(flop_mode.get_total_flops()) + counted[0],
                 versions_moved=moved, outputs=outputs)


def histogram(trace: Trace) -> Dict[str, int]:
    hist: Dict[str, int] = {}
    for name, *_ in trace.ops:
        hist[name] = hist.get(name, 0) + 1
    return {k: hist[k] for k in sorted(hist)}


def trace_case(case: IRCase) -> Trace:
    """The plain route of a built core (``graph=False`` where it has a graph
    site)."""
    kwargs = dict(case.static)
    if case.graph is not None:
        kwargs["graph"] = False
    return trace_call(case.fn, case.args, kwargs)


# --- the roofline bound of the kernel cores --------------------------------------------


def kernel_bound(name: str, case: IRCase) -> Optional[Dict[str, Any]]:
    """The ``obs/roofline`` cost of a kernel core at its registered shape
    (the plain version's work on the CPU: one block of ``check_every``
    iterations for the block kernels)."""
    from citizensassemblies_tpu_torch.obs import roofline

    if name == "kernels.pallas_ell_matvec":
        idx, val, y = case.args
        lanes = int(y.shape[0]) if y.dim() == 2 else 1
        cost = roofline.gather_cost(int(idx.shape[0]), int(idx.shape[1]), int(y.shape[-1]), lanes)
        formula = f"gather_cost(C={idx.shape[0]}, kp={idx.shape[1]}, T={y.shape[-1]}, lanes={lanes})"
    elif name == "kernels.pdhg_megakernel_two_sided":
        idx, val, v, colmask = case.args[:4]
        ce = int(case.static["check_every"])
        nnz = int((val != 0).sum())
        C, kp, T, B = int(idx.shape[0]), int(idx.shape[1]), int(v.shape[0]), int(colmask.shape[0])
        cost = roofline.two_sided_cost(C, kp, T, nnz, B, [ce] * B, ce)
        formula = f"two_sided_cost(C={C}, kp={kp}, T={T}, nnz={nnz}, lanes={B}, iters={ce}, check_every={ce})"
    elif name == "kernels.pdhg_megakernel_lp":
        c, idx, val = case.args[:3]
        ce = int(case.static["check_every"])
        nnz = int((val != 0).sum())
        m1, kp, nv = int(idx.shape[0]), int(idx.shape[1]), int(c.shape[0])
        cost = roofline.lp_cost(m1, kp, nv, nnz, ce, ce)
        formula = f"lp_cost(m1={m1}, kp={kp}, nv={nv}, nnz={nnz}, iters={ce}, check_every={ce})"
    else:
        return None
    return {"formula": formula, "flops": float(cost.flops), "bytes": float(cost.bytes)}


# --- per-core verification -------------------------------------------------------------


def _viol(entry: CoreEntry, rule: str, name: str, message: str) -> Violation:
    return Violation(path=entry.path, line=entry.line, col=0, rule=rule, name=name,
                     message=f"[{entry.name}] {message}")


def measure(entry: CoreEntry, case: IRCase, trace: Trace) -> Dict[str, Any]:
    measured: Dict[str, Any] = {
        "flops": float(trace.flops),
        "bytes": float(sum(i + o for _n, i, o, _a, _b in trace.ops)),
        "ops": histogram(trace),
    }
    bound = kernel_bound(entry.name, case)
    if bound is not None:
        measured["bound"] = bound
        if bound["flops"] > 0:
            measured["plain_over_bound_flops"] = round(measured["flops"] / bound["flops"], 4)
    return measured


def verify_core(entry: CoreEntry, budget: Optional[Dict[str, Any]], tolerance: float,
                device: str = "cpu") -> CoreReport:
    """IR1-IR4 for one core; check failures become violations, and a core
    that no longer builds or runs is one too (IR0)."""
    report = CoreReport(name=entry.name, path=entry.path, line=entry.line)
    try:
        case = entry.build(device="cpu")
        trace = trace_case(case)
        if device != "cpu":
            entry.build(device=device).run()
    except Exception as exc:  # noqa: BLE001 - reported, not raised
        report.violations.append(_viol(entry, "IR0", "untraceable-core", f"build or run failed: {exc!r}"))
        return report

    for read in sorted(set(trace.host_reads)):
        report.violations.append(_viol(
            entry, "IR1", "host-read-in-core",
            f"'{read}' ({trace.host_reads.count(read)}x) reads a value to the host inside the "
            "core: a sync inside its launch window; read it after the window"))
    f64 = sorted({n for n, _i, _o, _a, outs in trace.ops if "torch.float64" in outs})
    if case.allow_f64:
        narrow = sum(1 for n, _i, _o, ins, outs in trace.ops
                     if "torch.float64" in ins and outs == ("torch.float32",) and "_to_copy" in n)
        if narrow:
            report.violations.append(_viol(
                entry, "IR2", "f64-narrowed-in-cert-core",
                f"{narrow} float64 → float32 conversion(s) inside a certification core"))
    elif f64:
        report.violations.append(_viol(
            entry, "IR2", "f64-in-core",
            f"float64 result(s) from {', '.join(f64)}: the device paths are float32; keep float64 "
            "on the host path"))
    if trace.versions_moved != case.donate_expected:
        kind = "dropped" if trace.versions_moved < case.donate_expected else "undeclared"
        report.violations.append(_viol(
            entry, "IR3", f"{kind}-in-place-update",
            f"declared {case.donate_expected} in-place update(s) of its inputs, the call made "
            f"{trace.versions_moved}"))

    measured = report.measured = measure(entry, case, trace)
    bound = measured.get("bound")
    if entry.name == "kernels.pallas_ell_matvec" and bound is not None and measured["flops"] != bound["flops"]:
        report.violations.append(_viol(
            entry, "IR4", "gather-cost-mismatch",
            f"the plain gather's {measured['flops']:.0f} FLOPs differ from {bound['formula']}'s "
            f"{bound['flops']:.0f}: the roofline's bound and the plain version disagree on the work"))
    if budget is None:
        report.violations.append(_viol(
            entry, "IR4", "missing-budget",
            "no entry in the analysis budget: run 'python -m citizensassemblies_tpu_torch.lint "
            "--ir --update-budget --device cpu' and commit the result"))
        return report
    for metric in ("flops", "bytes"):
        allowed = float(budget.get(metric, 0.0)) * (1.0 + tolerance)
        if measured[metric] > allowed:
            report.violations.append(_viol(
                entry, "IR4", f"{metric}-budget-exceeded",
                f"{metric} regressed: measured {measured[metric]:.0f} > budget "
                f"{float(budget.get(metric, 0.0)):.0f} × (1 + {tolerance:g})"))
    budget_ops: Dict[str, int] = dict(budget.get("ops", {}))
    for op, count in measured["ops"].items():
        if op not in budget_ops:
            report.violations.append(_viol(
                entry, "IR4", "new-op", f"aten op '{op}' ({count}x) is new to this core"))
        elif count > math.ceil(budget_ops[op] * (1.0 + tolerance)):
            report.violations.append(_viol(
                entry, "IR4", "op-count-exceeded",
                f"aten op '{op}' count regressed: {count} > {budget_ops[op]} × (1 + {tolerance:g})"))
    return report


# --- budget file -----------------------------------------------------------------------


def load_budget(path: Path) -> Tuple[Dict[str, Any], float]:
    if not path.exists():
        return {}, DEFAULT_TOLERANCE
    data = json.loads(path.read_text(encoding="utf-8"))
    return dict(data.get("cores", {})), float(data.get("_meta", {}).get("tolerance", DEFAULT_TOLERANCE))


def write_budget(path: Path, reports: Sequence[CoreReport], tolerance: float) -> None:
    import torch

    data = {
        "_meta": {
            "tolerance": tolerance,
            "torch": torch.__version__.split("+")[0],
            "generated_by": "python -m citizensassemblies_tpu_torch.lint --ir --update-budget --device cpu",
        },
        "cores": {r.name: r.measured for r in reports if r.measured is not None},
    }
    path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n", encoding="utf-8")


def budget_provenance(path: Optional[Path] = None) -> Dict[str, Any]:
    path = path or BUDGET_PATH
    if not path.exists():
        return {"file": path.name, "missing": True}
    raw = path.read_bytes()
    data = json.loads(raw.decode("utf-8"))
    meta = data.get("_meta", {})
    return {"file": path.name, "sha256": hashlib.sha256(raw).hexdigest()[:12],
            "cores": len(data.get("cores", {})), "tolerance": meta.get("tolerance"),
            "torch": meta.get("torch")}


# --- the pass --------------------------------------------------------------------------


def run_ir_checks(entries: Optional[Sequence[CoreEntry]] = None, budget_path: Optional[Path] = None,
                  update_budget: bool = False, tolerance: Optional[float] = None,
                  device: str = "cpu") -> IRReport:
    """Verify every registered core (or ``entries``) against the budget.
    ``update_budget`` rewrites the budget from this run (IR4 findings are
    then dropped; IR0-IR3 still fail). A one-rank world the distributed
    cores' build functions start is ended before returning."""
    import torch.distributed as dist

    budget_path = Path(budget_path) if budget_path is not None else BUDGET_PATH
    entries = list(entries) if entries is not None else collect()
    budgets, file_tol = load_budget(budget_path)
    tol = float(tolerance) if tolerance is not None else file_tol
    had_world = dist.is_available() and dist.is_initialized()
    try:
        reports = [verify_core(e, budgets.get(e.name), tol, device=device) for e in entries]
    finally:
        if not had_world and dist.is_available() and dist.is_initialized():
            from citizensassemblies_tpu_torch.dist import runtime

            runtime.shutdown()
    if update_budget:
        write_budget(budget_path, reports, tol)
        for rep in reports:
            rep.violations = [v for v in rep.violations if v.rule != "IR4"]
    else:
        known = {e.name for e in entries}
        for name in sorted(set(budgets) - known):
            reports.append(CoreReport(name=name, path=budget_path.name, line=1, violations=[Violation(
                path=budget_path.name, line=1, col=0, rule="IR4", name="stale-budget-entry",
                message=f"[{name}] budget entry has no registered core: remove it via --update-budget",
            )]))
    return IRReport(cores=reports, budget_path=str(budget_path), tolerance=tol, updated=update_budget)


def budget_diff(report: IRReport) -> Dict[str, Any]:
    """Measured-vs-budget comparison, with the dense → sparse deltas of the
    registered ELL twins (same problem shape) and the kernel cores' bounds."""
    budgets, _ = load_budget(Path(report.budget_path))
    cores: Dict[str, Any] = {}
    measured = {r.name: r.measured for r in report.cores if r.measured is not None}
    for rep in report.cores:
        entry: Dict[str, Any] = {"status": "PASS" if rep.ok else "FAIL"}
        if rep.measured is not None:
            entry["measured"] = {k: rep.measured[k] for k in ("flops", "bytes")}
            if "bound" in rep.measured:
                entry["bound"] = rep.measured["bound"]
            budget = budgets.get(rep.name)
            if budget:
                entry["budget"] = {k: budget.get(k) for k in ("flops", "bytes")}
                entry["ratio"] = {k: round(rep.measured[k] / float(budget[k]), 4)
                                  for k in ("flops", "bytes") if float(budget.get(k) or 0) > 0}
        cores[rep.name] = entry
    deltas: Dict[str, Any] = {}
    for ell, dense in sorted(sparse_pairs().items()):
        e, d = measured.get(ell), measured.get(dense)
        if not e or not d:
            continue
        row: Dict[str, Any] = {"dense": dense}
        for metric in ("flops", "bytes"):
            row[f"dense_{metric}"], row[f"ell_{metric}"] = d[metric], e[metric]
            if e[metric] > 0:
                row[f"{metric}_reduction"] = round(d[metric] / e[metric], 2)
        deltas[ell] = row
    return {"budget_file": report.budget_path, "tolerance": report.tolerance,
            "provenance": budget_provenance(Path(report.budget_path)), "sparse_deltas": deltas,
            "cores": cores}


def render_ir_report(report: IRReport) -> str:
    lines = [v.render() for v in report.violations]
    for rep in sorted(report.cores, key=lambda r: r.name):
        extra = ""
        if rep.measured is not None:
            extra = f" (flops={rep.measured['flops']:.0f} bytes={rep.measured['bytes']:.0f})"
        lines.append(f"{rep.path}:{rep.line}: {'PASS' if rep.ok else 'FAIL'} [{rep.name}]{extra}")
    n_fail = sum(1 for r in report.cores if not r.ok)
    lines.append(f"ir: {len(report.cores)} core(s) verified, {n_fail} failing, "
                 f"budget={report.budget_path}" + (" (updated)" if report.updated else ""))
    return "\n".join(lines)


def ir_report_as_json(report: IRReport) -> Dict[str, Any]:
    return {
        "schema_version": 1, "pass": "ir", "ok": report.ok, "budget": report.budget_path,
        "tolerance": report.tolerance, "updated": report.updated,
        "cores": [{"core": r.name, "path": r.path, "line": r.line,
                   "status": "PASS" if r.ok else "FAIL", "measured": r.measured}
                  for r in sorted(report.cores, key=lambda r: r.name)],
        "violations": [dataclasses.asdict(v) for v in report.violations],
    }
