"""The precision pass (P1): error-flow certification of the registered
cores' bf16 demotions over their aten traces.

The JAX package's certifier walks each core's jaxpr with an abstract
interpreter; this pass walks the aten trace of the core's plain route on
CPU tensors (``lint/ir.py``'s route) with the same domain and the same
classes. Per traced value it carries a dynamic-range interval ``[lo, hi]``,
a relative-error bound ``rel`` (``inf``: unbounded, e.g. past a possible
cancellation) and ``exact`` (integer-valued, magnitude ≤ 256, zero error:
exactly representable at bf16). The arguments are seeded from the
registration's ``arg_ranges`` triples ``(lo, hi, exact)``; a tensor the
trace meets without a state (a constant the core builds) is seeded from its
values. Every floating result is classified ``bf16_safe`` /
``f32_required`` / ``f64_cert`` (``non_float`` otherwise): accumulation
outputs (reductions, products, scatter-adds) and values consumed by a
comparison, an ordering or an extremum, or returned by the core, are pinned
at float32 by rule; a value is ``bf16_safe`` only when exact.

A nominated argument (``prec_demote``) is certified when its declared range
is exact and the core is not a float64 certification core: the demotion
is then lossless, and the runtime (``utils/precision.demote_operator``)
checks the same property per array. The certified set, mapped to the JAX
registration's argument order (``IRCase.jax_args``), must equal the
``demote_args`` of the committed ``PRECISION_PLAN.json``, which the port's
runtime applies (read only here). As the compiled-truth check (P3) the
core is run once more with the certified arguments stored at bf16: the
result must equal the float32 run bit for bit, as an engaged run must
equal an off run.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from citizensassemblies_tpu_torch.lint.engine import Violation
from citizensassemblies_tpu_torch.lint.registry import CoreEntry, IRCase, collect

#: the committed plan at the repo root (the runtime's, ``utils/precision.py``)
PLAN_PATH = Path(__file__).resolve().parent.parent.parent / "PRECISION_PLAN.json"

F32_EPS = 2.0 ** -24
BF16_MAX = 3.38e38
BF16_EXACT_INT = 256.0

#: accumulation ops: their results are pinned at float32 by rule
ACCUM_OPS = frozenset({
    "sum", "mean", "mm", "mv", "bmm", "addmm", "addmv", "matmul", "dot", "cumsum", "index_add",
    "index_add_", "scatter_add", "scatter_add_", "segment_reduce", "linalg_vector_norm", "norm",
})

#: consumers that pin their floating operands at float32: comparisons decide
#: convergence and feasibility, orderings and extrema flip on ties
PIN_OPS = frozenset({
    "lt", "le", "gt", "ge", "eq", "ne", "sort", "argsort", "argmax", "argmin", "topk", "amax",
    "amin", "max", "min", "searchsorted", "isfinite", "isnan",
})

_STRUCTURAL = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose", "slice", "select",
    "clone", "contiguous", "_to_copy", "copy_", "copy", "index", "index_select", "gather", "cat",
    "stack", "squeeze", "unsqueeze", "alias", "detach", "lift_fresh", "where", "repeat",
    "flatten", "unbind", "split", "split_with_sizes", "narrow", "as_strided", "new_zeros",
    "zeros_like", "full_like", "ones_like", "fill_", "zero_", "scatter", "scatter_", "index_put_",
    "masked_fill", "masked_fill_", "empty_like", "_reshape_alias", "roll", "flip",
})


@dataclasses.dataclass(frozen=True)
class AbsVal:
    lo: float
    hi: float
    rel: float
    exact: bool = False

    @property
    def mag(self) -> float:
        return max(abs(self.lo), abs(self.hi))


TOP = AbsVal(-math.inf, math.inf, math.inf, False)


def _compose(*rels: float, steps: int = 1) -> float:
    acc = 1.0
    for r in rels:
        if math.isinf(r):
            return math.inf
        acc *= 1.0 + r
    return acc * (1.0 + F32_EPS) ** min(steps, 1 << 20) - 1.0


def _join(vals: Sequence[AbsVal]) -> AbsVal:
    if not vals:
        return TOP
    return AbsVal(min(v.lo for v in vals), max(v.hi for v in vals), max(v.rel for v in vals),
                  all(v.exact for v in vals))


def _exact(lo: float, hi: float, *ins: AbsVal) -> bool:
    return all(v.exact for v in ins) and max(abs(lo), abs(hi)) <= BF16_EXACT_INT


def _mulb(x: float, y: float) -> float:
    return 0.0 if x == 0.0 or y == 0.0 else x * y


def transfer(name: str, ins: List[AbsVal], n_terms: int) -> AbsVal:
    """The transfer function of one aten op over its floating operands'
    states; TOP where none is defined."""
    if name in ("add", "add_", "sub", "sub_", "rsub") and len(ins) >= 2:
        a, b = ins[0], ins[1]
        if name.startswith("sub") or name == "rsub":
            b = AbsVal(-b.hi, -b.lo, b.rel, b.exact)
        lo, hi = a.lo + b.lo, a.hi + b.hi
        same = (a.lo >= 0 and b.lo >= 0) or (a.hi <= 0 and b.hi <= 0)
        ex = _exact(lo, hi, a, b)
        return AbsVal(lo, hi, 0.0 if ex else (_compose(max(a.rel, b.rel)) if same else math.inf), ex)
    if name in ("mul", "mul_") and len(ins) >= 2:
        a, b = ins[0], ins[1]
        c = [_mulb(a.lo, b.lo), _mulb(a.lo, b.hi), _mulb(a.hi, b.lo), _mulb(a.hi, b.hi)]
        ex = _exact(min(c), max(c), a, b)
        return AbsVal(min(c), max(c), 0.0 if ex else _compose(a.rel, b.rel), ex)
    if name in ("div", "div_") and len(ins) >= 2:
        a, b = ins[0], ins[1]
        if b.lo <= 0.0 <= b.hi:
            return TOP
        c = [_mulb(a.lo, 1 / b.lo), _mulb(a.lo, 1 / b.hi), _mulb(a.hi, 1 / b.lo), _mulb(a.hi, 1 / b.hi)]
        return AbsVal(min(c), max(c), _compose(a.rel, b.rel), False)
    if name == "neg" and ins:
        a = ins[0]
        return AbsVal(-a.hi, -a.lo, a.rel, a.exact)
    if name == "abs" and ins:
        a = ins[0]
        lo = 0.0 if a.lo <= 0.0 <= a.hi else min(abs(a.lo), abs(a.hi))
        return AbsVal(lo, a.mag, a.rel, a.exact)
    if name in ("maximum", "minimum") and len(ins) >= 2:
        a, b = ins[0], ins[1]
        pick = max if name == "maximum" else min
        # the result is one of the operands: its error is at most theirs
        return AbsVal(pick(a.lo, b.lo), pick(a.hi, b.hi), max(a.rel, b.rel), a.exact and b.exact)
    if name in ("clamp", "clamp_", "clamp_min", "clamp_max") and ins:
        # a bound that is a python number is not among the operands: the
        # range is unknown, the error at most the operands'
        return AbsVal(-math.inf, math.inf, max(v.rel for v in ins), False)
    if name == "sqrt" and ins:
        a = ins[0]
        if a.lo < 0.0 or math.isinf(a.hi):
            return TOP
        return AbsVal(math.sqrt(a.lo), math.sqrt(a.hi), _compose(0.5 * a.rel), False)
    if name in ACCUM_OPS and ins:
        a = _join(ins)
        n = max(int(n_terms), 1)
        if math.isinf(a.lo) or math.isinf(a.hi):
            return TOP
        lo, hi = min(n * a.lo, a.lo), max(n * a.hi, a.hi)
        one_signed = a.lo >= 0.0 or a.hi <= 0.0
        return AbsVal(lo, hi, _compose(a.rel, steps=n) if one_signed else math.inf, False)
    if name in _STRUCTURAL and ins:
        return _join(ins)
    return TOP


def _const(t) -> AbsVal:
    """A tensor met without a state: a constant the core built."""
    import torch

    if t.numel() == 0:
        return AbsVal(0.0, 0.0, 0.0, True)
    if not (t.is_floating_point() or t.dtype in (torch.int32, torch.int64, torch.bool)):
        return TOP
    v = t.detach().cpu()
    v = np.asarray((v.float() if v.is_floating_point() else v).numpy(), dtype=np.float64)
    lo, hi = float(v.min()), float(v.max())
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return TOP
    ex = max(abs(lo), abs(hi)) <= BF16_EXACT_INT and bool(np.all(v == np.round(v)))
    return AbsVal(lo, hi, 0.0, ex)


def _seed(rng) -> AbsVal:
    if rng is None:
        return AbsVal(-math.inf, math.inf, F32_EPS, False)
    lo, hi, exact = float(rng[0]), float(rng[1]), bool(rng[2])
    if exact and max(abs(lo), abs(hi)) <= BF16_EXACT_INT:
        return AbsVal(lo, hi, 0.0, True)
    return AbsVal(lo, hi, F32_EPS, False)


@dataclasses.dataclass
class Analysis:
    classes: Dict[str, int]
    n_vars: int
    certified_demote: List[int]
    out_rel: Optional[float]


def analyze_case(case: IRCase) -> Analysis:
    """P1 for one built core: walk its plain route's aten trace."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from citizensassemblies_tpu_torch.lint.ir import tensor_leaves

    env: Dict[int, Tuple[Any, AbsVal]] = {}
    ranges = case.arg_ranges or (None,) * len(case.args)
    for i, a in enumerate(case.args):
        for t in tensor_leaves(a):
            env[id(t)] = (t, _seed(ranges[i] if i < len(ranges) else None))
    # per traced result: its op, class inputs, and its consumers' op names
    results: List[Tuple[Any, str, AbsVal]] = []
    consumers: Dict[int, List[str]] = {}

    def state(t) -> AbsVal:
        got = env.get(id(t))
        if got is None or got[0] is not t:
            av = _const(t)
            env[id(t)] = (t, av)
            return av
        return got[1]

    class Walk(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            name = func.overloadpacket.__name__
            ins = [t for t in tensor_leaves((a, kw or {})) if isinstance(t, torch.Tensor)]
            for t in ins:
                consumers.setdefault(id(t), []).append(name)
            fl = [state(t) for t in ins if t.is_floating_point()]
            outs = [t for t in tensor_leaves(out) if isinstance(t, torch.Tensor)]
            n_terms = max((t.numel() for t in ins), default=1) // max(
                max((t.numel() for t in outs), default=1), 1)
            if name in ("mm", "mv", "bmm", "matmul", "addmm", "addmv", "dot") and len(ins) >= 2:
                n_terms = int(ins[-1].shape[0]) if ins[-1].dim() else 1
            av = transfer(name, fl, n_terms) if fl else TOP
            for t in outs:
                env[id(t)] = (t, av if t.is_floating_point() else _const(t))
                results.append((t, name, av))
            return out

    kwargs = dict(case.static)
    if case.graph is not None:
        kwargs["graph"] = False
    with Walk():
        outputs = case.fn(*case.args, **kwargs)
    returned = {id(t) for t in tensor_leaves(outputs)}
    counts = {"bf16_safe": 0, "f32_required": 0, "f64_cert": 0, "non_float": 0}
    for t, name, av in results:
        if not t.is_floating_point():
            counts["non_float"] += 1
        elif t.element_size() == 8:
            counts["f64_cert"] += 1
        else:
            pinned = name in ACCUM_OPS or id(t) in returned or any(
                c in PIN_OPS for c in consumers.get(id(t), ()))
            safe = not pinned and av.exact and av.mag <= BF16_MAX
            counts["bf16_safe" if safe else "f32_required"] += 1
    certified = []
    for i in sorted(set(int(j) for j in case.prec_demote)):
        leaves = tensor_leaves(case.args[i]) if i < len(case.args) else []
        floats = bool(leaves) and all(t.is_floating_point() and t.element_size() < 8 for t in leaves)
        if floats and not case.allow_f64 and _seed(ranges[i] if i < len(ranges) else None).exact:
            certified.append(i)
    rels = [state(t).rel for t in tensor_leaves(outputs) if t.is_floating_point()]
    out_rel = max(rels, default=0.0)
    return Analysis(classes=counts, n_vars=len(results), certified_demote=certified,
                    out_rel=None if math.isinf(out_rel) or out_rel > 1e30 else out_rel)


def to_jax_indices(case: IRCase, indices: Sequence[int]) -> List[int]:
    """Port argument indices as the JAX registration's (``jax_args``)."""
    if case.jax_args is None:
        return sorted(int(i) for i in indices)
    return sorted(int(case.jax_args[i]) for i in indices if case.jax_args[i] is not None)


def demoted_run_equal(case: IRCase, demote: Sequence[int]) -> bool:
    """Is the core's result with the ``demote`` arguments stored at bf16
    bit for bit its float32 result?"""
    import torch

    from citizensassemblies_tpu_torch.lint.ir import tensor_leaves
    from citizensassemblies_tpu_torch.utils.precision import demote_dtype

    kwargs = dict(case.static)
    if case.graph is not None:
        kwargs["graph"] = False
    ref = tensor_leaves(case.fn(*case.args, **kwargs))
    args = list(case.args)
    for i in demote:
        args[i] = args[i].to(demote_dtype())
    got = tensor_leaves(case.fn(*args, **kwargs))
    return len(ref) == len(got) and all(torch.equal(a, b) for a, b in zip(ref, got))


# --- per-core verification -------------------------------------------------------------


@dataclasses.dataclass
class PrecCoreReport:
    name: str
    path: str
    line: int
    violations: List[Violation] = dataclasses.field(default_factory=list)
    analysis: Optional[Analysis] = None
    certified_jax: Optional[List[int]] = None
    plan_demote: Optional[List[int]] = None

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclasses.dataclass
class PrecReport:
    cores: List[PrecCoreReport]
    plan_path: str

    @property
    def violations(self) -> List[Violation]:
        return [v for c in self.cores for v in c.violations]

    @property
    def ok(self) -> bool:
        return not self.violations


def _viol(entry, rule: str, name: str, message: str) -> Violation:
    return Violation(path=entry.path, line=entry.line, col=0, rule=rule, name=name,
                     message=f"[{entry.name}] {message}")


def load_plan(path: Path) -> Dict[str, Any]:
    import json

    if not path.exists():
        return {}
    return dict(json.loads(path.read_text(encoding="utf-8")).get("cores", {}))


def verify_prec_core(entry: CoreEntry, plan_entry: Optional[Dict[str, Any]],
                     device: str = "cpu") -> PrecCoreReport:
    report = PrecCoreReport(name=entry.name, path=entry.path, line=entry.line)
    try:
        case = entry.build(device="cpu")
        report.analysis = analyze_case(case)
        if device != "cpu":
            entry.build(device=device).run()
    except Exception as exc:  # noqa: BLE001 - reported, not raised
        report.violations.append(_viol(entry, "P1", "untraceable-core", f"error-flow walk failed: {exc!r}"))
        return report
    certified = report.analysis.certified_demote
    refused = sorted(set(int(i) for i in case.prec_demote) - set(certified))
    if refused:
        report.violations.append(_viol(
            entry, "P1", "uncertified-demotion",
            f"argument(s) {refused} are nominated in prec_demote but the walk refuses them: declare "
            "an exact arg_ranges triple the operand satisfies, or drop the nomination"))
    report.certified_jax = to_jax_indices(case, certified)
    if plan_entry is None:
        report.violations.append(_viol(entry, "P2", "missing-plan-entry",
                                       "no entry in PRECISION_PLAN.json for this core"))
    else:
        report.plan_demote = sorted(int(i) for i in plan_entry.get("demote_args", []))
        if report.plan_demote != report.certified_jax:
            report.violations.append(_viol(
                entry, "P2", "plan-mismatch",
                f"the port certifies demote_args {report.certified_jax} (JAX argument order), the "
                f"committed plan applies {report.plan_demote}"))
    if certified:
        try:
            same = demoted_run_equal(case, certified)
        except Exception as exc:  # noqa: BLE001
            report.violations.append(_viol(entry, "P3", "demoted-run-failed", f"{exc!r}"))
        else:
            if not same:
                report.violations.append(_viol(
                    entry, "P3", "lossy-demotion",
                    f"with argument(s) {certified} at bf16 the core's result is not bit for bit its "
                    "float32 result: the certified demotion is not lossless on this route"))
    return report


def run_prec_checks(entries: Optional[Sequence[CoreEntry]] = None, plan_path: Optional[Path] = None,
                    device: str = "cpu") -> PrecReport:
    """Certify every registered core (or ``entries``) against the committed
    plan (read only). A one-rank world a build function starts is ended."""
    import torch.distributed as dist

    plan_path = Path(plan_path) if plan_path is not None else PLAN_PATH
    entries = list(entries) if entries is not None else collect()
    plan = load_plan(plan_path)
    had_world = dist.is_initialized()
    try:
        reports = [verify_prec_core(e, plan.get(e.name), device=device) for e in entries]
    finally:
        if not had_world and dist.is_initialized():
            from citizensassemblies_tpu_torch.dist import runtime

            runtime.shutdown()
    known = {e.name for e in entries}
    for name in sorted(set(plan) - known):
        reports.append(PrecCoreReport(name=name, path=plan_path.name, line=1, violations=[Violation(
            path=plan_path.name, line=1, col=0, rule="P2", name="stale-plan-entry",
            message=f"[{name}] precision-plan entry has no registered core")]))
    return PrecReport(cores=reports, plan_path=str(plan_path))


def prec_plan_diff(report: PrecReport) -> Dict[str, Any]:
    return {
        "plan_file": report.plan_path,
        "cores": {r.name: {
            "status": "PASS" if r.ok else "FAIL",
            "classes": r.analysis.classes if r.analysis else None,
            "n_vars": r.analysis.n_vars if r.analysis else None,
            "certified_demote": r.certified_jax, "plan_demote": r.plan_demote,
            "out_rel_bound": r.analysis.out_rel if r.analysis else None,
        } for r in report.cores},
    }


def render_prec_report(report: PrecReport) -> str:
    lines = [v.render() for v in report.violations]
    for rep in sorted(report.cores, key=lambda r: r.name):
        extra = ""
        if rep.analysis is not None:
            c = rep.analysis.classes
            extra = (f" (bf16_safe={c['bf16_safe']} f32_required={c['f32_required']} "
                     f"f64_cert={c['f64_cert']}, demote {rep.certified_jax})")
        lines.append(f"{rep.path}:{rep.line}: {'PASS' if rep.ok else 'FAIL'} [{rep.name}]{extra}")
    n_fail = sum(1 for r in report.cores if not r.ok)
    n_dem = sum(1 for r in report.cores if r.certified_jax)
    lines.append(f"prec: {len(report.cores)} core(s) certified, {n_dem} demoted, {n_fail} failing, "
                 f"plan={report.plan_path}")
    return "\n".join(lines)


def prec_report_as_json(report: PrecReport) -> Dict[str, Any]:
    return {
        "schema_version": 1, "pass": "prec", "ok": report.ok, "plan": report.plan_path,
        "cores": [{"core": r.name, "path": r.path, "line": r.line,
                   "status": "PASS" if r.ok else "FAIL",
                   "classes": r.analysis.classes if r.analysis else None,
                   "demote_args": r.certified_jax, "plan_demote": r.plan_demote}
                  for r in sorted(report.cores, key=lambda r: r.name)],
        "violations": [dataclasses.asdict(v) for v in report.violations],
    }
