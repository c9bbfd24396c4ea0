"""The SPMD pass: collective census and placement contracts of the
registered cores.

One process sweeps world sizes 1, 2, 4 and 8 over torch's fake process
group (``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``, a ``(chains, agents)`` device mesh over it): no rank is
spawned. A fake collective leaves its tensors as they are, so each case
runs a fixed number of iterations (a loop run to a tolerance might never
end on sums that are not real) and its values are not checked here. A
``TorchDispatchMode`` counts the ``c10d`` ops each call issues, by kind:

* **S1 collective census**: per core the collectives of its IR build
  (``base``, the one-rank world the IR pass runs on) and of each SPMD
  registration at every swept world size (``mesh1`` … ``mesh8``), ratcheted
  against the port's ``lint/spmd_budget.json`` like IR4: a new kind or a
  larger count fails; ``--update-budget`` rewrites the file.
* **S2 contracts**: (a) collectives inside the iteration loop: each SPMD
  case runs at two loop lengths (``scale`` 1 and 2) and a count that grows
  with the loop is per-iteration communication, a failure unless the
  registration gives a reasoned ``loop_collectives``; (b) each declared
  role (``IRCase.arg_roles``, a ``dist/partition.ROLE_BUILDERS`` key) must be
  the placement the operand really gets: ``dist_partition.place`` and
  ``prepartition`` are observed during the call, and an operand placed
  otherwise, or a sharded role never placed, fails; (c) an undeclared
  operand above ``Config.spmd_replicated_bytes_max`` at a world above one
  rank is an implicitly replicated operand and fails.

The JAX package's ``SPMD_BUDGET.json`` counts collective instructions of
compiled programs; the port counts the collectives a call issues, its
loops unrolled. :func:`jax_comparison` sets the two side by side.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from citizensassemblies_tpu_torch.lint.engine import Violation
from citizensassemblies_tpu_torch.lint.registry import (
    CoreEntry,
    IRCase,
    SpmdEntry,
    collect,
    collect_spmd,
)

#: the port's committed census, beside this module
SPMD_BUDGET_PATH = Path(__file__).resolve().parent / "spmd_budget.json"
#: the JAX package's census (read only)
JAX_SPMD_BUDGET_PATH = Path(__file__).resolve().parent.parent.parent / "SPMD_BUDGET.json"

#: the swept world sizes
MESH_SIZES = (1, 2, 4, 8)

#: c10d op → collective kind (the JAX census's names where they exist)
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather", "scatter_": "scatter",
    "barrier": "barrier",
}


def collective_kind(op_name: str) -> Optional[str]:
    """The kind of a traced ``c10d.<op>`` name, None for a non-collective."""
    if not op_name.startswith("c10d."):
        return None
    base = op_name.split(".")[1]
    return _KINDS.get(base, base)


def census_of(ops: Sequence[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name in ops:
        kind = collective_kind(name)
        if kind is not None:
            out[kind] = out.get(kind, 0) + 1
    return {k: out[k] for k in sorted(out)}


# --- fake worlds --------------------------------------------------------------------


def _fake_mesh(size: int):
    """The ``(chains, agents)`` mesh over a fake world of ``size`` ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from citizensassemblies_tpu_torch.dist.runtime import CHAIN_AXES

    return DeviceMesh("cpu", torch.arange(size).reshape(size, 1), mesh_dim_names=CHAIN_AXES)


@contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in this process (rank 0) and
    its mesh; ended on exit. Raises when a process group already runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is running: the SPMD pass needs its own fake worlds")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(size))
    try:
        yield _fake_mesh(size)
    finally:
        from citizensassemblies_tpu_torch.dist import runtime

        runtime.shutdown()


@contextmanager
def observed_placements():
    """Record the layout of every ``dist_partition.place``/``prepartition``
    call in the scope: yields a list of ``(operand, layout)``."""
    from citizensassemblies_tpu_torch.dist import partition as dp

    seen: List[Tuple[Any, Any]] = []
    place, prepartition = dp.place, dp.prepartition

    def place_rec(x, layout, device=None):
        seen.append((x, layout))
        return place(x, layout, device=device)

    def prepartition_rec(x, layout, log=None, count=True):
        seen.append((x, layout))
        return prepartition(x, layout, log=log, count=count)

    dp.place, dp.prepartition = place_rec, prepartition_rec
    try:
        yield seen
    finally:
        dp.place, dp.prepartition = place, prepartition


def _call_ops(case: IRCase) -> List[str]:
    """The aten/c10d op names one call of ``case`` issues."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    names: List[str] = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            names.append(str(func))
            return func(*a, **(kw or {}))

    with torch.no_grad(), Ops():
        case.run()
    return names


# --- per-core verification ---------------------------------------------------------------


@dataclasses.dataclass
class SpmdCoreReport:
    name: str
    path: str
    line: int
    violations: List[Violation] = dataclasses.field(default_factory=list)
    #: {"base": {kind: n}, "mesh1": {...}, ...}
    census: Optional[Dict[str, Dict[str, int]]] = None
    #: per swept size, the collectives each extra loop iteration issues
    per_iteration: Optional[Dict[str, Dict[str, int]]] = None
    loop_exempt: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclasses.dataclass
class SpmdReport:
    cores: List[SpmdCoreReport]
    budget_path: str
    mesh_sizes: List[int]
    updated: bool = False

    @property
    def violations(self) -> List[Violation]:
        return [v for c in self.cores for v in c.violations]

    @property
    def ok(self) -> bool:
        return not self.violations


def _viol(entry, rule: str, name: str, message: str) -> Violation:
    return Violation(path=entry.path, line=entry.line, col=0, rule=rule, name=name,
                     message=f"[{entry.name}] {message}")


def _replicated_bytes_max() -> int:
    from citizensassemblies_tpu_torch.utils.config import default_config

    return int(default_config().spmd_replicated_bytes_max)


def _nbytes(a) -> int:
    import numpy as np

    nbytes = getattr(a, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    numel = getattr(a, "numel", None)
    if callable(numel):
        return int(numel()) * int(a.element_size())
    return int(np.asarray(a).nbytes)


def _check_placements(entry, report, case: IRCase, mesh, seen, key: str) -> None:
    from citizensassemblies_tpu_torch.dist import partition as dp

    roles = case.arg_roles or (None,) * len(case.args)
    size = int(mesh.size())
    threshold = _replicated_bytes_max()
    for i, (a, role) in enumerate(zip(case.args, roles)):
        if role is None:
            if size > 1 and _nbytes(a) > threshold:
                report.violations.append(_viol(
                    entry, "S2", "implicit-replication",
                    f"argument {i} ({_nbytes(a)} bytes) has no declared dist/partition role at "
                    f"{key}: it is replicated on every rank; declare 'replicated' if that is the "
                    "layout, or shard it"))
            continue
        ndim = len(getattr(a, "shape", ()))
        want = dp._effective(dp.role_layout(mesh, role, ndim).placements, mesh)
        got = [lay for x, lay in seen if x is a]
        if not got:
            if role != "replicated":
                report.violations.append(_viol(
                    entry, "S2", "unplaced-declared-operand",
                    f"argument {i} declares role '{role}' but the call never placed it at {key}"))
            continue
        for lay in got:
            if dp._effective(lay.placements, mesh) != want:
                report.violations.append(_viol(
                    entry, "S2", "placement-contract-mismatch",
                    f"argument {i} declares role '{role}' {want} but is placed {lay.placements} "
                    f"at {key}"))


def _sweep(entry, spmd_entry: SpmdEntry, report: SpmdCoreReport, sizes, device) -> None:
    measured = report.census
    report.per_iteration = {}
    for size in sizes:
        key = f"mesh{size}"
        try:
            counts = []
            with fake_world(size) as mesh:
                for scale in (1, 2):
                    case = spmd_entry.build(mesh, device=device, scale=scale)
                    with observed_placements() as seen:
                        counts.append(census_of(_call_ops(case)))
                    if scale == 1:
                        _check_placements(entry, report, case, mesh, seen, key)
        except Exception as exc:  # noqa: BLE001 - reported, not raised
            report.violations.append(_viol(entry, "S0", "untraceable-core",
                                           f"spmd case failed at {key}: {exc!r}"))
            continue
        measured[key] = counts[0]
        grew = {k: counts[1].get(k, 0) - counts[0].get(k, 0) for k in counts[1]}
        grew = {k: v for k, v in sorted(grew.items()) if v > 0}
        report.per_iteration[key] = grew
        if grew and report.loop_exempt is None:
            report.violations.append(_viol(
                entry, "S2", "collective-in-loop-body",
                f"collective(s) {', '.join(grew)} grow with the iteration loop at {key}: "
                "per-iteration communication; keep collectives at block boundaries, or register "
                "a reasoned loop_collectives= exemption if the per-iteration reduction is the "
                "algorithm"))


def verify_spmd_core(entry: CoreEntry, spmd_entry: Optional[SpmdEntry],
                     budget: Optional[Dict[str, Dict[str, int]]], sizes: Sequence[int],
                     device: str = "cpu") -> SpmdCoreReport:
    """S1-S2 for one core; failures become violations."""
    from citizensassemblies_tpu_torch.lint.ir import trace_case

    report = SpmdCoreReport(name=entry.name, path=entry.path, line=entry.line)
    report.loop_exempt = spmd_entry.loop_collectives if spmd_entry else None
    report.census = {}
    try:
        report.census["base"] = census_of([n for n, *_ in trace_case(entry.build(device="cpu")).ops])
    except Exception as exc:  # noqa: BLE001
        report.violations.append(_viol(entry, "S0", "untraceable-core", f"build failed: {exc!r}"))
        return report
    finally:
        import torch.distributed as dist

        if dist.is_initialized():  # the IR build's one-rank world
            from citizensassemblies_tpu_torch.dist import runtime

            runtime.shutdown()
    if spmd_entry is not None:
        _sweep(entry, spmd_entry, report, sizes, "cpu")
    measured = report.census
    if budget is None:
        report.violations.append(_viol(
            entry, "S1", "missing-budget",
            "no entry in the SPMD budget: run 'python -m citizensassemblies_tpu_torch.lint --spmd "
            "--update-budget --device cpu' and commit the result"))
        return report
    for key, census in sorted(measured.items()):
        allowed = budget.get(key)
        if allowed is None:
            report.violations.append(_viol(entry, "S1", "missing-budget",
                                           f"no budgeted census for {key}"))
            continue
        for op, count in sorted(census.items()):
            if op not in allowed:
                report.violations.append(_viol(
                    entry, "S1", "new-collective",
                    f"collective '{op}' ({count}x) at {key} is new to this core"))
            elif count > int(allowed[op]):
                report.violations.append(_viol(
                    entry, "S1", "collective-count-exceeded",
                    f"collective '{op}' count regressed at {key}: {count} > budgeted {allowed[op]}"))
    return report


# --- budget file -------------------------------------------------------------------------


def load_spmd_budget(path: Path) -> Dict[str, Any]:
    if not path.exists():
        return {}
    return dict(json.loads(path.read_text(encoding="utf-8")).get("cores", {}))


def write_spmd_budget(path: Path, reports: Sequence[SpmdCoreReport], sizes: Sequence[int]) -> None:
    import torch

    data = {
        "_meta": {
            "torch": torch.__version__.split("+")[0],
            "mesh_sizes": list(sizes),
            "generated_by": "python -m citizensassemblies_tpu_torch.lint --spmd --update-budget --device cpu",
        },
        "cores": {r.name: r.census for r in reports if r.census is not None},
    }
    path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n", encoding="utf-8")


def spmd_budget_provenance(path: Optional[Path] = None) -> Dict[str, Any]:
    path = path or SPMD_BUDGET_PATH
    if not path.exists():
        return {"file": path.name, "missing": True}
    raw = path.read_bytes()
    data = json.loads(raw.decode("utf-8"))
    return {"file": path.name, "sha256": hashlib.sha256(raw).hexdigest()[:12],
            "cores": len(data.get("cores", {})), "mesh_sizes": data.get("_meta", {}).get("mesh_sizes")}


# --- the pass ----------------------------------------------------------------------------


def run_spmd_checks(entries: Optional[Sequence[CoreEntry]] = None,
                    spmd_entries: Optional[Sequence[SpmdEntry]] = None,
                    budget_path: Optional[Path] = None, update_budget: bool = False,
                    mesh_sizes: Optional[Sequence[int]] = None, device: str = "cpu") -> SpmdReport:
    """Census every registered core (or ``entries``), sweeping the SPMD
    registrations over ``mesh_sizes``. The traces are of CPU tensors over
    fake groups whatever ``device`` says. ``update_budget`` rewrites the
    budget (S1 findings dropped; S0/S2 still fail)."""
    budget_path = Path(budget_path) if budget_path is not None else SPMD_BUDGET_PATH
    entries = list(entries) if entries is not None else collect()
    spmd_by_name = {e.name: e for e in (spmd_entries if spmd_entries is not None else collect_spmd())}
    sizes = list(mesh_sizes) if mesh_sizes is not None else list(MESH_SIZES)
    budgets = load_spmd_budget(budget_path)
    reports = [verify_spmd_core(e, spmd_by_name.get(e.name), budgets.get(e.name), sizes, device)
               for e in entries]
    if update_budget:
        write_spmd_budget(budget_path, reports, sizes)
        for rep in reports:
            rep.violations = [v for v in rep.violations if v.rule != "S1"]
    else:
        known = {e.name for e in entries}
        for name in sorted(set(budgets) - known):
            reports.append(SpmdCoreReport(name=name, path=budget_path.name, line=1, violations=[Violation(
                path=budget_path.name, line=1, col=0, rule="S1", name="stale-budget-entry",
                message=f"[{name}] SPMD budget entry has no registered core: remove it via --update-budget",
            )]))
    return SpmdReport(cores=reports, budget_path=str(budget_path), mesh_sizes=sizes,
                      updated=update_budget)


def jax_comparison(report: SpmdReport, path: Optional[Path] = None) -> Dict[str, Any]:
    """Per core and size key, the JAX package's compiled collective count
    beside the port's issued count (only where either is nonzero)."""
    jax = load_spmd_budget(path or JAX_SPMD_BUDGET_PATH)
    out: Dict[str, Any] = {}
    for rep in report.cores:
        if rep.census is None:
            continue
        rows = {}
        for key in sorted(set(rep.census) | set(jax.get(rep.name, {}))):
            j, p = jax.get(rep.name, {}).get(key, {}), rep.census.get(key, {})
            if j or p:
                rows[key] = {"jax": j, "port": p}
        if rows:
            out[rep.name] = rows
    return out


def spmd_budget_diff(report: SpmdReport) -> Dict[str, Any]:
    budgets = load_spmd_budget(Path(report.budget_path))
    cores: Dict[str, Any] = {}
    for rep in report.cores:
        entry: Dict[str, Any] = {"status": "PASS" if rep.ok else "FAIL"}
        if rep.census is not None:
            entry["measured"] = rep.census
            if rep.per_iteration:
                entry["per_iteration"] = rep.per_iteration
            if budgets.get(rep.name):
                entry["budget"] = budgets[rep.name]
        cores[rep.name] = entry
    return {"budget_file": report.budget_path, "mesh_sizes": report.mesh_sizes,
            "provenance": spmd_budget_provenance(Path(report.budget_path)),
            "jax_comparison": jax_comparison(report), "cores": cores}


def render_spmd_report(report: SpmdReport) -> str:
    lines = [v.render() for v in report.violations]
    for rep in sorted(report.cores, key=lambda r: r.name):
        extra = ""
        if rep.census is not None:
            total = sum(sum(c.values()) for c in rep.census.values())
            extra = f" (collectives={total} over {len(rep.census)} build(s))"
        lines.append(f"{rep.path}:{rep.line}: {'PASS' if rep.ok else 'FAIL'} [{rep.name}]{extra}")
    n_fail = sum(1 for r in report.cores if not r.ok)
    lines.append(f"spmd: {len(report.cores)} core(s) verified at world sizes {report.mesh_sizes}, "
                 f"{n_fail} failing, budget={report.budget_path}" + (" (updated)" if report.updated else ""))
    return "\n".join(lines)


def spmd_report_as_json(report: SpmdReport) -> Dict[str, Any]:
    return {
        "schema_version": 1, "pass": "spmd", "ok": report.ok, "budget": report.budget_path,
        "mesh_sizes": report.mesh_sizes, "updated": report.updated,
        "cores": [{"core": r.name, "path": r.path, "line": r.line,
                   "status": "PASS" if r.ok else "FAIL", "census": r.census,
                   "per_iteration": r.per_iteration}
                  for r in sorted(report.cores, key=lambda r: r.name)],
        "violations": [dataclasses.asdict(v) for v in report.violations],
    }
