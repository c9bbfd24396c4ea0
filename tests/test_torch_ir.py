"""The port's core registry and its IR pass (IR1-IR4) on the CPU.

Every JAX core name has a port counterpart with the JAX registration's
span (the gather's is named after the port's dispatch span), dense twin and
problem shapes; the registry imports no JAX. The IR pass holds every core
against the committed ``lint/analysis_budget.json``, and planted faults (a
host read, a float64 result, a dropped in-place update, a stale or missing
budget entry) each fail by name.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from citizensassemblies_tpu_torch.lint import ir
from citizensassemblies_tpu_torch.lint.registry import CoreEntry, IRCase, collect

REPO = Path(__file__).resolve().parent.parent

#: the port's gather span is its dispatch span's name; every other span is
#: the JAX registration's
SPAN_RENAMES = {"kernels.pallas_ell_matvec": "kernels.ell_gather"}


@pytest.fixture(scope="module")
def jax_entries():
    from citizensassemblies_tpu.lint.registry import collect as jax_collect

    return {e.name: e for e in jax_collect()}


@pytest.fixture(scope="module")
def port_entries():
    return {e.name: e for e in collect()}


def test_every_jax_core_has_a_counterpart(jax_entries, port_entries):
    assert len(jax_entries) == 24
    assert set(port_entries) == set(jax_entries)
    for name, j in jax_entries.items():
        p = port_entries[name]
        assert p.dense_ref == j.dense_ref, name
        assert p.span == SPAN_RENAMES.get(name, j.span), name
        assert (p.span_optout is None) == (j.span_optout is None), name


def test_spmd_registrations_match(port_entries):
    from citizensassemblies_tpu.lint.registry import collect_spmd as jax_collect_spmd
    from citizensassemblies_tpu_torch.lint.registry import collect_spmd

    assert {e.name for e in collect_spmd()} == {e.name for e in jax_collect_spmd()}
    assert len(collect_spmd()) == 4


@pytest.mark.parametrize("name", [
    "lp_pdhg.pdhg_core", "lp_pdhg.pdhg_core_ell", "lp_pdhg.two_sided_core_ell",
    "kernels.pdhg_megakernel_two_sided", "kernels.pdhg_megakernel_lp", "kernels.pallas_ell_matvec",
    "batch_lp.vmapped_core", "qp.l2_dual_ascent", "qp.l2_dual_ascent_ell", "qp.l2_fused_core",
    "qp.l2_fused_core_ell", "delta.screen",
])
def test_port_core_keeps_the_jax_shapes(jax_entries, port_entries, name):
    """Where the port keeps the JAX argument order, every argument has the
    JAX registration's shape, or that shape as one lane of a batch (the
    port's two-sided cores batch their lane vectors; the gather's ``y`` is
    one lane of the problem's T=128, unpadded)."""
    j = jax_entries[name].build()
    p = port_entries[name].build(device="cpu")
    j_shapes = [tuple(getattr(a, "shape", ())) for a in j.args]
    p_shapes = [tuple(getattr(a, "shape", ())) for a in p.args]
    if name == "kernels.pallas_ell_matvec":
        j_shapes[2] = (1, 128)  # the JAX call pads y's minor axis to its block
    assert len(p_shapes) == len(j_shapes)
    for ps, js in zip(p_shapes, j_shapes):
        assert ps in (js, (1,) + js), (ps, js)
    assert tuple(p.prec_demote) == tuple(j.prec_demote)
    if j.arg_ranges is not None:
        assert tuple(p.arg_ranges) == tuple(j.arg_ranges)


def test_registry_imports_no_jax():
    code = (
        "import json, sys\n"
        "from citizensassemblies_tpu_torch.lint.registry import collect, collect_spmd\n"
        "collect(); collect_spmd()\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'citizensassemblies_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_build_functions_run_nothing_at_import():
    code = (
        "import torch\n"
        "from citizensassemblies_tpu_torch.lint.registry import collect\n"
        "collect()\n"
        "import torch.distributed as dist\n"
        "from citizensassemblies_tpu_torch.aot.store import GRAPHS\n"
        "assert not dist.is_initialized() and len(GRAPHS) == 0\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# --- the pass over the real cores ------------------------------------------------------


@pytest.fixture(scope="module")
def ir_report():
    torch.set_num_threads(1)
    return ir.run_ir_checks(device="cpu")


def test_every_core_passes_against_committed_budget(ir_report):
    assert ir_report.ok, ir.render_ir_report(ir_report)
    assert len(ir_report.cores) == 24
    assert all(r.measured is not None for r in ir_report.cores)


def test_kernel_cores_record_their_roofline_bound(ir_report):
    from citizensassemblies_tpu_torch.obs import roofline

    measured = {r.name: r.measured for r in ir_report.cores}
    gather = measured["kernels.pallas_ell_matvec"]
    # the plain gather's FLOPs are the roofline's: a multiply and an add a slot
    assert gather["flops"] == roofline.gather_cost(256, 16, 128).flops == gather["bound"]["flops"]
    for name in ("kernels.pdhg_megakernel_two_sided", "kernels.pdhg_megakernel_lp"):
        m = measured[name]
        assert m["bound"]["formula"].startswith(("two_sided_cost(", "lp_cost("))
        # the plain block plus the prelude does more than the bound's work
        assert m["plain_over_bound_flops"] == round(m["flops"] / m["bound"]["flops"], 4) > 1.0


def test_budget_diff_has_sparse_deltas(ir_report, tmp_path):
    diff = ir.budget_diff(ir_report)
    assert set(diff["sparse_deltas"]) >= {"lp_pdhg.pdhg_core_ell", "qp.l2_fused_core_ell"}
    assert diff["provenance"]["cores"] == 24
    assert all(c["status"] == "PASS" for c in diff["cores"].values())


# --- planted faults -------------------------------------------------------------------


def _entry(name, build):
    return CoreEntry(name=name, path="fixture.py", line=1, build=build)


def _rules(report):
    return {(v.rule, v.name) for v in report.violations}


def _core(fn, *args, **kw):
    return _entry("fixture.core", lambda device="cpu": IRCase(fn=fn, args=args, **kw))


def _clean(x):
    return x * 2.0 + 1.0


@pytest.mark.parametrize("fn,expected", [
    (lambda x: x * float(x.sum().item()), ("IR1", "host-read-in-core")),
    (lambda x: x * bool(x.sum() > 0), ("IR1", "host-read-in-core")),
    (lambda x: x[x > 0], ("IR1", "host-read-in-core")),
    (lambda x: (x.double() * 2).float(), ("IR2", "f64-in-core")),
    (lambda x: x.mul_(2.0), ("IR3", "undeclared-in-place-update")),
], ids=["item", "bool", "mask-index", "float64", "in-place"])
def test_planted_fault_fails_by_name(tmp_path, fn, expected):
    x = torch.arange(8, dtype=torch.float32)
    budget = tmp_path / "b.json"
    report = ir.run_ir_checks([_core(fn, x)], budget_path=budget, update_budget=True)
    assert expected in _rules(report), ir.render_ir_report(report)


def test_dropped_in_place_update_fails(tmp_path):
    x = torch.arange(8, dtype=torch.float32)
    report = ir.run_ir_checks([_core(_clean, x, donate_expected=1)], budget_path=tmp_path / "b.json",
                              update_budget=True)
    assert ("IR3", "dropped-in-place-update") in _rules(report)
    declared = ir.run_ir_checks([_core(lambda t: t.mul_(2.0), torch.ones(3), donate_expected=1)],
                                budget_path=tmp_path / "c.json", update_budget=True)
    assert declared.ok


def test_budget_round_trip_missing_stale_and_regressed(tmp_path):
    budget = tmp_path / "budget.json"
    x = torch.arange(64, dtype=torch.float32)
    assert not ir.run_ir_checks([_core(_clean, x)], budget_path=budget).ok  # missing entry
    updated = ir.run_ir_checks([_core(_clean, x)], budget_path=budget, update_budget=True)
    assert updated.ok and updated.updated
    data = json.loads(budget.read_text())
    assert data["_meta"]["tolerance"] == ir.DEFAULT_TOLERANCE
    assert data["cores"]["fixture.core"]["ops"] == {"aten.add.Tensor": 1, "aten.mul.Tensor": 1}
    assert ir.run_ir_checks([_core(_clean, x)], budget_path=budget).ok
    # a tripled core overruns its FLOPs and op counts
    doubled = ir.run_ir_checks([_core(lambda t: _clean(_clean(_clean(t))), x)], budget_path=budget)
    assert ("IR4", "flops-budget-exceeded") in _rules(doubled)
    assert ("IR4", "op-count-exceeded") in _rules(doubled)
    assert ("IR4", "new-op") in _rules(ir.run_ir_checks([_core(torch.sqrt, x)], budget_path=budget))
    stale = ir.run_ir_checks([_entry("other.core", lambda device="cpu": IRCase(fn=_clean, args=(x,)))],
                             budget_path=budget)
    assert ("IR4", "stale-budget-entry") in _rules(stale)


def test_cli_ir_json_envelope_and_diff(tmp_path, capsys, monkeypatch):
    from citizensassemblies_tpu_torch.lint import cli

    x = torch.arange(8, dtype=torch.float32)
    monkeypatch.setattr(ir, "collect", lambda: [_core(_clean, x)])
    budget, diff = tmp_path / "b.json", tmp_path / "d.json"
    assert cli.main(["--ir", "--device", "cpu", "--budget", str(budget), "--update-budget"]) == 0
    capsys.readouterr()
    assert cli.main(["--ir", "--device", "cpu", "--budget", str(budget), "--format", "json",
                     "--diff-out", str(diff)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema_version"] == 1 and doc["pass"] == "ir" and doc["ok"] is True
    assert json.loads(diff.read_text())["cores"]["fixture.core"]["status"] == "PASS"


# --- the repairs the card's IR1 found --------------------------------------------------


def test_lp_kernel_slots_fill_without_an_element_store():
    """``lp_blocks_cuda`` wrote its scalar slots by element stores of python
    numbers (``scal[i] = x``), each a copy from pageable host memory: a host
    sync inside the LP kernel core, found by the card's armed window. The
    fill writes the same bits."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    values = (("L_RES", float("inf")), ("L_OMEGA", 1.0), ("L_BEST", float("inf")),
              ("L_NORM", torch.tensor(3.25)), ("L_SCALE", torch.tensor(7.0)), ("L_TOL", 1e-6))
    stored = torch.zeros(mk.LP_LAYOUT["L_N"])
    for slot, val in values:
        stored[mk.LP_LAYOUT[slot]] = val
    filled = torch.zeros(mk.LP_LAYOUT["L_N"])
    mk.fill_slots(filled, mk.LP_LAYOUT, values)
    assert torch.equal(stored, filled)


def test_fused_l2_anchor_objective_unchanged():
    """The fused L2 core built its anchor's objective by an element store
    (``c[C] = 1.0``), a host sync in the middle of the core on the card;
    it is built on the device now, the same vector, and the fused core's
    result is unchanged (held against the JAX package in
    ``tests/test_torch_qp.py``)."""
    C = 7
    stored = torch.zeros(C + 1)
    stored[C] = 1.0
    built = torch.cat([torch.zeros(C), torch.ones(1)])
    assert torch.equal(stored, built) and stored.dtype == built.dtype


def test_dropout_tallies_count_exactly():
    """The dropout round's ok and fill tallies were float64 sums on the
    device (R4); they are integer counts, now int64: the rates are exact
    fractions of the draws, as the float64 sums of the same integers were."""
    import numpy as np

    from citizensassemblies_tpu_torch.interop import dense_from_arrays
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.parallel import mc

    P, probs, attend, type_id, A, qmin, qmax = mc._dropout_case(Seeded(51))
    dense = dense_from_arrays(A, qmin, qmax, np.arange(A.shape[1]) // 3, 6, 2, device="cpu")
    draws = 300
    out = mc.dropout_realization_round(P, probs, attend, type_id, dense,
                                       torch.Generator().manual_seed(7), draws, chunk=64)
    ok, filled = out.quota_ok_rate * draws, out.fill_rate * draws * dense.k
    assert ok == round(ok) and filled == round(filled) and 0 < filled <= draws * dense.k
