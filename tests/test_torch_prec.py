"""The port's precision pass (P1) on the CPU.

The error-flow walk over each registered core's aten trace certifies the
demotions the committed ``PRECISION_PLAN.json`` applies (the JAX package's
certifier wrote it; the port's runtime reads it): the certified sets are
equal core by core, and with the certified arguments at bf16 every core's
result is bit for bit its float32 result. The transfer functions agree
with the JAX certifier's on the same intervals, and planted faults (a
refused nomination, a plan that claims more, a lossy demotion) fail by
name.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from citizensassemblies_tpu.lint import prec as jax_prec
from citizensassemblies_tpu_torch.lint import prec
from citizensassemblies_tpu_torch.lint.registry import CoreEntry, IRCase

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def report():
    torch.set_num_threads(1)
    return prec.run_prec_checks(device="cpu")


def test_certified_sets_equal_the_committed_plan(report):
    assert report.ok, prec.render_prec_report(report)
    plan = json.loads((REPO / "PRECISION_PLAN.json").read_text())["cores"]
    certified = {r.name: r.certified_jax for r in report.cores}
    assert set(certified) == set(plan)
    for name, entry in plan.items():
        assert certified[name] == sorted(entry["demote_args"]), name
    # three of the plan's demotions, and its 11 demoted cores
    assert certified["lp_pdhg.pdhg_core"] == [1, 3]
    assert certified["kernels.pdhg_megakernel_two_sided"] == [1]
    assert certified["qp.l2_fused_core"] == [0]
    assert sum(1 for v in certified.values() if v) == 11


def test_every_core_is_classified(report):
    for r in report.cores:
        c = r.analysis.classes
        assert sum(c.values()) == r.analysis.n_vars > 0 or r.name == "face_decompose.move_screen"
        assert c["f64_cert"] == 0, r.name
    demoted = {r.name for r in report.cores if r.certified_jax}
    # a demoted operand reaches only float32 arithmetic: nothing derived from it
    # stays bf16 past its first product, so few values of a walk are bf16-safe
    for r in report.cores:
        if r.name in demoted:
            assert r.analysis.classes["f32_required"] > r.analysis.classes["bf16_safe"]


_A = (0.0, 3.0, 0.0, True)
_B = (-2.0, 5.0, 2.0 ** -24, False)
_C = (1.0, 4.0, 1e-6, False)


@pytest.mark.parametrize("op,args", [
    ("add", (_A, _A)), ("add", (_A, _B)), ("add", (_C, _C)), ("sub", (_A, _C)),
    ("mul", (_A, _A)), ("mul", (_B, _C)), ("div", (_A, _C)), ("div", (_C, _B)),
    ("neg", (_B,)), ("abs", (_B,)), ("sqrt", (_C,)), ("maximum", (_A, _C)),
])
def test_transfer_matches_the_jax_certifier(op, args):
    port_in = [prec.AbsVal(*a) for a in args]
    jax_in = [jax_prec.AbsVal(*a) for a in args]
    got = prec.transfer(op, port_in, 1)
    if op in ("add", "sub"):
        want = jax_prec._add(jax_in[0], jax_in[1], sub=op == "sub")
    elif op == "mul":
        want = jax_prec._mul(*jax_in)
    elif op == "div":
        want = jax_prec._div(*jax_in)
    else:
        class Eqn:  # the fields of a jaxpr equation the transfer reads
            primitive = type("P", (), {"name": "max" if op == "maximum" else op})()
            params = {}
        want = jax_prec._transfer(Eqn, jax_in)
    for field in ("lo", "hi", "rel", "exact"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g == w) or (isinstance(g, float) and math.isclose(g, w, rel_tol=1e-12)), (field, g, w)


@pytest.mark.parametrize("n", [1, 8, 64])
def test_sum_transfer_matches_the_jax_certifier(n):
    got = prec.transfer("sum", [prec.AbsVal(*_C)], n)
    want = jax_prec._reduce_sum_like(jax_prec.AbsVal(*_C), n)
    assert (got.lo, got.hi, got.exact) == (want.lo, want.hi, want.exact)
    # the same bound; the JAX certifier multiplies its (1 + eps) factors one
    # by one, the port raises to the power: the last digits differ
    assert math.isclose(got.rel, want.rel, rel_tol=1e-6)
    assert math.isinf(prec.transfer("sum", [prec.AbsVal(*_B)], n).rel)


# --- planted faults -------------------------------------------------------------------


def _entry(fn, args, **kw):
    return CoreEntry(name="lp_pdhg.pdhg_core", path="fixture.py", line=1,
                     build=lambda device="cpu": IRCase(fn=fn, args=args, **kw))


def _rules(rep):
    return {(v.rule, v.name) for v in rep.violations if "[lp_pdhg.pdhg_core]" in v.message}


def _plan(tmp_path, demote):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"cores": {"lp_pdhg.pdhg_core": {"demote_args": demote}}}))
    return path


def test_refused_nomination_and_plan_mismatch(tmp_path):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    inexact = _entry(lambda a, b: a @ b, (x, x.t()), arg_ranges=((0.0, 1.0, False), None),
                     prec_demote=(0,))
    rep = prec.run_prec_checks([inexact], plan_path=_plan(tmp_path, [0]))
    assert ("P1", "uncertified-demotion") in _rules(rep)
    assert ("P2", "plan-mismatch") in _rules(rep)
    exact = _entry(lambda a, b: a.float() @ b, (x, x.t()), arg_ranges=((0.0, 256.0, True), None),
                   prec_demote=(0,))
    assert prec.run_prec_checks([exact], plan_path=_plan(tmp_path, [0])).ok
    assert ("P2", "plan-mismatch") in _rules(prec.run_prec_checks([exact], plan_path=_plan(tmp_path, [])))


def test_lossy_demotion_fails(tmp_path):
    x = torch.full((4,), 0.1)
    # a range wrongly declared exact: the bf16 copy of 0.1 is not 0.1
    lying = _entry(lambda a: a * 3.0, (x,), arg_ranges=((0.0, 1.0, True),), prec_demote=(0,))
    rep = prec.run_prec_checks([lying], plan_path=_plan(tmp_path, [0]))
    assert ("P3", "lossy-demotion") in _rules(rep)


def test_jax_argument_order_mapping(tmp_path):
    x = torch.ones(3)
    mapped = _entry(lambda idx, val: val * 2.0, (x.int(), x), arg_ranges=(None, (0.0, 256.0, True)),
                    prec_demote=(1,), jax_args=(None, 0))
    rep = prec.run_prec_checks([mapped], plan_path=_plan(tmp_path, [0]))
    assert rep.ok and rep.cores[0].certified_jax == [0]


def test_cli_prec_json(tmp_path, capsys, monkeypatch):
    from citizensassemblies_tpu_torch.lint import cli

    x = torch.ones(3)
    monkeypatch.setattr(prec, "collect", lambda: [_entry(lambda a: a * 2.0, (x,))])
    diff = tmp_path / "d.json"
    assert cli.main(["--prec", "--device", "cpu", "--prec-plan", str(_plan(tmp_path, [])),
                     "--format", "json", "--diff-out", str(diff)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["pass"] == "prec" and doc["ok"] is True
    assert json.loads(diff.read_text())["cores"]["lp_pdhg.pdhg_core"]["certified_demote"] == []
