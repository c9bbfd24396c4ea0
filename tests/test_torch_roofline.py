"""The port's roofline join and trend gate against the JAX package's.

* ``obs/trend.py`` is a stdlib copy: ``collect_series`` and ``trend_gate``
  give the JAX module's results on the committed ``BENCH_*.json`` files
  (the JAX package's rounds, a parity fixture only) and on tmp fixtures
  with an injected 2× regression, truncated tails and the loader's edge
  cases (the cases of ``tests/test_obs.py:298-344`` and ``:636``);
* ``obs/roofline.roofline_join`` on the same spans and a cost table equal
  to a budget JSON that the JAX join loads gives the same rows, misses,
  ``unexecuted`` and verdicts (``tests/test_obs.py:445-473``);
* the three kernels' cost functions are the bounds ``chip_smoke.py``
  reports for them (the formulas pinned here as numbers), the card's
  constants give the ridge ``Config.obs_roofline_ridge`` holds, and every
  dispatch span a CPU LEXIMIN run fires joins without a miss.
"""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.obs.roofline import roofline_join as j_roofline_join
from citizensassemblies_tpu.obs.trace import Tracer as JTracer
from citizensassemblies_tpu.obs.trend import collect_series as j_collect_series
from citizensassemblies_tpu.obs.trend import trend_gate as j_trend_gate

from citizensassemblies_tpu_torch.obs import roofline
from citizensassemblies_tpu_torch.obs.trace import Tracer
from citizensassemblies_tpu_torch.obs.trend import collect_series, trend_gate
from citizensassemblies_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]


def _same_report(a, b):
    assert a.as_json() == b.as_json()
    assert a.ok == b.ok and [r.name for r in a.failures] == [r.name for r in b.failures]


# --- trend gate ------------------------------------------------------------------


def test_trend_equals_jax_on_committed_series():
    assert collect_series(REPO_ROOT) == j_collect_series(REPO_ROOT)
    _same_report(trend_gate(REPO_ROOT), j_trend_gate(REPO_ROOT))
    for tol in (1.1, 1.75, 3.0):
        _same_report(trend_gate(REPO_ROOT, tol=tol), j_trend_gate(REPO_ROOT, tol=tol))
    assert default_config().obs_trend_tol == 1.75


def test_trend_flags_injected_regression_like_jax(tmp_path):
    for pattern in ("BENCH_r*.json", "BENCH_serve_r*.json"):
        for f in REPO_ROOT.glob(pattern):
            shutil.copy(f, tmp_path / f.name)
    _same_report(trend_gate(tmp_path), j_trend_gate(tmp_path))
    series, rounds = collect_series(tmp_path)
    nxt = max(rounds) + 1
    slowed = {name: pts[-1][1] * 2.0 for name, pts in series.items() if pts and pts[-1][1] >= 1.0}
    assert slowed
    tail = json.dumps({name: {"seconds": v} for name, v in slowed.items()})
    (tmp_path / f"BENCH_r{nxt:02d}.json").write_text(
        json.dumps({"n": nxt, "cmd": "synthetic", "rc": 0, "tail": tail, "parsed": None})
    )
    report = trend_gate(tmp_path)
    assert not report.ok and report.failures
    _same_report(report, j_trend_gate(tmp_path))


def test_trend_recovers_truncated_tails_like_jax(tmp_path):
    series, rounds = collect_series(REPO_ROOT)
    assert {3, 4, 5}.issubset(set(rounds))
    # a tail cut mid-JSON: the regex recovery keeps the whole rows before it
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({
        "n": 1, "rc": 0, "parsed": None,
        "tail": '{"detail": {"row_a": {"seconds": 2.5}, "row_b": {"seconds": 4.0}, "row_c": {"sec',
    }))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps({
        "n": 2, "rc": 0, "parsed": None, "tail": '"row_a": {"seconds": 9.0}, "row_b": {"seco',
    }))
    assert collect_series(tmp_path) == j_collect_series(tmp_path)
    _same_report(trend_gate(tmp_path), j_trend_gate(tmp_path))
    assert [r.name for r in trend_gate(tmp_path).failures] == ["row_a"]


def test_trend_loader_edge_cases_like_jax(tmp_path):
    assert collect_series(tmp_path) == ({}, []) == j_collect_series(tmp_path)
    (tmp_path / "BENCH_kernels_r01.json").write_text(
        json.dumps({"detail": {"kern_row": {"seconds": 5.0}}})
    )
    (tmp_path / "BENCH_kernels_r02.json").write_text("{ not json")
    (tmp_path / "BENCH_kernels_r03.json").write_text(
        json.dumps({"detail": {"bad row name!": {"seconds": "nan"}}})
    )
    (tmp_path / "ROOFLINE_r04.json").write_text(json.dumps({
        "detail": {"roofline_lp_core": {"seconds": 3.0}, "kern_row": {"seconds": 5.5}}
    }))
    (tmp_path / "ROOFLINE_r05.json").write_text(
        json.dumps({"detail": {"roofline_lp_core": {"seconds": 6.5}}})
    )
    assert collect_series(tmp_path) == j_collect_series(tmp_path)
    _same_report(trend_gate(tmp_path), j_trend_gate(tmp_path))
    assert [r.name for r in trend_gate(tmp_path).failures] == ["roofline_lp_core"]


# --- roofline join -----------------------------------------------------------------


def _budget(tmp_path):
    cores = {
        "lp.core": {"bytes": 1.0e6, "flops": 4.0e6, "prims": {}},
        "hot.core": {"bytes": 1.0e3, "flops": 5.0e4, "prims": {}},
        "never.fired": {"bytes": 1.0, "flops": 1.0, "prims": {}},
    }
    path = tmp_path / "budget.json"
    path.write_text(json.dumps({
        "_meta": {"generated_by": "test", "jax": "0", "tolerance": 0.25}, "cores": cores,
    }))
    return path, {name: {"flops": c["flops"], "bytes": c["bytes"]} for name, c in cores.items()}


def _spans(tracer, durations):
    for name, dur, sampled in durations:
        sp = tracer.begin(name, kind="dispatch", sampled=sampled)
        sp.t1 = sp.t0 + dur
        tracer.end(sp)
    with tracer.span("not.a.dispatch", kind="phase"):
        pass


@pytest.mark.parametrize("ridge", [1.0, 10.0, 20.0, 80.0])
def test_roofline_join_equals_jax(tmp_path, ridge):
    path, costs = _budget(tmp_path)
    spans = [("lp.core", 0.01, True), ("lp.core", 0.02, True), ("hot.core", 0.003, False),
             ("rogue.core", 0.001, True)]
    tr, jtr = Tracer(name="t"), JTracer(name="t")
    _spans(tr, spans)
    _spans(jtr, spans)
    mine = roofline.roofline_join([tr], costs=costs, ridge=ridge)
    theirs = j_roofline_join([jtr], budget_path=path, ridge=ridge)
    assert mine.misses == theirs.misses == ["rogue.core"]
    assert mine.unexecuted == theirs.unexecuted == ["never.fired"]
    assert not mine.ok and not theirs.ok
    for a, b in zip(mine.rows, theirs.rows):
        assert a.core == b.core and a.calls == b.calls and a.bound == b.bound
        assert a.sampled == b.sampled and a.flops == b.flops and a.bytes == b.bytes
        assert a.intensity_flops_per_byte == b.intensity_flops_per_byte
        assert a.seconds == pytest.approx(b.seconds, abs=1e-6)
        assert a.achieved_gflops_s == pytest.approx(b.achieved_gflops_s, rel=1e-3)
        assert a.achieved_gbytes_s == pytest.approx(b.achieved_gbytes_s, rel=1e-3)
    assert len(mine.rows) == len(theirs.rows) == 2
    assert mine.trend_detail().keys() == theirs.trend_detail().keys()
    doc, jdoc = mine.as_json(), theirs.as_json()
    assert set(doc) == set(jdoc) and doc["misses"] == jdoc["misses"]
    assert set(doc["rows"]["lp.core"]) == set(jdoc["rows"]["lp.core"])


def test_roofline_measured_row_rates_and_shares():
    tr = Tracer(name="synthetic")
    for _ in range(2):
        with tr.span("kernels.ell_gather", kind="dispatch", sampled=True, cols=6144, kp=112,
                     T=814, lanes=1, value_bytes=4, lane_values=False):
            time.sleep(0.005)
    report = roofline.roofline_join([tr])
    assert report.ok and report.misses == []
    (row,) = report.rows
    cost = roofline.gather_cost(6144, 112, 814)
    assert row.flops == cost.flops and row.bytes == cost.bytes and row.calls == 2
    shares = row.peak_shares()
    assert 0.0 < shares["hbm"] <= 1.0 and 0.0 < shares["f32"] <= 1.0
    assert row.bound == "bytes-bound"  # 0.25 FLOP/B under the card's ridge
    assert "kernels.pdhg_megakernel_lp" in report.unexecuted


def test_card_constants_and_ridge():
    assert roofline.HBM_BYTES_PER_S == 3.35e12 and roofline.F32_FLOPS_PER_S == 67e12
    ridge = roofline.F32_FLOPS_PER_S / roofline.HBM_BYTES_PER_S
    assert ridge == pytest.approx(default_config().obs_roofline_ridge) == 20.0


def test_kernel_costs_are_the_reported_bounds():
    """The bounds ``chip_smoke.py`` has reported for the three kernels
    (its formulas before they moved into the package), at the flagship
    shapes: the gather at C=6144, kp=112, T=814 in float32 and bf16 values;
    the two-sided kernel's three-lane solve; the flagship dual LP."""
    C, kp, T = 6144, 112, 814
    gather = roofline.gather_cost(C, kp, T)
    assert gather.bytes == C * kp * 8 + T * 4 + C * 4 and gather.flops == 2 * C * kp
    assert roofline.gather_cost(C, kp, T, value_bytes=2).bytes == C * kp * 6 + T * 4 + C * 4
    ms, by = roofline.bound(gather)
    assert ms == 1e3 * max(gather.bytes / 3.35e12, gather.flops / 67e12) and by == "bytes"
    nnz, B, iters, ce = 400_000, 3, [1024, 2048, 4096], 128
    two = roofline.two_sided_cost(C, kp, T, nnz, B, iters, ce)
    evals = sum(i + 2 * (i // ce) for i in iters)
    assert two.bytes == C * kp * 4 * (1 + B) + B * (4 * C + 6 * T) * 4
    assert two.flops == evals * (4 * nnz + 10 * (C + 2 * T))
    assert roofline.stream_ms(two) == 1e3 * evals * (C * kp * 8 + nnz * 8) / 3.35e12
    m1, kpl, nv, nnzl, it = 4096, 112, 1728, 450_000, 65_536
    lp = roofline.lp_cost(m1, kpl, nv, nnzl, it)
    ev = it + 2 * (it // 128)
    assert lp.bytes == m1 * kpl * 8 + (4 * nv + 3 * m1 + 2 * nv + 4) * 4
    assert lp.flops == ev * (4 * nnzl + 10 * (nv + m1))
    assert roofline.bound(lp)[1] == "operations"


def test_every_cpu_leximin_dispatch_span_joins():
    """A LEXIMIN run on the CPU with the device routes forced fires the
    port's dispatch spans; each carries the attributes its cost function
    reads, so the join has no miss and every row is finite."""
    from citizensassemblies_tpu_torch.core.generator import skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.obs import use_tracer

    dense, space = featurize(skewed_instance(n=40, k=6, n_categories=3, seed=2), device="cpu")
    tr = Tracer(name="cpu")
    with use_tracer(tr):
        find_distribution_leximin(dense, space, cfg=default_config().replace(lp_batch=True),
                                  device="cpu")
    report = roofline.roofline_join([tr])
    assert report.misses == [] and report.rows
    assert all(np.isfinite(r.flops) and np.isfinite(r.bytes) for r in report.rows)
