"""The harness finds a configuration, a cell, a traffic mix and a metric by
name, from files and ``BENCHMARK.json`` entries a later change adds, without
editing any file that is there; and a run whose timed path is broken
underneath comes out ``correct: false``. On the CPU at small sizes: the
harness's own look for a card is the only part these tests skip."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TINY_REGISTRY = {"name": "tiny_registry", "pool": {"generator": "registry", "n": 3000,
                 "sizes": [2, 7, 12, 4, 3], "quota_slack": 0.08},
                 "checks": {"legacy": {"panel_mismatch": 0, "draws_gap": 0, "alloc_gap": 0}}}
TINY_POOL = {"name": "tiny_pool", "pool": {"generator": "skewed", "n": 120, "k": 15,
             "sizes": [3, 3, 3], "quota_slack": 0.12, "skew": 0.4}}
TRAFFIC = {
    "tiny_draws": {"request": "legacy", "entry": "sample_feasible_panels", "num": 200,
                   "warm_panels": 64, "judged": 1,
                   "program_config": {"mc_batch": 256, "mc_max_resample_rounds": 2}},
    "tiny_estimate": {"request": "legacy", "entry": "legacy_probabilities", "num": 100,
                      "warm_panels": 64, "judged": 1,
                      "program_config": {"mc_batch": 64, "mc_max_resample_rounds": 2}},
    "tiny_estimate_pair": {"request": "legacy", "entry": "legacy_probabilities", "num": 100,
                           "warm_panels": 64, "judged": 2, "clients": 2,
                           "program_config": {"mc_batch": 64, "mc_max_resample_rounds": 2}},
}
CELLS = {"tiny_registry.draws": ("tiny_registry", "tiny_draws"),
         "tiny_pool.estimate": ("tiny_pool", "tiny_estimate"),
         "tiny_pool.estimate_pair": ("tiny_pool", "tiny_estimate_pair")}
ESTIMATE_PER_LAYER = [
    ("sampler.step_ms.estimate", "ms", "lower", "host_clock", "sampler"),
    ("sampler.accept_pct.estimate", "%", "higher", "program_counter", "sampler"),
    ("device_idle_pct.estimate", "%", "lower", "device_trace", "device"),
]
METRIC = '''"""A throwaway metric: the panels handed back in the window."""


def read(run):
    return float(sum(r["kept"] for r in run.records))
'''


def digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A copy of the benchmark with the throwaway files and entries added."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root)
    shipped = json.loads((root / "BENCHMARK.json").read_text())
    sf_e = json.loads((ROOT / "portbench" / "configs" / "sf_e_110.json").read_text())
    (root / "portbench" / "configs" / "tiny_registry.json").write_text(json.dumps(TINY_REGISTRY))
    (root / "portbench" / "configs" / "tiny_pool.json").write_text(
        json.dumps(dict(TINY_POOL, checks=sf_e["checks"])))
    for name, body in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(body))
    (root / "portbench" / "metrics" / "throwaway.panels_total.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += [{"name": c, "source": "test", "file": f"portbench/configs/{c}.json",
                          "reduced": [], "why": "test"} for c in ("tiny_registry", "tiny_pool")]
    bench["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                           for n, (c, t) in CELLS.items()]
    bench["end_to_end"].append({"name": "throwaway.panels_total", "unit": "panels",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny_registry.draws"]})
    # the tiny registry cell reports what the shipped registry cell reports;
    # the tiny estimator cell gets metrics of its own, read by the formulas'
    # files that are there
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nationwide_100k.legacy_draws" in m.get("workloads", ()):
            m["workloads"] += ["tiny_registry.draws"]
    bench["end_to_end"].append({"name": "panels_per_s.estimate", "unit": "panels/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny_pool.estimate"]})
    bench["per_layer"] += [{"name": name, "unit": unit, "better": better, "source": source,
                            "layer": layer, "moves": "panels_per_s.estimate",
                            "workloads": ["tiny_pool.estimate"]}
                           for name, unit, better, source, layer in ESTIMATE_PER_LAYER]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root, before, shipped


def test_the_harness_finds_added_files_without_editing_any(layout):
    root, before, shipped = layout
    code = ("import json, sys\nfrom portbench import run as R\n"
            "res, run = R.run_cell(R.Cell('tiny_registry.draws'), 2**33 + 5, 0.5, False, "
            "device='cpu')\nprint(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600, env={"PYTHONPATH": f"{root}:{ROOT}",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"panels_per_s", "setup_s", "throwaway.panels_total"}
    assert result["metrics"]["throwaway.panels_total"]["value"] == 200.0 * result["attempted"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert [e["name"] for e in bench[key][:len(shipped[key])]] == \
            [e["name"] for e in shipped[key]]
    # every file that was there is as it was; BENCHMARK.json only gained entries
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}


def run_tiny(layout, cell, seed=2**35 + 1, seconds=0.5, trace=False, with_run=False):
    from portbench import run as R

    root = layout[0]
    result, run = R.run_cell(R.Cell(cell, root=root), seed, seconds, trace, device="cpu")
    return (result, run) if with_run else result


def test_a_metric_without_a_file_of_its_own_is_read_by_its_formulas_file(layout):
    """``device_idle_pct.estimate`` has no file: ``device_idle_pct.py``
    reads it; a metric with a file of its own is read by that file."""
    from portbench import run as R

    cell = R.Cell("tiny_pool.estimate", root=layout[0])
    assert cell.reader("device_idle_pct.estimate").__module__ == "portbench_metric_device_idle_pct"
    assert cell.reader("sampler.step_ms.a.b").__module__ == "portbench_metric_sampler.step_ms"
    assert cell.reader("throwaway.panels_total").__module__ == \
        "portbench_metric_throwaway.panels_total"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_unbroken_run_is_correct(layout, cell):
    assert run_tiny(layout, cell)["correct"] is True


def test_a_traced_run_reports_per_layer_metrics(layout):
    """On the CPU the trace holds no device operation: the shape of the
    result is what is checked here, and that the sampler's seconds are the
    sampler's alone, without the estimator's pair matrix after it."""
    from citizensassemblies_tpu_torch.models import legacy

    collect = legacy.sample_feasible_panels
    result, run = run_tiny(layout, "tiny_pool.estimate", trace=True, with_run=True)
    assert legacy.sample_feasible_panels is collect
    assert result["correct"] is True
    assert set(result["metrics"]) == {"sampler.step_ms.estimate", "sampler.accept_pct.estimate",
                                      "device_idle_pct.estimate"}
    assert "panels_per_s.estimate" not in result["metrics"]
    assert all(0 < r["sampler_s"] < r["seconds"] for r in run.records)
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_two_clients_in_closed_loops_each_time_their_own_sampler_calls(layout):
    result, run = run_tiny(layout, "tiny_pool.estimate_pair", trace=True, with_run=True)
    assert result["correct"] is True
    assert {r["client"] for r in run.records} == {0, 1}
    assert all(0 < r["sampler_s"] < r["seconds"] for r in run.records)


def test_an_untraced_run_does_not_time_the_sampler(layout):
    result, run = run_tiny(layout, "tiny_pool.estimate", with_run=True)
    assert set(result["metrics"]) == {"panels_per_s.estimate", "setup_s"}
    assert not any("sampler_s" in r for r in run.records)


def _state_unchanged(monkeypatch):
    from citizensassemblies_tpu_torch.models import legacy

    step = legacy._sample_step

    def frozen(A_f32, A_T_f32, qmin, qmax, n, state, noise, scores, households):
        _new, person = step(A_f32, A_T_f32, qmin, qmax, n, state, noise, scores, households)
        return state, person

    monkeypatch.setattr(legacy, "_sample_step", frozen)


def _half_the_batch(monkeypatch):
    from citizensassemblies_tpu_torch.models import legacy

    draw = legacy.sample_panels_batch

    def half(dense, generator, batch, *args, **kwargs):
        panels, ok = draw(dense, generator, batch, *args, **kwargs)
        ok = ok.clone()
        ok[batch // 2:] = False
        return panels, ok

    monkeypatch.setattr(legacy, "sample_panels_batch", half)


def _panel_altered(monkeypatch):
    from citizensassemblies_tpu_torch.models import legacy

    collect = legacy.sample_feasible_panels

    def altered(dense, num, *args, **kwargs):
        panels, draws = collect(dense, num, *args, **kwargs)
        panels = panels.copy()
        panels[0, 0] = (panels[0, 0] + 1) % dense.n
        return panels, draws

    monkeypatch.setattr(legacy, "sample_feasible_panels", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_registry.draws", _state_unchanged),
    ("tiny_registry.draws", _half_the_batch),
    ("tiny_registry.draws", _panel_altered),
    ("tiny_pool.estimate", _state_unchanged),
    ("tiny_pool.estimate", _half_the_batch),
    ("tiny_pool.estimate", _panel_altered),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(layout, monkeypatch, cell, fault):
    """The fault goes in once set-up is done, under the measured window."""
    from portbench import run as R

    window = R.Run.window

    def broken_window(run):
        fault(monkeypatch)
        window(run)

    monkeypatch.setattr(R.Run, "window", broken_window)
    result = run_tiny(layout, cell)
    assert result["correct"] is False, result["checks"]
