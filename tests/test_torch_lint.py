"""The port's lint package, AST side: the engine and its rules against the
JAX package's.

The engine and the stdlib rules (R0 suppression hygiene, R6, R7, R9, R11)
get the same fixture sources in both packages and must report the same
findings (rule, path, line, name). The torch rules (R1-R5, R10, R12, R13)
are held on pairs: a JAX fixture and its torch twin with the offence on
the same line must draw the same rule id there. Then the port's own
package lints clean, every suppression with a reason, and the CLI keeps
the JAX package's exit codes and JSON envelope.
"""

import json
from pathlib import Path

import pytest

from citizensassemblies_tpu.lint import lint_paths as jax_lint_paths
from citizensassemblies_tpu_torch.lint import lint_paths, render_report
from citizensassemblies_tpu_torch.lint.cli import main as lint_main

REPO = Path(__file__).resolve().parent.parent


def _write(root: Path, sources: dict, readme=None):
    for rel, src in sources.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src, encoding="utf-8")
    if readme is None:
        return None
    path = root / "README.md"
    path.write_text(readme, encoding="utf-8")
    return path


def _findings(report, root: Path):
    return sorted((v.rule, v.path.replace(f"{root}/", ""), v.line, v.name) for v in report.violations)


# --- the same fixtures through both engines -----------------------------------------

_CONFIG = (
    "import dataclasses\n"
    "\n"
    "@dataclasses.dataclass(frozen=True)\n"
    "class Config:\n"
    "    live_knob: int = 1\n"
    "    dead_knob: int = 2\n"
    "    undocumented: int = 3\n"
)

SHARED = {
    "r6_dead_and_undocumented": (
        {"pkg/utils/config.py": _CONFIG,
         "pkg/solver.py": "def use(cfg):\n    return cfg.live_knob + cfg.undocumented\n"},
        "Documented: `live_knob`, dead_knob.\n",
    ),
    "r7_unlocked_worker_write": (
        {"mod.py": (
            "from concurrent.futures import ThreadPoolExecutor\n"
            "\n"
            "_RESULTS = {}\n"
            "\n"
            "def worker(i):\n"
            "    _RESULTS[i] = i * 2\n"
            "\n"
            "def run(items):\n"
            "    with ThreadPoolExecutor(max_workers=2) as pool:\n"
            "        list(pool.map(worker, items))\n"
        )},
        None,
    ),
    "r7_lock_and_instance_state": (
        {"mod.py": (
            "import threading\n"
            "from concurrent.futures import ThreadPoolExecutor\n"
            "\n"
            "_lock = threading.Lock()\n"
            "\n"
            "class Pipeline:\n"
            "    def __init__(self):\n"
            "        self.pool = ThreadPoolExecutor(max_workers=1)\n"
            "        self.pending = None\n"
            "\n"
            "    def _work(self, x):\n"
            "        with _lock:\n"
            "            self.safe = x\n"
            "        self.result = x + 1\n"
            "\n"
            "    def go(self, x):\n"
            "        self.pending = self.pool.submit(self._work, x)\n"
        )},
        None,
    ),
    "r9_fault_sites": (
        {"pkg/robust/inject.py": "FAULT_SITES = {\"known\": \"doc\", \"undocumented\": \"doc\"}\n",
         "pkg/mod.py": (
             "from pkg.robust import inject\n"
             "\n"
             "def f(name):\n"
             "    inject.site(\"known\")\n"
             "    inject.site(\"unknown\")\n"
             "    inject.raise_if(\"undocumented\")\n"
             "    inject.site(name)\n"
         )},
        "Sites: `known`.\n",
    ),
    "r11_metric_names": (
        {"pkg/obs/catalog.py": (
            "METRIC_SERIES = {\"good_total\": \"help\"}\n"
            "METRIC_PREFIXES = (\"fam_\",)\n"
        ),
         "pkg/mod.py": (
             "def f(log, key, flag):\n"
             "    log.count(\"good_total\")\n"
             "    log.count(\"bad_total\")\n"
             "    log.gauge(f\"fam_{key}\", 1)\n"
             "    log.gauge(f\"other_{key}\", 1)\n"
             "    log.timer(key)\n"
             "    log.count(\"good_total\" if flag else \"worse_total\")\n"
         )},
        None,
    ),
    "r0_suppression_hygiene": (
        {"mod.py": (
            "import threading\n"
            "from concurrent.futures import ThreadPoolExecutor\n"
            "_R = {}\n"
            "def worker(i):\n"
            "    _R[i] = i  # graftlint: disable=R7 -- the fixture's reasoned escape\n"
            "    _R[-i] = i  # graftlint: disable=R7\n"
            "    return i  # graftlint: disable=R7 -- nothing to suppress here\n"
            "def run(items):\n"
            "    with ThreadPoolExecutor(max_workers=2) as pool:\n"
            "        list(pool.map(worker, items))\n"
            "S = \"# graftlint: disable=R1 -- inside a string: inert\"\n"
        )},
        None,
    ),
    "r0_file_wide_and_unparsable": (
        {"ok.py": "# graftlint: disable-file=R7 -- fixture\nx = 1\n",
         "broken.py": "def f(:\n    pass\n"},
        None,
    ),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_engine_and_stdlib_rules_match_the_jax_package(tmp_path, case):
    sources, readme = SHARED[case]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_readme = _write(jax_root, sources, readme)
    port_readme = _write(port_root, sources, readme)
    jax_report = jax_lint_paths([jax_root], root=jax_root, readme=jax_readme)
    port_report = lint_paths([port_root], root=port_root, readme=port_readme)
    assert _findings(port_report, port_root) == _findings(jax_report, jax_root), render_report(port_report)
    assert port_report.suppressed == jax_report.suppressed
    assert port_report.violations, "each shared fixture holds at least one finding"


# --- torch twins of the JAX fixtures ------------------------------------------------

TWINS = {
    "R1": (
        ("pkg/mod.py", "import jax\n@jax.jit\ndef f(x):\n    return x.item()\n"),
        ("pkg/mod.py", "from pkg.guards import guarded_launch\ndef f(x):\n"
                       "    with guarded_launch(x.device):\n        return x.item()\n"),
        4,
    ),
    "R2": (
        ("pkg/mod.py", "import jax\ndef f(xs):\n    for x in xs:\n"
                       "        g = jax.jit(lambda v: v + 1)\n        g(x)\n"),
        ("pkg/mod.py", "import torch\ndef f(xs):\n    for x in xs:\n"
                       "        g = torch.cuda.CUDAGraph()\n        g.replay()\n"),
        4,
    ),
    "R3": (
        ("pkg/mod.py", "import jax\nfrom functools import partial\n"
                       "@partial(jax.jit, donate_argnums=(0,))\ndef step(x):\n    return x + 1\n"
                       "def run(x):\n    y = step(x)\n    return x + y\n"),
        ("pkg/mod.py", "def run(entry):\n    entry.replay()\n    y = entry.outs[0]\n"
                       "    entry.replay()\n    z = 1\n    w = 2\n    q = 3\n    return y + z + w + q\n"),
        8,
    ),
    "R4": (
        ("pkg/mod.py", "import jax.numpy as jnp\nx = jnp.zeros(3, dtype=jnp.float64)\n"),
        ("pkg/mod.py", "import torch\nx = torch.zeros(3, dtype=torch.float64)\n"),
        2,
    ),
    "R5": (
        ("pkg/solvers/mod.py", "import jax\n@jax.jit\ndef f(x):\n    if x > 0:\n        return x\n"
                               "    return -x\n"),
        ("pkg/solvers/mod.py", "import torch\ndef f(x):\n    y = torch.abs(x)\n"
                               "    if y.sum() > 0:\n        return y\n    return -y\n"),
        4,
    ),
    "R10": (
        ("pkg/mod.py", "from jax.lax import psum\ndef f(x):\n    return psum(x, \"chains\")\n"),
        ("pkg/mod.py", "import torch.distributed as dist\ndef f(mesh):\n"
                       "    return mesh.get_group(\"chains\")\n"),
        3,
    ),
    "R12": (
        ("pkg/mod.py", "from jax.sharding import NamedSharding, PartitionSpec as P\n"
                       "def f(mesh):\n    return NamedSharding(mesh, P(None))\n"),
        ("pkg/mod.py", "from torch.distributed.tensor import Shard\ndef f(mesh):\n"
                       "    return Shard(0)\n"),
        3,
    ),
    "R13": (
        ("pkg/solvers/mod.py", "import jax.numpy as jnp\ndef f(x):\n"
                               "    return x.astype(jnp.bfloat16)\n"),
        ("pkg/solvers/mod.py", "import torch\ndef f(x):\n    return x.to(torch.bfloat16)\n"),
        3,
    ),
}


@pytest.mark.parametrize("rule", sorted(TWINS, key=lambda r: int(r[1:])))
def test_torch_twin_draws_the_jax_rule_on_the_same_line(tmp_path, rule):
    (jax_rel, jax_src), (port_rel, port_src), line = TWINS[rule]
    _write(tmp_path / "jax", {jax_rel: jax_src})
    _write(tmp_path / "port", {port_rel: port_src})
    jax_report = jax_lint_paths([tmp_path / "jax"], root=tmp_path / "jax")
    port_report = lint_paths([tmp_path / "port"], root=tmp_path / "port")
    jax_hits = {(v.rule, v.line) for v in jax_report.violations}
    port_hits = {(v.rule, v.line) for v in port_report.violations}
    assert (rule, line) in jax_hits
    assert port_hits == {(rule, line)}, render_report(port_report)


@pytest.mark.parametrize("src", [
    # a readback is the legal sync inside a window
    "from pkg.guards import guarded_launch, readback\ndef f(x):\n"
    "    with guarded_launch(x.device):\n        with readback():\n            return x.item()\n",
    # a sync outside every window
    "def f(x):\n    return x.item()\n",
    # float() of a python number inside a window
    "from pkg.guards import guarded_launch\ndef f(x, n):\n"
    "    with guarded_launch(x.device):\n        return float(n)\n",
    # a clone breaks the static-output alias
    "def run(entry):\n    entry.replay()\n    y = entry.outs[0].clone()\n    entry.replay()\n"
    "    return y\n",
    # a graph captured by the graph store's own module
    "import torch\ng = torch.cuda.CUDAGraph()\n",
], ids=["readback", "outside-window", "python-number", "clone", "store"])
def test_torch_rules_leave_legal_forms_alone(tmp_path, src):
    rel = "pkg/aot/store.py" if "CUDAGraph" in src else "pkg/mod.py"
    _write(tmp_path, {rel: src})
    report = lint_paths([tmp_path], root=tmp_path)
    assert report.violations == [], render_report(report)


def test_r8_span_needs_a_roofline_cost(tmp_path):
    _write(tmp_path, {
        "pkg/obs/roofline.py": "COSTS = {\"costed\": None}\n",
        "pkg/mod.py": (
            "from pkg.registry import register_ir_core\n"
            "from pkg.hooks import dispatch_span\n"
            "def entry():\n"
            "    with dispatch_span(\"costed\"):\n        pass\n"
            "    with dispatch_span(\"uncosted\"):\n        pass\n"
            "@register_ir_core(\"a\", span=\"costed\")\ndef _a(device=\"cpu\"):\n    pass\n"
            "@register_ir_core(\"b\", span=\"uncosted\")\ndef _b(device=\"cpu\"):\n    pass\n"
            "@register_ir_core(\"c\", span_optout=\"comparator only\")\ndef _c(device=\"cpu\"):\n"
            "    pass\n"
        ),
    })
    report = lint_paths([tmp_path], root=tmp_path)
    hits = [(v.rule, v.line) for v in report.violations]
    assert hits == [("R8", 11)], render_report(report)
    assert "obs/roofline.COSTS" in report.violations[0].message


# --- the port's own package ----------------------------------------------------------


def test_port_package_lints_clean_with_reasoned_suppressions():
    report = lint_paths([REPO / "citizensassemblies_tpu_torch"], root=REPO)
    assert report.ok, render_report(report)
    assert report.files >= 90
    # every suppression names its reason (a missing one is an R0 finding),
    # and they all sit in the lint rules' own tables of the names they search for
    assert report.suppressed == 7


def test_cli_exit_codes_and_json_envelope(tmp_path, capsys):
    assert lint_main([str(REPO / "citizensassemblies_tpu_torch"), "-q"]) == 0
    capsys.readouterr()
    _write(tmp_path, {"mod.py": "import torch\nx = torch.zeros(3, dtype=torch.float64)\n"})
    assert lint_main([str(tmp_path), "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema_version"] == 1 and doc["pass"] == "ast" and doc["ok"] is False
    assert doc["violations"][0]["rule"] == "R4"
    assert set(doc["violations"][0]) == {"path", "line", "col", "rule", "name", "message"}
    for bad in (["--update-budget"], ["--ir", "--spmd"], ["--ir", str(tmp_path)],
                ["--prec-plan", "x.json"], ["--diff-out", "x.json"]):
        with pytest.raises(SystemExit) as exc:
            lint_main(bad)
        assert exc.value.code == 2


def test_core_passes_run_on_cuda_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint_main(["--ir"])
