"""No module a run or the references import is JAX's or the JAX package's,
compared by whole top-level names (the port's name begins with the JAX
package's); the references import nothing of the port either. Each check
imports in a fresh interpreter, so what other tests loaded cannot hide or
fake a finding."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "citizensassemblies_tpu"}

HARNESS = ["portbench.run", "portbench.devtrace", "portbench.pools", "portbench.costs",
           "portbench.requests"] + [f"portbench.requests.{p.stem}"
                                   for p in sorted((HERE / "requests").glob("*.py"))
                                   if p.stem != "__init__"]
REFERENCES = ["portbench.reference"] + [f"portbench.reference.{p.stem}"
                                        for p in sorted((HERE / "reference").glob("*.py"))
                                        if p.stem != "__init__"]


def top_level_names(modules, setup=""):
    code = (
        "import importlib, json, sys\n" + setup +
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = top_level_names(HARNESS)
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_a_run_of_every_request_kind_loads_no_jax():
    """What the loads import when they set up: the port's entry points."""
    setup = (
        "import citizensassemblies_tpu_torch.models.legacy, "
        "citizensassemblies_tpu_torch.utils.config, "
        "citizensassemblies_tpu_torch.interop, citizensassemblies_tpu_torch.obs.trace\n"
    )
    names = top_level_names(HARNESS, setup)
    assert "citizensassemblies_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_references_import_nothing_of_the_port_or_jax():
    names = top_level_names(REFERENCES + ["portbench.pools", "portbench.costs"])
    assert not names & (FORBIDDEN | {"citizensassemblies_tpu_torch"}), names


@pytest.mark.parametrize("name,found", [("jax.numpy", ["jax"]), ("citizensassemblies_tpu", ["citizensassemblies_tpu"]),
                                        ("citizensassemblies_tpu_torch.models", [])])
def test_the_runs_own_check_compares_whole_top_level_names(name, found, monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, name, object())
    assert [f for f in run.forbidden_modules() if f in found] == found
    assert "citizensassemblies_tpu_torch" not in run.forbidden_modules()
