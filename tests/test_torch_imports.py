"""The PyTorch port loads without JAX and without the JAX package.

One subprocess imports every module of ``citizensassemblies_tpu_torch`` and
reports what ``sys.modules`` holds; an AST scan finds no import of either in
the package's sources. Matplotlib, which the analysis figures use, must not
load at import either: the figure writers import it when they draw. The JAX package's name is a prefix of the port's, so
both checks compare exact names.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "citizensassemblies_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "citizensassemblies_tpu"}
#: loaded only by a call that needs it, never by an import of the package
DEFERRED_ROOTS = {"matplotlib"}


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN_ROOTS


def test_every_module_imports_without_jax():
    names = _module_names()
    assert "citizensassemblies_tpu_torch.kernels.pdhg_megakernel" in names
    assert "citizensassemblies_tpu_torch.analysis.plots" in names
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [n for n in loaded if _forbidden(n) or n.split(".")[0] in DEFERRED_ROOTS]
    assert bad == [], bad
    assert "citizensassemblies_tpu_torch" in loaded
    # importing the package builds nothing and needs no GPU toolchain
    assert "torch" in loaded


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append(node.module)
    assert found == []


def test_forbidden_compares_exact_names():
    assert _forbidden("citizensassemblies_tpu")
    assert _forbidden("citizensassemblies_tpu.core.instance")
    assert not _forbidden("citizensassemblies_tpu_torch")
    assert not _forbidden("citizensassemblies_tpu_torch.core.instance")


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "citizensassemblies_tpu_torch.models.leximin" in mods
    assert not [m for m in mods if _forbidden(m)]
