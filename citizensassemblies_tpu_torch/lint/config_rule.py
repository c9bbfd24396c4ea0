"""R6: Config-field hygiene (cross-file).

Every field of the frozen ``Config`` dataclass must be

* **read somewhere in the package** — an attribute access ``cfg.field``, a
  ``getattr(x, "field")``, or membership in a string registry (a tuple/list/
  dict of field-name strings, e.g. the analysis cache's ``_KEY_FIELDS``);
  docstrings and bare comments do NOT count, so a knob nothing consumes is
  dead config and fails; and
* **documented in README** — the field name must appear verbatim in the
  README section of the package that owns the ``Config`` (the ``## ``
  heading that names the package in backticks, up to the next ``## ``
  heading; the whole README when no heading names it). The JAX package's
  README table does not document the port's fields.

The rule finds the Config class by walking the scanned modules for a
``class Config`` with dataclass-style annotated fields, so it works on any
package layout (and on the self-test fixtures).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

from citizensassemblies_tpu_torch.lint.engine import ModuleSource, Violation


def _config_fields(mod: ModuleSource) -> List[Tuple[str, int]]:
    """(field, line) pairs of the annotated fields of a Config class."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            return [
                (st.target.id, st.lineno)
                for st in node.body
                if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name)
            ]
    return []


def _reads_in_module(mod: ModuleSource) -> Set[str]:
    """Names this module plausibly READS as config knobs: attribute
    accesses, getattr literals, and strings inside container literals
    (registry pattern). Docstrings are plain Expr constants and excluded by
    the container requirement."""
    reads: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            reads.add(node.attr)
        elif isinstance(node, ast.Call):
            d = node.func
            if isinstance(d, ast.Name) and d.id == "getattr" and len(node.args) >= 2:
                arg = node.args[1]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    reads.add(arg.value)
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for elt in node.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    reads.add(elt.value)
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    reads.add(key.value)
    return reads


def _find_readme(modules: Sequence[ModuleSource], explicit: Optional[Path]) -> Optional[Path]:
    if explicit is not None:
        return explicit if explicit.exists() else None
    # nearest README.md above the config module
    for mod in modules:
        if mod.path.name == "config.py":
            for parent in mod.path.resolve().parents:
                candidate = parent / "README.md"
                if candidate.exists():
                    return candidate
    return None


def readme_section(text: str, package: str) -> str:
    """The README section whose ``## `` heading names ``package`` in
    backticks, up to the next ``## `` heading; all of ``text`` when no
    heading names it."""
    lines = text.splitlines()
    start = None
    for i, line in enumerate(lines):
        if line.startswith("## ") and f"`{package}`" in line:
            start = i
            break
    if start is None:
        return text
    end = len(lines)
    for j in range(start + 1, len(lines)):
        if lines[j].startswith("## "):
            end = j
            break
    return "\n".join(lines[start:end])


class ConfigKnobRule:
    rule_id = "R6"
    name = "config-knob-hygiene"
    description = "every Config field must be read in-package and README-documented"

    def check_package(
        self, modules: Sequence[ModuleSource], readme: Optional[Path] = None
    ) -> List[Violation]:
        config_mod: Optional[ModuleSource] = None
        fields: List[Tuple[str, int]] = []
        for mod in modules:
            got = _config_fields(mod)
            if got:
                config_mod, fields = mod, got
                break
        if config_mod is None:
            return []

        # "read somewhere" means read IN THE PACKAGE that owns the Config:
        # with the lint scope extended to bench.py and tests/, a knob whose
        # only consumer is a test would otherwise stop counting as dead
        pkg_root = config_mod.rel.replace("\\", "/").split("/", 1)[0]
        reads: Set[str] = set()
        for mod in modules:
            if mod is config_mod:
                continue
            rel = mod.rel.replace("\\", "/")
            if "/" in config_mod.rel.replace("\\", "/") and not rel.startswith(
                pkg_root + "/"
            ):
                continue
            reads |= _reads_in_module(mod)

        readme_path = _find_readme(modules, readme)
        readme_text = readme_path.read_text(encoding="utf-8") if readme_path else ""
        readme_text = readme_section(readme_text, config_mod.path.resolve().parents[1].name)

        out: List[Violation] = []
        for field, line in fields:
            if field not in reads:
                out.append(
                    Violation(
                        path=config_mod.rel, line=line, col=4,
                        rule=self.rule_id, name=self.name,
                        message=(
                            f"Config.{field} is never read in the package — "
                            "dead knob: wire it or remove it"
                        ),
                    )
                )
            if readme_text and field not in readme_text:
                out.append(
                    Violation(
                        path=config_mod.rel, line=line, col=4,
                        rule=self.rule_id, name=self.name,
                        message=(
                            f"Config.{field} is not documented in "
                            f"{readme_path.name} — add it to the "
                            "configuration-knob table"
                        ),
                    )
                )
        return out
