"""The port's lint engine: module loading, suppression, rule dispatch.

A rule is an object with ``rule_id`` (``"R1"``), ``name`` (kebab-case slug)
and ``description``, plus either

* ``check_module(module) -> [Violation]`` — per-file AST rules, or
* ``check_package(modules) -> [Violation]`` — cross-file rules (R6 needs the
  whole package plus README to judge a config knob).

Suppression syntax (the acceptance contract requires a *reason*):

* ``# graftlint: disable=R1 -- reason``       suppress R1 on this line and
  the next (so the comment may sit on its own line above a long statement);
* ``# graftlint: disable=R1,R4 -- reason``    several rules at once;
* ``# graftlint: disable-file=R6 -- reason``  whole-file suppression.

Directives are parsed from real COMMENT tokens (``tokenize``), so a
directive spelled inside a string literal — a lint self-test fixture, a
docstring example like the ones above — is inert. Two directive hygiene
checks ride the engine itself (both R0): a disable *without a reason*, and
an *unused* disable that matches no finding (ruff's unused-noqa, so stale
suppressions cannot accumulate as the rules or the code improve).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str  # "R1"
    name: str  # "host-sync-in-launch-window"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.name}] {self.message}"


@dataclasses.dataclass
class ModuleSource:
    """One parsed python file plus its raw lines (for suppression scanning)."""

    path: Path
    rel: str  # path as reported in violations
    text: str
    lines: List[str]
    tree: ast.Module


@dataclasses.dataclass
class LintReport:
    violations: List[Violation]
    suppressed: int
    files: int

    @property
    def ok(self) -> bool:
        return not self.violations


_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable(?:-file)?)\s*=\s*([A-Z][0-9]+(?:\s*,\s*[A-Z][0-9]+)*)"
    r"(?:\s*--\s*(\S.*))?"
)


@dataclasses.dataclass
class _Directive:
    """One parsed ``# graftlint: disable…`` comment."""

    line: int
    rules: Set[str]
    file_wide: bool
    has_reason: bool
    text: str  # "disable" / "disable-file", for messages
    used: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _Suppressions:
    directives: List[_Directive]

    def covers(self, rule: str, line: int) -> bool:
        """Does any directive suppress ``rule`` at ``line``? Marks the
        matching directives used, which is what the unused-suppression
        check reads afterwards."""
        hit = False
        for d in self.directives:
            if rule not in d.rules:
                continue
            # a line directive covers its own line and the next one, so it
            # can annotate a long statement from the line above
            if d.file_wide or line in (d.line, d.line + 1):
                d.used.add(rule)
                hit = True
        return hit


def _comment_tokens(text: str) -> List[Tuple[int, str]]:
    """(line, comment_text) for every real COMMENT token. Tokenizing keeps
    directives inside string literals inert; on files tokenize cannot digest
    (rare encoding edge cases) fall back to raw line scanning."""
    try:
        return [
            (tok.start[0], tok.string)
            for tok in tokenize.generate_tokens(io.StringIO(text).readline)
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return list(enumerate(text.splitlines(), start=1))


def _parse_suppressions(text: str) -> _Suppressions:
    directives: List[_Directive] = []
    for line, comment in _comment_tokens(text):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        kind, rule_list, reason = m.group(1), m.group(2), m.group(3)
        directives.append(
            _Directive(
                line=line,
                rules={r.strip() for r in rule_list.split(",")},
                file_wide=kind == "disable-file",
                has_reason=bool(reason),
                text=kind,
            )
        )
    return _Suppressions(directives=directives)


def load_module(path: Path, root: Optional[Path] = None) -> Optional[ModuleSource]:
    """Parse one file; returns None for unparsable sources (reported upstream)."""
    text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError:
        return None
    try:
        rel = str(path.relative_to(root)) if root is not None else str(path)
    except ValueError:
        rel = str(path)
    return ModuleSource(
        path=path, rel=rel, text=text, lines=text.splitlines(), tree=tree
    )


def iter_python_files(paths: Iterable[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    # dedupe, keep order
    seen: Set[Path] = set()
    uniq = []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def all_rules():
    """The registered rule set, R1..R13 (R0 is emitted by the engine itself)."""
    from citizensassemblies_tpu_torch.lint.config_rule import ConfigKnobRule
    from citizensassemblies_tpu_torch.lint.rules import (
        CoreSpanRule,
        CudaValueBranchRule,
        DtypeDisciplineRule,
        DtypeLiteralHygieneRule,
        FaultSiteRule,
        HostSyncInLaunchWindowRule,
        MeshHygieneRule,
        MetricHygieneRule,
        PerCallConstructionRule,
        PlacementHygieneRule,
        StaticOutputAfterReplayRule,
        ThreadDisciplineRule,
    )

    return [
        HostSyncInLaunchWindowRule(),
        PerCallConstructionRule(),
        StaticOutputAfterReplayRule(),
        DtypeDisciplineRule(),
        CudaValueBranchRule(),
        ConfigKnobRule(),
        ThreadDisciplineRule(),
        CoreSpanRule(),
        FaultSiteRule(),
        MeshHygieneRule(),
        MetricHygieneRule(),
        PlacementHygieneRule(),
        DtypeLiteralHygieneRule(),
    ]


def lint_paths(
    paths: Sequence[Path],
    rules=None,
    readme: Optional[Path] = None,
    root: Optional[Path] = None,
) -> LintReport:
    """Lint every python file under ``paths`` with the full rule set."""
    rules = rules if rules is not None else all_rules()
    root = root or Path.cwd()
    files = iter_python_files([Path(p) for p in paths])
    modules: List[ModuleSource] = []
    raw: List[Violation] = []
    for f in files:
        mod = load_module(f, root=root)
        if mod is None:
            raw.append(
                Violation(
                    path=str(f), line=1, col=0, rule="R0",
                    name="unparsable", message="file does not parse",
                )
            )
            continue
        modules.append(mod)

    for rule in rules:
        if hasattr(rule, "check_package"):
            raw.extend(rule.check_package(modules, readme=readme))
        else:
            for mod in modules:
                raw.extend(rule.check_module(mod))

    # apply suppressions + report directive hygiene (missing reason, unused)
    sup_by_rel = {m.rel: _parse_suppressions(m.text) for m in modules}
    kept: List[Violation] = []
    suppressed = 0
    for v in sorted(raw, key=lambda v: (v.path, v.line, v.col, v.rule)):
        sup = sup_by_rel.get(v.path)
        if sup is not None and sup.covers(v.rule, v.line):
            suppressed += 1
            continue
        kept.append(v)
    for m in modules:
        for d in sup_by_rel[m.rel].directives:
            if not d.has_reason:
                kept.append(
                    Violation(
                        path=m.rel, line=d.line, col=0, rule="R0",
                        name="suppression-without-reason",
                        message=(
                            f"'graftlint: {d.text}=' needs a reason "
                            "(append ' -- why this is safe')"
                        ),
                    )
                )
            for rule in sorted(d.rules - d.used):
                kept.append(
                    Violation(
                        path=m.rel, line=d.line, col=0, rule="R0",
                        name="unused-suppression",
                        message=(
                            f"'graftlint: {d.text}={rule}' suppresses no "
                            "finding — remove the stale directive (mirrors "
                            "ruff's unused-noqa)"
                        ),
                    )
                )
    kept.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return LintReport(violations=kept, suppressed=suppressed, files=len(files))


def render_report(report: LintReport) -> str:
    lines = [v.render() for v in report.violations]
    tail = (
        f"graftlint: {len(report.violations)} violation(s), "
        f"{report.suppressed} suppressed, {report.files} file(s) checked"
    )
    return "\n".join(lines + [tail])
