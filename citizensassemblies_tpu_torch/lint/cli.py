"""The lint CLI: ``python -m citizensassemblies_tpu_torch.lint [paths...]``.

Exit code 0 when clean, 1 on violations, 2 on a usage error. With no paths
the package that contains this module is linted (the AST rules R0-R13).
The three core passes take no paths:

* ``--ir`` traces every registered core's plain route on CPU tensors and
  checks it against ``lint/analysis_budget.json`` (``--update-budget``
  rewrites the file);
* ``--spmd`` counts the collectives of every registered core at world sizes
  1, 2, 4 and 8 over torch's fake process group and checks the placements
  against ``lint/spmd_budget.json`` (``--update-budget`` rewrites it);
* ``--prec`` certifies every core's bf16 nominations and checks the result
  against the committed ``PRECISION_PLAN.json`` (read only).

``--diff-out F`` writes the pass's measured-vs-budget JSON to ``F``.
``--device`` picks where the cores are built: ``cuda`` by default, which
raises where there is no card, like every entry point of the port. The
traces read by IR4, the census and P1 are of the plain route on CPU
tensors whatever ``--device`` says (the plain versions run only on CPU
tensors), so their budgets are the same on either machine; ``--device
cuda`` builds each core on the card as well and checks that it runs there.
``--format json`` emits the JAX package's envelope for every pass:
``{"schema_version", "pass", "ok", ..., "violations": [...]}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from citizensassemblies_tpu_torch.lint.engine import lint_paths, render_report


def _ast_report_as_json(report) -> dict:
    """Stable schema shared with the core passes: rule, path, line, message
    inside the common pass envelope."""
    return {
        "schema_version": 1,
        "pass": "ast",
        "ok": report.ok,
        "files": report.files,
        "suppressed": report.suppressed,
        "violations": [dataclasses.asdict(v) for v in report.violations],
    }


def _emit(args, report, render, as_json, diff) -> int:
    if args.diff_out is not None:
        args.diff_out.write_text(
            json.dumps(diff(report), indent=1, sort_keys=True) + "\n", encoding="utf-8"
        )
    if args.format == "json":
        print(json.dumps(as_json(report), indent=1))
    else:
        rendered = render(report)
        if args.quiet:
            rendered = "\n".join(v.render() for v in report.violations)
        if rendered:
            print(rendered)
    return 0 if report.ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m citizensassemblies_tpu_torch.lint",
        description=(
            "Static analysis of the port's invariants (R1 host-sync-in-launch-"
            "window, R2 per-call-construction, R3 static-output-after-replay, "
            "R4 dtype-discipline, R5 cuda-value-branch, R6 config-knob-hygiene, "
            "R7 thread-discipline, R8 core-span-coverage, R9 fault-site-"
            "catalogue, R10 mesh-hygiene, R11 metric-hygiene, R12 placement-"
            "hygiene, R13 dtype-literal-hygiene). Suppress with '# graftlint: "
            "disable=R1 -- reason'; a suppression that matches no finding is "
            "itself an error. --ir, --spmd and --prec check the registered "
            "cores instead."
        ),
    )
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/directories to lint (default: the package)")
    parser.add_argument("--readme", type=Path, default=None,
                        help="README checked by R6/R9 (default: nearest README.md above config.py)")
    parser.add_argument("-q", "--quiet", action="store_true", help="print violations only")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="output format (json: the shared pass envelope)")
    parser.add_argument("--ir", action="store_true",
                        help="trace every registered core (IR1-IR4) against the analysis budget")
    parser.add_argument("--spmd", action="store_true",
                        help="collective census and placements of the registered cores")
    parser.add_argument("--prec", action="store_true",
                        help="certify the registered cores' bf16 nominations (P1)")
    parser.add_argument("--budget", type=Path, default=None,
                        help="budget file of --ir or --spmd (default: the port's committed one)")
    parser.add_argument("--prec-plan", type=Path, default=None,
                        help="precision plan of --prec (default: PRECISION_PLAN.json)")
    parser.add_argument("--update-budget", action="store_true",
                        help="with --ir or --spmd: re-measure every core and REWRITE the budget")
    parser.add_argument("--diff-out", type=Path, default=None,
                        help="with --ir/--spmd/--prec: write the measured-vs-budget JSON here")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="where the cores are built (default cuda; raises without a card)")
    args = parser.parse_args(argv)

    passes = [p for p in ("ir", "spmd", "prec") if getattr(args, p)]
    if len(passes) > 1:
        parser.error("--ir, --spmd and --prec are separate passes; run them separately")
    if args.update_budget and not (args.ir or args.spmd):
        parser.error("--update-budget requires --ir or --spmd")
    if args.budget is not None and not (args.ir or args.spmd):
        parser.error("--budget requires --ir or --spmd")
    if args.prec_plan is not None and not args.prec:
        parser.error("--prec-plan requires --prec")
    if args.diff_out is not None and not passes:
        parser.error("--diff-out requires --ir, --spmd or --prec")
    if passes:
        if args.paths:
            parser.error(f"--{passes[0]} checks the registered cores; paths are for the AST pass")
        from citizensassemblies_tpu_torch.utils.device import resolve_device

        device = str(resolve_device(args.device))
    if args.ir:
        from citizensassemblies_tpu_torch.lint import ir

        report = ir.run_ir_checks(budget_path=args.budget, update_budget=args.update_budget,
                                  device=device)
        return _emit(args, report, ir.render_ir_report, ir.ir_report_as_json, ir.budget_diff)
    if args.spmd:
        from citizensassemblies_tpu_torch.lint import spmd

        report = spmd.run_spmd_checks(budget_path=args.budget, update_budget=args.update_budget,
                                      device=device)
        return _emit(args, report, spmd.render_spmd_report, spmd.spmd_report_as_json,
                     spmd.spmd_budget_diff)
    if args.prec:
        from citizensassemblies_tpu_torch.lint import prec

        report = prec.run_prec_checks(plan_path=args.prec_plan, device=device)
        return _emit(args, report, prec.render_prec_report, prec.prec_report_as_json,
                     prec.prec_plan_diff)

    paths = args.paths or [Path(__file__).resolve().parent.parent]
    report = lint_paths(paths, readme=args.readme)
    if args.format == "json":
        print(json.dumps(_ast_report_as_json(report), indent=1))
        return 0 if report.ok else 1
    rendered = render_report(report)
    if args.quiet:
        rendered = "\n".join(v.render() for v in report.violations)
    if rendered:
        print(rendered)
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
