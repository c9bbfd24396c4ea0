"""The port's lint package: static analysis of its own sources and checks of
its registered cores.

The port's speed rests on invariants nothing in the type system enforces:
no host synchronisation inside a launch window, CUDA graphs captured once
per signature in the graph store and never per call, a graph's static
output never read after the next replay, float64 only in the host
certification modules, no Python branch on a CUDA tensor's value in the hot
paths, every ``Config`` field read and documented, worker threads writing
shared state under a lock, every registered core traced and costed, and
fault sites, metric names, mesh axes, placements and 16-bit dtypes spelled
only in their catalogues. The AST pass walks the package and enforces all
of it (rules R1-R13), with ``file:line`` reports and the suppression syntax
``# graftlint: disable=R1 -- reason`` (an unused suppression, or one
without a reason, is itself an error, R0).

Three more passes check what the AST cannot see, over the cores registered
in :mod:`.registry` (the counterparts of the JAX package's 24 cores, under
its names):

* ``--ir`` (:mod:`.ir`) traces each core's plain route on CPU tensors at the
  aten level and checks IR1 (no host read inside a core), IR2 (no float64
  outside the certification cores), IR3 (declared in-place updates are
  realized) and IR4 (FLOPs, bytes and the aten-op histogram against the
  port's own ``analysis_budget.json``);
* ``--spmd`` (:mod:`.spmd`) counts each distributed core's collectives at
  world sizes 1, 2, 4 and 8 in one process over torch's fake process group,
  and checks placements against ``dist/partition.ROLE_BUILDERS``;
* ``--prec`` (:mod:`.prec`) runs the error-flow interval interpretation
  over the aten trace and certifies each nominated bf16 demotion; the
  certified sets must equal the committed ``PRECISION_PLAN.json``'s.

Run the AST pass as ``python -m citizensassemblies_tpu_torch.lint
[paths...]``; ``--format json`` emits the stable machine schema. The AST
side is stdlib only (no torch import), so linting is fast and runs
anywhere.
"""

from citizensassemblies_tpu_torch.lint.engine import (
    LintReport,
    Violation,
    all_rules,
    lint_paths,
    render_report,
)

__all__ = [
    "LintReport",
    "Violation",
    "all_rules",
    "lint_paths",
    "render_report",
]
