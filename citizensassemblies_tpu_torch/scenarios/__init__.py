"""Deployment-shaped selection models over the type-space machinery.

Two departures from the one-panel, everyone-shows-up model, both solved by
the certified composition engine (``solvers/compositions.py``) through a
product or capped type space, as in the JAX package:

* **Dropout-robust LEXIMIN** (:mod:`~citizensassemblies_tpu_torch.scenarios.
  dropout`): attendance probabilities are bucketed into an extra
  vacuous-quota category, and the composition LEXIMIN runs with an
  attendance-weighted divisor, so its certified values are realized
  (post-dropout) seating probabilities. The realization is audited by the
  Monte-Carlo core ``parallel/mc.dropout_realization_round`` on the
  instance's device.
* **Multi-assembly scheduling** (:mod:`~citizensassemblies_tpu_torch.
  scenarios.multi`): LEXIMIN over R successive panels with no agent seated
  twice, from an enumeration capped at ``⌊m_t/R⌋`` seats a type; the R
  per-round probability recoveries are one bucketed dispatch of the batched
  LP engine (``solvers/batch_lp.solve_lp_batch``).
"""

from __future__ import annotations


class ScenarioError(RuntimeError):
    """A scenario model cannot run on this instance as configured."""


class SchedulingInfeasible(ScenarioError):
    """No feasible R-round disjoint schedule exists: the per-round type caps
    ``⌊m_t/R⌋`` leave the quotas unsatisfiable. Lower ``rounds`` or relax
    the quotas."""


from citizensassemblies_tpu_torch.scenarios.dropout import (  # noqa: E402
    DropoutDistribution,
    find_distribution_dropout,
)
from citizensassemblies_tpu_torch.scenarios.multi import (  # noqa: E402
    MultiAssemblyResult,
    find_distribution_multi,
)

__all__ = [
    "DropoutDistribution",
    "MultiAssemblyResult",
    "ScenarioError",
    "SchedulingInfeasible",
    "find_distribution_dropout",
    "find_distribution_multi",
]
