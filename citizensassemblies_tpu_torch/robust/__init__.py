"""Fault injection, the policies it exercises, and face-loop checkpoints.

* :mod:`~citizensassemblies_tpu_torch.robust.inject`: a config-gated,
  seed-deterministic fault-injection registry; hot boundaries consult named
  sites (``inject.site("pdhg_nan", log)``), and the same ``fault_sites``
  spec and ``fault_seed`` fire the same schedule as in the JAX package.
* :mod:`~citizensassemblies_tpu_torch.robust.policy`: ``Deadline``,
  ``RetryBudget`` and the ordered ``DegradationLadder``.
* :mod:`~citizensassemblies_tpu_torch.robust.checkpoint`: crash-consistent
  face-decomposition checkpoints.

Acceptance everywhere is the float64 arithmetic residual of the mixture
that comes back (the 1e-3 L∞ audit), so a degraded, retried or resumed path
is judged by the same check as the fast path. Only an injected fault
(``FaultInjected``) walks a fallback; a kernel's build or launch failure
raises.
"""

from citizensassemblies_tpu_torch.robust.inject import (
    FAULT_SITES,
    FaultInjected,
    FaultInjector,
    use_injector,
)
from citizensassemblies_tpu_torch.robust.policy import (
    DEGRADATION_LADDER,
    Deadline,
    DeadlineExceeded,
    DegradationLadder,
    RetryBudget,
)

__all__ = [
    "FAULT_SITES",
    "FaultInjected",
    "FaultInjector",
    "use_injector",
    "DEGRADATION_LADDER",
    "Deadline",
    "DeadlineExceeded",
    "DegradationLadder",
    "RetryBudget",
]
