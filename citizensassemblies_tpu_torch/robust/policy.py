"""Deadline, retry and degradation policy.

* :class:`Deadline`: a monotonic wall-clock budget, checked by a host clock
  read (no device synchronisation).
* :class:`RetryBudget`: counted exponential-backoff retries for transient
  faults.
* :class:`DegradationLadder`: the ordered fallback chain walked one rung per
  injected transient fault (``robust.inject.FaultInjected``): device
  pricing → host MILP, ELL → dense, batched → serial, fused screen → host
  screen, mesh → single device. Every rung lands on a gate whose off position runs a path held
  equal by the tests, so a degraded run is slower, not different, and is
  judged by the same 1e-3 L∞ arithmetic audit. The face loop's anchor
  pricer walks it at an injected ``device_dispatch`` fault
  (``solvers/face_decompose._AnchorPricer``).

The JAX package's ladder begins with a kernel → chained-ops rung
(``pdhg_megakernel=False``). This package has none: a kernel that fails to
build or launch raises, and no rung may turn that into a quiet switch to
the plain version. Its last rung, mesh → single device
(``dist_mesh=False``), is walked after a collective-layer fault: the
``dist_collective`` site fires in ``dist.runtime.effective_mesh`` before it
hands out a mesh of more than one device, and with the rung taken every
routing site stays on its undistributed path (bit for bit the same draws,
the same LPs on one device). The per-request deadline check
inside the face loop arrives with the serving layer's request context
(queue A item 9).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from citizensassemblies_tpu_torch.utils.config import Config


class DeadlineExceeded(RuntimeError):
    """The deadline expired. ``partial`` carries whatever evidence the
    raising layer could assemble (best ε so far, round count)."""

    def __init__(self, message: str, partial: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.partial = partial or {}


class Deadline:
    """Monotonic wall-clock budget."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        return self.seconds - self.elapsed()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, where: str, log=None, partial: Optional[Dict[str, Any]] = None) -> None:
        """Raise :class:`DeadlineExceeded` when expired, counting
        ``deadline_exceeded`` on ``log``."""
        if not self.expired:
            return
        if log is not None:
            log.count("deadline_exceeded")
        raise DeadlineExceeded(
            f"deadline of {self.seconds:.1f}s exceeded at {where} "
            f"({self.elapsed():.1f}s elapsed)",
            partial=partial,
        )


class RetryBudget:
    """Counted exponential-backoff retries for transient faults."""

    def __init__(self, attempts: int = 2, backoff_s: float = 0.05):
        self.attempts = max(int(attempts), 0)
        self.backoff_s = max(float(backoff_s), 0.0)
        self.used = 0

    @property
    def left(self) -> int:
        return self.attempts - self.used

    def take(self) -> Optional[float]:
        """Consume one retry; returns the backoff delay (exponential in the
        retries already used) or None when the budget is spent."""
        if self.used >= self.attempts:
            return None
        delay = self.backoff_s * (2.0 ** self.used)
        self.used += 1
        return delay


#: the fallback chain, in order: each rung is a Config gate whose off
#: position runs a path the tests hold equal to the gate's on position
DEGRADATION_LADDER: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("device_pricing_host_milp", {"decomp_device_pricing": False}),
    ("ell_to_dense", {"sparse_ops": False}),
    ("batched_to_serial", {"lp_batch": False}),
    ("fused_screen_to_host", {"decomp_batched_expand": False}),
    ("mesh_to_single_device", {"dist_mesh": False}),
)


class DegradationLadder:
    """Walk the fallback chain one rung per injected transient fault. Each
    :meth:`degrade` returns a Config with the next rung's gate off,
    cumulatively; past the last rung the config comes back unchanged."""

    def __init__(self):
        self.steps: List[str] = []

    @property
    def position(self) -> int:
        return len(self.steps)

    @property
    def exhausted(self) -> bool:
        return self.position >= len(DEGRADATION_LADDER)

    def degrade(self, cfg: Config, log=None) -> Config:
        if self.exhausted:
            return cfg
        name, patch = DEGRADATION_LADDER[self.position]
        self.steps.append(name)
        if log is not None:
            log.count(f"robust_degrade_{name}")
            log.count("robust_degrade_steps")
        return cfg.replace(**patch)
