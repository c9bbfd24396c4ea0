"""Seeded, config-gated fault injection.

Every fault site is a named knob consulted at a hot boundary::

    from citizensassemblies_tpu_torch.robust import inject
    if inject.site("pdhg_nan", log):
        x0[0] = np.nan  # poison the lane; the sentinel must quarantine it

Sites are registered in :data:`FAULT_SITES`, the same names as the JAX
package's. A run is configured by ``Config.fault_sites``, a spec string
``"pdhg_nan:0.1,oracle_raise:0.05"`` of per-site firing rates, plus
``Config.fault_seed``. Firing is deterministic: the n-th consultation of a
site fires iff ``_hash_unit(seed, site, n)`` lies below the rate, the same
function as the JAX package's, so the same spec and seed fire the same
consultations in both packages, in every process.

The injector is ambient. A request's own (``RequestContext.injector``,
``service/context.py``) comes first; then the one the model entry points
build from their ``Config`` for the call (:func:`request_injector`); then
the process default that offline harnesses and tests install with
:func:`use_injector`. With none installed (the default,
``fault_sites=""``) :func:`site` is a None check.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional

#: the registry: site name → where it fires and what recovery it exercises
FAULT_SITES: Dict[str, str] = {
    "pdhg_nan": (
        "poisons a PDHG warm start with NaN (serial wrapper or one batched "
        "lane) — exercises the in-loop numerical sentinel + float64 host "
        "re-solve quarantine"
    ),
    "qp_nan": (
        "poisons the fused L2 stage's donor iterate — exercises the QP "
        "sentinel and the serial float64 fallback of solve_final_primal_l2"
    ),
    "oracle_raise": (
        "anchor-oracle backend (native/HiGHS) failure — exercises the "
        "retry-once-then-skip policy (anchors are heuristic columns)"
    ),
    "device_dispatch": (
        "device-pricing dispatch raises — exercises the device→host-MILP "
        "rung of the degradation ladder"
    ),
    "batcher_leader_death": (
        "cross-request batcher leader dies after claiming a group, before "
        "dispatch — exercises the follower watchdog / re-election"
    ),
    "warm_slot_corrupt": (
        "a loaded warm-start slot is NaN-corrupted — exercises lane "
        "quarantine (a corrupt warm start must not poison the fleet)"
    ),
    "worker_crash": (
        "the request worker crashes at execution start — exercises the "
        "service retry budget + degradation ladder"
    ),
    "queue_stall": (
        "artificial pre-execution stall — exercises deadline accounting "
        "and graceful DeadlineExceeded rejection"
    ),
    "face_abort": (
        "kills the face-decomposition loop mid-round — exercises the "
        "crash-consistent checkpoint/resume path"
    ),
    "dist_collective": (
        "mesh handout fails (collective init / topology build) — "
        "exercises the mesh→single-device rung of the degradation ladder"
    ),
}


class FaultInjected(RuntimeError):
    """A deliberately injected, transient fault."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site '{site}'")
        self.site = site


def _hash_unit(seed: int, site: str, n: int) -> float:
    """Deterministic uniform value in [0, 1) for consultation ``n`` of
    ``site`` under ``seed``: blake2b, not ``hash()`` (salted per process)
    and not crc32 (linear: consecutive consults would differ by a fixed
    xor, correlating the schedule)."""
    digest = hashlib.blake2b(f"{seed}:{site}:{n}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") / 18446744073709551616.0


class FaultInjector:
    """Parsed ``fault_sites`` spec and per-site consultation counters.
    Thread-safe: the anchor pricer's worker thread consults sites while the
    main thread does; the counters ride one lock."""

    def __init__(self, spec: str, seed: int = 0):
        self.seed = int(seed)
        self.spec = spec or ""
        self._rates: Dict[str, float] = {}
        for part in self.spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rate = part.partition(":")
            name = name.strip()
            if name not in FAULT_SITES:
                raise ValueError(f"unknown fault site {name!r} (known: {sorted(FAULT_SITES)})")
            self._rates[name] = min(max(float(rate or 1.0), 0.0), 1.0)
        self._lock = threading.Lock()
        self._consulted: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}

    def fire(self, site: str) -> bool:
        """Decide whether this consultation of ``site`` fires; an unknown
        site is a programming error."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        rate = self._rates.get(site)
        if rate is None or rate <= 0.0:
            return False
        with self._lock:
            n = self._consulted.get(site, 0)
            self._consulted[site] = n + 1
            hit = _hash_unit(self.seed, site, n) < rate
            if hit:
                self._fired[site] = self._fired.get(site, 0) + 1
        return hit

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"consulted": dict(self._consulted), "fired": dict(self._fired)}


#: process-default injector of offline harnesses and tests
_DEFAULT: Optional[FaultInjector] = None
#: the calling context's injector, installed by an entry point for its call
_REQUEST: ContextVar[Optional[FaultInjector]] = ContextVar(
    "citizens_torch_fault_injector", default=None
)


@contextmanager
def use_injector(inj: Optional[FaultInjector]):
    """Install ``inj`` as the process-default injector for the scope."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, inj
    try:
        yield inj
    finally:
        _DEFAULT = prev


@contextmanager
def request_injector(cfg):
    """Install an injector built from ``cfg.fault_sites``/``cfg.fault_seed``
    as the calling context's for the scope; a no-op when the spec is empty
    or the context already has one (an outer entry point's)."""
    spec = getattr(cfg, "fault_sites", "") if cfg is not None else ""
    if not spec or _REQUEST.get() is not None:
        yield _REQUEST.get()
        return
    inj = FaultInjector(spec, seed=int(getattr(cfg, "fault_seed", 0)))
    token = _REQUEST.set(inj)
    try:
        yield inj
    finally:
        _REQUEST.reset(token)


def active_injector() -> Optional[FaultInjector]:
    """The ambient request context's injector (``service/context.py``),
    else the one an entry point built from ``Config.fault_sites`` for the
    call, else the process default, else None."""
    from citizensassemblies_tpu_torch.service.context import current_context

    ctx = current_context()
    if ctx is not None and ctx.injector is not None:
        return ctx.injector
    inj = _REQUEST.get()
    return inj if inj is not None else _DEFAULT


def site(name: str, log=None, inj: Optional[FaultInjector] = None) -> bool:
    """Consult fault site ``name``; counts ``fault_<name>`` on ``log`` when
    it fires. ``inj`` overrides the ambient lookup: a worker thread outside
    its caller's context (the anchor pricer) captures the injector at
    construction and passes it."""
    if inj is None:
        inj = active_injector()
    if inj is None:
        return False
    if inj.fire(name):
        if log is not None:
            log.count(f"fault_{name}")
        return True
    return False


def raise_if(name: str, log=None, inj: Optional[FaultInjector] = None) -> None:
    """Consult ``name`` and raise :class:`FaultInjected` when it fires, for
    sites whose real-world analog is an exception."""
    if site(name, log, inj=inj):
        raise FaultInjected(name)
