"""Memory ledger: per-phase device-memory accounting.

The ledger answers what the span tracer cannot: not when a phase ran but
what it left resident. Its sources, all read-only:

* on CUDA, the caching allocator: ``torch.cuda.memory_allocated`` (bytes
  held by live tensors), ``torch.cuda.memory_stats`` (``allocated_bytes``
  current and peak, ``active.all.current`` blocks) on the ledger's device;
  the run's high watermark is the largest of them seen;
* the :class:`~citizensassemblies_tpu_torch.utils.memo.LRU` registry
  (``utils/memo.live_caches``): every bounded cache of the process (tenant
  warm-slot stores, ELL packs, result memos, built cores), walked shallowly
  to attribute resident bytes to the owning subsystem or tenant.

On the CPU the allocator has no such counters: a snapshot records zeros and
the stamp says ``"measured": False`` with the device, so no CPU number
stands as a device metric.

Tri-stated by ``Config.obs_memory`` as ``obs_trace`` is: ``False`` hard off
(the dispatch hook never touches this module), ``None`` snapshots whenever
a caller installs a ledger (:func:`use_ledger`), ``True`` the service also
gives each request a ledger and stamps its summary on the audit. A snapshot
reads counters only: no transfer, no synchronisation, no numerics.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

MEMORY_SCHEMA_VERSION = 1

_AMBIENT: ContextVar[Optional["MemoryLedger"]] = ContextVar(
    "citizens_torch_memory_ledger", default=None
)


def ambient_ledger() -> Optional["MemoryLedger"]:
    """The ledger installed on this thread's (or task's) context, if any."""
    return _AMBIENT.get()


@contextmanager
def use_ledger(ledger: Optional["MemoryLedger"]):
    """Install ``ledger`` as the ambient snapshot target for the block."""
    token = _AMBIENT.set(ledger)
    try:
        yield ledger
    finally:
        _AMBIENT.reset(token)


def ledger_enabled(cfg) -> bool:
    """The dispatch-hook gate: ``obs_memory`` hard-off wins over an
    installed ledger."""
    return cfg is None or getattr(cfg, "obs_memory", None) is not False


def device_memory(device=None) -> Dict[str, Any]:
    """The allocator's counters on ``device`` (default: the current CUDA
    device when there is one): ``live_bytes`` (bytes held by tensors),
    ``live_arrays`` (active blocks), ``hbm_bytes_in_use`` and
    ``hbm_peak_bytes``, and ``measured``. Off CUDA every count is 0 with
    ``measured`` False."""
    import torch

    if device is None:
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    else:
        dev = torch.device(device)
    if dev.type != "cuda":
        return {"live_bytes": 0, "live_arrays": 0, "measured": False}
    stats = torch.cuda.memory_stats(dev)
    return {
        "live_bytes": int(torch.cuda.memory_allocated(dev)),
        "live_arrays": int(stats.get("active.all.current", 0)),
        "hbm_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "hbm_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        "measured": True,
    }


def _shallow_nbytes(value: Any, depth: int = 3) -> int:
    """Bytes held by arrays and tensors reachable from ``value`` within
    ``depth`` hops through containers and object fields. Shallow on
    purpose: cache entries are small records (packs, warm slots, results),
    and a bounded walk cannot be wedged by cyclic or exotic objects."""
    if value is None or depth < 0:
        return 0
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(value, dict):
        return sum(_shallow_nbytes(v, depth - 1) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_shallow_nbytes(v, depth - 1) for v in value)
    fields = getattr(value, "__dict__", None)
    if isinstance(fields, dict):
        return sum(_shallow_nbytes(v, depth - 1) for v in fields.values())
    return 0


def owner_attribution() -> Dict[str, int]:
    """Resident bytes per owner, from the LRU registry: keys are the entry
    owners (``tenant:<name>`` for session state) or the cache's own name,
    values the shallow byte totals of the cached entries. This attributes
    the cached population; what a solve allocates and frees shows in the
    snapshot deltas instead."""
    from citizensassemblies_tpu_torch.utils.memo import live_caches

    by_owner: Dict[str, int] = {}
    for cache in live_caches():
        for owner, entry in cache.owned_items():
            by_owner[owner] = by_owner.get(owner, 0) + _shallow_nbytes(entry)
    return by_owner


class MemoryLedger:
    """Per-run (or per-request) accountant of device-memory snapshots.

    ``snapshot(phase)`` records one row; :meth:`stamp` summarizes the run
    for audits; :meth:`series` gives the live-bytes trajectory for
    :func:`leak_verdict`. ``device`` is where the allocator is read
    (default: the current CUDA device, else the CPU's zeros).
    """

    def __init__(self, name: str = "run", attribute_owners: bool = True, device=None):
        self.name = name
        self.attribute_owners = attribute_owners
        self.device = device
        self.records: List[Dict[str, Any]] = []
        self.high_watermark_bytes = 0
        self.measured = False
        self._t0 = time.perf_counter()

    def snapshot(self, phase: str) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "phase": phase,
            "t_s": round(time.perf_counter() - self._t0, 6),
        }
        rec.update(device_memory(self.device))
        self.measured = bool(rec.pop("measured"))
        resident = max(rec["live_bytes"], rec.get("hbm_bytes_in_use", 0))
        peak = max(resident, rec.get("hbm_peak_bytes", 0))
        if peak > self.high_watermark_bytes:
            self.high_watermark_bytes = peak
        self.records.append(rec)
        return rec

    def series(self, phase: Optional[str] = None) -> List[int]:
        """Live-byte trajectory, optionally filtered to one phase name."""
        return [r["live_bytes"] for r in self.records if phase is None or r["phase"] == phase]

    def stamp(self) -> Dict[str, Any]:
        """The ``memory`` block of a service audit."""
        out: Dict[str, Any] = {
            "schema_version": MEMORY_SCHEMA_VERSION,
            "ledger": self.name,
            "snapshots": len(self.records),
            "high_watermark_bytes": self.high_watermark_bytes,
            "measured": self.measured,
        }
        if self.records:
            last = self.records[-1]
            out["live_bytes_last"] = last["live_bytes"]
            out["live_arrays_last"] = last["live_arrays"]
            if "hbm_bytes_in_use" in last:
                out["hbm_bytes_in_use"] = last["hbm_bytes_in_use"]
        if self.attribute_owners:
            owners = owner_attribution()
            out["owners"] = {k: owners[k] for k in sorted(owners, key=owners.get, reverse=True)}
        return out


def leak_verdict(series: List[int]) -> bool:
    """True (leak) when live bytes grew strictly monotonically across at
    least 3 warm repetitions; one flat or descending step clears it."""
    if len(series) < 3:
        return False
    return all(b > a for a, b in zip(series, series[1:]))
