"""Per-tenant session state for the selection service.

A tenant that submits selection jobs repeatedly should not pay cold-start
costs per request, and MUST not leak memory as its request history grows.
:class:`TenantSession` holds the three kinds of cross-request state the
solver stack can reuse, every one LRU-capped (``utils/memo.LRU``) with
evictions attributed to the owning tenant (``memo_evictions_by_owner``):

* **warm-start slot stores** — one ``WarmSlotStore`` per in-flight request
  (``solvers/batch_lp``), keyed by request id. Keeping them in the session
  (instead of module level) is what makes two concurrent requests unable to
  share or clobber warm iterates, and the LRU cap is what stops a tenant's
  request history from pinning host buffers forever.
* **result memos** — completed ``Distribution``s keyed by the full problem
  fingerprint (``utils/checkpoint.problem_fingerprint``: incidence, quotas,
  k, config, households). An identical re-submission is answered from the
  memo (stamped ``memo_hit`` in the audit), and an XMIN request whose
  LEXIMIN seed was already solved for the same problem reuses it via
  ``find_distribution_xmin(..., leximin=...)`` — the service's cheapest win.
* **packed operands** — ``EllPack``s of committee matrices keyed by content
  hash, consulted by the L2 stage (``solvers/qp``) so a repeat solve over
  the same portfolio skips the pack step;
* **delta certificates** — the ``solvers/delta.DeltaState`` a ``revise``
  request re-certifies against, keyed by the instance's content
  fingerprint.

All mutation goes through the session's lock: requests of the same tenant
run concurrently on different worker threads.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from citizensassemblies_tpu_torch.utils.memo import LRU


class TenantSession:
    """One tenant's cross-request solver state, LRU-capped per store."""

    def __init__(self, tenant: str, cap: int = 8):
        self.tenant = tenant
        self.owner = f"tenant:{tenant}"
        cap = max(int(cap), 1)
        self._lock = threading.Lock()
        #: request_id → WarmSlotStore (solvers/batch_lp)
        self.warm_stores: LRU = LRU(cap=cap, name=f"{self.owner}:warm")
        #: problem fingerprint → Distribution
        self.memo: LRU = LRU(cap=cap, name=f"{self.owner}:memo")
        #: content hash → EllPack
        self.packs: LRU = LRU(cap=cap, name=f"{self.owner}:packs")
        #: instance content fingerprint → DeltaState (solvers/delta): the
        #: base certificate a ``revise`` request re-certifies
        #: against. Fingerprint-keying is the staleness contract — a revised
        #: instance has a different fingerprint, so it can never pick up the
        #: pre-edit portfolio by accident
        self.delta: LRU = LRU(cap=cap, name=f"{self.owner}:delta")
        #: pack keys written per in-flight request (request_id → [keys]) —
        #: the rollback ledger: a request that fails mid-solve may have
        #: half-useful packs in the session, and its teardown removes
        #: exactly what it wrote (``rollback_request``)
        self._pack_writes: Dict[str, list] = {}
        #: delta-state keys written per in-flight request — same rollback
        #: discipline as ``_pack_writes``
        self._delta_writes: Dict[str, list] = {}
        self.memo_hits = 0
        self.pack_hits = 0
        self.delta_hits = 0

    # --- warm-slot stores ---------------------------------------------------

    def warm_store_for(self, request_id: str):
        """The request's private warm-slot store (created on first use)."""
        from citizensassemblies_tpu_torch.solvers.batch_lp import WarmSlotStore

        with self._lock:
            store = self.warm_stores.get(request_id)
            if store is None:
                store = WarmSlotStore()
                self.warm_stores.put(request_id, store, owner=self.owner)
            return store

    # --- result memo --------------------------------------------------------

    def memo_get(self, fingerprint: str):
        with self._lock:
            hit = self.memo.get(fingerprint)
            if hit is not None:
                self.memo_hits += 1
            return hit

    def memo_put(self, fingerprint: str, dist) -> None:
        with self._lock:
            self.memo.put(fingerprint, dist, owner=self.owner)

    # --- packed-operand memo ------------------------------------------------

    def pack_get(self, key: str):
        with self._lock:
            hit = self.packs.get(key)
            if hit is not None:
                self.pack_hits += 1
            return hit

    def pack_put(self, key: str, pack, request_id: Optional[str] = None) -> None:
        with self._lock:
            self.packs.put(key, pack, owner=self.owner)
            if request_id is not None:
                self._pack_writes.setdefault(request_id, []).append(key)

    # --- delta base certificates -------------------------------------------

    def delta_get(self, fingerprint: str):
        """The stored :class:`~citizensassemblies_tpu_torch.solvers.delta.DeltaState`
        certified for exactly this instance fingerprint, or None."""
        with self._lock:
            hit = self.delta.get(fingerprint)
            if hit is not None:
                self.delta_hits += 1
            return hit

    def delta_put(
        self, fingerprint: str, state, request_id: Optional[str] = None
    ) -> None:
        with self._lock:
            self.delta.put(fingerprint, state, owner=self.owner)
            if request_id is not None:
                self._delta_writes.setdefault(request_id, []).append(fingerprint)

    # --- request-scoped rollback (robust) -----------------------------------

    def finish_request(self, request_id: str) -> None:
        """Success path: the request's writes become durable session state —
        drop its rollback ledger and keep everything it cached."""
        with self._lock:
            self._pack_writes.pop(request_id, None)
            self._delta_writes.pop(request_id, None)

    def rollback_request(self, request_id: str) -> None:
        """Failure path: remove the request's warm-slot store and every
        session pack it wrote — an aborted request must leave no
        half-written warm state behind (``RequestContext.teardown``)."""
        with self._lock:
            self.warm_stores.pop(request_id, None)
            for key in self._pack_writes.pop(request_id, []):
                self.packs.pop(key, None)
            for key in self._delta_writes.pop(request_id, []):
                self.delta.pop(key, None)

    def stats(self) -> Dict[str, int]:
        """Session-level accounting for the audit stamp."""
        with self._lock:
            return {
                "memo_entries": len(self.memo),
                "pack_entries": len(self.packs),
                "delta_entries": len(self.delta),
                "warm_stores": len(self.warm_stores),
                "memo_hits": self.memo_hits,
                "pack_hits": self.pack_hits,
                "delta_hits": self.delta_hits,
                "evictions": (
                    self.warm_stores.evictions
                    + self.memo.evictions
                    + self.packs.evictions
                    + self.delta.evictions
                ),
            }


class TenantRegistry:
    """Thread-safe tenant → session map owned by one service instance (no
    process-global registry: two services in one process stay independent)."""

    def __init__(self, cap_per_tenant: int = 8):
        self._lock = threading.Lock()
        self._sessions: Dict[str, TenantSession] = {}
        self.cap_per_tenant = max(int(cap_per_tenant), 1)

    def session(self, tenant: str) -> TenantSession:
        with self._lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                sess = TenantSession(tenant, cap=self.cap_per_tenant)
                self._sessions[tenant] = sess
            return sess

    def all_stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            sessions = dict(self._sessions)
        return {t: s.stats() for t, s in sessions.items()}
