"""Bounded LRU memo for module-level caches of built solver cores.

The package memoizes built callables at module level so repeat calls reuse
them instead of rebuilding: the fused L2 cores (``solvers/qp.py``), one per
iteration schedule. A plain dict there is unbounded: a sweep over iteration
schedules would accrete cores forever. :class:`LRU` bounds each cache with
least-recently-used eviction and counts every eviction into one module
counter, so cache pressure is observable (:func:`memo_evictions`).

Eviction attribution: every LRU entry carries an OWNER (default: the cache's
own name), and evictions are counted both process-wide and per owner
(:func:`memo_evictions_by_owner`). A caller that caps per-tenant state in
its own LRUs inserts with ``owner="tenant:<name>"``, so an eviction says
WHOSE entry went. Counters are lock-guarded, and each LRU's operations
take its own lock: concurrent requests read and fill the shared caches (the
fused L2 cores) and a tenant's session stores from their own threads.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional

#: guards the module-wide eviction counters; LRU instances reuse it —
#: evictions are rare enough that one shared lock is simpler than per-cache
#: locks and never hot
_EVICTION_LOCK = threading.Lock()

#: process-wide eviction count across every LRU memo (observability only)
_EVICTIONS = 0

#: eviction counts split by the evicted ENTRY's owner (cache name, or the
#: owner tag it was inserted with)
_EVICTIONS_BY_OWNER: Dict[str, int] = {}


def memo_evictions() -> int:
    """Total LRU memo evictions since process start, across all caches."""
    return _EVICTIONS


def memo_evictions_by_owner() -> Dict[str, int]:
    """Eviction counts keyed by the evicted entry's owner (a copy; safe to
    hold)."""
    with _EVICTION_LOCK:
        return dict(_EVICTIONS_BY_OWNER)


#: weak registry of every live LRU, so a memory report can walk the caches;
#: weak so a dropped cache leaves no ghost entry
_INSTANCES: "weakref.WeakSet[LRU]" = weakref.WeakSet()


def live_caches() -> List["LRU"]:
    """Every LRU currently alive in the process (a snapshot copy)."""
    with _EVICTION_LOCK:
        return list(_INSTANCES)


class LRU:
    """A small ordered cache with least-recently-used eviction.

    Drop-in for the dict operations the memo sites use (``get``, item
    assignment, ``in``, ``len``, ``clear``, iteration over keys). A hit
    refreshes recency; an insert beyond ``cap`` evicts the oldest entry and
    bumps the global eviction counter — attributed to the evicted entry's
    owner (:meth:`put`), or to the cache's name when none was given.
    """

    def __init__(self, cap: int, name: str = ""):
        self.cap = max(int(cap), 1)
        self.name = name
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._owners: Dict[Any, str] = {}
        self._lock = threading.RLock()
        self.evictions = 0
        with _EVICTION_LOCK:
            _INSTANCES.add(self)

    def get(self, key, default: Optional[Any] = None):
        with self._lock:
            try:
                self._d.move_to_end(key)
            except KeyError:
                return default
            return self._d[key]

    def __getitem__(self, key):
        with self._lock:
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value, owner: Optional[str] = None) -> None:
        """Insert with an explicit OWNER attribution for eviction accounting.
        ``lru[key] = value`` is equivalent with ``owner=None`` — the eviction
        then counts against the cache's own name."""
        global _EVICTIONS
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = value
            if owner is not None:
                self._owners[key] = owner
            else:
                self._owners.pop(key, None)
            while len(self._d) > self.cap:
                old_key, _ = self._d.popitem(last=False)
                old_owner = self._owners.pop(old_key, None) or self.name or "unnamed"
                self.evictions += 1
                with _EVICTION_LOCK:
                    _EVICTIONS += 1
                    _EVICTIONS_BY_OWNER[old_owner] = _EVICTIONS_BY_OWNER.get(old_owner, 0) + 1

    def __setitem__(self, key, value) -> None:
        self.put(key, value)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __iter__(self) -> Iterator:
        with self._lock:
            return iter(list(self._d))

    def items(self) -> List[tuple]:
        """``(key, value)`` of every entry, oldest first (a snapshot that
        refreshes no recency)."""
        with self._lock:
            return list(self._d.items())

    def owned_items(self) -> List[tuple]:
        """``(owner, value)`` of every entry (a snapshot): the entry's owner
        tag, else the cache's name."""
        with self._lock:
            return [(self._owners.get(k) or self.name or "unnamed", v) for k, v in self._d.items()]

    def pop(self, key, default: Optional[Any] = None):
        """Remove and return one entry WITHOUT counting an eviction — a
        deliberate removal is not cache pressure."""
        with self._lock:
            self._owners.pop(key, None)
            return self._d.pop(key, default)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._owners.clear()
