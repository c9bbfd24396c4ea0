"""Cross-request shape-bucketed batching: fuse LP fleets across requests.

The batched LP engine (``solvers/batch_lp``) solves the many small LPs of
one selection job per shape bucket. A serving workload is a fleet of whole
jobs, each with a small LP fleet (a small pool's probe prescreen), and each
alone pays the dispatch floor. When concurrent requests' worker threads
reach ``solve_lp_batch``, this batcher holds their fleets open for
``Config.serve_batch_window_ms`` and merges them (same iteration schedule,
same device, any mix of shapes: the engine's buckets then group the union)
into one engine call, so a probe fleet of tenant A and one of tenant B land
in the same buckets.

Invariants:

* **per-instance math unchanged** — merging only concatenates instance
  lists; each instance keeps its own tolerance (set on ``BatchLP.tol``
  before the merge) and its own lane, as within one request;
* **schedule and device compatibility** — fleets merge only within a group
  key of (max_iters, check_every, bucket cap, transfer-guard mode, device),
  so no request runs under another's schedule and fleets of different
  devices never merge;
* **warm-slot isolation** — each submission's warm slots are loaded from
  and written back to its own request's store under its tenant/request
  key; positions inside the merged list never touch the slot keys;
* **no deadlock** — the first submitter of a group leads: it sleeps out
  the window, then dispatches whatever joined; followers wait on an event
  under a watchdog that re-elects a follower when the leader dies before
  dispatching, and a last-resort timeout solves a follower's fleet alone.

The batcher owns no threads (it runs on the submitting requests' worker
threads) and no device state: host-side coordination only. The merged
dispatch runs on the leader's thread under the leader's context, so the
engine's fault evidence of the merged call is booked to the leader's log
and each owner's warm slots and counters are written here, per owner.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from citizensassemblies_tpu_torch.dist import runtime as dist_runtime
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.utils.config import Config, default_config

#: follower safety net of last resort: past this, a follower re-claims its
#: own fleet and solves solo even if leadership state looks healthy
_FOLLOWER_TIMEOUT_S = 120.0

#: floor on the follower watchdog's poll interval — each wake checks the
#: leader's liveness (thread dead / claim released), so a dead leader is
#: detected within ~2 window widths instead of the 120 s safety net
_WATCHDOG_POLL_S = 0.05

#: one mesh-spanning dispatch in flight per process: two leaders' merged
#: fleets dealt over the same ranks could interleave their collectives
#: (rank 0 in fleet A's gather while rank 1 is in fleet B's) and deadlock.
#: Single-device dispatches never take this lock.
_MESH_DISPATCH_LOCK = threading.Lock()


class _Pending:
    """One request's deferred fleet, parked until the group dispatches."""

    def __init__(self, problems, ctx, warm_key: Optional[str], log):
        self.problems = list(problems)
        self.ctx = ctx
        self.warm_key = warm_key
        self.log = log
        self.event = threading.Event()
        self.results: Optional[list] = None
        self.error: Optional[BaseException] = None


class CrossRequestBatcher:
    """Merge compatible ``solve_lp_batch`` fleets from concurrent requests."""

    def __init__(self, cfg: Optional[Config] = None):
        cfg = cfg or default_config()
        #: how long the group leader holds the window open for other
        #: requests' fleets to join (Config.serve_batch_window_ms)
        self.window_s = max(float(cfg.serve_batch_window_ms), 0.0) / 1000.0
        self._lock = threading.Lock()
        self._groups: Dict[tuple, List[_Pending]] = {}
        self._leaders: Set[tuple] = set()
        #: the leader's THREAD per claimed group — the followers' heartbeat:
        #: a claim whose thread is no longer alive is a dead leader, and the
        #: first follower to notice re-elects itself and dispatches
        self._leader_threads: Dict[tuple, threading.Thread] = {}
        # --- occupancy accounting (the fleet rollup and the gauges) ----------
        self._stats = {
            "submissions": 0,          # solve_lp_batch calls deferred here
            "dispatches": 0,           # merged engine calls made
            "fused_dispatches": 0,     # … that merged ≥2 distinct requests
            "solves": 0,               # real LP instances solved
            "max_requests_fused": 0,   # largest request count in one merge
            "leader_deaths": 0,        # leaders that died before dispatch
            "leader_reclaims": 0,      # follower re-elections after a death
            # --- mesh-spanning dispatch accounting ---------------------------
            "mesh_dispatches": 0,      # merged calls laid out over a mesh
            "mesh_devices_max": 0,     # widest mesh a dispatch spanned
            "dist_placements": 0,      # operands placed into their layout
            "dist_reshards": 0,        # steady state must be 0
        }

    # --- public API ---------------------------------------------------------

    def submit(
        self,
        problems: Sequence,
        ctx,
        cfg: Optional[Config] = None,
        log=None,
        warm_key: Optional[str] = None,
        tol: Optional[float] = None,
        max_iters: Optional[int] = None,
        device=None,
    ) -> list:
        """Solve ``problems`` on ``device`` through the cross-request window;
        returns the per-instance solutions in input order (the
        ``solve_lp_batch`` contract — call sites cannot tell they were
        fused)."""
        import torch

        from citizensassemblies_tpu_torch.utils.device import resolve_device

        cfg = cfg or default_config()
        device = resolve_device(device)
        # materialize each instance's effective tolerance NOW: after the
        # merge there is no per-submission tol argument anymore
        base_tol = float(tol if tol is not None else cfg.pdhg_tol)
        problems = [
            p if p.tol is not None else dataclasses.replace(p, tol=base_tol)
            for p in problems
        ]
        key = (
            int(max_iters if max_iters is not None else cfg.pdhg_max_iters),
            int(cfg.pdhg_check_every),
            int(cfg.lp_batch_bucket_max),
            str(cfg.transfer_guard),
            str(torch.device(device)),
        )
        pend = _Pending(problems, ctx, warm_key, log)
        with self._lock:
            self._stats["submissions"] += 1
            self._groups.setdefault(key, []).append(pend)
            lead = key not in self._leaders
            if lead:
                self._leaders.add(key)
                self._leader_threads[key] = threading.current_thread()
        if lead:
            dispatched = False
            try:
                if self.window_s > 0:
                    # the leader's share of the fusion window — timed as
                    # "batch_window" so the sojourn decomposition and the
                    # trace CLI's fusion timeline see it (followers time
                    # their whole coupled wait under the same name)
                    if log is not None:
                        with log.timer("batch_window"):
                            time.sleep(self.window_s)  # GIL released
                    else:
                        time.sleep(self.window_s)  # GIL released; followers join
                # chaos: the leader "dies" after claiming the group, before
                # dispatch — the exact hang the follower watchdog exists for
                inject.raise_if("batcher_leader_death", log)
                with self._lock:
                    batch = self._groups.pop(key, [])
                    self._leaders.discard(key)
                    self._leader_threads.pop(key, None)
                dispatched = True
                self._dispatch(key, batch, cfg)
            finally:
                if not dispatched:
                    # the leader is dying between claim and dispatch (an
                    # exception here; a hard thread kill skips this and is
                    # caught by the is_alive() heartbeat instead): release
                    # the claim so the watchdog re-elects promptly
                    with self._lock:
                        self._leaders.discard(key)
                        self._leader_threads.pop(key, None)
                        self._stats["leader_deaths"] += 1
        else:
            if pend.log is not None:
                with pend.log.timer("batch_window"):
                    self._follower_wait(key, pend, cfg)
            else:
                self._follower_wait(key, pend, cfg)
        if pend.error is not None:
            raise pend.error
        return pend.results

    def _follower_wait(self, key: tuple, pend: _Pending, cfg: Config) -> None:
        """Wait for the leader's dispatch under the liveness watchdog.

        Every poll interval the follower checks the group's leadership: a
        claim that was released without a dispatch, or whose leader THREAD
        is no longer alive, is a dead leader — the first follower to see it
        re-elects itself and dispatches the whole remaining group (so its
        group-mates are rescued too, not just its own fleet). The old
        120 s full-window wait is kept only as the safety net of last
        resort."""
        waited = 0.0
        poll = max(self.window_s * 2.0, _WATCHDOG_POLL_S)
        while not pend.event.wait(timeout=poll):
            waited += poll
            with self._lock:
                in_group = any(p is pend for p in self._groups.get(key, []))
                lt = self._leader_threads.get(key)
                leader_dead = in_group and (
                    key not in self._leaders
                    or (lt is not None and not lt.is_alive())
                )
                if leader_dead:
                    # re-elect: claim the group before releasing the lock so
                    # exactly one follower becomes the new leader
                    self._leaders.add(key)
                    self._leader_threads[key] = threading.current_thread()
                    self._stats["leader_reclaims"] += 1
            if leader_dead:
                if pend.log is not None:
                    pend.log.count("batcher_leader_reclaim")
                with self._lock:
                    batch = self._groups.pop(key, [])
                    self._leaders.discard(key)
                    self._leader_threads.pop(key, None)
                self._dispatch(key, batch, cfg)
                return
            if waited >= _FOLLOWER_TIMEOUT_S:
                # last-resort: re-claim only our own fleet and solve solo
                with self._lock:
                    group = self._groups.get(key, [])
                    mine = pend in group
                    if mine:
                        group.remove(pend)
                if mine:
                    self._dispatch(key, [pend], cfg)
                else:
                    pend.event.wait()  # dispatch in flight — finish it
                return

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    # --- dispatch -----------------------------------------------------------

    def _dispatch(self, key: tuple, batch: List[_Pending], cfg: Config) -> None:
        """Run the merged fleet through the engine and fan results back."""
        from citizensassemblies_tpu_torch.solvers.batch_lp import (
            _DEFAULT_WARM_STORE,
            solve_lp_batch,
        )
        from citizensassemblies_tpu_torch.utils.logging import RunLog

        if not batch:
            return
        max_iters, _check, _cap, _tg, device = key
        try:
            merged = []
            spans: List[Tuple[int, int]] = []
            for pend in batch:
                start = len(merged)
                store = scoped = None
                if pend.warm_key is not None and pend.ctx is not None:
                    store = pend.ctx.warm_store or _DEFAULT_WARM_STORE
                    scoped = pend.ctx.scoped_warm_key(pend.warm_key)
                probs = []
                for i, inst in enumerate(pend.problems):
                    if inst.warm is None and store is not None:
                        slot = store.get((scoped, i))
                        if slot is not None:
                            inst = dataclasses.replace(inst, warm=slot[:3])
                    probs.append(inst)
                merged.extend(probs)
                spans.append((start, len(merged)))
            # a world of several devices deals the merged fleet's lanes over
            # the mesh (None on one device: the engine's path is unchanged).
            # A fleet smaller than the mesh stays undealt: the undealt
            # dispatch is the layout the bit-identity with a solo solve holds
            mesh = dist_runtime.effective_mesh(cfg)
            if mesh is not None and len(merged) < int(mesh.size()):
                mesh = None
            # the engine counts its layout work (dist_placements,
            # dist_reshards) into this dispatch-scoped log, summed into the
            # batcher's stats below for the fleet rollup
            dispatch_log = RunLog(echo=False)
            # each instance's owner: its lane's fault sites and counts are
            # its own request's, not the leader's
            owners = [p.ctx for p in batch for _ in p.problems]
            kw = dict(
                cfg=cfg, log=dispatch_log, warm_key=None, max_iters=max_iters, defer=False,
                mesh=mesh, device=device, owners=owners,
            )
            if mesh is not None:
                with _MESH_DISPATCH_LOCK:
                    sols = solve_lp_batch(merged, **kw)
            else:
                sols = solve_lp_batch(merged, **kw)
            n_requests = len({
                (p.ctx.tenant, p.ctx.request_id)
                for p in batch if p.ctx is not None
            })
            with self._lock:
                self._stats["dispatches"] += 1
                self._stats["solves"] += len(merged)
                if n_requests > 1:
                    self._stats["fused_dispatches"] += 1
                self._stats["max_requests_fused"] = max(
                    self._stats["max_requests_fused"], n_requests
                )
                if mesh is not None:
                    self._stats["mesh_dispatches"] += 1
                    self._stats["mesh_devices_max"] = max(
                        self._stats["mesh_devices_max"], int(mesh.size()),
                    )
                self._stats["dist_placements"] += int(
                    dispatch_log.counters.get("dist_placements", 0)
                )
                self._stats["dist_reshards"] += int(
                    dispatch_log.counters.get("dist_reshards", 0)
                )
            for pend, (start, end) in zip(batch, spans):
                out = sols[start:end]
                if pend.warm_key is not None and pend.ctx is not None:
                    store = pend.ctx.warm_store or _DEFAULT_WARM_STORE
                    scoped = pend.ctx.scoped_warm_key(pend.warm_key)
                    for i, (inst, sol) in enumerate(zip(pend.problems, out)):
                        store.put(
                            (scoped, i),
                            (sol.x, sol.lam, sol.mu, int(inst.tail_vars)),
                        )
                if pend.log is not None:
                    pend.log.count("lp_batch_solves", len(out))
                    pend.log.count("lp_batch_xreq_dispatches")
                    if n_requests > 1:
                        pend.log.count("lp_batch_xreq_fused")
                pend.results = out
                pend.event.set()
        except BaseException as exc:
            for pend in batch:
                if pend.results is None:
                    pend.error = exc
                    pend.event.set()
            raise
