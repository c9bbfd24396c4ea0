"""Tenant-affine routing and open-loop load over N serving processes.

A selection platform is a fleet: N independent serving processes (each a
:class:`~citizensassemblies_tpu_torch.service.server.SelectionService` on
its own card), a front router placing tenants, and a load policy that keeps
the fleet inside its SLOs when the offered rate exceeds capacity. This
module owns the fleet's host-side coordination:

* **tenant-affine placement** — :func:`rendezvous_route` maps every tenant
  to exactly one serving process by highest-random-weight (rendezvous)
  hashing over a keyed blake2b digest: stable across processes and runs
  (no ``PYTHONHASHSEED`` dependence), computed by every process with no
  coordination, and growing the fleet from N to N+1 moves only about
  1/(N+1) of the tenants, so a tenant's warm slots, packs, memos and delta
  certificates stay on their process;
* **open-loop load** — :func:`open_loop_schedule` draws seeded Poisson
  arrivals at an offered rate; arrivals do not wait for completions, so
  the sustained rate at fixed p50/p99 sojourn is the measurement;
* **per-process drive and fleet rollup** — :class:`FleetProcess` drives one
  process's share of a global plan and reports a rollup;
  :func:`fleet_aggregate` merges N rollups into the fleet row.

Everything here is deterministic given (seed, rate, tenants, fleet size):
each process rebuilds the same global plan and keeps its own share. The
schedules, routes and covers equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from citizensassemblies_tpu_torch.service.server import (
    AdmissionError,
    SelectionRequest,
    SelectionService,
)
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike

FLEET_SCHEMA_VERSION = 1


# --- tenant-affine placement (rendezvous hashing) ---------------------------


def rendezvous_weight(tenant: str, slot: int) -> int:
    """The (tenant, slot) rendezvous weight: a keyed blake2b digest read as
    an integer. Deterministic across processes and runs by construction —
    ``hash()`` would silently reshuffle the fleet per interpreter."""
    digest = hashlib.blake2b(
        f"{tenant}|{slot}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


def rendezvous_route(tenant: str, n_processes: int) -> int:
    """Highest-random-weight owner of ``tenant`` among ``n_processes``
    slots. Ties are impossible in practice (64-bit digests); the max over
    slots makes membership churn minimal — removing one slot only moves
    the tenants that slot owned."""
    n = max(int(n_processes), 1)
    return max(range(n), key=lambda slot: rendezvous_weight(tenant, slot))


class FleetRouter:
    """The front router: tenant → owning process, with routing accounting.

    Stateless beyond counters — every process can instantiate its own
    router and agree on placement, which is what makes the fleet bench's
    no-IPC plan-sharing work."""

    def __init__(self, n_processes: int):
        self.n_processes = max(int(n_processes), 1)
        self._routed: Dict[int, int] = {i: 0 for i in range(self.n_processes)}

    def route(self, tenant: str) -> int:
        owner = rendezvous_route(tenant, self.n_processes)
        self._routed[owner] += 1
        return owner

    def placement(self, tenants: Sequence[str]) -> Dict[str, int]:
        """The full tenant → process map (counts NOT advanced — this is the
        planning view, :meth:`route` is the serving path)."""
        return {
            t: rendezvous_route(t, self.n_processes) for t in sorted(set(tenants))
        }

    def stats(self) -> Dict[str, Any]:
        total = sum(self._routed.values())
        return {
            "processes": self.n_processes,
            "routed_total": total,
            "routed_per_process": dict(self._routed),
            # the affinity skew gauge: max process share over the fair share
            "skew": round(
                max(self._routed.values()) * self.n_processes / max(total, 1), 3
            ),
        }


def covering_tenants(
    n_tenants: int, n_processes: int, prefix: str = "tenant"
) -> List[str]:
    """At least ``n_tenants`` tenant names, deterministically extended until
    every process owns ≥1 tenant under rendezvous placement — the fleet
    bench's workload must exercise ALL N processes, and with few tenants
    the hash can legitimately leave a slot empty. Pure function of its
    arguments, so every fleet process derives the identical list."""
    names = [f"{prefix}{i}" for i in range(max(int(n_tenants), 1))]
    n = max(int(n_processes), 1)
    i = len(names)
    while len(set(rendezvous_route(t, n) for t in names)) < n and i < 64 * n:
        names.append(f"{prefix}{i}")
        i += 1
    return names


# --- open-loop arrivals -----------------------------------------------------


def open_loop_schedule(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` seeded Poisson arrival offsets (seconds from drive start) at
    ``rate_hz`` offered requests/second: the cumulative sum of exponential
    inter-arrival gaps from ``np.random.default_rng(seed)``. Deterministic
    across runs and platforms — the property the fleet's no-IPC plan
    sharing and the determinism test both pin."""
    rate = max(float(rate_hz), 1e-9)
    rng = np.random.default_rng(int(seed))
    gaps = rng.exponential(scale=1.0 / rate, size=max(int(n), 0))
    return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class PlannedArrival:
    """One slot of the global open-loop plan."""

    index: int  # global arrival index (schedule order)
    t_offset_s: float  # arrival offset from drive start
    tenant: str
    owner: int  # owning fleet process (rendezvous placement)


def plan_open_loop(
    tenants: Sequence[str],
    n_requests: int,
    rate_hz: float,
    n_processes: int,
    seed: int = 0,
) -> List[PlannedArrival]:
    """The global fleet plan: ``n_requests`` Poisson arrivals at the fleet
    offered rate, each assigned a tenant (seeded draw over ``tenants``) and
    its rendezvous owner. Every fleet process rebuilds this identical plan
    from the same (seed, rate, tenants, fleet size) and serves the slice
    ``owner == fleet_process_index()`` — placement without coordination."""
    offsets = open_loop_schedule(rate_hz, n_requests, seed=seed)
    rng = np.random.default_rng(int(seed) + 0x5EED)
    names = list(tenants)
    picks = rng.integers(0, max(len(names), 1), size=max(int(n_requests), 0))
    return [
        PlannedArrival(
            index=i,
            t_offset_s=float(offsets[i]),
            tenant=names[int(picks[i])] if names else "default",
            owner=rendezvous_route(
                names[int(picks[i])] if names else "default", n_processes
            ),
        )
        for i in range(int(n_requests))
    ]


def plan_from_config(
    cfg,
    n_requests: int,
    seed: int = 0,
    n_processes: Optional[int] = None,
    rate_hz: Optional[float] = None,
) -> Tuple[List[str], List[PlannedArrival]]:
    """The global fleet plan derived from the Config knobs: a
    ``fleet_tenants``-sized covering tenant set over the fleet (every
    process owns ≥1 tenant) and ``n_requests`` Poisson arrivals at
    ``fleet_offered_rate_hz``. ``n_processes``/``rate_hz`` override the
    knob resolution (the bench's smoke mode and env contract)."""
    from citizensassemblies_tpu_torch.dist import runtime as dist_runtime

    n = (
        int(n_processes)
        if n_processes is not None
        else dist_runtime.fleet_process_count(cfg)
    )
    rate = float(rate_hz if rate_hz is not None else cfg.fleet_offered_rate_hz)
    tenants = covering_tenants(int(cfg.fleet_tenants), n)
    return tenants, plan_open_loop(tenants, n_requests, rate, n, seed=seed)


# --- per-process drive ------------------------------------------------------


def _terminal(channel, timeout: float) -> Tuple[str, Any]:
    """The channel's terminal event (``("result", …)`` / ``("error", …)``)
    without raising — the open-loop drive classifies outcomes instead of
    aborting on the first typed rejection."""
    last = ("error", "channel closed early")
    try:
        for kind, payload in channel.events(timeout=timeout):
            last = (kind, payload)
    except TimeoutError:
        return ("error", "drain timeout")
    return last


class FleetProcess:
    """One serving process of the fleet: a :class:`SelectionService` on
    ``device`` (CUDA unless the caller passes another) plus the open-loop
    driver for this process's share of a global plan."""

    def __init__(
        self, index: int, n_processes: int, cfg: Optional[Config] = None,
        device: DeviceLike = None,
    ):
        self.index = int(index)
        self.router = FleetRouter(n_processes)
        self.service = SelectionService(cfg, device=device)

    def drive(
        self,
        arrivals: Sequence[Tuple[PlannedArrival, SelectionRequest]],
        timeout_s: float = 600.0,
        on_result=None,
    ) -> Dict[str, Any]:
        """Submit each request at its scheduled offset — open loop, never
        waiting for completions — then drain every channel and roll up this
        process's serving metrics. ``on_result(plan, result)`` is invoked
        for every completed request during the drain (the bench's hook for
        checking served allocations against serial references without the
        rollup having to carry whole result objects)."""
        ordered = sorted(arrivals, key=lambda ar: ar[0].t_offset_s)
        t0 = time.monotonic()
        live: List[Tuple[PlannedArrival, Any]] = []
        admission_rejected = 0
        for plan, request in ordered:
            self.router.route(plan.tenant)
            delay = (t0 + plan.t_offset_s) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                live.append((plan, self.service.submit(request)))
            except AdmissionError:
                admission_rejected += 1
        offered_s = max(time.monotonic() - t0, 1e-9)
        completed = 0
        memo_served = 0
        shed = 0
        failed = 0
        sojourns: List[float] = []
        for plan, channel in live:
            kind, payload = _terminal(channel, timeout_s)
            if kind == "result":
                completed += 1
                memo_served += 1 if payload.from_memo else 0
                soj = payload.audit.get("sojourn")
                sojourns.append(
                    float(soj["total_s"]) if soj else float(payload.seconds)
                )
                if on_result is not None:
                    on_result(plan, payload)
            elif isinstance(payload, dict) and payload.get("kind") == "ShedRejection":
                shed += 1
            else:
                failed += 1
        drained_s = max(time.monotonic() - t0, 1e-9)
        ordered_soj = sorted(sojourns)

        def pct(q: float) -> float:
            if not ordered_soj:
                return 0.0
            rank = min(len(ordered_soj) - 1, int(round(q * (len(ordered_soj) - 1))))
            return ordered_soj[rank]

        stats = self.service.stats()
        rollup: Dict[str, Any] = {
            "schema_version": FLEET_SCHEMA_VERSION,
            "process": self.index,
            "offered": len(ordered),
            "submitted": len(live),
            "completed": completed,
            "memo_served": memo_served,
            "shed": shed,
            "admission_rejected": admission_rejected,
            "failed": failed,
            "offered_window_s": round(offered_s, 3),
            "drained_s": round(drained_s, 3),
            "sustained_req_per_s": round(completed / drained_s, 2),
            "p50_sojourn_s": round(pct(0.50), 4),
            "p99_sojourn_s": round(pct(0.99), 4),
            "sojourns_s": [round(s, 4) for s in sojourns],
            "batcher": stats["batcher"],
            "router": self.router.stats(),
        }
        if self.service.load_policy is not None:
            rollup["load_policy"] = self.service.load_policy.stamp()
        if self.service.slo is not None:
            report = self.service.slo.evaluate()
            rollup["slo_ok"] = report["slo_ok"]
            rollup["slo_events"] = report["events"]
        return rollup

    def shutdown(self) -> None:
        self.service.shutdown()

    def __enter__(self) -> "FleetProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# --- fleet-level rollup -----------------------------------------------------

#: batcher counters summed process-wise into the fleet aggregate
_SUM_BATCHER = (
    "submissions", "dispatches", "fused_dispatches", "solves",
    "mesh_dispatches", "dist_placements", "dist_reshards",
)


def fleet_aggregate(rollups: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-process rollups into the fleet row: pooled sojourn
    percentiles (over every completed request, not averaged per-process
    percentiles), fleet sustained rate over the slowest process's window,
    and summed batcher/mesh/shed accounting. ``dist_reshards`` summed here
    IS the fleet's steady-state reshard gauge — the bench asserts 0."""
    pooled: List[float] = []
    for r in rollups:
        pooled.extend(r.get("sojourns_s", []))
    pooled.sort()

    def pct(q: float) -> float:
        if not pooled:
            return 0.0
        rank = min(len(pooled) - 1, int(round(q * (len(pooled) - 1))))
        return pooled[rank]

    wall = max((r.get("drained_s", 0.0) for r in rollups), default=1e-9)
    completed = sum(r.get("completed", 0) for r in rollups)
    batcher = {
        k: sum(int(r.get("batcher", {}).get(k, 0)) for r in rollups)
        for k in _SUM_BATCHER
    }
    batcher["mesh_devices_max"] = max(
        (int(r.get("batcher", {}).get("mesh_devices_max", 0)) for r in rollups),
        default=0,
    )
    return {
        "schema_version": FLEET_SCHEMA_VERSION,
        "processes": len(rollups),
        "offered": sum(r.get("offered", 0) for r in rollups),
        "completed": completed,
        "memo_served": sum(r.get("memo_served", 0) for r in rollups),
        "shed": sum(r.get("shed", 0) for r in rollups),
        "failed": sum(r.get("failed", 0) for r in rollups),
        "sustained_req_per_s": round(completed / max(wall, 1e-9), 2),
        "p50_sojourn_s": round(pct(0.50), 4),
        "p99_sojourn_s": round(pct(0.99), 4),
        "batcher": batcher,
        "steady_state_reshards": batcher["dist_reshards"],
        "slo_ok": all(r.get("slo_ok", True) for r in rollups),
    }
