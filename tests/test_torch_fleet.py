"""The port's fleet layer against the JAX package's, on the CPU.

The 17 cases of ``tests/test_fleet.py`` other than its trend-loader case
(which waits for ROADMAP queue A item 4): open-loop schedules, plans,
routes, tenant covers and router stats equal the JAX package's exactly;
the SLO load policy walks the same states under the same injected clock
and degrades a config by the same rungs; a shed request gets the same
typed rejection; a fleet drive serves allocations bit for bit its serial
references and within 1e-3 of the JAX package's; artifact paths scope the
same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.core.generator import random_instance as j_random_instance
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.dist import runtime as j_runtime
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.obs.slo import SloEngine as JSloEngine
from citizensassemblies_tpu.obs.slo import SloLoadPolicy as JSloLoadPolicy
from citizensassemblies_tpu.service import fleet as jfleet
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch.core.generator import random_instance
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.dist import runtime as dist_runtime
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.obs.slo import SloEngine, SloLoadPolicy
from citizensassemblies_tpu_torch.service import (
    FleetProcess,
    FleetRouter,
    SelectionRequest,
    SelectionService,
    covering_tenants,
    open_loop_schedule,
    plan_from_config,
    plan_open_loop,
    rendezvous_route,
)
from citizensassemblies_tpu_torch.service.fleet import PlannedArrival
from citizensassemblies_tpu_torch.utils.config import default_config

torch.set_num_threads(1)


def _tiny(seed=0, n=24, k=5):
    return featurize(random_instance(n=n, k=k, n_categories=2, seed=seed), device="cpu")


def _same_plan(plan, jplan):
    return [dataclasses.astuple(a) for a in plan] == [dataclasses.astuple(a) for a in jplan]


# --- seeded Poisson arrivals ---------------------------------------------------------


def test_open_loop_schedule_deterministic_across_runs():
    a = open_loop_schedule(50.0, 200, seed=7)
    np.testing.assert_array_equal(a, open_loop_schedule(50.0, 200, seed=7))
    np.testing.assert_array_equal(a, jfleet.open_loop_schedule(50.0, 200, seed=7))
    assert len(a) == 200
    assert np.all(np.diff(a) > 0)
    assert not np.array_equal(a, open_loop_schedule(50.0, 200, seed=8))


def test_open_loop_schedule_matches_offered_rate():
    sched = open_loop_schedule(20.0, 5000, seed=3)
    np.testing.assert_array_equal(sched, jfleet.open_loop_schedule(20.0, 5000, seed=3))
    mean_gap = float(sched[-1]) / len(sched)
    assert abs(mean_gap - 1.0 / 20.0) / (1.0 / 20.0) < 0.1


def test_plan_from_config_reads_the_fleet_knobs():
    knobs = dict(fleet_tenants=4, fleet_offered_rate_hz=100.0, fleet_processes=2)
    tenants, plan = plan_from_config(default_config().replace(**knobs), 10, seed=1)
    jtenants, jplan = jfleet.plan_from_config(jcfg().replace(**knobs), 10, seed=1)
    assert tenants == jtenants and _same_plan(plan, jplan)
    assert len(tenants) >= 4
    assert len(plan) == 10
    assert {a.owner for a in plan} <= {0, 1}
    _t2, p2 = plan_from_config(default_config().replace(**knobs), 10, seed=1, n_processes=2,
                               rate_hz=100.0)
    assert p2 == plan


def test_plan_open_loop_identical_across_processes():
    tenants = covering_tenants(8, 4)
    assert tenants == jfleet.covering_tenants(8, 4)
    p1 = plan_open_loop(tenants, 100, 50.0, 4, seed=11)
    assert p1 == plan_open_loop(tenants, 100, 50.0, 4, seed=11)
    assert _same_plan(p1, jfleet.plan_open_loop(tenants, 100, 50.0, 4, seed=11))
    for a in p1:
        assert a.owner == rendezvous_route(a.tenant, 4)


# --- rendezvous placement ----------------------------------------------------------------


def test_rendezvous_route_stable_and_in_range():
    for n in (1, 2, 4, 8):
        for t in ("civic", "tenant0", "tenant13", "default"):
            owner = rendezvous_route(t, n)
            assert 0 <= owner < n
            assert owner == rendezvous_route(t, n) == jfleet.rendezvous_route(t, n)


def test_rendezvous_growth_moves_a_minority():
    tenants = [f"tenant{i}" for i in range(200)]
    before = {t: rendezvous_route(t, 4) for t in tenants}
    after = {t: rendezvous_route(t, 5) for t in tenants}
    assert after == {t: jfleet.rendezvous_route(t, 5) for t in tenants}
    moved = sum(1 for t in tenants if before[t] != after[t])
    assert moved < len(tenants) // 2
    assert all(after[t] == 4 for t in tenants if before[t] != after[t])


def test_covering_tenants_leaves_no_process_idle():
    for n in (2, 3, 4, 8):
        names = covering_tenants(8, n)
        assert names == jfleet.covering_tenants(8, n)
        assert len(names) >= 8
        assert {rendezvous_route(t, n) for t in names} == set(range(n))


def test_router_stats_track_routing():
    router, jrouter = FleetRouter(4), jfleet.FleetRouter(4)
    for t in covering_tenants(8, 4):
        router.route(t)
        jrouter.route(t)
    st = router.stats()
    assert st == jrouter.stats()
    assert st["processes"] == 4
    assert st["routed_total"] == sum(st["routed_per_process"].values())
    assert st["skew"] >= 1.0
    assert router.placement(covering_tenants(8, 4)) == jrouter.placement(covering_tenants(8, 4))


# --- the SLO load policy: shed and re-arm under an injected clock --------------------------


def _policy(engine_cls, policy_cls, cfg, now, window_s=60.0, max_rungs=3):
    cfg = cfg.replace(
        serve_shed=True, serve_shed_burn=2.0, serve_shed_recover=0.5,
        serve_shed_window_s=window_s, serve_shed_max_rungs=max_rungs,
    )
    clock = lambda: now[0]  # noqa: E731 - shared mutable test clock
    engine = engine_cls("error_rate:0.01", clock=clock)
    return engine, policy_cls(engine, cfg, clock=clock)


def _sustained_burn(engine_cls, policy_cls, cfg):
    now = [1000.0]
    engine, policy = _policy(engine_cls, policy_cls, cfg, now)
    states = [(policy.update(), policy.shedding, policy.rung)]
    engine.record("civic", 0.1, ok=False)
    policy.update()
    states.append((policy.shedding, policy.rung))
    for _ in range(10):
        now[0] += policy.cooldown_s + 0.01
        engine.record("civic", 0.1, ok=False)
        policy.update()
        states.append((policy.shedding, policy.rung, policy.worst_burn))
    stub = policy.shed("civic", "req-1")
    return states, stub, policy


def test_policy_sheds_and_descends_under_sustained_burn():
    states, stub, policy = _sustained_burn(SloEngine, SloLoadPolicy, default_config())
    jstates, jstub, _jp = _sustained_burn(JSloEngine, JSloLoadPolicy, jcfg())
    assert states == jstates and stub == jstub
    assert states[0] == (0.0, False, 0)
    assert states[1] == (True, 1)
    assert policy.rung == policy.max_rungs == 3
    assert {"tenant", "request_id", "worst_burn", "rung", "t"} <= set(stub)
    assert policy.shed_total == 1


def test_policy_rearms_when_the_window_drains():
    def run(engine_cls, policy_cls, cfg):
        now = [0.0]
        engine, policy = _policy(engine_cls, policy_cls, cfg, now, window_s=10.0)
        engine.record("civic", 0.1, ok=False)
        policy.update()
        first = policy.shedding
        now[0] += 11.0
        policy.update()
        return first, policy.stamp(), policy

    first, stamp, policy = run(SloEngine, SloLoadPolicy, default_config())
    jfirst, jstamp, _jp = run(JSloEngine, JSloLoadPolicy, jcfg())
    assert (first, stamp) == (jfirst, jstamp)
    assert first and not policy.shedding and policy.rung == 0
    assert policy.rearm_total == 1
    cfg = default_config()
    assert policy.degraded(cfg) is cfg


def test_policy_degraded_applies_ladder_rungs():
    """Rung 1 is the JAX package's kernel → chained-ops rung, which the port
    does not have (a kernel's failure raises): it leaves the port's config
    as it is. Every later rung changes the fields the JAX package's changes,
    to the same values, besides that rung's ``pdhg_megakernel``."""

    def run(engine_cls, policy_cls, cfg, rungs):
        now = [0.0]
        engine, policy = _policy(engine_cls, policy_cls, cfg, now)
        out = []
        for _ in range(rungs):
            now[0] += policy.cooldown_s + 0.01
            engine.record("civic", 0.1, ok=False)
            policy.update()
            out.append((policy.rung, policy.degraded(cfg)))
        return out

    cfg, jc = default_config(), jcfg()
    got, jgot = run(SloEngine, SloLoadPolicy, cfg, 3), run(JSloEngine, JSloLoadPolicy, jc, 3)
    assert [r for r, _ in got] == [r for r, _ in jgot] == [1, 2, 3]
    assert jgot[0][1].pdhg_megakernel is False and cfg.pdhg_megakernel is None
    assert got[0][1] is cfg
    for (_r, degraded), (_jr, jdegraded) in zip(got, jgot):
        changed = {
            f.name: getattr(degraded, f.name) for f in dataclasses.fields(degraded)
            if getattr(degraded, f.name) != getattr(cfg, f.name)
        }
        jchanged = {
            k: v for k, v in dataclasses.asdict(jdegraded).items()
            if v != getattr(jc, k) and k != "pdhg_megakernel"
        }
        assert changed == jchanged
    assert got[2][1].decomp_device_pricing is False and got[2][1].sparse_ops is False
    assert got[2][1].lp_batch is None


# --- typed shedding through the service ------------------------------------------------------


def test_shed_requests_get_typed_rejection_with_audit_stub():
    dense, space = _tiny(seed=3)
    cfg = default_config().replace(
        obs_slo_spec="error_rate:0.01", serve_shed=True, serve_shed_window_s=60.0,
        serve_batch_window_ms=0.0,
    )
    with SelectionService(cfg, device="cpu") as svc:
        with pytest.raises(RuntimeError):
            svc.run(SelectionRequest(algorithm="nope", dense=dense, space=space), timeout=60)
        assert svc.load_policy is not None and svc.load_policy.shedding
        in_flight_before = svc.stats()["in_flight"]
        ch = svc.submit(SelectionRequest(dense=dense, space=space, tenant="civic"))
        events = list(ch.events(timeout=10))
        assert len(events) == 1
        kind, payload = events[0]
        assert kind == "error"
        assert payload["kind"] == "ShedRejection"
        stub = payload["audit"]
        assert stub["tenant"] == "civic"
        assert stub["worst_burn"] >= stub["burn_threshold"]
        assert {"request_id", "rung", "window_s", "t"} <= set(stub)
        assert svc.stats()["in_flight"] == in_flight_before
        snap = svc.metrics_snapshot()
        assert snap["load_policy"]["shed_total"] == 1
        assert 'graftserve_shed_total{tenant="civic"} 1' in svc.metrics_text()


def test_unarmed_service_never_sheds():
    dense, space = _tiny(seed=3)
    cfg = default_config().replace(obs_slo_spec="error_rate:0.01", serve_batch_window_ms=0.0)
    with SelectionService(cfg, device="cpu") as svc:
        assert svc.load_policy is None
        with pytest.raises(RuntimeError):
            svc.run(SelectionRequest(algorithm="nope", dense=dense, space=space), timeout=60)
        res = svc.run(SelectionRequest(dense=dense, space=space, tenant="civic"), timeout=600)
        assert res.allocation is not None


# --- fleet vs single-process bit-identity ------------------------------------------------------


def test_fleet_drive_bit_identical_to_serial():
    cfg = default_config().replace(lp_batch=True, serve_batch_window_ms=2.0)
    n_proc = 2
    tenants = covering_tenants(4, n_proc)
    insts = {t: random_instance(n=24, k=4, n_categories=2, seed=i) for i, t in enumerate(tenants[:4])}
    refs = {}
    for i, (t, inst) in enumerate(insts.items()):
        d, s = featurize(inst, device="cpu")
        refs[t] = np.asarray(find_distribution_leximin(d, s, cfg=cfg, device="cpu").allocation)
        jd, js = j_featurize(j_random_instance(n=24, k=4, n_categories=2, seed=i))
        jref = np.asarray(j_leximin(jd, js, cfg=jcfg().replace(lp_batch=True)).allocation)
        assert float(np.abs(refs[t] - jref).max()) <= 1e-3
    plan = plan_open_loop(list(insts), 8, 1000.0, n_proc, seed=5)
    assert _same_plan(plan, jfleet.plan_open_loop(list(insts), 8, 1000.0, n_proc, seed=5))
    got = {}
    for idx in range(n_proc):
        items = [
            (a, SelectionRequest(instance=insts[a.tenant], tenant=a.tenant))
            for a in plan if a.owner == idx
        ]
        if not items:
            continue
        with FleetProcess(idx, n_proc, cfg, device="cpu") as fp:
            rollup = fp.drive(
                items, timeout_s=600.0,
                on_result=lambda a, r: got.setdefault(a.tenant, np.asarray(r.allocation)),
            )
        assert rollup["failed"] == 0 and rollup["shed"] == 0
        assert rollup["completed"] == len(items)
        assert set(rollup) >= {"p50_sojourn_s", "p99_sojourn_s", "memo_served", "batcher"}
    assert set(got) == {a.tenant for a in plan}
    for t, alloc in got.items():
        assert np.array_equal(alloc, refs[t]), f"fleet drive diverged for {t}"


# --- artifact-path scoping ----------------------------------------------------------------------


def test_scoped_artifact_path_suffixes_by_process(monkeypatch):
    monkeypatch.setenv(dist_runtime.ENV_FLEET_PROCESSES, "4")
    monkeypatch.setenv(dist_runtime.ENV_FLEET_INDEX, "2")
    assert dist_runtime.fleet_process_count() == 4 == j_runtime.fleet_process_count()
    assert dist_runtime.fleet_process_index() == 2 == j_runtime.fleet_process_index()
    for path in ("artifacts/trace_serve.json",):
        assert dist_runtime.scoped_artifact_path(path) == "artifacts/trace_serve.p2.json"
        assert j_runtime.scoped_artifact_path(path) == "artifacts/trace_serve.p2.json"
    monkeypatch.setenv(dist_runtime.ENV_FLEET_INDEX, "0")
    assert dist_runtime.scoped_artifact_path("artifacts/metrics.prom") == "artifacts/metrics.p0.prom"


def test_scoped_artifact_path_single_process_unchanged(monkeypatch):
    monkeypatch.delenv(dist_runtime.ENV_FLEET_PROCESSES, raising=False)
    monkeypatch.delenv(dist_runtime.ENV_FLEET_INDEX, raising=False)
    assert dist_runtime.scoped_artifact_path("artifacts/trace_serve.json") == "artifacts/trace_serve.json"


# --- planned arrivals carry the routing facts ------------------------------------------------------


def test_planned_arrival_slots_are_complete():
    plan = plan_open_loop(["a", "b"], 5, 10.0, 2, seed=0)
    assert _same_plan(plan, jfleet.plan_open_loop(["a", "b"], 5, 10.0, 2, seed=0))
    assert [a.index for a in plan] == [0, 1, 2, 3, 4]
    assert all(isinstance(a, PlannedArrival) for a in plan)
    assert all(a.tenant in ("a", "b") for a in plan)
    assert all(a.owner == rendezvous_route(a.tenant, 2) for a in plan)
    # the fleet rollup merges as the JAX package's
    rollups = [
        {"sojourns_s": [0.5, 0.1], "drained_s": 2.0, "completed": 2, "offered": 2,
         "batcher": {"dispatches": 3, "solves": 7, "mesh_devices_max": 0}},
        {"sojourns_s": [0.3], "drained_s": 1.0, "completed": 1, "offered": 1, "slo_ok": True,
         "batcher": {"dispatches": 1, "solves": 2}},
    ]
    from citizensassemblies_tpu_torch.service import fleet_aggregate

    assert fleet_aggregate(rollups) == jfleet.fleet_aggregate(rollups)
