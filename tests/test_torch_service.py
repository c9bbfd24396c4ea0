"""The port's selection service against the JAX package's, on the CPU.

The 12 cases of ``tests/test_service.py``, the 2 service cases of
``tests/test_scenarios.py`` (``:258``, ``:288``) and the 4 of
``tests/test_delta.py`` (``:330``, ``:371``, ``:393``, ``:423``), each fed
the same seeded inputs in both packages: served allocations bit for bit
the port's own serial twins and within 1e-3 of the JAX service's (or its
serial solve, which its own tests hold bit for bit to its service), audit
stamps with the JAX package's keys, fingerprints distinct where the JAX
package's are. Then the concurrency repairs of the shared device state:

* two requests' warm slots land in their own stores, never the default;
* the transfer guard's windows of two threads, interleaved, keep the sync
  debug mode in force only while a window is open and restore the
  process's mode after the last one, and a legal readback outside every
  window waits for open windows to close instead of meeting the mode
  (``torch.cuda`` patched to record its calls);
* two threads replaying one graph closure each get their own results (a
  plain replay in place of the graph), and a capture books only its own
  thread's kernel launches.
"""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.core.generator import random_instance as j_random_instance
from citizensassemblies_tpu.core.generator import skewed_instance as j_skewed_instance
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.data.registry import apply_edit as j_apply_edit
from citizensassemblies_tpu.data.registry import churn_trail as j_churn_trail
from citizensassemblies_tpu.data.registry import nationwide_registry as j_nationwide
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.service import SelectionRequest as JRequest
from citizensassemblies_tpu.service import SelectionService as JService
from citizensassemblies_tpu.service.session import TenantSession as JSession
from citizensassemblies_tpu.solvers import delta as jdelta
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog
from citizensassemblies_tpu.utils.memo import memo_evictions_by_owner as j_evictions

from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.core.generator import random_instance, skewed_instance
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.data.registry import (
    RegistryEdit,
    apply_edit,
    churn_trail,
    nationwide_registry,
)
from citizensassemblies_tpu_torch.kernels import cuda_lib
from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.service import (
    AdmissionError,
    CrossRequestBatcher,
    RequestContext,
    SelectionRequest,
    SelectionService,
    use_context,
)
from citizensassemblies_tpu_torch.service.session import TenantSession
from citizensassemblies_tpu_torch.solvers import batch_lp as tbl
from citizensassemblies_tpu_torch.solvers import delta as tdelta
from citizensassemblies_tpu_torch.solvers import lp_pdhg
from citizensassemblies_tpu_torch.utils import guards
from citizensassemblies_tpu_torch.utils.checkpoint import problem_fingerprint
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog
from citizensassemblies_tpu_torch.utils.memo import LRU, memo_evictions_by_owner

torch.set_num_threads(1)

#: the JAX service as the port's is: no ahead-of-time executable store
JAX_SERVE = dict(aot_cache=False)


def _tiny(seed=0, n=24, k=5):
    return (
        featurize(random_instance(n=n, k=k, n_categories=2, seed=seed), device="cpu"),
        j_featurize(j_random_instance(n=n, k=k, n_categories=2, seed=seed)),
    )


def _svc(cfg):
    return SelectionService(cfg, device="cpu")


def _linf(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)).max())


# --- RunLog thread safety --------------------------------------------------------


@pytest.mark.parametrize("log_cls", [RunLog, JLog], ids=["torch", "jax"])
def test_runlog_count_no_lost_increments(log_cls):
    log = log_cls(echo=False)
    workers, per = 8, 5_000

    def hammer():
        for _ in range(per):
            log.count("hits")
        return True

    with ThreadPoolExecutor(max_workers=workers) as pool:
        assert all(f.result() for f in [pool.submit(hammer) for _ in range(workers)])
    assert log.counters["hits"] == workers * per


def test_runlog_timer_and_gauge_concurrent():
    log = RunLog(echo=False)

    def one(i):
        with log.timer("t"):
            pass
        log.gauge("g", i)
        return True

    with ThreadPoolExecutor(max_workers=4) as pool:
        assert all(f.result() for f in [pool.submit(one, i) for i in range(64)])
    assert log.timers["t"] >= 0.0
    assert 0 <= log.counters["g"] < 64


# --- re-entrancy ------------------------------------------------------------------


def test_interleaved_leximin_bit_identical_to_serial():
    """Two concurrent requests with different configs each honor their own
    knobs and reproduce their serial twins bit for bit, within 1e-3 of the
    JAX package's solves."""
    (t1, j1), (t2, j2) = _tiny(seed=1, n=32, k=6), _tiny(seed=2, n=40, k=7)
    knobs_a = dict(lp_batch=True, sparse_ops=False)
    knobs_b = dict(lp_batch=False, sparse_ops=True)
    cfg_a, cfg_b = default_config().replace(**knobs_a), default_config().replace(**knobs_b)
    serial_a = find_distribution_leximin(*t1, cfg=cfg_a, device="cpu")
    serial_b = find_distribution_leximin(*t2, cfg=cfg_b, device="cpu")
    ctx_a = RequestContext.create(cfg=cfg_a, tenant="a", request_id="ra")
    ctx_b = RequestContext.create(cfg=cfg_b, tenant="b", request_id="rb")
    barrier = threading.Barrier(2)

    def run(ctx, d, s):
        barrier.wait(timeout=30)
        return find_distribution_leximin(d, s, ctx=ctx, device="cpu")

    with ThreadPoolExecutor(max_workers=2) as pool:
        fa, fb = pool.submit(run, ctx_a, *t1), pool.submit(run, ctx_b, *t2)
        conc_a, conc_b = fa.result(timeout=300), fb.result(timeout=300)
    np.testing.assert_array_equal(conc_a.allocation, serial_a.allocation)
    np.testing.assert_array_equal(conc_b.allocation, serial_b.allocation)
    np.testing.assert_array_equal(conc_a.probabilities, serial_a.probabilities)
    np.testing.assert_array_equal(conc_b.probabilities, serial_b.probabilities)
    assert ctx_a.log.lines and ctx_b.log.lines
    assert _linf(conc_a.allocation, j_leximin(*j1, cfg=jcfg().replace(**knobs_a)).allocation) <= 1e-3
    assert _linf(conc_b.allocation, j_leximin(*j2, cfg=jcfg().replace(**knobs_b)).allocation) <= 1e-3


# --- the service end to end ----------------------------------------------------------


def _serve_three(service, request, cfg, make):
    with service(cfg) as svc:
        chans = [
            svc.submit(request(instance=make(i), algorithm="leximin", tenant=f"t{i}"))
            for i in range(3)
        ]
        results = [c.result(timeout=300) for c in chans]
    return results, list(chans[0].events(timeout=5))


def test_service_end_to_end_parity_stream_and_audit():
    knobs = dict(lp_batch=True, serve_batch_window_ms=5.0)
    cfg = default_config().replace(**knobs)
    results, events = _serve_three(
        _svc, SelectionRequest, cfg,
        lambda i: random_instance(n=24 + 8 * i, k=5, n_categories=2, seed=i),
    )
    jresults, _ = _serve_three(
        JService, JRequest, jcfg().replace(**knobs, **JAX_SERVE),
        lambda i: j_random_instance(n=24 + 8 * i, k=5, n_categories=2, seed=i),
    )
    for i, (res, jres) in enumerate(zip(results, jresults)):
        d, s = featurize(random_instance(n=24 + 8 * i, k=5, n_categories=2, seed=i), device="cpu")
        ref = find_distribution_leximin(d, s, cfg=cfg, device="cpu")
        np.testing.assert_array_equal(res.allocation, ref.allocation)
        assert _linf(res.allocation, jres.allocation) <= 1e-3
        assert res.audit["contract_ok"] is True
        assert res.audit["realization_dev"] <= 1e-3
        assert set(res.audit) == set(jres.audit)
        for field in ("decomp_host_syncs", "xla_compiles", "counters", "timers",
                      "session", "tenant_memo_evictions"):
            assert field in res.audit, field
        soj = res.audit["sojourn"]
        assert set(soj) == set(jres.audit["sojourn"])
        parts = soj["queue_wait_s"] + soj["prepare_s"] + soj["solve_s"] + soj["audit_s"]
        assert abs(parts - soj["total_s"]) <= 0.05 * soj["total_s"] + 1e-3
    kinds = [k for k, _ in events]
    assert kinds[-1] == "result" and "progress" in kinds


def test_service_memo_and_xmin_seed_reuse():
    inst = random_instance(n=24, k=5, n_categories=2, seed=3)
    with _svc(default_config()) as svc:
        r1 = svc.run(SelectionRequest(instance=inst, tenant="memo"), timeout=300)
        assert not r1.from_memo
        r2 = svc.run(SelectionRequest(instance=inst, tenant="memo"), timeout=300)
        assert r2.from_memo
        np.testing.assert_array_equal(r1.allocation, r2.allocation)
        rx = svc.run(SelectionRequest(instance=inst, algorithm="xmin", tenant="memo"), timeout=300)
    assert any(
        "reusing the tenant session's LEXIMIN seed" in line for line in rx.result.output_lines
    )
    assert _linf(np.sort(rx.allocation), np.sort(r1.allocation)) <= 1e-3
    jd, js = j_featurize(j_random_instance(n=24, k=5, n_categories=2, seed=3))
    assert _linf(r1.allocation, j_leximin(jd, js).allocation) <= 1e-3


def test_session_pack_memo_serves_a_repeat_portfolio():
    """An XMIN request whose min-L2 stage packs a portfolio the tenant
    session packed before takes the pack from the session's memo
    (``session_pack_hit``), in both packages."""
    def run(service, request, cfg, inst):
        with service as svc:
            svc.run(request(instance=inst, tenant="memo"), timeout=300)
            first = svc.run(request(instance=inst, algorithm="xmin", tenant="memo"), timeout=300)
            again = svc.run(request(instance=inst, algorithm="xmin", tenant="memo",
                                    cfg=cfg.replace(xmin_qp_iters=19_999)), timeout=300)
        return first.audit, again.audit

    first, again = run(_svc(default_config()), SelectionRequest, default_config(),
                       random_instance(n=24, k=5, n_categories=2, seed=3))
    jfirst, jagain = run(JService(jcfg().replace(**JAX_SERVE)), JRequest, jcfg().replace(**JAX_SERVE),
                         j_random_instance(n=24, k=5, n_categories=2, seed=3))
    assert first["session"]["pack_entries"] == jfirst["session"]["pack_entries"] == 1
    assert "session_pack_hit" not in first["counters"]
    assert again["counters"]["session_pack_hit"] == jagain["counters"]["session_pack_hit"] == 1
    assert again["session"]["pack_hits"] == jagain["session"]["pack_hits"] == 1


def test_service_legacy_algorithm_parity():
    inst = random_instance(n=24, k=5, n_categories=2, seed=4)
    d, _s = featurize(inst, device="cpu")
    ref = legacy_probabilities(d, iterations=300, seed=7, cfg=default_config(), device="cpu")
    with _svc(default_config()) as svc:
        res = svc.run(
            SelectionRequest(instance=inst, algorithm="legacy", iterations=300, seed=7),
            timeout=300,
        )
    np.testing.assert_array_equal(res.allocation, ref.allocation)
    assert res.audit["draws_attempted"] >= 300
    with JService(jcfg().replace(**JAX_SERVE)) as jsvc:
        jres = jsvc.run(
            JRequest(instance=j_random_instance(n=24, k=5, n_categories=2, seed=4),
                     algorithm="legacy", iterations=300, seed=7),
            timeout=300,
        )
    assert set(res.audit) == set(jres.audit)
    # the two packages draw from different generators: the frequencies are
    # held within 5σ of each other, agent by agent
    p = np.clip((res.allocation + np.asarray(jres.allocation)) / 2, 1 / 300, 1 - 1 / 300)
    assert np.all(np.abs(res.allocation - np.asarray(jres.allocation)) <= 5 * np.sqrt(2 * p * (1 - p) / 300))


def test_admission_control_queue_depth():
    cfg = default_config().replace(serve_queue_depth=2, serve_admission_cap=1)
    svc = _svc(cfg)
    try:
        with svc._lock:
            svc._in_flight = svc.queue_depth
        with pytest.raises(AdmissionError):
            svc.submit(SelectionRequest(instance=random_instance(n=24, k=5, n_categories=2)))
        with svc._lock:
            svc._in_flight = 0
    finally:
        svc.shutdown()
    # a service for the card raises at construction when there is none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SelectionService(cfg)


# --- cross-request batching ---------------------------------------------------------


def _fleet(seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        P = r.random((16, 8)) < 0.5
        q = r.random(16)
        q /= q.sum()
        out.append(tbl.final_primal_batch_lp(P, P.T.astype(np.float64) @ q))
    return out


def test_cross_request_batcher_fuses_and_matches_solo():
    """Two threads submit same-schedule fleets inside the window: one engine
    dispatch, results bit for bit the solo dispatches', within 1e-3 of the
    JAX engine's."""
    from citizensassemblies_tpu.solvers.batch_lp import solve_lp_batch as j_solve_lp_batch

    cfg = default_config().replace(lp_batch=True, serve_batch_window_ms=500.0)
    fleets = [_fleet(1), _fleet(2)]
    solo = [
        tbl.solve_lp_batch(f, cfg=cfg, max_iters=20_000, defer=False, device="cpu")
        for f in fleets
    ]
    batcher = CrossRequestBatcher(cfg)
    ctxs = [
        RequestContext.create(cfg=cfg, tenant=f"t{i}", request_id=f"r{i}", batcher=batcher)
        for i in range(2)
    ]
    barrier = threading.Barrier(2)

    def run(i):
        barrier.wait(timeout=30)
        with use_context(ctxs[i]):
            return tbl.solve_lp_batch(fleets[i], cfg=cfg, max_iters=20_000, device="cpu")

    with ThreadPoolExecutor(max_workers=2) as pool:
        fused = [f.result(timeout=120) for f in [pool.submit(run, i) for i in range(2)]]
    stats = batcher.stats()
    assert stats["submissions"] == 2
    assert stats["fused_dispatches"] >= 1, stats
    assert stats["max_requests_fused"] == 2, stats
    jcfg_ = jcfg().replace(lp_batch=True)
    for i, (got, want) in enumerate(zip(fused, solo)):
        jwant = j_solve_lp_batch(
            [dataclasses.replace(p) for p in _jax_fleet(i + 1)], cfg=jcfg_, max_iters=20_000,
            defer=False,
        )
        for g, w, jw in zip(got, want, jwant):
            np.testing.assert_array_equal(g.x, w.x)
            assert g.objective == w.objective
            assert abs(g.objective - float(jw.objective)) <= 1e-3


def _jax_fleet(seed):
    from citizensassemblies_tpu.solvers.batch_lp import final_primal_batch_lp as j_final

    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        P = r.random((16, 8)) < 0.5
        q = r.random(16)
        q /= q.sum()
        out.append(j_final(P, P.T.astype(np.float64) @ q))
    return out


def test_warm_slot_isolation_across_contexts():
    """Two contexts, run side by side: each context's warm slots land in its
    own store under its tenant/request key; the default store is untouched;
    a request-scoped clear drops only its own."""
    rng = np.random.default_rng(5)
    P = rng.random((16, 8)) < 0.5
    q = rng.random(16)
    q /= q.sum()
    inst = [tbl.final_primal_batch_lp(P, P.T.astype(np.float64) @ q)]
    cfg = default_config().replace(lp_batch=True)
    store_a, store_b = tbl.WarmSlotStore(), tbl.WarmSlotStore()
    ctx_a = RequestContext.create(cfg=cfg, tenant="ta", request_id="r1", warm_store=store_a)
    ctx_b = RequestContext.create(cfg=cfg, tenant="tb", request_id="r2", warm_store=store_b)
    before_default = len(tbl._DEFAULT_WARM_STORE)
    barrier = threading.Barrier(2)

    def run(ctx):
        barrier.wait(timeout=30)
        with use_context(ctx):
            return tbl.solve_lp_batch(inst, cfg=cfg, warm_key="probe", max_iters=10_000, device="cpu")

    with ThreadPoolExecutor(max_workers=2) as pool:
        outs = [f.result(timeout=120) for f in [pool.submit(run, c) for c in (ctx_a, ctx_b)]]
    np.testing.assert_array_equal(outs[0][0].x, outs[1][0].x)
    assert len(store_a) == 1 and len(store_b) == 1
    assert store_a.get(("ta/r1/probe", 0)) is not None
    assert store_b.get(("tb/r2/probe", 0)) is not None
    assert store_a.get(("tb/r2/probe", 0)) is None
    assert len(tbl._DEFAULT_WARM_STORE) == before_default
    with use_context(ctx_a):
        assert set(tbl.warm_slots("probe")) == {0}
        tbl.clear_warm_slots("probe")
    assert len(store_a) == 0 and len(store_b) == 1
    # the JAX package's keys are the same
    from citizensassemblies_tpu.service.context import RequestContext as JContext

    assert JContext.create(tenant="ta", request_id="r1").scoped_warm_key("probe") == (
        ctx_a.scoped_warm_key("probe")
    )


# --- per-tenant eviction attribution -------------------------------------------------


def test_lru_owner_attributed_evictions():
    before = memo_evictions_by_owner().get("tenant:evict-me", 0)
    cache = LRU(cap=2, name="tenant:evict-me:memo")
    for i in range(4):
        cache.put(i, i, owner="tenant:evict-me")
    assert memo_evictions_by_owner().get("tenant:evict-me", 0) - before == 2
    assert cache.evictions == 2


def test_tenant_session_caps_and_attributes():
    def run(session_cls, evictions):
        sess = session_cls("cap-t", cap=2)
        before = evictions().get(sess.owner, 0)
        for i in range(4):
            sess.memo_put(f"fp{i}", object())
        hits = (sess.memo_get("fp3") is not None, sess.memo_get("fp0") is None)
        return hits, evictions().get(sess.owner, 0) - before, sess.stats()

    got, jgot = run(TenantSession, memo_evictions_by_owner), run(JSession, j_evictions)
    assert got == jgot
    assert got[0] == (True, True) and got[1] == 2 and got[2]["evictions"] == 2


# --- decomp_host_syncs gauge -----------------------------------------------------------


def test_decomp_host_syncs_counts_device_rounds(monkeypatch):
    """Forced device masters tick the gauge per device round trip; the host
    masters keep it at zero, in both packages."""
    from citizensassemblies_tpu.solvers import cg_typespace as jcg
    from citizensassemblies_tpu.solvers import face_decompose as jfd
    from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed

    from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
    from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    def syncs(red, relax, slice_, oracle, realize, log_cls, cfg, **kw):
        v, _x = relax(red, log_cls(echo=False))
        seeds = slice_(v * red.msize.astype(np.float64), red, R=8)
        out = []
        for use_pdhg, c in ((False, None), (True, cfg)):
            log = log_cls(echo=False)
            realize(red, v, list(seeds), oracle(red), accept=5e-3, log=log, max_rounds=3,
                    use_pdhg=use_pdhg, cfg=c, **kw)
            out.append(log.counters.get("decomp_host_syncs", 0))
        return out

    dense, _s = featurize(skewed_instance(n=120, k=12, n_categories=3, seed=1), device="cpu")
    host, dev = syncs(
        TypeReduction(dense), tcg._leximin_relaxation, tcg._slice_relaxation, tcg.CompositionOracle,
        tfd.realize_profile, RunLog, default_config().replace(decomp_host_master_max_types=0),
        device="cpu",
    )
    jd, _js = j_featurize(j_skewed_instance(n=120, k=12, n_categories=3, seed=1))
    jhost, jdev = syncs(
        JRed(jd), jcg._leximin_relaxation, jcg._slice_relaxation, jcg.CompositionOracle,
        jfd.realize_profile, JLog, jcfg().replace(decomp_host_master_max_types=0),
    )
    assert host == jhost == 0
    assert dev >= 1 and jdev >= 1


# --- the scenario models through the service --------------------------------------------


def test_service_scenario_algorithms():
    drop = np.random.default_rng(1).uniform(0.0, 0.4, size=24)
    svc = _svc(default_config().replace(scenario_mc_draws=256))
    jsvc = JService(jcfg().replace(scenario_mc_draws=256, **JAX_SERVE))
    try:
        inst = random_instance(n=24, k=5, n_categories=2, seed=1)
        jinst = j_random_instance(n=24, k=5, n_categories=2, seed=1)
        r1 = svc.submit(SelectionRequest(algorithm="dropout", instance=inst, dropout=drop)).result(timeout=600)
        j1 = jsvc.submit(JRequest(algorithm="dropout", instance=jinst, dropout=drop)).result(timeout=600)
        assert r1.audit["scenario"]["model"] == "dropout"
        assert "mc" in r1.audit["scenario"]
        assert r1.audit["contract_ok"]
        assert set(r1.audit["scenario"]) == set(j1.audit["scenario"])
        assert _linf(r1.allocation, j1.allocation) <= 1e-3

        r2 = svc.submit(SelectionRequest(algorithm="multi", instance=inst, rounds=2)).result(timeout=600)
        j2 = jsvc.submit(JRequest(algorithm="multi", instance=jinst, rounds=2)).result(timeout=600)
        assert r2.audit["scenario"]["model"] == "multi"
        assert r2.audit["scenario"]["pair_ratio"] >= 1.0 - 1e-9
        assert _linf(r2.allocation, j2.allocation) <= 1e-3

        with pytest.raises(RuntimeError):
            svc.submit(SelectionRequest(algorithm="dropout", instance=inst)).result(timeout=600)
    finally:
        svc.shutdown()
        jsvc.shutdown()


def test_service_dropout_fingerprint_distinguishes_profiles():
    (dense, _), _j = _tiny(seed=0)
    cfg = default_config()
    svc = _svc(cfg)
    try:
        reqs = (
            SelectionRequest(algorithm="dropout", dense=dense, dropout=np.full(dense.n, 0.1)),
            SelectionRequest(algorithm="dropout", dense=dense, dropout=np.full(dense.n, 0.3)),
            SelectionRequest(algorithm="multi", dense=dense, rounds=2),
            SelectionRequest(algorithm="multi", dense=dense, rounds=3),
        )
        fps = [svc._fingerprint(r, dense, cfg) for r in reqs]
        assert len(set(fps)) == 4
        # the suffixes the JAX package appends to the problem fingerprint
        base = problem_fingerprint(dense, cfg, None)
        assert [fp[len(base):] for fp in fps] == [":drop" + fps[0].split(":drop")[1],
                                                  ":drop" + fps[1].split(":drop")[1], ":R2", ":R3"]
        import zlib

        assert fps[0].endswith(f"{zlib.crc32(np.full(dense.n, 0.1).tobytes()) & 0xFFFFFFFF:08x}")
    finally:
        svc.shutdown()


# --- revise requests (delta re-certification) --------------------------------------------


def _registries():
    kw = dict(n=1200, k=36, seed=9, categories=(("region", [f"r{i}" for i in range(6)]),),
              quota_slack=0.02)
    reg, jreg = nationwide_registry(**kw), j_nationwide(**kw)
    return reg, churn_trail(reg, 2, seed=1, max_edit_agents=8), jreg, j_churn_trail(jreg, 2, seed=1, max_edit_agents=8)


def test_service_revise_round_trip():
    reg, edits, jreg, jedits = _registries()
    cfg = default_config()

    def drive(service, request, spec_cls, apply, r, trail, to_dense):
        with service as svc:
            r0 = svc.run(request(dense=to_dense(r)[0], space=to_dense(r)[1], tenant="t"))
            cur, results = r, []
            for edit in trail:
                nxt = apply(cur, edit)
                dn, sn = to_dense(nxt)
                rr = svc.run(request(dense=dn, space=sn, tenant="t",
                                     revise=spec_cls(edit=edit, reg_before=cur)))
                results.append((rr, dn, sn))
                cur = nxt
        return r0, results

    r0, results = drive(_svc(cfg), SelectionRequest, tdelta.ReviseSpec, apply_edit, reg, edits,
                        lambda g: g.to_dense(device="cpu"))
    j0, jresults = drive(JService(jcfg().replace(**JAX_SERVE)), JRequest, jdelta.ReviseSpec,
                         j_apply_edit, jreg, jedits, lambda g: g.to_dense())
    assert r0.audit["contract_ok"] and "delta_cert" not in r0.audit
    assert results[0][0].audit["counters"].get("delta_fallback") == 1
    assert results[0][0].audit["session"]["delta_entries"] >= 1
    r2, d2, s2 = results[1]
    cert = r2.audit["delta_cert"]
    assert cert["mode"] in ("cache_hit", "resume", "full_ladder")
    assert cert["mode"] == jresults[1][0].audit["delta_cert"]["mode"]
    assert r2.audit["contract_ok"]
    scratch = find_distribution_leximin(d2, s2, cfg=cfg, device="cpu")
    assert _linf(r2.allocation, scratch.allocation) <= 2e-3 + 1e-9
    for (rr, _d, _s), (jr, _jd, _js) in zip([(r0, None, None)] + results, [(j0, None, None)] + jresults):
        assert _linf(rr.allocation, jr.allocation) <= 1e-3


def test_service_revise_inconsistent_spec_falls_back():
    reg, edits, _jreg, _jedits = _registries()
    with _svc(default_config()) as svc:
        nxt = apply_edit(reg, edits[0])
        dn, sn = nxt.to_dense(device="cpu")
        other = churn_trail(reg, 5, seed=99, max_edit_agents=8)[-1]
        rr = svc.run(SelectionRequest(dense=dn, space=sn, tenant="t",
                                      revise=tdelta.ReviseSpec(edit=other, reg_before=reg)))
    assert "delta_cert" not in rr.audit
    assert rr.audit["counters"].get("delta_fallback", 0) >= 1
    assert rr.audit["contract_ok"]


def test_delta_solve_false_bit_identical():
    reg, edits, _jreg, _jedits = _registries()
    cfg = default_config().replace(delta_solve=False)
    nxt = apply_edit(reg, edits[0])
    dn, sn = nxt.to_dense(device="cpu")
    with _svc(cfg) as svc:
        plain = svc.run(SelectionRequest(dense=dn, space=sn, tenant="plain"))
        revised = svc.run(SelectionRequest(dense=dn, space=sn, tenant="revised",
                                           revise=tdelta.ReviseSpec(edit=edits[0], reg_before=reg)))
    np.testing.assert_array_equal(plain.allocation, revised.allocation)
    np.testing.assert_array_equal(np.asarray(plain.result.probabilities),
                                  np.asarray(revised.result.probabilities))
    assert revised.audit["session"]["delta_entries"] == 0
    assert "delta_cert" not in revised.audit
    assert "delta_fallback" not in revised.audit["counters"]


def test_memo_and_delta_keys_are_content_fingerprints():
    reg, _edits, _jreg, _jedits = _registries()
    cfg = default_config()
    nxt = apply_edit(reg, RegistryEdit(kind="quota_relax", cell=1, dlo=0, dhi=1))
    d0, s0 = reg.to_dense(device="cpu")
    d1, s1 = nxt.to_dense(device="cpu")
    assert problem_fingerprint(d0, cfg, None) != problem_fingerprint(d1, cfg, None)
    with _svc(cfg) as svc:
        svc.run(SelectionRequest(dense=d0, space=s0, tenant="t"))
        again = svc.run(SelectionRequest(dense=d0, space=s0, tenant="t"))
        assert again.from_memo
        edited = svc.run(SelectionRequest(dense=d1, space=s1, tenant="t"))
        assert not edited.from_memo
        assert edited.audit["session"]["memo_hits"] == 1


# --- the request payloads carried across -------------------------------------------------


def test_request_from_dict_carries_the_jax_request():
    _reg, _edits, jreg, jedits = _registries()
    jreq = JRequest(
        algorithm="leximin", tenant="t", request_id="r9", iterations=5, seed=3,
        revise=jdelta.ReviseSpec(edit=jedits[0], reg_before=jreg, base_fingerprint="fp"),
    )
    req = interop.request_from_dict(dataclasses.asdict(jreq), device="cpu")
    assert (req.algorithm, req.tenant, req.request_id, req.iterations, req.seed) == (
        "leximin", "t", "r9", 5, 3,
    )
    assert req.revise.base_fingerprint == "fp"
    assert req.revise.edit.kind == jedits[0].kind
    np.testing.assert_array_equal(req.revise.reg_before.assignments, jreg.assignments)
    assert req.revise.edit.magnitude == jedits[0].magnitude


# --- the concurrency repairs of the shared device state ----------------------------------


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s sync-debug setters patched to record their calls
    on a fake process-wide mode (starting at 1, a user's ``"warn"``)."""
    state = {"mode": 1, "calls": []}

    def setter(mode):
        state["mode"] = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        state["calls"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", setter)
    return state


def test_guard_windows_of_two_threads_interleave(fake_cuda):
    """A-enter, B-enter, A-exit, B-exit: the mode is in force exactly while
    a window is open and returns to the process's own mode afterwards."""
    steps = [threading.Event() for _ in range(4)]
    seen = {}

    def window(name, enter_after, opened, exit_after, closed):
        with guards.no_implicit_transfers(mode="disallow"):
            if enter_after is not None:
                steps[enter_after].wait(10)
            with guards.guarded_launch():
                seen[f"{name}_in"] = fake_cuda["mode"]
                steps[opened].set()
                steps[exit_after].wait(10)
            seen[f"{name}_out"] = fake_cuda["mode"]
            steps[closed].set()

    a = threading.Thread(target=window, args=("a", None, 0, 1, 2))
    b = threading.Thread(target=window, args=("b", 0, 1, 2, 3))
    a.start()
    b.start()
    a.join(10)
    b.join(10)
    assert not a.is_alive() and not b.is_alive()
    assert seen == {"a_in": 2, "b_in": 2, "a_out": 2, "b_out": 1}
    assert fake_cuda["mode"] == 1
    # set once on the first open, once back on the last close
    assert fake_cuda["calls"] == [2, 1]
    assert guards.GATE.state() == {"open": 0, "syncs": 0, "in_force": None}


def test_guard_readback_outside_windows_waits_for_them(fake_cuda):
    """A legal readback of another thread, and every torch call of a thread
    under ``shared_device``, runs only while no window is open: it never
    meets the mode, and windows do not open during it."""
    opened, release = threading.Event(), threading.Event()
    modes = {}

    def launcher():
        with guards.no_implicit_transfers(mode="disallow"), guards.guarded_launch():
            opened.set()
            release.wait(10)
            time.sleep(0.05)

    def reader():
        opened.wait(10)
        release.set()
        with guards.readback():
            modes["readback"] = fake_cuda["mode"]
        with guards.shared_device():
            x = torch.ones(4)
            modes["op"] = (fake_cuda["mode"], float(x.sum()))

    threads = [threading.Thread(target=launcher), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert modes == {"readback": 1, "op": (1, 4.0)}
    # a sync inside a window still meets the mode: the guard is not weakened
    with guards.no_implicit_transfers(mode="disallow"), guards.guarded_launch():
        with guards.readback():
            assert fake_cuda["mode"] == 2
    assert fake_cuda["mode"] == 1


def test_replay_closure_keeps_each_threads_results():
    """Two threads replaying one graph closure (a plain replay of its block
    over the static buffers stands in for the graph) each get their own
    results: the closure's lock keeps them off each other's buffers."""
    static = (torch.zeros(64),)
    outs = (torch.zeros(64),)

    def replay():
        v = static[0].clone()
        time.sleep(0.0005)  # a window for another thread's copy-in
        outs[0].copy_(v * 2.0 + 1.0)

    run = lp_pdhg._replay_closure(static, outs, replay, {})
    errors = []

    def worker(seed):
        for i in range(40):
            x = torch.full((64,), float(seed * 1000 + i))
            (y,) = run(x)
            if not torch.equal(y, x * 2.0 + 1.0):
                errors.append((seed, i))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_capture_books_only_its_own_threads_launches(monkeypatch):
    """A capture on one thread books that thread's wrapper calls to its own
    tally; another thread's launches meanwhile are counted as launches; each
    replay of the capture counts exactly the captured launches."""
    lib = cuda_lib.CudaLibrary("test_capture_lib", "ell_gather.cu", [], {})
    monkeypatch.setattr(cuda_lib.CudaLibrary, "run", lambda self, fname, *a: 0)
    inside, done = threading.Event(), threading.Event()
    tallies = {}

    def capturer():
        with cuda_lib.capturing_launches() as tally:
            lib.call("k")
            inside.set()
            done.wait(10)
            lib.call("k")
            lib.call("k2")
        tallies["a"] = tally

    def other():
        inside.wait(10)
        lib.call("k")
        lib.call("k")
        done.set()

    try:
        threads = [threading.Thread(target=capturer), threading.Thread(target=other)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert tallies["a"] == {"test_capture_lib": {"k": 2, "k2": 1}}
        assert lib.launches == 2 and lib.entry_launches == {"k": 2}
        run = lp_pdhg._replay_closure((torch.zeros(1),), (torch.zeros(1),), lambda: None, tallies["a"])
        run(torch.ones(1))
        run(torch.ones(1))
        assert lib.launches == 8 and lib.entry_launches == {"k": 6, "k2": 2}
    finally:
        cuda_lib.LIBRARIES.remove(lib)


def test_compilation_guard_counts_this_threads_one_time_work():
    """``CompilationGuard`` counts the captures and builds noted on its own
    thread, logs them as ``xla_compiles_<name>`` and holds its bound."""
    log = RunLog(echo=False)
    with guards.CompilationGuard(name="g", log=log) as guard:
        guards.note_compile("cuda_graph_captures")
        t = threading.Thread(target=guards.note_compile, args=("cuda_graph_captures",))
        t.start()
        t.join(10)
        guards.note_compile("cuda_library_builds")
    assert guard.count == 2
    assert guard.by_name == {"cuda_graph_captures": 1, "cuda_library_builds": 1}
    assert log.counters["xla_compiles_g"] == 2
    with pytest.raises(guards.GuardViolation):
        with guards.CompilationGuard(name="bounded", max_compiles=0):
            guards.note_compile("cuda_graph_captures")
