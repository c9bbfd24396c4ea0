"""The port's request context against the JAX package's.

Held here, on the CPU:

* ``resolve`` and ``use_context`` resolve and scope exactly as the JAX
  package's (explicit ``cfg``/``log`` first, then the context's, then the
  defaults; the ambient context per thread; ``None`` a pass-through), and
  ``teardown`` rolls back only what a failed request set;
* the fault sites prefer the ambient context's injector to the one an
  entry point builds from ``Config.fault_sites`` and to the process default;
* the face loop on the forced device route (``skewed_instance(n=160, k=14,
  n_categories=4, seed=2)``, the device-pricing test's recipe) raises
  ``DeadlineExceeded`` at a past deadline and at one that expires after two
  rounds, with the JAX package's partial-evidence keys and round counts;
* a generous context is bit for bit no context, on the face loop and
  through ``find_distribution_leximin``, ``find_distribution_xmin`` and
  ``legacy_probabilities``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.robust.policy import Deadline as JDeadline
from citizensassemblies_tpu.robust.policy import DeadlineExceeded as JDeadlineExceeded
from citizensassemblies_tpu.service import context as jctx
from citizensassemblies_tpu.solvers import cg_typespace as jcg
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.robust.policy import Deadline, DeadlineExceeded
from citizensassemblies_tpu_torch.service import context as tctx
from citizensassemblies_tpu_torch.service import RequestContext, current_context, resolve, use_context
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

#: the device-pricing test's forced device route, with a face-loop budget no
#: run reaches, so the loop's branches do not depend on the host's speed
FORCED = dict(decomp_host_master_max_types=0, pdhg_megakernel=True, mixed_precision=False,
              decomp_device_pricing=True, lp_batch=False, decomp_time_budget_s=1e9)
#: the rounds the loops may run in the deadline tests (a deadline after two
#: rounds raises at the top of the third), and in the bit-for-bit test
ROUNDS = 3
GENEROUS_ROUNDS = 2


# --- resolve, use_context, teardown ---------------------------------------------


def test_resolve_matches_the_jax_rule():
    cfg_a, cfg_b = default_config().replace(eps=1e-3), default_config().replace(eps=2e-3)
    log_a, log_b = RunLog(echo=False), RunLog(echo=False)
    ctx = RequestContext.create(cfg=cfg_a, log=log_a, tenant="t")
    # explicit wins, then the context's, then the defaults
    assert resolve(ctx, cfg_b, log_b) == (ctx, cfg_b, log_b)
    assert resolve(ctx, None, None) == (ctx, cfg_a, log_a)
    none_ctx, cfg, log = resolve(None, None, None)
    assert none_ctx is None and cfg == default_config() and isinstance(log, RunLog)
    # the ambient context is the default ctx
    with use_context(ctx) as got:
        assert got is ctx and current_context() is ctx
        assert resolve(None, None, None) == (ctx, cfg_a, log_a)
    assert current_context() is None
    # the JAX package's rule on the same shapes of call
    jc = jctx.RequestContext.create(cfg=jcfg().replace(eps=1e-3), tenant="t")
    assert jctx.resolve(jc, None, None)[1].eps == resolve(ctx, None, None)[1].eps
    assert jctx.resolve(None, None, None)[0] is None
    # ids and the JAX package's fields
    assert ctx.request_id.startswith("req-") and ctx.tenant == "t"
    assert RequestContext.create().request_id != ctx.request_id
    assert ({f.name for f in dataclasses.fields(RequestContext)}
            == {f.name for f in dataclasses.fields(jctx.RequestContext)})


def test_use_context_nests_and_isolates_threads():
    outer, inner = RequestContext.create(), RequestContext.create()
    with use_context(None) as nothing:
        assert nothing is None and current_context() is None
    seen = {}
    with use_context(outer):
        with use_context(inner):
            assert current_context() is inner
            t = threading.Thread(target=lambda: seen.setdefault("thread", current_context()))
            t.start()
            t.join()
        assert current_context() is outer
    assert current_context() is None
    # a new thread starts with no ambient context
    assert seen["thread"] is None


def test_teardown_rolls_back_only_what_is_set():
    class Store:
        cleared = 0

        def clear(self):
            self.cleared += 1

    class Session:
        def __init__(self):
            self.rolled = []

        def rollback_request(self, rid):
            self.rolled.append(rid)

    RequestContext.create().teardown(False)  # nothing set: nothing to do
    store, session = Store(), Session()
    ctx = RequestContext.create(warm_store=store, session=session)
    ctx.teardown(True)
    assert store.cleared == 0 and session.rolled == []
    ctx.teardown(False)
    assert store.cleared == 1 and session.rolled == [ctx.request_id]
    only = RequestContext.create(session=Session())
    only.teardown(False)
    assert only.session.rolled == [only.request_id]


def test_use_context_imports_no_obs_module():
    """The context module imports no obs module at its top (the obs layer
    reads the context, not the reverse). Since the serving slice a
    context's tracer is the ambient tracer of its scope, as in the JAX
    package, and a context without one leaves the ambient tracer alone."""
    import ast
    import inspect

    from citizensassemblies_tpu.obs.trace import Tracer as JTracer
    from citizensassemblies_tpu.obs.trace import current_tracer as j_current_tracer

    from citizensassemblies_tpu_torch.obs.trace import Tracer, current_tracer

    top = ast.parse(inspect.getsource(tctx)).body
    assert not [
        n.module for n in top
        if isinstance(n, ast.ImportFrom) and n.module and ".obs" in n.module
    ]
    tr, jtr = Tracer(name="t"), JTracer(name="t")
    with use_context(RequestContext.create(tracer=tr)):
        assert current_tracer() is tr
    with jctx.use_context(jctx.RequestContext.create(tracer=jtr)):
        assert j_current_tracer() is jtr
    assert current_tracer() is None and j_current_tracer() is None
    with use_context(RequestContext.create()):
        assert current_tracer() is None


# --- the injector ---------------------------------------------------------------


def test_active_injector_prefers_the_context_injector():
    mine = inject.FaultInjector("pdhg_nan:1.0", seed=1)
    default = inject.FaultInjector("qp_nan:1.0", seed=2)
    with inject.use_injector(default):
        assert inject.active_injector() is default
        with inject.request_injector(default_config().replace(fault_sites="oracle_raise:1.0")) as req:
            assert inject.active_injector() is req
            with use_context(RequestContext.create(injector=mine)):
                assert inject.active_injector() is mine
                log = RunLog(echo=False)
                assert inject.site("pdhg_nan", log) and log.counters["fault_pdhg_nan"] == 1
            assert inject.active_injector() is req
        # a context without an injector leaves the lookup as it was
        with use_context(RequestContext.create()):
            assert inject.active_injector() is default
    assert inject.active_injector() is None


def test_context_injector_reaches_an_entry_point():
    """``face_abort`` from the context's injector kills the face loop that
    ``find_distribution_leximin`` runs through ``ctx=``."""
    dense, space = t_featurize(tgen.skewed_instance(n=120, k=12, n_categories=3, seed=1),
                               device="cpu")
    ctx = RequestContext.create(injector=inject.FaultInjector("face_abort:1.0", seed=0))
    with pytest.raises(inject.FaultInjected):
        find_distribution_leximin(dense, space, ctx=ctx, device="cpu")
    assert ctx.log.counters["fault_face_abort"] == 1


# --- the face loop's deadline ----------------------------------------------------


@pytest.fixture(scope="module")
def profiles():
    def make(gen):
        return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)

    jred = JRed(j_featurize(make(jgen))[0])
    tred = TRed(t_featurize(make(tgen), device="cpu")[0])
    jv, _ = jcg._leximin_relaxation(jred, JLog(echo=False))
    tv, _ = tcg._leximin_relaxation(tred, RunLog(echo=False))
    jseeds = jcg._slice_relaxation(jv * jred.msize.astype(np.float64), jred, R=4)
    tseeds = tcg._slice_relaxation(tv * tred.msize.astype(np.float64), tred, R=4)
    return (jred, jv, jseeds), (tred, tv, tseeds)


def _after_checks(base, checks: int):
    """A deadline of class ``base`` that expires at its ``checks + 1``-th
    check: at the top of that round of the face loop."""

    class Counted(base):
        def __init__(self):
            super().__init__(1e9)
            self.calls = 0

        def check(self, where, log=None, partial=None):
            self.calls += 1
            if self.calls > checks:
                self.seconds = 0.0
            return super().check(where, log=log, partial=partial)

    return Counted()


def _jax_loop(profiles, deadline):
    (jred, jv, jseeds), _ = profiles
    ctx = jctx.RequestContext.create(cfg=jcfg().replace(**FORCED), deadline=deadline)
    with pytest.raises(JDeadlineExceeded) as info:
        jfd.realize_profile(
            jred, jv, list(jseeds), jcg.CompositionOracle(jred), ctx.cfg.decomp_accept,
            max_rounds=ROUNDS, use_pdhg=True, ctx=ctx,
        )
    return info.value, ctx.log


def _port_loop(profiles, monkeypatch, deadline=None, ambient=False, rounds=ROUNDS):
    """The port's face loop on the forced device route; ``deadline`` on a
    context passed as ``ctx`` (or made ambient), else no context."""
    _, (tred, tv, tseeds) = profiles
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    cfg = default_config().replace(**FORCED)
    log = RunLog(echo=False)
    ctx = None if deadline is None else RequestContext.create(cfg=cfg, log=log, deadline=deadline)
    args = (tred, tv, list(tseeds), tcg.CompositionOracle(tred), cfg.decomp_accept)
    kw = dict(max_rounds=rounds, use_pdhg=True, device="cpu")
    if ctx is None:
        return tfd.realize_profile(*args, log=log, cfg=cfg, **kw), log
    if ambient:
        with use_context(ctx):
            return tfd.realize_profile(*args, **kw), log
    return tfd.realize_profile(*args, ctx=ctx, **kw), log


@pytest.mark.parametrize("checks", [0, 2], ids=["past", "after_two_rounds"])
def test_face_loop_deadline_raises_with_the_jax_partial(profiles, monkeypatch, checks):
    jerr, jlog = _jax_loop(profiles, _after_checks(JDeadline, checks))
    for ambient in (False, True):
        with pytest.raises(DeadlineExceeded) as info:
            _port_loop(profiles, monkeypatch, _after_checks(Deadline, checks), ambient=ambient)
        err = info.value
        assert set(err.partial) == set(jerr.partial) == {"decomp_rounds", "best_eps"}
        assert err.partial["decomp_rounds"] == jerr.partial["decomp_rounds"] == checks
        assert "face_decompose round" in str(err) and "face_decompose round" in str(jerr)
    if checks == 0:
        assert err.partial["best_eps"] is None and jerr.partial["best_eps"] is None
    else:
        # the best certified residual after the rounds run: finite and
        # positive in both packages (their masters sum in another order)
        assert 0.0 < err.partial["best_eps"] < np.inf
        assert 0.0 < jerr.partial["best_eps"] < np.inf
    assert jlog.counters["deadline_exceeded"] == 1


def test_generous_context_is_the_face_loop_without_one(profiles, monkeypatch):
    (C0, p0, eps0, solves0), log0 = _port_loop(profiles, monkeypatch, rounds=GENEROUS_ROUNDS)
    (C1, p1, eps1, solves1), log1 = _port_loop(profiles, monkeypatch, Deadline(1e9),
                                               rounds=GENEROUS_ROUNDS)
    np.testing.assert_array_equal(C0, C1)
    np.testing.assert_array_equal(p0, p1)
    assert eps0 == eps1 and solves0 == solves1
    assert log0.counters["decomp_rounds"] == log1.counters["decomp_rounds"] >= 2
    assert "deadline_exceeded" not in log1.counters


def test_generous_context_is_the_entry_points_without_one():
    dense, space = t_featurize(tgen.skewed_instance(n=120, k=12, n_categories=3, seed=1),
                               device="cpu")
    cfg = default_config().replace(xmin_iterations_factor=2, xmin_qp_iters=2000)
    plain = find_distribution_leximin(dense, space, cfg=cfg, device="cpu")
    ctx = RequestContext.create(cfg=cfg, deadline=Deadline(1e9))
    got = find_distribution_leximin(dense, space, ctx=ctx, device="cpu")
    for a, b in ((plain.committees, got.committees), (plain.probabilities, got.probabilities),
                 (plain.allocation, got.allocation)):
        np.testing.assert_array_equal(a, b)
    # the context's log took the run's lines
    assert "Using leximin algorithm." in ctx.log.lines
    xmin_plain = find_distribution_xmin(dense, space, cfg=cfg, leximin=plain, device="cpu")
    xmin_ctx = find_distribution_xmin(dense, space, leximin=plain, device="cpu",
                                      ctx=RequestContext.create(cfg=cfg, deadline=Deadline(1e9)))
    np.testing.assert_array_equal(xmin_plain.probabilities, xmin_ctx.probabilities)
    np.testing.assert_array_equal(xmin_plain.allocation, xmin_ctx.allocation)
    # legacy reads the context's cfg
    leg_cfg = default_config().replace(mc_batch=64)
    a = legacy_probabilities(dense, iterations=300, seed=3, cfg=leg_cfg, device="cpu")
    with use_context(RequestContext.create(cfg=leg_cfg)):
        b = legacy_probabilities(dense, iterations=300, seed=3, device="cpu")
    np.testing.assert_array_equal(a.allocation, b.allocation)
    np.testing.assert_array_equal(a.pair_matrix, b.pair_matrix)


def test_past_deadline_through_the_entry_point():
    """``find_distribution_leximin`` with ``ctx``: a pool whose type space
    is over the enumeration budget runs the face loop, whose first round
    raises; the JAX package raises the same."""
    def make(gen):
        return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)

    dense, space = t_featurize(make(tgen), device="cpu")
    with pytest.raises(DeadlineExceeded) as info:
        find_distribution_leximin(dense, space, device="cpu",
                                  ctx=RequestContext.create(deadline=Deadline(0.0)))
    from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin

    jd, js = j_featurize(make(jgen))
    with pytest.raises(JDeadlineExceeded) as jinfo:
        j_leximin(jd, js, ctx=jctx.RequestContext.create(deadline=JDeadline(0.0)))
    assert info.value.partial == jinfo.value.partial == {"decomp_rounds": 0, "best_eps": None}
