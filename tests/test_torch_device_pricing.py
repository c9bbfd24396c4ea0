"""Device anchor pricing and the fused move screen: the port against the JAX package.

The same seeded inputs go through the JAX package's jitted cores
(``solvers/device_pricing._get_greedy_core`` / ``_get_dp_core``,
``face_decompose._get_fused_screen_core``) and the port's torch versions on
the CPU. Integer state and first-index argmax ties on both sides, and a
stable sort where the JAX package takes ``lax.top_k``, so the compositions,
the harvest's hits and misses and the screen's pairs are compared for
equality, not closeness. The face loop in device-pricing mode is held to
the JAX package's on ``skewed_instance(n=160, k=14, n_categories=4,
seed=2)`` with the device routes forced on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.solvers import cg_typespace as jcg
from citizensassemblies_tpu.solvers import device_pricing as jdp
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers import lp_pdhg as jlp
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers import device_pricing as tdp
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

#: the two packages' masters on equal inputs: iterations equal, ε and duals
#: within float32 rounding of solves that sum in another order
MASTER_TOL = 1e-6
#: a face-loop wall-clock budget no run reaches: the loop's end-game branches
#: then do not depend on how fast the host runs the test
CLOCK_FREE_BUDGET_S = 1e9
#: rounds the port's face loop on its own master solutions may take beyond
#: the JAX package's on the forced device route (measured: 6 against 5)
OWN_LOOP_EXTRA_ROUNDS = 1


def _reductions(n=160, k=14, n_categories=3, seed=5):
    def make(gen):
        return gen.skewed_instance(n=n, k=k, n_categories=n_categories, seed=seed)

    return JRed(j_featurize(make(jgen))[0]), TRed(t_featurize(make(tgen), device="cpu")[0])


def _assert_feasible(red, comp):
    comp = np.asarray(comp, dtype=np.int64).ravel()
    assert comp.sum() == red.k
    assert (comp >= 0).all() and (comp <= red.msize).all()
    counts = np.zeros(red.F, dtype=np.int64)
    for t in range(red.T):
        counts[red.type_feature[t]] += comp[t]
    assert (counts >= red.qmin).all() and (counts <= red.qmax).all()


def _tasks(T, seed, forced=()):
    rng = np.random.default_rng(seed)
    out = [(rng.normal(0, 1.0, T), None) for _ in range(4)]
    return out + [(rng.normal(0, 1.0, T), int(f)) for f in forced]


def _dispatch_both(jred, tred, tasks):
    jp, tp = jdp.DevicePricer(jred), tdp.DevicePricer(tred, device="cpu")
    return (jp, jp.dispatch(tasks)), (tp, tp.dispatch(tasks))


def test_greedy_lanes_equal_reference():
    """The β-ladder lanes: every composition and device flag equal to the
    JAX core's, forced-inclusion tasks included; the hits feasible."""
    jred, tred = _reductions()
    forced = [int(np.argmax(tred.msize)), int(np.argmin(np.where(tred.msize > 0, tred.msize, 99)))]
    tasks = _tasks(tred.T, 0, forced)
    (jp, jh), (tp, th) = _dispatch_both(jred, tred, tasks)
    assert not th.exact and th.lanes == jh.lanes == 6
    np.testing.assert_array_equal(th.comps.numpy(), np.asarray(jh.comps))
    np.testing.assert_array_equal(th.ok.numpy(), np.asarray(jh.ok))
    hits, missed = tp.harvest(th)
    assert len(hits) >= 4
    for _i, comp in hits:
        _assert_feasible(tred, comp)


def test_exact_dp_equal_reference_and_milp():
    """Single-category reductions take the exact DP: compositions equal to
    the JAX core's, anchor values equal to the HiGHS MILP optimum."""
    jred, tred = _reductions(n=120, k=10, n_categories=1, seed=3)
    assert tred.n_cats == 1
    tasks = _tasks(tred.T, 1, forced=[int(np.argmax(tred.msize))])
    (jp, jh), (tp, th) = _dispatch_both(jred, tred, tasks)
    assert th.exact and th.lanes == 1
    np.testing.assert_array_equal(th.comps.numpy(), np.asarray(jh.comps))
    np.testing.assert_array_equal(th.ok.numpy(), np.asarray(jh.ok))
    hits, missed = tp.harvest(th)
    assert not missed
    oracle = tcg.CompositionOracle(tred)
    for i, comp in hits:
        _assert_feasible(tred, comp)
        w, f = tasks[i]
        exact = oracle.maximize(w, forced_type=f)
        val = float(comp.astype(np.float64).ravel() @ w)
        assert abs(val - exact[1]) <= 1e-6 * (1.0 + abs(exact[1]))


def test_forced_inclusion_lanes_hold_their_type():
    jred, tred = _reductions()
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1.0, tred.T)
    forced = int(np.argmin(w))  # a type the dual direction would never pick
    (_jp, jh), (tp, th) = _dispatch_both(jred, tred, [(w, forced)])
    np.testing.assert_array_equal(th.comps.numpy(), np.asarray(jh.comps))
    hits, missed = tp.harvest(th)
    assert [i for i, _ in hits] == [0] or missed == [0]
    if hits:
        assert hits[0][1].ravel()[forced] >= 1
        _assert_feasible(tred, hits[0][1])


@pytest.mark.parametrize("seed", [3, 4])
def test_harvest_equal_reference(seed):
    """Hits (task, composition) and misses equal to the JAX harvest, on a
    batch with forced types the greedy lanes cannot all serve."""
    jred, tred = _reductions(n=160, k=14, n_categories=4, seed=2)
    forced = list(np.argsort(tred.msize)[:3])
    tasks = _tasks(tred.T, seed, forced)
    (jp, jh), (tp, th) = _dispatch_both(jred, tred, tasks)
    j_hits, j_missed = jp.harvest(jh)
    t_hits, t_missed = tp.harvest(th)
    assert t_missed == j_missed
    assert [i for i, _ in t_hits] == [i for i, _ in j_hits]
    for (_i, a), (_j, b) in zip(t_hits, j_hits):
        np.testing.assert_array_equal(a, b)


def _screen_inputs(red, seed=6, rows=10):
    oracle = tcg.CompositionOracle(red)
    rng = np.random.default_rng(seed)
    comps = []
    for _ in range(rows):
        got = oracle.maximize(rng.normal(0, 1.0, red.T))
        if got is not None:
            comps.append(got[0])
    comps = np.stack(comps).astype(np.int16)
    lam = np.abs(rng.normal(0, 1e-3, 2 * red.T)).astype(np.float32)
    # tied duals: half the rows at exactly zero, so r = 0 for many types and
    # |Δ| = 0 for many face pairs
    lam[rng.random(2 * red.T) < 0.5] = 0.0
    lam[: red.T // 4] = lam[red.T // 2 : red.T // 2 + red.T // 4]
    return comps, lam


@pytest.mark.parametrize("shape", [(160, 14, 4, 2), (240, 16, 3, 7)])
def test_fused_screen_equal_reference_with_tied_duals(shape):
    """The fused screen's pairs (ti, tj), fixed-size indices and new
    compositions equal to the JAX core's on a dual vector full of ties."""
    n, k, nc, seed = shape
    jred, tred = _reductions(n=n, k=k, n_categories=nc, seed=seed)
    comps, lam = _screen_inputs(tred)
    js = jfd._FusedScreen(jred, per_round_cap=16_384, cfg=jcfg())
    ts = tfd._FusedScreen(tred, per_round_cap=16_384, device="cpu")
    assert js.dispatch(comps, jnp.asarray(lam))
    assert ts.dispatch(comps, torch.as_tensor(lam))
    j_idx, j_ti, j_tj, _ = js._pending
    t_idx, t_ti, t_tj, _ = ts._pending
    np.testing.assert_array_equal(t_ti.numpy(), np.asarray(j_ti))
    np.testing.assert_array_equal(t_tj.numpy(), np.asarray(j_tj))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    got, want = ts.harvest(), js.harvest()
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    for comp in got[:64]:
        _assert_feasible(tred, comp)
    assert not ts.pending and ts.harvest().shape[0] == 0


class _CountingOracle:
    def __init__(self, red):
        self.inner = tcg.CompositionOracle(red)
        self.calls = 0

    def maximize(self, *a, **kw):
        self.calls += 1
        return self.inner.maximize(*a, **kw)


class _AlwaysMissPricer:
    def dispatch(self, tasks):
        return ("stub", list(tasks))

    def harvest(self, handle):
        return [], list(range(len(handle[1])))


class _FailingPricer:
    def dispatch(self, tasks):
        raise RuntimeError("device dispatch failed")


def test_device_hit_skips_host_milp():
    _jred, tred = _reductions()
    oracle = _CountingOracle(tred)
    log = TLog(echo=False)
    pricer = tfd._AnchorPricer(
        oracle, np.random.default_rng(0), tred, overlap=True, log=log,
        device=tdp.DevicePricer(tred, log=log, device="cpu"),
    )
    pricer.submit(1, np.random.default_rng(3).normal(0, 1e-3, tred.T), 1e-3, None, None)
    cols = pricer.harvest()
    pricer.close()
    hits = log.counters.get("decomp_oracle_device_hit", 0)
    assert hits >= 1
    assert oracle.calls == log.counters.get("decomp_oracle_device_miss", 0)
    for comp in cols[:hits]:
        _assert_feasible(tred, comp)


def test_device_miss_falls_back_to_host_milp():
    _jred, tred = _reductions()
    oracle = _CountingOracle(tred)
    log = TLog(echo=False)
    pricer = tfd._AnchorPricer(
        oracle, np.random.default_rng(0), tred, overlap=True, log=log, device=_AlwaysMissPricer()
    )
    pricer.submit(1, np.random.default_rng(4).normal(0, 1e-3, tred.T), 1e-3, None, None)
    cols = pricer.harvest()
    pricer.close()
    assert oracle.calls == 1
    assert log.counters.get("decomp_oracle_device_miss", 0) == 1
    assert len(cols) == 1
    _assert_feasible(tred, cols[0])


def test_failed_dispatch_raises():
    """A failing device dispatch propagates: the port has no quiet drop to
    the host MILP (the JAX package's degrade rung comes with the fault
    ladder)."""
    _jred, tred = _reductions()
    pricer = tfd._AnchorPricer(
        _CountingOracle(tred), np.random.default_rng(0), tred, overlap=True,
        log=TLog(echo=False), device=_FailingPricer(),
    )
    with pytest.raises(RuntimeError, match="device dispatch failed"):
        pricer.submit(1, np.zeros(tred.T), 1e-3, None, None)
    pricer.close()


@pytest.mark.parametrize("knob", [None, True, False])
def test_gates_resolve_like_reference(monkeypatch, knob):
    """``None`` follows the device (off on the CPU, on where the routing
    predicate says accelerator); ``True``/``False`` force."""
    from citizensassemblies_tpu_torch.solvers.batch_lp import lp_batch_enabled

    cfg = tconfig.default_config().replace(decomp_device_pricing=knob, lp_batch=knob)
    cpu = torch.device("cpu")
    want_cpu = bool(knob) if knob is not None else False
    assert tdp.device_pricing_enabled(cfg, cpu) is want_cpu
    assert lp_batch_enabled(cfg, cpu) is want_cpu
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    want_acc = bool(knob) if knob is not None else True
    assert tdp.device_pricing_enabled(cfg, cpu) is want_acc
    assert lp_batch_enabled(cfg, cpu) is want_acc


@pytest.fixture(scope="module")
def profiles():
    def make(gen):
        return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)

    jred = JRed(j_featurize(make(jgen))[0])
    tred = TRed(t_featurize(make(tgen), device="cpu")[0])
    jv, _ = jcg._leximin_relaxation(jred, JLog(echo=False))
    tv, _ = tcg._leximin_relaxation(tred, TLog(echo=False))
    jseeds = jcg._slice_relaxation(jv * jred.msize.astype(np.float64), jred, R=4)
    tseeds = tcg._slice_relaxation(tv * tred.msize.astype(np.float64), tred, R=4)
    return (jred, jv, jseeds), (tred, tv, tseeds)


def _forced_cfgs():
    common = dict(decomp_host_master_max_types=0, pdhg_megakernel=True, mixed_precision=False,
                  decomp_device_pricing=True, lp_batch=False, decomp_time_budget_s=CLOCK_FREE_BUDGET_S)
    return jcfg().replace(**common), tconfig.default_config().replace(**common)


def _recording_masters(mod, store):
    """``mod._master_pdhg`` recording a copy of each master's columns."""
    master = mod._master_pdhg

    def recorded(MT, *args, **kw):
        store.append(np.array(MT, copy=True))
        return master(MT, *args, **kw)

    return recorded


@pytest.fixture(scope="module")
def jax_face_loop(profiles):
    """The JAX package's face loop in device-pricing mode on the profile,
    every master on the device route: ``(C, p, eps, log, solves,
    columns)``, with each master solution and each master's columns in
    order."""
    (jred, jv, jseeds), _ = profiles
    jc, tc = _forced_cfgs()
    log = JLog(echo=False)
    solves, columns = [], []

    def recorded(h, finish=jlp.finish_two_sided_master):
        sol = finish(h)
        solves.append(sol)
        return sol

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlp, "finish_two_sided_master", recorded)
        mp.setattr(jfd, "_master_pdhg", _recording_masters(jfd, columns))
        C, p, eps, _ = jfd.realize_profile(
            jred, jv, list(jseeds), jcg.CompositionOracle(jred), tc.decomp_accept,
            log=log, max_rounds=8, use_pdhg=True, cfg=jc,
        )
    return C, p, eps, log, solves, columns


def _port_face_loop(profiles, monkeypatch, fed=None):
    """The port's face loop as :func:`jax_face_loop` runs the JAX package's.
    ``fed(r, own)`` gives the values the loop reads from the handle of its
    ``r``-th master (its own solve ``own`` when None). Returns ``(C, p,
    eps, log, solves, columns)`` with the port's own solves ``(tol, sol)``."""
    _, (tred, tv, tseeds) = profiles
    _, tc = _forced_cfgs()
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    solves, columns = [], []
    dispatch = tlp.solve_two_sided_master_ell_async

    def feeding(*args, **kw):
        h = dispatch(*args, **kw)
        own = tlp.finish_two_sided_master(h)
        r = len(solves)
        solves.append((h.tol, own))
        x, lam, tail = fed(r, own) if fed is not None else (None, None, None)
        if x is None:
            return h
        out = torch.as_tensor(np.concatenate([x, lam, tail]), dtype=torch.float32)
        return tlp.MasterHandle(out=out, Cp=h.Cp, T=h.T, tol=h.tol)

    monkeypatch.setattr(tlp, "solve_two_sided_master_ell_async", feeding)
    monkeypatch.setattr(tfd, "_master_pdhg", _recording_masters(tfd, columns))
    log = TLog(echo=False)
    C, p, eps, _ = tfd.realize_profile(
        tred, tv, list(tseeds), tcg.CompositionOracle(tred), tc.decomp_accept,
        log=log, max_rounds=8, use_pdhg=True, cfg=tc, device="cpu",
    )
    return C, p, eps, log, solves, columns


def _assert_certified(red, v, C, p, eps, log):
    """Within the bar, the mixture realizing the profile within ε, device
    anchors, at most one synchronisation per steady round."""
    assert eps <= _forced_cfgs()[1].decomp_accept
    mix = p @ (C.astype(np.float64) / red.msize[None, :])
    assert float(np.abs(mix - v).max()) <= eps + 1e-12
    c = log.counters
    assert c.get("decomp_oracle_device_hit", 0) >= 1
    steady = c.get("decomp_host_syncs", 0) - c.get("decomp_polish_syncs", 0)
    assert steady <= c["decomp_rounds"]


def _print_masters(jax_solves, port_solves):
    for r, (a, (_tol, b)) in enumerate(zip(jax_solves, port_solves)):
        same = a.x.shape == b.x.shape
        print(f"solve {r + 1}: iters {a.iters}/{b.iters}, |Δε| {abs(a.objective - b.objective):.2e}, "
              f"max|Δλ| {float(np.abs(a.lam - b.lam).max()) if same else float('nan'):.2e}, "
              f"max|Δp| {float(np.abs(a.x - b.x).max()) if same else float('nan'):.2e}")


def test_forced_device_route_matches_reference(profiles, jax_face_loop, monkeypatch):
    """The face loop in device-pricing mode, every master on the device
    route (the block kernel's plain version against the Pallas kernel in
    interpret mode), from the same master solutions in both packages.

    A master's optimal p is not unique on this pool, and the loop builds
    its next columns from p's support and, through the fused screen and
    anchor pricing, from the master's duals, whose last digits order the
    next master's columns
    (:func:`test_forced_device_route_duals_order_the_next_columns`). So the
    JAX package's solution of each master is fed into the port's loop
    through its dispatch handle, which the readback, the warm start, the
    screen and the pricing all read; the port still solves each master
    itself from that state, and that solve is held to the JAX package's:
    iterations equal and ε and duals within ``MASTER_TOL`` for the rounds'
    masters, ε for the end-game polish (whose iterations run into a
    plateau). The two loops must then take the same rounds and end on the
    same columns, mixture and ε, and both certify within the bar with
    device anchors and at most one synchronisation per steady round. The
    loop's wall-clock budget is set out of reach in both: its end-game
    polish widens at 60 % of the budget, which made the outcome depend on
    the host's speed."""
    (jred, jv, _), (tred, tv, _) = profiles
    Cj, pj, ej, jlog, jax_solves, _ = jax_face_loop

    def fed(r, own):
        j = jax_solves[r]
        assert own.x.shape == j.x.shape
        return j.x, j.lam, np.array([np.ravel(j.mu)[0], j.iters, j.kkt, 0.0])

    Ct, pt, et, tlog, port_solves, _ = _port_face_loop(profiles, monkeypatch, fed)
    assert len(port_solves) == len(jax_solves)
    master_tol = port_solves[0][0]
    for a, (tol, b) in zip(jax_solves, port_solves):
        assert abs(a.objective - b.objective) <= MASTER_TOL
        if tol == master_tol:
            assert a.iters == b.iters
            assert float(np.abs(a.lam - b.lam).max()) <= MASTER_TOL
    _print_masters(jax_solves, port_solves)
    _assert_certified(jred, jv, Cj, pj, ej, jlog)
    _assert_certified(tred, tv, Ct, pt, et, tlog)
    assert tlog.counters["decomp_rounds"] == jlog.counters["decomp_rounds"]
    np.testing.assert_array_equal(Ct, Cj)
    np.testing.assert_array_equal(pt, pj)
    assert et == ej
    assert "megakernel_fit_miss" not in tlog.counters


def test_forced_device_route_duals_order_the_next_columns(profiles, jax_face_loop, monkeypatch):
    """The witness of why the loops are fed: the port's loop with only the
    JAX package's DUALS in its handles (its own p, iterations and
    residual). Master 1's duals of the two packages differ in their last
    digits (within ``MASTER_TOL``); the fused screen and anchor pricing read
    them, and with the port's own ones master 2 gets the same columns in
    another order, and, its optimum not being unique, a p 0.125 away
    (:func:`test_forced_device_route_own_masters`). With the JAX package's
    duals master 2 gets the same columns in the same order, the port's own
    solve of it lands on the JAX package's p, and the loops take the same
    rounds."""
    (jred, jv, _), (tred, tv, _) = profiles
    Cj, pj, ej, jlog, jax_solves, jax_columns = jax_face_loop

    def fed(r, own):
        j = jax_solves[r]
        return own.x, j.lam, np.array([np.ravel(j.mu)[0], own.iters, own.kkt, 0.0])

    Ct, pt, et, tlog, port_solves, port_columns = _port_face_loop(profiles, monkeypatch, fed)
    _print_masters(jax_solves, port_solves)
    np.testing.assert_array_equal(port_columns[1], jax_columns[1])
    a, (_tol, b) = jax_solves[1], port_solves[1]
    assert a.iters == b.iters
    assert float(np.abs(a.x - b.x).max()) <= MASTER_TOL
    _assert_certified(tred, tv, Ct, pt, et, tlog)
    assert tlog.counters["decomp_rounds"] == jlog.counters["decomp_rounds"]


def test_forced_device_route_own_masters(profiles, jax_face_loop, monkeypatch):
    """The port's loop on its own master solutions, with the wall-clock
    budget out of reach: it certifies within the bar with device anchors
    and at most one synchronisation per steady round; its first two
    masters equal the JAX package's in iterations, ε and duals (within
    ``MASTER_TOL``), and master 2 has the same set of columns; it takes at
    most ``OWN_LOOP_EXTRA_ROUNDS`` more rounds than the JAX package's loop
    (measured: 6 against 5)."""
    (jred, jv, _), (tred, tv, _) = profiles
    _, _, _, jlog, jax_solves, jax_columns = jax_face_loop
    Ct, pt, et, tlog, port_solves, port_columns = _port_face_loop(profiles, monkeypatch)
    _print_masters(jax_solves, port_solves)
    for a, (_tol, b) in zip(jax_solves[:2], port_solves[:2]):
        assert a.iters == b.iters and a.x.shape == b.x.shape
        assert abs(a.objective - b.objective) <= MASTER_TOL
        assert float(np.abs(a.lam - b.lam).max()) <= MASTER_TOL
    assert {tuple(c) for c in port_columns[1].T} == {tuple(c) for c in jax_columns[1].T}
    _assert_certified(tred, tv, Ct, pt, et, tlog)
    assert tlog.counters["decomp_rounds"] <= jlog.counters["decomp_rounds"] + OWN_LOOP_EXTRA_ROUNDS


def test_gate_off_is_bit_identical_to_auto_cpu(profiles):
    """On the CPU the auto gates resolve off: the same engine as the gates
    forced off, bit for bit, with no device-pricing counter."""
    _, (tred, tv, tseeds) = profiles
    out = {}
    for name, cfg in (
        ("auto", tconfig.default_config().replace(decomp_host_master_max_types=0)),
        ("off", tconfig.default_config().replace(
            decomp_host_master_max_types=0, decomp_device_pricing=False, lp_batch=False)),
    ):
        log = TLog(echo=False)
        C, p, eps, _ = tfd.realize_profile(
            tred, tv, list(tseeds), tcg.CompositionOracle(tred), 6.5e-4,
            log=log, max_rounds=4, use_pdhg=False, cfg=cfg, device="cpu",
        )
        out[name] = (C, p, eps, log.counters)
    np.testing.assert_array_equal(out["auto"][0], out["off"][0])
    np.testing.assert_array_equal(out["auto"][1], out["off"][1])
    assert out["auto"][2] == out["off"][2]
    for *_, c in out.values():
        assert "decomp_oracle_device_hit" not in c and "lp_batch_dispatches" not in c
