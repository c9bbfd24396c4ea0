"""Fault injection, sentinels, the ladder and face checkpoints: the port
against the JAX package.

What is held here, each through both packages where the JAX package has the
path:

* the injector's schedule: the same spec and seed fire the same
  consultations; unknown sites are refused; no injector, no fault;
* the two-seed face checkpoint resume of ``tests/test_robust.py``: a face
  loop killed by ``face_abort`` on a pinned schedule resumes from its last
  checkpoint and lands within 1e-3 of the uninterrupted run, and of the
  JAX package's resumed run; the port's resume replays its uninterrupted
  run bit for bit, on the host route and on the forced device route, and
  a snapshot the JAX package wrote resumes in the port;
* zero-fault bit identity with the sentinels on and off;
* the poisoned batch lane and the corrupt warm slot, quarantined and
  re-solved on the host, their bucket mates untouched;
* the ladder's order and cumulative configs, and its primitives;
* ``oracle_raise``, ``device_dispatch``, ``pdhg_nan`` and ``qp_nan`` at
  their sites, and a non-injected error of the device pricing dispatch
  propagating (no rung hides it).
"""

import dataclasses

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.robust import inject as jinj
from citizensassemblies_tpu.robust import policy as jpol
from citizensassemblies_tpu.solvers import batch_lp as jbl
from citizensassemblies_tpu.solvers import cg_typespace as jcg
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers import qp as jqp
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.robust import inject as tinj
from citizensassemblies_tpu_torch.robust import policy as tpol
from citizensassemblies_tpu_torch.robust.checkpoint import FaceCheckpointer
from citizensassemblies_tpu_torch.solvers import batch_lp as tbl
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers import qp as tqp
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

torch.set_num_threads(1)

#: the contract: a resumed face loop's realized profile against the
#: uninterrupted one's (and the JAX package's resumed one)
CONTRACT = 1e-3
#: the acceptance the resume test asks of every face loop (test_robust.py)
FACE_ACCEPT = 5e-4
FACE_BAND = 8e-4


# --- injector ----------------------------------------------------------------


@pytest.mark.parametrize("spec,seed", [
    ("pdhg_nan:0.5,oracle_raise:0.25", 3), ("pdhg_nan:0.5", 4), ("face_abort:0.3", 8),
    ("device_dispatch:1.0,qp_nan", 0),
])
def test_injector_schedule_equals_reference(spec, seed):
    """The same spec and seed fire the same consultations in both packages,
    site by site; the stats agree."""
    j, t = jinj.FaultInjector(spec, seed=seed), tinj.FaultInjector(spec, seed=seed)
    for site in tinj.FAULT_SITES:
        want = [j.fire(site) for _ in range(64)]
        assert [t.fire(site) for _ in range(64)] == want, site
    assert t.stats() == j.stats()
    assert tinj._hash_unit(seed, "pdhg_nan", 5) == jinj._hash_unit(seed, "pdhg_nan", 5)
    assert set(tinj.FAULT_SITES) == set(jinj.FAULT_SITES)


def test_injector_rejects_unknown_sites_and_is_inert_without_one():
    with pytest.raises(ValueError):
        tinj.FaultInjector("not_a_site:0.5")
    with pytest.raises(ValueError):
        tinj.FaultInjector("pdhg_nan:0.5").fire("not_a_site")
    log = TLog(echo=False)
    assert tinj.site("pdhg_nan", log) is False
    assert "fault_pdhg_nan" not in log.counters


def test_request_injector_follows_the_config():
    """An entry point's scope installs the config's injector; an empty spec
    installs none; an outer scope's stays; the process default is read
    when no scope holds one."""
    cfg = tconfig.default_config().replace(fault_sites="qp_nan:1.0", fault_seed=3)
    with tinj.request_injector(cfg) as inj:
        assert tinj.active_injector() is inj and inj.seed == 3
        with tinj.request_injector(cfg.replace(fault_sites="pdhg_nan")) as inner:
            assert inner is inj
    assert tinj.active_injector() is None
    with tinj.request_injector(tconfig.default_config()) as none:
        assert none is None and tinj.active_injector() is None
    default = tinj.FaultInjector("pdhg_nan:1.0")
    with tinj.use_injector(default):
        assert tinj.active_injector() is default
        with tinj.request_injector(cfg) as inj:
            assert tinj.active_injector() is inj


# --- face checkpoint / resume (test_robust.py's acceptance pin) ----------------


def _face_problem(gen, featurize, cg, Red, Log, seed, **kw):
    dense = featurize(gen.skewed_instance(n=120, k=12, n_categories=3, seed=seed), **kw)[0]
    red = Red(dense)
    v, _ = cg._leximin_relaxation(red, Log(echo=False))
    # a weak seed hull (R=4): the loop runs several rounds, so checkpoints
    # exist before the kill
    return red, v, cg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)


def _run_face(fd, cg, red, v, seeds, cfg, log, inj, **kw):
    with (jinj if fd is jfd else tinj).use_injector(inj):
        return fd.realize_profile(
            red, v, list(seeds), cg.CompositionOracle(red), accept=FACE_ACCEPT, log=log,
            max_rounds=8, use_pdhg=False, cfg=cfg, **kw,
        )


def _killed_then_resumed(fd, cg, inj_mod, red, v, seeds, cfg, log, **kw):
    """Run under ``face_abort:0.3`` with seed 8 (the first attempt dies at
    round 1, after the round-0 checkpoint) until an attempt completes."""
    inj = inj_mod.FaultInjector("face_abort:0.3", seed=8)
    killed, result = False, None
    for _attempt in range(6):
        try:
            result = _run_face(fd, cg, red, v, seeds, cfg, log, inj, **kw)
            break
        except inj_mod.FaultInjected:
            killed = True
    return killed, result


@pytest.mark.parametrize("inst_seed", [1, 2])
def test_face_checkpoint_resume_matches_uninterrupted(tmp_path, inst_seed):
    """``tests/test_robust.py``'s resume pin through both packages: killed
    by ``face_abort`` on the pinned schedule, each resumes from its
    checkpoint, lands within the stalled band and within 1e-3 (realized
    profile) of its uninterrupted run; the port's resumed run is its
    uninterrupted run bit for bit (its snapshot carries the loop state),
    its resumed profile is within 1e-3 of the JAX package's, and the
    checkpoint is gone."""
    profiles = {}
    for name, fd, cg, inj_mod, Log, jcfg_, fz, gen, Red, kw in (
        ("jax", jfd, jcg, jinj, JLog, jcfg(), j_featurize, jgen, JRed, {}),
        ("port", tfd, tcg, tinj, TLog, tconfig.default_config(), t_featurize, tgen, TRed,
         dict(device="cpu")),
    ):
        red, v, seeds = _face_problem(gen, fz, cg, Red, Log, inst_seed, **kw)
        m = red.msize.astype(np.float64)
        C_ref, p_ref, eps_ref, _ = _run_face(fd, cg, red, v, seeds, jcfg_, Log(echo=False), None, **kw)
        assert eps_ref <= FACE_BAND
        cfg = jcfg_.replace(robust_checkpoint_every=1, robust_checkpoint_dir=str(tmp_path / name))
        log = Log(echo=False)
        killed, result = _killed_then_resumed(fd, cg, inj_mod, red, v, seeds, cfg, log, **kw)
        assert killed, "the pinned schedule must kill the first attempt"
        assert result is not None, "resume never completed"
        assert log.counters.get("robust_resume", 0) >= 1
        assert log.counters.get("robust_checkpoint_saved", 0) >= 1
        C_res, p_res, eps_res, _ = result
        assert eps_res <= FACE_BAND
        alloc_ref = (C_ref.astype(np.float64) / m[None, :]).T @ p_ref
        alloc_res = (C_res.astype(np.float64) / m[None, :]).T @ p_res
        assert float(np.abs(alloc_ref - alloc_res).max()) <= CONTRACT
        if name == "port":
            np.testing.assert_array_equal(C_res, C_ref)
            np.testing.assert_array_equal(p_res, p_ref)
            assert eps_res == eps_ref
        assert not list((tmp_path / name).glob("face_*.npz")), "a certified run clears its checkpoint"
        profiles[name] = (alloc_res, dict(log.counters))
    assert float(np.abs(profiles["port"][0] - profiles["jax"][0]).max()) <= CONTRACT
    for key in ("robust_resume", "fault_face_abort"):
        assert profiles["port"][1].get(key, 0) == profiles["jax"][1].get(key, 0), key


def test_face_checkpoint_file_is_the_reference_layout(tmp_path):
    """A face snapshot the JAX package writes resumes in the port (same
    fingerprint formula, same file layout)."""
    from citizensassemblies_tpu.robust.checkpoint import FaceCheckpointer as JCk

    jred, jv, _ = _face_problem(jgen, j_featurize, jcg, JRed, JLog, 1)
    tred, tv, _ = _face_problem(tgen, t_featurize, tcg, TRed, TLog, 1, device="cpu")
    kw = dict(robust_checkpoint_every=1, robust_checkpoint_dir=str(tmp_path))
    jck = JCk(jcfg().replace(**kw), jred, jv, FACE_ACCEPT)
    tck = FaceCheckpointer(tconfig.default_config().replace(**kw), tred, tv, FACE_ACCEPT)
    assert tck.path == jck.path
    comps = np.eye(3, tred.T, dtype=np.int32)
    assert jck.maybe_save(0, comps, np.full(3, 1 / 3), 1e-2)
    got = tck.load(tred.T)
    assert got is not None and got.round == 0
    np.testing.assert_array_equal(got.compositions, comps)
    tck.clear()
    assert tck.load(tred.T) is None


def test_reference_snapshot_resumes_in_the_port(tmp_path):
    """A snapshot the JAX package's killed face loop left (no loop state)
    resumes in the port the JAX package's way: its columns first, the
    first master warm from its mixture; the port certifies within the band
    and clears the file."""
    jred, jv, jseeds = _face_problem(jgen, j_featurize, jcg, JRed, JLog, 1)
    cfg_kw = dict(robust_checkpoint_every=1, robust_checkpoint_dir=str(tmp_path))
    with pytest.raises(jinj.FaultInjected):
        _run_face(jfd, jcg, jred, jv, jseeds, jcfg().replace(**cfg_kw), JLog(echo=False),
                  jinj.FaultInjector("face_abort:0.3", seed=8))
    assert len(list(tmp_path.glob("face_*.npz"))) == 1
    tred, tv, tseeds = _face_problem(tgen, t_featurize, tcg, TRed, TLog, 1, device="cpu")
    cfg = tconfig.default_config().replace(**cfg_kw)
    snap = FaceCheckpointer(cfg, tred, tv, FACE_ACCEPT).load(tred.T)
    assert snap is not None and snap.loop is None
    log = TLog(echo=False)
    C, p, eps, _ = _run_face(tfd, tcg, tred, tv, tseeds, cfg, log, None, device="cpu")
    assert log.counters.get("robust_resume", 0) == 1
    assert eps <= FACE_BAND
    mix = p @ (C.astype(np.float64) / tred.msize[None, :])
    assert float(np.abs(mix - tv).max()) <= FACE_BAND
    assert not list(tmp_path.glob("face_*.npz"))


@pytest.mark.parametrize("realized", [False, True])
def test_face_loop_state_round_trips(tmp_path, realized):
    """Every field of the loop state comes back from the file as saved:
    the warm iterate, the polish screen's slots, the in-flight anchor
    batch (with and without its realized profile) and the generators."""
    from citizensassemblies_tpu_torch.robust import checkpoint as rck

    rng = np.random.default_rng(5)
    before = rng.bit_generator.state
    rng.normal(size=3)
    T = 6
    loop = rck.FaceLoopState(
        next_round=3, cols=rng.integers(0, 4, size=(5, T)).astype(np.int16),
        p=rng.random(4), eps=2.5e-3, eps_hist=np.array([9e-3, 4e-3, 2.5e-3]),
        warm=(rng.random(5), rng.random(2 * T), np.array([0.25])), stall=(2.5e-3, 1),
        polish_after=4, lp_solves=3, rng_state=rng.bit_generator.state,
        pending=rck.FaceSubmit(2, rng.normal(size=T), 2.5e-3,
                               rng.random(T) if realized else None, before),
        device_degraded=True, ell_kpad=16,
        slots={0: (rng.random(7), rng.random(3), rng.random(2), 1),
               2: (rng.random(6), rng.random(4), rng.random(1), 0)},
        elapsed=1.75,
    )
    state = rck.FaceCGState(np.eye(4, T, dtype=np.int32), np.full(4, 0.25), 2.5e-3, 2, "fp",
                            loop=loop)
    rck.save_face_state(tmp_path / "f.npz", state)
    got = rck.load_face_state(tmp_path / "f.npz", T, "fp").loop
    for f in dataclasses.fields(loop):
        want, have = getattr(loop, f.name), getattr(got, f.name)
        if f.name == "pending":
            assert (have.rnd, have.eps, have.rng_state) == (want.rnd, want.eps, want.rng_state)
            np.testing.assert_array_equal(have.r_norm, want.r_norm)
            assert (have.realized is None) == (not realized)
            if realized:
                np.testing.assert_array_equal(have.realized, want.realized)
        elif f.name == "slots":
            assert sorted(have) == sorted(want)
            for pos in want:
                for a, b in zip(have[pos], want[pos]):
                    np.testing.assert_array_equal(a, b)
        elif f.name == "warm":
            for a, b in zip(have, want):
                np.testing.assert_array_equal(a, b)
        elif isinstance(want, np.ndarray):
            np.testing.assert_array_equal(have, want)
            assert have.dtype == want.dtype, f.name
        else:
            assert tuple(have) == tuple(want) if f.name == "stall" else have == want, f.name
    replay = np.random.default_rng(0)
    replay.bit_generator.state = got.pending.rng_state
    np.testing.assert_array_equal(replay.normal(size=3), np.random.default_rng(5).normal(size=3))


#: the forced device route with device pricing and the batched engine on,
#: and no clock in the loop's decisions
REPLAY = dict(decomp_host_master_max_types=0, pdhg_megakernel=True, decomp_device_pricing=True,
              lp_batch=True, decomp_time_budget_s=1e9)


@pytest.fixture(scope="module")
def replay_problem():
    """The device-pricing pool of ``tests/test_torch_device_pricing.py`` (six
    rounds on the forced device route) and its uninterrupted face loop."""
    red = TRed(t_featurize(tgen.skewed_instance(n=160, k=14, n_categories=4, seed=2),
                           device="cpu")[0])
    v, _ = tcg._leximin_relaxation(red, TLog(echo=False))
    seeds = tcg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)
    cfg = tconfig.default_config().replace(**REPLAY)
    log = TLog(echo=False)
    ref = tfd.realize_profile(red, v, list(seeds), tcg.CompositionOracle(red), cfg.decomp_accept,
                              log=log, use_pdhg=True, cfg=cfg, device="cpu")
    return red, v, seeds, cfg, ref, dict(log.counters)


@pytest.mark.parametrize("kill_seed,kill_round", [(2012, 2), (434, 4)])
def test_face_resume_replays_the_uninterrupted_run(replay_problem, tmp_path, kill_seed,
                                                   kill_round):
    """Killed by ``face_abort`` at the top of round ``kill_round`` (the
    injector's schedule for this seed fires at that consultation only), the
    next attempt resumes at that round from the snapshot taken just before
    the kill (the round's columns, the master's warm iterate, the pricing
    generator and its in-flight device anchor batch) and returns the
    uninterrupted loop's columns, mixture and ε bit for bit, after the same
    number of rounds and master solves."""
    red, v, seeds, cfg, ref, ref_counters = replay_problem
    assert ref_counters["decomp_rounds"] > kill_round
    assert ref_counters.get("decomp_oracle_device_hit", 0) >= 1
    run_cfg = cfg.replace(robust_checkpoint_every=1, robust_checkpoint_dir=str(tmp_path))
    inj = tinj.FaultInjector("face_abort:0.3", seed=kill_seed)
    log, attempts, out = TLog(echo=False), [], None
    for _ in range(3):
        try:
            with tinj.use_injector(inj):
                out = tfd.realize_profile(
                    red, v, list(seeds), tcg.CompositionOracle(red), cfg.decomp_accept, log=log,
                    use_pdhg=True, cfg=run_cfg, device="cpu",
                )
            break
        except tinj.FaultInjected:
            attempts.append(log.counters.get("decomp_rounds", 0))
    assert attempts == [kill_round]
    assert any(f"from round {kill_round - 1} " in ln for ln in log.lines)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    assert out[2:] == ref[2:]
    for key in ("decomp_rounds", "decomp_oracle_device_hit", "decomp_master_warm"):
        assert log.counters.get(key, 0) == ref_counters.get(key, 0), key
    assert log.counters["robust_resume"] == 1
    assert not list(tmp_path.glob("face_*.npz"))


# --- zero-fault bit identity -----------------------------------------------------


@pytest.mark.parametrize("lp_batch", [False, True])
def test_sentinels_zero_fault_bit_identity_leximin(lp_batch):
    """With no fault and the sentinels on (the default), LEXIMIN is bitwise
    the sentinels-off run, serial engine and batched engine; within the
    contract of the JAX package's."""
    def make(gen):
        return gen.random_instance(n=32, k=6, n_categories=2, seed=1)

    td, ts = t_featurize(make(tgen), device="cpu")
    out = {}
    for sent in (True, False):
        cfg = tconfig.default_config().replace(robust_sentinels=sent, lp_batch=lp_batch)
        out[sent] = t_leximin(td, ts, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(out[True].allocation, out[False].allocation)
    np.testing.assert_array_equal(out[True].probabilities, out[False].probabilities)
    from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin

    jd, js = j_featurize(make(jgen))
    jdist = j_leximin(jd, js, cfg=jcfg().replace(lp_batch=lp_batch))
    assert float(np.abs(out[True].allocation - jdist.allocation).max()) <= CONTRACT


# --- quarantine --------------------------------------------------------------------


def _port_insts(jinsts):
    return [tbl.BatchLP(**dataclasses.asdict(i)) for i in jinsts]


def _final_primal_fleet(seed=3, lanes=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lanes):
        P = (rng.random((16, 8)) < 0.5).astype(np.float64)
        q = rng.random(16)
        q /= q.sum()
        out.append((P, P.T @ q))
    return out


def test_sentinel_quarantines_poisoned_batch_lane():
    """``pdhg_nan:0.6`` (seed 2) poisons the same cold lanes in both
    packages: each is quarantined and re-solved on the host (its optimum
    covers the target), the other lanes are bit for bit the clean run's."""
    data = _final_primal_fleet()
    jinsts = [jbl.final_primal_batch_lp(P, t) for P, t in data]
    cfg = tconfig.default_config().replace(lp_batch=True)
    clean = tbl.solve_lp_batch(_port_insts(jinsts), cfg=cfg, max_iters=20_000, device="cpu")
    logs = {}
    for name, mod, inj_mod, Log, kw in (
        ("jax", jbl, jinj, JLog, dict(cfg=jcfg().replace(lp_batch=True), defer=False)),
        ("port", tbl, tinj, TLog, dict(cfg=cfg, device="cpu")),
    ):
        log = Log(echo=False)
        insts = jinsts if name == "jax" else _port_insts(jinsts)
        with inj_mod.use_injector(inj_mod.FaultInjector("pdhg_nan:0.6", seed=2)):
            chaos = mod.solve_lp_batch(insts, log=log, max_iters=20_000, **kw)
        logs[name] = log.counters
    quarantined = logs["port"].get("sentinel_quarantined", 0)
    assert quarantined >= 1
    assert quarantined == logs["jax"].get("sentinel_quarantined", 0)
    assert logs["port"].get("sentinel_host_resolve", 0) == quarantined
    for (P, target), c, g in zip(data, clean, chaos):
        assert np.all(np.isfinite(g.x))
        if g.iters == -1:
            assert float(np.maximum(target - P.T @ g.x[:16], 0.0).max()) <= 1e-6
        else:
            np.testing.assert_array_equal(g.x, c.x)


def test_corrupt_warm_slot_quarantined_not_propagated():
    """A loaded warm slot corrupted by ``warm_slot_corrupt:1.0`` is
    quarantined and re-solved on the host in both packages."""
    (P, target), = _final_primal_fleet(seed=7, lanes=1)
    jinst = [jbl.final_primal_batch_lp(P, target)]
    for name, mod, inj_mod, Log, kw in (
        ("jax", jbl, jinj, JLog, dict(cfg=jcfg().replace(lp_batch=True), defer=False)),
        ("port", tbl, tinj, TLog, dict(cfg=tconfig.default_config().replace(lp_batch=True),
                                       device="cpu")),
    ):
        insts = jinst if name == "jax" else _port_insts(jinst)
        log = Log(echo=False)
        mod.solve_lp_batch(insts, log=log, warm_key="t", max_iters=20_000, **kw)
        with inj_mod.use_injector(inj_mod.FaultInjector("warm_slot_corrupt:1.0", seed=1)):
            out = mod.solve_lp_batch(insts, log=log, warm_key="t", max_iters=20_000, **kw)
        assert log.counters.get("fault_warm_slot_corrupt", 0) == 1, name
        assert log.counters.get("sentinel_quarantined", 0) == 1, name
        assert np.all(np.isfinite(out[0].x))
        assert float(np.maximum(target - P.T @ out[0].x[:16], 0.0).max()) <= 1e-6
    tbl.clear_warm_slots("t")


# --- policy ------------------------------------------------------------------------


def test_degradation_ladder_order_and_cumulative_config():
    """The port's ladder is the JAX package's in its order, without the
    kernel → chained-ops rung (a kernel's failure must raise, never switch
    to the plain version); each rung's gate stays off, cumulatively; past
    the bottom, no-op."""
    struck = {"megakernel_to_chained"}
    want = [(n, p) for n, p in jpol.DEGRADATION_LADDER if n not in struck]
    assert list(tpol.DEGRADATION_LADDER) == want
    cfg = tconfig.default_config()
    log = TLog(echo=False)
    ladder = tpol.DegradationLadder()
    for _ in range(len(tpol.DEGRADATION_LADDER) + 2):
        cfg = ladder.degrade(cfg, log)
    assert ladder.steps == [n for n, _p in want] and ladder.exhausted
    assert cfg.decomp_device_pricing is False and cfg.sparse_ops is False
    assert cfg.lp_batch is False and cfg.decomp_batched_expand is False
    assert cfg.dist_mesh is False
    assert cfg.pdhg_megakernel is None
    assert log.counters["robust_degrade_steps"] == len(want)


def test_deadline_and_retry_budget_primitives():
    assert not tpol.Deadline(1000.0).expired
    log = TLog(echo=False)
    with pytest.raises(tpol.DeadlineExceeded) as ei:
        tpol.Deadline(0.0).check("unit", log=log, partial={"best_eps": 1.0})
    assert ei.value.partial["best_eps"] == 1.0 and log.counters["deadline_exceeded"] == 1
    r = tpol.RetryBudget(attempts=2, backoff_s=0.01)
    assert r.take() == pytest.approx(0.01)
    assert r.take() == pytest.approx(0.02)
    assert r.take() is None and r.left == 0


# --- the face loop's sites ---------------------------------------------------------


def test_oracle_raise_retries_then_skips_like_reference():
    """``oracle_raise:1.0``: every anchor MILP fails twice (a retry, then a
    skip) in both packages, with the same counts."""
    counts = {}
    for name, fd, cg, inj_mod, Log, fz, gen, Red, kw in (
        ("jax", jfd, jcg, jinj, JLog, j_featurize, jgen, JRed, {}),
        ("port", tfd, tcg, tinj, TLog, t_featurize, tgen, TRed, dict(device="cpu")),
    ):
        red = Red(fz(gen.skewed_instance(n=60, k=8, n_categories=2, seed=1), **kw)[0])
        log = Log(echo=False)
        with inj_mod.use_injector(inj_mod.FaultInjector("oracle_raise:1.0")):
            pricer = fd._AnchorPricer(cg.CompositionOracle(red), np.random.default_rng(0), red,
                                      overlap=False, log=log)
        r = np.linspace(-1.0, 1.0, red.T)
        pricer.submit(0, r, 1e-2, None, np.zeros(red.T))
        assert pricer.harvest() == []
        pricer.close()
        counts[name] = {k: log.counters.get(k, 0) for k in (
            "robust_oracle_retry", "robust_oracle_skip", "fault_oracle_raise")}
    assert counts["port"] == counts["jax"]
    assert counts["port"]["robust_oracle_skip"] == 3


class _FailingPricer:
    def dispatch(self, tasks):
        raise RuntimeError("device dispatch failed")


def test_only_an_injected_fault_degrades_device_pricing():
    """An injected ``device_dispatch`` fault walks the device-pricing rung:
    counted, the device dropped, the host MILPs price the batch. A real
    error of the dispatch (here with an injector installed that does not
    fire) propagates: no rung turns it into a host fallback."""
    red = TRed(t_featurize(tgen.skewed_instance(n=60, k=8, n_categories=2, seed=1), device="cpu")[0])
    r = np.linspace(-1.0, 1.0, red.T)
    log = TLog(echo=False)
    with tinj.use_injector(tinj.FaultInjector("device_dispatch:1.0")):
        pricer = tfd._AnchorPricer(tcg.CompositionOracle(red), np.random.default_rng(0), red,
                                   overlap=False, log=log, device=_FailingPricer())
    pricer.submit(1, r, 1e-2, None, np.zeros(red.T))
    assert pricer.device is None
    assert log.counters["robust_degrade_device_pricing"] == 1
    # the ladder's first rung, walked once
    assert log.counters["robust_degrade_device_pricing_host_milp"] == 1
    assert log.counters["robust_degrade_steps"] == 1
    assert len(pricer.harvest()) >= 1  # the host MILP's anchor
    pricer.close()
    with tinj.use_injector(tinj.FaultInjector("oracle_raise:1.0")):
        pricer = tfd._AnchorPricer(tcg.CompositionOracle(red), np.random.default_rng(0), red,
                                   overlap=False, log=TLog(echo=False), device=_FailingPricer())
    with pytest.raises(RuntimeError, match="device dispatch failed"):
        pricer.submit(1, r, 1e-2, None, np.zeros(red.T))
    pricer.close()


#: the forced device route with device pricing on (the two-sided kernel's
#: plain version for every master, anchors priced by the device lanes)
DEVICE_PRICING = dict(decomp_host_master_max_types=0, pdhg_megakernel=True,
                      decomp_device_pricing=True, lp_batch=False, decomp_time_budget_s=1e9)


@pytest.mark.parametrize("spec", ["device_dispatch:1.0", "pdhg_nan:1.0"])
def test_face_loop_faults_recover_like_reference(spec, monkeypatch):
    """The face loop on the forced device route of
    ``tests/test_torch_device_pricing.py``'s pool, a fault at every
    consultation: ``device_dispatch`` degrades to host anchors at the first
    dispatch; ``pdhg_nan`` poisons every master, whose sentinel quarantines
    it and the round re-solves on the host. Both loops certify, and the
    fault and recovery counters equal the JAX package's."""
    def make(gen):
        return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)

    keys = ("robust_degrade_device_pricing", "robust_host_resolve", "sentinel_quarantined",
            "fault_device_dispatch", "decomp_oracle_device_hit")
    runs = {}
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    for name, fd, cg, inj_mod, Log, cfg, fz, Red, kw in (
        ("jax", jfd, jcg, jinj, JLog, jcfg(), j_featurize, JRed, {}),
        ("port", tfd, tcg, tinj, TLog, tconfig.default_config(), t_featurize, TRed,
         dict(device="cpu")),
    ):
        red = Red(fz(make(jgen if name == "jax" else tgen), **kw)[0])
        v, _ = cg._leximin_relaxation(red, Log(echo=False))
        seeds = cg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)
        cfg = cfg.replace(**DEVICE_PRICING)
        log = Log(echo=False)
        with inj_mod.use_injector(inj_mod.FaultInjector(spec)):
            C, p, eps, _ = fd.realize_profile(
                red, v, list(seeds), cg.CompositionOracle(red), cfg.decomp_accept, log=log,
                max_rounds=8, use_pdhg=True, cfg=cfg, **kw,
            )
        assert eps <= cfg.decomp_accept, name
        mix = p @ (C.astype(np.float64) / red.msize[None, :])
        # a device master's ε is its mixture's residual itself; a host
        # re-solve's is the LP's value, up to its tolerance
        host = spec.startswith("pdhg_nan")
        assert float(np.abs(mix - v).max()) <= (cfg.decomp_accept if host else eps + 1e-12)
        runs[name] = {k: log.counters.get(k, 0) for k in keys}
    if spec.startswith("device_dispatch"):
        assert runs["port"]["robust_degrade_device_pricing"] == 1
        assert runs["port"]["decomp_oracle_device_hit"] == 0
        assert runs["port"] == runs["jax"]
    else:
        # every round's master is quarantined and re-solved on the host (the
        # loops' rounds agree, so do the counts)
        assert runs["port"]["robust_host_resolve"] >= 1
        assert runs["port"]["robust_host_resolve"] == runs["port"]["sentinel_quarantined"]
        for k in ("robust_host_resolve", "sentinel_quarantined"):
            assert runs["port"][k] == runs["jax"][k], k


def test_qp_nan_falls_back_to_the_serial_route_like_reference():
    """``qp_nan:1.0`` poisons the fused L2 stage's donor: the QP sentinel
    quarantines it and the serial ascent realizes the targets from the
    clean donor, within the contract, in both packages."""
    rng = np.random.default_rng(11)
    C, n = 60, 16
    P = (rng.random((C, n)) < 0.35).astype(bool)
    P[:n, :n] |= np.eye(n, dtype=bool)
    donor = np.zeros(C)
    donor[:20] = rng.random(20)
    donor /= donor.sum()
    t = np.clip(P[:20].T.astype(np.float64) @ donor[:20], 0.0, 1.0)
    loose = 0.9 * donor[:20] + 0.1 / 20
    PT = P.T.astype(np.float64)
    out = {}
    for name, mod, inj_mod, Log, cfg, kw in (
        ("jax", jqp, jinj, JLog, jcfg(), {}),
        ("port", tqp, tinj, TLog, tconfig.default_config(), dict(device="cpu")),
    ):
        log = Log(echo=False)
        cfg = cfg.replace(lp_batch=True, sparse_ops=True)
        with inj_mod.use_injector(inj_mod.FaultInjector("qp_nan:1.0")):
            p, eps = mod.solve_final_primal_l2(P, t, iters=4000, floor_donor=loose, cfg=cfg,
                                               log=log, **kw)
        assert np.all(np.isfinite(p)) and abs(p.sum() - 1.0) <= 1e-9
        assert float(np.abs(PT @ p - t).max()) <= eps + CONTRACT
        out[name] = (p, eps, {k: log.counters.get(k, 0) for k in (
            "sentinel_quarantined", "sentinel_host_resolve", "lp_batch_l2_fused")})
    assert out["port"][2] == out["jax"][2] == {
        "sentinel_quarantined": 1, "sentinel_host_resolve": 1, "lp_batch_l2_fused": 1}
    assert abs(out["port"][1] - out["jax"][1]) <= CONTRACT
    assert float(np.abs(out["port"][0] - out["jax"][0]).max()) <= CONTRACT


def test_entry_point_installs_the_config_injector():
    """``Config.fault_sites`` reaches the sites through the entry point:
    LEXIMIN on the agent-space route with ``pdhg_nan:1.0`` poisons every
    device dual LP, each re-solved on the host, and the result still meets
    the contract."""
    td, ts = t_featurize(tgen.random_instance(n=24, k=5, n_categories=2, seed=3), device="cpu")
    cfg = tconfig.default_config().replace(
        force_agent_space=True, backend="jax", fault_sites="pdhg_nan:1.0", fault_seed=1,
    )
    log = TLog(echo=False)
    dist = t_leximin(td, ts, cfg=cfg, log=log, device="cpu")
    c = log.counters
    assert c["fault_pdhg_nan"] >= 1
    assert c["sentinel_poisoned"] == c["fault_pdhg_nan"]
    assert c.get("sentinel_host_resolve", 0) >= 1
    assert dist.contract_ok
    assert tinj.active_injector() is None
