"""The batched LP engine: the port against the JAX package.

``solve_lp_batch`` pads each instance into its shape bucket and solves it
with the port's serial dense chained PDHG, so a lane takes the iterations
the serial ``solve_lp`` takes on the same padded instance, bit for bit, and
the JAX package's vmapped engine takes the same iterations. The polish screen's lanes
(``solve_polish_screen_ell``, the block kernel's plain version on the CPU)
are held to the JAX package's padded B=4 run with the Pallas kernel in
interpret mode, at ``tests/test_torch_megakernel.py``'s bars. Every
candidate the probe prescreen prunes, in either package, is held to the
exact host LP.
"""

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.solvers import batch_lp as jbl
from citizensassemblies_tpu.solvers import compositions as jcomp
from citizensassemblies_tpu.solvers.sparse_ops import EllPack as JEll
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch.solvers import batch_lp as tbl
from citizensassemblies_tpu_torch.solvers import compositions as tcomp
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers.lp_util import robust_linprog
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack as TEll
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

CFG_ON = tconfig.default_config().replace(lp_batch=True)
J_ON = jcfg().replace(lp_batch=True)
#: tests/test_torch_megakernel.py's bars (the reference's fused-vs-chained)
X_TOL, OBJ_TOL = 5e-4, 5e-5


def _final_primal_fleet(n_inst=6, seed=0):
    """``tests/test_batch_lp.py::_final_primal_fleet``: feasible final-ε LPs
    of varied small shapes."""
    rng = np.random.default_rng(seed)
    fleet = []
    for i in range(n_inst):
        C, n = 18 + 4 * i, 9 + i
        P = rng.random((C, n)) < 0.5
        P[:n, :n] |= np.eye(n, dtype=bool)
        q = rng.random(C)
        q /= q.sum()
        fleet.append((P, P.T.astype(np.float64) @ q))
    return fleet


def _final_primal(P, target):
    """The JAX package's final ε-LP (``min ε s.t. Pᵀp ≥ target − ε, Σp = 1``)
    as a port instance; the port has no caller of that packing."""
    j = jbl.final_primal_batch_lp(P, target)
    return tbl.BatchLP(c=j.c, G=j.G, h=j.h, A=j.A, b=j.b, tol=j.tol, tail_vars=j.tail_vars)


def _padded(inst, m1, m2, nv):
    """The instance zero-padded to one bucket, as the engine pads it."""
    c = np.zeros(nv)
    c[: len(inst.c)] = inst.c
    G = np.zeros((m1, nv))
    G[: inst.G.shape[0], : inst.G.shape[1]] = inst.G
    h = np.zeros(m1)
    h[: len(inst.h)] = inst.h
    A = np.zeros((m2, nv))
    A[: inst.A.shape[0], : inst.A.shape[1]] = inst.A
    b = np.zeros(m2)
    b[: len(inst.b)] = inst.b
    return c, G, h, A, b


def test_batch_matches_serial_per_instance():
    """Every lane of a shared bucket takes the serial solve's iterations on
    the same padded instance and returns its x bit for bit; against the JAX
    engine, the same iterations and objectives within 1e-4."""
    fleet = _final_primal_fleet()
    t_insts = [_final_primal(P, t) for P, t in fleet]
    j_insts = [jbl.final_primal_batch_lp(P, t) for P, t in fleet]
    log = RunLog(echo=False)
    batch = tbl.solve_lp_batch(t_insts, cfg=CFG_ON, log=log, max_iters=30_000,
                               common_bucket=True, device="cpu")
    assert log.counters["lp_batch_dispatches"] == 1
    assert log.counters["lp_batch_solves"] == len(fleet)
    m1, m2, nv = tbl._bucket_key(t_insts, CFG_ON.lp_batch_bucket_max)
    cfg = CFG_ON.replace(pdhg_max_iters=30_000)
    for inst, sol in zip(t_insts, batch):
        ser = tlp.solve_lp(*_padded(inst, m1, m2, nv), cfg=cfg, device="cpu")
        assert sol.ok and ser.ok
        assert sol.iters == ser.iters
        np.testing.assert_array_equal(sol.x, ser.x[: len(inst.c)])
        assert sol.x.shape == inst.c.shape and sol.lam.shape == inst.h.shape
    ref = jbl.solve_lp_batch(j_insts, cfg=J_ON, max_iters=30_000, common_bucket=True)
    for a, b in zip(batch, ref):
        assert a.iters == b.iters
        assert abs(a.objective - b.objective) <= 1e-4


def test_convergence_mask_freezes_early_finisher():
    """An easy lane bucketed with a hard one converges to its own result:
    the same solution and iterations as alone."""
    rng = np.random.default_rng(3)
    n = 10
    easy = _final_primal(np.eye(n, dtype=bool), np.full(n, 1.0 / n))
    P_hard = rng.random((10, n)) < 0.5
    t_hard = np.clip(P_hard.T.astype(np.float64) @ np.full(10, 0.1) + rng.normal(0, 5e-3, n), 0, 1)
    hard = _final_primal(P_hard, t_hard)
    solo = tbl.solve_lp_batch([easy], cfg=CFG_ON, max_iters=30_000, device="cpu")[0]
    both = tbl.solve_lp_batch([easy, hard], cfg=CFG_ON, max_iters=30_000, device="cpu")
    assert both[0].ok and both[0].iters == solo.iters
    np.testing.assert_array_equal(both[0].x, solo.x)
    assert both[1].iters >= both[0].iters


def test_warm_slots_survive_bucket_repad():
    """A warm slot saved at one column bucket re-pads into a larger one,
    the ε tail slot kept last, and the warm solve is no slower than cold."""
    tbl.clear_warm_slots("test_repad")
    rng = np.random.default_rng(4)
    T, C = 12, 28
    MT = rng.uniform(0.0, 1.0, (T, C))
    v = MT @ rng.dirichlet(np.ones(C))
    first = tbl.solve_lp_batch([tbl.two_sided_master_batch_lp(MT, v)], cfg=CFG_ON,
                               warm_key="test_repad", max_iters=40_000, device="cpu")[0]
    assert first.ok
    MT2 = np.concatenate([MT, rng.uniform(0.0, 1.0, (T, 12))], axis=1)
    log = RunLog(echo=False)
    warm = tbl.solve_lp_batch([tbl.two_sided_master_batch_lp(MT2, v)], cfg=CFG_ON, log=log,
                              warm_key="test_repad", max_iters=40_000, device="cpu")[0]
    assert warm.ok and log.counters.get("lp_batch_warm_hits", 0) == 1
    assert len(warm.x) == MT2.shape[1] + 1
    cold = tbl.solve_lp_batch([tbl.two_sided_master_batch_lp(MT2, v)], cfg=CFG_ON,
                              max_iters=40_000, device="cpu")[0]
    assert warm.iters <= cold.iters
    # the re-pad itself: the ε slot stays last through the column growth
    x, lam, mu = tbl._repad_warm((np.arange(5.0), np.ones(3), np.ones(1)), 1, 8, 4, 1)
    np.testing.assert_array_equal(x, [0, 1, 2, 3, 0, 0, 0, 4])
    np.testing.assert_array_equal(lam, [1, 1, 1, 0])
    tbl.clear_warm_slots("test_repad")


def _prescreen_fixture(seed):
    rng = np.random.default_rng(seed)
    T, C = 8, 30
    MT = rng.uniform(0.0, 1.0, (T, C))
    z = float((MT @ rng.dirichlet(np.ones(C))).min())
    return MT, -MT, np.full(T, -(z - jcomp._SLACK)), z


#: how far from the face's boundary, in float64, an iterate may sit where
#: the two packages' masks differ: both stop at a KKT residual of about
#: 1e-6 in float32 (measured on these fixtures: at most 1.7e-6)
FACE_EDGE = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_probe_prescreen_never_prunes_a_tight_candidate(seed):
    """Every candidate either package's screen prunes is verified loose by
    the exact float64 host LP. The masks are equal except where the float64
    face check of the last float32 iterate is a knife edge: a candidate is
    pruned when its approximate optimizer, renormalized, lies on the face,
    and the two packages' iterates differ in their last digits. So wherever
    the masks differ, both packages' optimizers are held to lie within
    ``FACE_EDGE`` of the face's boundary with an objective above the bound:
    a near-tie of the feasibility test, not a different solve."""
    MT, A_face, b_face, z = _prescreen_fixture(seed)
    C = MT.shape[1]
    allowances = np.full(MT.shape[0], 1e-6)
    probe_tol = 1e-7
    loose = tcomp._batched_probe_prescreen(MT, A_face, b_face, z, probe_tol, allowances,
                                          CFG_ON, log=RunLog(echo=False), device="cpu")
    want = jcomp._batched_probe_prescreen(MT, A_face, b_face, z, probe_tol, allowances, J_ON)
    assert loose is not None and want is not None
    for i in np.nonzero(loose | want)[0]:
        r = robust_linprog(-MT[i], A_ub=A_face, b_ub=b_face, A_eq=np.ones((1, C)), b_eq=[1.0],
                           bounds=[(0, None)] * C)
        assert r.status == 0 and float(-r.fun) > z + probe_tol + allowances[i]
    differ = np.nonzero(loose != want)[0]
    if len(differ):
        # the prescreen's own solves, in both packages
        t_sols = tbl.solve_lp_batch(
            [tbl.face_probe_batch_lp(o, A_face, b_face, tol=1e-6) for o in MT], cfg=CFG_ON,
            max_iters=8_192, device="cpu",
        )
        j_sols = jbl.solve_lp_batch(
            [jbl.face_probe_batch_lp(o, A_face, b_face, tol=1e-6) for o in MT], cfg=J_ON,
            max_iters=8_192,
        )
        for i in differ:
            for sol in (t_sols[i], j_sols[i]):
                x = np.maximum(np.asarray(sol.x, dtype=np.float64), 0.0)
                x /= x.sum()
                assert abs(float((A_face @ x - b_face).max())) <= FACE_EDGE
                assert float(MT[i] @ x) > z + probe_tol + allowances[i]


def test_prescreen_fires_somewhere():
    pruned = 0
    for seed in range(4):
        MT, A_face, b_face, z = _prescreen_fixture(seed)
        loose = tcomp._batched_probe_prescreen(MT, A_face, b_face, z, 1e-7,
                                              np.full(MT.shape[0], 1e-6), CFG_ON, device="cpu")
        pruned += int(loose.sum())
    assert pruned > 0


def test_prescreen_disabled_returns_none():
    obj = np.eye(3)
    args = (obj, -obj, np.zeros(3), 0.0, 1e-7, np.full(3, 1e-6))
    assert tcomp._batched_probe_prescreen(*args, CFG_ON.replace(lp_batch_screen=False),
                                          device="cpu") is None
    assert tcomp._batched_probe_prescreen(*args, None, device="cpu") is None
    # the auto gate is off on the CPU
    assert tcomp._batched_probe_prescreen(*args, tconfig.default_config(), device="cpu") is None


def test_empty_and_single_instance_batches():
    assert tbl.solve_lp_batch([], cfg=CFG_ON, device="cpu") == []
    P, t = _final_primal_fleet(n_inst=1)[0]
    inst = _final_primal(P, t)
    sol = tbl.solve_lp_batch([inst], cfg=CFG_ON, max_iters=20_000, device="cpu")[0]
    ser = tlp.solve_lp(inst.c, inst.G, inst.h, inst.A, inst.b, cfg=CFG_ON, device="cpu")
    assert sol.ok and abs(sol.objective - ser.objective) <= 1e-4


def _screen_fixture(seed=7, T=24, C=96):
    """``tests/test_torch_megakernel.py::_flagship_master``'s shape: a
    composition pack over T types scaled by 1/8, ``v`` realised by a mix of
    the first half of the columns."""
    r = np.random.default_rng(seed)
    comps = (r.random((C, T)) < 0.2) * r.integers(1, 4, (C, T))
    MT = (comps / 8.0).T.astype(np.float64)
    p = np.zeros(C)
    p[: C // 2] = r.dirichlet(np.ones(C // 2))
    return MT, MT @ p


@pytest.mark.parametrize("warm", [False, True])
def test_polish_screen_lanes_match_reference(warm):
    """Nested prefixes as lanes of one two-sided solve: the port's three
    lanes (the block kernel's plain version) against the JAX package's
    padded four (the Pallas kernel in interpret mode): equal per-lane
    iterations, x and λ within X_TOL, the objective within OBJ_TOL."""
    MT, v = _screen_fixture()
    T, C = MT.shape
    rows = np.asarray(MT, np.float32).T
    caps = [C // 4, C // 2, C]
    warms = [None] * 3
    if warm:
        sol = tlp.solve_two_sided_master(MT, v, cfg=CFG_ON, tol=1e-3, max_iters=512, device="cpu")
        warms = [(np.concatenate([sol.x[:c], sol.x[-1:]]), sol.lam, sol.mu) for c in caps]
    kw = dict(tol=1e-5, max_iters=4096)
    log = RunLog(echo=False)
    got = tbl.solve_polish_screen_ell(TEll.from_rows(rows, minor=T), v, caps, warms,
                                      cfg=CFG_ON.replace(pdhg_megakernel=True), log=log,
                                      device="cpu", **kw)
    want = jbl.solve_polish_screen_ell(JEll.from_rows(rows, minor=T), v, caps, warms,
                                       cfg=J_ON.replace(pdhg_megakernel=True), **kw)
    assert log.counters["megakernel_dispatches"] == 1
    assert log.counters["megakernel_lanes"] == 3
    assert "megakernel_fit_miss" not in log.counters
    for a, b in zip(got, want):
        assert a.iters == b.iters
        assert np.max(np.abs(a.x - b.x)) < X_TOL
        assert np.max(np.abs(a.lam - b.lam)) < X_TOL
        assert abs(a.objective - b.objective) < OBJ_TOL


def test_polish_screen_chained_route_matches_fused():
    """``pdhg_megakernel=False``: the chained ELL ops give the lanes the
    same iterations as the fused route's plain version."""
    MT, v = _screen_fixture(seed=11)
    T, C = MT.shape
    pack = TEll.from_rows(np.asarray(MT, np.float32).T, minor=T)
    caps = [C // 4, C // 2, C]
    args = (pack, v, caps, [None] * 3)
    fused = tbl.solve_polish_screen_ell(*args, tol=1e-5, max_iters=4096,
                                        cfg=CFG_ON.replace(pdhg_megakernel=True), device="cpu")
    chained = tbl.solve_polish_screen_ell(*args, tol=1e-5, max_iters=4096,
                                          cfg=CFG_ON.replace(pdhg_megakernel=False), device="cpu")
    for a, b in zip(fused, chained):
        assert a.iters == b.iters
        assert np.max(np.abs(a.x - b.x)) < X_TOL


def test_polish_screen_in_the_face_loop_certifies(monkeypatch):
    """With the engine on, the face loop's end-game screens the prefixes as
    one dispatch per polish attempt, and whatever it returns carries the
    float64 certificate ‖Mp − v‖∞ ≤ ε."""
    import citizensassemblies_tpu_torch.core.generator as tgen
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
    from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    monkeypatch.setattr(tfd, "_POLISH_SCREEN_MIN_SUP", 0)
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    dense, _ = featurize(tgen.skewed_instance(n=120, k=12, n_categories=3, seed=2), device="cpu")
    red = TypeReduction(dense)
    v, _ = tcg._leximin_relaxation(red, RunLog(echo=False))
    seeds = tcg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)
    cfg = CFG_ON.replace(decomp_host_master_max_types=0, decomp_device_pricing=False)
    log = RunLog(echo=False)
    C, p, eps, _ = tfd.realize_profile(red, v, list(seeds), tcg.CompositionOracle(red), 1e-5,
                                       log=log, max_rounds=3, use_pdhg=True, cfg=cfg, device="cpu")
    c = log.counters
    assert c.get("lp_batch_dispatches", 0) >= 1
    assert c.get("lp_batch_polish_hit", 0) + c.get("lp_batch_polish_miss", 0) >= 1
    mix = p @ (C.astype(np.float64) / red.msize[None, :])
    assert float(np.abs(mix - v).max()) <= eps + 1e-12


def test_leximin_engine_on_vs_off(monkeypatch):
    """LEXIMIN on a flagship-shaped pool (27 types: the column-generation
    path and the face loop) with every route forced onto the device
    routes: the engine on and off meet the contract and agree within 1e-3."""
    import citizensassemblies_tpu_torch.core.generator as tgen
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin

    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    inst = tgen.random_instance(n=120, k=15, n_categories=3, features_per_category=3, seed=5)
    out = {}
    for on in (True, False):
        dense, space = featurize(inst, device="cpu")
        cfg = tconfig.default_config().replace(
            lp_batch=on, decomp_host_master_max_types=0, mixed_precision=False
        )
        out[on] = find_distribution_leximin(dense, space, cfg=cfg, device="cpu")
    for d in out.values():
        assert d.contract_ok
    assert float(np.max(np.abs(out[True].allocation - out[False].allocation))) <= 1e-3
    np.testing.assert_allclose(out[True].fixed_probabilities, out[False].fixed_probabilities,
                               rtol=0, atol=1e-6)
