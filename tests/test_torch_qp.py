"""The min-L2 stage (``solvers/qp.py``) and its helpers: the port against the JAX package.

The same seeded numpy inputs go through the JAX package's jitted cores and
the port's torch versions on the CPU: the simplex projection, the dense and
ELL dual ascents, the ELL power norm, both fused L2 cores (with the
sentinel on and off), ``solve_final_primal_l2`` over its four routes (dense
and ELL × serial and fused, the fused one forced with ``lp_batch=True``),
the composition expansion and the LRU memo. Each check states its
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citizensassemblies_tpu.solvers import qp as jqp
from citizensassemblies_tpu.solvers.compositions import (
    enumerate_compositions as j_enumerate,
    expand_compositions as j_expand,
)
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.solvers.sparse_ops import ell_pack_rows as j_pack
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_forward, csr_to_device
from citizensassemblies_tpu_torch.solvers import qp as tqp
from citizensassemblies_tpu_torch.solvers.compositions import expand_compositions as t_expand
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import memo as tmemo
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

#: the projection of the same float32 vector: the sort and the threshold
#: pick are exact, the prefix sums differ in order (a sequential sum here,
#: XLA's on the JAX side), a few float32 ulps of entries of order 1
SIMPLEX_TOL = 1e-6
#: 2,000 ascent iterations of float32 iterates: p and λ within ASCENT_TOL,
#: σ within ASCENT_TOL relative. Each iteration sums the matvecs and the
#: projection's prefix sums in another order than XLA, and the step
#: (1/L ≈ 0.1 on this portfolio) carries those ulps into λ; measured here:
#: p within 4e-8 and λ within 2e-7 after 2,000 iterations
ASCENT_TOL = 1e-5
#: the fused cores' anchors: the floor vector each picks, element by element
FLOOR_TOL = 1e-6
#: solve_final_primal_l2 against the JAX package's: ε* (the float64 floor
#: recomputed from the float32 floor vector) and the realized deviation of
#: the returned, float64-blended p
EPS_TOL = 1e-6
DEV_TOL = 1e-5

ROUTES = {
    "dense-serial": dict(sparse_ops=False, lp_batch=False),
    "ell-serial": dict(sparse_ops=True, lp_batch=False),
    "dense-fused": dict(sparse_ops=False, lp_batch=True),
    "ell-fused": dict(sparse_ops=True, lp_batch=True),
}


def _panels(C=150, n=40, k=8, seed=2):
    """The fixed portfolio of the JAX package's sparse-ops L2 test: C panels
    of k of n agents, a target realized by a Dirichlet mix, a donor halfway
    to another mix."""
    rng = np.random.default_rng(seed)
    P = np.zeros((C, n), bool)
    for r in range(C):
        P[r, rng.choice(n, k, replace=False)] = True
    q = rng.dirichlet(np.ones(C))
    t = P.T.astype(np.float64) @ q
    donor = q * 0.5 + rng.dirichlet(np.ones(C)) * 0.5
    return P, t, donor


def _heterogeneous(seed=7):
    """The JAX package's fused-vs-serial L2 case: a 35 % dense random
    portfolio with a noisy target and a 30-panel donor."""
    rng = np.random.default_rng(seed)
    C, n = 100, 24
    P = rng.random((C, n)) < 0.35
    P[:n, :n] |= np.eye(n, dtype=bool)
    donor = np.zeros(C)
    donor[:30] = rng.random(30)
    donor /= donor.sum()
    t = np.clip(P[:30].T.astype(np.float64) @ donor[:30] + rng.normal(0, 2e-3, n), 0.0, 1.0)
    return P, t, donor, 1e-4


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# --- project_simplex -----------------------------------------------------------


def _simplex_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=int(rng.integers(2, 4000))).astype(np.float32)
    if kind == "tied":
        # few distinct values, many ties, so u − css/idx sits at 0 on ties
        return rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=600).astype(np.float32)
    if kind == "uniform":
        return np.full(97, 0.3, np.float32)
    if kind == "one-hot":
        v = np.zeros(50, np.float32)
        v[7] = 5.0
        return v
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind,seed",
    [("random", s) for s in range(4)] + [("tied", s) for s in range(3)]
    + [("uniform", 0), ("one-hot", 0)],
)
def test_project_simplex_matches_reference(kind, seed):
    v = _simplex_inputs(kind, seed)
    want = np.asarray(jqp.project_simplex(jnp.asarray(v)))
    got = tqp.project_simplex(_t(v)).numpy()
    assert float(np.abs(got - want).max()) <= SIMPLEX_TOL
    # on the simplex as far as the JAX package's own float32 threshold is
    got_err = abs(float(got.astype(np.float64).sum()) - 1.0)
    assert got_err <= abs(float(want.astype(np.float64).sum()) - 1.0) + SIMPLEX_TOL
    assert (got >= 0).all()


def test_fixed_order_prefix_sum_matches_cumsum():
    """The two-level prefix sum the CUDA route takes (rows scanned along,
    row totals down) equals a sequential cumsum within float32 rounding,
    at sizes below, at and above one row."""
    rng = np.random.default_rng(3)
    for d in (1, 5, 255, 256, 257, 1000, 15_300):
        u = _t(rng.random(d))
        got = tqp._prefix_sum_fixed_order(u)
        want = torch.cumsum(u.double(), 0).float()
        assert got.shape == (d,)
        assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want[-1]))


# --- the dual ascents and the power norm --------------------------------------


def test_dual_ascent_dense_and_ell_match_reference():
    P, t, _ = _panels()
    C, n = P.shape
    Pf = P.astype(np.float32)
    eps, lr, iters = np.float32(2e-3), np.float32(0.1), 2000
    pj, lj = jqp._min_norm_dual_ascent(
        jnp.asarray(Pf), jnp.asarray(t, jnp.float32), jnp.float32(eps), jnp.float32(lr),
        jnp.zeros(2 * n, jnp.float32), iters=iters,
    )
    pt, lt = tqp._min_norm_dual_ascent(
        _t(Pf), _t(t), _t(eps), _t(lr), torch.zeros(2 * n), iters
    )
    assert float(np.abs(pt.numpy() - np.asarray(pj)).max()) <= ASCENT_TOL
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) <= ASCENT_TOL
    idx, val, _ = j_pack(Pf)
    pje, lje = jqp._min_norm_dual_ascent_ell(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(t, jnp.float32), jnp.float32(eps),
        jnp.float32(lr), jnp.zeros(2 * n, jnp.float32), iters=iters,
    )
    pte, lte = tqp._min_norm_dual_ascent_ell(
        _t(idx, torch.int32), _t(val), _t(t), _t(eps), _t(lr), torch.zeros(2 * n), iters
    )
    assert float(np.abs(pte.numpy() - np.asarray(pje)).max()) <= ASCENT_TOL
    assert float(np.abs(lte.numpy() - np.asarray(lje)).max()) <= ASCENT_TOL
    # the ascent actually spreads: most panels carry mass
    assert int((pte.numpy() > 1e-9).sum()) >= C // 2


@pytest.mark.parametrize("iters", [0, 1, 511, 512, 1100])
def test_serial_ascent_chunks_run_exactly_its_iterations(iters):
    """The serial ascent's fixed count runs in ``L2_CHUNK``-iteration chunks
    (replayed as CUDA graphs on the card) and the remainder op by op:
    exactly ``iters`` steps, each on the carry of the one before."""
    calls = []

    def step(lam):
        calls.append(1)
        return lam + 1.0

    got = tqp._iterate(step, torch.zeros(3), iters, graph=False)
    assert len(calls) == iters
    assert torch.equal(got, torch.full((3,), float(iters)))


def test_ell_power_norm_matches_reference_and_dense():
    P, _, _ = _panels()
    n = P.shape[1]
    idx, val, _ = j_pack(P.astype(np.float32))
    want = float(jqp._ell_power_norm(jnp.asarray(idx), jnp.asarray(val), n))
    got = float(tqp._ell_power_norm(_t(idx, torch.int32), _t(val), n))
    assert abs(got - want) <= ASCENT_TOL * want
    dense = float(tqp._power_norm(_t(P.astype(np.float32))))
    assert abs(dense - want) <= ASCENT_TOL * want


def test_ell_transpose_through_csr_equals_index_add():
    """The agent-major CSR route of ``Pᵀp`` (the CUDA route's
    ``csr_forward``, run here on CPU tensors) against ``index_add_``: the
    same per-agent sums, in panel order."""
    P, _, donor = _panels()
    n = P.shape[1]
    idx, val, _ = j_pack(P.astype(np.float32))
    csr = csr_to_device(idx, val, n, "cpu")
    y = _t(donor)
    got = csr_forward(csr, _t(val)[None])(y[None])[0]
    want = torch.zeros(n).index_add_(0, _t(idx, torch.int64).reshape(-1), (_t(val) * y[:, None]).reshape(-1))
    assert float((got - want).abs().max()) <= 1e-7


# --- the fused cores ------------------------------------------------------------


@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("rep", ["dense", "ell"])
def test_fused_core_matches_reference(rep, sentinel):
    """Both fused cores on the same portfolio, donor and tolerances: equal
    anchor iterations and ascent chunks, the same floor vector, the spread
    iterate within the ascent tolerance; with the sentinel, both clean."""
    P, t, donor = _panels()
    C, n = P.shape
    Pf = P.astype(np.float32)
    sched = (1024, 128, 256, 8)
    args_j = (jnp.asarray(t, jnp.float32), jnp.asarray(donor, jnp.float32),
              jnp.float32(1e-6), jnp.float32(1e-5), jnp.float32(1e-7))
    args_t = (_t(t), _t(donor), _t(1e-6), 1e-5, 1e-7)
    if rep == "dense":
        oj = jqp._get_l2_fused_core(*sched, sentinel=sentinel)(jnp.asarray(Pf), *args_j)
        ot = tqp._get_l2_fused_core(*sched, sentinel=sentinel)(_t(Pf), *args_t)
    else:
        idx, val, _ = j_pack(Pf)
        oj = jqp._get_l2_fused_core_ell(*sched, sentinel=sentinel)(
            jnp.asarray(idx), jnp.asarray(val), *args_j
        )
        csr = csr_to_device(idx, val, n, "cpu")
        ot = tqp._get_l2_fused_core_ell(*sched, sentinel=sentinel)(
            _t(idx, torch.int32), _t(val), *args_t, csr
        )
    assert int(oj[2]) == ot[2] > 0  # anchor iterations
    assert int(oj[3]) == ot[3] > 0  # ascent iterations: chunks × 256
    assert float(np.abs(ot[1].numpy() - np.asarray(oj[1])).max()) <= FLOOR_TOL
    assert float(np.abs(ot[0].numpy() - np.asarray(oj[0])).max()) <= ASCENT_TOL
    if sentinel:
        assert int(np.asarray(oj[4])) & 1 == ot[4] & 1 == 0


def test_fused_core_is_memoized_per_schedule():
    a = tqp._get_l2_fused_core_ell(512, 128, 128, 4)
    assert tqp._get_l2_fused_core_ell(512, 128, 128, 4) is a
    assert tqp._get_l2_fused_core_ell(512, 128, 128, 4, sentinel=True) is not a
    assert len(tqp._L2_FUSED_CORES_ELL) <= tqp._L2_FUSED_CORES_ELL.cap == 4


# --- solve_final_primal_l2 over its four routes ---------------------------------


def _l2_case(case):
    if case == "panels":
        P, t, donor = _panels()
        return P, t, donor, 1e-9
    return _heterogeneous()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", ["panels", "heterogeneous"])
def test_solve_final_primal_l2_matches_reference(case, route):
    P, t, donor, gate = _l2_case(case)
    kw = ROUTES[route]
    jlog, tlog = JLog(echo=False), TLog(echo=False)
    pj, ej = jqp.solve_final_primal_l2(
        P, t, iters=4000, log=jlog, floor_donor=donor, cfg=jcfg().replace(**kw), anchor_if_above=gate,
    )
    pt, et = tqp.solve_final_primal_l2(
        P, t, iters=4000, log=tlog, floor_donor=donor,
        cfg=tconfig.default_config().replace(**kw), anchor_if_above=gate, device="cpu",
    )
    PT = P.T.astype(np.float64)
    dev_j = float(np.abs(PT @ pj - t).max())
    dev_t = float(np.abs(PT @ pt - t).max())
    assert abs(et - ej) <= EPS_TOL
    assert abs(dev_t - dev_j) <= DEV_TOL
    assert abs(pt.sum() - 1.0) <= 1e-9 and (pt >= 0).all()
    for key in ("sparse_hit", "sparse_miss", "lp_batch_l2_fused"):
        assert tlog.counters.get(key) == jlog.counters.get(key), key
    fused = kw["lp_batch"]
    assert ("l2_fused" in tlog.timers) is fused
    assert ("l2_eps_pdhg" in tlog.timers) is not fused


def test_solve_final_primal_l2_without_donor_takes_the_host_lp():
    """No donor: the host ε-LP floor, then the serial ascent (the
    agent-space ``final_stage="l2"`` call)."""
    P, t, _ = _panels()
    jlog, tlog = JLog(echo=False), TLog(echo=False)
    pj, ej = jqp.solve_final_primal_l2(P, t, iters=2000, log=jlog, cfg=jcfg())
    pt, et = tqp.solve_final_primal_l2(P, t, iters=2000, log=tlog, device="cpu")
    assert "l2_eps_lp" in tlog.timers and "l2_dual_ascent" in tlog.timers
    assert abs(et - ej) <= EPS_TOL
    PT = P.T.astype(np.float64)
    assert abs(float(np.abs(PT @ pt - t).max()) - float(np.abs(PT @ pj - t).max())) <= DEV_TOL


def test_solve_final_primal_l2_refuses_an_empty_donor():
    P, t, _ = _panels()
    with pytest.raises(ValueError, match="no probability mass"):
        tqp.solve_final_primal_l2(P, t, floor_donor=np.zeros(3), device="cpu")


# --- expand_compositions --------------------------------------------------------


@pytest.mark.parametrize("budget", [4096, 24])
def test_expand_compositions_matches_reference(budget):
    """The rotation expansion of one composition distribution: the exact
    path (every rotation fits the budget) and the equidistributed one."""
    def make(gen):
        return gen.random_instance(n=60, k=8, n_categories=2, features_per_category=2, seed=11)

    jred = JRed(j_featurize(make(jgen))[0])
    tred = TRed(t_featurize(make(tgen), device="cpu")[0])
    comps = j_enumerate(jred)
    probs = np.random.default_rng(0).dirichlet(np.ones(len(comps)))
    probs[probs < np.quantile(probs, 0.3)] = 0.0
    Pj, qj = j_expand(comps, probs, jred, budget=budget)
    Pt, qt = t_expand(comps, probs, tred, budget=budget)
    np.testing.assert_array_equal(Pt, Pj)
    np.testing.assert_array_equal(qt, qj)
    assert (Pt.sum(axis=1) == tred.k).all()
    assert abs(qt.sum() - 1.0) <= 1e-12


# --- the LRU memo (the JAX package's cases) -------------------------------------


def test_lru_memo_bounds_and_counts_evictions():
    before = tmemo.memo_evictions()
    cache = tmemo.LRU(cap=2, name="t")
    cache["a"] = 1
    cache["b"] = 2
    assert cache.get("a") == 1  # refreshes recency: b is now oldest
    cache["c"] = 3
    assert "b" not in cache and "a" in cache and "c" in cache
    assert len(cache) == 2
    assert cache.evictions == 1
    assert tmemo.memo_evictions() == before + 1
    # a rebuilt entry after eviction works like a fresh insert
    cache["b"] = 20
    assert cache.get("b") == 20


def test_lru_owner_attribution_and_registry():
    cache = tmemo.LRU(1, name="unit_cache")
    before = tmemo.memo_evictions_by_owner()
    cache.put("a", np.zeros(128), owner="tenant:alpha")
    cache.put("b", np.zeros(64))
    after = tmemo.memo_evictions_by_owner()
    # the evicted entry counts against its owner, not the cache's name
    assert after.get("tenant:alpha", 0) == before.get("tenant:alpha", 0) + 1
    assert after.get("unit_cache", 0) == before.get("unit_cache", 0)
    # a deliberate removal is not an eviction; an unowned entry's eviction
    # counts against the cache's name
    assert cache.pop("b").shape == (64,) and cache.evictions == 1
    cache.put("c", 1)
    cache.put("d", 2)
    assert tmemo.memo_evictions_by_owner().get("unit_cache", 0) == after.get("unit_cache", 0) + 1
    assert cache in tmemo.live_caches()
    assert tqp._L2_FUSED_CORES in tmemo.live_caches()
