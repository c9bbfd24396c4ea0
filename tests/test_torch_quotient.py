"""The household quotient and the household rows: the port against the JAX package.

The same seeded inputs go through the JAX package's functions and the
port's, on the CPU: ``build_household_quotient`` on three household
layouts (couples, mixed structures, and a 240-agent pool whose quotient has
more than 64 features), ``compute_households`` and
``cross_product_instance``, the exact oracle and the quota relaxation with
household rows, ``audit_maximin``, the household-disjoint realization
(``_household_disjoint_pick``, ``greedy_decompose`` in the native slicer and
in its Python loop, ``decompose_with_pricing``) on the certified profile of
the couples' quotient, and device pricing and the fused screen on the
240-agent quotient's reduction. Host code on both sides: arrays are held
equal, values within the stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core import instance as jinst
from citizensassemblies_tpu.solvers import compositions as jcomp
from citizensassemblies_tpu.solvers import device_pricing as jdp
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers import highs_backend as jhb
from citizensassemblies_tpu.solvers import native_oracle as jno
from citizensassemblies_tpu.solvers.cg_typespace import leximin_cg_typespace as j_cg
from citizensassemblies_tpu.solvers.quotient import build_household_quotient as j_quotient
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core import instance as tinst
from citizensassemblies_tpu_torch.solvers import compositions as tcomp
from citizensassemblies_tpu_torch.solvers import device_pricing as tdp
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers import highs_backend as thb
from citizensassemblies_tpu_torch.solvers import native_oracle as tno
from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient as t_quotient

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

#: the oracle's MILP optimum: HiGHS on identical rows in both packages
VALUE_TOL = 1e-9
#: panel probabilities of the decompositions: the same float64 arithmetic
#: on the same inputs
PROB_TOL = 1e-9


def _couples(gen):
    # tests/test_households.py:70, 32 couples
    return gen.skewed_instance(n=64, k=10, n_categories=3, seed=5, features_per_category=[2, 3, 2])


def _mixed(gen):
    # tests/test_households.py:125-141
    return gen.cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(2, 6), (2, 6)]],
        counts=[12, 12], k=8, name="mixed_8",
    )


def _mixed_households():
    # (0,1) same-type couple, (2,12) mixed couple, (3,13,14) triple, the
    # rest singletons
    hh = np.arange(24, dtype=np.int32)
    hh[1] = hh[0]
    hh[12] = hh[2]
    hh[13] = hh[14] = hh[3]
    return hh


def _pairs_240(gen):
    # tests/test_device_pricing.py:221-226: the quotient has F > 64
    return gen.skewed_instance(n=240, k=16, n_categories=3, seed=7, features_per_category=[3, 3, 3])


FIXTURES = {
    "couples_64": (_couples, lambda: (np.arange(64) // 2).astype(np.int32)),
    "mixed_24": (_mixed, _mixed_households),
    "pairs_240": (_pairs_240, lambda: (np.arange(240) // 2).astype(np.int32)),
}


def _dense_both(make):
    return jinst.featurize(make(jgen))[0], tinst.featurize(make(tgen), device="cpu")[0]


_memo = {}


def _quotients(name):
    if name not in _memo:
        make, households = FIXTURES[name]
        jd, td = _dense_both(make)
        hh = households()
        _memo[name] = (jd, td, hh, j_quotient(jd, hh), t_quotient(td, hh))
    return _memo[name]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_quotient_equals_reference(name):
    """Every array of the quotient equal, so the orbits (and every tie
    order that follows from them) are the same."""
    _jd, _td, _hh, jq, tq = _quotients(name)
    ja, ta = jq.dense_aug, tq.dense_aug
    np.testing.assert_array_equal(ta.A_np, ja.A_np)
    np.testing.assert_array_equal(ta.qmin_np, ja.qmin_np)
    np.testing.assert_array_equal(ta.qmax_np, ja.qmax_np)
    np.testing.assert_array_equal(ta.cat_of_feature_np, np.asarray(ja.cat_of_feature))
    assert ta.n_categories == ja.n_categories and ta.k == ja.k
    assert ta.device == torch.device("cpu")
    for field in ("households", "class_of_household", "class_size"):
        np.testing.assert_array_equal(getattr(tq, field), getattr(jq, field))
        assert getattr(tq, field).dtype == getattr(jq, field).dtype
    assert tq.n_classes == jq.n_classes
    assert tq.class_feature_base == jq.class_feature_base
    if name == "mixed_24":
        assert tq.n_classes == 5
    if name == "pairs_240":
        assert tno.TypeReduction(ta).F > 64


def test_quotient_rejects_a_short_label_array():
    _jd, td, _hh, _jq, _tq = _quotients("mixed_24")
    with pytest.raises(ValueError, match="label every agent"):
        t_quotient(td, np.zeros(3, np.int32))


def _house_instance(gen):
    # tests/test_households.py:16-25: 20 agents in 10 households of 2
    inst = gen.cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(0, 4), (0, 4)]],
        counts=[10, 10], k=4, name="house_4",
    )
    inst.columns_data = [{"address1": f"{i // 2} Main St", "zip": "90210"} for i in range(20)]
    return inst


def test_cross_product_and_compute_households_equal_reference():
    ji, ti = _house_instance(jgen), _house_instance(tgen)
    assert ti.k == ji.k and ti.categories == ji.categories and ti.agents == ji.agents
    assert ti.name == ji.name
    cols = ["address1", "zip"]
    jh, th = jinst.compute_households(ji, cols), tinst.compute_households(ti, cols)
    np.testing.assert_array_equal(th, jh)
    assert th.dtype == jh.dtype and len(np.unique(th)) == 10
    with pytest.raises(ValueError, match="need 4 counts"):
        tgen.cross_product_instance(["g", "h"], [["a", "b"], ["c", "d"]],
                                    [[(0, 1)] * 2] * 2, [1, 1, 1], k=1)
    bare = tinst.Instance(k=2, categories={"g": {"a": (0, 2)}}, agents=[{"g": "a"}] * 4)
    with pytest.raises(ValueError, match="columns_data"):
        tinst.compute_households(bare, cols)


def _disjoint(panel, hh):
    panel = list(panel)
    return len(set(hh[panel].tolist())) == len(panel)


def test_oracle_with_households_equals_reference():
    """``maximize`` on 8 seeded weight vectors: equal optimum values, every
    committee household-disjoint; ``check_feasible`` and ``certify``
    equal."""
    jd, td, hh, _jq, _tq = _quotients("couples_64")
    jo = jhb.HighsCommitteeOracle(jd, households=hh)
    to = thb.HighsCommitteeOracle(td, households=hh)
    rng = np.random.default_rng(11)
    for _ in range(8):
        w = rng.normal(0.0, 1.0, td.n)
        (jc, jv), (tc, tv) = jo.maximize(w), to.maximize(w)
        assert abs(tv - jv) <= VALUE_TOL
        assert len(tc) == td.k and _disjoint(tc, hh)
        floor = jv - 0.5
        assert (to.certify(w, floor)[0] is None) == (jo.certify(w, floor)[0] is None)
        assert to.certify(w, jv + 1.0) == (None, jv + 1.0)
    assert to.check_feasible() is jo.check_feasible() is True
    # forced inclusion with the household rows
    (jc, jv), (tc, tv) = jo.maximize(np.ones(td.n), forced=(0,)), to.maximize(np.ones(td.n), forced=(0,))
    assert 0 in tc and 1 not in tc and abs(tv - jv) <= VALUE_TOL


def _crowded(gen):
    """10 agents of type a in 5 same-type couples, 10 singletons of type b:
    the quotas ask for 6-8 of a, which the quotas alone allow and the
    household rows (at most 5 of a) do not."""
    return gen.cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(6, 8), (0, 2)]],
        counts=[10, 10], k=8, name="crowded_8",
    )


def _crowded_households():
    hh = np.arange(20, dtype=np.int32)
    hh[:10] = np.arange(10) // 2
    return hh


def test_relaxation_with_household_rows_equals_reference():
    """An instance feasible without households and infeasible with them:
    equal feasibility verdicts, equal suggested quotas and advice lines,
    and the same ``InfeasibleQuotasError`` from the gate."""
    hh = _crowded_households()
    (jd, js), (td, ts) = jinst.featurize(_crowded(jgen)), tinst.featurize(_crowded(tgen), device="cpu")
    assert thb.HighsCommitteeOracle(td).check_feasible()
    jo, to = jhb.HighsCommitteeOracle(jd, households=hh), thb.HighsCommitteeOracle(td, households=hh)
    assert to.check_feasible() is jo.check_feasible() is False
    jq, jl = jhb.relax_infeasible_quotas(jd, js, hh)
    tq, tl = thb.relax_infeasible_quotas(td, ts, hh)
    assert tq == jq and tl == jl
    assert tq[("g", "a")][0] <= 5
    # inclusion sets take the agent-space MILP too, without households
    jq2, jl2 = jhb.relax_infeasible_quotas(jd, js, None, ensure_inclusion=[(0, 1), ()])
    tq2, tl2 = thb.relax_infeasible_quotas(td, ts, None, ensure_inclusion=[(0, 1), ()])
    assert tq2 == jq2 and tl2 == jl2
    with pytest.raises(tinst.InfeasibleQuotasError) as err:
        thb.check_feasible_or_suggest(td, ts, to, hh)
    assert err.value.quotas == tq and err.value.output[1:] == tl


def test_audit_maximin_equals_reference():
    """The certificate on the couples' quotient instance for one allocation
    (the JAX package's household LEXIMIN): equal dicts."""
    from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin

    jd, td, hh, jq, tq = _quotients("couples_64")
    dist = j_leximin(jd, jinst.featurize(_couples(jgen))[1], households=hh)
    want = jhb.audit_maximin(jq.dense_aug, dist.allocation, dist.covered)
    got = thb.audit_maximin(tq.dense_aug, dist.allocation, dist.covered)
    assert got == want
    assert got["maximin_gap"] <= 1e-3
    assert thb.audit_maximin(tq.dense_aug, dist.allocation) == jhb.audit_maximin(
        jq.dense_aug, dist.allocation
    )


_profile = {}


def _certified_profile():
    """The couples' quotient, its reductions in both packages and the JAX
    package's certified composition profile with its realized targets."""
    if not _profile:
        jd, td, hh, jq, tq = _quotients("couples_64")
        jred, tred = jno.TypeReduction(jq.dense_aug), tno.TypeReduction(tq.dense_aug)
        ts = j_cg(jq.dense_aug, jred, cfg=jcfg().replace(mixed_precision=False), log=JLog(echo=False))
        realized = ts.probabilities @ (
            ts.compositions.astype(np.float64) / jred.msize.astype(np.float64)[None, :]
        )
        _profile.update(
            jred=jred, tred=tred, hh=tq.households, comps=np.asarray(ts.compositions),
            probs=np.asarray(ts.probabilities), targets=realized[jred.type_id],
        )
    return _profile


def _assert_disjoint_rows(P, hh):
    for row in P:
        assert _disjoint(np.nonzero(row)[0], hh)


def test_household_disjoint_pick_equals_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        m = int(rng.integers(2, 12))
        scores = rng.integers(0, 3, m).astype(np.float64)  # ties
        rot = rng.permutation(m)
        houses = rng.integers(0, 6, m)
        used_j = set(rng.integers(0, 6, 2).tolist())
        used_t = set(used_j)
        ct = int(rng.integers(1, 4))
        try:
            want = jcomp._household_disjoint_pick(scores, rot, houses, ct, used_j)
        except ValueError as exc:
            with pytest.raises(tcomp.HouseholdPickError, match="infeasible") as err:
                tcomp._household_disjoint_pick(scores, rot, houses, ct, used_t)
            assert str(err.value) == str(exc) and isinstance(err.value, ValueError)
            continue
        got = tcomp._household_disjoint_pick(scores, rot, houses, ct, used_t)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and used_t == used_j


@pytest.mark.parametrize("route", ["native", "python"])
def test_greedy_decompose_with_households_equals_reference(route, monkeypatch):
    """The water-filling decomposition of the certified profile: equal
    panels, probabilities within ``PROB_TOL``, every panel
    household-disjoint; the native slicer and the Python loop each against
    their JAX counterpart, and against each other."""
    pr = _certified_profile()
    if route == "python":
        monkeypatch.setattr(tno, "greedy_decompose_native", lambda *a, **kw: None)
        monkeypatch.setattr(jno, "greedy_decompose_native", lambda *a, **kw: None)
    else:
        assert tno.greedy_decompose_native(
            pr["tred"], pr["comps"][:1], np.ones(1), np.zeros(pr["tred"].T), 4,
            households=pr["hh"],
        ) is not None
    args = (pr["comps"], pr["probs"])
    jP, jq = jcomp.greedy_decompose(*args, pr["jred"], pr["targets"], households=pr["hh"])
    tP, tq = tcomp.greedy_decompose(*args, pr["tred"], pr["targets"], households=pr["hh"])
    np.testing.assert_array_equal(tP, jP)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=PROB_TOL)
    _assert_disjoint_rows(tP, pr["hh"])
    if route == "python":
        monkeypatch.undo()
        nP, nq = tcomp.greedy_decompose(*args, pr["tred"], pr["targets"], households=pr["hh"])
        np.testing.assert_array_equal(nP, tP)
        np.testing.assert_allclose(nq, tq, rtol=0, atol=PROB_TOL)


def test_decompose_with_pricing_with_households_equals_reference():
    """The exact decomposition with the greedy seed cut to 20 panels, so
    the household-disjoint pricing rounds serve the rest of the mass: equal
    panels and probabilities, every panel household-disjoint."""
    pr = _certified_profile()
    args = (pr["comps"], pr["probs"])
    kw = dict(budget=20, tol=1e-9, households=pr["hh"], max_rounds=12)
    want = jcomp.decompose_with_pricing(*args, pr["jred"], pr["targets"], **kw)
    got = tcomp.decompose_with_pricing(*args, pr["tred"], pr["targets"], **kw)
    assert len(got[0]) > 20
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PROB_TOL)
    assert abs(got[2] - want[2]) <= PROB_TOL
    _assert_disjoint_rows(got[0], pr["hh"])


def _pairs_reductions():
    _jd, _td, _hh, jq, tq = _quotients("pairs_240")
    return jno.TypeReduction(jq.dense_aug), tno.TypeReduction(tq.dense_aug)


def _assert_feasible(red, comp):
    comp = np.asarray(comp, dtype=np.int64).ravel()
    assert comp.sum() == red.k
    assert (comp >= 0).all() and (comp <= red.msize).all()
    counts = np.zeros(red.F, dtype=np.int64)
    for t in range(red.T):
        counts[red.type_feature[t]] += comp[t]
    assert (counts >= red.qmin).all() and (counts <= red.qmax).all()


def test_device_pricing_on_the_quotient_equals_reference():
    """The tasks of tests/test_device_pricing.py:231-240 on the 240-agent
    quotient's reduction (F > 64, one class category): every lane's
    composition and flag equal to the JAX core's, in the same order, and
    the same hits and misses."""
    jred, tred = _pairs_reductions()
    assert tred.F > 64
    rng = np.random.default_rng(9)
    w = rng.normal(0, 1.0, tred.T)
    forced = int(np.argmax(tred.msize))
    tasks = [(w, None), (w, forced)]
    jp, tp = jdp.DevicePricer(jred), tdp.DevicePricer(tred, device="cpu")
    jh, th = jp.dispatch(tasks), tp.dispatch(tasks)
    np.testing.assert_array_equal(th.comps.numpy(), np.asarray(jh.comps))
    np.testing.assert_array_equal(th.ok.numpy(), np.asarray(jh.ok))
    (j_hits, j_missed), (t_hits, t_missed) = jp.harvest(jh), tp.harvest(th)
    assert t_missed == j_missed and len(t_hits) >= 1
    assert [i for i, _ in t_hits] == [i for i, _ in j_hits]
    for (i, a), (_j, b) in zip(t_hits, j_hits):
        np.testing.assert_array_equal(a, b)
        _assert_feasible(tred, a)
        if i == 1:
            assert a.ravel()[forced] >= 1


def test_fused_screen_on_the_quotient_equals_reference():
    """The fused move screen on 512 seeded compositions of the 240-agent
    quotient (device-pricing lanes) and one dual vector: equal pairs,
    indices and moved compositions."""
    jred, tred = _pairs_reductions()
    rng = np.random.default_rng(12)
    pricer = tdp.DevicePricer(tred, device="cpu")
    comps = []
    while len(comps) < 512:
        handle = pricer.dispatch([(rng.normal(0, 1.0, tred.T), None) for _ in range(16)])
        lanes, ok = handle.comps.numpy(), handle.ok.numpy()
        comps.extend(lanes.reshape(-1, tred.T)[ok.reshape(-1)])
    comps = np.stack(comps[:512]).astype(np.int16)
    lam = np.abs(rng.normal(0, 1e-3, 2 * tred.T)).astype(np.float32)
    lam[rng.random(2 * tred.T) < 0.5] = 0.0
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
