"""The leximin profile certificate: the port against the JAX package.

The same seeded pools go through both packages' ``audit_leximin_profile``
and ``audit_second_level`` on the CPU: the JAX package's certified profile
(``Distribution.fixed_probabilities``) of the pool of
``tests/test_certification.py:277``, of ``skewed_instance(n=120, k=12,
n_categories=3, seed=1)``, and of a household run's quotient (40 couples,
audited on the quotient's augmented instance, as
``tests/test_households.py:90`` does). Host code on both sides, HiGHS on
identical rows: every case holds the rounded dicts equal exactly, and none
needs the 1e-6 a field that two HiGHS builds would allow. The port's own
CPU LEXIMIN is certified by the port's audit, a profile with one level
lowered by 0.01 fails the certificate in both packages, and
``chip_smoke.py``'s hold (an audit in a worker process, folded into its
path's record) passes a certified profile and fails the lowered one.

On the stage-CG pool of ``tests/test_torch_stage_cg.py``
(``skewed_instance(n=80, k=8, n_categories=3, seed=3)``) both packages'
audits leave level 2 at a gap of 0.009996: their witness comes from the
marginal relaxation, which has an integrality gap there. Enumerating all
feasible compositions shows the profile optimal, and ``chip_smoke.py``'s
exact level bound (column generation with the exact MILP) closes the gap
on it and not on the same profile with that level lowered.
"""

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core import instance as jinst
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.solvers import highs_backend as jhb
from citizensassemblies_tpu.solvers.quotient import build_household_quotient as j_quotient

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core import instance as tinst
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.solvers import highs_backend as thb
from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient as t_quotient

# many small host ops: intra-op threads would only contend with the other
# test workers for the cores
torch.set_num_threads(1)

#: the certificate's bars (tests/test_certification.py:277-310)
GAP = 1e-3
GAP_MILP = 5e-3
#: how far a level is lowered to break the certificate
LOWERED = 0.01

POOLS = {
    # tests/test_certification.py:277: a 9-level profile
    "skewed_300": dict(n=300, k=45, n_categories=4, seed=14, features_per_category=[3, 4, 2, 3],
                       skew=0.6),
    "skewed_120": dict(n=120, k=12, n_categories=3, seed=1),
    # tests/test_torch_stage_cg.py: 50 feasible compositions
    "skewed_80": dict(n=80, k=8, n_categories=3, seed=3),
    # tests/test_households.py:90, with 40 couples
    "couples_80": dict(n=80, k=12, n_categories=3, seed=3, features_per_category=[2, 3, 2]),
}
HOUSEHOLDS = {"couples_80": (np.arange(80) // 2).astype(np.int32)}

_pools = {}


def _pool(name):
    """Both packages' instances the audit reads (a household pool's
    quotient's augmented instance), the JAX package's LEXIMIN distribution
    and the port's own CPU one, cached across the cases."""
    if name not in _pools:
        hh = HOUSEHOLDS.get(name)
        jd, js = jinst.featurize(jgen.skewed_instance(**POOLS[name]))
        td, ts = tinst.featurize(tgen.skewed_instance(**POOLS[name]), device="cpu")
        jdist = j_leximin(jd, js, households=hh)
        tdist = t_leximin(td, ts, households=hh, device="cpu")
        if hh is not None:
            jd, td = j_quotient(jd, hh).dense_aug, t_quotient(td, hh).dense_aug
        _pools[name] = dict(jd=jd, td=td, jdist=jdist, tdist=tdist)
    return _pools[name]


def _lowered(name, level):
    """The JAX package's certified profile of ``name`` with every agent of
    its ``level``-th level (0-based; "deep": the last level more than
    2·``LOWERED`` above its predecessor, so it stays a level of its own)
    lowered by ``LOWERED``; returns the profile and the level's index."""
    p = _pool(name)
    fixed, covered = p["jdist"].fixed_probabilities, p["jdist"].covered
    achieved = [lv["achieved"] for lv in jhb.audit_leximin_profile(p["jd"], fixed, covered)["levels"]]
    if level == "deep":
        level = max(j for j in range(1, len(achieved)) if achieved[j] - achieved[j - 1] > 2 * LOWERED)
    assert level == 0 or achieved[level] - achieved[level - 1] > 2 * LOWERED
    at = covered & (fixed >= achieved[level] - 1e-6) & (fixed <= achieved[level] + GAP)
    assert at.any()
    return np.where(at, fixed - LOWERED, fixed), level


def _certified(prof):
    """The hold ``chip_smoke.py`` puts on every finished LEXIMIN path."""
    return (
        prof["all_within_tol"] and prof["worst_gap"] <= GAP and prof["worst_gap_milp"] <= GAP_MILP
        and all(min(lv["certified_upper"], lv["milp_upper"]) >= lv["achieved"] - 1e-9
                for lv in prof["levels"])
    )


@pytest.mark.parametrize(
    "name,covered,max_levels",
    [("skewed_300", True, None), ("skewed_300", True, 3), ("couples_80", True, None),
     ("couples_80", False, None)],
    ids=["skewed_300", "skewed_300-max_levels_3", "couples_80_quotient",
         "couples_80_quotient-uncovered"],
)
def test_profile_audit_equals_reference(name, covered, max_levels):
    """``audit_leximin_profile`` on the JAX package's certified profile:
    equal dicts, with the covered mask and without it, over every level and
    over the first three; the profile certified."""
    p = _pool(name)
    dist = p["jdist"]
    mask = dist.covered if covered else None
    want = jhb.audit_leximin_profile(p["jd"], dist.fixed_probabilities, mask, max_levels=max_levels)
    got = thb.audit_leximin_profile(p["td"], dist.fixed_probabilities, mask, max_levels=max_levels)
    assert got == want
    assert got["n_levels"] == (max_levels or got["n_levels"]) >= 2
    assert _certified(got), got


@pytest.mark.parametrize("name", ["skewed_120", "skewed_300", "one_level"])
def test_second_level_equals_reference(name):
    """``audit_second_level`` on the JAX package's certified profile (on
    "one_level", the uniform k/n allocation of the n=120 pool, one level
    only, whose level-2 fields are None): equal dicts."""
    p = _pool("skewed_120" if name == "one_level" else name)
    dist = p["jdist"]
    fixed = dist.fixed_probabilities
    if name == "one_level":
        fixed = np.full(p["td"].n, p["td"].k / p["td"].n)
    want = jhb.audit_second_level(p["jd"], fixed, dist.covered)
    got = thb.audit_second_level(p["td"], fixed, dist.covered)
    assert got == want
    if name == "one_level":
        assert got["level2_gap"] is None and got["achieved_level2"] is None
    else:
        assert 0 < got["level1_set_types"] and got["level2_gap"] <= GAP
        assert got["certified_level2_upper"] >= got["achieved_level2"] - 1e-9


@pytest.mark.parametrize("name", ["skewed_300", "couples_80"])
def test_port_leximin_is_certified(name):
    """The port's own CPU LEXIMIN (with households on the couples' pool),
    certified by the port's audit on its certified profile at every level,
    and the JAX package's audit of the same profile equal to it."""
    p = _pool(name)
    dist = p["tdist"]
    assert dist.contract_ok
    got = thb.audit_leximin_profile(p["td"], dist.fixed_probabilities, dist.covered)
    assert _certified(got), got
    assert got == jhb.audit_leximin_profile(p["jd"], dist.fixed_probabilities, dist.covered)


@pytest.mark.parametrize("level", [0, "deep"])
def test_lowered_level_fails_the_certificate(level):
    """A certified profile with one level lowered by 0.01 (the first, or a
    deep one): both packages report that level's gap at 0.01 − 1e-6 or
    more and ``all_within_tol`` false, in equal dicts."""
    p = _pool("skewed_300")
    fixed, j = _lowered("skewed_300", level)
    want = jhb.audit_leximin_profile(p["jd"], fixed, p["jdist"].covered)
    got = thb.audit_leximin_profile(p["td"], fixed, p["jdist"].covered)
    assert got == want
    for prof in (got, want):
        assert prof["levels"][j]["gap"] >= LOWERED - 1e-6
        assert prof["worst_gap"] >= LOWERED - 1e-6
        assert not prof["all_within_tol"] and not _certified(prof)
        assert all(lv["gap"] <= GAP for lv in prof["levels"][:j])


def test_chip_smoke_profile_hold():
    """``chip_smoke.py``'s certificate: each audit started in a worker
    process from the host arrays of the instance it reads (here the
    couples' quotient on the CPU), collected onto its path's record (a
    ``phase:pool`` label onto that pool's key). A certified profile passes
    with the bench's fields; the n=80 pool's profile with level 2 lowered
    by 0.01 fails its path."""
    import chip_smoke

    q = _pool("couples_80")
    p = _pool("skewed_80")
    lowered = type("Lowered", (), dict(
        fixed_probabilities=_lowered("skewed_80", 1)[0], covered=p["jdist"].covered,
    ))
    audits = {}
    chip_smoke.start_profile_audit(audits, "households_n80", q["td"], q["tdist"])
    chip_smoke.start_profile_audit(audits, "lowered:level_2", p["td"], lowered)
    records = {"households_n80": dict(phase="households_n80", ok=True),
               "lowered": dict(phase="lowered", ok=True, level_2={})}
    chip_smoke.profile_audit_phase(audits, records)
    good = records["households_n80"]["profile_certificate"]
    assert records["households_n80"]["ok"] and good["ok"]
    want = thb.audit_leximin_profile(q["td"], q["tdist"].fixed_probabilities, q["tdist"].covered)
    assert good["profile_levels"] == want["n_levels"]
    assert good["profile_worst_gap"] == want["worst_gap"] == good["certified_worst_gap"] <= GAP
    assert good["profile_worst_gap_milp"] == want["worst_gap_milp"]
    assert good["profile_all_within_tol"] is True and good["audit_s"] > 0
    assert good["level2_gap"] == want["levels"][1]["gap"] and good["tightened"] == []
    bad = records["lowered"]["level_2"]["profile_certificate"]
    assert not records["lowered"]["ok"] and not bad["ok"]
    assert bad["certified_worst_gap"] >= LOWERED - 1e-6 and not bad["profile_all_within_tol"]


def _enumerated_level(dense, fixed, covered, level):
    """The ``level``-th level's optimum (0-based) under the audit's floors,
    by the LP over every feasible composition of the pool's types
    (enumerated; the committee polytope in type space, exactly)."""
    from scipy.optimize import linprog

    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(dense)
    m = red.msize.astype(int)
    tf = np.zeros((red.T, red.F), dtype=int)
    for t in range(red.T):
        tf[t, red.type_feature[t]] = 1
    comps, c = [], np.zeros(red.T, dtype=int)

    def walk(t, left, counts):
        if (counts > red.qmax).any():
            return
        if t == red.T:
            if left == 0 and (counts >= red.qmin).all():
                comps.append(c.copy())
            return
        for x in range(min(m[t], left) + 1):
            c[t] = x
            walk(t + 1, left - x, counts + x * tf[t])
        c[t] = 0

    walk(0, red.k, np.zeros(red.F, dtype=int))
    M = (np.array(comps) / m[None, :]).T
    v = np.full(red.T, np.inf)
    np.minimum.at(v, red.type_id, np.where(covered, fixed, np.inf))
    remaining = np.isfinite(v)
    floored = np.zeros(red.T, dtype=bool)
    for _ in range(level):
        S = remaining & (v <= v[remaining].min() + GAP)
        floored |= S
        remaining &= ~S
    N = M.shape[1]
    res = linprog(
        np.concatenate([np.zeros(N), [-1.0]]),
        A_ub=np.vstack([np.hstack([-M[remaining], np.ones((remaining.sum(), 1))]),
                        np.hstack([-M[floored], np.zeros((floored.sum(), 1))])]),
        b_ub=np.concatenate([np.zeros(remaining.sum()), -(v[floored] - 1e-9)]),
        A_eq=np.concatenate([np.ones(N), [0.0]])[None, :], b_eq=[1.0],
        bounds=(0, None), method="highs",
    )
    assert res.status == 0
    return -res.fun, N


@pytest.mark.parametrize("lowered", [False, True], ids=["optimal", "level_2_lowered"])
def test_exact_level_bound_closes_the_integrality_gap(lowered):
    """The n=80 stage-CG pool's LEXIMIN profile (the JAX package's): both
    packages' audits leave level 2 at 0.009996, in equal dicts, though the
    LP over all 50 feasible compositions puts level 2 at what the profile
    achieved. ``chip_smoke.profile_audit``'s exact level bound closes that
    level to within 1e-6 of the enumerated optimum and certifies the
    profile; on the profile with level 2 lowered by 0.01 the audit and the
    exact bound both leave its gap at 0.01 − 1e-6 or more, and the hold
    fails."""
    import chip_smoke

    p = _pool("skewed_80")
    dist = p["jdist"]
    fixed = _lowered("skewed_80", 1)[0] if lowered else dist.fixed_probabilities
    want = jhb.audit_leximin_profile(p["jd"], fixed, dist.covered)
    got = thb.audit_leximin_profile(p["td"], fixed, dist.covered)
    assert got == want
    assert not got["all_within_tol"]
    assert got["levels"][1]["gap"] >= (LOWERED if lowered else 0.0) + 0.009
    optimum, n_comps = _enumerated_level(p["td"], fixed, dist.covered, 1)
    assert n_comps == 50
    rec = chip_smoke.profile_audit(p["td"], fixed, dist.covered)
    # the lowered floor frees mass for every later level, whose gaps open too
    assert [lv["level"] for lv in rec["tightened"]] == ([2, 3, 4, 5, 6, 7] if lowered else [2])
    assert abs(rec["tightened"][0]["exact_upper"] - optimum) <= 1e-6
    if lowered:
        assert rec["certified_worst_gap"] >= LOWERED - 1e-6 and not rec["ok"]
    else:
        assert abs(optimum - got["levels"][1]["achieved"]) <= 1e-6
        assert rec["certified_worst_gap"] <= GAP and rec["ok"]
    assert rec["profile_worst_gap"] == got["worst_gap"]
