"""The port's scenario models against the JAX package's.

The cases of ``tests/test_scenarios.py`` that do not start the service, run
through both packages on the same seeded pools on the CPU, with these
tolerances:

* attendance buckets, product and capped enumerations exactly; the
  certified LEXIMIN values (``realized_values``, the aggregate
  ``fixed_probabilities``) and the selection-space targets within 1e-6;
* allocations of the realized portfolios within 1e-3 (the decompositions
  pick their panels by solver order);
* Monte-Carlo outputs within 5 binomial standard deviations (the two
  packages draw from different streams: ``torch.Generator`` against
  ``jax.random``), never element by element;
* the exact-enumeration MC check and the mesh bit-identity held for the
  port alone, as the JAX test holds them for the JAX package;
* the existing models bit for bit with the scenario knobs changed.

The last case gives both packages' ``dropout_realization_round`` one
LEXIMIN portfolio of ``skewed_instance(n=160, k=14, n_categories=4,
seed=2)``, as numpy, at 4,096 draws a policy and holds the fill and quota
rates within 5σ.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.parallel import mc as jmc
from citizensassemblies_tpu.scenarios import SchedulingInfeasible as JInfeasible
from citizensassemblies_tpu.scenarios import dropout as jdrop
from citizensassemblies_tpu.scenarios import find_distribution_dropout as j_dropout
from citizensassemblies_tpu.scenarios import find_distribution_multi as j_multi
from citizensassemblies_tpu.solvers.compositions import enumerate_compositions as j_enum
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.dist import runtime as trt
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.parallel import mc as tmc
from citizensassemblies_tpu_torch.parallel.mesh import make_mesh
from citizensassemblies_tpu_torch.scenarios import (
    ScenarioError,
    SchedulingInfeasible,
    find_distribution_dropout,
    find_distribution_multi,
)
from citizensassemblies_tpu_torch.scenarios import dropout as tdrop
from citizensassemblies_tpu_torch.solvers.compositions import enumerate_compositions
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

#: certified values and targets of the same LPs in both packages
CERT_TOL = 1e-6
#: the realized portfolios' allocations (the L∞ contract)
ALLOC_TOL = 1e-3


def _tiny(seed=0, n=24, k=5, n_categories=2):
    kw = dict(n=n, k=k, n_categories=n_categories, seed=seed)
    return (t_featurize(tgen.random_instance(**kw), device="cpu"),
            j_featurize(jgen.random_instance(**kw)))


def _hetero_dropout(n, seed=0, lo=0.0, hi=0.5):
    return np.random.default_rng(seed).uniform(lo, hi, size=n)


def _sigma5(a, b, N):
    """Two Monte-Carlo estimates of one probability within 5σ."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    p = np.clip((a + b) / 2, 1.0 / N, 1 - 1.0 / N)
    return bool(np.all(np.abs(a - b) <= 5 * np.sqrt(2 * p * (1 - p) / N)))


def _mc_agree(t, j, N, k):
    """The port's MC stamp against the JAX package's, within 5σ."""
    assert set(t) == set(j)
    assert t["policy"] == j["policy"] and t["draws"] == j["draws"] == N
    for key in ("realized_min", "realized_min_any", "realized_mean", "quota_ok_rate"):
        assert _sigma5([t[key]], [j[key]], N), key
    assert _sigma5([t["fill_rate"]], [j["fill_rate"]], N * k)


# --- dropout-robust LEXIMIN -----------------------------------------------------


def test_dropout_buckets_and_product_enumeration_match_jax():
    (td, _), (jd, _) = _tiny(seed=0)
    drop = _hetero_dropout(td.n, seed=0)
    tb, tw, terr = tdrop._attendance_buckets(drop, 4)
    jb, jw, jerr = jdrop._attendance_buckets(drop, 4)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tw, jw)
    assert terr == jerr
    tred = TypeReduction(tdrop._augment_with_buckets(td, tb, len(tw)))
    jred = JRed(jdrop._augment_with_buckets(jd, jb, len(jw)))
    np.testing.assert_array_equal(tred.type_id, jred.type_id)
    np.testing.assert_array_equal(enumerate_compositions(tred), j_enum(jred))


def test_dropout_contract_and_certified_improvement():
    """The certified realized minimum dominates the attendance-blind
    LEXIMIN's, the portfolio realizes its targets within the contract, and
    both packages certify the same values."""
    (dense, space), (jd, js) = _tiny(seed=0)
    drop = _hetero_dropout(dense.n, seed=0)
    w = 1.0 - np.clip(drop, 0.0, 0.95)

    d = find_distribution_dropout(dense, space, dropout=drop, device="cpu")
    assert d.contract_ok and d.realization_dev <= 1e-3
    assert "fallback" not in d.scenario_audit
    assert d.realized_values.shape == (dense.n,)

    plain = find_distribution_leximin(dense, space, device="cpu")
    blind_min = float((w * plain.allocation)[plain.covered].min())
    aware_min = float(d.realized_values[d.covered].min())
    slack = d.scenario_audit["quantization_linf"] + 1e-6
    assert aware_min >= blind_min - slack
    assert aware_min > blind_min

    jdist = j_dropout(jd, js, dropout=drop)
    np.testing.assert_allclose(d.realized_values, jdist.realized_values, atol=CERT_TOL)
    np.testing.assert_allclose(d.fixed_probabilities, jdist.fixed_probabilities, atol=CERT_TOL)
    np.testing.assert_array_equal(d.covered, jdist.covered)
    np.testing.assert_array_equal(d.type_id, jdist.type_id)
    assert np.abs(d.allocation - jdist.allocation).max() <= ALLOC_TOL
    for key in ("model", "buckets", "quantization_linf", "replacement", "types"):
        assert d.scenario_audit[key] == jdist.scenario_audit[key], key
    assert abs(d.scenario_audit["certified_min_realized"]
               - jdist.scenario_audit["certified_min_realized"]) <= CERT_TOL
    _mc_agree(d.scenario_audit["mc"], jdist.scenario_audit["mc"], 4096, dense.k)


def test_dropout_mc_stamp_and_audit():
    (dense, space), (jd, js) = _tiny(seed=1)
    drop = _hetero_dropout(dense.n, 1)
    d = find_distribution_dropout(dense, space, dropout=drop, device="cpu",
                                  cfg=default_config().replace(scenario_mc_draws=512))
    mc = d.scenario_audit["mc"]
    assert mc["policy"] == "type"
    assert mc["draws"] == 512
    assert 0.0 <= mc["realized_min"] <= 1.0
    assert 0.0 < mc["quota_ok_rate"] <= 1.0
    jdist = j_dropout(jd, js, dropout=drop, cfg=jcfg().replace(scenario_mc_draws=512))
    np.testing.assert_allclose(d.realized_values, jdist.realized_values, atol=CERT_TOL)
    _mc_agree(mc, jdist.scenario_audit["mc"], 512, dense.k)


def test_dropout_fallback_when_product_space_too_large():
    (dense, space), (jd, js) = _tiny(seed=2)
    drop = _hetero_dropout(dense.n, 2)
    d = find_distribution_dropout(dense, space, dropout=drop, device="cpu",
                                  cfg=default_config().replace(enum_max_types=2, scenario_mc_draws=0))
    assert "fallback" in d.scenario_audit
    assert d.contract_ok
    jdist = j_dropout(jd, js, dropout=drop, cfg=jcfg().replace(enum_max_types=2, scenario_mc_draws=0))
    assert d.scenario_audit == jdist.scenario_audit
    np.testing.assert_allclose(d.fixed_probabilities, jdist.fixed_probabilities, atol=CERT_TOL)
    assert np.abs(d.allocation - jdist.allocation).max() <= ALLOC_TOL


def test_dropout_requires_dropout_and_rejects_households():
    (dense, space), _ = _tiny(seed=0)
    with pytest.raises(ScenarioError):
        find_distribution_dropout(dense, space, dropout=None, device="cpu")
    with pytest.raises(ScenarioError):
        find_distribution_dropout(dense, space, dropout=np.zeros(dense.n), device="cpu",
                                  households=np.zeros(dense.n, dtype=np.int64))
    with pytest.raises(ScenarioError):
        find_distribution_dropout(dense, space, dropout=np.zeros(dense.n + 1), device="cpu")


# --- the dropout-realization MC core ----------------------------------------------


def _exact_realization(P, probs, w, type_id, policy):
    """Exact expected seating frequency by enumerating the 2^k attendance
    patterns of every support panel (``tests/test_scenarios.py``'s oracle)."""
    n = P.shape[1]
    freq = np.zeros(n)
    for row, pc in zip(P, probs):
        S = np.nonzero(row)[0]
        off = np.nonzero(~row)[0]
        for pattern in itertools.product([0, 1], repeat=len(S)):
            pa = 1.0
            shows, noshows = [], []
            for i, bit in zip(S, pattern):
                if bit:
                    pa *= w[i]
                    shows.append(i)
                else:
                    pa *= 1.0 - w[i]
                    noshows.append(i)
            contrib = np.zeros(n)
            contrib[shows] = 1.0
            if policy == "type" and noshows:
                for t in set(type_id[noshows].tolist()):
                    need = sum(1 for i in noshows if type_id[i] == t)
                    cand = off[type_id[off] == t]
                    if len(cand):
                        contrib[cand] += min(need, len(cand)) / len(cand)
            elif policy == "naive" and noshows:
                contrib[off] += min(len(noshows), len(off)) / len(off)
            freq += pc * pa * contrib
    return freq


@pytest.mark.parametrize("policy", ["none", "type", "naive"])
def test_dropout_mc_matches_exact_enumeration(policy):
    """The port's realization core against the exact small-case enumeration
    for every replacement policy, within 4σ of the per-agent noise."""
    (dense, _), _ = _tiny(seed=3, n=18, k=4)
    red = TypeReduction(dense)
    P = np.zeros((3, dense.n), dtype=bool)
    P[0, [0, 1, 2, 3]] = True
    P[1, [4, 5, 6, 7]] = True
    P[2, [2, 5, 9, 12]] = True
    probs = np.array([0.5, 0.3, 0.2])
    w = np.linspace(0.45, 0.95, dense.n)
    draws = 60_000
    real = tmc.dropout_realization_round(P, probs, w, red.type_id, dense,
                                         torch.Generator().manual_seed(11), draws, policy=policy)
    exact = _exact_realization(P, probs, w, red.type_id, policy)
    tol = 4.0 * 0.5 / np.sqrt(draws)
    assert np.abs(real.frequencies - exact).max() < tol


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo world in this process for the module, ended after."""
    assert not dist.is_initialized()
    trt.reset_for_tests()
    mesh = make_mesh(1, device="cpu")
    yield mesh
    trt.shutdown()


@pytest.mark.parametrize("policy", ["none", "type", "naive"])
def test_dropout_mc_mesh_bit_identical(mesh1, policy):
    """The chain-sharded path on a one-rank mesh is bit for bit the plain
    path from the same generator seed."""
    (dense, _), _ = _tiny(seed=4, n=20, k=4)
    red = TypeReduction(dense)
    P = np.zeros((2, dense.n), dtype=bool)
    P[0, [0, 1, 2, 3]] = True
    P[1, [4, 5, 6, 7]] = True
    probs = np.array([0.6, 0.4])
    w = np.linspace(0.5, 1.0, dense.n)
    a = tmc.dropout_realization_round(P, probs, w, red.type_id, dense,
                                      torch.Generator().manual_seed(5), 128, policy=policy)
    b = tmc.dropout_realization_round(P, probs, w, red.type_id, dense,
                                      torch.Generator().manual_seed(5), 128, policy=policy,
                                      mesh=mesh1)
    assert np.array_equal(a.counts, b.counts)
    assert a.quota_ok_rate == b.quota_ok_rate


def test_dropout_beats_naive_redraw_baseline_mc():
    """The dropout-aware portfolio with type replacement beats the
    attendance-blind portfolio with a naive re-draw on the MC realized
    minimum, in the port; both stamps agree with the JAX package's."""
    (dense, space), (jd, js) = _tiny(seed=0)
    drop = _hetero_dropout(dense.n, seed=0)
    d = find_distribution_dropout(dense, space, dropout=drop, device="cpu",
                                  cfg=default_config().replace(scenario_mc_draws=0))
    plain = find_distribution_leximin(dense, space, device="cpu",
                                      cfg=default_config().replace(scenario_mc_draws=0))

    def baseline(dist_, drop_dist, red):
        class _Baseline:
            committees = dist_.committees
            probabilities = dist_.probabilities
            attendance = drop_dist.attendance
            type_id = red.type_id
            covered = dist_.covered
        return _Baseline()

    draws = 8_192
    ours = tdrop.evaluate_realization(d, dense, draws=draws, policy="type", seed=0)
    base = tdrop.evaluate_realization(baseline(plain, d, TypeReduction(dense)), dense,
                                      draws=draws, policy="naive", seed=0)
    assert ours["realized_min"] > base["realized_min"]
    jd_drop = j_dropout(jd, js, dropout=drop, cfg=jcfg().replace(scenario_mc_draws=0))
    jplain = j_leximin(jd, js, cfg=jcfg().replace(scenario_mc_draws=0))
    j_ours = jdrop.evaluate_realization(jd_drop, jd, draws=draws, policy="type", seed=0)
    j_base = jdrop.evaluate_realization(baseline(jplain, jd_drop, JRed(jd)), jd, draws=draws,
                                        policy="naive", seed=0)
    _mc_agree(ours, j_ours, draws, dense.k)
    _mc_agree(base, j_base, draws, dense.k)


# --- multi-assembly scheduling ----------------------------------------------------


def _multi_agree(m, jm):
    np.testing.assert_allclose(m.fixed_probabilities, jm.fixed_probabilities, atol=CERT_TOL)
    assert np.abs(m.allocation - jm.allocation).max() <= ALLOC_TOL
    np.testing.assert_array_equal(m.covered, jm.covered)
    np.testing.assert_array_equal(m.type_id, jm.type_id)
    assert m.pair_uniform == pytest.approx(jm.pair_uniform, rel=1e-12)
    for key in ("model", "rounds", "types", "compositions", "fleet_backend"):
        assert m.scenario_audit[key] == jm.scenario_audit[key], key
    assert abs(m.scenario_audit["certified_min_aggregate"]
               - jm.scenario_audit["certified_min_aggregate"]) <= CERT_TOL


def test_multi_capped_enumeration_matches_jax():
    import copy

    (td, _), (jd, _) = _tiny(seed=0)
    for R in (2, 3):
        tred, jred = TypeReduction(td), JRed(jd)
        tcap, jcap = copy.copy(tred), copy.copy(jred)
        tcap.msize = (tred.msize // R).astype(np.int32)
        jcap.msize = (jred.msize // R).astype(np.int32)
        np.testing.assert_array_equal(enumerate_compositions(tcap), j_enum(jcap))


def test_multi_zero_repeats_contract_and_pair_gauge():
    (dense, space), (jd, js) = _tiny(seed=0)
    R = 3
    m = find_distribution_multi(dense, space, rounds=R, device="cpu")
    assert m.contract_ok and m.realization_dev <= 1e-3
    assert len(m.round_portfolios) == R == len(m.round_probabilities)
    assert m.pair_uniform > 0 and m.pair_ratio >= 1.0 - 1e-9
    assert m.scenario_audit["model"] == "multi"
    for seed in range(5):
        sched = m.realize(seed=seed)
        assert sched.shape == (R, dense.k)
        flat = sched.ravel()
        assert len(np.unique(flat)) == flat.size, "agent seated twice"
    _multi_agree(m, j_multi(jd, js, rounds=R))


def test_multi_aggregate_certificate_caps():
    (dense, space), (jd, js) = _tiny(seed=5)
    m = find_distribution_multi(dense, space, rounds=2, device="cpu")
    assert np.all(m.fixed_probabilities <= 1.0 + 1e-9)
    assert np.all(m.fixed_probabilities >= -1e-12)
    assert float(m.allocation.sum()) == pytest.approx(2 * dense.k, abs=1e-6)
    _multi_agree(m, j_multi(jd, js, rounds=2))


def test_multi_rfold_fleet_through_batch_lp(monkeypatch):
    """The R per-round ε-LPs go through the batched engine as one fleet in
    one bucketed dispatch; the rounds' probabilities realize the same
    aggregate as the JAX package's fleet within the contract."""
    from citizensassemblies_tpu_torch.solvers import batch_lp

    (dense, space), (jd, js) = _tiny(seed=0)
    log = RunLog(echo=False)
    R = 3
    fleets = []
    solve = batch_lp.solve_lp_batch

    def recorded(problems, cfg=None, log=None, warm_key=None, **kw):
        before = log.counters.get("lp_batch_dispatches", 0)
        sols = solve(problems, cfg, log, warm_key=warm_key, **kw)
        fleets.append((warm_key, len(problems), log.counters["lp_batch_dispatches"] - before))
        return sols

    monkeypatch.setattr(batch_lp, "solve_lp_batch", recorded)
    m = find_distribution_multi(dense, space, rounds=R, cfg=default_config().replace(lp_batch=True),
                                log=log, device="cpu")
    assert m.scenario_audit["fleet_backend"] == "batch_lp"
    assert log.counters.get("lp_batch_solves", 0) >= R
    assert log.counters.get("lp_batch_dispatches", 0) >= 1
    # the fleet: one call of R lanes, one dispatch
    assert [f for f in fleets if f[0] == "scenario_multi"] == [("scenario_multi", R, 1)]
    assert m.contract_ok
    jlog = JLog(echo=False)
    jm = j_multi(jd, js, rounds=R, cfg=jcfg().replace(lp_batch=True), log=jlog)
    _multi_agree(m, jm)
    assert abs(m.scenario_audit["round_eps_max"] - jm.scenario_audit["round_eps_max"]) <= ALLOC_TOL


def test_multi_infeasible_rounds():
    (dense, space), (jd, js) = _tiny(seed=0, n=12, k=5)
    with pytest.raises(SchedulingInfeasible):
        find_distribution_multi(dense, space, rounds=4, device="cpu")
    with pytest.raises(JInfeasible):
        j_multi(jd, js, rounds=4)


def test_multi_rejects_households_and_bad_rounds():
    (dense, space), _ = _tiny(seed=0)
    with pytest.raises(ScenarioError):
        find_distribution_multi(dense, space, rounds=2, device="cpu",
                                households=np.zeros(dense.n, dtype=np.int64))
    with pytest.raises(ScenarioError):
        find_distribution_multi(dense, space, rounds=0, device="cpu")
    with pytest.raises(ScenarioError, match="enumerable"):
        find_distribution_multi(dense, space, rounds=2, device="cpu",
                                cfg=default_config().replace(enum_max_types=2))


# --- gate-off parity --------------------------------------------------------------


def test_existing_models_bit_identical_with_scenarios_unused():
    """With the scenario knobs changed but the scenarios unused, LEXIMIN is
    bit for bit the default run."""
    (dense, space), _ = _tiny(seed=0)
    base = find_distribution_leximin(dense, space, cfg=default_config(), device="cpu")
    tweaked = find_distribution_leximin(
        dense, space, device="cpu",
        cfg=default_config().replace(
            scenario_dropout_buckets=9, scenario_replacement="naive", scenario_rounds=7,
            scenario_mc_draws=17,
        ),
    )
    assert np.array_equal(base.allocation, tweaked.allocation)
    assert np.array_equal(base.probabilities, tweaked.probabilities)
    assert np.array_equal(base.committees, tweaked.committees)


# --- the realization rates on one LEXIMIN portfolio -------------------------------


@pytest.fixture(scope="module")
def leximin_portfolio():
    """The JAX package's LEXIMIN portfolio of ``skewed_instance(n=160,
    k=14, n_categories=4, seed=2)`` as numpy, the pool in both packages,
    attendance 1 − U(0, 0.5) (numpy seed 0) and the base types."""
    def make(gen):
        return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)

    jd, js = j_featurize(make(jgen))
    td, _ = t_featurize(make(tgen), device="cpu")
    lex = j_leximin(jd, js)
    P = np.asarray(lex.committees, dtype=bool)
    probs = np.asarray(lex.probabilities, dtype=np.float64)
    att = 1.0 - np.random.default_rng(0).uniform(0.0, 0.5, size=td.n)
    return td, jd, P, probs, att, TypeReduction(td).type_id


@pytest.mark.parametrize("policy", ["type", "naive", "none"])
def test_dropout_rates_on_a_leximin_portfolio_match_jax(leximin_portfolio, policy):
    td, jd, P, probs, att, tid = leximin_portfolio
    N = 4096
    got = tmc.dropout_realization_round(P, probs, att, tid, td, torch.Generator().manual_seed(3),
                                        N, policy)
    want = jmc.dropout_realization_round(P, probs, att, tid, jd, jax.random.PRNGKey(3), N, policy)
    assert got.draws == want.draws == N
    assert _sigma5([got.quota_ok_rate], [want.quota_ok_rate], N)
    # fill is a mean of k Bernoulli seats a draw
    assert _sigma5([got.fill_rate], [want.fill_rate], N * td.k)
    assert _sigma5(got.frequencies_valid, want.frequencies_valid, N)
    if policy == "naive":
        assert got.fill_rate == want.fill_rate == 1.0
    if policy == "none":
        assert got.fill_rate < 1.0 and want.fill_rate < 1.0
