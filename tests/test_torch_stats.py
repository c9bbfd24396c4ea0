"""Fairness statistics, ratio products and intersections: the port against
the JAX package.

The same numpy inputs, made from a seed, go through ``ops/stats``,
``ops/ratio`` and ``ops/intersections`` of both packages on the CPU. Both
reduce in float32 (the JAX package with 64-bit mode off, as the tests run
it), in their own summation orders, so the float results are held within
``F32_TOL``; comparisons and host-side scipy/numpy code are held exactly.
"""

import csv

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
import citizensassemblies_tpu.ops.intersections as jint
import citizensassemblies_tpu.ops.ratio as jratio
import citizensassemblies_tpu.ops.stats as jstats
from citizensassemblies_tpu.core.instance import featurize as j_featurize

import citizensassemblies_tpu_torch.core.generator as tgen
import citizensassemblies_tpu_torch.ops.intersections as tint
import citizensassemblies_tpu_torch.ops.ratio as tratio
import citizensassemblies_tpu_torch.ops.stats as tstats
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize

#: float32 reductions of at most a few thousand terms of magnitude ≤ 1, in
#: two summation orders: a few ulps of float32 (1.2e-7 each) at most
F32_TOL = 1e-6

#: (n, k, zeros): allocation sizes of the tiny, example_small and sf_e pools,
#: the last with agents LEGACY never drew (the geometric mean's 1e-4 floor)
ALLOCS = {"tiny": (24, 4, 0), "example_small": (200, 20, 0), "sf_e": (1727, 110, 40)}


def _alloc(n, k, zeros, seed=0):
    """A seeded allocation summing to ``k`` with ``zeros`` agents at 0."""
    rng = np.random.default_rng(seed)
    a = rng.dirichlet(np.full(n, 2.0)) * k
    a[rng.choice(n, zeros, replace=False)] = 0.0
    a = np.minimum(a * k / a.sum(), 1.0)
    return a * k / a.sum()


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("name", list(ALLOCS))
def test_prob_allocation_stats_match(name, cap):
    a = _alloc(*ALLOCS[name])
    j = jstats.prob_allocation_stats(a, cap_for_geometric_mean=cap)
    t = tstats.prob_allocation_stats(a, cap_for_geometric_mean=cap, device="cpu")
    assert t.min == j.min  # one float32 rounding of the same float64 value
    assert abs(t.gini - j.gini) <= F32_TOL
    if ALLOCS[name][2] and not cap:
        assert t.geometric_mean == j.geometric_mean == 0.0
    else:
        assert abs(t.geometric_mean - j.geometric_mean) <= F32_TOL * j.geometric_mean


@pytest.mark.parametrize("name", list(ALLOCS))
def test_gini_geometric_mean_share_below_match(name):
    a = _alloc(*ALLOCS[name], seed=1)
    ja, ta = np.asarray(a, np.float32), torch.tensor(a, dtype=torch.float32)
    assert abs(float(tstats.gini(ta)) - float(jstats.gini(ja))) <= F32_TOL
    for cap in (False, True):
        assert abs(float(tstats.geometric_mean(ta, cap=cap))
                   - float(jstats.geometric_mean(ja, cap=cap))) <= F32_TOL
    n = a.shape[0]
    for threshold in (0.0, float(np.median(a)), float(a.max()), 1.0):
        # the same comparisons in float32: the same count; the mean of the
        # 0/1 vector in float32 rounds the division differently
        t = float(tstats.share_below(ta, threshold))
        j = float(jstats.share_below(ja, threshold))
        assert round(t * n) == round(j * n) and abs(t - j) <= F32_TOL


def test_gini_rounds_k_half_to_even():
    """``k = round(Σπ)``: both packages round half to even (an allocation
    summing to 2.5 divides by 2, not 3)."""
    a = np.array([0.5, 1.0, 1.0], np.float32)
    t = float(tstats.gini(torch.tensor(a)))
    assert t == pytest.approx(float(jstats.gini(a)), abs=F32_TOL)
    assert t == pytest.approx(sum((2 * i - 2) * v for i, v in enumerate(sorted(a))) / (3 * 2))


@pytest.mark.parametrize("C,n", [(40, 24), (512, 200), (1475, 1727)])
def test_allocation_from_portfolio_matches(C, n):
    rng = np.random.default_rng(C)
    P = rng.random((C, n)) < 0.06
    p = rng.dirichlet(np.ones(C))
    j = np.asarray(jstats.allocation_from_portfolio(P, p.astype(np.float32)))
    t = tstats.allocation_from_portfolio(P, p, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize(
    "trials,prop",
    [(10_000, 0.0), (10_000, 0.0265), (500, 0.142), (2_000, 0.084), (300, 1.0), (7, 3 / 7)],
)
def test_upper_confidence_bound_equal(trials, prop):
    assert tstats.upper_confidence_bound(trials, prop) == jstats.upper_confidence_bound(trials, prop)


def test_allocation_dict_to_vector_equal():
    d = {3: 0.25, "0": 0.5, 7: 1.0}
    np.testing.assert_array_equal(
        tstats.allocation_dict_to_vector(d, 9), jstats.allocation_dict_to_vector(d, 9)
    )


INSTANCES = {
    "example_small_like": lambda g: g.example_small_like_instance(),
    "skewed_160": lambda g: g.skewed_instance(n=160, k=14, n_categories=4, seed=2),
    "sf_e_skewed_seed1": lambda g: g.sf_e_skewed_instance(seed=1),
    # a cell no agent holds: its log-ratio is masked out of the product
    "empty_cell": lambda g: g.cross_product_instance(
        categories=["g", "a"], features=[["x", "y", "z"], ["p", "q"]],
        quotas=[[(1, 3), (1, 3), (0, 2)], [(1, 3), (1, 3)]],
        counts=[4, 3, 5, 2, 0, 0], k=4, name="empty_cell_4",
    ),
}


@pytest.mark.parametrize("name", list(INSTANCES))
def test_ratio_products_match(name):
    jd, _ = j_featurize(INSTANCES[name](jgen))
    td, _ = t_featurize(INSTANCES[name](tgen), device="cpu")
    j = np.asarray(jratio.compute_ratio_products(jd))
    t = tratio.compute_ratio_products(td)
    assert t.dtype == torch.float32 and t.shape == (td.n,)
    assert np.isfinite(t.numpy()).all()
    np.testing.assert_allclose(t.numpy(), j, rtol=F32_TOL, atol=0)


def _intersections_csv(path, space, rng):
    """Every pair of cells from two different categories, with stated
    population shares, in the reference schema."""
    with open(path, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(["category 1", "feature 1", "category 2", "feature 2", "population share"])
        for i, (c1, f1) in enumerate(space.cells):
            for c2, f2 in space.cells[i + 1:]:
                if c1 != c2:
                    w.writerow([c1, f1, c2, f2, f"{rng.random() * 0.2:.4f}"])


@pytest.mark.parametrize("name", ["skewed_160", "sf_e_skewed_seed1"])
def test_intersections_match(name, tmp_path):
    jd, jspace = j_featurize(INSTANCES[name](jgen))
    td, tspace = t_featurize(INSTANCES[name](tgen), device="cpu")
    path = tmp_path / "intersections.csv"
    _intersections_csv(path, tspace, np.random.default_rng(3))
    jt = jint.read_intersections(path, jd, jspace)
    tt = tint.read_intersections(path, td, tspace)
    assert tt.rows == jt.rows and len(tt.rows) > 20
    np.testing.assert_array_equal(tt.group_mask, jt.group_mask)
    np.testing.assert_array_equal(tt.population_share, jt.population_share)
    np.testing.assert_array_equal(tt.quota_share, jt.quota_share)

    allocs = {"LEGACY": _alloc(td.n, td.k, 3, seed=5), "LEXIMIN": _alloc(td.n, td.k, 0, seed=6)}
    js = jint.intersection_shares(jt, jd.k, allocs)
    ts = tint.intersection_shares(tt, td.k, allocs, device="cpu")
    assert set(ts) == set(js)
    for key in js:
        np.testing.assert_allclose(ts[key], js[key], rtol=0, atol=F32_TOL, err_msg=key)
    jm, tm = jint.intersection_mses(js), tint.intersection_mses(ts)
    assert list(tm) == list(jm) == list(tint.DIFF_PAIRS) == list(jint.DIFF_PAIRS)
    for pair in jm:
        # differences d of two share series, each share within F32_TOL:
        # |d_t² − d_j²| ≤ 2δ(2|d| + 2δ), whose mean is ≤ 4δ(√mse + δ)
        assert abs(tm[pair] - jm[pair]) <= 4 * F32_TOL * (jm[pair] ** 0.5 + F32_TOL), pair
