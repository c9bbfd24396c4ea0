"""LEGACY: the port's batched sampler and estimator against the JAX package.

Both packages take a greedy step from the same state and the same Gumbel
noise, so fed identical numpy noise they must draw identical panels, bit
for bit. Their random streams differ (a ``torch.Generator`` against JAX
keys), so the estimators are compared in distribution: per-agent selection
frequencies within 5 binomial standard deviations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models import legacy as jleg
from citizensassemblies_tpu.ops.pairs import pair_matrix_from_panels as j_pairs
from citizensassemblies_tpu.solvers.pricing import _pricing_scores as j_scores

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import SelectionError
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models import legacy as tleg
from citizensassemblies_tpu_torch.ops import pairs as tpairs
from citizensassemblies_tpu_torch.solvers import pricing as tpricing
from citizensassemblies_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

INSTANCES = {
    "example_small_like": lambda g: g.example_small_like_instance(),
    "mass_like": lambda g: g.mass_like_instance(),
}
B = 96


def _jax_draw(jd, noise, scores):
    """The JAX package's scan body, step by step, on the given noise."""
    n = jd.n
    A_f32 = jd.A.astype(jnp.float32)
    alive = jnp.ones((B, n), dtype=bool)
    selected = jnp.zeros((B, jd.n_features), dtype=jnp.int32)
    failed = jnp.zeros(B, dtype=bool)
    households = jnp.arange(n, dtype=jnp.int32)
    persons = []
    for step in range(jd.k):
        out_of_people = ~jnp.any(alive, axis=1)
        (alive, selected, failed2), person = jleg._sample_step(
            A_f32, A_f32.T, jd.qmin, jd.qmax, n, (alive, selected, failed),
            jnp.asarray(noise[step]), scores, households,
        )
        failed = failed2 | failed | out_of_people
        persons.append(np.asarray(person))
    failed = failed | jnp.any(selected < jd.qmin[None, :], axis=1)
    return np.stack(persons, axis=1), ~np.asarray(failed)


@pytest.mark.parametrize("steer", ["uniform", "steered"])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_sample_step_parity_on_identical_noise(name, steer):
    jd, _ = j_featurize(INSTANCES[name](jgen))
    td, _ = t_featurize(INSTANCES[name](tgen), device="cpu")
    rng = np.random.default_rng(4)
    noise = rng.gumbel(size=(td.k, B, td.n)).astype(np.float32)
    if steer == "uniform":
        j_s, t_s = jnp.zeros((1, td.n), jnp.float32), None
    else:
        w = rng.random(td.n).astype(np.float32)
        j_s = j_scores(jnp.asarray(w), B)
        t_s = tpricing._pricing_scores(torch.as_tensor(w), B)
        np.testing.assert_array_equal(np.asarray(j_s), t_s.numpy())
    want_panels, want_ok = _jax_draw(jd, noise, j_s)
    got_panels, got_ok = tleg._sample_panels_kernel(
        td, B, lambda step: torch.as_tensor(noise[step]), scores=t_s
    )
    np.testing.assert_array_equal(got_panels.numpy(), want_panels)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert got_ok.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accepted_panels_meet_every_quota(seed):
    td, _ = t_featurize(tgen.random_instance(n=80, k=12, n_categories=3, seed=seed), device="cpu")
    panels, draws = tleg.sample_feasible_panels(td, 300, seed=seed)
    assert panels.shape == (300, td.k) and draws >= 300
    for row in panels:
        assert len(set(row.tolist())) == td.k
        counts = td.A_np[row].sum(axis=0)
        assert np.all(counts >= td.qmin_np) and np.all(counts <= td.qmax_np)


def test_households_keep_panels_one_per_household():
    """Selecting an agent evicts the rest of its household: every accepted
    panel holds at most one member of each (here two-agent) household."""
    td, _ = t_featurize(tgen.random_instance(n=80, k=10, n_categories=3, seed=5), device="cpu")
    households = np.arange(td.n) // 2
    panels, _ = tleg.sample_feasible_panels(td, 200, seed=1, households=households)
    for row in panels:
        assert len(set(households[row].tolist())) == td.k
        counts = td.A_np[row].sum(axis=0)
        assert np.all(counts >= td.qmin_np) and np.all(counts <= td.qmax_np)


def test_deterministic_under_one_seed():
    td, _ = t_featurize(tgen.example_small_like_instance(), device="cpu")
    a, _ = tleg.sample_feasible_panels(td, 200, seed=3)
    b, _ = tleg.sample_feasible_panels(td, 200, seed=3)
    c, _ = tleg.sample_feasible_panels(td, 200, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_infeasible_quotas_raise():
    inst = tgen.random_instance(n=40, k=6, n_categories=2, seed=1)
    cat = next(iter(inst.categories))
    # every cell of one category demands 6 of a 6-member panel
    cats = dict(inst.categories)
    cats[cat] = {f: (6, 6) for f in cats[cat]}
    td, _ = t_featurize(dataclasses.replace(inst, categories=cats), device="cpu")
    cfg = default_config().replace(mc_batch=64, mc_max_resample_rounds=2)
    with pytest.raises(SelectionError, match="no feasible panel"):
        tleg.sample_feasible_panels(td, 10, cfg=cfg)
    # distributed over a one-rank world the infeasible draw fails alike, and
    # draws what the undistributed sampler draws
    from citizensassemblies_tpu_torch.dist import runtime

    try:
        want = tleg.sample_panels_batch(td, torch.Generator().manual_seed(1), 8, distribute=False)
        got = tleg.sample_panels_batch(td, torch.Generator().manual_seed(1), 8, distribute=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not got[1].any()
        with pytest.raises(SelectionError, match="no feasible panel"):
            tleg.sample_feasible_panels(td, 10, cfg=cfg, distribute=True)
    finally:
        runtime.shutdown()


def test_estimators_agree_in_distribution():
    """4000 draws in each package: every agent's selection frequency within
    5 standard deviations of the difference of two binomial estimates."""
    N = 4000
    inst_j, inst_t = jgen.example_small_like_instance(), tgen.example_small_like_instance()
    jd, _ = j_featurize(inst_j)
    td, _ = t_featurize(inst_t, device="cpu")
    want = jleg.legacy_probabilities(jd, iterations=N, seed=0, distribute=False)
    got = tleg.legacy_probabilities(td, iterations=N, seed=0, device="cpu")
    k = td.k
    assert got.allocation.sum() == pytest.approx(k, abs=1e-9)
    p = np.clip((want.allocation + got.allocation) / 2, 1.0 / N, 1 - 1.0 / N)
    sigma = np.sqrt(2 * p * (1 - p) / N)
    assert np.all(np.abs(got.allocation - want.allocation) <= 5 * sigma)
    # the pair matrix: symmetric, zero diagonal, rows sum to (k − 1)·allocation
    M = got.pair_matrix.astype(np.float64)
    np.testing.assert_array_equal(M, M.T)
    assert np.all(np.diag(M) == 0)
    np.testing.assert_allclose(M.sum(axis=1), (k - 1) * got.allocation, atol=1e-4)
    assert len(got.unique_panels) <= N and got.panels.shape == (N, k)


def test_pair_matrix_matches_reference():
    rng = np.random.default_rng(2)
    n, k = 50, 7
    panels = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(300)]).astype(np.int32)
    w = rng.random(300).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(j_pairs(panels, weights, n=n, chunk=128))
        got = tpairs.pair_matrix_from_panels(panels, weights, n=n, chunk=128, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    P = np.zeros((300, n), bool)
    for r, row in enumerate(panels):
        P[r, row] = True
    got = tpairs.pair_matrix_from_portfolio(P, w / w.sum(), device="cpu").numpy()
    vals = tpairs.sorted_pair_values(got)
    assert vals.shape == (n * (n - 1) // 2,) and np.all(np.diff(vals) >= 0)
    assert tpairs.uniform_pair_value(n) == pytest.approx(1 / 1225)
