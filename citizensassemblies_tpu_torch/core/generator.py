"""Synthetic instance generation.

The reference's cross-product generator (``data/generate_examples/main.py``:
respondents as the cross product of all feature combinations with
per-combination counts), and parameterized random instance families at reference scale (an
``sf_e_110``-like pool: n=1727, k=110, 7 categories; the real pool is
withheld, so benchmarks run on synthetic pools with matching shape
statistics), plus a stand-in shaped like ``example_small_20``. The same
seed gives the same instance as the JAX package's generator.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from citizensassemblies_tpu_torch.core.instance import Instance, Quota


def cross_product_instance(
    categories: Sequence[str],
    features: Sequence[Sequence[str]],
    quotas: Sequence[Sequence[Tuple[int, int]]],
    counts: Sequence[int],
    k: int,
    name: str = "synthetic",
) -> Instance:
    """Build an instance whose pool enumerates the cross product of all feature
    combinations, repeating combination ``i`` ``counts[i]`` times — the
    reference generator's respondent layout (``data/generate_examples/main.py``).
    """
    combos = list(itertools.product(*features))
    if len(counts) != len(combos):
        raise ValueError(f"need {len(combos)} counts, got {len(counts)}")
    cat_quotas: Dict[str, Dict[str, Quota]] = {}
    for ci, cat in enumerate(categories):
        cat_quotas[cat] = {feat: tuple(quotas[ci][fi]) for fi, feat in enumerate(features[ci])}
    agents: List[Dict[str, str]] = []
    for combo, count in zip(combos, counts):
        for _ in range(count):
            agents.append({cat: feat for cat, feat in zip(categories, combo)})
    return Instance(k=k, categories=cat_quotas, agents=agents, name=name)


def random_instance(
    n: int,
    k: int,
    n_categories: int,
    features_per_category: Union[int, Sequence[int]] = 3,
    seed: int = 0,
    quota_slack: float = 0.35,
    concentration: float = 2.0,
    name: str = "",
) -> Instance:
    """Generate a random feasible instance with realistic quota structure.

    Feature shares per category are drawn from a Dirichlet(``concentration``);
    each agent samples one feature per category independently. Quotas bracket
    the proportional panel composition: for pool share ``s`` the quota is
    ``[floor((1-slack)*s*k), ceil((1+slack)*s*k)]``, then adjusted so each
    category's lower quotas sum to ≤ k and upper quotas to ≥ k (the sanity
    conditions the reference asserts at ``analysis.py:174-176``). Proportional
    quotas around observed pool shares guarantee the pool itself scales down to
    a feasible panel, so the instance is feasible by construction.
    """
    rng = np.random.default_rng(seed)
    if isinstance(features_per_category, int):
        features_per_category = [features_per_category] * n_categories

    categories: Dict[str, Dict[str, Quota]] = {}
    assignments: List[np.ndarray] = []
    for ci in range(n_categories):
        m = features_per_category[ci]
        if n < m:
            raise ValueError(
                f"need n >= {m} agents so every feature of category {ci} can appear in the pool"
            )
        shares = rng.dirichlet([concentration] * m)
        # ensure every feature actually appears in the pool; repairs only
        # overwrite indices of features that occur more than once, so one
        # repair cannot erase another feature's sole occurrence
        labels = rng.choice(m, size=n, p=shares)
        for f in range(m):
            if not np.any(labels == f):
                counts = np.bincount(labels, minlength=m)
                candidates = np.nonzero(counts[labels] > 1)[0]
                labels[rng.choice(candidates)] = f
        assignments.append(labels)
        counts = np.bincount(labels, minlength=m)
        pool_shares = counts / n
        quotas: Dict[str, Quota] = {}
        for f in range(m):
            lo = int(math.floor((1 - quota_slack) * pool_shares[f] * k))
            hi = int(math.ceil((1 + quota_slack) * pool_shares[f] * k))
            hi = max(hi, lo + 1, 1)
            quotas[f"c{ci}f{f}"] = (lo, hi)
        # repair category-level sanity: sum(lo) <= k <= sum(hi)
        los = [quotas[f"c{ci}f{f}"][0] for f in range(m)]
        his = [quotas[f"c{ci}f{f}"][1] for f in range(m)]
        f = 0
        while sum(los) > k:
            if los[f % m] > 0:
                los[f % m] -= 1
            f += 1
        f = 0
        while sum(his) < k:
            his[f % m] += 1
            f += 1
        for ff in range(m):
            quotas[f"c{ci}f{ff}"] = (los[ff], his[ff])
        categories[f"cat{ci}"] = quotas

    agents = [
        {f"cat{ci}": f"c{ci}f{assignments[ci][i]}" for ci in range(n_categories)}
        for i in range(n)
    ]
    return Instance(
        k=k, categories=categories, agents=agents, name=name or f"random_{n}_{k}_{seed}"
    )


def skewed_instance(
    n: int,
    k: int,
    n_categories: int,
    features_per_category: Union[int, Sequence[int]] = 3,
    seed: int = 0,
    quota_slack: float = 0.12,
    skew: float = 1.0,
    name: str = "",
) -> Instance:
    """A heterogeneous-allocation instance: quotas target a Dirichlet
    distribution *decoupled* from the pool composition.

    ``random_instance`` brackets quotas around observed pool shares, which
    makes the leximin allocation near-uniform (everyone ≈ k/n). Real pools are
    self-selected while quotas mirror the population, so over-represented
    groups get low selection probabilities — the reference's production
    instances have LEXIMIN Gini 37–68 % (BASELINE.md). Here target shares are
    drawn independently of the pool (blended with pool shares by ``skew``;
    many fully skewed categories can be *jointly* infeasible) and repaired for
    per-category feasibility, reproducing that heterogeneity.
    """
    rng = np.random.default_rng(seed)
    base = random_instance(
        n, k, n_categories, features_per_category, seed=seed, name=name or f"skewed_{n}_{k}"
    )
    cats: Dict[str, Dict[str, Quota]] = {}
    for cat, feats in base.categories.items():
        names = list(feats)
        m = len(names)
        pool = np.array(
            [sum(1 for a in base.agents if a[cat] == f) for f in names], dtype=float
        )
        pool /= pool.sum()
        target = (1.0 - skew) * pool + skew * rng.dirichlet([1.2] * m)
        avail = {f: sum(1 for a in base.agents if a[cat] == f) for f in names}
        lo = {}
        hi = {}
        for f, s in zip(names, target):
            lo[f] = min(int(np.floor((1 - quota_slack) * s * k)), avail[f])
            hi[f] = max(min(int(np.ceil((1 + quota_slack) * s * k)), avail[f]), lo[f])
        while sum(lo.values()) > k:
            f = max(lo, key=lambda x: lo[x])
            lo[f] -= 1
        while sum(hi.values()) < k:
            f = max(names, key=lambda x: avail[x] - hi[x])
            if avail[f] == hi[f]:
                break
            hi[f] += 1
        cats[cat] = {f: (lo[f], hi[f]) for f in names}
    import dataclasses

    inst = dataclasses.replace(base, categories=cats)

    # Per-category repair does not imply joint feasibility: with many fully
    # skewed categories no single panel may satisfy every quota at once (all
    # tested n=1727/7-category draws were jointly infeasible). Real instances
    # are feasible because organizers relax quotas until a panel exists — do
    # the same with the framework's own minimal-relaxation MILP (the
    # reference's 1+2/q cost model, ``leximin.py:90-187``), which preserves
    # the heterogeneous structure while guaranteeing feasibility.
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers.cg_typespace import CompositionOracle
    from citizensassemblies_tpu_torch.solvers.highs_backend import relax_infeasible_quotas
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    # host-only repair: the dense arrays never leave the CPU here
    dense, space = featurize(inst, device="cpu")
    red = TypeReduction(dense)
    if CompositionOracle(red).maximize(np.zeros(red.T)) is None:
        suggested, _ = relax_infeasible_quotas(dense, space)
        repaired = {
            cat: {f: suggested[(cat, f)] for f in feats}
            for cat, feats in inst.categories.items()
        }
        inst = dataclasses.replace(inst, categories=repaired)
    return inst


def sf_e_skewed_instance(
    seed: int = 1,
    quota_slack: float = 0.12,
    skew: float = 0.4,
    features_per_category: Optional[Sequence[int]] = None,
) -> Instance:
    """Heterogeneous synthetic stand-in for the withheld ``sf_e_110`` pool in
    its *realistic* allocation regime.

    Shape from ``reference_output/sf_e_110_statistics.txt:2-5`` (n=1727,
    k=110, 7 categories); ``skew=0.4`` with the default seed tuned so the
    exact leximin profile lands in the band of the real instance — Gini
    ≈ 0.5 with the minimum probability around 0.4·k/n (the reference reports
    Gini 51.2 %, min 2.6 % vs k/n 6.4 %, lines 6-11) — unlike
    :func:`sf_e_like_instance`, whose pool-proportional quotas make leximin
    collapse to the uniform k/n. Other seeds vary the profile (seed 0 lands
    at Gini ≈ 0.27, a milder but still heterogeneous regime). The keyword
    knobs span the bench's flagship SEED FAMILY (VERDICT r4 #1): tighter
    ``quota_slack`` narrows every quota band, a different ``skew`` shifts
    the heterogeneity, and ``features_per_category`` varies the distinct
    type count the solvers face.
    """
    return skewed_instance(
        n=1727,
        k=110,
        n_categories=7,
        features_per_category=list(features_per_category or [2, 4, 5, 3, 2, 4, 6]),
        seed=seed,
        quota_slack=quota_slack,
        skew=skew,
        name="sf_e_skewed_110",
    )


def sf_b_skewed_instance(seed: int = 1) -> Instance:
    """Heterogeneous synthetic stand-in shaped like ``sf_b_20`` (n=250, k=20,
    6 categories, LEXIMIN Gini 47.4 % / min 4.0 % / runtime 8.8 s,
    ``reference_output/sf_b_20_statistics.txt:2-5,9,15``)."""
    return skewed_instance(
        n=250,
        k=20,
        n_categories=6,
        features_per_category=[2, 3, 3, 2, 4, 3],
        seed=seed,
        skew=0.7,
        name="sf_b_skewed_20",
    )


def sf_d_skewed_instance(seed: int = 1) -> Instance:
    """Heterogeneous synthetic stand-in shaped like ``sf_d_40`` (n=404, k=40,
    6 categories, LEXIMIN Gini 48.7 % / min 4.7 % / runtime 46.2 s,
    ``reference_output/sf_d_40_statistics.txt:2-5,9,15``)."""
    return skewed_instance(
        n=404,
        k=40,
        n_categories=6,
        features_per_category=[2, 3, 4, 2, 3, 3],
        seed=seed,
        skew=0.8,
        name="sf_d_skewed_40",
    )


def mass_like_instance(seed: int = 3) -> Instance:
    """A mass_24-shaped instance: n=70, k=24, 5 categories, with two
    categories fully pinned (min = max on every cell), the tight-quota
    regime (shape from ``reference_output/mass_24_statistics.txt:2-4``)."""
    import dataclasses

    base = random_instance(
        n=70, k=24, n_categories=5, features_per_category=[2, 3, 2, 3, 2],
        seed=seed, name="mass_like_24",
    )
    cats: Dict[str, Dict[str, Quota]] = {}
    for ci, (cat, feats) in enumerate(base.categories.items()):
        names = list(feats)
        counts = np.array(
            [sum(1 for a in base.agents if a[cat] == f) for f in names], float
        )
        if ci < 2:
            # pin to the proportional integer composition: min = max
            exact = np.floor(counts / 70.0 * 24.0).astype(int)
            order = np.argsort(-(counts / 70.0 * 24.0 - exact))
            for j in order[: 24 - exact.sum()]:
                exact[j] += 1
            cats[cat] = {f: (int(c), int(c)) for f, c in zip(names, exact)}
        else:
            cats[cat] = feats
    return dataclasses.replace(base, categories=cats)


def example_small_like_instance(seed: int = 0) -> Instance:
    """Synthetic stand-in shaped like ``example_small_20``: n=200, k=20, two
    binary categories with quotas [9, 20] (see
    ``data/example_small_20/categories.csv``)."""
    rng = np.random.default_rng(seed)
    categories = {
        "gender": {"female": (9, 20), "male": (9, 20)},
        "leaning": {"liberal": (9, 20), "conservative": (9, 20)},
    }
    agents = [
        {
            "gender": "female" if rng.random() < 0.5 else "male",
            "leaning": "liberal" if rng.random() < 0.65 else "conservative",
        }
        for _ in range(200)
    ]
    return Instance(k=20, categories=categories, agents=agents, name="example_small_like_20")
