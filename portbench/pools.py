"""Pool generators: frozen copies of the port's two instance families.

* :func:`skewed_pool` is ``core/generator.skewed_instance`` (the stand-in
  for the withheld ``sf_e_110`` pool): ``random_instance``'s Dirichlet
  pool, quotas aimed at a second Dirichlet blended in by ``skew``, and,
  where no panel meets them, the minimal relaxation MILP of the reference
  (lowering a lower quota q costs 1 + 2/q, raising an upper one costs 1)
  over agent types.
* :func:`registry_pool` is ``data/registry.nationwide_registry``: census
  marginals per category and quotas bracketing a uniformly drawn witness
  panel, so every registry is feasible.

Both consume their ``numpy`` streams draw for draw as the originals do, so
the same seed gives the same pool (``test_portbench_pools.py`` holds them
equal today). A pool is plain arrays; the port receives them through its
``interop.dense_from_arrays`` and the references read them directly.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import List, Sequence

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp


@dataclasses.dataclass
class Pool:
    """``assign[i, c]``: agent i's feature within category c; ``sizes[c]``:
    the features of category c; ``qmin``/``qmax``: per-feature quotas in
    category-then-feature order; ``k``: the panel size."""

    assign: np.ndarray  # int32 [n, C]
    sizes: List[int]
    qmin: np.ndarray  # int32 [F]
    qmax: np.ndarray  # int32 [F]
    k: int

    @property
    def n(self) -> int:
        return int(self.assign.shape[0])

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(np.int64)

    @property
    def cat_of_feature(self) -> np.ndarray:
        return np.repeat(np.arange(len(self.sizes)), self.sizes).astype(np.int32)

    def permuted(self, seed: int) -> "Pool":
        """The same pool with its agents in an order drawn from ``seed``:
        the same types, quotas and k, so the same work, under other labels."""
        order = np.random.default_rng(seed).permutation(self.n)
        return Pool(self.assign[order], list(self.sizes), self.qmin.copy(), self.qmax.copy(),
                    self.k)

    def incidence(self) -> np.ndarray:
        """bool ``[n, F]``: one feature per category for every agent."""
        A = np.zeros((self.n, int(sum(self.sizes))), dtype=bool)
        cols = self.assign.astype(np.int64) + self.offsets[None, :]
        A[np.arange(self.n)[:, None], cols] = True
        return A


def derived_seed(seed: int, index: int, salt: int = 0) -> int:
    """A 63-bit seed for the ``index``-th item of a run of ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(index), int(salt)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# --- the sf_e family ---------------------------------------------------------------


def _random_pool(rng, n: int, k: int, sizes: Sequence[int], concentration: float):
    """``random_instance``'s draws: per category Dirichlet shares, one label
    per agent, and a repair so that every feature occurs."""
    assign = np.empty((n, len(sizes)), dtype=np.int64)
    for c, m in enumerate(sizes):
        shares = rng.dirichlet([concentration] * m)
        labels = rng.choice(m, size=n, p=shares)
        for f in range(m):
            if not np.any(labels == f):
                counts = np.bincount(labels, minlength=m)
                candidates = np.nonzero(counts[labels] > 1)[0]
                labels[rng.choice(candidates)] = f
        assign[:, c] = labels
    return assign


def _type_rows(A: np.ndarray):
    """Distinct agent rows (sorted, as ``np.unique``) and their counts."""
    rows, counts = np.unique(A.astype(np.int8), axis=0, return_counts=True)
    return rows.astype(np.float64), counts.astype(np.float64)


def _feasible(A: np.ndarray, qmin, qmax, k: int) -> bool:
    """Whether some panel of k agents meets every quota (a MILP over type
    counts)."""
    tf, m = _type_rows(A)
    T = tf.shape[0]
    rows = np.vstack([np.ones((1, T)), tf.T])
    res = milp(
        c=np.zeros(T),
        constraints=LinearConstraint(rows, np.concatenate([[k], qmin]),
                                     np.concatenate([[k], qmax])),
        integrality=np.ones(T),
        bounds=Bounds(np.zeros(T), m),
    )
    return res.status == 0


def _relaxed_quotas(A: np.ndarray, qmin: np.ndarray, qmax: np.ndarray, k: int):
    """The minimal quota relaxation that admits a panel (the reference's
    relaxation ILP collapsed onto types)."""
    n, F = A.shape
    tf, m = _type_rows(A)
    T = tf.shape[0]
    qlo, qhi = qmin.astype(np.float64), qmax.astype(np.float64)
    c = np.zeros(T + 2 * F)
    c[T:T + F] = np.where(qlo == 0, 0.0, 1.0 + 2.0 / np.where(qlo == 0, 1.0, qlo))
    c[T + F:] = 1.0
    hi = np.concatenate([m, qlo, np.full(F, float(n))])
    rows = np.zeros((1 + 2 * F, T + 2 * F))
    rows[0, :T] = 1.0
    rows[1:1 + F, :T] = tf.T
    rows[1:1 + F, T:T + F] = np.eye(F)
    rows[1 + F:, :T] = tf.T
    rows[1 + F:, T + F:] = -np.eye(F)
    lbs = np.concatenate([[k], qlo, np.full(F, -np.inf)])
    ubs = np.concatenate([[k], np.full(F, np.inf), qhi])
    res = milp(c=c, constraints=LinearConstraint(rows, lbs, ubs),
               integrality=np.ones(len(c)), bounds=Bounds(np.zeros(len(c)), hi))
    if res.status != 0 or res.x is None:
        raise RuntimeError(f"no panel even with relaxed quotas (HiGHS status {res.status})")
    lower = np.rint(qlo - np.rint(res.x[T:T + F])).astype(np.int32)
    upper = np.rint(qhi + np.rint(res.x[T + F:])).astype(np.int32)
    return lower, upper


def skewed_pool(seed: int, n: int, k: int, sizes: Sequence[int], quota_slack: float,
                skew: float, concentration: float = 2.0) -> Pool:
    """``core/generator.skewed_instance(n, k, len(sizes), sizes, seed,
    quota_slack, skew)`` as a :class:`Pool`."""
    sizes = [int(s) for s in sizes]
    assign = _random_pool(np.random.default_rng(seed), n, k, sizes, concentration)
    rng = np.random.default_rng(seed)
    qmin: List[int] = []
    qmax: List[int] = []
    for c, m in enumerate(sizes):
        avail = np.bincount(assign[:, c], minlength=m)
        target = (1.0 - skew) * (avail / n) + skew * rng.dirichlet([1.2] * m)
        lo = [min(int(np.floor((1 - quota_slack) * s * k)), int(a)) for s, a in zip(target, avail)]
        hi = [max(min(int(np.ceil((1 + quota_slack) * s * k)), int(a)), lo[f])
              for f, (s, a) in enumerate(zip(target, avail))]
        while sum(lo) > k:
            lo[int(np.argmax(lo))] -= 1
        while sum(hi) < k:
            f = int(np.argmax([int(a) - h for a, h in zip(avail, hi)]))
            if avail[f] == hi[f]:
                break
            hi[f] += 1
        qmin.extend(lo)
        qmax.extend(hi)
    pool = Pool(assign.astype(np.int32), sizes, np.asarray(qmin, np.int32),
                np.asarray(qmax, np.int32), int(k))
    A = pool.incidence()
    if not _feasible(A, pool.qmin, pool.qmax, k):
        pool.qmin, pool.qmax = _relaxed_quotas(A, pool.qmin, pool.qmax, k)
    return pool


# --- the nationwide registry -------------------------------------------------------


def registry_pool(seed: int, n: int, sizes: Sequence[int], quota_slack: float,
                  k: int = 0) -> Pool:
    """``data/registry.nationwide_registry(n, seed, k, quota_slack)`` over
    categories of ``sizes`` features as a :class:`Pool` (``k = 0``: the
    registry's round(√n), clipped to [24, 400])."""
    sizes = [int(s) for s in sizes]
    rng = np.random.default_rng(seed)
    if not k:
        k = int(max(24, min(400, round(n ** 0.5))))
    assign = np.empty((n, len(sizes)), dtype=np.int32)
    for c, m in enumerate(sizes):
        probs = rng.dirichlet(np.full(m, 4.0))
        assign[:, c] = rng.choice(m, size=n, p=probs)
    # the household classes: drawn and dealt only to keep the stream aligned
    H = min(n, max(5000, n // 3)) if n >= 5000 else max(1, n // 3)
    H = max(1, min(int(H), n))
    household = rng.integers(0, H, size=n, dtype=np.int32)
    household[:H] = np.arange(H, dtype=np.int32)
    rng.shuffle(household)
    witness = np.sort(rng.choice(n, size=k, replace=False))
    slack = max(1, int(round(quota_slack * k)))
    qmin: List[np.ndarray] = []
    qmax: List[np.ndarray] = []
    for c, m in enumerate(sizes):
        counts = np.bincount(assign[witness, c], minlength=m)
        qmin.append(np.maximum(0, counts - slack))
        qmax.append(np.minimum(k, counts + slack))
    return Pool(assign, sizes, np.concatenate(qmin).astype(np.int32),
                np.concatenate(qmax).astype(np.int32), int(k))


GENERATORS = {"skewed": skewed_pool, "registry": registry_pool}


def make_pool(spec: dict, seed: int) -> Pool:
    """The pool a configuration's ``pool`` block describes, from ``seed``:
    ``{"generator": "skewed" | "registry", ...the generator's keywords}``.
    With a ``"seed"`` of its own in the block, the generator draws that one
    pool and ``seed`` only orders its agents (:meth:`Pool.permuted`)."""
    if "seed" in spec:
        return _base_pool(json.dumps(spec, sort_keys=True)).permuted(seed)
    kw = {key: value for key, value in spec.items() if key != "generator"}
    return GENERATORS[spec["generator"]](seed=int(seed), **kw)


@functools.lru_cache(maxsize=4)
def _base_pool(spec_json: str) -> Pool:
    """The one pool of a block with a fixed ``"seed"``, drawn once a process
    (callers only take :meth:`Pool.permuted` copies of it)."""
    spec = json.loads(spec_json)
    kw = {key: value for key, value in spec.items() if key not in ("generator", "seed")}
    return GENERATORS[spec["generator"]](seed=int(spec["seed"]), **kw)
