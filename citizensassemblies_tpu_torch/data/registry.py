"""Seeded synthetic nationwide-registry instances and their churn.

A standing nationwide civic-lottery registry holds n = 10⁵-10⁶ volunteers.
This module generates that instance family, numpy only, the same registry
and the same churn trail for the same arguments as the JAX package's
``data/registry.py``:

* **Vectorized.** The pool is one ``int32[n, C]`` assignment matrix drawn
  per category from a seeded Dirichlet-weighted categorical, and
  :meth:`Registry.to_dense` lowers it straight to the ``DenseInstance``
  incidence arrays by numpy scatter. ``to_instance()`` builds the
  CSV-shaped container, priced for modest n only.
* **Feasible quotas by construction.** Quotas bracket the composition of a
  *witness panel* of k agents drawn uniformly, with a ±slack band, so the
  witness satisfies every quota (:meth:`Registry.check_witness`).
* **Household classes.** Every agent carries a household id.
* **Churn.** :class:`RegistryEdit` is one atomic edit (agents join or
  drop, a quota band widens or narrows, a new feature value appears);
  :func:`apply_edit` applies one and :func:`churn_trail` generates seeded
  trails that keep every intermediate registry witness-feasible. The delta
  re-certifier (``solvers/delta.py``) consumes them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    Instance,
    dense_instance,
)
from citizensassemblies_tpu_torch.utils.device import DeviceLike

#: default civic-lottery demography: (category, features) in file order.
DEFAULT_CATEGORIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("gender", ("female", "male")),
    ("age", ("16-24", "25-34", "35-44", "45-54", "55-64", "65-74", "75+")),
    (
        "region",
        tuple(f"region_{i:02d}" for i in range(12)),
    ),
    ("education", ("none", "secondary", "vocational", "tertiary")),
    ("urbanicity", ("urban", "suburban", "rural")),
)


@dataclasses.dataclass
class Registry:
    """A generated nationwide-registry instance (host-side, all numpy).

    ``assignments[i, c]`` is agent i's feature index within category c;
    ``qmin``/``qmax`` are flat per-cell quotas in ``FeatureSpace`` order;
    ``witness`` is the k-panel the quotas were synthesized around (the
    feasibility certificate); ``household_id`` labels household classes.
    """

    name: str
    k: int
    categories: Tuple[str, ...]
    features: Tuple[Tuple[str, ...], ...]
    assignments: np.ndarray  # int32[n, C]
    qmin: np.ndarray  # int32[F]
    qmax: np.ndarray  # int32[F]
    household_id: np.ndarray  # int32[n]
    witness: np.ndarray  # int64[k], sorted agent ids
    seed: int

    @property
    def n(self) -> int:
        return int(self.assignments.shape[0])

    @property
    def n_categories(self) -> int:
        return int(self.assignments.shape[1])

    @property
    def n_households(self) -> int:
        return int(self.household_id.max()) + 1 if self.household_id.size else 0

    @property
    def cell_offsets(self) -> np.ndarray:
        """Flat-cell index of each category's first feature."""
        sizes = np.asarray([len(f) for f in self.features], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def incidence(self) -> np.ndarray:
        """bool[n, F] agent×cell incidence, built by vectorized scatter."""
        n, C = self.assignments.shape
        F = int(sum(len(f) for f in self.features))
        A = np.zeros((n, F), dtype=bool)
        offsets = self.cell_offsets
        rows = np.arange(n)
        for c in range(C):
            A[rows, offsets[c] + self.assignments[:, c]] = True
        return A

    def check_witness(self) -> bool:
        """Re-verify the feasibility certificate: the witness panel has k
        distinct members and satisfies every cell quota."""
        if len(np.unique(self.witness)) != self.k:
            return False
        counts = self.incidence()[self.witness].sum(axis=0)
        return bool(np.all((counts >= self.qmin) & (counts <= self.qmax)))

    def to_dense(self, device: DeviceLike = None) -> Tuple[DenseInstance, FeatureSpace]:
        """Lower straight to the dense representation on ``device`` (CUDA
        unless the caller passes another; no per-agent dicts, the only path
        priced for n = 10⁶)."""
        cat_of_feature = np.concatenate(
            [
                np.full(len(feats), ci, dtype=np.int32)
                for ci, feats in enumerate(self.features)
            ]
        )
        dense = dense_instance(
            self.incidence(),
            self.qmin.astype(np.int32),
            self.qmax.astype(np.int32),
            cat_of_feature,
            self.k,
            len(self.categories),
            device=device,
        )
        space = FeatureSpace(
            categories=self.categories,
            cells=tuple(
                (cat, feat)
                for cat, feats in zip(self.categories, self.features)
                for feat in feats
            ),
        )
        return dense, space

    def to_instance(self) -> Instance:
        """CSV-shaped host container (per-agent dicts — modest n only)."""
        cat_quotas = {}
        flat = 0
        for cat, feats in zip(self.categories, self.features):
            cat_quotas[cat] = {
                feat: (int(self.qmin[flat + j]), int(self.qmax[flat + j]))
                for j, feat in enumerate(feats)
            }
            flat += len(feats)
        agents = [
            {
                cat: self.features[c][self.assignments[i, c]]
                for c, cat in enumerate(self.categories)
            }
            for i in range(self.n)
        ]
        return Instance(
            k=self.k, categories=cat_quotas, agents=agents, name=self.name
        )


def nationwide_registry(
    n: int = 100_000,
    seed: int = 0,
    k: Optional[int] = None,
    categories: Optional[Sequence[Tuple[str, Sequence[str]]]] = None,
    household_classes: Optional[int] = None,
    quota_slack: float = 0.08,
    name: str = "",
) -> Registry:
    """Generate a seeded nationwide-registry instance of ``n`` volunteers.

    The same ``(n, seed, …)`` always yields the identical registry (numpy
    ``default_rng`` stream, no global state). ``quota_slack`` is the ±band
    around the witness composition, as a fraction of k (floored at ±1 seat,
    so every instance has real selection freedom without losing the
    witness-feasibility guarantee). ``household_classes`` defaults to
    ``max(5000, n // 3)`` capped at n — the nationwide tier's ≥ 5k classes
    — and scales down to ``n // 3`` on small test instances.
    """
    if n <= 0:
        raise ValueError(f"registry size n={n} must be positive")
    rng = np.random.default_rng(seed)
    cats = tuple(
        (str(c), tuple(str(f) for f in feats))
        for c, feats in (categories or DEFAULT_CATEGORIES)
    )
    cat_names = tuple(c for c, _ in cats)
    cat_feats = tuple(f for _, f in cats)

    if k is None:
        k = int(max(24, min(400, round(n ** 0.5))))
    if k > n:
        raise ValueError(f"panel size k={k} exceeds pool size n={n}")

    # per-category Dirichlet-weighted categorical marginals: skewed enough
    # to look like census marginals, never degenerate (alpha > 1)
    assignments = np.empty((n, len(cats)), dtype=np.int32)
    for c, feats in enumerate(cat_feats):
        probs = rng.dirichlet(np.full(len(feats), 4.0))
        assignments[:, c] = rng.choice(len(feats), size=n, p=probs)

    # household classes: contiguous labels over the configured class count
    H = household_classes
    if H is None:
        H = min(n, max(5000, n // 3)) if n >= 5000 else max(1, n // 3)
    H = max(1, min(int(H), n))
    household_id = rng.integers(0, H, size=n, dtype=np.int32)
    # guarantee every class is inhabited (cardinality is part of the tier
    # contract): deal the first H agents one class each, then shuffle
    household_id[:H] = np.arange(H, dtype=np.int32)
    rng.shuffle(household_id)

    # witness panel → quotas bracketing its composition (feasible by
    # construction; the witness is retained as the certificate)
    witness = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)
    slack = max(1, int(round(quota_slack * k)))
    qmin_parts, qmax_parts = [], []
    for c, feats in enumerate(cat_feats):
        counts = np.bincount(assignments[witness, c], minlength=len(feats))
        qmin_parts.append(np.maximum(0, counts - slack))
        qmax_parts.append(np.minimum(k, counts + slack))
    qmin = np.concatenate(qmin_parts).astype(np.int32)
    qmax = np.concatenate(qmax_parts).astype(np.int32)

    return Registry(
        name=name or f"registry_n{n}_s{seed}",
        k=int(k),
        categories=cat_names,
        features=cat_feats,
        assignments=assignments,
        qmin=qmin,
        qmax=qmax,
        household_id=household_id,
        witness=witness,
        seed=int(seed),
    )


# --- registry churn: the edit model ------------------------------------------
#
# A registry is never static: volunteers join and drop, quotas get amended
# mid-recruitment, and now and then a new demographic class appears.
# ``RegistryEdit`` is the atomic unit of that churn, small enough that the
# delta solver (``solvers/delta.py``) re-certifies in ~O(edit), and
# ``churn_trail`` generates seeded sequences of them that keep every
# intermediate registry witness-feasible (``check_witness``).

#: the five edit classes the delta solver distinguishes (each maps onto the
#: type space differently — see ``solvers/delta.py``).
EDIT_KINDS: Tuple[str, ...] = (
    "agents_add",  # volunteers join existing types (pool weights shift)
    "agents_drop",  # volunteers leave (never witness members)
    "quota_relax",  # a cell's band widens (new compositions become feasible)
    "quota_tighten",  # a cell's band narrows toward the witness count
    "new_type",  # a new feature value (household class) appears in a category
)


@dataclasses.dataclass(frozen=True)
class RegistryEdit:
    """One atomic registry edit (see :data:`EDIT_KINDS`).

    ``rows`` carries the appended agents' feature-index rows for
    ``agents_add``/``new_type`` (for ``new_type`` the edited category's
    index is the NEW feature slot, i.e. ``len(features[category])`` at
    application time); ``agents`` the dropped agent ids for
    ``agents_drop``; ``cell``/``dlo``/``dhi`` the flat quota cell and band
    deltas for the quota edits; ``category``/``feature`` the new feature's
    placement for ``new_type`` (its quota band is ``[0, dhi]`` — the lower
    bound MUST be 0 so the witness panel, which contains none of the new
    type, stays feasible).
    """

    kind: str
    rows: Optional[np.ndarray] = None  # int32 [e, C]
    agents: Optional[np.ndarray] = None  # int64 [e]
    cell: int = -1
    dlo: int = 0
    dhi: int = 0
    category: int = -1
    feature: str = ""

    @property
    def magnitude(self) -> int:
        """Edit size in its natural unit: agents touched, or quota seats
        moved — the quantity ``Config.delta_max_edit_frac`` gates on."""
        if self.kind in ("agents_add", "new_type"):
            return int(self.rows.shape[0]) if self.rows is not None else 0
        if self.kind == "agents_drop":
            return int(len(self.agents)) if self.agents is not None else 0
        return abs(int(self.dlo)) + abs(int(self.dhi))

    def describe(self) -> str:
        if self.kind in ("agents_add", "agents_drop"):
            return f"{self.kind}({self.magnitude} agents)"
        if self.kind == "new_type":
            return (
                f"new_type(cat {self.category} += {self.feature!r}, "
                f"{self.magnitude} agents, band [0, {self.dhi}])"
            )
        return f"{self.kind}(cell {self.cell}, dlo {self.dlo:+d}, dhi {self.dhi:+d})"


def apply_edit(reg: Registry, edit: RegistryEdit) -> Registry:
    """Apply one :class:`RegistryEdit`, returning a NEW registry (the input
    is never mutated — the delta solver diffs the two).

    Validates structural sanity (index ranges, band ordering, witness
    survival on drops) and raises ``ValueError`` on violation; quota
    FEASIBILITY preservation is the trail generator's contract, checkable
    afterwards via :meth:`Registry.check_witness`.
    """
    C = reg.n_categories
    feats = tuple(tuple(f) for f in reg.features)
    assignments = reg.assignments
    household_id = reg.household_id
    witness = reg.witness
    qmin, qmax = reg.qmin.copy(), reg.qmax.copy()

    if edit.kind in ("agents_add", "new_type"):
        rows = np.asarray(edit.rows, dtype=np.int32)
        if rows.ndim != 2 or rows.shape[1] != C or rows.shape[0] == 0:
            raise ValueError(f"{edit.kind}: rows must be int [e>0, {C}]")
        if edit.kind == "new_type":
            c = int(edit.category)
            if not (0 <= c < C):
                raise ValueError(f"new_type: category {c} out of range")
            name = edit.feature or f"{reg.categories[c]}_new"
            if name in feats[c]:
                raise ValueError(f"new_type: feature {name!r} already exists")
            if edit.dhi <= 0:
                raise ValueError("new_type: dhi must be > 0 (the new cell's band)")
            new_slot = len(feats[c])
            if not np.all(rows[:, c] == new_slot):
                raise ValueError(
                    f"new_type: rows must reference the new slot {new_slot} "
                    f"in category {c}"
                )
            feats = tuple(
                f + (name,) if ci == c else f for ci, f in enumerate(feats)
            )
            # the flat quota layout shifts: insert the new cell (band
            # [0, dhi]) at the end of category c's block
            at = int(reg.cell_offsets[c]) + new_slot
            qmin = np.insert(qmin, at, 0).astype(np.int32)
            qmax = np.insert(qmax, at, min(int(edit.dhi), reg.k)).astype(np.int32)
        sizes = np.asarray([len(f) for f in feats])
        if np.any(rows < 0) or np.any(rows >= sizes[None, :]):
            raise ValueError(f"{edit.kind}: feature index out of range")
        e = rows.shape[0]
        assignments = np.concatenate([assignments, rows], axis=0)
        # joiners arrive as fresh household classes (the conservative
        # reading: churn does not merge households)
        base = int(household_id.max()) + 1 if household_id.size else 0
        household_id = np.concatenate(
            [household_id, base + np.arange(e, dtype=np.int32)]
        )
    elif edit.kind == "agents_drop":
        drop = np.unique(np.asarray(edit.agents, dtype=np.int64))
        if drop.size == 0 or drop.min() < 0 or drop.max() >= reg.n:
            raise ValueError("agents_drop: agent ids out of range")
        if np.intersect1d(drop, witness).size:
            raise ValueError(
                "agents_drop: dropping a witness member would void the "
                "feasibility certificate"
            )
        keep = np.ones(reg.n, dtype=bool)
        keep[drop] = False
        assignments = assignments[keep]
        household_id = household_id[keep]
        # witness ids shift down past each dropped agent
        witness = witness - np.searchsorted(drop, witness)
    elif edit.kind in ("quota_relax", "quota_tighten"):
        f = int(edit.cell)
        if not (0 <= f < len(qmin)):
            raise ValueError(f"{edit.kind}: cell {f} out of range")
        lo = int(qmin[f]) + int(edit.dlo)
        hi = int(qmax[f]) + int(edit.dhi)
        lo, hi = max(0, lo), min(int(reg.k), hi)
        if lo > hi:
            raise ValueError(f"{edit.kind}: band [{lo}, {hi}] is empty")
        qmin[f], qmax[f] = lo, hi
    else:
        raise ValueError(f"unknown edit kind {edit.kind!r} (see EDIT_KINDS)")

    return Registry(
        name=reg.name,
        k=reg.k,
        categories=reg.categories,
        features=feats,
        assignments=assignments,
        qmin=qmin,
        qmax=qmax,
        household_id=household_id,
        witness=witness,
        seed=reg.seed,
    )


def churn_trail(
    reg: Registry,
    n_edits: int,
    seed: int = 0,
    max_edit_agents: int = 64,
    max_new_types: int = 3,
    weights: Optional[dict] = None,
) -> List[RegistryEdit]:
    """Seeded churn trail: ``n_edits`` edits whose SEQUENTIAL application
    keeps every intermediate registry witness-feasible.

    The generator simulates each candidate edit on a working copy before
    emitting it, so the guarantee is by construction, not by hope:

    * agent adds/joins copy feature rows of existing agents (no accidental
      new types) and never touch quotas;
    * drops avoid witness members;
    * tighten edits only move a band edge TOWARD the witness count, never
      past it; relax edits widen within ``[0, k]``;
    * ``new_type`` appends a feature with band ``[0, hi]`` (the witness has
      zero of it) and is capped at ``max_new_types`` per trail so the type
      space stays enumerable.

    Deterministic in ``(reg, n_edits, seed, …)``: the same inputs always
    yield the identical trail (``numpy.default_rng``, no global state).
    """
    rng = np.random.default_rng(seed)
    w = dict(weights or {
        "agents_add": 0.30,
        "agents_drop": 0.28,
        "quota_relax": 0.16,
        "quota_tighten": 0.16,
        "new_type": 0.10,
    })
    kinds = [kk for kk in EDIT_KINDS if w.get(kk, 0.0) > 0]
    probs = np.asarray([w[kk] for kk in kinds], dtype=np.float64)
    probs = probs / probs.sum()

    cur = reg
    new_types = 0
    trail: List[RegistryEdit] = []
    while len(trail) < n_edits:
        kind = kinds[int(rng.choice(len(kinds), p=probs))]
        edit: Optional[RegistryEdit] = None
        if kind == "new_type" and new_types >= max_new_types:
            kind = "agents_add"
        if kind == "agents_add":
            e = int(rng.integers(1, max_edit_agents + 1))
            src = rng.integers(0, cur.n, size=e)
            edit = RegistryEdit(
                kind="agents_add", rows=cur.assignments[src].copy()
            )
        elif kind == "agents_drop":
            mask = np.ones(cur.n, dtype=bool)
            mask[cur.witness] = False
            pool = np.nonzero(mask)[0]
            if pool.size == 0:
                continue
            e = int(min(rng.integers(1, max_edit_agents + 1), pool.size))
            edit = RegistryEdit(
                kind="agents_drop",
                agents=np.sort(rng.choice(pool, size=e, replace=False)).astype(
                    np.int64
                ),
            )
        elif kind in ("quota_relax", "quota_tighten"):
            f = int(rng.integers(0, len(cur.qmin)))
            wc = int(cur.incidence()[cur.witness].sum(axis=0)[f])
            lo, hi = int(cur.qmin[f]), int(cur.qmax[f])
            if kind == "quota_tighten":
                dlo = 1 if lo < wc else 0
                dhi = -1 if hi > wc else 0
                if dlo == 0 and dhi == 0:
                    kind = "quota_relax"
                else:
                    edit = RegistryEdit(
                        kind="quota_tighten", cell=f, dlo=dlo, dhi=dhi
                    )
            if kind == "quota_relax":
                # exactly ONE arm per edit: a relax that widened both bounds
                # at once is a 2-unit step — outside the single-unit edit
                # grammar every consumer (delta re-certifier sensitivity,
                # trail replays) is sized for. Both arms open → rng picks.
                arms = []
                if lo > 0:
                    arms.append((-1, 0))
                if hi < cur.k:
                    arms.append((0, 1))
                if not arms:
                    continue
                dlo, dhi = arms[int(rng.integers(0, len(arms)))]
                edit = RegistryEdit(kind="quota_relax", cell=f, dlo=dlo, dhi=dhi)
        elif kind == "new_type":
            c = int(rng.integers(0, cur.n_categories))
            e = int(rng.integers(1, 9))
            new_slot = len(cur.features[c])
            src = rng.integers(0, cur.n, size=e)
            rows = cur.assignments[src].copy()
            rows[:, c] = new_slot
            edit = RegistryEdit(
                kind="new_type",
                rows=rows,
                category=c,
                feature=f"{cur.categories[c]}_new{new_types}",
                dhi=int(rng.integers(1, 4)),
            )
        if edit is None:
            continue
        nxt = apply_edit(cur, edit)
        if not nxt.check_witness():  # defensive: the generator keeps it by construction
            raise AssertionError(
                f"churn_trail generated an infeasible edit: {edit.describe()}"
            )
        if edit.kind == "new_type":
            new_types += 1
        trail.append(edit)
        cur = nxt
    return trail
