"""Household quotient: type-space LEXIMIN under household constraints.

The reference keeps household ("same address") runs in agent space, adding
≤1-per-household rows to its ILPs (``leximin.py:211-221``). Households keep
a *quotient* symmetry that the agent-space view hides:

* agents are grouped by feature row into base types, as in the
  unconstrained reduction;
* households are grouped by the **multiset of their members' base types**
  into household *classes*; class ``c`` has ``m_c`` households of one shape;
* two agents are interchangeable iff they have the same base type and
  their households are of the same class: the orbits are (class, base type)
  pairs.

The leximin allocation is the unique optimum of a symmetric problem, hence
constant on orbits, and a per-orbit count vector ``x`` is realizable by a
household-disjoint panel iff it meets the feature quotas, ``Σx = k`` and the
per-class cap ``Σ_{t ∈ c} x_{c,t} ≤ m_c`` (pick ``Σ_t x_{c,t}`` distinct
class-``c`` households and give ``x_{c,t}`` of them type-``t`` duty: every
class-``c`` household has a member of every type in the class multiset).

The class caps are plain one-sided quota rows, so the whole type-space
pipeline runs unchanged on an **augmented instance** whose incidence gains
one "household class" category (one-hot class membership, quotas
``[0, m_c]``). Its distinct rows are the orbits. Only the realization of
panels needs the households: within one panel, picks across a class's
orbits must land in distinct households
(``compositions.greedy_decompose`` / ``decompose_with_pricing``).

This is host numpy code, as in the JAX package
(``citizensassemblies_tpu/solvers/quotient.py``); the augmented instance
lives on the device of the instance it augments. Class order and the
compaction of household ids follow the JAX package's, so the orbits, and
every tie order that follows from them, are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance, dense_instance


@dataclasses.dataclass
class HouseholdQuotient:
    """The augmented instance plus the household bookkeeping realization needs."""

    dense_aug: DenseInstance
    households: np.ndarray  # int32[n] compacted household id per agent
    class_of_household: np.ndarray  # int32[H] class id per household
    class_size: np.ndarray  # int32[C] households per class (m_c)
    class_feature_base: int  # first augmented column index (= original F)
    n_classes: int


def build_household_quotient(
    dense: DenseInstance, households: np.ndarray
) -> HouseholdQuotient:
    """The augmented instance of the household quotient, on ``dense.device``.

    ``households`` is any int array of group labels (as
    ``core.instance.compute_households`` returns); it is compacted to
    0..H-1.
    """
    A = dense.A_np
    n, F = A.shape
    hh = np.asarray(households)
    if hh.shape != (n,):
        raise ValueError(f"households must label every agent: shape {hh.shape}, need ({n},)")
    _, hh = np.unique(hh, return_inverse=True)
    hh = hh.reshape(n)
    H = int(hh.max()) + 1 if n else 0

    # base types by feature row (the unconstrained reduction's grouping)
    _, base_type = np.unique(A, axis=0, return_inverse=True)
    base_type = base_type.reshape(n)

    # class signature per household: the sorted multiset of its members'
    # base types. Size-1 households of one base type share a class, so
    # single agents keep collapsing onto types.
    members_of_hh: Dict[int, list] = {h: [] for h in range(H)}
    for i in range(n):
        members_of_hh[int(hh[i])].append(int(base_type[i]))
    sig_to_class: Dict[Tuple[int, ...], int] = {}
    class_of_household = np.zeros(H, dtype=np.int32)
    for h in range(H):
        sig = tuple(sorted(members_of_hh[h]))
        if sig not in sig_to_class:
            sig_to_class[sig] = len(sig_to_class)
        class_of_household[h] = sig_to_class[sig]
    C = len(sig_to_class)
    class_size = np.bincount(class_of_household, minlength=C).astype(np.int32)

    A_aug = np.zeros((n, F + C), dtype=bool)
    A_aug[:, :F] = A
    A_aug[np.arange(n), F + class_of_household[hh]] = True
    qmin_aug = np.concatenate([dense.qmin_np, np.zeros(C, dtype=np.int32)])
    qmax_aug = np.concatenate([dense.qmax_np, class_size])
    cat_aug = np.concatenate([
        np.asarray(dense.cat_of_feature_np, dtype=np.int32),
        np.full(C, dense.n_categories, dtype=np.int32),
    ])
    dense_aug = dense_instance(
        A_aug, qmin_aug, qmax_aug, cat_aug, dense.k, dense.n_categories + 1,
        device=dense.device,
    )
    return HouseholdQuotient(
        dense_aug=dense_aug,
        households=hh.astype(np.int32),
        class_of_household=class_of_household,
        class_size=class_size,
        class_feature_base=F,
        n_classes=C,
    )
