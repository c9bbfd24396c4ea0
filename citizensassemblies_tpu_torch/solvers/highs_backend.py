"""Host exact-solver backend on scipy's HiGHS (LPs via ``linprog``, ILPs via
``milp``): the parts the type-space LEXIMIN path calls.

* the feasibility gate and the quota-relaxation ILP (``leximin.py:90-187``,
  ``:223-228`` of the reference), both on the type-space collapse of the
  committee polytope;
* the final primal LP with its duals (``leximin.py:453-464``), which
  realizes the panel distribution.

The agent-space committee oracle and household constraints arrive with the
agent-space and households slices.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse
from scipy.optimize import Bounds, LinearConstraint, linprog, milp

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    InfeasibleQuotasError,
    SelectionError,
)


def relax_infeasible_quotas(
    dense: DenseInstance, space: FeatureSpace
) -> Tuple[Dict[Tuple[str, str], Tuple[int, int]], List[str]]:
    """Suggest a minimal quota relaxation making the instance feasible.

    Mirrors the reference's relaxation ILP (``leximin.py:90-187``): integer
    relaxation variables per feature bound; lowering a small lower quota of
    old value q costs ``1 + 2/q`` while raising an upper quota costs 1
    (``leximin.py:152-163``). Without households or inclusion sets the
    committee block collapses onto agent types (quota rows depend only on
    type counts), so the MILP has T bounded integers rather than n binaries.

    Returns (suggested quotas {(category, feature): (lo, hi)}, advice lines).
    Raises :class:`SelectionError` if even fully relaxed quotas admit no panel.
    """
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    n, F = dense.A_np.shape
    k = dense.k
    qmin = dense.qmin_np.astype(np.float64)
    qmax = dense.qmax_np.astype(np.float64)
    red = TypeReduction(dense)
    T = red.T
    tf = np.zeros((T, F))
    for t in range(T):
        tf[t, red.type_feature[t]] = 1.0
    nvars = T + 2 * F
    c = np.zeros(nvars)
    for f in range(F):
        old = qmin[f]
        c[T + f] = 0.0 if old == 0 else 1.0 + 2.0 / old
        c[T + F + f] = 1.0
    lo = np.zeros(nvars)
    hi = np.concatenate([red.msize.astype(np.float64), qmin, np.full(F, float(n))])
    rows = np.zeros((1 + 2 * F, nvars))
    lbs = np.zeros(1 + 2 * F)
    ubs = np.zeros(1 + 2 * F)
    rows[0, :T] = 1.0
    lbs[0] = ubs[0] = float(k)
    rows[1 : 1 + F, :T] = tf.T
    rows[1 : 1 + F, T : T + F] = np.eye(F)  # + min_relax_f ≥ qmin_f
    lbs[1 : 1 + F] = qmin
    ubs[1 : 1 + F] = np.inf
    rows[1 + F :, :T] = tf.T
    rows[1 + F :, T + F :] = -np.eye(F)  # − max_relax_f ≤ qmax_f
    lbs[1 + F :] = -np.inf
    ubs[1 + F :] = qmax
    res = milp(
        c=c,
        constraints=LinearConstraint(rows, lbs, ubs),
        integrality=np.ones(nvars),
        bounds=Bounds(lo, hi),
    )
    if res.status != 0 or res.x is None:
        raise SelectionError(
            f"No feasible committees found even with relaxed quotas (HiGHS "
            f"status {res.status}). Either the pool is very bad or something "
            f"is wrong with the solver."
        )
    lines: List[str] = []
    new_quotas: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for f, (cat, feat) in enumerate(space.cells):
        lower = int(round(qmin[f] - round(res.x[T + f])))
        upper = int(round(qmax[f] + round(res.x[T + F + f])))
        if lower < qmin[f]:
            lines.append(f"Recommend lowering lower quota of {cat}:{feat} to {lower}.")
        if upper > qmax[f]:
            lines.append(f"Recommend raising upper quota of {cat}:{feat} to {upper}.")
        new_quotas[(cat, feat)] = (lower, upper)
    return new_quotas, lines


def check_feasible_or_suggest(dense: DenseInstance, space: FeatureSpace) -> None:
    """Feasibility gate (``leximin.py:223-228``): on infeasible quotas raise
    :class:`InfeasibleQuotasError` carrying the suggested relaxation.

    Without household constraints the committee polytope depends only on
    type counts, so the check is one type-space MILP."""
    from citizensassemblies_tpu_torch.solvers.cg_typespace import CompositionOracle
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(dense)
    if CompositionOracle(red).maximize(np.zeros(red.T)) is None:
        new_quotas, lines = relax_infeasible_quotas(dense, space)
        raise InfeasibleQuotasError(new_quotas, lines)


def solve_final_primal_lp_duals(
    P: np.ndarray, target: np.ndarray, two_sided: bool = True
) -> Tuple[np.ndarray, float, np.ndarray, float]:
    """Final primal LP ``min ε`` over panel mixtures ``p`` and its dual
    solution (``leximin.py:453-464``): ``(p, ε, y, μ)`` where ``y`` are the agent-coverage duals and ``μ`` the
    normalization dual — the quantities column-generation pricing needs
    (reduced cost of a candidate panel column is ``−y·panel − μ``).

    ``two_sided`` bounds the deviation on both sides
    (``target − ε ≤ Pᵀp ≤ target + ε``): since panels conserve total mass
    (``Σ alloc = k = Σ target``), a one-sided formulation lets a per-agent
    deficit of ε fund an n·ε overshoot concentrated on one agent; the
    two-sided ε bounds the allocation L∞ error directly. ``y`` is then the
    mixed-sign ``y_lower − y_upper``.
    """
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    target = np.asarray(target, dtype=np.float64)
    c = np.zeros(C + 1)
    c[-1] = 1.0
    lower = np.hstack([-P.T, -np.ones((n, 1))])
    if two_sided:
        A_ub = np.vstack([lower, np.hstack([P.T, -np.ones((n, 1))])])
        b_ub = np.concatenate([-target, target])
    else:
        A_ub = lower
        b_ub = -target
    A_eq = np.concatenate([np.ones(C), [0.0]])[None, :]
    b_eq = np.array([1.0])
    res = linprog(
        c, A_ub=scipy.sparse.csr_matrix(A_ub), b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
        bounds=(0, None), method="highs-ipm",
    )
    if res.status != 0 or res.x is None:
        res = linprog(
            c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=(0, None),
            method="highs",
        )
    if res.status != 0 or res.x is None:
        raise SelectionError(f"final primal LP failed (HiGHS status {res.status}: {res.message})")
    lam = -np.asarray(res.ineqlin.marginals)
    y = lam[:n] - lam[n:] if two_sided else lam
    mu = float(res.eqlin.marginals[0])
    return res.x[:C], float(res.x[C]), y, mu
