"""Host exact-solver backend on scipy's HiGHS (LPs via ``linprog``, ILPs via
``milp``).

* the feasibility gate and the quota-relaxation ILP (``leximin.py:90-187``,
  ``:223-228`` of the reference), both on the type-space collapse of the
  committee polytope;
* the agent-space committee oracle (:class:`HighsCommitteeOracle`): the
  column-generation pricing and certification ILP, on the native
  type-reduced branch-and-bound with the HiGHS MILP behind it;
* the dual leximin LP (``leximin.py:300-328``) and the final primal LP
  (``leximin.py:453-464``), the latter also with its duals.

Household constraints arrive with the households slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse
from scipy.optimize import Bounds, LinearConstraint, linprog, milp

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    InfeasibleQuotasError,
    SelectionError,
)


class HighsCommitteeOracle:
    """Exact committee oracle: maximize a linear agent-weight objective over
    feasible committees (``x ∈ {0,1}^n``, ``Aᵀx ∈ [qmin, qmax]``,
    ``1ᵀx = k``). Served by the native type-reduced branch-and-bound when
    it can, by the HiGHS MILP otherwise; ``log`` counts which backend served
    each call."""

    def __init__(self, dense: DenseInstance, log=None):
        self.log = log
        self.A = dense.A_np.astype(np.float64)
        self.n, self.F = self.A.shape
        self.k = dense.k
        self._mat = np.vstack([np.ones((1, self.n)), self.A.T])
        self._lb = np.concatenate([[float(self.k)], dense.qmin_np.astype(np.float64)])
        self._ub = np.concatenate([[float(self.k)], dense.qmax_np.astype(np.float64)])
        self._reduction = None  # TypeReduction, built at first use
        self._dense = dense

    def _types(self):
        from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

        if self._reduction is None:
            self._reduction = TypeReduction(self._dense)
        return self._reduction

    def _native_maximize(self, weights: np.ndarray, incumbent: float = -1e300,
                         max_nodes: int = 500_000):
        """The native exact oracle; None means 'use the MILP path' (library
        missing, or the node budget ran out)."""
        from citizensassemblies_tpu_torch.solvers import native_oracle

        if not native_oracle.native_available():
            return None
        return native_oracle.price_exact(
            self._types(), weights, incumbent=incumbent, max_nodes=max_nodes
        )

    def certify(self, weights: np.ndarray, floor: float):
        """Decide whether a feasible committee has value > ``floor``: returns
        one as ``(committee, value)``, else ``(None, floor)``. Seeded with
        ``floor`` as the incumbent, the branch-and-bound usually certifies
        from its root bound alone."""
        res = self._native_maximize(weights, incumbent=float(floor))
        if res is not None:
            if self.log is not None:
                self.log.count("oracle_backend_native")
            committee, value = res
            return (None, float(floor)) if committee is None else (committee, value)
        committee, value = self._milp_maximize(weights)
        return (None, float(floor)) if value <= floor else (committee, value)

    def maximize(
        self, weights: np.ndarray, forced: Sequence[int] = ()
    ) -> Tuple[Tuple[int, ...], float]:
        """``(committee, value)`` maximizing ``weights @ x``, with the
        ``forced`` agents constrained into the committee (forced inclusion
        breaks type interchangeability, so it takes the MILP). Raises
        :class:`SelectionError` when no feasible committee exists."""
        if not forced:
            res = self._native_maximize(weights)
            if res is not None:
                if self.log is not None:
                    self.log.count("oracle_backend_native")
                return res
        return self._milp_maximize(weights, forced)

    def _milp_maximize(
        self, weights: np.ndarray, forced: Sequence[int] = ()
    ) -> Tuple[Tuple[int, ...], float]:
        if self.log is not None:
            self.log.count("oracle_backend_highs")
        lo = np.zeros(self.n)
        lo[list(forced)] = 1.0
        res = milp(
            c=-np.asarray(weights, dtype=np.float64),
            constraints=LinearConstraint(self._mat, self._lb, self._ub),
            integrality=np.ones(self.n),
            bounds=Bounds(lo, np.ones(self.n)),
        )
        if res.status != 0 or res.x is None:
            raise SelectionError(
                f"committee pricing ILP not solved to optimality (HiGHS status "
                f"{res.status}: {res.message})"
            )
        x = res.x > 0.5
        committee = tuple(int(i) for i in np.nonzero(x)[0])
        return committee, float(np.asarray(weights) @ x)

    def check_feasible(self) -> bool:
        """Whether any committee meets the quotas: without households the
        committee polytope depends only on type counts, so this is one
        type-space MILP."""
        from citizensassemblies_tpu_torch.solvers.cg_typespace import CompositionOracle

        red = self._types()
        return CompositionOracle(red).maximize(np.zeros(red.T)) is not None


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


def check_feasible_or_suggest(
    dense: DenseInstance, space: FeatureSpace, oracle: Optional[HighsCommitteeOracle] = None
) -> None:
    """Feasibility gate (``leximin.py:223-228``): on infeasible quotas raise
    :class:`InfeasibleQuotasError` carrying the suggested relaxation."""
    oracle = oracle or HighsCommitteeOracle(dense)
    if not oracle.check_feasible():
        new_quotas, lines = relax_infeasible_quotas(dense, space)
        raise InfeasibleQuotasError(new_quotas, lines)


@dataclasses.dataclass
class DualSolution:
    ok: bool
    y: np.ndarray  # float64[n] agent duals
    yhat: float  # ŷ, the committee cap
    objective: float  # ŷ − Σ fixed_i y_i


def solve_dual_lp(P: np.ndarray, fixed: np.ndarray) -> DualSolution:
    """The dual leximin LP over the portfolio ``P`` (bool/0-1 ``[C, n]``):

        minimize    ŷ − Σ_{i fixed} fixed_i · y_i
        subject to  Σ_{i ∈ C} y_i ≤ ŷ   for each committee row C of P
                    Σ_{i unfixed} y_i = 1,   y ≥ 0, ŷ ≥ 0

    (``fixed[i] < 0`` marks agent i unfixed). Any non-optimal HiGHS status
    returns ``ok=False``; the caller shaves the fixed probabilities and
    retries (``leximin.py:405-417``).
    """
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    fixed = np.asarray(fixed, dtype=np.float64)
    unfixed = fixed < 0
    c = np.concatenate([-np.where(unfixed, 0.0, fixed), [1.0]])
    res = linprog(
        c,
        A_ub=np.hstack([P, -np.ones((C, 1))]),
        b_ub=np.zeros(C),
        A_eq=np.concatenate([unfixed.astype(np.float64), [0.0]])[None, :],
        b_eq=np.array([1.0]),
        bounds=(0, None),
        method="highs",
    )
    if res.status != 0 or res.x is None:
        return DualSolution(ok=False, y=np.zeros(n), yhat=0.0, objective=0.0)
    return DualSolution(ok=True, y=res.x[:n], yhat=float(res.x[n]), objective=float(res.fun))


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


def solve_final_primal_lp(P: np.ndarray, target: np.ndarray) -> Tuple[np.ndarray, float]:
    """Committee probabilities realizing the fixed per-agent targets:

        minimize ε  s.t.  Σ_C p_C = 1,  (Pᵀp)_i ≥ target_i − ε,  p, ε ≥ 0

    (``leximin.py:453-464``). Returns ``(p, ε)``.
    """
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    c = np.zeros(C + 1)
    c[-1] = 1.0
    A_ub = scipy.sparse.hstack(
        [scipy.sparse.csr_matrix(-P.T), scipy.sparse.csr_matrix(-np.ones((n, 1)))]
    ).tocsr()
    b_ub = -np.asarray(target, dtype=np.float64)
    A_eq = scipy.sparse.csr_matrix(np.concatenate([np.ones(C), [0.0]])[None, :])
    b_eq = np.array([1.0])
    res = None
    for method in ("highs-ipm", "highs"):
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=(0, None), method=method)
        if res.status == 0 and res.x is not None:
            return res.x[:C], float(max(res.x[C], 0.0))
    raise SelectionError(f"final primal LP failed (HiGHS status {res.status}: {res.message})")
