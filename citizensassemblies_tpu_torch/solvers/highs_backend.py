"""Host exact-solver backend on scipy's HiGHS (LPs via ``linprog``, ILPs via
``milp``).

* the feasibility gate and the quota-relaxation ILP (``leximin.py:90-187``,
  ``:223-228`` of the reference), on the type-space collapse of the
  committee polytope, or in agent space with household rows;
* the agent-space committee oracle (:class:`HighsCommitteeOracle`): the
  column-generation pricing and certification ILP, on the native
  type-reduced branch-and-bound with the HiGHS MILP behind it; with
  households (≤1 member per household, ``leximin.py:211-221``) always the
  MILP;
* the dual leximin LP (``leximin.py:300-328``) and the final primal LP
  (``leximin.py:453-464``), the latter also with its duals;
* :func:`audit_maximin`, the solver-independent certificate of an
  allocation's least probability, and :func:`audit_leximin_profile` (with
  its level-2 view :func:`audit_second_level`), the same certificate level
  by level for a whole leximin profile.
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


def _household_groups(households: np.ndarray) -> List[np.ndarray]:
    """Member indices of every household of two or more agents, in order of
    household label."""
    groups = []
    for h in np.unique(households):
        members = np.nonzero(households == h)[0]
        if len(members) >= 2:
            groups.append(members)
    return groups


def _constraint_rows(
    A: np.ndarray, k: int, qmin: np.ndarray, qmax: np.ndarray,
    households: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The committee constraint system ``(rows, lb, ub)`` over ``x ∈ {0,1}^n``:
    the size row, one row per feature cell, and a ≤1 row per household of
    two or more (``leximin.py:201-221``)."""
    n = A.shape[0]
    mats = [np.ones((1, n)), A.T.astype(np.float64)]
    lbs = [np.array([float(k)]), qmin.astype(np.float64)]
    ubs = [np.array([float(k)]), qmax.astype(np.float64)]
    if households is not None:
        for members in _household_groups(np.asarray(households)):
            row = np.zeros((1, n))
            row[0, members] = 1.0
            mats.append(row)
            lbs.append(np.array([0.0]))
            ubs.append(np.array([1.0]))
    return np.vstack(mats), np.concatenate(lbs), np.concatenate(ubs)


class HighsCommitteeOracle:
    """Exact committee oracle: maximize a linear agent-weight objective over
    feasible committees (``x ∈ {0,1}^n``, ``Aᵀx ∈ [qmin, qmax]``,
    ``1ᵀx = k``, and with ``households`` at most one member per household).
    Served by the native type-reduced branch-and-bound when it can, by the
    HiGHS MILP otherwise (household rows break type interchangeability, so
    they always take the MILP); ``log`` counts which backend served each
    call."""

    def __init__(self, dense: DenseInstance, households: Optional[np.ndarray] = None, log=None):
        self.log = log
        self.A = dense.A_np.astype(np.float64)
        self.n, self.F = self.A.shape
        self.k = dense.k
        self.households = households
        self._mat, self._lb, self._ub = _constraint_rows(
            self.A, self.k, dense.qmin_np, dense.qmax_np, households
        )
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
        if self.households is None:
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
        and households break type interchangeability, so they take the
        MILP). Raises :class:`SelectionError` when no feasible committee
        exists."""
        if self.households is None and not forced:
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
        committee, value, _bound = self._milp_maximize_with_bound(weights, forced)
        return committee, value

    def _milp_maximize_with_bound(
        self, weights: np.ndarray, forced: Sequence[int] = ()
    ) -> Tuple[Tuple[int, ...], float, float]:
        """Like :meth:`_milp_maximize`, and also HiGHS's proven dual bound on
        the maximum: the incumbent can sit up to the default MIP gap (rel
        1e-4) below the optimum, so a certificate uses the bound."""
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
        value = float(np.asarray(weights) @ x)
        dual = getattr(res, "mip_dual_bound", None)
        # the minimization's dual bound lower-bounds min(−w·x), so its
        # negation upper-bounds max(w·x); the incumbent where none is given
        bound = float(-dual) if dual is not None else value
        return committee, value, max(bound, value)

    def check_feasible(self) -> bool:
        """Whether any committee meets the quotas (and the household rows).
        Without households the committee polytope depends only on type
        counts, so this is one type-space MILP; with them, the agent-space
        MILP."""
        if self.households is None:
            from citizensassemblies_tpu_torch.solvers.cg_typespace import CompositionOracle

            red = self._types()
            return CompositionOracle(red).maximize(np.zeros(red.T)) is not None
        try:
            self.maximize(np.zeros(self.n))
            return True
        except SelectionError:
            return False


def relax_infeasible_quotas(
    dense: DenseInstance,
    space: FeatureSpace,
    households: Optional[np.ndarray] = None,
    ensure_inclusion: Sequence[Sequence[int]] = ((),),
) -> Tuple[Dict[Tuple[str, str], Tuple[int, int]], List[str]]:
    """Suggest a minimal quota relaxation making the instance feasible.

    Mirrors the reference's relaxation ILP (``leximin.py:90-187``): integer
    relaxation variables per feature bound; lowering a small lower quota of
    old value q costs ``1 + 2/q`` while raising an upper quota costs 1
    (``leximin.py:152-163``); ``ensure_inclusion`` demands that, for each
    given agent set, some feasible panel contains it (one committee block
    per set, all sharing the relaxation variables). Without households or
    inclusion sets the committee block collapses onto agent types (quota
    rows depend only on type counts), so the MILP has T bounded integers
    rather than n binaries; with them it is the agent-space MILP, with a
    ≤1 row per household in every block.

    Returns (suggested quotas {(category, feature): (lo, hi)}, advice lines).
    Raises :class:`SelectionError` if even fully relaxed quotas admit no panel.
    """
    n, F = dense.A_np.shape
    k = dense.k
    qmin = dense.qmin_np.astype(np.float64)
    qmax = dense.qmax_np.astype(np.float64)
    S = len(ensure_inclusion)
    if S == 0:
        raise ValueError("ensure_inclusion must contain at least one (possibly empty) set")
    if households is None and all(len(s) == 0 for s in ensure_inclusion):
        from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

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
        return _relaxation_advice(rows, lbs, ubs, c, lo, hi, T, qmin, qmax, space)

    # agent space, variables [x_0 .. x_{S-1} blocks of n | min_relax (F) | max_relax (F)]
    A = dense.A_np.astype(np.float64)
    groups = _household_groups(np.asarray(households)) if households is not None else []
    nvars = S * n + 2 * F
    c = np.zeros(nvars)
    for f in range(F):
        old = qmin[f]
        c[S * n + f] = 0.0 if old == 0 else 1.0 + 2.0 / old
        c[S * n + F + f] = 1.0
    lo = np.zeros(nvars)
    hi = np.ones(nvars)
    hi[S * n : S * n + F] = qmin  # cannot lower below zero
    hi[S * n + F :] = float(n)  # raising beyond the pool is pointless
    mats: List[np.ndarray] = []
    lbs: List[float] = []
    ubs: List[float] = []
    for s, inclusion in enumerate(ensure_inclusion):
        base = s * n
        row = np.zeros(nvars)
        row[base : base + n] = 1.0
        mats.append(row)
        lbs.append(float(k))
        ubs.append(float(k))
        for f in range(F):
            row = np.zeros(nvars)
            row[base : base + n] = A[:, f]
            row[S * n + f] = 1.0  # + min_relax_f ≥ qmin_f
            mats.append(row)
            lbs.append(qmin[f])
            ubs.append(np.inf)
            row = np.zeros(nvars)
            row[base : base + n] = A[:, f]
            row[S * n + F + f] = -1.0  # − max_relax_f ≤ qmax_f
            mats.append(row)
            lbs.append(-np.inf)
            ubs.append(qmax[f])
        for members in groups:
            row = np.zeros(nvars)
            row[base + members] = 1.0
            mats.append(row)
            lbs.append(0.0)
            ubs.append(1.0)
        for agent in inclusion:
            lo[base + int(agent)] = 1.0
    return _relaxation_advice(
        np.vstack(mats), np.array(lbs), np.array(ubs), c, lo, hi, S * n, qmin, qmax, space
    )


def _relaxation_advice(rows, lbs, ubs, c, lo, hi, base, qmin, qmax, space):
    """Solve the relaxation MILP (relaxation variables from column ``base``
    on) and turn its solution into suggested quotas and advice lines."""
    F = len(qmin)
    res = milp(
        c=c,
        constraints=LinearConstraint(rows, lbs, ubs),
        integrality=np.ones(len(c)),
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
        lower = int(round(qmin[f] - round(res.x[base + f])))
        upper = int(round(qmax[f] + round(res.x[base + F + f])))
        if lower < qmin[f]:
            lines.append(f"Recommend lowering lower quota of {cat}:{feat} to {lower}.")
        if upper > qmax[f]:
            lines.append(f"Recommend raising upper quota of {cat}:{feat} to {upper}.")
        new_quotas[(cat, feat)] = (lower, upper)
    return new_quotas, lines


def check_feasible_or_suggest(
    dense: DenseInstance,
    space: FeatureSpace,
    oracle: Optional[HighsCommitteeOracle] = None,
    households: Optional[np.ndarray] = None,
) -> None:
    """Feasibility gate (``leximin.py:223-228``): on infeasible quotas raise
    :class:`InfeasibleQuotasError` carrying the suggested relaxation."""
    oracle = oracle or HighsCommitteeOracle(dense, households=households)
    if not oracle.check_feasible():
        new_quotas, lines = relax_infeasible_quotas(dense, space, households)
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


def audit_maximin(
    dense: DenseInstance, allocation: np.ndarray, covered: Optional[np.ndarray] = None
) -> dict:
    """Solver-independent certificate of an allocation's least probability.

    By LP minimax duality, for any probability vector ``w`` over agents,
    ``maximin ≤ Σ_i w_i · alloc_i ≤ max_{feasible committee x} w·x``; the
    right-hand maximum is the exact agent-space HiGHS MILP's proven bound,
    so the bound holds wherever ``w`` came from (the role the reference's
    dual-gap certificate plays, ``leximin.py:429-431``). The witness is the
    floor-dual vector of the stage-1 maximin LP over the marginal polytope,
    tight when the allocation is exact. On a household quotient's augmented
    instance the class caps make the bound valid for the
    household-constrained feasible set.

    ``covered`` masks agents contained in some feasible committee: agents in
    none have probability 0 under every distribution (the reference excludes
    them, ``leximin.py:286-296``), so the claim and its witness range over
    coverable agents only.

    Returns ``{"achieved_min", "certified_maximin_upper", "maximin_gap"}``
    (rounded to 1e-6); a gap within 1e-3 certifies the first leximin level
    of ``allocation``.
    """
    from citizensassemblies_tpu_torch.solvers.lp_util import robust_linprog
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(dense)
    T, F = red.T, red.F
    m = red.msize.astype(np.float64)
    if covered is None:
        covered = np.ones(dense.n, dtype=bool)
    covered = np.asarray(covered, dtype=bool)
    # a type is coverable iff any member is
    cov_t = np.zeros(T, dtype=bool)
    np.logical_or.at(cov_t, red.type_id, covered)
    tf = np.zeros((T, F))
    for t in range(T):
        tf[t, red.type_feature[t]] = 1.0
    # stage-1 maximin LP over the marginal polytope: vars [x (T), z]; floors
    # on coverable types only
    c = np.zeros(T + 1)
    c[T] = -1.0
    A_ub = np.zeros((2 * F + T, T + 1))
    A_ub[:F, :T] = -tf.T
    A_ub[F : 2 * F, :T] = tf.T
    A_ub[2 * F + np.arange(T), np.arange(T)] = -1.0
    A_ub[2 * F :, T] = np.where(cov_t, m, 0.0)
    b_ub = np.concatenate([-red.qmin.astype(float), red.qmax.astype(float), np.zeros(T)])
    A_eq = np.concatenate([np.ones(T), [0.0]])[None, :]
    res = robust_linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=[float(red.k)],
        bounds=[(0, mm) for mm in m] + [(0, None)],
    )
    if res.status != 0:
        raise SelectionError(f"maximin witness LP failed: {res.message}")
    y_t = np.maximum(-np.asarray(res.ineqlin.marginals)[2 * F :], 0.0)
    w = np.where(cov_t, y_t, 0.0)[red.type_id]
    total = w.sum()
    if total <= 0:
        # degenerate dual (no active floor row): the uniform witness over
        # covered agents only — mass on an agent no committee holds would
        # deflate the bound below the true maximin
        w = covered.astype(np.float64) / covered.sum()
    else:
        w = w / total
    # the exact agent-space bound, from the MILP directly: the witness is
    # constant within types, where the seeded native branch-and-bound ties
    # itself in near-equal branches
    _panel, _value, upper = HighsCommitteeOracle(dense)._milp_maximize_with_bound(w)
    z_min = float(np.asarray(allocation)[covered].min())
    return {
        "achieved_min": round(z_min, 6),
        "certified_maximin_upper": round(float(upper), 6),
        "maximin_gap": round(float(upper) - z_min, 6),
    }


def audit_leximin_profile(
    dense: DenseInstance,
    allocation: np.ndarray,
    covered: Optional[np.ndarray] = None,
    level_tol: float = 1e-3,
    max_levels: Optional[int] = None,
) -> dict:
    """Solver-independent certificate of a whole leximin profile, level by
    level.

    :func:`audit_maximin` iterated: at level ``j`` the types of earlier
    levels are floored at their *achieved* values (``allocation`` meets
    those floors, so the relaxed level-``j`` problem contains it and the
    bound never undercuts what was achieved), a witness LP over the
    marginal polytope maximizes the least value of the remaining types, and
    its floor duals enter the exact agent-space HiGHS MILP as Lagrange
    multipliers:

        level_j ≤ Σ w·a ≤ max_{feasible x} (w + λ)·x − Σ_t λ_t·floor_t·cnt_t

    for any feasible distribution meeting the earlier floors, any
    probability vector ``w`` over the remaining covered agents and any
    λ ≥ 0 on the floored types. This certifies what the reference's
    per-stage dual gap certifies (``leximin.py:429-431``): each level is
    optimal given the prefix already fixed. Each level reports two valid
    upper bounds: ``milp_upper``, the Lagrangian bound of the exact
    agent-space MILP, outside the type-space machinery but carrying an
    integrality duality gap deep in the profile, and ``marginal_upper``,
    the witness LP's own optimum, tight everywhere but sharing the
    marginal-relaxation view with the solver. ``gap`` uses the smaller;
    ``gap_milp`` and ``worst_gap_milp`` record how far the independent
    bound alone reaches. One witness LP and one to nine MILPs per level.

    Pass the CERTIFIED profile (``Distribution.fixed_probabilities``) as
    ``allocation``, not the realized one: flooring the prefix at realized
    values leaks the realization ε across every fixed type, which the
    polytope concentrates onto later singleton types as spurious headroom.
    The realized-vs-certified gap, ``max|allocation − fixed_probabilities|``,
    is a separate, directly measured number; the two together certify the
    shipped allocation end to end.

    Host code on numpy, scipy and HiGHS: ``dense`` may live on the card,
    and is read only through its host mirrors (:class:`TypeReduction`, the
    oracle's constraint rows).

    Returns ``{"levels", "n_levels", "worst_gap", "worst_gap_milp",
    "all_within_tol", "audited_types"}`` (rounded to 1e-6), each level
    ``{"achieved", "certified_upper", "milp_upper", "marginal_upper",
    "gap", "gap_milp", "types"}``.
    """
    from citizensassemblies_tpu_torch.solvers.lp_util import robust_linprog
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(dense)
    T, F = red.T, red.F
    alloc = np.asarray(allocation, dtype=np.float64)
    if covered is None:
        covered = np.ones(dense.n, dtype=bool)
    covered = np.asarray(covered, dtype=bool)
    cov_t = np.zeros(T, dtype=bool)
    np.logical_or.at(cov_t, red.type_id, covered)
    # per-type achieved values: allocations are type-constant up to the
    # realization tolerance; the min, so floors never overstate
    v_t = np.full(T, np.inf)
    np.minimum.at(v_t, red.type_id, np.where(covered, alloc, np.inf))
    v_t = np.where(cov_t, v_t, 0.0)
    # per-type covered member counts: uncovered agents sit at a structural
    # 0 and carry no level guarantee, so floors and the Lagrangian
    # subtraction scale with the covered count, not the type size
    cnt_t = np.zeros(T)
    np.add.at(cnt_t, red.type_id, covered.astype(np.float64))
    tf = np.zeros((T, F))
    for t in range(T):
        tf[t, red.type_feature[t]] = 1.0

    oracle = HighsCommitteeOracle(dense)
    fixed_floor = np.zeros(T)
    fixed_mask = np.zeros(T, dtype=bool)
    remaining = cov_t.copy()
    levels: list = []
    worst_gap = 0.0
    worst_gap_milp = 0.0
    while remaining.any() and (max_levels is None or len(levels) < max_levels):
        lvl = float(v_t[remaining].min())
        S = remaining & (v_t <= lvl + level_tol)
        nr = int(remaining.sum())
        idxr = np.nonzero(remaining)[0]
        c = np.zeros(T + 1)
        c[T] = -1.0
        A_ub = np.zeros((2 * F + nr, T + 1))
        A_ub[:F, :T] = -tf.T
        A_ub[F : 2 * F, :T] = tf.T
        A_ub[2 * F + np.arange(nr), idxr] = -1.0
        A_ub[2 * F :, T] = cnt_t[idxr]
        b_ub = np.concatenate([-red.qmin.astype(float), red.qmax.astype(float), np.zeros(nr)])
        lo = np.where(fixed_mask, np.clip(fixed_floor * cnt_t, 0.0, cnt_t), 0.0)
        # upper bounds at the covered member counts: no feasible committee
        # holds an uncovered agent, and a free uncoverable type lets the LP
        # park quota pressure there and inflate the bound
        res = robust_linprog(
            c, A_ub=A_ub, b_ub=b_ub,
            A_eq=np.concatenate([np.ones(T), [0.0]])[None, :],
            b_eq=[float(red.k)],
            bounds=[(lo[t], cnt_t[t]) for t in range(T)] + [(0, None)],
        )
        if res.status != 0:
            raise SelectionError(f"level-{len(levels) + 1} witness LP failed: {res.message}")
        y = np.maximum(-np.asarray(res.ineqlin.marginals)[2 * F :], 0.0)
        w_t = np.zeros(T)
        w_t[idxr] = y
        # per-agent weights, y_t per covered remaining member (the stage
        # dual makes Σ y_t·cnt_t ≈ 1: the z column's coefficients are the
        # covered counts)
        w = np.where(covered, w_t[red.type_id], 0.0)
        lam_t = np.zeros(T)
        if res.lower is not None and res.lower.marginals is not None:
            lam_t = np.maximum(np.asarray(res.lower.marginals)[:T], 0.0)
        lam_t = np.where(fixed_mask, lam_t, 0.0)
        total = w.sum()
        if total <= 0:
            w = np.where(covered & remaining[red.type_id], 1.0, 0.0)
            total = w.sum()
            lam_t[:] = 0.0
        w = w / total
        lam_t = lam_t / total
        # the fractional stage optimum is itself a valid upper bound: any
        # feasible distribution's marginal lies in the floored polytope
        marginal_upper = float(res.x[T])

        # the Lagrangian MILP bound, tightened by a few projected
        # subgradient steps on λ (one exact MILP each): the LP-dual λ is
        # optimal for the fractional problem, not for the Lagrangian dual
        # of the integer one
        def milp_bound(lam):
            u = w + np.where(covered, lam[red.type_id], 0.0)
            panel, _value, raw = oracle._milp_maximize_with_bound(u)
            return float(raw) - float(np.sum(lam * fixed_floor * cnt_t)), panel

        upper_milp, panel = milp_bound(lam_t)
        if fixed_mask.any() and upper_milp > lvl + level_tol:
            # backtracking: step from the best λ so far; a worsening step
            # reverts λ and its argmax panel (which seeds the next
            # subgradient) and halves the step
            lam_best, panel_best = lam_t.copy(), panel
            lam = lam_t.copy()
            step = 1.0
            for _ in range(8):
                # the subgradient at λ: the floor slack of the argmax panel
                x_cnt = np.bincount(
                    red.type_id[np.asarray(panel, dtype=int)], minlength=T
                ).astype(np.float64)
                g = np.where(fixed_mask, x_cnt - fixed_floor * cnt_t, 0.0)
                if not np.any(g):
                    break
                lam = np.maximum(lam - step * g / max(np.abs(g).max(), 1.0) * 0.1, 0.0)
                val, panel = milp_bound(lam)
                if val < upper_milp - 1e-12:
                    upper_milp, lam_best, panel_best = val, lam.copy(), panel
                else:
                    lam, panel = lam_best.copy(), panel_best
                    step *= 0.5
                    if step < 0.05:
                        break

        upper = min(upper_milp, marginal_upper)
        gap = upper - lvl
        gap_milp = upper_milp - lvl
        worst_gap = max(worst_gap, gap)
        worst_gap_milp = max(worst_gap_milp, gap_milp)
        levels.append(
            {
                "achieved": round(lvl, 6),
                "certified_upper": round(upper, 6),
                "milp_upper": round(upper_milp, 6),
                "marginal_upper": round(marginal_upper, 6),
                "gap": round(gap, 6),
                "gap_milp": round(gap_milp, 6),
                "types": int(S.sum()),
            }
        )
        fixed_mask |= S
        # each fixed type floored at its own achieved value, not the level's
        # least: a prefix floored even 1e-3 low frees aggregate mass that
        # the polytope concentrates onto later singleton types. The
        # allocation meets these floors, so each level is certified given
        # the achieved earlier values, the semantics of the reference's
        # per-stage certificate
        fixed_floor = np.where(S, np.maximum(v_t - 1e-9, 0.0), fixed_floor)
        remaining &= ~S
    return {
        "levels": levels,
        "n_levels": len(levels),
        "worst_gap": round(worst_gap, 6),
        "worst_gap_milp": round(worst_gap_milp, 6),
        "all_within_tol": bool(worst_gap <= level_tol),
        "audited_types": int(fixed_mask.sum()),
    }


def audit_second_level(
    dense: DenseInstance,
    allocation: np.ndarray,
    covered: Optional[np.ndarray] = None,
    level_tol: float = 1e-3,
) -> dict:
    """The level-2 view of :func:`audit_leximin_profile`: the level-1 set
    floored at its certified value, the second level bounded by the
    Lagrangian-tightened exact MILP witness. Pass the certified profile, as
    there. Returns ``{"achieved_level2", "certified_level2_upper",
    "level2_gap", "level1_set_types"}``; the first three are None for a
    profile of one level, which has no second level to certify (0.0 would
    read as a perfect certificate)."""
    prof = audit_leximin_profile(
        dense, allocation, covered=covered, level_tol=level_tol, max_levels=2
    )
    if prof["n_levels"] < 2:
        return {
            "achieved_level2": None, "certified_level2_upper": None, "level2_gap": None,
            "level1_set_types": prof["levels"][0]["types"] if prof["levels"] else 0,
        }
    l2 = prof["levels"][1]
    return {
        "achieved_level2": l2["achieved"],
        "certified_level2_upper": l2["certified_upper"],
        "level2_gap": l2["gap"],
        "level1_set_types": prof["levels"][0]["types"],
    }
