"""Column-generation LEXIMIN in composition (type) space, phase 1.

For instances with too many distinct agent types to enumerate every feasible
composition (``solvers/compositions.py``), the problem still collapses onto
types: columns are *compositions* ``c ∈ Z^T`` rather than agent subsets.
Phase 1 solves leximin exactly over the marginal relaxation polytope (T
stages of millisecond host LPs), seeds aimed integer compositions around the
target with the native slicer, certifies coverage with forced-inclusion
MILPs, and realizes the profile as one mixture of compositions with the
face decomposition (``solvers/face_decompose.py``), whose masters run on
the device. When the face loop stalls above the acceptance band, phase 2
falls back to certified stage-wise column generation over compositions:
per stage the stage LP (by PDHG on the device, re-solved on the host before
any irreversible fixing), stochastic pricing with the LEGACY sampler and one
exact pricing MILP per iteration, and tranche fixing by marginal probes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.optimize
import scipy.sparse

from citizensassemblies_tpu_torch.solvers.lp_util import probe_confirm_tranche, robust_linprog
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

_SLACK = 1e-9
#: deduction applied to every fixed leximin value: the solver-reported stage
#: optimum can overstate the true optimum by its own tolerance (~1e-8), and
#: floors encoding overstated values leave later stages genuinely infeasible
#: — a ratchet that compounds across stages. Fixing at z − margin keeps every
#: floor strictly achievable; the understatement is far below the 1e-3 bar.
_FIX_MARGIN = 1e-7


class CompositionOracle:
    """Exact ``max Σ_t w_t c_t`` over feasible compositions (HiGHS MILP).

    The type-space collapse of the reference's committee-generation ILP
    (``leximin.py:190-233``): variables are per-type member counts with bounds
    ``[0, m_t]``, constraints are ``Σc = k`` plus one row per feature quota.
    """

    def __init__(self, reduction: TypeReduction, log: Optional[RunLog] = None):
        #: optional RunLog for oracle-mix attribution (every maximize is a
        #: scipy/HiGHS MILP; the device pricer counts its own lane, so bench
        #: rows show the native / HiGHS / device split per run)
        self.log = log
        self.red = reduction
        T, F = reduction.T, reduction.F
        tf = np.zeros((T, F))
        for t in range(T):
            tf[t, reduction.type_feature[t]] = 1.0
        A = scipy.sparse.vstack(
            [scipy.sparse.csr_matrix(np.ones((1, T))), scipy.sparse.csr_matrix(tf.T)]
        )
        self._constraints = scipy.optimize.LinearConstraint(
            A,
            np.concatenate([[reduction.k], reduction.qmin]),
            np.concatenate([[reduction.k], reduction.qmax]),
        )
        self._integrality = np.ones(T)

    def maximize(
        self, weights: np.ndarray, forced_type: Optional[int] = None,
        rel_gap: float = 0.0,
    ) -> Optional[Tuple[np.ndarray, float]]:
        """Best feasible composition for per-type ``weights``; optionally force
        ``c_t ≥ 1`` for one type (the coverage solves of ``leximin.py:279-289``).
        Returns None when infeasible.

        ``rel_gap`` relaxes the MILP's optimality gap for callers that use the
        result as a *heuristic column* rather than a certificate (the face
        loop's anchor columns: acceptance there is the arithmetic residual of
        the master iterate, so anchor optimality buys nothing, while an
        exact solve at T ≈ 1000 is a large share of an anchor round).
        Certification calls keep the exact default."""
        if self.log is not None:
            self.log.count("oracle_backend_highs")
        lo = np.zeros(self.red.T)
        if forced_type is not None:
            lo[forced_type] = 1.0
        res = scipy.optimize.milp(
            c=-np.asarray(weights, dtype=np.float64),
            constraints=self._constraints,
            bounds=scipy.optimize.Bounds(lo, self.red.msize.astype(np.float64)),
            integrality=self._integrality,
            options={"mip_rel_gap": rel_gap} if rel_gap > 0.0 else None,
        )
        if res.status != 0 or res.x is None:
            return None
        comp = np.round(res.x).astype(np.int32)
        return comp, float(-res.fun)


def _relaxation_bound(
    reduction: TypeReduction, fixed: np.ndarray
) -> Tuple[float, np.ndarray]:
    """Stage upper bound from the LP relaxation over expected type counts.

    ``max z`` over fractional ``x ∈ [0, m]`` with ``Σx = k``, feature quota
    rows, ``x_t ≥ z·m_t`` (unfixed) and ``x_t ≥ f_t·m_t`` (fixed). Any
    distribution over feasible compositions has its expectation in this
    polytope, so no stage can exceed ``z_UB``; when the master LP reaches it,
    the stage is certified optimal without an exact pricing call. The
    optimizer ``x*`` is a vertex with at most #rows fractional coordinates —
    its randomized roundings are injected as master columns so the portfolio
    spans near-optimal mixtures immediately instead of discovering them one
    pricing round at a time.
    """
    T, F = reduction.T, reduction.F
    tf = np.zeros((T, F))
    for t in range(T):
        tf[t, reduction.type_feature[t]] = 1.0
    m = reduction.msize.astype(np.float64)
    unfixed = fixed < 0
    # variables [x (T), z]
    c = np.zeros(T + 1)
    c[T] = -1.0
    rows = []
    b = []
    # quota rows: lo ≤ tfᵀ x ≤ hi  →  two inequality blocks
    rows.append(np.concatenate([-tf.T, np.zeros((F, 1))], axis=1))
    b.append(-reduction.qmin.astype(np.float64))
    rows.append(np.concatenate([tf.T, np.zeros((F, 1))], axis=1))
    b.append(reduction.qmax.astype(np.float64))
    # floor rows: z·m_t − x_t ≤ 0 (unfixed), f_t·m_t − x_t ≤ 0 (fixed)
    floor = np.zeros((T, T + 1))
    floor[np.arange(T), np.arange(T)] = -1.0
    floor[unfixed, T] = m[unfixed]
    rows.append(floor)
    b.append(np.where(unfixed, 0.0, -(np.maximum(fixed, 0.0) * m - _SLACK)))
    A_ub = np.concatenate(rows, axis=0)
    b_ub = np.concatenate(b)
    A_eq = np.concatenate([np.ones(T), [0.0]])[None, :]
    res = robust_linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=[float(reduction.k)],
        bounds=[(0, mm) for mm in m] + [(0, None)],
    )
    if res.status != 0:
        return float("inf"), np.zeros(T)
    return float(res.x[T]), res.x[:T]


def _round_relaxation(
    x: np.ndarray,
    reduction: TypeReduction,
    rng: np.random.Generator,
    count: int = 256,
) -> List[np.ndarray]:
    """Randomized quota-feasible integer roundings of a fractional type-count
    vector (probability-proportional on the fractional coordinates, with a
    Σ=k repair step); infeasible roundings are discarded."""
    T = reduction.T
    k = reduction.k
    lo = reduction.qmin
    hi = reduction.qmax
    base = np.floor(x).astype(np.int64)
    frac = x - base
    fidx = np.nonzero(frac > 1e-12)[0]
    tf = np.zeros((T, reduction.F), dtype=np.int64)
    for t in range(T):
        tf[t, reduction.type_feature[t]] = 1
    cands = np.repeat(base[None, :], count, axis=0)
    for r in range(count):
        c = cands[r]
        c[fidx] += rng.random(len(fidx)) < frac[fidx]
        gap = k - int(c.sum())
        order = rng.permutation(fidx)
        for t in order:
            if gap == 0:
                break
            if gap > 0 and c[t] == base[t]:
                c[t] += 1
                gap -= 1
            elif gap < 0 and c[t] > base[t]:
                c[t] -= 1
                gap += 1
        if gap != 0:
            c[0] = -1  # mark infeasible
    ok = cands[:, 0] >= 0
    counts = cands @ tf  # [count, F]
    ok &= np.all(counts >= lo[None, :], axis=1) & np.all(counts <= hi[None, :], axis=1)
    return [c.astype(np.int32) for c in cands[ok]]


def _quota_system(reduction: TypeReduction) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked two-sided quota rows over type counts: ``A x ≤ b`` encodes
    ``qmin ≤ tfᵀ x ≤ qmax`` (A is [2F, T])."""
    T, F = reduction.T, reduction.F
    tf = np.zeros((T, F))
    for t in range(T):
        tf[t, reduction.type_feature[t]] = 1.0
    A = np.concatenate([-tf.T, tf.T], axis=0)
    b = np.concatenate(
        [-reduction.qmin.astype(np.float64), reduction.qmax.astype(np.float64)]
    )
    return A, b


def _marginal_probe_confirm(
    reduction: TypeReduction,
    fixed: np.ndarray,
    z: float,
    cand: np.ndarray,
    probe_tol: float = 1e-7,
    floor_slack: float = _SLACK,
    log: Optional[RunLog] = None,
    exclude: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Certify which candidate types are capped at ``z`` on the *marginal*
    optimal face ``{x ∈ X : x_u ≥ z·m_u ∀ unfixed u, x_f ≥ f·m_f}``.

    One group LP maximizing ``Σ_cand x_t/m_t`` confirms every candidate at
    once when its optimum is ``|cand|·z`` (each term is ≥ z on the face, so
    none can exceed z anywhere); per-candidate probes resolve disagreement.
    Because the composition hull is contained in the marginal polytope, a
    marginal certificate is also valid for the hull face at the same ``z`` —
    the cheap, bounds-only certification used by the stage-CG fixing. Returns
    a bool mask over ``cand``.
    """
    T = reduction.T
    m = reduction.msize.astype(np.float64)
    if exclude is not None and exclude.any():
        # mirror the stage LP's pinning (x_t = 0): leaving the full upper
        # bound would let the probe face route mass through excluded types —
        # a strictly larger polytope than the one being optimized, whose
        # probes can then fail on genuinely tight candidates and push the
        # stage into the uncertified dual-heuristic fallback
        m = np.where(exclude, 0.0, m)
    k = float(reduction.k)
    quota_A, quota_b = _quota_system(reduction)
    unfixed = fixed < 0
    # the stage LP's unfixed floors are EXACT (x_u ≥ z·m_u rows, no slack),
    # so its optimum provably lies on the face with floors z − probe_relax
    # for any probe_relax > 0 — only solver feasibility tolerance needs
    # covering, not the fixing margin. The floor stays at 1e-8, BELOW
    # HiGHS's ~1e-7 primal tolerance, deliberately: raising it to 1e-7
    # inflates slack_gain ≈ probe_relax·Σm past ALLOWANCE_CAP at n ≈ 1700,
    # which makes every sound group-probe budget unpassable and degrades
    # tranche certification to one LP per candidate (about one probe LP
    # per type of the sf_e_like stage loop). The rare numerically-empty
    # face a sub-tolerance relaxation can produce is handled by the
    # empty-face detection plus the 10×-relaxed retry face below, which
    # costs one extra LP only when it actually occurs. A loose face (the
    # old margin+slack relaxation) freed (margin+slack)·Σm ≈ 1e-4-scale
    # reroutable mass — same failure mode, same lesson.
    probe_relax = max(1e-8, floor_slack)
    A_eq = np.ones((1, T))

    def _bounds_at(relax: float):
        lo = np.where(
            unfixed,
            np.maximum(z - relax, 0.0) * m,
            (np.maximum(fixed, 0.0) - floor_slack) * m,
        )
        lo = np.clip(lo, 0.0, m)
        return [(lo[t], m[t]) for t in range(T)]

    bounds = _bounds_at(probe_relax)
    bounds_relaxed = _bounds_at(10.0 * probe_relax)

    def _face_max_over(bnds):
        def fm(w: np.ndarray):
            r = robust_linprog(
                -w, A_ub=quota_A, b_ub=quota_b, A_eq=A_eq, b_eq=[k], bounds=bnds
            )
            if r.status == 0:
                return float(-r.fun), np.asarray(r.x)
            # infeasible vs failed — no optimizer either way
            return (-np.inf, None) if r.status == 2 else (None, None)
        return fm

    face_max = _face_max_over(bounds)
    # retry probe for objective-specific infeasible reports: same face with
    # floors 10× looser — a superset, so its optimum is a valid upper bound
    face_max_relaxed = _face_max_over(bounds_relaxed)

    cand = np.asarray(cand)
    if z >= 1.0 - probe_tol:
        # normalized type values cannot exceed 1 (x_t ≤ m_t), so every
        # candidate is trivially capped at z — no LP needed, and the face at
        # z ≈ 1 is often numerically empty anyway
        return np.ones(len(cand), dtype=bool)
    # the face floors are relaxed by probe_relax·m_t (unfixed) and
    # floor_slack·m_t (fixed) raw units; at most their sum can be re-routed
    # into a candidate, so tightness must be judged up to that freed mass
    # (normalized by m_t) or genuinely tight types probe "loose" on large
    # pools, inflating later stage values by exactly the slack (the shared
    # prober clamps the allowance so an escalated slack ladder can never
    # certify at a tolerance material against the 1e-3 bar); each
    # candidate's own value may also sit up to probe_relax below z on the
    # face, which the prober charges against the group test's budget
    slack_gain = probe_relax * float(m[unfixed].sum()) + floor_slack * float(
        m[~unfixed].sum()
    )
    objectives = np.zeros((len(cand), T))
    objectives[np.arange(len(cand)), cand] = 1.0 / m[cand]
    return probe_confirm_tranche(
        face_max,
        objectives,
        z,
        probe_tol,
        slack_gain / m[cand],
        term_deficit=probe_relax,
        log=log.emit if log is not None else None,
        face_max_relaxed=face_max_relaxed,
    )


def _leximin_relaxation(
    reduction: TypeReduction,
    log: Optional[RunLog] = None,
    probe_tol: float = 1e-7,
    exclude: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact leximin of ``x/m`` over the marginal relaxation polytope
    ``X = {x ∈ [0, m] : Σx = k, lo ≤ tfᵀx ≤ hi}``.

    Every achievable allocation profile is the expectation of a composition
    distribution and hence lies in ``X/m``, so this leximin profile dominates
    the true one in leximin order; when the decomposition LP later realizes it
    exactly (ε ≈ 0), it *is* the true leximin — certified without any
    stage-wise column generation. Runs the same fix-tranche stage loop as
    ``leximin_over_compositions`` but each stage is a T-variable LP solved in
    milliseconds (fixed-type floors live in the variable bounds, so the row
    count shrinks as fixing progresses).

    Tranche fixing is **probe-certified**, not dual-heuristic: a vertex dual
    ``y_t > 0`` proves tightness only at *one* optimum (the reference leans on
    Gurobi's strictly-complementary barrier for the stronger claim,
    ``leximin.py:325-327,431-443``). Here candidates proposed by the duals are
    confirmed against the optimal face ``{x ∈ X : x_u ≥ z·m_u ∀ unfixed u}``:
    one group LP maximizing ``Σ_cand x_t/m_t`` certifies the whole tranche when
    its optimum is ``|cand|·z`` (then no candidate can exceed ``z`` anywhere on
    the face); otherwise per-candidate probes keep exactly the types whose face
    maximum is ``z``. Returns ``(v [T] leximin type values, x_final [T] an
    optimal marginal)``.

    ``exclude`` (bool[T]) pins types proven to appear in NO integer
    composition at value 0 with ``x_t = 0``: leaving them free lets the
    relaxation route mass through them fractionally, inflating other types'
    values past what any composition mixture can realize (the face
    decomposition then stalls on an irreducible residual).
    """
    log = log or RunLog(echo=False)
    T, F = reduction.T, reduction.F
    m = reduction.msize.astype(np.float64)
    if exclude is not None and exclude.any():
        m = np.where(exclude, 0.0, m)  # upper bound 0 ⇒ x_t = 0 throughout
    k = float(reduction.k)
    fixed = np.full(T, -1.0)
    if exclude is not None:
        fixed[exclude] = 0.0
    x_last = np.zeros(T)
    quota_A, quota_b = _quota_system(reduction)
    stage = 0
    probes = 0
    floor_slack = 0.0
    while (fixed < 0).any():
        stage += 1
        unfixed = fixed < 0
        uidx = np.nonzero(unfixed)[0]
        nu = len(uidx)
        # stage LP over [x, z]: max z s.t. x ∈ X, x_u ≥ z·m_u (unfixed),
        # x_t ≥ (f_t − slack)·m_t via lower bounds (fixed). The slack ladder
        # covers HiGHS's own primal feasibility tolerance: fixing at a
        # solver-reported optimum can overstate the true optimum by ~1e-7,
        # leaving later stages *genuinely* (numerically) infeasible at a
        # 1e-9 slack; the probe allowances scale with the slack in use, so
        # escalation costs tolerance budget only when actually needed.
        A_dense = np.zeros((2 * F + nu, T + 1))
        A_dense[: 2 * F, :T] = quota_A
        A_dense[2 * F + np.arange(nu), uidx] = -1.0
        A_dense[2 * F :, T] = m[uidx]
        # the floor block is −I plus one dense column: sparse storage roughly
        # halves HiGHS's stage-LP time at T ≈ 1000
        A_ub = scipy.sparse.csr_matrix(A_dense)
        b_ub = np.concatenate([quota_b, np.zeros(nu)])
        c = np.zeros(T + 1)
        c[T] = -1.0
        res = None
        for slack in sorted({floor_slack, 1e-8, 1e-7, 1e-6, 1e-5}):
            if slack < floor_slack:
                continue
            lo_b = np.clip((np.where(unfixed, 0.0, np.maximum(fixed, 0.0)) - slack) * m, 0.0, m)
            lo_b[unfixed] = 0.0
            res = robust_linprog(
                c, A_ub=A_ub, b_ub=b_ub,
                A_eq=np.concatenate([np.ones(T), [0.0]])[None, :], b_eq=[k],
                bounds=[(lo_b[t], m[t]) for t in range(T)] + [(0, None)],
            )
            if res.status == 0:
                if slack > floor_slack:
                    log.emit(
                        f"Relaxation stage {stage}: floor slack escalated to "
                        f"{slack:.0e} (solver-tolerance infeasibility)."
                    )
                floor_slack = slack
                break
        if res is None or res.status != 0:
            raise RuntimeError(f"relaxation stage LP failed: {res.message}")
        z = float(res.x[T])
        x_last = res.x[:T]
        y = -np.asarray(res.ineqlin.marginals)[2 * F :]  # unfixed floor duals
        # candidate gate on the dimensionless contribution y_t·m_t (the duals
        # satisfy Σ y_t·m_t = 1, so an absolute cut is scale-inconsistent)
        cand = np.nonzero(y * m[uidx] > 1e-9)[0]
        if len(cand) == 0:
            cand = np.array([int(np.argmax(y * m[uidx]))])

        conf = _marginal_probe_confirm(
            reduction, fixed, z, uidx[cand], probe_tol, floor_slack=floor_slack,
            log=log, exclude=exclude,
        )
        probes += 1 + (0 if conf.all() else len(cand))
        confirmed = np.zeros(T, dtype=bool)
        confirmed[uidx[cand[conf]]] = True
        if not confirmed.any():
            # the dual candidates all probe loose — scan the remaining unfixed
            # types (descending dual weight) for one that is genuinely capped;
            # at a stage optimum at least one must be (else z could increase)
            rest = uidx[np.argsort(-(y * m[uidx]))]
            rest = np.array([t for t in rest if t not in set(uidx[cand])], dtype=int)
            for t in rest:
                if _marginal_probe_confirm(
                    reduction, fixed, z, np.array([t]), probe_tol,
                    floor_slack=floor_slack, log=log, exclude=exclude,
                )[0]:
                    confirmed[t] = True
                    break
                probes += 1
            if not confirmed.any():
                # numerics left nothing certifiable: fall back to the largest
                # dual weight so the loop always progresses (reference
                # heuristic, leximin.py:431-443)
                confirmed[uidx[np.argmax(y * m[uidx])]] = True
                log.emit(
                    f"Relaxation stage {stage}: no probe-certified type at "
                    f"z={z:.6f}; falling back to the dual heuristic."
                )
        fixed = np.where(confirmed, max(0.0, z - _FIX_MARGIN), fixed)
    log.emit(f"Relaxation leximin: {stage} stages, ~{probes} probe LPs, values in "
             f"[{fixed.min():.6f}, {fixed.max():.6f}].")
    return fixed, x_last


def _decomp_lp(MT: np.ndarray, v: np.ndarray) -> Tuple[float, np.ndarray, float, np.ndarray]:
    """Two-sided decomposition master: ``min ε`` s.t.
    ``v − ε ≤ M p ≤ v + ε``, ``Σp = 1``, ``p ≥ 0`` (host, sparse IPM).

    One-sided feasibility (the reference's final-LP shape,
    ``leximin.py:453-464``) lets the surplus ``Σ(alloc − v) = 0`` concentrate:
    a deficit of ε per type funds an overshoot of up to T·ε on one type,
    which breaks the L∞ acceptance bar even at small ε. The two-sided form
    bounds the allocation error by ε directly. Returns ``(ε, w, μ, p)`` with
    pricing weights ``w = y_lower − y_upper`` (mixed sign): a composition
    improves the master iff ``w·(c/m) > −μ``.
    """
    T, C = MT.shape
    v = np.asarray(v, dtype=np.float64)
    G = scipy.sparse.vstack(
        [
            scipy.sparse.hstack(
                [scipy.sparse.csr_matrix(-MT), scipy.sparse.csr_matrix(-np.ones((T, 1)))]
            ),
            scipy.sparse.hstack(
                [scipy.sparse.csr_matrix(MT), scipy.sparse.csr_matrix(-np.ones((T, 1)))]
            ),
        ]
    ).tocsr()
    h = np.concatenate([-(v - _SLACK), v + _SLACK])
    A_eq = scipy.sparse.csr_matrix(np.concatenate([np.ones(C), [0.0]])[None, :])
    c_obj = np.zeros(C + 1)
    c_obj[C] = 1.0
    # dual simplex wins on the small host masters (T ≈ 150, C ≈ 2000) but
    # degrades badly on tall systems such as a T = 1199 household-quotient
    # polish, where the interior point is many times faster — so the order
    # flips on T
    methods = (
        ("highs-ds", "highs-ipm", "highs")
        if T <= 384
        else ("highs-ipm", "highs")
    )
    res = robust_linprog(
        c_obj, A_ub=G, b_ub=h, A_eq=A_eq, b_eq=[1.0],
        bounds=[(0, None)] * (C + 1), methods=methods,
    )
    if res.status != 0:
        raise RuntimeError(f"decomposition LP failed: {res.message}")
    lam = -np.asarray(res.ineqlin.marginals)  # ≥ 0
    w = lam[:T] - lam[T:]
    mu = float(res.eqlin.marginals[0])
    return float(res.x[C]), w, mu, np.maximum(res.x[:C], 0.0)


def _slice_relaxation(
    x: np.ndarray,
    reduction: TypeReduction,
    R: int = 512,
    j0: int = 0,
    chunks: int = 1,
    max_passes: Optional[int] = None,
) -> List[np.ndarray]:
    """Systematic apportionment of a fractional marginal into ``R`` integer
    compositions whose uniform mixture reproduces ``x`` to within ~1/R.

    Slice j takes ``c_t(j) = ⌊j·x_t⌋ − ⌊(j−1)·x_t⌋`` (cumulative largest-
    remainder rounding, so every type's total over slices is exact to ±1),
    then repairs ``Σc = k`` by moving units between types with the smallest
    rounding residuals, subject to the feature quotas. Slices that cannot be
    repaired feasibly are dropped. Unlike independent randomized roundings
    (≈5–20 % feasible on tight instances), these columns are *aimed*: their
    hull surrounds ``x`` by construction, which is what the decomposition
    master needs."""
    from citizensassemblies_tpu_torch.solvers.native_oracle import slice_stream_native

    # one native call for the whole stream when the toolchain is available:
    # the per-slice path below costs ~0.3 ms/slice of ctypes marshalling and
    # numpy bookkeeping, which at R ≈ 1000 dominated mid-tier leximin solves.
    # j0 offsets the tie streams (fresh slices of the same hull on repeated
    # calls); chunks > 1 runs that many GIL-released streams in parallel.
    if max_passes is None:
        max_passes = 3 * reduction.F
    streamed = slice_stream_native(
        reduction, np.asarray(x, dtype=np.float64), R,
        max_passes=max_passes, j0=j0, chunks=chunks,
    )
    if streamed is not None:
        return list(streamed)

    if chunks > 1:
        # match the native semantics without the toolchain (ADVICE r4):
        # `chunks` independent phase-spaced streams of R // chunks slices,
        # run sequentially — same offsets (j0 + i·(1<<16)) and hull
        # diversity as the parallel native streams
        out: List[np.ndarray] = []
        sizes = [R // chunks + (1 if i < R % chunks else 0) for i in range(chunks)]
        for i, r in enumerate(sizes):
            out.extend(
                _slice_relaxation(
                    x, reduction, R=r, j0=j0 + i * (1 << 16), chunks=1,
                    max_passes=max_passes,
                )
            )
        return out

    T = reduction.T
    k = reduction.k
    lo, hi = reduction.qmin, reduction.qmax
    tf = np.zeros((T, reduction.F), dtype=np.int64)
    for t in range(T):
        tf[t, reduction.type_feature[t]] = 1
    x = np.asarray(x, dtype=np.float64)
    msize = reduction.msize.astype(np.int64)
    # cumulative feedback: each slice apportions the *residual* j·x −
    # assigned, and every unit actually emitted (including quota repairs)
    # feeds back into `assigned` — so repair deviations self-correct in later
    # slices and the uniform mixture tracks x to ~1/R per type
    assigned = np.zeros(T, dtype=np.int64)
    feat_of = np.asarray(reduction.type_feature)  # [T, ncat]
    ncat = feat_of.shape[1]
    tidx = np.arange(T)

    def swap_repair(c: np.ndarray, counts: np.ndarray, j: int, need: np.ndarray) -> bool:
        """Greedy best-swap quota repair, vectorized per iteration.

        Each pass scores every (donor, receiver) unit move by its exact
        violation change — per-type removal/addition effects from the
        feature-count deltas, with a correction for categories where donor
        and receiver share a feature (their effects cancel there) — and
        applies a best strictly-improving swap. Ties (ubiquitous on integer
        scores) are broken by the slice's *tracking residual* ``c − need``
        plus per-slice random noise: preferring donors above their stream
        target and receivers below it means a repair corrects the
        apportionment error instead of compounding it — repair drift, not
        the ±1 rounding, is what set the decomposition's starting ε. Pure
        random ties remain in the mix because fully deterministic repair
        collapses slice diversity (measured: support 87 vs 180 columns,
        ε 3.8e-2 vs 2.0e-2). Replaces a python double loop that dominated
        the slicer's runtime at T ≈ 800.
        """
        tie = np.random.default_rng(j)
        for _ in range(max_passes):
            track = np.clip(c - need, -2.0, 2.0)
            pref_sub = -0.4 * track  # donate where above target ⇒ lower score
            pref_add = 0.4 * track  # receive where below target ⇒ lower score
            viol = np.maximum(counts - hi, 0) + np.maximum(lo - counts, 0)
            total = int(viol.sum())
            if total == 0:
                return True
            # per-feature violation deltas for one removal / one addition
            dv_sub_f = (
                np.maximum(counts - 1 - hi, 0) + np.maximum(lo - counts + 1, 0) - viol
            )
            dv_add_f = (
                np.maximum(counts + 1 - hi, 0) + np.maximum(lo - counts - 1, 0) - viol
            )
            dv_sub = dv_sub_f[feat_of].sum(axis=1)  # [T] effect of c_t -= 1
            dv_add = dv_add_f[feat_of].sum(axis=1)  # [T] effect of c_t += 1
            # restrict to the worst violated features' member types — the
            # all-pairs matrix at T ≈ 800 is what made repair slow
            over = np.nonzero(counts > hi)[0]
            under = np.nonzero(counts < lo)[0]
            if len(over):
                worst = over[np.argmax(viol[over])]
                donors = np.nonzero((tf[:, worst] > 0) & (c > 0))[0]
            else:
                donors = np.nonzero(c > 0)[0]
            if len(under):
                worst = under[np.argmax(viol[under])]
                receivers = np.nonzero((tf[:, worst] > 0) & (c < msize))[0]
            else:
                receivers = np.nonzero(c < msize)[0]
            if len(donors) == 0 or len(receivers) == 0:
                return False
            # score the exact (donor, receiver) delta only on the most
            # promising 16 per side (per-type scores + random tie noise):
            # the full cross product over hundreds of types per pass was
            # the slicer's dominant cost at T ≈ 800, and the best swap
            # almost always lives among the top per-type scores
            if len(donors) > 16:
                donors = donors[
                    np.argsort(
                        dv_sub[donors] + pref_sub[donors] + tie.random(len(donors)) * 0.3
                    )[:16]
                ]
            if len(receivers) > 16:
                receivers = receivers[
                    np.argsort(
                        dv_add[receivers]
                        + pref_add[receivers]
                        + tie.random(len(receivers)) * 0.3
                    )[:16]
                ]
            delta = dv_sub[donors][:, None] + dv_add[receivers][None, :]
            # shared-feature correction: in a category where donor and
            # receiver have the same feature the move is a no-op there
            for ci in range(ncat):
                same = feat_of[donors, ci][:, None] == feat_of[receivers, ci][None, :]
                corr = (
                    dv_sub_f[feat_of[donors, ci]][:, None]
                    + dv_add_f[feat_of[receivers, ci]][None, :]
                )
                delta = delta - np.where(same, corr, 0)
            noisy = (
                delta
                + pref_sub[donors][:, None]
                + pref_add[receivers][None, :]
                + tie.random(delta.shape) * 0.3
            )
            di, ri = np.unravel_index(np.argmin(noisy), delta.shape)
            if delta[di, ri] >= 0:
                return False
            td, tr = donors[di], receivers[ri]
            c[td] -= 1
            c[tr] += 1
            counts += tf[tr] - tf[td]
        return bool(np.all(counts >= lo) and np.all(counts <= hi))

    from citizensassemblies_tpu_torch.solvers.native_oracle import repair_slice_native

    out: List[np.ndarray] = []
    # j0 shifts the per-type apportionment phase (see native slice_stream):
    # repair-free slices are pure functions of the apportionment, so tie
    # noise alone cannot diversify them between passes
    phase = (
        (j0 * 0.38196601125 + tidx * 0.61803398875) % 1.0
        if j0
        else np.zeros(T)
    )
    for j in range(1, R + 1):
        need = (j + phase) * x - assigned
        c = np.maximum(np.floor(need + 1e-12), 0.0).astype(np.int64)
        c = np.minimum(c, msize)
        gap = k - int(c.sum())
        counts = c @ tf
        if gap != 0:
            # top up (or trim) by residual fraction; a per-slice golden-ratio
            # jitter rotates exact ties. Two sweeps, the first quota-aware
            # (additions below hi / removals above lo only) — quota-blind
            # top-up left ~10-20 violations for the swap repair, which was
            # most of the slicer's cost. Mirrors the native stream exactly.
            frac = need - np.floor(need + 1e-12)
            jitter = ((tidx * 0.6180339887 + (j + j0) * 0.7548776662) % 1.0) * 1e-6
            frac = frac + jitter
            order = np.argsort(-frac) if gap > 0 else np.argsort(frac)
            for sweep in range(2):
                if gap == 0:
                    break
                for t in order:
                    if gap == 0:
                        break
                    feats = feat_of[t]
                    if gap > 0:
                        if c[t] >= msize[t]:
                            continue
                        if sweep == 0 and np.any(counts[feats] + 1 > hi[feats]):
                            continue
                        c[t] += 1
                        counts[feats] += 1
                        gap -= 1
                    else:
                        if c[t] <= 0:
                            continue
                        if sweep == 0 and np.any(counts[feats] - 1 < lo[feats]):
                            continue
                        c[t] -= 1
                        counts[feats] -= 1
                        gap += 1
        if gap != 0:
            assigned += c  # feed back even on drop, keeping the stream honest
            continue
        # the repair loop is the slicer's host hot spot (tens of passes per
        # slice of small-array work): the native C++ implementation runs the
        # identical scoring ~100× faster; the python path remains as the
        # fallback when the toolchain is unavailable
        c32 = np.ascontiguousarray(c, dtype=np.int32)
        cnt32 = np.ascontiguousarray(counts, dtype=np.int32)
        ok = repair_slice_native(
            reduction, c32, cnt32, need, seed=j + j0, max_passes=max_passes
        )
        if ok is None:
            ok = swap_repair(c, counts, j + j0, need)
        else:
            c[:] = c32
        assigned += c
        if ok:
            out.append(c.astype(np.int32))
    return out


@dataclasses.dataclass
class TypeCGResult:
    compositions: np.ndarray  # int32 [C, T] generated portfolio
    probabilities: np.ndarray  # float64 [C]
    type_values: np.ndarray  # float64 [T]
    coverable: np.ndarray  # bool [T]
    stages: int
    lp_solves: int
    exact_prices: int
    eps_dev: float = 0.0  # accepted downward deviation of the distribution


def _stage_lp(
    MT: np.ndarray,
    fixed: np.ndarray,
) -> Tuple[float, np.ndarray, float, np.ndarray]:
    """Maximize the minimum unfixed type value over the portfolio.

    Returns ``(z*, y, mu, p)`` where ``y ≥ 0`` are per-unfixed-type duals
    (Σy = 1), ``mu`` the normalization dual — a candidate composition ``c``
    improves the stage iff ``Σ_t ŷ_t c_t/m_t > −mu`` with ``ŷ`` the full dual
    vector (fixed types included).
    """
    T, C = MT.shape
    unfixed = np.nonzero(fixed < 0)[0]
    done = np.nonzero(fixed >= 0)[0]
    nu, nd = len(unfixed), len(done)
    A_ub = np.zeros((nu + nd, C + 1))
    A_ub[:nu, :C] = -MT[unfixed]
    A_ub[:nu, C] = 1.0
    b_ub = np.zeros(nu + nd)
    if nd:
        A_ub[nu:, :C] = -MT[done]
        b_ub[nu:] = -(fixed[done] - _SLACK)
    A_eq = np.ones((1, C + 1))
    A_eq[0, C] = 0.0
    c_obj = np.zeros(C + 1)
    c_obj[C] = -1.0
    # interior point, sparse: the master is maximally degenerate (hundreds of
    # near-active rows), where simplex crawls — the same reason the reference
    # forces Gurobi's barrier (leximin.py:325-327); interior duals also fix
    # larger tranches via strict complementarity
    A_ub_s = scipy.sparse.csr_matrix(A_ub)
    A_eq_s = scipy.sparse.csr_matrix(A_eq)
    res = robust_linprog(
        c_obj, A_ub=A_ub_s, b_ub=b_ub, A_eq=A_eq_s, b_eq=[1.0],
        bounds=[(0, None)] * C + [(None, None)], methods=("highs-ipm", "highs"),
    )
    if res.status != 0:
        raise RuntimeError(f"type-space stage LP failed: {res.message}")
    marg = -np.asarray(res.ineqlin.marginals)  # ≥ 0
    y_full = np.zeros(T)
    y_full[unfixed] = marg[:nu]
    if nd:
        y_full[done] = marg[nu:]
    mu = float(res.eqlin.marginals[0])
    return float(res.x[C]), y_full, mu, np.maximum(res.x[:C], 0.0)


def leximin_cg_typespace(
    dense,
    reduction: TypeReduction,
    cfg: Optional[Config] = None,
    log: Optional[RunLog] = None,
    device=None,
    checkpoint_path: Optional[str] = None,
) -> TypeCGResult:
    """LEXIMIN via the relaxation profile and one face decomposition (see
    the module docstring); ``device`` carries the decomposition masters.

    With ``checkpoint_path`` the seed columns, the relaxation targets and
    the coverable types are saved there before the face decomposition
    (``utils/checkpoint.TypeCGState``), and a matching checkpoint (same
    :func:`~citizensassemblies_tpu_torch.utils.checkpoint.problem_fingerprint`
    of ``dense`` and ``cfg``) skips the coverage and injection phases. The
    caller removes the file when the run is done."""
    from citizensassemblies_tpu_torch.utils import checkpoint as ckpt

    cfg = cfg or default_config()
    log = log or RunLog(echo=False)
    T = reduction.T
    msize = reduction.msize.astype(np.float64)
    oracle = CompositionOracle(reduction, log=log)

    comps: List[np.ndarray] = []
    seen: Dict[bytes, int] = {}

    def add_comp(c: np.ndarray) -> bool:
        kb = c.astype(np.int16).tobytes()
        if kb in seen:
            return False
        seen[kb] = len(comps)
        comps.append(c.astype(np.int32))
        return True

    # a checkpoint resume restores the seed columns and the certified targets
    # and skips the coverage and injection phases
    ckpt_fp = ""
    resumed = None
    if checkpoint_path is not None:
        ckpt_fp = ckpt.problem_fingerprint(dense, cfg)
        resumed = ckpt.load_ts_state(checkpoint_path, T, ckpt_fp)

    if resumed is None:
        # ---- seeding: relaxation-derived coverage --------------------------------
        # Fractional coverage (v_relax > 0) does NOT imply integer coverage: a
        # type can carry relaxation mass yet appear in no integer composition,
        # in which case the decomposition target is unrealizable. Certify every
        # type by integer evidence — membership in an aimed slice, or one exact
        # forced-inclusion MILP — and re-run the relaxation with proven-
        # uncoverable types pinned to x_t = 0.
        with log.timer("relax_leximin"):
            excluded = np.zeros(T, dtype=bool)
            # integer-coverage evidence persists across rounds: a forced-
            # inclusion MILP's verdict cannot change when more types get
            # excluded (excluding only shrinks the polytope for OTHERS, and
            # a witness composition never contains an excluded type), so
            # certified/refuted types are never re-solved
            int_certified = np.zeros(T, dtype=bool)
            int_refuted = np.zeros(T, dtype=bool)
            probe_solves = 0
            # exclusion grows monotonically, so the loop terminates; 8
            # rounds is a generous bound (rounds after the first mostly pay
            # only the T-var relaxation re-run — refuted types regaining
            # mass re-exclude WITHOUT new MILP solves)
            for _cov_round in range(8):
                v_relax, _ = _leximin_relaxation(
                    reduction, log, probe_tol=cfg.probe_tol,
                    exclude=excluded if excluded.any() else None,
                )
                frac_cov = v_relax > 1e-9
                # a refuted type that regained relaxation mass after other
                # exclusions re-routed it must be excluded too (its MILP
                # verdict is permanent)
                regained = int_refuted & frac_cov & ~excluded
                newly_uncoverable = list(np.nonzero(regained)[0].astype(int))
                # integer evidence from a cheap aimed-slice pass
                trial = _slice_relaxation(v_relax * msize, reduction, R=256)
                present = (
                    np.any(np.stack(trial) > 0, axis=0)
                    if trial
                    else np.zeros(T, dtype=bool)
                ) | int_certified
                for t in np.nonzero(~present & ~excluded & ~int_refuted)[0]:
                    if present[t]:
                        continue  # certified by an earlier probe's witness
                    got = oracle.maximize(np.zeros(T), forced_type=int(t))
                    probe_solves += 1
                    if got is None:
                        int_refuted[t] = True
                        if frac_cov[t]:
                            newly_uncoverable.append(int(t))
                    else:
                        add_comp(got[0])
                        # the witness composition certifies EVERY type it
                        # contains — marking them all cuts the probe count
                        # by about the composition's support on
                        # many-small-type pools such as sf_e-like
                        witness = got[0] > 0
                        present |= witness
                        int_certified |= witness
                if not newly_uncoverable:
                    break
                excluded[newly_uncoverable] = True
                log.emit(
                    f"Coverage round {_cov_round + 1}: "
                    f"{len(newly_uncoverable)} fractionally-covered type(s) "
                    "proven integer-uncoverable; re-running the relaxation "
                    "with them excluded."
                )
            else:
                # the round budget ended ON an exclusion: the target must
                # still be recomputed without the just-excluded mass or the
                # decomposition chases an unrealizable profile
                v_relax, _ = _leximin_relaxation(
                    reduction, log, probe_tol=cfg.probe_tol, exclude=excluded
                )
            # int-refuted types are never coverable regardless of the mass
            # the final relaxation left on them
            coverable = (present | (v_relax > 1e-9)) & ~excluded & ~int_refuted
            # the certification slices aim at the final target — keep them
            # as seed columns (the main injection below dedups against them)
            for c in trial:
                add_comp(c)
            log.emit(
                f"Coverage: {int(coverable.sum())}/{T} types coverable "
                f"(integer-certified; {probe_solves} probe solves)."
            )
    else:
        for c in resumed.compositions:
            add_comp(c)
        coverable = resumed.coverable.astype(bool)
        log.emit(
            f"Resumed type-space checkpoint: {len(comps)} compositions, round {resumed.round}."
        )

    if (~coverable).any():
        log.emit(f"{int((~coverable).sum())} type(s) in no feasible committee.")
    rng = np.random.default_rng(cfg.solver_seed)

    # ---- phase 1: leximin of the marginal relaxation + one decomposition ----
    if resumed is None:
        with log.timer("inject"):
            v_relax = np.where(coverable, v_relax, 0.0)
            # aim the column hull at the *target* marginal v·m — the mixture
            # the master must realize (M p = v ⇔ Σ p_c c = v·m). The last
            # stage's vertex optimum x_star is a poor proxy: its early-fixed
            # types sit above their floors, so slicing it leaves the master
            # dozens of correction rounds short of the actual target.
            x_target = v_relax * reduction.msize.astype(np.float64)
            injected = 0
            # R=1024 is the sweet spot for the first master: hd/obf-class
            # shapes certify on it directly, and when the round-0 master
            # misses (sf_d-class), the face loop's deep R=2048 pass (fresh
            # tie streams via j0) supplies the missing hull diversity at the
            # cost of one more master — cheaper than paying a deep stream
            # plus a large first master on every instance. Beyond ~1k types
            # the finer R=2048 stream pays for itself: the hull needs ~T
            # columns and repair-drop rates rise with the feature count
            # (the n=1200 household quotient, T=1199/F=626, keeps about a
            # third of 1024 slices and grinds many face rounds from ε=2e-2;
            # at R=2048 it keeps more slices than types and starts lower —
            # unlike a top-up of SEPARATE phase-shifted streams, one finer
            # stream also tightens the cumulative apportionment feedback to
            # ~1/2048)
            for c in _slice_relaxation(
                x_target, reduction, R=1024 if reduction.T <= 1024 else 2048
            ):
                injected += add_comp(c)
            # NOTE: topping the hull up with extra phase-shifted streams when
            # injected < T (household-quotient instances start
            # under-determined, ε ~ 2e-2) lowers the round-0 ε but does NOT
            # reduce the face-round count on the n=1200 couples, so the
            # injection stays single-stream; the ε tail there is integrality
            # structure, not hull bulk (same finding as the large-T deep-pass
            # experiment in face_decompose.py).
            if T <= 64:
                # independent roundings only help at small type counts — at
                # sf_e scale their quota-feasible yield is zero (measured)
                for c in _round_relaxation(x_target, reduction, rng, count=256):
                    injected += add_comp(c)
            log.emit(f"Injected {injected} aimed columns around the relaxation target.")
    else:
        v_relax = resumed.v_relax
    from citizensassemblies_tpu_torch.solvers.face_decompose import realize_profile

    with log.timer("decomp"):
        if checkpoint_path is not None and comps:
            # the stage CG's sampler is seeded from cfg.solver_seed, which the
            # fingerprint pins: the key records it as a [0, seed] pair
            ckpt.save_ts_state(checkpoint_path, ckpt.TypeCGState(
                compositions=np.stack(comps, axis=0), v_relax=v_relax, coverable=coverable,
                key=np.asarray([0, cfg.solver_seed], dtype=np.uint32), round=0,
                fingerprint=ckpt_fp,
            ))
        C_sup, probs, eps_dev, lp_solves = realize_profile(
            reduction,
            v_relax,
            list(comps),
            oracle,
            cfg.decomp_accept,
            log=log,
            max_rounds=cfg.decomp_max_rounds,
            cfg=cfg,
            device=device,
        )
    if eps_dev <= max(cfg.decomp_accept, cfg.decomp_accept_stalled):
        # the face loop targets decomp_accept; a stalled residual inside the
        # graded band is still accepted — the panel stage's tolerance is
        # coupled to eps_dev so the end-to-end contract holds
        # (models/leximin.py)
        band = " (stalled-band)" if eps_dev > cfg.decomp_accept else ""
        log.emit(
            f"Decomposition: profile realized, ε = {eps_dev:.2e} "
            f"(two-sided){band}, portfolio {len(C_sup)}."
        )
        return TypeCGResult(
            compositions=np.asarray(C_sup, dtype=np.int32),
            probabilities=probs / probs.sum(),
            type_values=v_relax,
            coverable=coverable,
            stages=0,
            lp_solves=lp_solves,
            exact_prices=0,
            eps_dev=eps_dev,
        )
    log.emit(
        f"Face decomposition stalled at ε = {eps_dev:.2e} "
        f"(integrality residual); falling back to stage CG."
    )
    # carry the certified support into the stage-CG portfolio
    for c in C_sup:
        add_comp(c)
    return _stage_cg(
        dense, reduction, cfg, log, oracle, comps, seen, add_comp, coverable, lp_solves, device,
    )


def _stage_cg(
    dense, reduction: TypeReduction, cfg: Config, log: RunLog, oracle, comps, seen, add_comp,
    coverable: np.ndarray, lp_solves: int, device,
) -> TypeCGResult:
    """Phase 2, the fallback after a stalled face loop: certified stage-wise
    column generation over compositions. Each stage maximizes the least
    unfixed type value over the portfolio (``lp_pdhg.solve_stage_lp_pdhg``
    on ``device`` when the backend routes there; the host IPM re-solves
    before any tranche is fixed), prices new compositions with the LEGACY
    sampler steered by the stage duals (a ``torch.Generator`` seeded with
    ``cfg.solver_seed``) and one exact MILP every iteration, and fixes a
    tranche by marginal probes once no composition beats the cap (or the
    stage reaches its relaxation bound)."""
    import torch

    from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch
    from citizensassemblies_tpu_torch.solvers.pricing import _pricing_scores
    from citizensassemblies_tpu_torch.utils import device as _device

    T = reduction.T
    msize = reduction.msize.astype(np.float64)
    type_id = reduction.type_id
    fixed = np.full(T, -1.0)
    fixed[~coverable] = 0.0
    stages = 0
    exact_prices = 0
    # device PDHG for the recurring stage LP on the accelerator (or forced
    # by backend="jax"); host HiGHS otherwise and as the fallback
    use_pdhg = cfg.backend == "jax" or (
        cfg.backend == "hybrid" and _device.on_accelerator(device)
    )
    generator = torch.Generator(device=dense.device).manual_seed(int(cfg.solver_seed))
    rng = np.random.default_rng(cfg.solver_seed)

    def panels_to_comps(panels: np.ndarray) -> np.ndarray:
        tids = type_id[panels]  # [B, k]
        B = panels.shape[0]
        out = np.zeros((B, T), dtype=np.int32)
        rows = np.repeat(np.arange(B), panels.shape[1])
        np.add.at(out, (rows, tids.ravel()), 1)
        return out

    def prune_columns(p_now: np.ndarray, keep_last: int = 4000) -> bool:
        """Column management: keep the LP support plus the freshest columns,
        only as a memory backstop (the threshold sits well above the
        portfolio a normal stage loop reaches). Returns True when columns
        were dropped (the caller must then discard any PDHG warm start)."""
        if len(comps) <= 12000:
            return False
        keep = set(np.nonzero(p_now > 1e-12)[0].tolist())
        keep.update(range(max(0, len(comps) - keep_last), len(comps)))
        kept = [comps[i] for i in sorted(keep)]
        comps.clear()
        seen.clear()
        for c in kept:
            add_comp(c)
        return True

    def fix_tranche(z: float, y: np.ndarray) -> int:
        """Fix a tranche at value ``z`` from authoritative stage duals:
        probe-certify the dual-proposed candidates on the marginal face
        (:func:`_marginal_probe_confirm`), keeping the reference's dual
        heuristic only as the progress guard. Mutates ``fixed``; returns
        the tranche size."""
        nonlocal fixed
        unfixed_idx = np.nonzero(fixed < 0)[0]
        cand = unfixed_idx[y[unfixed_idx] > cfg.eps]
        if len(cand) == 0:
            cand = unfixed_idx[[int(np.argmax(y[unfixed_idx]))]]
        conf = _marginal_probe_confirm(reduction, fixed, z, cand, cfg.probe_tol, log=log)
        newly = np.zeros(T, dtype=bool)
        newly[cand[conf]] = True
        if not newly.any():
            # nothing marginal-certifiable: the reference dual heuristic
            newly[unfixed_idx[np.argmax(y[unfixed_idx])]] = True
        fixed = np.where(newly, max(0.0, z - _FIX_MARGIN), fixed)
        return int(newly.sum())

    pdhg_warm = None
    while (fixed < 0).any():
        stages += 1
        # stage upper bound + targeted columns from the marginal LP relaxation
        with log.timer("relaxation"):
            z_ub, x_star = _relaxation_bound(reduction, fixed)
            injected = 0
            for c in _slice_relaxation(x_star, reduction, R=384):
                injected += add_comp(c)
            for c in _round_relaxation(x_star, reduction, rng):
                injected += add_comp(c)
        log.emit(
            f"Stage {stages}: relaxation bound {z_ub:.6f}, injected {injected} "
            f"aimed columns (portfolio {len(comps)})."
        )
        while True:
            M = np.stack(comps, axis=0).astype(np.float64) / msize[None, :]
            MT = np.ascontiguousarray(M.T)
            with log.timer("stage_lp"):
                # loose-tolerance device PDHG guides pricing; any fixing
                # decision below re-solves on the host IPM first
                authoritative = not use_pdhg
                if use_pdhg:
                    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_stage_lp_pdhg

                    z, y, mu, probs, ok, pdhg_warm = solve_stage_lp_pdhg(
                        MT, fixed, cfg=cfg, warm=pdhg_warm, device=device, log=log
                    )
                    log.count("stage_lp_pdhg")
                    if not ok:
                        z, y, mu, probs = _stage_lp(MT, fixed)
                        log.count("stage_lp_host")
                        pdhg_warm = None
                        authoritative = True
                else:
                    z, y, mu, probs = _stage_lp(MT, fixed)
                    log.count("stage_lp_host")
            lp_solves += 1
            if prune_columns(probs):
                pdhg_warm = None
            bound_tol = max(1e-7, 10 * _SLACK)
            if z >= z_ub - bound_tol:
                if not authoritative:
                    # the PDHG estimate may overshoot the bound: re-check
                    # with the authoritative solve
                    with log.timer("stage_lp"):
                        z, y, mu, probs = _stage_lp(MT, fixed)
                    log.count("stage_lp_host")
                    lp_solves += 1
                    authoritative = True
                if z >= z_ub - bound_tol:
                    # the master reached the relaxation bound: certified
                    # stage optimum, no exact pricing needed
                    count = fix_tranche(z, y)
                    log.emit(
                        f"Stage {stages}: z={z:.6f} meets relaxation bound — fixed "
                        f"{count} type(s) ({int((fixed >= 0).sum())}/{T} done)."
                    )
                    break
            w_type = y / msize  # pricing weights per type
            # stochastic pricing: weight-steered batched panel draw
            with log.timer("stochastic_pricing"):
                w_agents = torch.as_tensor(w_type[type_id], dtype=torch.float32, device=dense.device)
                scores = _pricing_scores(w_agents, cfg.pricing_batch)
                panels, ok_t = sample_panels_batch(
                    dense, generator, cfg.pricing_batch, scores=scores, cfg=cfg
                )
                panels_np = panels.cpu().numpy()
                cand = panels_to_comps(panels_np[ok_t.cpu().numpy()])
            values = cand.astype(np.float64) @ w_type
            order = np.argsort(-values)
            added = 0
            for i in order:
                if values[i] <= -mu + cfg.eps:
                    break
                if add_comp(cand[i]):
                    added += 1
                    if added >= cfg.cg_columns_typespace:
                        break
            # exact pricing every iteration (the reference's loop shape): its
            # column is the single most violated constraint
            with log.timer("exact_oracle"):
                got = oracle.maximize(w_type)
            exact_prices += 1
            if got is None:
                raise RuntimeError("the stage-CG pricing MILP must stay feasible")
            best_comp, value = got
            if value > -mu + cfg.eps and add_comp(best_comp):
                added += 1
            log.emit(
                f"  stage {stages} iter {lp_solves}: z={z:.6f} cap={-mu:.6f} "
                f"exact_best={value:.6f} "
                f"best_sampled={values[order[0]] if len(values) else float('nan'):.6f} "
                f"added {added} (portfolio {len(comps)})."
            )
            if added:
                continue
            log.emit(
                f"Stage {stages}: maximin ≤ {z + max(0.0, value + mu):.4%}, can do "
                f"{z:.4%} with {len(comps)} compositions (gap {value + mu:.2e})."
            )
            if value <= -mu + cfg.eps or not add_comp(best_comp):
                # converged (no composition beats the cap — or the exact
                # oracle repeated a known column)
                if not authoritative:
                    with log.timer("stage_lp"):
                        z, y, mu, probs = _stage_lp(MT, fixed)
                    log.count("stage_lp_host")
                    lp_solves += 1
                    pdhg_warm = None
                    # the certificate above priced against PDHG duals:
                    # re-price once against the authoritative optimum
                    with log.timer("exact_oracle"):
                        got = oracle.maximize(y / msize)
                    exact_prices += 1
                    if got is not None:
                        best_comp, value = got
                        if value > -mu + cfg.eps and add_comp(best_comp):
                            log.emit(
                                f"  stage {stages}: authoritative duals still "
                                f"price an improving column (gap "
                                f"{value + mu:.2e}); continuing."
                            )
                            continue
                count = fix_tranche(z, y)
                log.emit(
                    f"Fixed {count} type(s) "
                    f"({int((fixed >= 0).sum())}/{T} done)."
                )
                break

    C = np.stack(comps, axis=0)
    # final probabilities over the generated portfolio realizing the fixed
    # values (the caller decomposes into concrete panels)
    MT = np.ascontiguousarray((C.astype(np.float64) / msize[None, :]).T)
    A_ub = np.concatenate([-MT, -np.ones((T, 1))], axis=1)
    b_ub = -(fixed - _SLACK)
    A_eq = np.ones((1, C.shape[0] + 1))
    A_eq[0, -1] = 0.0
    c_obj = np.zeros(C.shape[0] + 1)
    c_obj[-1] = 1.0
    res = robust_linprog(
        c_obj, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=[1.0],
        bounds=[(0, None)] * C.shape[0] + [(0, None)],
    )
    lp_solves += 1
    if res.status != 0:
        raise RuntimeError(f"type-space final LP failed: {res.message}")
    probs = np.maximum(res.x[: C.shape[0]], 0.0)
    probs = probs / probs.sum()
    log.gauge("stage_cg_stages", stages)
    return TypeCGResult(
        compositions=C,
        probabilities=probs,
        type_values=fixed,
        coverable=coverable,
        stages=stages,
        lp_solves=lp_solves,
        exact_prices=exact_prices,
    )
