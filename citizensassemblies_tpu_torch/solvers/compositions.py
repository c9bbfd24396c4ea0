"""Exact LEXIMIN in type space: enumerate feasible committee *compositions*.

Agents with identical feature rows are interchangeable: quota feasibility of a
committee depends only on how many members of each *type* it contains (the
type reduction of ``solvers/native_oracle.py``), and the leximin-optimal
allocation — the unique leximin point of the convex allocation polytope — is
therefore symmetric within types. So for instances with few distinct types the
entire problem collapses:

* a committee is a **composition** ``c ∈ Z^T`` with ``Σc = k``,
  ``0 ≤ c_t ≤ m_t`` and per-feature quota constraints;
* a distribution over committees induces the per-agent allocation
  ``π_i = Σ_c p_c · c_t(i)/m_t(i)`` (members drawn uniformly within types);
* leximin over n agents reduces to leximin over T type values with
  multiplicities.

The reference's headline benchmark instances are extreme cases:
``example_large_200`` (n=2000, reference runtime 1161.8 s,
``reference_output/example_large_200_statistics.txt:15``) has **3** distinct
types, ``example_small_20`` (2.7 s) has **4**. Enumerating every feasible
composition and running the leximin stage LPs over the full enumeration is
exact, deterministic, and takes milliseconds — replacing the reference's
column generation (``leximin.py:338-470``) outright for such instances. The
stage fixing here is *certified*: dual weights propose the tranche
(strict complementarity, as in ``leximin.py:431-443``) and per-type probe LPs
confirm every remaining candidate, so no tranche is ever fixed prematurely
(the reference trusts the ``y > EPS`` heuristic alone).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from citizensassemblies_tpu_torch.solvers.lp_util import ALLOWANCE_CAP, probe_confirm_tranche
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.utils.device import resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog


def enumerate_compositions(
    reduction: TypeReduction,
    cap: int = 200_000,
    node_budget: int = 3_000_000,
) -> Optional[np.ndarray]:
    """All feasible compositions ``c`` (int32 [C, T]), or None if more than
    ``cap`` exist / the search exceeds ``node_budget`` nodes.

    Feasibility: ``Σc = k``, ``0 ≤ c_t ≤ m_t`` and for every feature f
    ``lo_f ≤ Σ_{t: f ∈ t} c_t ≤ hi_f`` (the committee constraints of
    ``leximin.py:201-209`` collapsed onto types).
    """
    T = reduction.T
    F = reduction.F
    k = reduction.k
    msize = reduction.msize
    lo = reduction.qmin.astype(np.int64)
    hi = reduction.qmax.astype(np.int64)
    # per-type one-hot feature incidence [T, F]
    tf = np.zeros((T, F), dtype=np.int64)
    for t in range(T):
        tf[t, reduction.type_feature[t]] = 1
    # suffix capacity per feature: how many members types >= i can still add
    suffix = np.zeros((T + 1, F), dtype=np.int64)
    for i in range(T - 1, -1, -1):
        suffix[i] = suffix[i + 1] + tf[i] * int(msize[i])
    suffix_total = np.zeros(T + 1, dtype=np.int64)
    for i in range(T - 1, -1, -1):
        suffix_total[i] = suffix_total[i + 1] + int(msize[i])

    out: List[np.ndarray] = []
    counts = np.zeros(F, dtype=np.int64)
    cur = np.zeros(T, dtype=np.int32)
    nodes = 0

    def rec(i: int, total: int) -> bool:
        nonlocal nodes
        nodes += 1
        if nodes > node_budget:
            return False
        if i == T:
            if total == k and np.all(counts >= lo) and np.all(counts <= hi):
                out.append(cur.copy())
                if len(out) > cap:
                    return False
            return True
        # prune: total members still reachable
        if total + suffix_total[i] < k or total > k:
            return True
        # prune: every feature must stay satisfiable
        if np.any(counts > hi) or np.any(counts + suffix[i] < lo):
            return True
        row = reduction.type_feature[i]
        for c in range(min(int(msize[i]), k - total), -1, -1):
            cur[i] = c
            counts[row] += c
            ok = rec(i + 1, total + c)
            counts[row] -= c
            cur[i] = 0
            if not ok:
                return False
        return True

    if not rec(0, 0) or len(out) > cap:
        return None
    if not out:
        return np.zeros((0, T), dtype=np.int32)
    return np.stack(out, axis=0)


@dataclasses.dataclass
class StageCert:
    """Dual certificate of one leximin stage, captured for graftdelta
    (``solvers/delta.py``): enough to decide, after a registry edit, whether
    the stage's optimal face can have changed — and to resume the ladder
    from exactly this point when it has."""

    z: float  # stage value (the min the stage maximized)
    y: np.ndarray  # float64 [T] dual weights scattered over ALL types
    mu: float  # max column price max_c Σ_t y_t·c_t/m_t (the support price)
    fixed_after: np.ndarray  # float64 [T] fixed vector AFTER the stage (-1 ⇒ open)


@dataclasses.dataclass
class TypeLeximin:
    """Result of the enumerated type-space leximin solve."""

    compositions: np.ndarray  # int32 [C, T], the full feasible enumeration
    probabilities: np.ndarray  # float64 [C] final distribution over compositions
    type_values: np.ndarray  # float64 [T] leximin value per type
    eps_dev: float  # max downward deviation of the final distribution
    stages: int
    lp_solves: int
    #: per-stage dual certificates, present only when the caller asked for
    #: them (``capture_certs=True``) — the delta solver's re-pricing basis
    stage_certs: Optional[List[StageCert]] = None


_SLACK = 1e-9  # constraint slack absorbing LP solver round-off


def _linprog(c, A_ub, b_ub, A_eq, b_eq, bounds):
    from citizensassemblies_tpu_torch.solvers.lp_util import robust_linprog

    return robust_linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds)


#: prescreen size guard: beyond this many columns a probe-fleet bucket
#: holds tens of MB per lane, and the host LPs win
_SCREEN_MAX_COLS = 32_768


def _batched_probe_prescreen(
    objectives: np.ndarray,
    A_face: np.ndarray,
    b_face: np.ndarray,
    z: float,
    probe_tol: float,
    allowances: np.ndarray,
    cfg,
    log: Optional[RunLog] = None,
    device=None,
) -> Optional[np.ndarray]:
    """Device prescreen of a probe-candidate fleet: witness clearly-loose
    candidates in one call of the batched LP engine (``solvers/batch_lp.py``).

    Every candidate's face LP (``max objectives[i]·x`` over the stage's
    optimal face) is solved approximately on ``device``; a candidate is
    marked loose only when its approximate optimizer, clipped, renormalized
    and re-validated **in float64 against the exact face constraints**,
    attains a value strictly above the certificate bound ``z + probe_tol +
    allowance`` — the same witness-elimination evidence the host scheme
    trusts (``lp_util.probe_confirm_tranche``): a feasible face point above
    the bound proves the host probe could never confirm the candidate.
    Candidates the screen cannot witness keep their float64 host confirm —
    the screen only ever REDUCES the host-LP count, never certifies.
    Returns the bool mask, or ``None`` when the screen is disabled or out
    of its size envelope.
    """
    from citizensassemblies_tpu_torch.solvers.batch_lp import (
        face_probe_batch_lp,
        lp_batch_enabled,
        solve_lp_batch,
    )

    if cfg is None or not cfg.lp_batch_screen:
        return None
    device = resolve_device(device)
    if not lp_batch_enabled(cfg, device):
        return None
    n_cand = len(objectives)
    if n_cand < 2 or A_face.shape[1] > _SCREEN_MAX_COLS:
        return None
    insts = [
        face_probe_batch_lp(objectives[i], A_face, b_face, tol=1e-6)
        for i in range(n_cand)
    ]
    sols = solve_lp_batch(insts, cfg=cfg, log=log, max_iters=8_192, device=device)
    loose = np.zeros(n_cand, dtype=bool)
    for i, sol in enumerate(sols):
        x = np.maximum(np.asarray(sol.x, dtype=np.float64), 0.0)
        total = x.sum()
        if not np.isfinite(total) or total <= 0.0:
            continue
        x = x / total
        # strict float64 feasibility on the SAME face the host probes use
        # (b_face already carries the probe scheme's slack): only a genuine
        # face point may witness looseness
        if not (A_face @ x <= b_face).all():
            continue
        if float(objectives[i] @ x) > z + probe_tol + float(allowances[i]) + 1e-9:
            loose[i] = True
    if log is not None:
        log.count("lp_batch_probe_screened", n_cand)
        if loose.any():
            log.count("lp_batch_probe_pruned", int(loose.sum()))
    return loose


def leximin_over_compositions(
    comps: np.ndarray,
    msize: np.ndarray,
    probe_tol: float = 1e-7,
    log: Optional[RunLog] = None,
    cfg=None,
    fixed_init: Optional[np.ndarray] = None,
    capture_certs: bool = False,
    device=None,
) -> TypeLeximin:
    """Exact leximin over the full composition enumeration.

    Runs the reference's outer fixing loop (``leximin.py:383-449``) with the
    portfolio replaced by *every* feasible composition, so no pricing is ever
    needed: each stage is one LP (max the min unfixed type value), and the
    final stage recovers composition probabilities minimizing the max downward
    deviation ε (``leximin.py:453-464``).

    Every fixed tranche is **probe-certified** against the stage's optimal
    face: the dual-proposed candidates (``y > 0`` at a vertex optimum proves
    tightness only at that one optimum) are confirmed by one group LP — if
    ``max Σ_cand M_t·p`` over the face equals ``|cand|·z``, no candidate can
    exceed ``z`` at any optimum — with per-candidate probes on disagreement;
    the remaining near-zero-dual types are probed individually to catch
    degenerately tight ones. The reference trusts the ``y > EPS`` heuristic
    alone (``leximin.py:431-443``); here no tranche is ever fixed prematurely.

    With the batched LP engine on (``cfg.lp_batch`` resolved for
    ``device``, and ``cfg.lp_batch_screen``) the probe-candidate fleet is
    first prescreened in one call of the batched LP engine on the device
    (:func:`_batched_probe_prescreen`): candidates witnessed loose at a
    float64-validated face point skip their host LPs. The screen never
    certifies, so the certification contract is unchanged.

    ``fixed_init`` warm-starts the fixing ladder: entries ≥ 0 are taken as
    already-fixed type values (a prefix of a previous solve's trajectory,
    graftdelta's resume point), ``-1`` entries stay open — ``None`` is
    identical to the all-open default. ``capture_certs=True`` additionally
    records a :class:`StageCert` per stage on the result.
    """
    log = log or RunLog(echo=False)
    C, T = comps.shape
    M = comps.astype(np.float64) / np.asarray(msize, dtype=np.float64)[None, :]
    MT = np.ascontiguousarray(M.T)  # [T, C]
    if fixed_init is not None:
        fixed = np.asarray(fixed_init, dtype=np.float64).copy()
        if fixed.shape != (T,):
            raise ValueError(f"fixed_init must be float [{T}]")
    else:
        fixed = np.full(T, -1.0)
    coverable = comps.max(axis=0) > 0 if C else np.zeros(T, dtype=bool)
    fixed[~coverable & (fixed < 0)] = 0.0
    certs: List[StageCert] = [] if capture_certs else None
    if (~coverable).any():
        log.emit(
            f"{int((~coverable).sum())} type(s) appear in no feasible committee; "
            f"their probability is 0."
        )
    stages = 0
    lp_solves = 0

    while (fixed < 0).any():
        stages += 1
        unfixed = np.nonzero(fixed < 0)[0]
        done = np.nonzero(fixed >= 0)[0]
        # stage LP over x = [p (C), z]: max z
        #   s.t. -M_t·p + z ≤ 0        (t unfixed)
        #        -M_t·p     ≤ -f_t + slack  (t fixed)
        #        Σp = 1, p ≥ 0
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
        bounds = [(0, None)] * C + [(None, None)]
        res = _linprog(c_obj, A_ub, b_ub, A_eq, [1.0], bounds)
        lp_solves += 1
        if res.status != 0:
            raise RuntimeError(f"type-space stage LP failed: {res.message}")
        z = float(res.x[C])
        y = -np.asarray(res.ineqlin.marginals[:nu])  # dual weights, ≥ 0

        # optimal-face constraints, hoisted: every unfixed type ≥ z, fixed ≥ f
        # (only the probe objective row changes per candidate)
        A_p = np.concatenate([-MT[unfixed], -MT[done]], axis=0) if nd else -MT[unfixed]
        b_p = np.concatenate(
            [np.full(nu, -(z - _SLACK)), -(fixed[done] - _SLACK)]
        ) if nd else np.full(nu, -(z - _SLACK))
        A_eq_p = np.ones((1, C))
        bounds_p = [(0, None)] * C

        def _face_max_over(rhs):
            def fm(obj_rows: np.ndarray):
                nonlocal lp_solves
                r = _linprog(-obj_rows, A_p, rhs, A_eq_p, [1.0], bounds_p)
                lp_solves += 1
                if r.status == 0:
                    return float(-r.fun), np.asarray(r.x)
                # infeasible vs failed — no optimizer either way
                return (-np.inf, None) if r.status == 2 else (None, None)
            return fm

        face_max = _face_max_over(b_p)
        # retry probe for objective-specific infeasible reports: floors 10×
        # looser — a superset face, so its optimum is a valid upper bound
        face_max_relaxed = _face_max_over(b_p + 9.0 * _SLACK)

        # tranche candidates from the duals, probe-certified via the shared
        # group-then-individual scheme (lp_util.probe_confirm_tranche). The
        # face floors are each relaxed by _SLACK in normalized units — i.e.
        # _SLACK·m_u raw members — and at most that freed mass can be
        # re-routed into a candidate, so tightness is judged up to
        # _SLACK·Σm/m_t or genuinely tight types probe "loose" on large pools
        msz = np.asarray(msize, dtype=np.float64)
        slack_gain = _SLACK * float(msz.sum())
        tranche = np.zeros(nu, dtype=bool)
        cand = np.nonzero(y > 1e-9)[0]
        # near-zero dual weight can still be degenerately tight everywhere —
        # but a type already above z at *this* optimum provably is not, so
        # only the ones sitting at z need a probe
        vals = MT[unfixed] @ np.maximum(res.x[:C], 0.0)
        singles = np.nonzero((y <= 1e-9) & (vals <= z + probe_tol))[0]
        # device prescreen of the whole candidate fleet (dual-proposed and
        # near-zero-dual) as one batched solve: witnessed-loose members skip
        # their host LPs; everyone else keeps the float64 confirm
        pre_cand = pre_singles = None
        if len(cand) + len(singles) >= 2:
            fleet = np.concatenate([cand, singles]).astype(np.int64)
            allow_fleet = np.minimum(slack_gain / msz[unfixed[fleet]], ALLOWANCE_CAP)
            loose_mask = _batched_probe_prescreen(
                MT[unfixed[fleet]], A_p, b_p, z, probe_tol, allow_fleet,
                cfg, log=log, device=device,
            )
            if loose_mask is not None:
                pre_cand = loose_mask[: len(cand)]
                pre_singles = loose_mask[len(cand) :]
        if len(cand):
            conf = probe_confirm_tranche(
                face_max, MT[unfixed[cand]], z, probe_tol,
                slack_gain / msz[unfixed[cand]],
                term_deficit=_SLACK, log=log.emit,
                face_max_relaxed=face_max_relaxed,
                presumed_loose=pre_cand,
            )
            tranche[cand[conf]] = True
        for jj, j in enumerate(singles):
            if pre_singles is not None and pre_singles[jj]:
                continue  # witnessed loose on the device: the host LP is waste
            if probe_confirm_tranche(
                face_max, MT[unfixed[j]][None, :], z, probe_tol,
                np.array([slack_gain / float(msz[unfixed[j]])]),
                term_deficit=_SLACK, log=log.emit,
                face_max_relaxed=face_max_relaxed,
            )[0]:
                tranche[j] = True
        if not tranche.any():
            tranche[np.argmax(y)] = True  # progress guard
        fixed[unfixed[tranche]] = max(0.0, z)
        if capture_certs:
            marg = -np.asarray(res.ineqlin.marginals, dtype=np.float64)
            y_full = np.zeros(T)
            y_full[unfixed] = marg[:nu]
            if nd:
                y_full[done] = marg[nu:]
            prices = M @ y_full
            certs.append(
                StageCert(
                    z=z,
                    y=y_full,
                    mu=float(prices.max()) if C else 0.0,
                    fixed_after=fixed.copy(),
                )
            )
        log.emit(
            f"Stage {stages}: value {z:.6f}, fixed {int(tranche.sum())} type(s), "
            f"{int((fixed >= 0).sum())}/{T} done."
        )

    # final LP: min ε s.t. M_t·p ≥ f_t − ε ∀t, Σp = 1 (leximin.py:453-464)
    A_ub = np.concatenate([-MT, -np.ones((T, 1))], axis=1)
    b_ub = -(fixed - _SLACK)
    A_eq = np.ones((1, C + 1))
    A_eq[0, C] = 0.0
    c_obj = np.zeros(C + 1)
    c_obj[C] = 1.0
    res = _linprog(c_obj, A_ub, b_ub, A_eq, [1.0], [(0, None)] * C + [(0, None)])
    lp_solves += 1
    if res.status != 0:
        raise RuntimeError(f"type-space final LP failed: {res.message}")
    probs = np.maximum(res.x[:C], 0.0)
    probs = probs / probs.sum()
    return TypeLeximin(
        compositions=comps,
        probabilities=probs,
        type_values=fixed,
        eps_dev=float(res.x[C]),
        stages=stages,
        lp_solves=lp_solves,
        stage_certs=certs,
    )


class HouseholdPickError(ValueError):
    """A household-disjoint pick found fewer distinct households than a
    composition's duty count: the compositions violate the quotient's class
    caps."""


def _household_disjoint_pick(
    scores: np.ndarray,
    rot: np.ndarray,
    houses: np.ndarray,
    ct: int,
    used: set,
) -> np.ndarray:
    """Indices of ``ct`` members maximizing ``scores`` (ties broken by
    ``rot``) whose households are distinct from each other and from ``used``;
    marks the chosen households used.

    Conflicts only arise within one household class (a household's members
    all carry the class in their augmented feature row — see
    ``solvers/quotient.py``), and the class-cap quota row keeps the class's
    total duty count at most its household count, so this greedy always
    finds ``ct`` members: every class-``c`` orbit has a member in each of
    the class's ``m_c`` households.
    """
    order = np.lexsort((rot, -scores))
    picked: List[int] = []
    for j in order:
        h = int(houses[j])
        if h in used:
            continue
        used.add(h)
        picked.append(int(j))
        if len(picked) == ct:
            break
    if len(picked) < ct:
        # the input contract (class-cap quota rows) is violated; failing
        # loudly beats emitting an undersized panel that would enter the
        # distribution with positive probability
        raise HouseholdPickError(
            f"household-disjoint pick infeasible: needed {ct} members but "
            f"only {len(picked)} households available — compositions violate "
            "the quotient's class caps"
        )
    return np.asarray(picked, dtype=np.int64)


def greedy_decompose(
    comps: np.ndarray,
    probs: np.ndarray,
    reduction: TypeReduction,
    targets: np.ndarray,
    support_eps: float = 1e-11,
    max_panels: int = 16_384,
    households: Optional[np.ndarray] = None,
    delta_cap: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Water-filling decomposition of a composition distribution into panels.

    Serves each composition's probability mass in slices; every slice's panel
    takes, per type, the ``c_t`` members with the largest remaining need
    (need = target probability not yet realized), ties rotated by a per-type
    cursor so equal-need members are cycled fairly. The slice probability is
    the largest step that overshoots no member. Exact up to float rounding on
    most instances (the caller verifies and LP-polishes any residual);
    portfolio size is typically O(Σ_t m_t/c_t) per support composition.

    With ``households`` (int[n] group ids, on a household-quotient reduction —
    ``solvers/quotient.py``), each slice's picks are also household-disjoint,
    so every emitted panel honors the ≤1-per-household constraint exactly
    (reference ``leximin.py:211-221``).

    ``delta_cap`` (> 0) bounds each slice's probability mass: when the
    mixture is a *basic* LP solution (sparse support, e.g. from an exact
    host master), the natural need-driven steps are too coarse to mix
    members — on a nexus-shaped instance (k/n ≈ 0.5) the uncapped greedy
    leaves a 7e-3 residual that costs ~18 host-LP pricing rounds to polish,
    while capping at ~tol yields residual ≈ 0.4·cap with no LP at all.
    """
    sel = probs > support_eps
    comps = comps[sel]
    p = probs[sel].astype(np.float64)
    p = p / p.sum()
    n = reduction.n
    T = reduction.T
    msize = reduction.msize
    members = reduction.members

    # serve compositions largest-first so late slices retain mixing freedom
    order = np.argsort(-p)

    # the slice loop is the host hot path (~90k per-type partial sorts on a
    # nexus_170-shaped instance); the native slicer runs the identical
    # algorithm ~100× faster, with the Python loop below as the reference
    # implementation and fallback
    from citizensassemblies_tpu_torch.solvers.native_oracle import (
        greedy_decompose_native,
    )

    per_type_need = np.array(
        [targets[members[t][0]] if len(members[t]) else 0.0 for t in range(T)]
    )
    got = greedy_decompose_native(
        reduction, comps[order], p[order], per_type_need,
        max_panels, households=households, delta_cap=delta_cap,
    )
    if got is not None:
        return got

    house_of = (
        [households[members[t]] for t in range(T)] if households is not None else None
    )
    needs = [np.full(int(msize[t]), 0.0) for t in range(T)]
    for t in range(T):
        needs[t][:] = targets[members[t][0]] if len(members[t]) else 0.0
    cursors = np.zeros(T, dtype=np.int64)
    panels: List[np.ndarray] = []
    pprobs: List[float] = []
    for s in order:
        c = comps[s]
        rho = float(p[s])
        while rho > 1e-12 and len(panels) < max_panels:
            row = np.zeros(n, dtype=bool)
            delta = min(rho, delta_cap) if delta_cap > 0 else rho
            chosen: List[Tuple[int, np.ndarray]] = []
            used_houses: set = set()
            for t in range(T):
                ct, mt = int(c[t]), int(msize[t])
                if not ct:
                    continue
                rot = (np.arange(mt) - cursors[t]) % mt
                if house_of is None:
                    idx = np.lexsort((rot, -needs[t]))[:ct]
                else:
                    idx = _household_disjoint_pick(needs[t], rot, house_of[t], ct, used_houses)
                chosen.append((t, idx))
                m = float(needs[t][idx].min())
                if m > 1e-15:
                    delta = min(delta, m)
            if delta <= 1e-15:
                # forced overshoot; the LP polish absorbs it
                delta = min(rho, delta_cap) if delta_cap > 0 else rho
            for t, idx in chosen:
                row[members[t][idx]] = True
                needs[t][idx] -= delta
                cursors[t] = (cursors[t] + int(c[t])) % max(int(msize[t]), 1)
            panels.append(row)
            pprobs.append(delta)
            rho -= delta
    return np.stack(panels, axis=0), np.asarray(pprobs, dtype=np.float64)


def decompose_with_pricing(
    comps: np.ndarray,
    probs: np.ndarray,
    reduction: TypeReduction,
    targets: np.ndarray,
    budget: int = 16_384,
    support_eps: float = 1e-11,
    max_rounds: int = 200,
    log: Optional[RunLog] = None,
    tol: float = 1e-9,
    households: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Exact panel decomposition of a composition distribution.

    ``budget`` bounds the panel portfolio the greedy water-filling seed may
    emit; any mass it could not serve within the budget is recovered by the
    pricing LP loop below.

    Finds concrete panels and probabilities whose per-agent allocation matches
    ``targets`` up to LP tolerance, via column generation on the final LP
    (min ε s.t. ``Pᵀp ≥ targets − ε``, ``Σp = 1``) with **closed-form
    pricing**: the best panel for dual weights ``y`` within a feasible
    composition ``c`` simply takes each type's ``c_t`` highest-weight members,
    so pricing over the full enumeration is one prefix-sum lookup per
    composition — no ILP, unlike the reference's committee pricing
    (``leximin.py:420-424``). An exact decomposition always exists (uniform
    within-type selection is a finite convex combination of concrete panels),
    so ε converges to ~0. Returns ``(panels bool [R, n], probs, ε)``.

    With ``households`` every emitted panel is household-disjoint; the
    prefix-sum pricing value then upper-bounds the realized column's value
    (the disjoint pick may have to skip a top member), so a stall guard
    breaks the loop when ε stops improving instead of trusting the estimate.
    """
    log = log or RunLog(echo=False)
    n = reduction.n
    T = reduction.T
    members = reduction.members
    maxm = reduction.maxm

    # seed: greedy water-filling decomposition — usually already within
    # tolerance, in which case no LP runs at all
    tol = max(tol, 1e-9)
    P0, q0 = greedy_decompose(
        comps, probs, reduction, targets, support_eps=support_eps,
        max_panels=budget, households=households,
    )
    total = q0.sum()
    if abs(total - 1.0) < tol:
        # two-sided: overshoot counts too — mass conservation means a small
        # one-sided deficit can fund a concentrated overshoot elsewhere
        dev = float(np.max(np.abs(targets - P0.T.astype(np.float64) @ q0)))
        if dev <= tol:
            return P0, q0 / total, max(dev, 0.0)
        if tol >= 4e-5:
            # coarse-slice failure mode (sparse basic mixtures at high k/n):
            # retry once with capped slices — the cap equidistributes
            # members (measured residual ≈ 0.4·cap), trading a larger
            # portfolio for skipping the LP pricing loop entirely
            P1, q1 = greedy_decompose(
                comps, probs, reduction, targets, support_eps=support_eps,
                max_panels=budget, households=households,
                delta_cap=1.5 * tol,
            )
            t1 = q1.sum()
            if abs(t1 - 1.0) < tol:
                dev1 = float(
                    np.max(np.abs(targets - P1.T.astype(np.float64) @ q1))
                )
                if dev1 <= tol:
                    return P1, q1 / t1, max(dev1, 0.0)
                if dev1 < dev:
                    P0, q0, dev = P1, q1, dev1
    rows: List[np.ndarray] = [r for r in P0]
    seen = {r.tobytes() for r in rows}

    from citizensassemblies_tpu_torch.solvers.highs_backend import solve_final_primal_lp_duals

    add_per_round = 256  # closed-form pricing is ~free; bigger rounds cut
    # the number of host LP solves, which are the loop's whole cost (64 made
    # a nexus-class polish pay ~18 LP rounds for ~1150 columns)
    p = None
    eps_dev = 1.0
    best_eps = np.inf
    stalled = 0
    for _ in range(max_rounds):
        P = np.stack(rows, axis=0)
        p, eps_dev, y, mu = solve_final_primal_lp_duals(P, targets)
        if eps_dev <= tol:
            break
        if households is not None:
            # the pricing estimate below only bounds a household-disjoint
            # column's value from above: stop when realized columns no
            # longer move ε rather than loop on a phantom improvement
            if eps_dev > best_eps - 1e-12:
                stalled += 1
                if stalled >= 8:
                    break
            else:
                best_eps, stalled = eps_dev, 0
        # price: value(c) = Σ_t (sum of the c_t largest y within type t)
        prefix = np.zeros((T, maxm + 1))
        tops: List[np.ndarray] = []
        for t in range(T):
            order = members[t][np.argsort(-y[members[t]], kind="stable")]
            tops.append(order)
            prefix[t, 1 : len(order) + 1] = np.cumsum(y[order])
        values = prefix[np.arange(T)[None, :], comps].sum(axis=1)  # [C]
        cand = np.argsort(-values)[: add_per_round]
        cand = cand[values[cand] > -mu + 1e-10]
        if len(cand) == 0:
            break  # no improving panel exists anywhere: ε is optimal
        added = 0
        for ci in cand:
            row = np.zeros(n, dtype=bool)
            if households is None:
                for t in range(T):
                    ct = int(comps[ci, t])
                    if ct:
                        row[tops[t][:ct]] = True
            elif not _household_disjoint_row(row, comps[ci], tops, households):
                continue  # never add an undersized panel
            kb = row.tobytes()
            if kb not in seen:
                seen.add(kb)
                rows.append(row)
                added += 1
        if added == 0:
            break  # numerically stalled
        p = None
    if p is None or len(p) != len(rows):
        P = np.stack(rows, axis=0)
        p, eps_dev, _, _ = solve_final_primal_lp_duals(P, targets)
    else:
        P = np.stack(rows, axis=0)
    return P, p, float(eps_dev)


def _household_disjoint_row(row, comp, tops, households) -> bool:
    """Realize composition ``comp`` into ``row`` household-disjointly, each
    type's duty taken down its members in ``tops`` order (dual weight,
    descending), skipping households already used; False when a type runs
    out of households (the column breaks the class caps)."""
    used_houses: set = set()
    for t, ct in enumerate(comp):
        ct = int(ct)
        if not ct:
            continue
        picked = 0
        for a in tops[t]:
            h = int(households[a])
            if h in used_houses:
                continue
            used_houses.add(h)
            row[a] = True
            picked += 1
            if picked == ct:
                break
        if picked < ct:
            return False
    return True


def expand_compositions(
    comps: np.ndarray,
    probs: np.ndarray,
    reduction: TypeReduction,
    budget: int = 4096,
    support_eps: float = 1e-11,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a distribution over compositions into concrete panels.

    Members are assigned within each type so that every agent of type t is
    selected with (near-)equal probability ``Σ_c p_c c_t/m_t``:

    * **exact path** — when the total rotation count fits the budget, each
      composition ``c`` is expanded into ``R_c = lcm_t(m_t/gcd(c_t, m_t))``
      block-rotated panels of probability ``p_c/R_c``; within-type uniformity
      is then exact (each member appears in exactly ``R_c·c_t/m_t`` panels);
    * **equidistributed path** — otherwise each composition receives
      ``R_c ≈ budget·p_c`` panels with equidistributed rotation offsets
      (``floor(r·m_t/R_c)``), so member counts differ by at most one and the
      per-agent deviation from composition c is at most ``p_c/R_c ≈ 1/budget``.

    Callers polish the result against the exact type targets (the min-L2
    stage of ``solvers/qp``), which removes the residual construction error.
    Returns ``(panels bool [R, n], panel_probs float64 [R])``.
    """
    from math import gcd

    sel = probs > support_eps
    comps = comps[sel]
    p = probs[sel].astype(np.float64)
    p = p / p.sum()
    S, T = comps.shape
    n = reduction.n
    msize = reduction.msize
    members = reduction.members

    def lcm(a: int, b: int) -> int:
        return a // gcd(a, b) * b

    exact_R = []
    total = 0
    for c in comps:
        R = 1
        for t in range(T):
            ct, mt = int(c[t]), int(msize[t])
            if 0 < ct < mt:
                R = lcm(R, mt // gcd(ct, mt))
                if R > budget:
                    break
        exact_R.append(R)
        total += R
        if total > budget:
            break

    panels: List[np.ndarray] = []
    pprobs: List[float] = []
    if total <= budget:
        for s in range(S):
            c, R = comps[s], exact_R[s]
            for r in range(R):
                row = np.zeros(n, dtype=bool)
                for t in range(T):
                    ct, mt = int(c[t]), int(msize[t])
                    if ct:
                        idx = (r * ct + np.arange(ct)) % mt
                        row[members[t][idx]] = True
                panels.append(row)
                pprobs.append(p[s] / R)
    else:
        # proportional rotation counts, ≥ 1 per support composition
        R_s = np.maximum(1, np.round(p * budget).astype(int))
        for s in range(S):
            c, R = comps[s], int(R_s[s])
            for r in range(R):
                row = np.zeros(n, dtype=bool)
                for t in range(T):
                    ct, mt = int(c[t]), int(msize[t])
                    if ct:
                        start = (r * mt) // R
                        idx = (start + np.arange(ct)) % mt
                        row[members[t][idx]] = True
                panels.append(row)
                pprobs.append(p[s] / R)

    # merge duplicate panels (e.g. trivial rotations when c_t ∈ {0, m_t})
    seen: dict = {}
    rows: List[np.ndarray] = []
    q: List[float] = []
    for row, pr in zip(panels, pprobs):
        kb = row.tobytes()
        if kb in seen:
            q[seen[kb]] += pr
        else:
            seen[kb] = len(rows)
            rows.append(row)
            q.append(pr)
    return np.stack(rows, axis=0), np.asarray(q, dtype=np.float64)
