"""Shared host-LP plumbing for the type-space solvers.

scipy's HiGHS front-end occasionally declares *feasible* LPs infeasible when
presolve encounters rows that are tight to within its tolerance — observed on
leximin stage LPs whose fixed-type floors sit 1e-9 below an attained optimum
(the witness point violated no constraint by more than 2e-14 yet both
``method="highs"`` and ``"highs-ipm"`` reported infeasibility; re-solving with
``presolve=False`` found the optimum). :func:`robust_linprog` retries across
presolve settings and methods before giving up, so borderline-degenerate
stages never abort an otherwise-exact solve.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize


def robust_linprog(
    c,
    A_ub=None,
    b_ub=None,
    A_eq=None,
    b_eq=None,
    bounds=None,
    methods: Sequence[str] = ("highs", "highs-ipm"),
) -> scipy.optimize.OptimizeResult:
    """``scipy.optimize.linprog`` with a presolve/method retry ladder.

    Tries each method with presolve on, then off; returns the first optimal
    result, else the last attempt (caller checks ``res.status``).
    """
    assert methods, "need at least one LP method"
    last = None
    for method in methods:
        for presolve in (True, False):
            res = scipy.optimize.linprog(
                c,
                A_ub=A_ub,
                b_ub=b_ub,
                A_eq=A_eq,
                b_eq=b_eq,
                bounds=bounds,
                method=method,
                options=None if presolve else {"presolve": False},
            )
            if res.status == 0:
                return res
            last = res
    return last


#: allowances beyond this are clamped before use: a certificate judged "up to
#: the allowance" is only meaningful while the allowance stays well inside the
#: framework's 1e-3 L∞ acceptance bar — an escalated slack ladder can push the
#: raw slack-gain for a rare type to ~1e-2, and certifying at that tolerance
#: would fix a genuinely loose type below its true leximin value.
ALLOWANCE_CAP = 1e-4


def probe_confirm_tranche(
    face_max: Callable[[np.ndarray], Tuple[Optional[float], Optional[np.ndarray]]],
    objectives: np.ndarray,
    z: float,
    probe_tol: float,
    allowances: np.ndarray,
    term_deficit: float = 0.0,
    log: Optional[Callable[[str], object]] = None,
    face_max_relaxed: Optional[
        Callable[[np.ndarray], Tuple[Optional[float], Optional[np.ndarray]]]
    ] = None,
    presumed_loose: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Certify which leximin tranche candidates are capped at ``z`` over a
    stage's optimal face.

    ``face_max(w)`` maximizes ``w`` over the face and returns ``(value,
    x_opt)`` — the optimizer feeds the witness elimination below;
    ``objectives[i]`` is candidate i's value functional; ``allowances[i]``
    bounds the spurious headroom constraint slack can grant candidate i (see
    the callers' slack-gain derivations; clamped to :data:`ALLOWANCE_CAP` so
    a certificate never exceeds a tolerance material against the 1e-3 bar);
    ``term_deficit`` is how far below ``z`` a candidate's value may sit on the
    face (the callers relax the face floors to ``z − margin − slack``, so each
    term is only ≥ ``z − term_deficit`` there).

    Group LPs certify many candidates per solve: a sum bound of ``g·z + δ``
    over a chunk caps each member at ``z + δ + (g−1)·term_deficit`` (the
    other members can each sit ``term_deficit`` below ``z``), and since the
    face's freed slack can concentrate on ONE member, ``δ`` must absorb the
    chunk's LARGEST allowance — sound only when every member's own
    allowance covers it. Chunks therefore group candidates of equal
    allowance (≈ equal pool size), sized so the ``(g−1)·term_deficit``
    inflation stays immaterial.

    Disagreeing chunks resolve by **witness elimination**, not per-candidate
    probes: the failed group LP's own optimizer ``x*`` values every candidate
    at once (``objectives[i]·x*``), and any candidate above the certificate
    bound at a *feasible face point* is thereby witnessed loose — drop it and
    re-probe the survivors. Each iteration removes at least one member (the
    argmax when none crosses the bound), so a tranche with ``l`` loose
    candidates costs ``O(l)`` group LPs instead of one LP per member (a
    mild-skew sf_e seed paid ~2500 per-candidate probe LPs ≈ 25–47 s under
    the flat scheme; elimination cuts the stage cost to a handful of LPs).
    A dropped candidate is merely deferred to a later stage — dropping can
    never certify, so soundness is unaffected. A whole-tranche pre-probe at
    the MINIMUM allowance (within every member's own budget) settles the
    all-tight case — the common one — in a single LP even across mixed
    allowances.

    An *infeasible* face from a group probe is never taken as evidence of
    tightness (this module's own header documents HiGHS falsely declaring
    feasible LPs infeasible): it falls through to the per-candidate probes.
    ``presumed_loose`` (bool mask, same length as ``objectives``) marks
    candidates a device prescreen has already WITNESSED loose at a
    float64-validated face point (``compositions._batched_probe_prescreen``):
    they are excluded from every probe and left unconfirmed — identical
    outcome to probing them (a genuinely loose candidate can never be
    confirmed; it is deferred to a later stage), minus the host LPs. The
    mask can only REDUCE the LP count, never add a confirmation, so
    soundness is untouched; with no mask (or an all-False one) the behavior
    is bit-identical to the unscreened scheme.

    A per-candidate infeasible face certifies only after the face itself is
    confirmed non-empty (one zero-objective feasibility solve, cached per
    tranche) AND, when the caller supplies ``face_max_relaxed`` (the same
    maximization over a slightly enlarged face — a superset, so its optimum
    upper-bounds the face optimum), a retry on that enlarged face also fails
    to produce a finite value. A finite retry value is decisive either way:
    within budget it is a genuine certificate; above budget it is genuine
    headroom and nothing is certified — so an objective-specific numerical
    failure can no longer fix a loose candidate. Only when the retry is also
    infeasible/failed is status-2 on a non-empty face read as a solver
    mis-report ("nothing exceeds z materially"), and the event is logged. If the face is genuinely empty — the reported ``z``
    overstates the true stage optimum by more than the face relaxation —
    nothing is certified: an empty face carries no tightness information,
    and falsely confirming would fix loose candidates at an understated
    value. Any other solver failure (``face_max`` None) certifies nothing.
    Returns a bool mask.
    """
    n = len(objectives)
    confirmed = np.zeros(n, dtype=bool)
    if n == 0:
        return confirmed
    allowances = np.minimum(
        np.asarray(allowances, dtype=np.float64), ALLOWANCE_CAP
    )

    infeasible_fixes = 0
    uncertified_drops = 0
    face_state = {"checked": False, "empty": False}

    def probe_one(i: int) -> None:
        nonlocal infeasible_fixes
        got, _x = face_max(objectives[i])
        if got == -np.inf:
            if not face_state["checked"]:
                face_state["checked"] = True
                z0, _ = face_max(np.zeros_like(objectives[i]))
                face_state["empty"] = z0 == -np.inf
                if face_state["empty"] and log is not None:
                    log(
                        f"  probe: face at z={z:.6f} is empty (reported stage "
                        "optimum overstates the true one beyond the face "
                        "relaxation) — certifying nothing."
                    )
            if face_state["empty"]:
                # a numerically-empty base face (solver-reported z overstates
                # the true stage optimum by more than the face relaxation)
                # still admits a sound certificate via the relaxed SUPERSET
                # face, which contains the true optimal face — without this,
                # an empty face degrades the whole stage to per-candidate
                # probes ending in the uncertified dual heuristic
                if face_max_relaxed is not None:
                    rv, _ = face_max_relaxed(objectives[i])
                    if (
                        rv is not None
                        and rv != -np.inf
                        and rv <= z + probe_tol + float(allowances[i])
                    ):
                        confirmed[i] = True
                return
            if face_max_relaxed is not None:
                rv, _ = face_max_relaxed(objectives[i])
                if rv is not None and rv != -np.inf:
                    # superset optimum ≥ face optimum: within budget it
                    # certifies, above budget it is genuine headroom —
                    # either way the infeasible report was objective-specific
                    # and must not certify on its own
                    if rv <= z + probe_tol + float(allowances[i]):
                        confirmed[i] = True
                    return
            confirmed[i] = True
            infeasible_fixes += 1
        elif got is not None and got <= z + probe_tol + float(allowances[i]):
            confirmed[i] = True

    # Chunked group probing over EQUAL-allowance groups. The sound bound for
    # a chunk probe: constraint slack lets the whole tranche's freed mass
    # concentrate on ONE member, so a passing sum certifies each member only
    # at ``z + probe_tol + max_allow(chunk) + (g−1)·term_deficit`` — usable
    # only when every member's own allowance covers ``max_allow``, i.e. when
    # the chunk's allowances are (near-)identical. Allowances are
    # ``slack_gain / m_t`` with small-integer ``m_t``, so grouping by exact
    # allowance value yields ~#distinct-pool-sizes probes per tranche
    # instead of one per candidate; chunk size is additionally capped so the
    # ``(g−1)·term_deficit`` inflation stays immaterial (≤ 10·probe_tol).
    max_infl = 10.0 * probe_tol

    def resolve(chunk: np.ndarray, a_i: float) -> None:
        """Certify an equal-allowance chunk by witness elimination (see the
        docstring): probe the sum; on disagreement, drop members the group
        optimizer itself witnesses loose and re-probe the survivors."""
        active = np.asarray(chunk)
        while len(active) > 1:
            g = len(active)
            got, xopt = face_max(np.sum(objectives[active], axis=0))
            if got is None or got == -np.inf or xopt is None:
                # infeasible/failed group face is never evidence of
                # tightness: resolve the remaining members individually
                # (probe_one owns the empty-face and superset-retry logic)
                for idx in active:
                    probe_one(int(idx))
                return
            if got <= g * z + probe_tol + a_i:
                confirmed[active] = True
                return
            vals = objectives[active] @ xopt
            # a candidate above the certificate bound at a FEASIBLE face
            # point is witnessed loose — dropping defers it to a later
            # stage, which can never falsely certify
            loose = vals > z + probe_tol + a_i
            if not loose.any():
                # the excess is spread below any individual bound: drop the
                # largest value so every iteration removes at least one.
                # Unlike a witnessed drop, this argmax drop carries NO
                # evidence of looseness — a genuinely tight candidate could
                # be deferred and the stage would silently lean on the
                # uncertified dual-progress guard. Spend one bounded LP per
                # such drop (probe_one) to certify it outright; drops that
                # still fail their probe are counted and logged so the
                # certification-coverage loss is visible, not silent.
                loose = vals >= vals.max() - 1e-12
                for idx in active[loose]:
                    probe_one(int(idx))
                    if not confirmed[int(idx)]:
                        uncertified_drops += 1
            active = active[~loose]
        if len(active) == 1:
            probe_one(int(active[0]))

    # whole-tranche pre-probe at the MINIMUM allowance: certifying every
    # member at min_allow is within each member's own budget, so one passing
    # LP settles the entire tranche even across mixed allowances (it may
    # spuriously fail when the freed slack genuinely concentrates — the
    # equal-allowance chunks below then recover the precise verdicts).
    # Prescreen-witnessed loose candidates are excluded up front: they would
    # make the group sum fail for certain, and probing them individually
    # could only repeat what the witness already proved.
    order = np.argsort(-allowances)
    if presumed_loose is not None:
        skip = np.asarray(presumed_loose, dtype=bool)
        order = order[~skip[order]]
    n_act = len(order)
    if n_act == 0:
        return confirmed
    if n_act > 1 and (n_act - 1) * term_deficit <= max_infl:
        got, _x = face_max(np.sum(objectives[order], axis=0))
        if (
            got is not None
            and got != -np.inf
            and got <= n_act * z + probe_tol + float(allowances[order].min())
        ):
            confirmed[order] = True
            return confirmed
    i = 0
    while i < n_act:
        j = i + 1
        a_i = float(allowances[order[i]])
        while (
            j < n_act
            and j - i < 256
            and abs(float(allowances[order[j]]) - a_i) <= 1e-12
            and (j - i) * term_deficit <= max_infl
        ):
            j += 1
        resolve(order[i:j], a_i)
        i = j
    if infeasible_fixes and log is not None:
        log(
            f"  probe: {infeasible_fixes}/{n} candidate(s) certified via an "
            f"infeasible probe face at z={z:.6f} (solver-tolerance overstatement)."
        )
    if uncertified_drops and log is not None:
        log(
            f"  probe: {uncertified_drops}/{n} argmax-dropped candidate(s) at "
            f"z={z:.6f} remain uncertified after an individual probe "
            "(deferred to a later stage; certification coverage reduced)."
        )
    return confirmed
