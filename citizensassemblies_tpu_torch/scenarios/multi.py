"""Multi-assembly scheduling: LEXIMIN over R successive disjoint panels.

R panels are drawn in sequence from one pool and no agent is seated twice.
The single-panel engine's certificates carry over, as in the JAX package:

* **Capped enumeration.** Compositions are enumerated with per-type caps
  ``⌊m_t/R⌋``. R panels whose compositions keep the caps use at most ``m_t``
  agents of each type, so every drawn R-round schedule is realizable with
  zero repeats by relabeling within types.
* **Aggregate LEXIMIN.** ``leximin_over_compositions(comps, msize / R)``
  certifies the per-type aggregate value ``R·c̄_t/m_t ∈ [0, 1]``: with zero
  repeats it is the probability of serving on at least one of the R panels.
* **The R-fold LP fleet.** Each round's probabilities are recovered by one
  final ε-LP over that round's portfolio (the base portfolio under a
  within-type rotation, which spreads pair co-occurrence over the rounds).
  Where ``Config.lp_batch`` resolves on (on CUDA by default) the R LPs are
  one bucketed dispatch of ``solvers/batch_lp.solve_lp_batch`` on
  ``device``; else each is the host LP of
  ``highs_backend.solve_final_primal_lp_duals``.

Pair equity is gauged against the uniform pair value (``ops/pairs.py``):
the co-seating mass summed over the rounds is ``R·C(k,2)``, and the gauge
reports the largest pair probability against that mass spread over all
``C(n,2)`` pairs.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance, FeatureSpace, on_device
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog


@dataclasses.dataclass
class MultiAssemblyResult:
    """R round portfolios, the aggregate certificates and the pair gauge.

    ``allocation`` and ``fixed_probabilities`` are aggregate (the
    probability of serving on at least one of the R panels). ``realize``
    draws one concrete zero-repeat schedule.
    """

    rounds: int
    committees: np.ndarray  # bool[C, n] base (round-0) portfolio
    round_portfolios: List[np.ndarray]  # R × bool[C, n]
    round_probabilities: List[np.ndarray]  # R × float64[C]
    allocation: np.ndarray  # float64[n] aggregate Σ_r P_rᵀ p_r
    output_lines: List[str]
    fixed_probabilities: np.ndarray  # float64[n] certified aggregate values
    covered: np.ndarray  # bool[n]
    type_id: np.ndarray  # int32[n]
    pair_max: float  # max cross-agent pair probability over the R rounds
    pair_uniform: float  # uniform-spread pair value R·C(k,2)/C(n,2)
    pair_ratio: float  # pair_max / pair_uniform (1.0 = perfectly spread)
    realization_dev: float = 0.0
    contract_ok: bool = True
    scenario_audit: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def probabilities(self) -> np.ndarray:
        """Round 0's probabilities."""
        return self.round_probabilities[0]

    def realize(self, seed: int = 0) -> np.ndarray:
        """Draw one concrete R-round schedule with zero agent repeats.

        Each round draws a panel from its portfolio; a member seated in an
        earlier round is swapped for an unseated agent of the same type
        (the caps guarantee one). Returns int32[R, k], sorted agent ids per
        round.
        """
        rng = np.random.default_rng(seed)
        n = self.allocation.shape[0]
        seated = np.zeros(n, dtype=bool)
        rows: List[np.ndarray] = []
        for r in range(self.rounds):
            p = self.round_probabilities[r]
            c = rng.choice(len(p), p=p)
            panel = set(np.nonzero(self.round_portfolios[r][c])[0].tolist())
            taken: set = set()
            for i in sorted(panel):
                if not seated[i]:
                    taken.add(i)
                    continue
                mates = np.nonzero((self.type_id == self.type_id[i]) & ~seated)[0]
                mates = [j for j in mates if j not in panel and j not in taken]
                if not mates:  # excluded by the caps
                    raise RuntimeError(
                        f"round {r}: no unseated type-{self.type_id[i]} replacement for agent {i}"
                    )
                taken.add(int(rng.choice(mates)))
            row = np.sort(np.asarray(sorted(taken), dtype=np.int32))
            seated[row] = True
            rows.append(row)
        return np.stack(rows, axis=0)


def _rotation(members: List[np.ndarray], n: int, shift: int) -> np.ndarray:
    """Within-type rotation ``src``: ``P[:, src]`` gives agent
    ``mem[(j+shift) % m]`` the column of ``mem[j]``, so round r's portfolio
    is the base portfolio advanced r steps around each type's members."""
    src = np.arange(n, dtype=np.int64)
    for mem in members:
        m = len(mem)
        if m > 1:
            src[mem[(np.arange(m) + shift) % m]] = mem
    return src


def find_distribution_multi(
    dense: DenseInstance,
    space: Optional[FeatureSpace] = None,
    rounds: Optional[int] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    log: Optional[RunLog] = None,
    ctx=None,
    device: DeviceLike = None,
) -> MultiAssemblyResult:
    """LEXIMIN over ``rounds`` successive panels with zero agent repeats,
    its LP fleet on ``device`` (CUDA unless the caller passes another).

    ``rounds`` defaults to ``Config.scenario_rounds``. Raises
    :class:`~citizensassemblies_tpu_torch.scenarios.SchedulingInfeasible`
    when the per-round caps leave the quotas unsatisfiable, and
    :class:`~citizensassemblies_tpu_torch.scenarios.ScenarioError` when the
    type space is not enumerable (disjointness is a property of the
    enumeration caps, so there is no column-generation path). ``ctx``
    (``service/context.py``) is ambient for the call; its deadline is
    checked before the enumeration, the LEXIMIN, the decomposition and the
    fleet.
    """
    from citizensassemblies_tpu_torch.scenarios import ScenarioError

    ctx, cfg, log = resolve_context(ctx, cfg, log)
    if households is not None:
        raise ScenarioError(
            "the multi-assembly model does not support household constraints "
            "yet (the rotation realization is not household-aware)"
        )
    R = int(rounds) if rounds is not None else int(cfg.scenario_rounds)
    if R < 1:
        raise ScenarioError(f"rounds must be >= 1, got {R}")
    dense = on_device(dense, resolve_device(device))
    with use_context(ctx):
        return _multi_impl(dense, R, cfg, log, ctx)


def _check_deadline(ctx, where: str, log: RunLog) -> None:
    if ctx is not None and ctx.deadline is not None:
        ctx.deadline.check(where, log)


def _multi_impl(dense: DenseInstance, R: int, cfg: Config, log: RunLog, ctx) -> MultiAssemblyResult:
    from citizensassemblies_tpu_torch.ops.pairs import pair_matrix_from_portfolio, uniform_pair_value
    from citizensassemblies_tpu_torch.scenarios import ScenarioError, SchedulingInfeasible
    from citizensassemblies_tpu_torch.solvers.batch_lp import (
        final_primal_batch_lp,
        lp_batch_enabled,
        solve_lp_batch,
    )
    from citizensassemblies_tpu_torch.solvers.compositions import (
        decompose_with_pricing,
        enumerate_compositions,
        leximin_over_compositions,
    )
    from citizensassemblies_tpu_torch.solvers.highs_backend import solve_final_primal_lp_duals
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    dev = dense.device
    log.emit(f"Using multi-assembly scheduling over {R} rounds (scenarios/multi).")
    reduction = TypeReduction(dense)
    if reduction.T > cfg.enum_max_types:
        raise ScenarioError(
            f"multi-assembly needs an enumerable type space: {reduction.T} "
            f"types > enum_max_types={cfg.enum_max_types}"
        )
    _check_deadline(ctx, "scenario_multi_enum", log)
    # capped enumeration: the enumerator reads only msize, and the caps make
    # every schedule disjoint-realizable
    capped = copy.copy(reduction)
    capped.msize = (reduction.msize // R).astype(np.int32)
    comps = enumerate_compositions(capped, cap=cfg.enum_cap, node_budget=cfg.enum_node_budget)
    if comps is None:
        raise ScenarioError(
            f"capped composition enumeration exceeded its budget "
            f"(cap={cfg.enum_cap}, node_budget={cfg.enum_node_budget})"
        )
    if len(comps) == 0:
        raise SchedulingInfeasible(
            f"no feasible composition with per-type caps ⌊m_t/{R}⌋ — "
            f"{R} disjoint rounds cannot satisfy the quotas "
            f"(pool of {dense.n} supports at most "
            f"{int(np.sum(reduction.msize // R))} capped seats for k={dense.k})"
        )
    log.emit(
        f"Multi-assembly: {reduction.T} types, caps ⌊m/{R}⌋, "
        f"{len(comps)} feasible compositions."
    )
    m = reduction.msize.astype(np.float64)
    _check_deadline(ctx, "scenario_multi_leximin", log)
    with log.timer("scenario_leximin"):
        # the m/R divisor certifies R·c/m: the aggregate (≥ 1-of-R) value
        ts = leximin_over_compositions(
            comps, m / float(R), probe_tol=cfg.probe_tol, log=log, cfg=cfg, device=dev,
        )
    agg_type = ts.probabilities @ (ts.compositions.astype(np.float64) * float(R) / m[None, :])
    a_agent = agg_type[reduction.type_id]
    per_round_target = a_agent / float(R)
    _check_deadline(ctx, "scenario_multi_decompose", log)
    with log.timer("scenario_decompose"):
        P, p_seed, eps_seed = decompose_with_pricing(
            ts.compositions, ts.probabilities, reduction, per_round_target,
            budget=cfg.decompose_budget, support_eps=cfg.support_eps, log=log,
            tol=max(cfg.decomp_tol, 2e-5),
        )
    p_seed = np.clip(p_seed, 0.0, 1.0)
    keep = p_seed > cfg.support_eps
    P, p_seed = P[keep], p_seed[keep]
    p_seed = p_seed / p_seed.sum()

    # R round portfolios: the base portfolio under within-type rotations —
    # the marginals stay (the target is constant within a type), the pair
    # co-occurrence decorrelates
    portfolios = [P[:, _rotation(reduction.members, dense.n, r)] for r in range(R)]

    batched = lp_batch_enabled(cfg, dev)
    _check_deadline(ctx, "scenario_multi_fleet", log)
    with log.timer("scenario_fleet"):
        probs_r: List[np.ndarray] = []
        eps_r: List[float] = []
        if batched:
            # the R-fold fleet: R same-shape ε-LPs, one bucketed dispatch
            fleet = [final_primal_batch_lp(Pr, per_round_target) for Pr in portfolios]
            sols = solve_lp_batch(
                fleet, cfg, log, warm_key="scenario_multi", common_bucket=True, device=dev,
            )
            for sol in sols:
                if sol.ok:
                    p = np.clip(np.asarray(sol.x[: P.shape[0]], dtype=np.float64), 0.0, 1.0)
                    probs_r.append(p / p.sum())
                    eps_r.append(float(sol.x[P.shape[0]]))
                else:
                    probs_r.append(p_seed)
                    eps_r.append(float(eps_seed))
        else:
            for Pr in portfolios:
                p, eps, _y, _mu = solve_final_primal_lp_duals(Pr, per_round_target)
                p = np.clip(np.asarray(p, dtype=np.float64), 0.0, 1.0)
                probs_r.append(p / p.sum())
                eps_r.append(float(eps))

    allocation = np.zeros(dense.n, dtype=np.float64)
    pair = np.zeros((dense.n, dense.n), dtype=np.float64)
    for Pr, pr in zip(portfolios, probs_r):
        allocation += Pr.T.astype(np.float64) @ pr
        pair += pair_matrix_from_portfolio(Pr, pr, device=dev).cpu().numpy().astype(np.float64)
    coverable = ts.compositions.max(axis=0) > 0
    covered = coverable[reduction.type_id]
    total_dev = float(np.max(np.abs(allocation - a_agent)))
    k = int(dense.k)
    pair_uniform = float(R) * (k * (k - 1) / 2.0) * float(uniform_pair_value(dense.n))
    offdiag = pair[~np.eye(dense.n, dtype=bool)]
    pair_max = float(offdiag.max()) if offdiag.size else 0.0
    pair_ratio = pair_max / pair_uniform if pair_uniform > 0 else 0.0
    log.emit(
        f"Multi-assembly done: {ts.stages} stages, {ts.lp_solves} LP solves, "
        f"{P.shape[0]} panels/round, round ε ≤ {max(eps_r):.2e}, aggregate "
        f"max |alloc − target| = {total_dev:.2e}, pair gauge "
        f"{pair_ratio:.2f}× uniform."
    )
    audit: Dict[str, Any] = {
        "model": "multi",
        "rounds": R,
        "types": int(reduction.T),
        "compositions": int(len(comps)),
        "panels_per_round": int(P.shape[0]),
        "fleet_backend": "batch_lp" if batched else "host",
        "round_eps_max": round(max(eps_r), 8),
        "pair_max": round(pair_max, 8),
        "pair_uniform": round(pair_uniform, 8),
        "pair_ratio": round(pair_ratio, 4),
        "certified_min_aggregate": round(
            float(agg_type[coverable].min()) if coverable.any() else 0.0, 6
        ),
    }
    return MultiAssemblyResult(
        rounds=R,
        committees=P,
        round_portfolios=portfolios,
        round_probabilities=probs_r,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=a_agent,
        covered=covered,
        type_id=reduction.type_id.astype(np.int32),
        pair_max=pair_max,
        pair_uniform=pair_uniform,
        pair_ratio=pair_ratio,
        realization_dev=total_dev,
        contract_ok=bool(total_dev <= 1e-3),
        scenario_audit=audit,
    )
