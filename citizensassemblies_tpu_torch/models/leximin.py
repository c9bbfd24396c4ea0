"""LEXIMIN: exact lexicographic-maximin panel distributions.

**Type space** (the default). Agents with identical feature rows are
interchangeable, so the problem collapses onto the T distinct agent types
(``solvers/native_oracle.TypeReduction``):

* at most ``Config.enum_max_types`` types: every feasible composition is
  enumerated and the leximin stage LPs run over the whole enumeration
  (``solvers/compositions.leximin_over_compositions``);
* more types: the relaxation profile is certified on the host and realized
  by one face decomposition whose masters run on ``device``
  (``solvers/cg_typespace.leximin_cg_typespace``).

Either certificate is then realized as concrete panels
(``compositions.decompose_with_pricing``) and checked against the 1e-3 L∞
contract on the per-agent allocation.

**Agent space** (``Config.force_agent_space``, ``initial_panels``, and the
fallback after a type-space contract miss): the reference's column
generation over panels (``leximin.py:338-470``). An outer loop fixes one
tranche of agents per round by strict complementarity; an inner loop solves
the dual LP over the portfolio (by PDHG on ``device`` with
``Config.backend == "jax"``, through the LP block kernel, else HiGHS; on a
world of more than one device, past ``Config.dual_shard_min_rows`` rows and
with any backend but ``"highs"``, by the row-sharded PDHG of
``parallel/solver``) and
prices new panels with the LEGACY sampler on ``device``, the exact oracle
certifying termination; a final LP realizes the fixed probabilities.

``final_stage="l2"`` realizes the certificate with the min-L2 stage of
``solvers/qp`` instead (type space: over the rotation expansion of the
compositions, ``compositions.expand_compositions``, or with households a
household-disjoint decomposition; agent space: over the column-generation
portfolio), as XMIN does; it never falls back to agent space, and
``contract_ok`` reports its deviation.

**Households** (at most one member per household, the reference's
``leximin.py:211-221``): type space runs on the household quotient's
augmented instance (``solvers/quotient.py``), whose distinct rows are the
symmetry orbits, and realizes household-disjoint panels; agent space adds
the household rows to the exact oracle and the feasibility gate, and
samples household-disjoint panels.

**Checkpoints** (``checkpoint_path=``): the agent-space CG saves its state
at every outer-round boundary and the type-space path its seed columns and
targets before the face decomposition (``utils/checkpoint.py``); a run
given the same path resumes from a checkpoint of the same problem, and a
finished run removes the file. ``Config.fault_sites`` installs a fault
injector for the call (``robust/inject.py``).

**Request context** (``ctx=``, ``service/context.py``): the call resolves
its ``cfg`` and ``log`` through it and runs with it ambient, so the face
loop checks its ``deadline`` once a round and the fault sites consult its
``injector``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    SelectionError,
    on_device,
)
from citizensassemblies_tpu_torch.solvers.highs_backend import (
    HighsCommitteeOracle,
    check_feasible_or_suggest,
    solve_dual_lp,
    solve_final_primal_lp,
)
from citizensassemblies_tpu_torch.dist.runtime import effective_mesh
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.utils import checkpoint as ckpt
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog, format_counters, format_timers

#: the framework's contract on max |allocation − leximin value| per agent
CONTRACT_LINF = 1e-3


@dataclasses.dataclass
class Distribution:
    """A distribution over feasible committees plus derived quantities."""

    committees: np.ndarray  # bool[|C|, n] portfolio matrix
    probabilities: np.ndarray  # float64[|C|]
    allocation: np.ndarray  # float64[n] per-agent selection probabilities
    output_lines: List[str]
    fixed_probabilities: np.ndarray  # float64[n] leximin values per agent
    covered: np.ndarray  # bool[n] agent appears in some feasible committee
    #: max |allocation − fixed_probabilities|; the contract is ≤ 1e-3
    realization_dev: float = 0.0
    contract_ok: bool = True

    @property
    def panels(self) -> List[Tuple[int, ...]]:
        return [tuple(np.nonzero(row)[0].tolist()) for row in self.committees]

    def support(self, eps: float = 1e-11) -> List[Tuple[int, ...]]:
        """Panels with probability above ``eps``."""
        return [
            tuple(np.nonzero(row)[0].tolist())
            for row, p in zip(self.committees, self.probabilities)
            if p > eps
        ]


def _typespace_leximin(
    dense: DenseInstance, cfg: Config, log: RunLog, device, final_stage: str = "lp",
    households: Optional[np.ndarray] = None, checkpoint_path: Optional[str] = None,
) -> Distribution:
    """Exact leximin in type space: enumeration when the type count is
    small, the relaxation profile plus one face decomposition otherwise
    (checkpointed at ``checkpoint_path``, removed once it is done). With
    ``households`` the caller passes the household quotient's augmented
    instance, and the realization keeps every panel household-disjoint."""
    from citizensassemblies_tpu_torch.solvers.compositions import (
        enumerate_compositions,
        leximin_over_compositions,
    )
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    reduction = TypeReduction(dense)
    comps = None
    if reduction.T <= cfg.enum_max_types:
        comps = enumerate_compositions(
            reduction, cap=cfg.enum_cap, node_budget=cfg.enum_node_budget
        )
        if comps is not None and len(comps) == 0:
            comps = None
    if comps is not None:
        log.emit(
            f"Type-space enumeration: {reduction.T} agent types, "
            f"{len(comps)} feasible compositions."
        )
        with log.timer("typespace_lp"):
            # cfg and the device carry the batched probe prescreen
            ts = leximin_over_compositions(
                comps, reduction.msize, probe_tol=cfg.probe_tol, log=log, cfg=cfg, device=device,
            )
    else:
        from citizensassemblies_tpu_torch.solvers.cg_typespace import leximin_cg_typespace

        log.emit(
            f"Type-space column generation: {reduction.T} agent types "
            f"(enumeration over budget)."
        )
        with log.timer("typespace_cg"):
            ts = leximin_cg_typespace(
                dense, reduction, cfg=cfg, log=log, device=device, checkpoint_path=checkpoint_path
            )
        if checkpoint_path is not None:
            ckpt.clear_cg_state(checkpoint_path)
    if final_stage == "l2":
        return realize_typespace_l2(dense, reduction, ts, cfg, log, device, households)
    return realize_typespace(
        dense, reduction, ts, cfg, log, enumerated=comps is not None, households=households
    )


def realize_typespace_l2(dense: DenseInstance, reduction, ts, cfg: Config, log: RunLog,
                         device, households: Optional[np.ndarray] = None) -> Distribution:
    """Realize a type-space certificate with the min-L2 stage: the
    rotation expansion of the compositions (``expand_compositions``) is the
    portfolio, its probabilities the ε-floor donor of
    ``qp.solve_final_primal_l2`` (so the host ε-LP never runs). The
    expansion is not household-aware, so with ``households`` a
    household-disjoint decomposition (``decompose_with_pricing``) is the
    portfolio and the donor instead."""
    from citizensassemblies_tpu_torch.solvers.compositions import (
        decompose_with_pricing,
        expand_compositions,
    )
    from citizensassemblies_tpu_torch.solvers.qp import solve_final_primal_l2

    fixed_agent = ts.type_values[reduction.type_id]
    with log.timer("final_stage"):
        if households is None:
            P, p_seed = expand_compositions(
                ts.compositions, ts.probabilities, reduction,
                budget=cfg.expand_budget, support_eps=cfg.support_eps,
            )
        else:
            realized = ts.probabilities @ (
                ts.compositions.astype(np.float64) / reduction.msize.astype(np.float64)[None, :]
            )
            P, p_seed, _ = decompose_with_pricing(
                ts.compositions, ts.probabilities, reduction, realized[reduction.type_id],
                budget=cfg.decompose_budget, support_eps=cfg.support_eps, log=log, tol=2e-5,
                households=households,
            )
        probs, eps_dev = solve_final_primal_l2(
            P, fixed_agent, iters=cfg.xmin_qp_iters, log=log, floor_donor=p_seed, cfg=cfg,
            device=device,
        )
    probs = np.clip(probs, 0.0, 1.0)
    probs = probs / probs.sum()
    allocation = P.T.astype(np.float64) @ probs
    coverable = ts.coverable if hasattr(ts, "coverable") else ts.compositions.max(axis=0) > 0
    total_dev = float(np.max(np.abs(allocation - fixed_agent)))
    log.emit(
        f"Leximin done (type space): {ts.stages} stages, {ts.lp_solves} LP solves, "
        f"{P.shape[0]} panels in portfolio, final ε = {eps_dev:.2e}, "
        f"max |alloc − target| = {total_dev:.2e}."
    )
    log.emit(format_timers(log.timers))
    if log.counters:
        log.emit(format_counters(log.counters))
    return Distribution(
        committees=P,
        probabilities=probs,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=fixed_agent,
        covered=coverable[reduction.type_id],
        realization_dev=total_dev,
        contract_ok=bool(total_dev <= CONTRACT_LINF),
    )


def realize_typespace(
    dense: DenseInstance,
    reduction,
    ts,
    cfg: Config,
    log: RunLog,
    enumerated: bool = True,
    households: Optional[np.ndarray] = None,
) -> Distribution:
    """Realize a type-space leximin certificate (compositions,
    probabilities, type values) as a concrete panel portfolio, every panel
    household-disjoint with ``households``."""
    from citizensassemblies_tpu_torch.solvers.compositions import decompose_with_pricing

    fixed_agent = ts.type_values[reduction.type_id]
    eps_dev = float(getattr(ts, "eps_dev", 0.0))
    with log.timer("final_stage"):
        # decompose toward the marginals the composition mixture actually
        # realizes (within ts.eps_dev of the type values)
        realized = ts.probabilities @ (
            ts.compositions.astype(np.float64) / reduction.msize.astype(np.float64)[None, :]
        )
        P, probs, eps_panel = decompose_with_pricing(
            ts.compositions,
            ts.probabilities,
            reduction,
            realized[reduction.type_id],
            budget=cfg.decompose_budget,
            support_eps=cfg.support_eps,
            log=log,
            households=households,
            # the enumerated path polishes to decomp_tol, the CG path floors
            # the panel tolerance at its greedy noise scale (2e-5); pools of
            # n ≥ 200 never go below 2.5e-4; and the total error
            # |alloc − v| ≤ tol + eps_dev stays inside the accept band plus
            # 1e-4 (< 1e-3 at the default config)
            tol=max(
                cfg.decomp_tol if enumerated else max(cfg.decomp_tol, 2e-5),
                min(
                    max(0.5 * eps_dev, 2.5e-4 if dense.n >= 200 else 0.0),
                    max(cfg.decomp_accept, cfg.decomp_accept_stalled) + 1e-4 - eps_dev,
                ),
            ),
        )
    probs = np.clip(probs, 0.0, 1.0)
    keep = probs > cfg.support_eps
    P, probs = P[keep], probs[keep]
    probs = probs / probs.sum()
    allocation = P.T.astype(np.float64) @ probs
    coverable = ts.coverable if hasattr(ts, "coverable") else ts.compositions.max(axis=0) > 0
    covered = coverable[reduction.type_id]
    total_dev = float(np.max(np.abs(allocation - fixed_agent)))
    log.emit(
        f"Leximin done (type space): {ts.stages} stages, {ts.lp_solves} LP solves, "
        f"{P.shape[0]} panels in portfolio, final ε = {eps_panel:.2e}, "
        f"max |alloc − target| = {total_dev:.2e}."
    )
    log.emit(format_timers(log.timers))
    if log.counters:
        log.emit(format_counters(log.counters))
    return Distribution(
        committees=P,
        probabilities=probs,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=fixed_agent,
        covered=covered,
        realization_dev=total_dev,
        contract_ok=bool(total_dev <= CONTRACT_LINF),
    )


class _Portfolio:
    """Growing committee portfolio with O(1) dedup."""

    def __init__(self, n: int):
        self.n = n
        self.rows: List[np.ndarray] = []
        self.seen: Set[Tuple[int, ...]] = set()

    def add(self, panel: Tuple[int, ...]) -> bool:
        if panel in self.seen:
            return False
        self.seen.add(panel)
        self.append(panel)
        return True

    def append(self, panel: Tuple[int, ...]) -> None:
        """Add a panel the caller has already entered in ``seen``."""
        row = np.zeros(self.n, dtype=bool)
        row[list(panel)] = True
        self.rows.append(row)

    def matrix(self) -> np.ndarray:
        return np.stack(self.rows, axis=0)

    def __len__(self) -> int:
        return len(self.rows)


def _seed_portfolio(
    dense: DenseInstance,
    oracle: HighsCommitteeOracle,
    portfolio: _Portfolio,
    cfg: Config,
    generator: torch.Generator,
    log: RunLog,
    households: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Seed a diverse portfolio covering every coverable agent: one batched
    LEGACY draw on the instance's device (household-disjoint with
    ``households``), then one exact solve per agent the batch missed (force
    the agent in, maximize the coverage of the other uncovered agents;
    ``leximin.py:279-289``). Returns the bool[n] coverage mask."""
    from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch

    n = dense.n
    budget = max(256, min(cfg.mw_rounds_factor * n, cfg.seed_batch))
    panels, ok = sample_panels_batch(dense, generator, budget, households=households, cfg=cfg)
    panels = np.sort(panels.cpu().numpy(), axis=1)
    for b in np.nonzero(ok.cpu().numpy())[0]:
        portfolio.add(tuple(panels[b].tolist()))
    covered = np.zeros(n, dtype=bool)
    for row in portfolio.rows:
        covered |= row
    log.emit(
        f"Portfolio seeding: batched sampler found {len(portfolio)} distinct feasible "
        f"committees covering {int(covered.sum())}/{n} agents."
    )
    for i in range(n):
        if covered[i]:
            continue
        try:
            panel, _ = oracle.maximize((~covered).astype(np.float64), forced=(i,))
        except Exception:
            log.emit(f"Agent {i} not contained in any feasible committee.")
            continue
        portfolio.add(panel)
        covered[list(panel)] = True
    if covered.all():
        log.emit("All agents are contained in some feasible committee.")
    return covered


def _shave(fixed: np.ndarray, step: float) -> np.ndarray:
    """Lower every fixed probability by ``step`` (the reference's recovery
    from a numerically infeasible dual LP, ``leximin.py:405-417``)."""
    return np.where(fixed >= 0, np.maximum(fixed - step, 0.0), fixed)


def _agent_space_leximin(
    dense: DenseInstance,
    cfg: Config,
    log: RunLog,
    device,
    oracle: HighsCommitteeOracle,
    initial_panels,
    ts_fallback: Optional[Distribution],
    final_stage: str = "lp",
    households: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
) -> Distribution:
    """The agent-space column generation (``leximin.py:338-470``). With a
    ``ts_fallback`` (a type-space result that missed the contract) the loop
    runs under ``Config.agent_space_budget_s``; past it the fallback ships,
    flagged. With ``checkpoint_path`` the state is saved at every outer
    round and a checkpoint of the same problem is resumed; the file is
    removed once the distribution is realized, and kept when the budget
    ships the fallback (a rerun then resumes the exact CG)."""
    n = dense.n
    generator = torch.Generator(device=dense.device).manual_seed(int(cfg.solver_seed))
    portfolio = _Portfolio(n)
    ckpt_fp = ""
    resumed = None
    if checkpoint_path is not None:
        ckpt_fp = ckpt.problem_fingerprint(dense, cfg, households)
        resumed = ckpt.load_cg_state(checkpoint_path, n, ckpt_fp)
    if resumed is not None:
        for row in resumed.portfolio:
            portfolio.add(tuple(np.nonzero(row)[0].tolist()))
        covered = resumed.covered.astype(bool)
        fixed = np.asarray(resumed.fixed, dtype=np.float64)
        ckpt.restore_generator(generator, resumed.key)
        reduction_counter = resumed.reduction_counter
        dual_solves = resumed.dual_solves
        exact_prices = resumed.exact_prices
        log.emit(
            f"Resumed checkpoint: {len(portfolio)} committees, "
            f"{int((fixed >= 0).sum())}/{n} probabilities already fixed."
        )
    else:
        fixed = np.full(n, -1.0)  # < 0: not fixed yet
        if initial_panels:
            for panel in initial_panels:
                portfolio.add(tuple(sorted(panel)))
            covered = np.zeros(n, dtype=bool)
            for row in portfolio.rows:
                covered |= row
        else:
            covered = _seed_portfolio(dense, oracle, portfolio, cfg, generator, log, households)
            # agents in no feasible committee get probability 0 up front, as
            # the reference excludes them (leximin.py:286-296,364)
            fixed[~covered] = 0.0
        reduction_counter = dual_solves = exact_prices = 0
    pdhg = cfg.backend == "jax"

    deadline = (
        time.monotonic() + cfg.agent_space_budget_s
        if ts_fallback is not None and cfg.agent_space_budget_s > 0
        else None
    )

    def budget_expired() -> Optional[Distribution]:
        if deadline is None or time.monotonic() <= deadline:
            return None
        prefix = ts_fallback.output_lines
        if log.lines[: len(prefix)] == prefix:
            prefix.extend(log.lines[len(prefix):])
        else:
            ts_fallback.output_lines = list(log.lines)
        msg = log.emit(
            f"Agent-space CG exceeded its {cfg.agent_space_budget_s:.0f} s "
            f"budget with {int((fixed >= 0).sum())}/{n} probabilities "
            f"fixed; shipping the certified type-space profile realized "
            f"to L-inf {ts_fallback.realization_dev:.2e} (above the 1e-3 "
            f"contract — treat per-agent probabilities as exact to that "
            f"tolerance only)."
        )
        ts_fallback.output_lines.append(msg)
        if checkpoint_path is not None:
            # the CG's progress is resumable state: a rerun with the same
            # path resumes the exact CG (unbudgeted: it has no fallback)
            ts_fallback.output_lines.append(log.emit(
                f"Agent-space CG checkpoint preserved at {checkpoint_path}; rerunning with "
                f"the same checkpoint path resumes the exact CG instead of re-deriving "
                f"this fallback."
            ))
        return ts_fallback

    def fix_tranche(sol) -> None:
        """Fix every unfixed agent with certifying dual weight (strict
        complementarity, ``leximin.py:431-443``); when the duals are too
        flat to clear EPS, the largest-weight unfixed agent."""
        nonlocal fixed
        newly = (sol.y > cfg.eps) & (fixed < 0)
        if not newly.any():
            unfixed_idx = np.nonzero(fixed < 0)[0]
            newly = np.zeros(n, dtype=bool)
            newly[unfixed_idx[np.argmax(sol.y[unfixed_idx])]] = True
        fixed = np.where(newly, max(0.0, sol.objective), fixed)

    while (fixed < 0).any():
        expired = budget_expired()
        if expired is not None:
            return expired
        log.emit(f"Fixed {int((fixed >= 0).sum())}/{n} probabilities.")
        if checkpoint_path is not None:
            ckpt.save_cg_state(checkpoint_path, ckpt.CGState(
                portfolio=portfolio.matrix() if len(portfolio) else np.zeros((0, n), bool),
                fixed=fixed, covered=covered, key=ckpt.generator_key(generator),
                reduction_counter=reduction_counter, dual_solves=dual_solves,
                exact_prices=exact_prices, fingerprint=ckpt_fp,
            ))
        dual_warm = None
        # stochastic pricing sits out the rest of a stage after two
        # zero-yield batches; the exact oracle then carries the tail
        stochastic_fails = 0
        while True:
            expired = budget_expired()
            if expired is not None:
                return expired
            P = portfolio.matrix()
            authoritative = True  # sol comes from the exact host LP
            with log.timer("dual_lp"):
                # a portfolio past dual_shard_min_rows on a world of more
                # than one device: the row-sharded PDHG over the mesh, HiGHS
                # only on non-convergence
                mesh = (
                    effective_mesh(cfg, log)
                    if cfg.backend != "highs" and len(portfolio) >= cfg.dual_shard_min_rows
                    else None
                )
                if mesh is not None:
                    from citizensassemblies_tpu_torch.parallel.solver import (
                        solve_dual_lp_pdhg_sharded,
                    )

                    sol = solve_dual_lp_pdhg_sharded(P, fixed, mesh, cfg=cfg)
                    log.count("dual_lp_sharded")
                    dual_warm = None
                    authoritative = not sol.ok
                    if not sol.ok:
                        log.count("dual_lp_host_fallback")
                        sol = solve_dual_lp(P, fixed)
                elif pdhg:
                    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_dual_lp_pdhg

                    # warm-started from the previous inner round (the
                    # portfolio only gains rows); HiGHS on non-convergence
                    sol, dual_warm = solve_dual_lp_pdhg(
                        P, fixed, cfg=cfg, warm=dual_warm, device=device, log=log
                    )
                    authoritative = not sol.ok
                    if not sol.ok:
                        log.count("dual_lp_host_fallback")
                        sol = solve_dual_lp(P, fixed)
                        dual_warm = None
                else:
                    sol = solve_dual_lp(P, fixed)
            dual_solves += 1
            if not sol.ok:
                fixed = _shave(fixed, cfg.fixed_prob_relax_step)
                reduction_counter += 1
                log.emit(f"Dual LP not optimal — reduced fixed probabilities "
                         f"(reduction {reduction_counter}).")
                continue

            # batched stochastic pricing adds several violated columns per
            # LP solve, until the portfolio reaches cfg.max_portfolio
            if stochastic_fails < 2 and len(portfolio) < cfg.max_portfolio:
                from citizensassemblies_tpu_torch.solvers.pricing import (
                    best_violating_panels,
                    stochastic_price,
                )

                with log.timer("stochastic_pricing"):
                    panels, values, ok = stochastic_price(
                        dense, sol.y, generator, cfg=cfg, households=households
                    )
                new = best_violating_panels(
                    panels, values, ok, sol.yhat + cfg.eps, portfolio.seen,
                    max_new=cfg.cg_columns_per_round,
                )
                for panel, _val in new:
                    portfolio.append(panel)
                if new:
                    stochastic_fails = 0
                    continue
                stochastic_fails += 1

            # certification: does any committee beat ŷ + EPS?
            with log.timer("exact_oracle"):
                panel, value = oracle.certify(sol.y, sol.yhat + cfg.eps)
            exact_prices += 1
            log.emit(
                f"Maximin is at most {sol.objective - sol.yhat + value:.2%}, can do "
                f"{sol.objective:.2%} with {len(portfolio)} committees. "
                f"Gap {value - sol.yhat:.2%}."
            )
            if value <= sol.yhat + cfg.eps:
                if not authoritative:
                    # the certificate priced float32 PDHG duals; the
                    # irreversible fix below comes from the exact host solve
                    sol_h = solve_dual_lp(P, fixed)
                    if not sol_h.ok:
                        fixed = _shave(fixed, cfg.fixed_prob_relax_step)
                        reduction_counter += 1
                        log.emit(
                            "Authoritative dual re-solve not optimal — reduced "
                            f"fixed probabilities (reduction {reduction_counter})."
                        )
                        continue
                    sol = sol_h
                    with log.timer("exact_oracle"):
                        panel, value = oracle.certify(sol.y, sol.yhat + cfg.eps)
                    exact_prices += 1
                    if value > sol.yhat + cfg.eps and portfolio.add(panel):
                        continue
                fix_tranche(sol)
                break
            if not portfolio.add(panel):
                # the oracle repeated a known committee despite a positive
                # gap (LP/ILP disagreement): accept the portfolio as converged
                log.emit("Exact oracle repeated a known committee; accepting gap.")
                fix_tranche(sol)
                break

    P = portfolio.matrix()
    with log.timer("final_stage"):
        if final_stage == "l2":
            from citizensassemblies_tpu_torch.solvers.qp import solve_final_primal_l2

            # the JAX package's call passes no cfg and no donor: the default
            # routing and the host ε-LP, then the ascent on ``device``
            probs, eps_dev = solve_final_primal_l2(P, fixed, log=log, device=device)
        elif pdhg:
            from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_final_primal_lp_pdhg

            probs, eps_dev = solve_final_primal_lp_pdhg(P, fixed, cfg=cfg, device=device, log=log)
        else:
            probs, eps_dev = solve_final_primal_lp(P, fixed)
    probs = np.clip(probs, 0.0, 1.0)
    probs = probs / probs.sum()
    allocation = P.T.astype(np.float64) @ probs
    log.gauge("agent_space_dual_solves", dual_solves)
    log.gauge("agent_space_exact_prices", exact_prices)
    log.emit(
        f"Leximin done: {len(portfolio)} committees, {dual_solves} dual LP solves, "
        f"{exact_prices} exact pricing calls, final ε = {eps_dev:.2e}."
    )
    log.emit(format_timers(log.timers))
    if log.counters:
        log.emit(format_counters(log.counters))
    if checkpoint_path is not None:
        ckpt.clear_cg_state(checkpoint_path)
    total_dev = float(np.max(np.abs(allocation - fixed)))
    return Distribution(
        committees=P,
        probabilities=probs,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=fixed,
        covered=covered,
        realization_dev=total_dev,
        contract_ok=bool(total_dev <= CONTRACT_LINF),
    )


def find_distribution_leximin(
    dense: DenseInstance,
    space: Optional[FeatureSpace] = None,
    cfg: Optional[Config] = None,
    log: Optional[RunLog] = None,
    device: DeviceLike = None,
    households: Optional[np.ndarray] = None,
    initial_panels: Optional[List[Tuple[int, ...]]] = None,
    final_stage: str = "lp",
    checkpoint_path: Optional[str] = None,
    ctx=None,
) -> Distribution:
    """Compute the exact LEXIMIN distribution over feasible committees.

    ``device`` carries the decomposition masters, the LEGACY pricing draws
    and (with ``Config.backend == "jax"``) the agent-space dual LPs: CUDA
    unless the caller passes another (``device="cpu"`` runs them on the
    host). Raises when CUDA is absent and no device was passed.
    ``households`` (int[n] group ids, ``core.instance.compute_households``)
    allows at most one member of each household on a panel.
    ``initial_panels`` warm-starts the agent-space portfolio.
    ``final_stage="l2"`` realizes the certificate with the min-L2 stage of
    ``solvers/qp`` (XMIN's) instead of the final LP. ``checkpoint_path``
    saves the run's column-generation state there and resumes from a
    checkpoint of the same problem (see the module docstring); the file is
    removed on success. ``Config.fault_sites`` installs a fault injector
    for the call. ``ctx`` (a ``service.RequestContext``, default the
    ambient one) supplies the ``cfg`` and ``log`` the call is not given and
    is ambient for the solve: its ``deadline`` raises ``DeadlineExceeded``
    from the face loop, its ``injector`` drives the fault sites.

    With households the type-space solve runs on the household quotient,
    as in the JAX package. Where that solve raises a ``SelectionError`` or
    a ``compositions.HouseholdPickError`` (class caps broken), the exact
    agent-space CG runs instead; any other error, a kernel's build or launch
    failure among them, propagates (the JAX package falls back on any
    exception).
    """
    ctx, cfg, log = resolve_context(ctx, cfg, log)
    if final_stage not in ("lp", "l2"):
        raise ValueError(f"final_stage must be 'lp' or 'l2', not {final_stage!r}")
    with use_context(ctx), inject.request_injector(cfg):
        return _leximin_impl(
            dense, space, cfg, log, device, households, initial_panels, final_stage,
            checkpoint_path,
        )


def _leximin_impl(
    dense: DenseInstance, space: Optional[FeatureSpace], cfg: Config, log: Optional[RunLog],
    device: DeviceLike, households: Optional[np.ndarray], initial_panels, final_stage: str,
    checkpoint_path: Optional[str],
) -> Distribution:
    dev = resolve_device(device)
    dense = on_device(dense, dev)
    log = log if log is not None else RunLog(echo=False)
    log.emit("Using leximin algorithm.")
    if space is None:
        space = FeatureSpace(categories=(), cells=())
    oracle = HighsCommitteeOracle(dense, households=households, log=log)
    check_feasible_or_suggest(dense, space, oracle, households)
    ts_fallback = None
    dist = None
    # a valid agent-space checkpoint means CG work to resume: honour it
    has_ckpt = checkpoint_path is not None and ckpt.load_cg_state(
        checkpoint_path, dense.n, ckpt.problem_fingerprint(dense, cfg, households)
    ) is not None
    if not initial_panels and not cfg.force_agent_space and not has_ckpt:
        if households is None:
            dist = _typespace_leximin(
                dense, cfg, log, dev, final_stage, checkpoint_path=checkpoint_path
            )
        else:
            dist = _quotient_leximin(dense, households, cfg, log, dev, final_stage)
    if dist is not None:
        if dist.contract_ok or final_stage == "l2":
            # the l2 stage never falls back (its callers gate the deviation
            # with their own band); contract_ok still reports it
            return dist
        # contract miss: run the exact agent-space CG, keeping the certified
        # type-space profile as the budget-expiry rescue
        log.emit(
            f"Type-space realization missed the 1e-3 contract "
            f"(dev {dist.realization_dev:.2e}); falling back to agent-space CG."
        )
        ts_fallback = dist
    return _agent_space_leximin(
        dense, cfg, log, dev, oracle, initial_panels, ts_fallback, final_stage, households,
        checkpoint_path,
    )


def _quotient_leximin(
    dense: DenseInstance, households: np.ndarray, cfg: Config, log: RunLog, device,
    final_stage: str,
) -> Optional[Distribution]:
    """The type-space solve on the household quotient (orbit space), or
    None when it raises one of the two errors after which the agent-space
    CG is the way on (see ``find_distribution_leximin``)."""
    from citizensassemblies_tpu_torch.solvers.compositions import HouseholdPickError
    from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient

    quotient = build_household_quotient(dense, households)
    log.emit(
        f"Household quotient: {quotient.n_classes} household classes over "
        f"{len(quotient.class_of_household)} households — solving in orbit space."
    )
    try:
        return _typespace_leximin(
            quotient.dense_aug, cfg, log, device, final_stage, households=quotient.households
        )
    except (SelectionError, HouseholdPickError) as exc:
        log.emit(
            f"Household quotient solve failed ({type(exc).__name__}: {exc}); "
            f"falling back to agent-space CG."
        )
        return None
