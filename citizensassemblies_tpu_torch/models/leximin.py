"""LEXIMIN: exact lexicographic-maximin panel distributions, type space.

Agents with identical feature rows are interchangeable, so the problem
collapses onto the T distinct agent types (``solvers/native_oracle.TypeReduction``):

* at most ``Config.enum_max_types`` types: every feasible composition is
  enumerated and the leximin stage LPs run over the whole enumeration
  (``solvers/compositions.leximin_over_compositions``);
* more types: the relaxation profile is certified on the host and realized
  by one face decomposition whose masters run on ``device``
  (``solvers/cg_typespace.leximin_cg_typespace``).

Either certificate is then realized as concrete panels
(``compositions.decompose_with_pricing``) and checked against the 1e-3 L∞
contract on the per-agent allocation.

Not in this package yet, each raising ``NotImplementedError``: the
agent-space column generation (also the fallback after a contract miss),
households, ``final_stage="l2"``, ``initial_panels`` and checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance, FeatureSpace
from citizensassemblies_tpu_torch.solvers.highs_backend import check_feasible_or_suggest
from citizensassemblies_tpu_torch.utils.config import Config, check_slice_config, default_config
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
    dense: DenseInstance, cfg: Config, log: RunLog, device
) -> Distribution:
    """Exact leximin in type space: enumeration when the type count is
    small, the relaxation profile plus one face decomposition otherwise."""
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
            ts = leximin_over_compositions(comps, reduction.msize, probe_tol=cfg.probe_tol, log=log)
    else:
        from citizensassemblies_tpu_torch.solvers.cg_typespace import leximin_cg_typespace

        log.emit(
            f"Type-space column generation: {reduction.T} agent types "
            f"(enumeration over budget)."
        )
        with log.timer("typespace_cg"):
            ts = leximin_cg_typespace(dense, reduction, cfg=cfg, log=log, device=device)
    return realize_typespace(dense, reduction, ts, cfg, log, enumerated=comps is not None)


def realize_typespace(
    dense: DenseInstance,
    reduction,
    ts,
    cfg: Config,
    log: RunLog,
    enumerated: bool = True,
) -> Distribution:
    """Realize a type-space leximin certificate (compositions,
    probabilities, type values) as a concrete panel portfolio."""
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


def find_distribution_leximin(
    dense: DenseInstance,
    space: Optional[FeatureSpace] = None,
    cfg: Optional[Config] = None,
    log: Optional[RunLog] = None,
    device: DeviceLike = None,
    households: Optional[np.ndarray] = None,
    initial_panels=None,
    final_stage: str = "lp",
    checkpoint_path: Optional[str] = None,
) -> Distribution:
    """Compute the exact LEXIMIN distribution over feasible committees.

    ``device`` carries the decomposition masters: CUDA unless the caller
    passes another (``device="cpu"`` runs every master on the host LP, as
    the JAX package does on its CPU backend). Raises when CUDA is absent and
    no device was passed.
    """
    cfg = cfg or default_config()
    check_slice_config(cfg)
    if households is not None:
        raise NotImplementedError("households need ROADMAP queue A item 'households'")
    if final_stage != "lp":
        raise NotImplementedError(
            "final_stage='l2' needs the XMIN L2 stage (ROADMAP queue A item 'XMIN')"
        )
    if initial_panels or checkpoint_path is not None:
        raise NotImplementedError(
            "initial_panels and checkpoint_path need ROADMAP queue A item 'agent-space path'"
        )
    dev = resolve_device(device)
    log = log if log is not None else RunLog(echo=False)
    log.emit("Using leximin algorithm.")
    if space is None:
        space = FeatureSpace(categories=(), cells=())
    check_feasible_or_suggest(dense, space)
    dist = _typespace_leximin(dense, cfg, log, dev)
    if not dist.contract_ok:
        # the JAX package falls back to its agent-space CG here
        log.emit(
            f"Type-space realization missed the 1e-3 contract "
            f"(dev {dist.realization_dev:.2e})."
        )
        raise NotImplementedError(
            "the agent-space fallback after a contract miss needs ROADMAP queue A "
            "item 'agent-space path'"
        )
    return dist
