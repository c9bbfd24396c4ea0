"""Dropout-robust LEXIMIN: maximize the realized minimum selection probability.

Each agent i carries a no-show probability ``q_i`` (attendance ``w_i = 1 −
q_i``). A seat given to agent i is realized with probability ``w_i`` (the
``"type"`` replacement policy refills a no-show's seat from its own base
type, so nobody else's realization changes; ``parallel/mc.py``). The model
leximin-maximizes the realized seating probability ``w_i · π_i``.

The fold into the composition engine: its allocation matrix is ``c_t /
m_t``, and every certificate reads only that matrix, so
``leximin_over_compositions(comps, msize / w)`` optimizes ``w_t · c_t /
m_t`` with the probe certification unchanged. Attendance enters the type
structure as a one-hot bucket category with vacuous quotas ``[0, k]``:
agents of one base type but different attendance become distinct product
types. The product multiplies the type count by the occupied buckets; past
``Config.enum_max_types`` (or when the enumeration runs over its budget) the
model runs the attendance-unaware LEXIMIN instead and says so in
``scenario_audit["fallback"]``.

The solves run on ``device`` (CUDA unless the caller passes another): the
fallback LEXIMIN's face loop launches the two-sided block kernel and the
ELL gather there, and the Monte-Carlo audit draws there, from a
``torch.Generator`` on that device seeded with ``seed`` (the JAX package
draws from ``jax.random.PRNGKey(seed)``: the two packages' draws are
different streams of the same law). ``ctx`` (``service/context.py``) is
ambient for the call; its deadline is checked before the reduction, the
LEXIMIN, the decomposition and the audit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    dense_instance,
    on_device,
)
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog

#: no-show probabilities are clipped here: a ``q → 1`` agent would blow the
#: divisor ``m/w`` up without bound
_MAX_NOSHOW = 0.95


@dataclasses.dataclass
class DropoutDistribution:
    """A panel distribution optimized for realized (post-dropout) equity.

    ``allocation`` and ``fixed_probabilities`` are selection probabilities
    (seated on paper); ``realized_values`` are the certified
    attendance-weighted values the model leximin-maximized. ``type_id``
    labels the base types of the original instance, which the ``"type"``
    replacement policy matches on.
    """

    committees: np.ndarray  # bool[C, n] portfolio matrix
    probabilities: np.ndarray  # float64[C]
    allocation: np.ndarray  # float64[n] selection probability realized
    output_lines: List[str]
    fixed_probabilities: np.ndarray  # float64[n] selection-space targets
    covered: np.ndarray  # bool[n]
    attendance: np.ndarray  # float64[n] show-up probability w
    realized_values: np.ndarray  # float64[n] certified w·π leximin values
    type_id: np.ndarray  # int32[n] base-type labels
    realization_dev: float = 0.0
    contract_ok: bool = True
    scenario_audit: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def panels(self) -> List[Tuple[int, ...]]:
        return [tuple(np.nonzero(row)[0].tolist()) for row in self.committees]

    def support(self, eps: float = 1e-11) -> List[Tuple[int, ...]]:
        return [
            tuple(np.nonzero(row)[0].tolist())
            for row, p in zip(self.committees, self.probabilities)
            if p > eps
        ]


def _attendance_buckets(
    noshow: np.ndarray, n_buckets: int
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Quantize no-show probabilities into equal-width buckets over [0, 1].

    Returns ``(bucket int32[n] dense ids, w_rep float64[n_occupied] mean
    attendance per occupied bucket, L∞ quantization error)``. Only occupied
    buckets get ids, so the product type space grows with the attendance
    diversity present, not with the knob.
    """
    q = np.clip(np.asarray(noshow, dtype=np.float64), 0.0, _MAX_NOSHOW)
    raw = np.minimum((q * n_buckets).astype(np.int64), n_buckets - 1)
    occupied, bucket = np.unique(raw, return_inverse=True)
    w = 1.0 - q
    w_rep = np.array([w[bucket == b].mean() for b in range(len(occupied))], dtype=np.float64)
    linf = float(np.max(np.abs(w - w_rep[bucket]))) if len(w) else 0.0
    return bucket.astype(np.int32), w_rep, linf


def _augment_with_buckets(dense: DenseInstance, bucket: np.ndarray, n_occupied: int) -> DenseInstance:
    """``dense`` with a one-hot attendance-bucket category of vacuous quotas
    ``[0, k]`` appended, on the same device: the feasible panels are
    unchanged, the type reduction tells attendance classes apart."""
    A = dense.A_np
    n = A.shape[0]
    onehot = np.zeros((n, n_occupied), dtype=bool)
    onehot[np.arange(n), bucket] = True
    return dense_instance(
        np.hstack([A, onehot]),
        np.concatenate([dense.qmin_np, np.zeros(n_occupied, dtype=np.int32)]),
        np.concatenate([dense.qmax_np, np.full(n_occupied, dense.k, dtype=np.int32)]),
        np.concatenate([
            np.asarray(dense.cat_of_feature_np, dtype=np.int32),
            np.full(n_occupied, dense.n_categories, dtype=np.int32),
        ]),
        dense.k,
        dense.n_categories + 1,
        device=dense.device,
    )


def _attendance_unaware_fallback(
    dense: DenseInstance,
    space: Optional[FeatureSpace],
    w: np.ndarray,
    cfg: Config,
    log: RunLog,
    reason: str,
    audit: Dict[str, Any],
) -> DropoutDistribution:
    """The plain (attendance-blind) LEXIMIN, flagged in the audit: the
    selection-space certificate still holds, only the objective is not
    attendance-weighted. Its realization is audited like the aware path's."""
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    log.emit(f"Dropout model falling back to attendance-unaware leximin: {reason}")
    dist = find_distribution_leximin(dense, space, cfg=cfg, log=log, device=dense.device)
    audit["fallback"] = reason
    realized = w * dist.allocation
    audit["certified_min_realized"] = round(
        float(realized[dist.covered].min()) if dist.covered.any() else 0.0, 6
    )
    result = DropoutDistribution(
        committees=dist.committees,
        probabilities=dist.probabilities,
        allocation=dist.allocation,
        output_lines=dist.output_lines,
        fixed_probabilities=dist.fixed_probabilities,
        covered=dist.covered,
        attendance=w,
        realized_values=realized,
        type_id=TypeReduction(dense).type_id.astype(np.int32),
        realization_dev=dist.realization_dev,
        contract_ok=dist.contract_ok,
        scenario_audit=audit,
    )
    if cfg.scenario_mc_draws > 0:
        audit["mc"] = evaluate_realization(
            result, dense, cfg=cfg, draws=cfg.scenario_mc_draws, policy=cfg.scenario_replacement,
        )
    return result


def find_distribution_dropout(
    dense: DenseInstance,
    space: Optional[FeatureSpace] = None,
    dropout: Optional[np.ndarray] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    log: Optional[RunLog] = None,
    ctx=None,
    device: DeviceLike = None,
) -> DropoutDistribution:
    """The dropout-robust LEXIMIN distribution, solved on ``device``.

    ``dropout`` is the float[n] per-agent no-show probability (clipped to
    ``[0, 0.95]``). The certified objective is the realized seating
    probability ``w_i · π_i``; the returned ``allocation`` is the
    selection-space marginal the portfolio realizes. With
    ``Config.scenario_mc_draws > 0`` a Monte-Carlo realization audit under
    ``Config.scenario_replacement`` is stamped on ``scenario_audit["mc"]``.
    """
    from citizensassemblies_tpu_torch.scenarios import ScenarioError

    ctx, cfg, log = resolve_context(ctx, cfg, log)
    if households is not None:
        raise ScenarioError(
            "the dropout model does not support household constraints yet "
            "(the bucket augmentation and the household quotient both rewrite "
            "the instance)"
        )
    if dropout is None:
        raise ScenarioError("the dropout model requires per-agent no-show probabilities")
    dropout = np.asarray(dropout, dtype=np.float64).reshape(-1)
    if dropout.shape[0] != dense.n:
        raise ScenarioError(f"dropout has {dropout.shape[0]} entries for {dense.n} agents")
    dense = on_device(dense, resolve_device(device))
    with use_context(ctx):
        return _dropout_impl(dense, space, dropout, cfg, log, ctx)


def _check_deadline(ctx, where: str, log: RunLog) -> None:
    if ctx is not None and ctx.deadline is not None:
        ctx.deadline.check(where, log)


def _dropout_impl(
    dense: DenseInstance,
    space: Optional[FeatureSpace],
    dropout: np.ndarray,
    cfg: Config,
    log: RunLog,
    ctx,
) -> DropoutDistribution:
    from citizensassemblies_tpu_torch.solvers.compositions import (
        decompose_with_pricing,
        enumerate_compositions,
        leximin_over_compositions,
    )
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    log.emit("Using dropout-robust leximin (scenarios/dropout).")
    w = 1.0 - np.clip(dropout, 0.0, _MAX_NOSHOW)
    bucket, w_rep, quant_err = _attendance_buckets(
        dropout, max(1, int(cfg.scenario_dropout_buckets))
    )
    audit: Dict[str, Any] = {
        "model": "dropout",
        "buckets": int(len(w_rep)),
        "quantization_linf": round(quant_err, 6),
        "replacement": cfg.scenario_replacement,
    }
    _check_deadline(ctx, "scenario_dropout_reduce", log)
    reduction = TypeReduction(_augment_with_buckets(dense, bucket, len(w_rep)))
    audit["types"] = int(reduction.T)
    if reduction.T > cfg.enum_max_types:
        return _attendance_unaware_fallback(
            dense, space, w, cfg, log,
            f"product type-space has {reduction.T} types "
            f"(> enum_max_types={cfg.enum_max_types})",
            audit,
        )
    comps = enumerate_compositions(reduction, cap=cfg.enum_cap, node_budget=cfg.enum_node_budget)
    if comps is None or len(comps) == 0:
        return _attendance_unaware_fallback(
            dense, space, w, cfg, log,
            "product composition enumeration exceeded its budget"
            if comps is None
            else "no feasible composition in the product type-space",
            audit,
        )
    # every member of a product type shares one bucket by construction
    w_type = w_rep[bucket[np.array([m[0] for m in reduction.members])]]
    log.emit(
        f"Dropout product type-space: {reduction.T} types over "
        f"{len(w_rep)} attendance buckets, {len(comps)} feasible compositions."
    )
    _check_deadline(ctx, "scenario_dropout_leximin", log)
    with log.timer("scenario_leximin"):
        # dividing msize by the attendance weight turns the engine's c/m into
        # w·c/m: certified realized values
        ts = leximin_over_compositions(
            comps, reduction.msize.astype(np.float64) / w_type, probe_tol=cfg.probe_tol,
            log=log, cfg=cfg, device=dense.device,
        )
    m = reduction.msize.astype(np.float64)
    # the selection-space marginal of the composition mixture (plain msize
    # divisor): the decomposition target, constant within a type
    sel_type = ts.probabilities @ (ts.compositions.astype(np.float64) / m[None, :])
    target_agent = sel_type[reduction.type_id]
    _check_deadline(ctx, "scenario_dropout_decompose", log)
    with log.timer("scenario_decompose"):
        P, probs, eps_dev = decompose_with_pricing(
            ts.compositions, ts.probabilities, reduction, target_agent,
            budget=cfg.decompose_budget, support_eps=cfg.support_eps, log=log,
            tol=max(cfg.decomp_tol, 2e-5),
        )
    probs = np.clip(probs, 0.0, 1.0)
    keep = probs > cfg.support_eps
    P, probs = P[keep], probs[keep]
    probs = probs / probs.sum()
    allocation = P.T.astype(np.float64) @ probs
    covered = (ts.compositions.max(axis=0) > 0)[reduction.type_id]
    realized_values = ts.type_values[reduction.type_id]
    total_dev = float(np.max(np.abs(allocation - target_agent)))
    w_agent = w_type[reduction.type_id]
    min_realized = float((w_agent * allocation)[covered].min()) if covered.any() else 0.0
    audit["certified_min_realized"] = round(
        float(realized_values[covered].min()) if covered.any() else 0.0, 6
    )
    log.emit(
        f"Dropout leximin done: {ts.stages} stages, {ts.lp_solves} LP solves, "
        f"{P.shape[0]} panels, ε = {eps_dev:.2e}, realized-min "
        f"{min_realized:.4f}, max |alloc − target| = {total_dev:.2e}."
    )
    result = DropoutDistribution(
        committees=P,
        probabilities=probs,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=target_agent,
        covered=covered,
        attendance=w,
        realized_values=realized_values,
        type_id=TypeReduction(dense).type_id.astype(np.int32),
        realization_dev=total_dev,
        contract_ok=bool(total_dev <= 1e-3),
        scenario_audit=audit,
    )
    if cfg.scenario_mc_draws > 0:
        _check_deadline(ctx, "scenario_dropout_mc", log)
        audit["mc"] = evaluate_realization(
            result, dense, cfg=cfg, draws=cfg.scenario_mc_draws, policy=cfg.scenario_replacement,
        )
        log.emit(
            f"MC realization audit ({cfg.scenario_replacement}, "
            f"{audit['mc']['draws']} draws): realized-min "
            f"{audit['mc']['realized_min']:.4f}, quota-ok rate "
            f"{audit['mc']['quota_ok_rate']:.3f}."
        )
    return result


def evaluate_realization(
    dist,
    dense: DenseInstance,
    cfg: Optional[Config] = None,
    draws: int = 4_096,
    policy: str = "type",
    seed: int = 0,
    mesh=None,
) -> Dict[str, Any]:
    """Monte-Carlo realized-outcome audit of a panel distribution under
    dropout, on ``dense``'s device. ``dist`` needs ``committees`` and
    ``probabilities`` plus ``attendance``, ``type_id`` and ``covered`` (a
    :class:`DropoutDistribution`, or any object with those arrays).
    ``realized_min`` is the least covered agent's probability of being
    seated on a valid realized panel (one that keeps every quota);
    ``realized_min_any`` counts every realized panel. Returns a plain dict.
    """
    from citizensassemblies_tpu_torch.parallel.mc import dropout_realization_round

    real = dropout_realization_round(
        np.asarray(dist.committees, dtype=bool),
        np.asarray(dist.probabilities, dtype=np.float64),
        np.asarray(dist.attendance, dtype=np.float64),
        np.asarray(dist.type_id, dtype=np.int32),
        dense,
        torch.Generator(device=dense.device).manual_seed(int(seed)),
        int(draws),
        policy=policy,
        mesh=mesh,
    )
    freq = real.frequencies_valid
    freq_any = real.frequencies
    covered = np.asarray(dist.covered, dtype=bool)
    return {
        "policy": policy,
        "draws": int(real.draws),
        "realized_min": round(float(freq[covered].min()) if covered.any() else 0.0, 6),
        "realized_min_any": round(float(freq_any[covered].min()) if covered.any() else 0.0, 6),
        "realized_mean": round(float(freq.mean()), 6),
        "quota_ok_rate": round(real.quota_ok_rate, 6),
        "fill_rate": round(real.fill_rate, 6),
    }
