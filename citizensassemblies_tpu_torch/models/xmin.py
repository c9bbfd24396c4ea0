"""XMIN: LEXIMIN's per-agent probabilities spread over a maximal panel support.

The fork's third algorithm (the reference's ``xmin.py:484-544``) keeps
LEXIMIN's per-agent selection probabilities but redistributes the panel
probabilities over many more panels, so repeated assemblies do not keep
drawing from the same small portfolio. The reference appends one fresh
LEGACY panel at a time and re-solves the whole column generation with a
final QP after each (O(n) LP re-solves).

Here, as in the JAX package, the portfolio grows in batched LEGACY draws
(``models/legacy.sample_panels_batch`` on the run's device) until
``Config.xmin_iterations_factor · n`` distinct new panels are found, the
LEXIMIN probabilities are computed once, and the min-L2 stage
(``solvers/qp.solve_final_primal_l2``) runs once over the grown portfolio
with the LEXIMIN distribution as its ε-floor donor. A closed-form blend with
the uniform distribution over the new panels then maximizes the support
inside the ``Config.xmin_linf_band`` budget. With ``households`` the
LEXIMIN seed and every expansion draw are household-disjoint.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance, FeatureSpace, on_device
from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch
from citizensassemblies_tpu_torch.models.leximin import (
    CONTRACT_LINF,
    Distribution,
    find_distribution_leximin,
)
from citizensassemblies_tpu_torch.solvers.qp import solve_final_primal_l2
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog


def find_distribution_xmin(
    dense: DenseInstance,
    space: Optional[FeatureSpace] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    log: Optional[RunLog] = None,
    leximin: Optional[Distribution] = None,
    device: DeviceLike = None,
    ctx=None,
) -> Distribution:
    """The XMIN distribution: leximin-optimal per-agent probabilities over an
    expanded, support-maximized portfolio, on ``device`` (CUDA unless the
    caller passes another; raises when CUDA is absent and no device was
    passed). ``households`` (int[n] group ids) allows at most one member of
    each household on a panel.

    ``leximin`` supplies a precomputed LEXIMIN distribution for the same
    problem and configuration, skipping that solve (for one from the JAX
    package, ``interop.distribution_from_arrays``). ``Config.fault_sites``
    installs a fault injector for the call. ``ctx`` (a
    ``service.RequestContext``, default the ambient one) supplies the
    ``cfg`` and ``log`` the call is not given and is ambient for the solve,
    as in ``find_distribution_leximin``."""
    ctx, cfg, log = resolve_context(ctx, cfg, log)
    dev = resolve_device(device)
    dense = on_device(dense, dev)
    with use_context(ctx), inject.request_injector(cfg):
        return _xmin_impl(dense, space, cfg, households, log, leximin, dev)


def _xmin_impl(
    dense: DenseInstance,
    space: Optional[FeatureSpace],
    cfg: Config,
    households: Optional[np.ndarray],
    log: RunLog,
    leximin: Optional[Distribution],
    device: torch.device,
) -> Distribution:
    # 1) exact leximin (fixes every agent's probability; xmin.py:506-508)
    if leximin is None:
        leximin = find_distribution_leximin(
            dense, space, cfg=cfg, log=log, device=device, households=households
        )
    n = dense.n

    # 2) portfolio expansion: collect target_new DISTINCT new panels (the
    #    reference's 5n one-panel iterations, xmin.py:511-522, in batches),
    #    within a total-draw bound of dedup_attempts_factor·n tries per
    #    addition (the reference's 3n, xmin.py:466)
    target_new = max(1, int(round(cfg.xmin_iterations_factor * n)))
    max_draws = int(cfg.xmin_dedup_attempts_factor * n * target_new)
    # dedup keys are the bytes of the sorted member rows: no Python tuple
    # per panel at sf_e scale (~14k panels of 110 members)
    seen = {
        np.sort(np.nonzero(row)[0]).astype(np.int32).tobytes()
        for row in leximin.committees
    }
    new_members: List[np.ndarray] = []
    generator = torch.Generator(device=device).manual_seed(int(cfg.solver_seed) + 1)
    drawn = 0
    while len(new_members) < target_new and drawn < max_draws:
        B = min(cfg.pricing_batch, max_draws - drawn)
        with log.timer("xmin_draws"):
            panels, ok = sample_panels_batch(
                dense, generator, B, households=households, cfg=cfg
            )
            panels = np.sort(panels.cpu().numpy(), axis=1).astype(np.int32)
            ok = ok.cpu().numpy()
        drawn += B
        with log.timer("xmin_dedup"):
            # in-batch dedup vectorized, cross-batch through the bytes set,
            # in FIRST-DRAWN order (np.unique sorts rows lexicographically;
            # truncating that order at target_new would bias the last batch
            # toward low-index agents)
            ok_panels = panels[ok]
            _, first = np.unique(ok_panels, axis=0, return_index=True)
            for prow in ok_panels[np.sort(first)]:
                kb = prow.tobytes()
                if kb not in seen:
                    seen.add(kb)
                    new_members.append(prow)
                    if len(new_members) >= target_new:
                        break
    P = leximin.committees
    if new_members:
        members = np.stack(new_members)
        new_rows = np.zeros((len(members), n), dtype=bool)
        new_rows[np.arange(len(members))[:, None], members] = True
        P = np.concatenate([leximin.committees, new_rows], axis=0)
    n_new = len(new_members)
    n_lex = leximin.committees.shape[0]
    log.emit(
        f"XMIN expansion: portfolio grew from {n_lex} to {P.shape[0]} committees "
        f"({drawn} draws)."
    )

    # 3) min-L2 redistribution over the grown portfolio (xmin.py:447-455),
    #    the LEXIMIN probabilities as the feasible ε-floor donor; the anchor
    #    gate tracks this run's spread band
    with log.timer("xmin_l2"):
        probs, eps_dev = solve_final_primal_l2(
            P, leximin.fixed_probabilities, iters=cfg.xmin_qp_iters, log=log,
            floor_donor=leximin.probabilities, cfg=cfg,
            anchor_if_above=0.5 * cfg.xmin_linf_band, device=device,
        )
    probs = np.clip(probs, 0.0, 1.0)
    probs = probs / probs.sum()
    allocation = P.T.astype(np.float64) @ probs

    # 4) maximal blend toward the uniform distribution over the expansion
    #    panels inside the L∞ band: by convexity the mix (1−γ)·p + γ·q
    #    deviates by at most (1−γ)·dev(p) + γ·dev(q), so γ is exact
    #    arithmetic — the largest weight keeping the deviation in the band
    if n_new:
        PT = P.T.astype(np.float64)
        t = leximin.fixed_probabilities
        band = cfg.xmin_linf_band
        dev_l2 = float(np.abs(allocation - t).max())
        if dev_l2 > 0.9 * band:
            # the ascent's spread overshot the band: keep its iterate only
            # as a donor and restart the mixture from the leximin
            # probabilities, whose deviation is the decomposition ε
            p_l2 = probs
            probs = np.zeros(P.shape[0])
            probs[:n_lex] = leximin.probabilities
            allocation = PT @ probs
        else:
            p_l2 = None
        dev_now = float(np.abs(allocation - t).max())
        # donors: the uniform over the expansion panels (full expansion
        # support, large deviation) and the L2 iterate; keep the blend with
        # the larger realized support
        donors = [np.concatenate([np.zeros(n_lex), np.full(n_new, 1.0 / n_new)])]
        if p_l2 is not None:
            donors.append(p_l2)
        best = None
        for q in donors:
            dev_q = float(np.abs(PT @ q - t).max())
            if dev_q <= band:
                gamma = 1.0
            elif dev_now < band:
                gamma = (band - dev_now) / (dev_q - dev_now)
            else:
                continue
            cand = (1.0 - gamma) * probs + gamma * q
            support = int((cand > cfg.support_eps).sum())
            if best is None or support > best[1]:
                best = (cand, support, gamma)
        if best is not None and best[1] > int((probs > cfg.support_eps).sum()):
            probs, support, gamma = best
            allocation = PT @ probs
            log.emit(
                f"XMIN spread: γ = {gamma:.4f} over {n_new} expansion panels → support "
                f"{support} (L∞ dev {float(np.abs(allocation - t).max()):.2e} ≤ band {band:g})."
            )
    if log.counters.get("lp_batch_l2_fused"):
        log.emit(
            "XMIN L2 stage ran fused on the batched LP engine "
            "(anchor + floor pick + spread in one device core)."
        )
    log.emit(f"XMIN done: support {(probs > 1e-11).sum()} committees, ε = {eps_dev:.2e}.")
    final_dev = float(np.abs(allocation - leximin.fixed_probabilities).max())
    return Distribution(
        committees=P,
        probabilities=probs,
        allocation=allocation,
        output_lines=list(log.lines),
        fixed_probabilities=leximin.fixed_probabilities,
        covered=leximin.covered,
        realization_dev=final_dev,
        contract_ok=bool(final_dev <= CONTRACT_LINF),
    )
