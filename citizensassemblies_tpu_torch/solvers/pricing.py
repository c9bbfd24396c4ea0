"""Stochastic committee pricing for the agent-space column generation.

Each inner round needs feasible committees with ``Σ_{i∈C} y_i`` above the
dual cap ŷ. Instead of one exact ILP per round, one batch of thousands of
quota-feasible committees is drawn on the instance's device by the LEGACY
sampler, each chain steered toward high-weight agents at its own inverse
temperature (Gumbel perturbations of ``β·ŵ``), and the best distinct
candidates are returned. The exact oracle then certifies that none remain,
so the termination test stays exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance
from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch
from citizensassemblies_tpu_torch.utils import device as _device
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.precision import iterate_dtype


def beta_ladder(batch: int, lo: float = -1.0, hi: float = 3.5) -> np.ndarray:
    """Log-spaced inverse-temperature ladder β ∈ [10^lo, 10^hi]: low β
    explores, high β exploits the dual weights."""
    return np.logspace(lo, hi, batch)


def _pricing_scores(weights: torch.Tensor, batch: int) -> torch.Tensor:
    """[B, n] member-pick scores: β_b · ŵ with the log-spaced β ladder."""
    w = weights / (weights.abs().max() + 1e-12)
    betas = torch.as_tensor(beta_ladder(batch), dtype=iterate_dtype(w.dtype), device=w.device)
    return betas[:, None] * w[None, :]


def stochastic_price(
    dense: DenseInstance,
    weights: np.ndarray,
    generator: torch.Generator,
    batch: Optional[int] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample a batch of feasible committees biased toward high ``weights``
    on the instance's device. Returns ``(panels int[B, k] sorted rows,
    values float64[B], ok bool[B])`` with ``values[b] = Σ_{i∈panel_b}
    weights[i]`` (meaningful where ``ok``)."""
    cfg = cfg or default_config()
    B = batch or cfg.pricing_batch
    if batch is None and not _device.on_accelerator(dense.device):
        # on the CPU the sweep is serial, and a batch exists only to surface
        # ~cg_columns_per_round violating panels per LP solve
        B = min(B, 1024)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=dense.device)
    panels, ok = sample_panels_batch(
        dense, generator, B, scores=_pricing_scores(w, B), households=households, cfg=cfg
    )
    panels = np.sort(panels.cpu().numpy(), axis=1)
    values = np.asarray(weights, dtype=np.float64)[panels].sum(axis=1)
    return panels, values, ok.cpu().numpy()


def best_violating_panels(
    panels: np.ndarray,
    values: np.ndarray,
    ok: np.ndarray,
    threshold: float,
    existing: set,
    max_new: int,
) -> list:
    """Up to ``max_new`` distinct feasible panels with value above
    ``threshold`` (= ŷ + EPS), strongest first, skipping panels already in
    ``existing`` (the caller's portfolio dedup set, which gains the picks)."""
    out = []
    for idx in np.argsort(-values):
        if len(out) >= max_new:
            break
        if not ok[idx] or values[idx] <= threshold:
            continue
        tup = tuple(panels[idx].tolist())
        if tup in existing:
            continue
        existing.add(tup)
        out.append((tup, values[idx]))
    return out
