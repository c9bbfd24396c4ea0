"""Ratio products: per-agent over-representation scores.

Reference ``analysis.py:411-431``: for each (category, feature) cell, the
representation ratio is ``pool_share / (quota_midpoint / k)``; an agent's ratio
product is the product of her cells' ratios. On the dense representation this
is one log-space matvec: ``exp(A @ log r)`` where ``r ∈ R^F`` is the per-cell
ratio vector.
"""

from __future__ import annotations

import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance


def compute_ratio_products(dense: DenseInstance) -> torch.Tensor:
    """float32[n] ratio products in agent order (``analysis.py:427-431``), on
    the dense instance's device."""
    A = dense.A.to(torch.float32)
    n = A.shape[0]
    pool_share = torch.sum(A, dim=0) / n
    quota_midpoint = (dense.qmin + dense.qmax).to(torch.float32) / 2.0
    cell_ratio = pool_share * dense.k / torch.clamp(quota_midpoint, min=1e-12)
    # cells with no pool members never touch any agent's product (A[i,f] = 0);
    # mask them so 0 * log(0) cannot poison the matvec with NaNs (the
    # reference only materializes ratios for observed cells, analysis.py:415-425)
    log_ratio = torch.where(
        pool_share > 0, torch.log(torch.clamp(cell_ratio, min=1e-30)), torch.zeros_like(cell_ratio)
    )
    return torch.exp(A @ log_ratio)
