"""Pairwise co-selection probabilities as dense symmetric matrices.

For one-hot panel rows ``S ∈ {0,1}^{B×n}`` and panel weights ``w``, the pair
co-selection mass is ``M = Sᵀ diag(w) S`` with a zeroed diagonal, built in
chunks of panels so the one-hot buffer stays at most ``chunk × n``.
"""

from __future__ import annotations

import numpy as np
import torch

from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device


def _device_of(x, device: DeviceLike) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _pair_chunk(panels: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    B = panels.shape[0]
    S = torch.zeros((B, n), dtype=torch.float32, device=panels.device)
    S.scatter_(1, panels, 1.0)
    M = (S * weights[:, None]).t() @ S
    return M.fill_diagonal_(0.0)


def pair_matrix_from_panels(
    panels, weights=None, *, n: int, chunk: int = 2048, device: DeviceLike = None
) -> torch.Tensor:
    """The pair matrix of a batch of panels (int ``[B, k]``), on ``device``
    (the panels' device for a tensor, else CUDA unless the caller passes
    another). ``weights`` defaults to 1 per panel (Monte-Carlo counting;
    divide by the draw count afterwards)."""
    dev = _device_of(panels, device)
    panels = torch.as_tensor(panels).to(device=dev, dtype=torch.int64)
    B = panels.shape[0]
    if weights is None:
        weights = torch.ones(B, dtype=torch.float32, device=dev)
    else:
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    M = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for start in range(0, B, chunk):
        M += _pair_chunk(panels[start : start + chunk], weights[start : start + chunk], n)
    return M


def pair_matrix_from_portfolio(P, probs, device: DeviceLike = None) -> torch.Tensor:
    """Pair matrix of a weighted portfolio: ``Pᵀ diag(p) P`` with zero
    diagonal."""
    dev = _device_of(P, device)
    P = torch.as_tensor(P, dtype=torch.float32, device=dev)
    probs = torch.as_tensor(probs, dtype=torch.float32, device=dev)
    return ((P * probs[:, None]).t() @ P).fill_diagonal_(0.0)


def sorted_pair_values(M) -> np.ndarray:
    """All C(n,2) upper-triangle values sorted ascending."""
    M = M.cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    vals = M[np.triu_indices(M.shape[0], k=1)]
    vals.sort()
    return vals


def uniform_pair_value(n: int) -> float:
    """The uniform baseline 1/C(n,2)."""
    return 1.0 / (n * (n - 1) // 2)
