"""Fairness statistics over probability allocations, as torch reductions.

Replaces the reference's dict-based statistics (``analysis.py:231-268``):
Gini coefficient (Damgaard & Weiner formulation, ``analysis.py:243-245``),
geometric mean with the LEGACY-only 1e-4 floor (``analysis.py:247-251``),
minimum probability, the share-below-threshold metric (``analysis.py:600``),
and the Jeffreys 99% upper confidence bound (``analysis.py:258-268``, on the
host via scipy: a reporting-path scalar).

An allocation here is a dense vector ``π ∈ [0,1]^n`` in agent-id order; given a
portfolio matrix ``P ∈ {0,1}^{|C|×n}`` and panel probabilities ``p``,
``π = P.T @ p`` (:func:`allocation_from_portfolio`). The reductions run in
float32 on the tensor's device, as the JAX package computes them with 64-bit
mode off; ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ProbAllocationStats:
    """Mirror of the reference's stats container (``analysis.py:61-65``)."""

    gini: float
    geometric_mean: float
    min: float


def _on(x, device: DeviceLike, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: on its own device for a tensor and no
    ``device``, else on ``device`` (CUDA unless the caller passes another)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def allocation_from_portfolio(P, probs, device: DeviceLike = None) -> torch.Tensor:
    """π_i = Σ_{panels P ∋ i} p_P (the adapter loop at ``analysis.py:205-207``
    as a single matvec)."""
    probs = _on(probs, device)
    P = _on(P, probs.device)
    return P.t() @ probs


def gini(alloc: torch.Tensor) -> torch.Tensor:
    """Gini coefficient of a probability allocation.

    Reference formula (``analysis.py:241-245``): with probabilities sorted
    ascending, ``Σ_i (2i - n + 1) π_i / (n k)`` where ``k = round(Σ π)``.
    """
    n = alloc.shape[0]
    sorted_probs = torch.sort(alloc).values
    k = torch.round(torch.sum(alloc))
    i = torch.arange(n, dtype=alloc.dtype, device=alloc.device)
    return torch.sum((2.0 * i - n + 1.0) * sorted_probs) / (n * k)


def geometric_mean(alloc: torch.Tensor, cap: bool = False) -> torch.Tensor:
    """Geometric mean of selection probabilities.

    With ``cap=True``, probabilities below 1/10,000 are floored first — the
    advantage the reference grants only to the LEGACY benchmark so its zeros
    don't collapse the mean (``analysis.py:234-236,247-249``).
    """
    x = torch.clamp(alloc, min=1.0 / 10_000) if cap else alloc
    return torch.exp(torch.mean(torch.log(x)))


def share_below(alloc: torch.Tensor, threshold) -> torch.Tensor:
    """Fraction of agents with probability strictly below ``threshold``
    (``analysis.py:600``: share of LEGACY probabilities below the LEXIMIN min)."""
    return torch.mean((alloc < threshold).to(torch.float32))


def prob_allocation_stats(
    alloc, cap_for_geometric_mean: bool, device: DeviceLike = None
) -> ProbAllocationStats:
    """Host-facing bundle matching ``compute_prob_allocation_stats``
    (``analysis.py:231-255``), computed in float32 on ``device`` (a tensor's
    own device when none is given, else CUDA unless the caller passes
    another)."""
    alloc = _on(alloc, device)
    return ProbAllocationStats(
        gini=float(gini(alloc)),
        geometric_mean=float(geometric_mean(alloc, cap=cap_for_geometric_mean)),
        min=float(torch.min(alloc)),
    )


def upper_confidence_bound(num_trials: int, sample_proportion: float) -> float:
    """99th percentile of the Jeffreys posterior Beta(.5 + s, .5 + f) for a
    binomial proportion (``analysis.py:258-268``); returns 1.0 when every trial
    succeeded. Host-side scalar (scipy), used only in the report path."""
    from scipy.stats import beta

    num_successes = round(sample_proportion * num_trials)
    if num_successes == num_trials:
        return 1.0
    return float(beta.ppf(0.99, 0.5 + num_successes, 0.5 + num_trials - num_successes))


def allocation_dict_to_vector(alloc_dict, n: int) -> np.ndarray:
    """Convert a reference-style ``{agent_id: prob}`` mapping (agent ids are
    row indices, ``analysis.py:132``) to the dense vector representation."""
    v = np.zeros(n, dtype=np.float64)
    for agent_id, prob in alloc_dict.items():
        v[int(agent_id)] = prob
    return v
