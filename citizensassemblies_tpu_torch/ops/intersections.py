"""Intersectional representation: shares and MSEs for 2-feature groups.

Reference ``analysis.py:459-530``: an optional ``intersections.csv`` (schema
``category 1,feature 1,category 2,feature 2,population share``) lists 2-feature
intersections with their population shares; for each, the panel share under an
allocation is ``Σ_i π_i [agent i has both features] / k``, the pool share is the
fraction of the pool in the group, and the quota share is the product of quota
midpoint shares (``analysis.py:466-471``). Seven MSEs over share pairs are the
headline numbers (``analysis.py:509-517``; golden values in
``reference_output/sf_e_110_statistics.txt:15-21``).

Dense form: stack the per-row pair masks as ``G ∈ {0,1}^{R×n}`` with
``G[r] = A[:, f1_r] * A[:, f2_r]``; then all panel/pool shares are matvecs,
computed in float32 on the device the caller names.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance, FeatureSpace
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device

#: the seven share pairs the reference reports MSEs for (``analysis.py:509-512``)
DIFF_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("panel share LEXIMIN", "population share"),
    ("panel share LEGACY", "population share"),
    ("panel share LEXIMIN", "pool share"),
    ("panel share LEGACY", "pool share"),
    ("panel share LEXIMIN", "quota share"),
    ("panel share LEGACY", "quota share"),
    ("panel share LEXIMIN", "panel share LEGACY"),
)


@dataclasses.dataclass
class IntersectionTable:
    """Parsed intersections.csv plus the dense group-membership matrix."""

    rows: List[Tuple[str, str, str, str]]  # (cat1, feat1, cat2, feat2)
    population_share: np.ndarray  # float[R]
    group_mask: np.ndarray  # bool[R, n]
    quota_share: np.ndarray  # float[R]


def read_intersections(
    path: Union[str, Path], dense: DenseInstance, space: FeatureSpace
) -> IntersectionTable:
    rows: List[Tuple[str, str, str, str]] = []
    pop: List[float] = []
    with open(path, "r", encoding="utf-8") as fh:
        for entry in csv.DictReader(fh):
            rows.append(
                (entry["category 1"], entry["feature 1"], entry["category 2"], entry["feature 2"])
            )
            pop.append(float(entry["population share"]))

    A = dense.A_np
    qmin = dense.qmin_np
    qmax = dense.qmax_np
    masks = np.zeros((len(rows), A.shape[0]), dtype=bool)
    quota_share = np.zeros(len(rows))
    for r, (c1, f1, c2, f2) in enumerate(rows):
        i1 = space.feature_index(c1, f1)
        i2 = space.feature_index(c2, f2)
        masks[r] = A[:, i1] & A[:, i2]
        mid1 = (qmin[i1] + qmax[i1]) / 2.0
        mid2 = (qmin[i2] + qmax[i2]) / 2.0
        # product of quota-midpoint panel shares (``analysis.py:466-471``)
        quota_share[r] = (mid1 / dense.k) * (mid2 / dense.k)

    return IntersectionTable(
        rows=rows,
        population_share=np.asarray(pop),
        group_mask=masks,
        quota_share=quota_share,
    )


def intersection_shares(
    table: IntersectionTable,
    k: int,
    allocations: Dict[str, Sequence[float]],
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Compute all share series on ``device`` (CUDA unless the caller passes
    another). ``allocations`` maps a label (e.g. "LEGACY") to a dense
    allocation vector; returns ``panel share <label>`` per entry, plus
    ``pool share``, ``quota share``, ``population share``."""
    dev = resolve_device(device)
    G = torch.as_tensor(table.group_mask, dtype=torch.float32, device=dev)
    out: Dict[str, np.ndarray] = {
        "population share": table.population_share,
        "pool share": torch.mean(G, dim=1).cpu().numpy(),
        "quota share": table.quota_share,
    }
    for label, alloc in allocations.items():
        pi = torch.as_tensor(alloc, dtype=torch.float32, device=dev)
        out[f"panel share {label}"] = (G @ pi / k).cpu().numpy()
    return out


def intersection_mses(
    shares: Dict[str, np.ndarray],
    diff_pairs: Sequence[Tuple[str, str]] = DIFF_PAIRS,
) -> Dict[Tuple[str, str], float]:
    """MSEs between share series (``analysis.py:513-517``)."""
    return {
        (s1, s2): float(np.mean((shares[s1] - shares[s2]) ** 2)) for s1, s2 in diff_pairs
    }
