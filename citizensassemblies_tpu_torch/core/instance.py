"""Problem instances: the two-CSV schema and the dense representation.

An :class:`Instance` is the host-side problem (panel size ``k``, per
category per feature quotas, one feature per category per agent), read from
``categories.csv`` (``category,feature,min,max``) and ``respondents.csv``
(one column per category; agent ids are row indices).

:func:`featurize` lowers it to a :class:`DenseInstance`: the ``{0,1}^{n×F}``
agent × feature-cell incidence ``A`` over the flat ``(category, feature)``
axis in file order, the quota vectors and the cell → category map. The
arrays are numpy (the host solvers read them); the same arrays also live as
torch tensors on the device the caller names.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device

Quota = Tuple[int, int]  # (min, max)


@dataclasses.dataclass
class Instance:
    """Host-side problem container: ``categories`` maps category name →
    feature name → (min, max) quota in file order; ``agents[i]`` maps
    category → feature for agent ``i``."""

    k: int
    categories: Dict[str, Dict[str, Quota]]
    agents: List[Dict[str, str]]
    name: str = ""
    columns_data: Optional[List[Dict[str, str]]] = None

    @property
    def n(self) -> int:
        return len(self.agents)


@dataclasses.dataclass(frozen=True)
class FeatureSpace:
    """Static metadata naming the flat feature axis of a :class:`DenseInstance`."""

    categories: Tuple[str, ...]
    cells: Tuple[Tuple[str, str], ...]

    @property
    def n_features(self) -> int:
        return len(self.cells)

    @property
    def n_categories(self) -> int:
        return len(self.categories)

    def feature_index(self, category: str, feature: str) -> int:
        return self.cells.index((category, feature))

    def cells_of_category(self, category: str) -> List[int]:
        return [i for i, (c, _) in enumerate(self.cells) if c == category]


class InfeasibleQuotasError(Exception):
    """No panel satisfies the quotas; carries a suggested minimal relaxation."""

    def __init__(self, quotas: Dict[Tuple[str, str], Quota], output: List[str]):
        self.quotas = quotas
        self.output = ["The quotas are infeasible:"] + output
        super().__init__("\n".join(self.output))

    def __str__(self) -> str:
        return "\n".join(self.output)


class SelectionError(Exception):
    """Panel selection failed."""

    def __init__(self, message: str):
        self.msg = message
        super().__init__(message)


class HostView:
    """Numpy arrays of a :class:`DenseInstance`, hashed by content."""

    __slots__ = ("A", "qmin", "qmax", "_h")

    def __init__(self, A: np.ndarray, qmin: np.ndarray, qmax: np.ndarray):
        self.A = A
        self.qmin = qmin
        self.qmax = qmax
        self._h = hash((A.shape, A.tobytes(), qmin.tobytes(), qmax.tobytes()))

    def __hash__(self) -> int:
        return self._h

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, HostView)
            and self._h == other._h
            and np.array_equal(self.A, other.A)
            and np.array_equal(self.qmin, other.qmin)
            and np.array_equal(self.qmax, other.qmax)
        )


@dataclasses.dataclass(frozen=True)
class DenseInstance:
    """Dense instance: numpy arrays in ``host`` plus the same arrays as
    torch tensors on ``device`` (``A`` bool [n, F], ``qmin``/``qmax``/
    ``cat_of_feature`` int32 [F])."""

    host: HostView
    cat_of_feature_np: np.ndarray
    k: int
    n_categories: int
    device: torch.device
    A: torch.Tensor
    qmin: torch.Tensor
    qmax: torch.Tensor
    cat_of_feature: torch.Tensor

    @property
    def n(self) -> int:
        return self.host.A.shape[0]

    @property
    def n_features(self) -> int:
        return self.host.A.shape[1]

    @property
    def A_np(self) -> np.ndarray:
        return self.host.A

    @property
    def qmin_np(self) -> np.ndarray:
        return self.host.qmin

    @property
    def qmax_np(self) -> np.ndarray:
        return self.host.qmax


def dense_instance(
    A: np.ndarray,
    qmin: np.ndarray,
    qmax: np.ndarray,
    cat_of_feature: np.ndarray,
    k: int,
    n_categories: int,
    device: DeviceLike = None,
) -> DenseInstance:
    """Build a :class:`DenseInstance` from its numpy arrays on ``device``."""
    dev = resolve_device(device)
    A = np.ascontiguousarray(A, dtype=bool)
    qmin = np.ascontiguousarray(qmin, dtype=np.int32)
    qmax = np.ascontiguousarray(qmax, dtype=np.int32)
    cof = np.ascontiguousarray(cat_of_feature, dtype=np.int32)
    return DenseInstance(
        host=HostView(A, qmin, qmax),
        cat_of_feature_np=cof,
        k=int(k),
        n_categories=int(n_categories),
        device=dev,
        A=torch.tensor(A, device=dev),
        qmin=torch.tensor(qmin, device=dev),
        qmax=torch.tensor(qmax, device=dev),
        cat_of_feature=torch.tensor(cof, device=dev),
    )


def on_device(dense: DenseInstance, device: torch.device) -> DenseInstance:
    """``dense`` itself when it already lives on ``device``, else the same
    instance rebuilt there."""
    if dense.device == torch.device(device):
        return dense
    return dense_instance(
        dense.A_np, dense.qmin_np, dense.qmax_np, dense.cat_of_feature_np,
        dense.k, dense.n_categories, device=device,
    )


def read_instance(
    feature_file: Union[str, Path],
    pool_file: Union[str, Path],
    k: int,
    name: str = "",
    extra_columns: Sequence[str] = (),
) -> Instance:
    """Read an instance from the two-CSV schema; unknown feature values in
    the pool raise a clean ValueError."""
    categories: Dict[str, Dict[str, Quota]] = {}
    with open(feature_file, "r", encoding="utf-8") as fh:
        for line in csv.DictReader(fh):
            cat, feat = line["category"], line["feature"]
            categories.setdefault(cat, {})
            categories[cat][feat] = (int(line["min"]), int(line["max"]))

    cat_names = list(categories)
    agents: List[Dict[str, str]] = []
    columns_data: List[Dict[str, str]] = []
    with open(pool_file, "r", encoding="utf-8") as fh:
        for i, line in enumerate(csv.DictReader(fh)):
            agent = {}
            for cat in cat_names:
                feat = line.get(cat)
                if feat is None:
                    raise ValueError(f"respondent row {i} is missing category column {cat!r}")
                if feat not in categories[cat]:
                    raise ValueError(
                        f"respondent row {i} has feature {feat!r} for category {cat!r} "
                        f"which does not appear in the categories file"
                    )
                agent[cat] = feat
            agents.append(agent)
            if extra_columns:
                columns_data.append({col: line.get(col, "") for col in extra_columns})

    return Instance(
        k=k,
        categories=categories,
        agents=agents,
        name=name or Path(pool_file).parent.name,
        columns_data=columns_data or None,
    )


def featurize(
    instance: Instance, device: DeviceLike = None
) -> Tuple[DenseInstance, FeatureSpace]:
    """Lower a host instance to its dense representation on ``device``."""
    cells: List[Tuple[str, str]] = []
    qmin: List[int] = []
    qmax: List[int] = []
    cat_of_feature: List[int] = []
    cell_index: Dict[Tuple[str, str], int] = {}
    cat_names = list(instance.categories)
    for ci, cat in enumerate(cat_names):
        for feat, (lo, hi) in instance.categories[cat].items():
            cell_index[(cat, feat)] = len(cells)
            cells.append((cat, feat))
            qmin.append(lo)
            qmax.append(hi)
            cat_of_feature.append(ci)

    n, F = len(instance.agents), len(cells)
    A = np.zeros((n, F), dtype=bool)
    for i, agent in enumerate(instance.agents):
        for cat in cat_names:
            A[i, cell_index[(cat, agent[cat])]] = True

    dense = dense_instance(
        A, np.asarray(qmin, np.int32), np.asarray(qmax, np.int32),
        np.asarray(cat_of_feature, np.int32), instance.k, len(cat_names),
        device=device,
    )
    space = FeatureSpace(categories=tuple(cat_names), cells=tuple(cells))
    return dense, space


def compute_households(
    instance: Instance, address_columns: Sequence[str]
) -> np.ndarray:
    """Group agents into households by equality on the address columns
    (the reference's ``_compute_households``, ``leximin.py:359-362``, and the
    same-address matching of ``legacy.py:78-99``).

    Returns int32[n] household ids, numbered in order of first appearance,
    for the ``households`` argument of the samplers, the oracles and the
    model entry points. Requires the instance to have been read with
    ``extra_columns=address_columns``.
    """
    if not instance.columns_data:
        raise ValueError(
            "instance has no columns_data — re-read it with "
            f"extra_columns={list(address_columns)!r} to enable household checks"
        )
    ids: Dict[Tuple[str, ...], int] = {}
    out = np.zeros(len(instance.agents), dtype=np.int32)
    for i, cols in enumerate(instance.columns_data):
        key = tuple(cols.get(c, "") for c in address_columns)
        out[i] = ids.setdefault(key, len(ids))
    return out
