"""Carry the JAX package's state into this package, from plain numpy and dicts.

The system has no weights: what crosses over is configurations, instances,
ELL packs of master columns, PDHG warm starts and distributions (a LEXIMIN
result seeds XMIN through its ``leximin=`` argument). Every function here takes
plain Python and numpy values (for example ``dataclasses.asdict`` of the JAX
package's ``Config``, or the host arrays of its ``DenseInstance``) and never
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance, Instance, dense_instance
from citizensassemblies_tpu_torch.data.registry import Registry, RegistryEdit
from citizensassemblies_tpu_torch.models.leximin import Distribution
from citizensassemblies_tpu_torch.service.server import SelectionRequest
from citizensassemblies_tpu_torch.solvers.delta import ReviseSpec
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike


def registry_from_dict(values: Mapping) -> Registry:
    """This package's :class:`~citizensassemblies_tpu_torch.data.registry.Registry`
    from ``dataclasses.asdict`` of the JAX package's (numpy arrays and
    tuples, taken as they are)."""
    return Registry(**{f.name: values[f.name] for f in dataclasses.fields(Registry)})


def revise_spec_from_dict(values: Mapping) -> ReviseSpec:
    """This package's :class:`~citizensassemblies_tpu_torch.solvers.delta.ReviseSpec`
    from ``dataclasses.asdict`` of the JAX package's: the edit's fields, the
    pre-edit registry's arrays and the base fingerprint."""
    return ReviseSpec(
        edit=RegistryEdit(**dict(values["edit"])),
        reg_before=registry_from_dict(values["reg_before"]),
        base_fingerprint=str(values.get("base_fingerprint", "")),
    )


def request_from_dict(values: Mapping, device: DeviceLike = None) -> SelectionRequest:
    """This package's ``service.SelectionRequest`` from ``dataclasses.asdict``
    of the JAX package's. A pre-featurized request's dense instance arrives
    as the dict of :func:`dense_from_arrays`'s arguments (``A``, ``qmin``,
    ``qmax``, ``cat_of_feature``, ``k``, ``n_categories``) and is built on
    ``device``; an ``instance`` (the host record of ``core.instance``, as a
    dict) becomes this package's ``Instance``; ``cfg`` maps through
    :func:`config_from_dict` and ``revise`` through
    :func:`revise_spec_from_dict`."""
    kw = {f.name: values[f.name] for f in dataclasses.fields(SelectionRequest) if f.name in values}
    if isinstance(kw.get("instance"), Mapping):
        kw["instance"] = Instance(**dict(kw["instance"]))
    if kw.get("dense") is not None:
        kw["dense"] = dense_from_arrays(**dict(kw["dense"]), device=device)
    if kw.get("cfg") is not None:
        kw["cfg"] = config_from_dict(kw["cfg"])
    if kw.get("revise") is not None:
        kw["revise"] = revise_spec_from_dict(kw["revise"])
    for name in ("households", "dropout"):
        if kw.get(name) is not None:
            kw[name] = np.asarray(kw[name])
    return SelectionRequest(**kw)


#: fields that describe the machine, not the run: this package keeps its own
#: value (the card's float32 ridge, not the JAX package's CPU-class one)
CARD_FIELDS = frozenset({"obs_roofline_ridge"})


def config_from_dict(values: Mapping) -> Config:
    """This package's :class:`Config` from a field dict of the JAX package's
    ``Config``: the fields both carry are copied, except
    :data:`CARD_FIELDS`; the others are dropped (they belong to modules
    this package does not have yet)."""
    names = {f.name for f in dataclasses.fields(Config)} - CARD_FIELDS
    return Config(**{k: v for k, v in values.items() if k in names})


def dense_from_arrays(
    A: np.ndarray,
    qmin: np.ndarray,
    qmax: np.ndarray,
    cat_of_feature: np.ndarray,
    k: int,
    n_categories: int,
    device: DeviceLike = None,
) -> DenseInstance:
    """A :class:`DenseInstance` on ``device`` from the host arrays of a
    dense instance (``A`` bool [n, F]; ``qmin``/``qmax``/``cat_of_feature``
    [F])."""
    return dense_instance(
        np.asarray(A), np.asarray(qmin), np.asarray(qmax), np.asarray(cat_of_feature),
        int(k), int(n_categories), device=device,
    )


def ellpack_from_arrays(idx: np.ndarray, val: np.ndarray, minor: int) -> EllPack:
    """An :class:`EllPack` holding the packed arrays ``idx`` int32 /
    ``val`` float32 ``[J, k_pad]`` as they are (padding slots index 0 with
    value 0)."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float32)
    if idx.shape != val.shape or idx.ndim != 2:
        raise ValueError(f"idx {idx.shape} and val {val.shape} must be one [J, k_pad] shape")
    pack = EllPack(minor=int(minor), idx=idx, val=val)
    pack.nnz_total = int((val != 0).sum())
    pack.pack_rows = idx.shape[0]
    return pack


def warm_from_arrays(x, lam, mu) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A PDHG warm triple ``(x0 [C+1], λ0 [2T], μ0 [1])`` as float64 numpy,
    the layout ``solvers/lp_pdhg`` takes for ``warm=``."""
    return (
        np.asarray(x, dtype=np.float64).reshape(-1),
        np.asarray(lam, dtype=np.float64).reshape(-1),
        np.asarray(mu, dtype=np.float64).reshape(-1),
    )


def portfolio_from_panels(panels, n: int) -> np.ndarray:
    """The bool ``[C, n]`` portfolio matrix of panels given as int agent
    indices (rows of a ``[C, k]`` array, or a sequence of tuples), as the
    JAX package's samplers return them."""
    P = np.zeros((len(panels), int(n)), dtype=bool)
    for r, panel in enumerate(panels):
        P[r, np.asarray(panel, dtype=np.int64)] = True
    return P


def distribution_from_arrays(
    committees: np.ndarray,
    probabilities: np.ndarray,
    allocation: np.ndarray,
    fixed_probabilities: np.ndarray,
    covered: np.ndarray,
    realization_dev: float,
    contract_ok: bool,
) -> Distribution:
    """This package's :class:`Distribution` from the arrays of one (for
    example the JAX package's ``Distribution`` fields): the portfolio bool
    ``[C, n]``, its float64 probabilities ``[C]``, the per-agent allocation
    and leximin values ``[n]``, the coverage mask, the realized deviation
    and the contract flag. The output lines start empty."""
    return Distribution(
        committees=np.asarray(committees, dtype=bool),
        probabilities=np.asarray(probabilities, dtype=np.float64),
        allocation=np.asarray(allocation, dtype=np.float64),
        output_lines=[],
        fixed_probabilities=np.asarray(fixed_probabilities, dtype=np.float64),
        covered=np.asarray(covered, dtype=bool),
        realization_dev=float(realization_dev),
        contract_ok=bool(contract_ok),
    )
