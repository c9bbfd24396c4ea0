"""Declared-once layouts and counted placement onto the mesh.

The stages hand operands to each other in layouts declared here and only
here, as DTensor placements on the ``(chains, agents)`` mesh of
``dist/runtime.py`` (the JAX package's ``NamedSharding`` specs):

* ``chain_batch`` — the leading axis over every mesh device (``Shard(0)``
  on both mesh dimensions: chains first, then agents), the layout of chain
  ids and chain-sharded draw batches;
* ``portfolio`` — committee rows over ``chains``, the agent axis over
  ``agents``;
* ``chain_rows`` — the leading axis over ``chains`` only;
* ``bucket`` and ``rows`` — the leading (instance or constraint-row) axis
  over the whole mesh, as ``chain_batch``;
* ``replicated`` — the whole tensor on every device.

:func:`prepartition` is the one placement point and counts what it cost,
as the JAX package does: a DTensor already in the declared layout passes
through untouched; a host array or plain tensor is placed (each rank takes
its own shard of the copy every rank holds; no communication) and counts
``dist_placements``; a DTensor in another layout is redistributed (a
collective) and counts ``dist_reshards`` when it spans more than one
device, ``dist_placements`` otherwise. The cores work on ``.to_local()``
shards: DTensor marks the hand-off, never an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class Layout:
    """A declared layout: the mesh, one placement per mesh dimension, and
    the role and rank it was declared for."""

    mesh: DeviceMesh
    placements: Tuple[Placement, ...]
    role: str
    ndim: int


_LAYOUTS: dict = {}


def _declared(mesh: DeviceMesh, role: str, ndim: int, placements) -> Layout:
    """One Layout object per (mesh, role, ndim): every stage that names the
    same role hands off the same layout."""
    key = (id(mesh), role, int(ndim))
    lay = _LAYOUTS.get(key)
    if lay is None or lay.mesh is not mesh:
        lay = Layout(mesh=mesh, placements=tuple(placements), role=role, ndim=int(ndim))
        _LAYOUTS[key] = lay
    return lay


def chain_batch(mesh: DeviceMesh, ndim: int = 2) -> Layout:
    """Leading axis over every mesh device (chains, then agents)."""
    return _declared(mesh, "chain_batch", ndim, (Shard(0), Shard(0)))


def portfolio(mesh: DeviceMesh) -> Layout:
    """Committee matrices: rows over ``chains``, agents over ``agents``."""
    return _declared(mesh, "portfolio", 2, (Shard(0), Shard(1)))


def chain_rows(mesh: DeviceMesh, ndim: int = 1) -> Layout:
    """Leading axis over ``chains`` only (per-panel probability vectors)."""
    return _declared(mesh, "chain_rows", ndim, (Shard(0), Replicate()))


def bucket(mesh: DeviceMesh, ndim: int) -> Layout:
    """Batched-LP bucket operands: the instance axis over the whole mesh."""
    return _declared(mesh, "bucket", ndim, (Shard(0), Shard(0)))


def rows(mesh: DeviceMesh, ndim: int = 1) -> Layout:
    """Dual-LP and master row shards: the constraint-row axis over the whole
    mesh, trailing dims replicated."""
    return _declared(mesh, "rows", ndim, (Shard(0), Shard(0)))


def replicated(mesh: DeviceMesh, ndim: int = 0) -> Layout:
    return _declared(mesh, "replicated", ndim, (Replicate(), Replicate()))


#: declared role name -> layout builder
ROLE_BUILDERS = {
    "chain_batch": chain_batch,
    "portfolio": portfolio,
    "chain_rows": chain_rows,
    "bucket": bucket,
    "rows": rows,
    "replicated": replicated,
}


def role_layout(mesh: DeviceMesh, role: str, ndim: int) -> Layout:
    """The declared layout of ``role`` at ``ndim``."""
    if role == "portfolio":
        return portfolio(mesh)
    return ROLE_BUILDERS[role](mesh, ndim)


def _effective(placements, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """Placements with every size-1 mesh dimension read as replicated: a
    layout that differs only there puts the same data on every device."""
    return tuple(
        Replicate() if mesh.size(d) == 1 else p for d, p in enumerate(placements)
    )


def placed_like(x, layout: Layout) -> bool:
    """Is ``x`` a DTensor already in ``layout``?"""
    if not isinstance(x, DTensor) or x.device_mesh is not layout.mesh:
        return False
    return _effective(x.placements, layout.mesh) == _effective(layout.placements, layout.mesh)


def local_shard(t: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``placements``
    (``torch.chunk`` per sharded mesh dimension, in mesh order, as DTensor
    shards)."""
    coord = mesh.get_coordinate()
    out = t
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            out = torch.chunk(out, mesh.size(d), dim=p.dim)[coord[d]]
    return out.contiguous()


def place(x, layout: Layout, device=None) -> DTensor:
    """``x`` (numpy array or tensor, the same full value on every rank) as
    a DTensor in ``layout``, on ``device`` (default: the mesh's device
    type), with no communication."""
    mesh = layout.mesh
    dev = torch.device(device if device is not None else mesh.device_type)
    if mesh.device_type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(dev)
    return DTensor.from_local(
        local_shard(t, mesh, layout.placements), mesh, layout.placements,
        run_check=False, shape=t.shape, stride=t.contiguous().stride(),
    )


def prepartition(x, layout: Layout, log=None, count: bool = True):
    """Put ``x`` into ``layout``, counting what it cost (see the module
    docstring). ``count=False`` places the same shards uncounted."""
    if placed_like(x, layout):
        return x
    if isinstance(x, DTensor):
        if log is not None and count:
            multi = x.device_mesh.size() > 1
            log.count("dist_reshards" if multi else "dist_placements")
        return x.redistribute(layout.mesh, layout.placements)
    if log is not None and count:
        log.count("dist_placements")
    return place(x, layout)


def reshard_count(log) -> int:
    """The ``dist_reshards`` counter value on ``log`` (0 when never hit)."""
    if log is None:
        return 0
    return int(log.counters.get("dist_reshards", 0))


def layout_cache_stats() -> Optional[dict]:
    """Visibility hook for tests: the number of declared layouts."""
    return {"size": len(_LAYOUTS)}
