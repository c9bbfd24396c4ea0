"""Device mesh construction for the package's two parallel axes.

* ``chains`` — data parallelism over Monte-Carlo chains and pricing
  candidates, reduced with ``all_reduce``;
* ``agents`` — model parallelism over the agent axis (the portfolio matvec's
  agent shards).

Topology construction lives in ``dist/runtime.py``; these are the entry
points call sites import. A mesh is one rank per device over the whole
``torch.distributed`` world (the JAX package builds its mesh over the
devices of one process and keeps a ``shard_map`` shim beside it; here the
cores are written per rank, so there is none).
"""

from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh

from citizensassemblies_tpu_torch.dist import runtime as _runtime
from citizensassemblies_tpu_torch.dist.runtime import CHAIN_AXES
from citizensassemblies_tpu_torch.utils.device import DeviceLike


def default_mesh(device: DeviceLike = None) -> DeviceMesh:
    """The process-cached ``(chains, agents)`` mesh over the whole world
    (pure chain parallelism); with no process group, a one-rank world on
    ``device`` (CUDA unless the caller passes another) starts first."""
    return _runtime.default_topology(device=device).mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = CHAIN_AXES,
    agents_axis: int = 1,
    device: DeviceLike = None,
) -> DeviceMesh:
    """A ``(chains, agents)`` mesh over the world's ``n_devices`` ranks, of
    which ``agents_axis`` shard the agent dimension. ``make_mesh(1)`` in a
    process with no group starts a one-rank world on ``device`` (NCCL on
    CUDA, gloo on the CPU) through a ``FileStore`` in a temporary
    directory; ``dist.runtime.shutdown`` ends it."""
    return _runtime.topology_mesh(
        n_devices, axis_names=axis_names, agents_axis=agents_axis, device=device
    )
