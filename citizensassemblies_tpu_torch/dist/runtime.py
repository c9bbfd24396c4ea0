"""Process bootstrap, the canonical mesh axes and the world's device mesh.

One module owns the facts every distributed call site needs:

* **The axis names.** ``AXIS_CHAINS``/``AXIS_AGENTS`` name the two parallel
  dimensions (data parallelism over Monte-Carlo chains and pricing
  candidates, model parallelism over the agent axis); everything else
  imports them.
* **The process layout.** One process per device. :func:`bootstrap` runs
  ``torch.distributed.init_process_group`` exactly once when a coordinator
  is configured (``CITIZENS_DIST_COORDINATOR`` or
  ``Config.dist_coordinator``; rank ``CITIZENS_DIST_PROCESS_ID``, world size
  ``CITIZENS_DIST_NUM_PROCESSES``): NCCL when the rank's device is CUDA,
  each rank on card ``rank % torch.cuda.device_count()``, gloo on the CPU.
  Without a coordinator it initializes nothing.
* **The mesh.** :func:`build_topology` lays the world's ranks out as a
  ``torch.distributed.device_mesh.DeviceMesh`` of shape ``(chains,
  agents)`` with those dimension names, rank-major, so rank ``r`` is flat
  mesh position ``r``: the torch counterpart of the JAX package's
  ``jax.sharding.Mesh``, one rank per device instead of many devices in one
  process. A mesh spans the whole world. With no process group it first
  starts a one-rank world through a ``FileStore`` in a temporary directory
  (NCCL on CUDA, gloo on the CPU), so a one-device mesh is a real world.

:func:`effective_mesh` is what routing sites consult: ``None`` (stay on the
undistributed path) unless the world spans more than one device and
``Config.dist_mesh`` is on.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device

#: canonical collective axis names
AXIS_CHAINS = "chains"
AXIS_AGENTS = "agents"
#: the full data-parallel reduction set: a batch sharded over every mesh
#: device uses both axes
CHAIN_AXES: Tuple[str, str] = (AXIS_CHAINS, AXIS_AGENTS)

#: environment contract of a multi-process launch (one process per device)
ENV_COORDINATOR = "CITIZENS_DIST_COORDINATOR"
ENV_NUM_PROCESSES = "CITIZENS_DIST_NUM_PROCESSES"
ENV_PROCESS_ID = "CITIZENS_DIST_PROCESS_ID"

#: environment contract of the serving fleet: independent serving processes
#: routed by tenant, not members of one process group
ENV_FLEET_PROCESSES = "CITIZENS_FLEET_PROCESSES"
ENV_FLEET_INDEX = "CITIZENS_FLEET_INDEX"

_LOCK = threading.RLock()
_BOOTSTRAP: Optional["BootstrapInfo"] = None
_DEFAULT_TOPOLOGY: Optional["Topology"] = None
#: the temporary directory of a one-rank world this module started
_OWN_STORE: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BootstrapInfo:
    """Outcome of :func:`bootstrap` (cached process-wide)."""

    initialized: bool  # did this call run init_process_group
    coordinator: str  # "" without a coordinator
    process_index: int
    process_count: int


@dataclasses.dataclass(frozen=True)
class Topology:
    """A built mesh plus the process-layout facts call sites partition by.
    ``hosts`` counts processes (the JAX package's ``jax.process_count()``);
    with one device a process, ``devices_per_host`` is 1."""

    mesh: DeviceMesh
    hosts: int
    devices_per_host: int
    agents_axis: int

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size())


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _init_method(coordinator: str) -> str:
    """``host:port`` → ``tcp://host:port``; an init method with a scheme
    (``tcp://``, ``file://``) passes as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device rank ``rank`` owns: card ``rank % device_count`` on CUDA
    (made current), the CPU otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def bootstrap(cfg=None, device: DeviceLike = None) -> BootstrapInfo:
    """Join the process group when a coordinator is configured.

    Reads ``CITIZENS_DIST_COORDINATOR`` (or ``Config.dist_coordinator``),
    ``CITIZENS_DIST_NUM_PROCESSES`` and ``CITIZENS_DIST_PROCESS_ID``; the
    rank runs on ``device`` (CUDA unless the caller passes another). With
    no coordinator nothing is initialized. A group an outer launcher
    already started is kept. Idempotent: the first call's outcome is
    cached."""
    global _BOOTSTRAP
    with _LOCK:
        if _BOOTSTRAP is not None:
            return _BOOTSTRAP
        coord = os.environ.get(ENV_COORDINATOR, "") or str(
            getattr(cfg, "dist_coordinator", "") or ""
        )
        initialized = False
        if coord and not dist.is_initialized():
            num = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
            pid = int(os.environ.get(ENV_PROCESS_ID, "0"))
            dev = _rank_device(device, pid)
            dist.init_process_group(
                _backend(dev), init_method=_init_method(coord), world_size=num, rank=pid
            )
            initialized = True
        _BOOTSTRAP = BootstrapInfo(
            initialized=initialized,
            coordinator=coord,
            process_index=process_index(),
            process_count=process_count(),
        )
        return _BOOTSTRAP


def _start_one_rank_world(device: DeviceLike) -> None:
    """A real world of one rank on ``device``, through a ``FileStore`` in a
    temporary directory (removed again by :func:`shutdown`)."""
    global _OWN_STORE
    dev = _rank_device(device, 0)
    path = tempfile.mkdtemp(prefix="citizens_dist_")
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(_backend(dev), store=store, rank=0, world_size=1)
    _OWN_STORE = path


def mesh_device_type() -> str:
    """The device type of the world's ranks: ``cuda`` under NCCL, ``cpu``
    under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_topology(
    n_devices: Optional[int] = None,
    agents_axis: int = 1,
    axis_names: Optional[Tuple[str, str]] = None,
    cfg=None,
    device: DeviceLike = None,
) -> Topology:
    """The world's ranks as a ``(chains, agents)`` DeviceMesh.

    ``agents_axis`` ranks are dedicated to the agent dimension and must
    divide ``n_devices``; ``n_devices`` (default: the world size) must be
    the world size, since a mesh spans every rank. With no process group a
    one-rank world on ``device`` starts first (then ``n_devices`` must be
    1)."""
    with _LOCK:
        bootstrap(cfg, device=device)
        if not dist.is_initialized():
            if n_devices not in (None, 1):
                raise ValueError(
                    f"n_devices={n_devices} needs a world of that many processes "
                    f"(one per device; launch through {ENV_COORDINATOR})"
                )
            _start_one_rank_world(device)
        world = process_count()
        n = int(n_devices or world)
        if n % max(int(agents_axis), 1) != 0:
            raise ValueError(f"n_devices={n} not divisible by agents_axis={agents_axis}")
        if n != world:
            raise ValueError(
                f"a mesh spans the whole world: n_devices={n}, world size {world}"
            )
        a = max(int(agents_axis), 1)
        mesh = DeviceMesh(
            mesh_device_type(),
            torch.arange(n).reshape(n // a, a),
            mesh_dim_names=tuple(axis_names or CHAIN_AXES),
        )
        hosts = world
        return Topology(mesh=mesh, hosts=hosts, devices_per_host=max(1, n // hosts),
                        agents_axis=a)


def topology_mesh(
    n_devices: Optional[int] = None,
    axis_names: Optional[Tuple[str, str]] = None,
    agents_axis: int = 1,
    device: DeviceLike = None,
) -> DeviceMesh:
    """Mesh-only convenience, the delegate of ``parallel.mesh.make_mesh``."""
    return build_topology(
        n_devices, agents_axis=agents_axis, axis_names=axis_names, device=device
    ).mesh


def default_topology(device: DeviceLike = None) -> Topology:
    """The process-cached topology over the whole world (pure chain
    parallelism), the delegate of ``parallel.mesh.default_mesh``; rebuilt
    when the world changes."""
    global _DEFAULT_TOPOLOGY
    with _LOCK:
        topo = _DEFAULT_TOPOLOGY
        if topo is None or not dist.is_initialized() or topo.n_devices != process_count():
            topo = build_topology(device=device)
            _DEFAULT_TOPOLOGY = topo
        return topo


def effective_mesh(cfg=None, log=None) -> Optional[DeviceMesh]:
    """The mesh multi-device call sites shard over, or ``None``.

    ``None`` keeps the undistributed path: the world spans one device, or
    ``Config.dist_mesh`` is off (the ``mesh_to_single_device`` rung of the
    degradation ladder). Handing out a mesh of more than one device is the
    ``dist_collective`` fault site, and stamps the ``dist_mesh_*`` gauges
    on ``log``."""
    if cfg is not None and not getattr(cfg, "dist_mesh", True):
        return None
    bootstrap(cfg)
    if process_count() <= 1:
        return None
    topo = default_topology()
    inject.raise_if("dist_collective", log)
    if log is not None:
        stamp_mesh_gauges(log, topo.mesh)
    return topo.mesh


def process_slice(n_items: int, topo: Optional[Topology] = None) -> Tuple[int, int]:
    """The ``[start, stop)`` share of ``n_items`` this process owns:
    contiguous ceil-balanced blocks, the whole range on one process."""
    hosts = max(topo.hosts if topo is not None else process_count(), 1)
    pid = process_index()
    per = -(-int(n_items) // hosts)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def host_lane() -> int:
    """This process's span-lane id (0 on one process)."""
    return process_index()


def stamp_mesh_gauges(log, mesh: DeviceMesh) -> None:
    """Latest-wins mesh gauges: processes and devices the mesh spans, and
    which process stamped them."""
    log.gauge("dist_mesh_hosts", process_count())
    log.gauge("dist_mesh_devices", int(mesh.size()))
    log.gauge("dist_process_index", process_index())


def fleet_process_count(cfg=None) -> int:
    """Serving processes of the fleet: ``Config.fleet_processes`` when > 0,
    else ``CITIZENS_FLEET_PROCESSES``, else the world size."""
    n = int(getattr(cfg, "fleet_processes", 0) or 0)
    if n > 0:
        return n
    env = os.environ.get(ENV_FLEET_PROCESSES, "")
    if env:
        return max(int(env), 1)
    return max(process_count(), 1)


def fleet_process_index() -> int:
    """This process's fleet slot: ``CITIZENS_FLEET_INDEX`` when set, else
    the rank."""
    env = os.environ.get(ENV_FLEET_INDEX, "")
    if env:
        return max(int(env), 0)
    return process_index()


def scoped_artifact_path(path: str) -> str:
    """``artifacts/trace.json`` → ``artifacts/trace.p2.json`` on fleet
    process 2; unchanged on a fleet of one."""
    idx = fleet_process_index()
    if idx == 0 and fleet_process_count() <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{idx}{ext}"


def shutdown() -> None:
    """Leave the process group (if any), remove the store of a one-rank
    world this module started, and drop the cached state."""
    global _OWN_STORE
    with _LOCK:
        if dist.is_initialized():
            dist.destroy_process_group()
        if _OWN_STORE is not None:
            shutil.rmtree(_OWN_STORE, ignore_errors=True)
            _OWN_STORE = None
        reset_for_tests()


def reset_for_tests() -> None:
    """Drop the cached bootstrap and topology (test isolation only)."""
    global _BOOTSTRAP, _DEFAULT_TOPOLOGY
    with _LOCK:
        _BOOTSTRAP = None
        _DEFAULT_TOPOLOGY = None
