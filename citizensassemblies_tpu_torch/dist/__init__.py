"""The multi-process runtime (``dist/runtime``: bootstrap, axis names, the
world's DeviceMesh) and the declared-once layouts operands are handed off
in (``dist/partition``), over ``torch.distributed``."""

from citizensassemblies_tpu_torch.dist.runtime import (  # noqa: F401
    AXIS_AGENTS,
    AXIS_CHAINS,
    CHAIN_AXES,
    Topology,
    bootstrap,
    default_topology,
    effective_mesh,
    process_slice,
    topology_mesh,
)
