"""citizensassemblies_tpu_torch: citizens' assembly selection in PyTorch.

The PyTorch and CUDA counterpart of the JAX package ``citizensassemblies_tpu``,
with the same module layout (``core/``, ``solvers/``, ``models/``,
``kernels/``, ``ops/``, ``analysis/``, ``utils/``; the analysis CLI is
``python -m citizensassemblies_tpu_torch``). It imports neither JAX nor the
JAX package. Entry points take an explicit ``device`` and run on the GPU
unless the caller asks for the CPU (``device="cpu"``); the hand-written
Hopper kernels live under ``csrc/`` and are built at first use
(``kernels/cuda_lib.py``).
"""

from citizensassemblies_tpu_torch.core.instance import (
    DenseInstance,
    FeatureSpace,
    InfeasibleQuotasError,
    Instance,
    SelectionError,
    compute_households,
    featurize,
    read_instance,
    read_instance_dir,
)
from citizensassemblies_tpu_torch.models import (
    Distribution,
    find_distribution_leximin,
    find_distribution_xmin,
    legacy_probabilities,
)
from citizensassemblies_tpu_torch.utils.config import Config, default_config

__all__ = [
    "Config",
    "DenseInstance",
    "Distribution",
    "FeatureSpace",
    "InfeasibleQuotasError",
    "Instance",
    "SelectionError",
    "compute_households",
    "default_config",
    "featurize",
    "find_distribution_leximin",
    "find_distribution_xmin",
    "legacy_probabilities",
    "read_instance",
    "read_instance_dir",
]
