"""The three algorithms: LEGACY, LEXIMIN and XMIN."""

from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities
from citizensassemblies_tpu_torch.models.leximin import Distribution, find_distribution_leximin
from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin

__all__ = [
    "Distribution",
    "find_distribution_leximin",
    "find_distribution_xmin",
    "legacy_probabilities",
]
