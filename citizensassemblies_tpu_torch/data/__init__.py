"""Instance families: the nationwide civic-lottery registry and its churn."""

from citizensassemblies_tpu_torch.data.registry import (  # noqa: F401
    Registry,
    RegistryEdit,
    apply_edit,
    churn_trail,
    nationwide_registry,
)
