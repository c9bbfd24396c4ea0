"""The serving layer's request context.

Only :mod:`~citizensassemblies_tpu_torch.service.context` is here so far:
the per-request :class:`RequestContext` that the model entry points accept
as ``ctx=`` and make ambient for their call. The selection service, its
batcher, tenant sessions and fleet come with the serving slice.
"""

from citizensassemblies_tpu_torch.service.context import (
    RequestContext,
    current_context,
    resolve,
    use_context,
)

__all__ = ["RequestContext", "current_context", "resolve", "use_context"]
