"""The serving layer: selection as a service on the card.

Public surface::

    from citizensassemblies_tpu_torch.service import (
        SelectionService, SelectionRequest, RequestContext,
    )

    with SelectionService(cfg) as svc:          # device="cpu" off the card
        ch = svc.submit(SelectionRequest(instance=inst, algorithm="leximin",
                                         tenant="city-a"))
        for kind, payload in ch.events():
            ...                      # ("progress", line) stream
        res = ch.result()            # RequestResult: allocation + audit stamp

``service/server.py`` holds the request lifecycle, ``service/batcher.py``
the cross-request batching of LP fleets, ``service/session.py`` the
per-tenant state, ``service/fleet.py`` the routing and open-loop drive of a
fleet of services, and ``service/context.py`` the per-request context the
solver stack reads.
"""

from citizensassemblies_tpu_torch.service.batcher import CrossRequestBatcher
from citizensassemblies_tpu_torch.service.context import (
    RequestContext,
    current_context,
    resolve,
    use_context,
)
from citizensassemblies_tpu_torch.service.fleet import (
    FleetProcess,
    FleetRouter,
    covering_tenants,
    fleet_aggregate,
    open_loop_schedule,
    plan_from_config,
    plan_open_loop,
    rendezvous_route,
)
from citizensassemblies_tpu_torch.service.server import (
    AdmissionError,
    RequestResult,
    ResultChannel,
    SelectionRequest,
    SelectionService,
)
from citizensassemblies_tpu_torch.service.session import TenantRegistry, TenantSession

__all__ = [
    "AdmissionError",
    "CrossRequestBatcher",
    "FleetProcess",
    "FleetRouter",
    "RequestContext",
    "RequestResult",
    "ResultChannel",
    "SelectionRequest",
    "SelectionService",
    "TenantRegistry",
    "TenantSession",
    "covering_tenants",
    "current_context",
    "fleet_aggregate",
    "open_loop_schedule",
    "plan_from_config",
    "plan_open_loop",
    "resolve",
    "rendezvous_route",
    "use_context",
]
