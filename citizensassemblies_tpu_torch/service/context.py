"""Per-request execution context.

One selection request owns a :class:`RequestContext`: its ``Config`` and
``RunLog``, its identity (tenant and request id), its warm-slot store, its
tenant session, the service's cross-request batcher, its tracer, and the
per-request robustness state (a wall-clock :class:`~citizensassemblies_tpu_torch.robust.
policy.Deadline`, a retry budget, a fault injector). :func:`use_context`
makes it ambient for a scope through a ``contextvars.ContextVar``, so each
thread (and each asyncio task) sees only its own request, and installs its
tracer as the ambient one (``obs/trace.py``) the same way; deep call sites
read it with :func:`current_context` (the batched LP engine's warm slots
and batcher hand-off, the L2 stage's pack memo, the face loop's deadline
check, the fault sites' injector lookup), and the model entry points take it
as ``ctx=`` and resolve ``(ctx, cfg, log)`` with :func:`resolve`.

This module imports no other module of the package beyond the config, the
log and (at a scope with a tracer) the tracer.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Optional

from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

#: the ambient per-request context: ContextVar semantics give each thread and
#: each asyncio task its own slot
_ACTIVE: ContextVar[Optional["RequestContext"]] = ContextVar(
    "citizens_torch_request_context", default=None
)

_REQUEST_SEQ_LOCK = threading.Lock()
_REQUEST_SEQ = 0


def _next_request_id() -> str:
    """Process-unique id for a context created without one."""
    global _REQUEST_SEQ
    with _REQUEST_SEQ_LOCK:
        _REQUEST_SEQ += 1
        return f"req-{_REQUEST_SEQ:06d}"


@dataclasses.dataclass
class RequestContext:
    """Everything one selection request owns.

    ``cfg``/``log`` are the request's knobs and log. ``tenant`` and
    ``request_id`` identify it. ``deadline`` (``robust.policy.Deadline``) is checked once
    a face-loop round and at the scenario models' stages, and raises
    ``DeadlineExceeded`` past it; ``retry`` is the request's retry budget;
    ``injector`` (``robust.inject.FaultInjector``) is consulted by every
    fault site before the process default. ``warm_store`` is the request's
    own warm-slot store of the batched LP engine
    (``solvers/batch_lp.WarmSlotStore``), ``session`` its tenant's session
    (``service/session.TenantSession``), ``batcher`` the service's
    cross-request batcher and ``tracer`` its ``obs.trace.Tracer``; the
    selection service sets them, and an offline context leaves them None.
    """

    cfg: Config
    log: RunLog
    request_id: str
    tenant: str = "default"
    warm_store: Optional[Any] = None
    session: Optional[Any] = None
    batcher: Optional[Any] = None
    tracer: Optional[Any] = None
    deadline: Optional[Any] = None
    retry: Optional[Any] = None
    injector: Optional[Any] = None

    def teardown(self, success: bool) -> None:
        """Request-scoped cleanup on every exit path: a failed request
        clears the warm slots and rolls back the session entries it wrote,
        where either is set; success leaves both in place."""
        if success:
            return
        if self.warm_store is not None:
            self.warm_store.clear()
        if self.session is not None:
            self.session.rollback_request(self.request_id)

    @classmethod
    def create(
        cls,
        cfg: Optional[Config] = None,
        log: Optional[RunLog] = None,
        request_id: Optional[str] = None,
        tenant: str = "default",
        **kw,
    ) -> "RequestContext":
        return cls(
            cfg=cfg or default_config(),
            log=log or RunLog(echo=False),
            request_id=request_id or _next_request_id(),
            tenant=tenant,
            **kw,
        )


    def scoped_warm_key(self, base: str) -> str:
        """A call site's warm-slot key (``"decomp_polish_screen"``) scoped by
        this request's tenant and id, so two concurrent requests of one call
        site never share warm iterates."""
        return f"{self.tenant}/{self.request_id}/{base}"


def current_context() -> Optional[RequestContext]:
    """The ambient context of the calling thread or task, or None."""
    return _ACTIVE.get()


@contextmanager
def use_context(ctx: Optional[RequestContext]):
    """Make ``ctx`` (and its tracer, if any) ambient for the scope; ``None``
    is a pass-through, so entry points wrap unconditionally."""
    if ctx is None:
        yield None
        return
    token = _ACTIVE.set(ctx)
    trace_token = None
    if ctx.tracer is not None:
        from citizensassemblies_tpu_torch.obs.trace import activate_tracer

        trace_token = activate_tracer(ctx.tracer)
    try:
        yield ctx
    finally:
        if trace_token is not None:
            from citizensassemblies_tpu_torch.obs.trace import deactivate_tracer

            deactivate_tracer(trace_token)
        _ACTIVE.reset(token)


def resolve(
    ctx: Optional[RequestContext],
    cfg: Optional[Config],
    log: Optional[RunLog],
) -> tuple:
    """``(ctx, cfg, log)`` for an entry point: ``ctx`` defaults to the
    ambient context; an explicit ``cfg``/``log`` wins over the context's,
    which win over the defaults. ``ctx`` stays None for an offline call."""
    if ctx is None:
        ctx = current_context()
    if ctx is not None:
        cfg = cfg or ctx.cfg
        log = log or ctx.log
    return ctx, cfg or default_config(), log or RunLog(echo=False)
