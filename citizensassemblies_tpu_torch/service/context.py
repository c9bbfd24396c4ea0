"""Per-request execution context.

One selection request owns a :class:`RequestContext`: its ``Config`` and
``RunLog``, its identity (tenant and request id), and the per-request
robustness state (a wall-clock :class:`~citizensassemblies_tpu_torch.robust.
policy.Deadline`, a retry budget, a fault injector). :func:`use_context`
makes it ambient for a scope through a ``contextvars.ContextVar``, so each
thread (and each asyncio task) sees only its own request; deep call sites
read it with :func:`current_context` (the face loop's deadline check, the
fault sites' injector lookup), and the model entry points take it as
``ctx=`` and resolve ``(ctx, cfg, log)`` with :func:`resolve`.

The serving layer's own state (a warm-start slot store, a tenant session,
a cross-request batcher, a tracer) has fields here too; nothing in the
package sets them yet. This module imports no other module of the package
beyond the config and the log.
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
    fault site before the process default. ``warm_store``, ``session``,
    ``batcher`` and ``tracer`` are the serving layer's and stay None until
    it sets them.
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


def current_context() -> Optional[RequestContext]:
    """The ambient context of the calling thread or task, or None."""
    return _ACTIVE.get()


@contextmanager
def use_context(ctx: Optional[RequestContext]):
    """Make ``ctx`` the ambient context for the scope; ``None`` is a
    pass-through, so entry points wrap unconditionally."""
    if ctx is None:
        yield None
        return
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
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
