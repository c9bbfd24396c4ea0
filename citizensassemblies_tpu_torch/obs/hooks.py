"""Device-dispatch hooks: a span around each hot dispatch.

The port's counterparts of the JAX package's dispatch sites wrap their
device dispatch in :func:`dispatch_span`. The hook is tri-stated by
``Config.obs_trace``:

* ``False`` — hard off: inert even with a tracer installed (one attribute
  read), no allocation on the shared scope;
* ``None`` (auto) — a span records whenever a tracer is ambient (or rides
  the given ``log``), measuring the host-side dispatch window: CUDA work is
  asynchronous, so the span is the enqueue time, the honest number for a
  pipelined caller;
* ``True`` (the sampling mode, carried by ``Tracer.sample_device``) — the
  hook also records a CUDA event after the outputs the caller parked in
  ``scope.out`` and waits on it, so the span measures device execution.
  The wait is an event wait, not a copy: outside the thread's launch
  windows a ``utils/guards.readback`` (it never meets another thread's
  window), inside one a poll of the event (no synchronising call), and
  none while the stream is captured into a graph. The numerics are
  untouched; it serialises the pipeline, hence opt-in.

With no tracer and no memory ledger the hook adds no synchronisation and no
allocation. Usage::

    with dispatch_span("lp_pdhg.pdhg_core", cfg=cfg, log=log, nv=nv) as ds:
        out = core(*operands)
        ds.out = out
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from citizensassemblies_tpu_torch.obs.trace import _resolve


class DispatchScope:
    """Mutable slot the caller parks its device outputs in; the hook waits
    for them at scope exit in sampling mode. :meth:`note` adds attributes
    to the recorded span, also after the scope closed (the iterations a
    solve took, once its caller reads them back)."""

    __slots__ = ("out", "span")

    def __init__(self):
        self.out = None
        self.span = None

    def note(self, **attrs) -> None:
        """Set ``attrs`` on the recorded span (a no-op when none records)."""
        if self.span is not None:
            self.span.attrs.update(attrs)


#: shared inert scope handed out when tracing is off — callers only ever
#: write ``.out`` (never read it), so sharing it across threads is harmless
#: and keeps the off path allocation-free
_INERT = DispatchScope()


def _cuda_tensor(value, depth: int = 3):
    """The first CUDA tensor reachable from ``value`` within ``depth`` hops
    through sequences and object fields, or None."""
    import torch

    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    if depth <= 0 or value is None:
        return None
    if isinstance(value, (list, tuple)):
        items = value
    elif isinstance(value, dict):
        items = list(value.values())
    else:
        fields = getattr(value, "__dict__", None)
        if not isinstance(fields, dict):
            return None
        items = list(fields.values())
    for item in items:
        found = _cuda_tensor(item, depth - 1)
        if found is not None:
            return found
    return None


def _wait_for(out) -> bool:
    """Wait for the device work behind ``out`` (an event recorded on the
    current stream of its first CUDA tensor); False when nothing of it is
    on a CUDA device, or when the stream is being captured into a graph
    (nothing runs until the replay). Outside the thread's launch windows
    the wait is an event synchronise taken as a ``readback``; inside one it
    polls the event, which is no synchronising call, so the window's
    transfer guard holds."""
    import torch

    from citizensassemblies_tpu_torch.utils.guards import GATE, readback

    t = _cuda_tensor(out)
    if t is None or torch.cuda.is_current_stream_capturing():
        return False
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    if GATE.in_window():
        while not event.query():
            time.sleep(0)
    else:
        with readback():
            event.synchronize()
    return True


@contextmanager
def dispatch_span(name: str, cfg=None, log=None, **attrs):
    # the memory ledger snapshots at the span boundary whenever one is
    # ambient and ``obs_memory`` is not hard off (one ContextVar read)
    led = None
    if cfg is None or getattr(cfg, "obs_memory", None) is not False:
        from citizensassemblies_tpu_torch.obs.memory import ambient_ledger

        led = ambient_ledger()
    if cfg is not None and getattr(cfg, "obs_trace", None) is False:
        yield _INERT
        if led is not None:
            led.snapshot(name)
        return
    tr = _resolve(log)
    if tr is None:
        yield _INERT
        if led is not None:
            led.snapshot(name)
        return
    scope = DispatchScope()
    # every span carries its process index, so merged multi-process traces
    # separate into lanes (0 in one process)
    from citizensassemblies_tpu_torch.dist.runtime import host_lane

    attrs.setdefault("host", host_lane())
    with tr.span(name, kind="dispatch", **attrs) as sp:
        scope.span = sp
        yield scope
        if tr.sample_device and scope.out is not None and _wait_for(scope.out):
            if sp is not None:
                sp.attrs["sampled"] = True
    if led is not None:
        led.snapshot(name)
