"""Runtime guards: host synchronisations in the device hot paths, and the
one-time work a scope may do.

The JAX package wraps its jitted hot calls in ``jax.transfer_guard``, so an
implicit host↔device transfer inside them (a numpy operand re-uploaded per
call, a scalar read back mid-loop) raises. The torch counterpart of that
guard is ``torch.cuda.set_sync_debug_mode``: in mode ``"error"`` every CUDA
call that makes the host wait for the device (a blocking copy either way,
``.item()``, a bool mask index, a stream synchronise) raises, in
``"warn"`` it warns.

Three pieces guard the syncs:

* :func:`no_implicit_transfers` arms the guard for a site, where the JAX
  package opens its ``jax.transfer_guard`` scope (the PDHG solves, the
  device pricing dispatch, the batched LP lanes, the L2 stages, the move
  screens, the two kernel dispatches and the sharded solvers).
  ``Config.transfer_guard`` selects the mode: ``"disallow"`` → ``"error"``,
  ``"log"`` → ``"warn"``, ``"off"`` opens no scope.
* :func:`guarded_launch` opens a launch window, where the mode is in
  force: around the kernel launches, CUDA-graph replays and iteration
  blocks inside an armed site. A site's host readback (a residual read once
  per block, a harvest) lies outside every window, so it stays legal, as
  the JAX package's explicit conversions do.
* The sync debug mode is one setting of the whole process, while
  ``jax.transfer_guard`` is per thread. So the windows of all threads are
  counted under one lock (:data:`GATE`): the mode goes in force when the
  first window opens (the strongest mode of the open windows), and the
  process's own mode comes back when the last one closes, however the
  windows of several threads interleave. A legal sync of a thread outside
  every window must not meet another thread's window: :func:`readback`
  waits until no window is open and keeps new ones from opening while it
  runs, and :func:`shared_device` does the same for every torch call of the
  thread (a thread-local ``TorchFunctionMode``). The selection service runs
  each request under :func:`shared_device`; an offline run in one thread
  needs neither. A sync inside a window still raises.

The arming rides a context variable, so a worker thread (which starts with
an empty context) is never armed by its parent's site. On tensors off CUDA
there is nothing to guard and the windows are no-ops.

:class:`CompilationGuard` is the port's counterpart of the JAX package's
XLA-compile counter: it counts the one-time work per shape that the port
does inside its scope, on the calling thread — CUDA-graph captures
(``solvers/lp_pdhg._replayed``) and builds of the hand-written kernel
libraries (``kernels/cuda_lib``) — with the same ``max_compiles`` bound.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

#: ``Config.transfer_guard`` → ``torch.cuda.set_sync_debug_mode`` mode;
#: ``"off"`` (and ``"allow"``, the JAX package's other no-op) open no scope
TORCH_MODES = {"disallow": "error", "log": "warn"}
_NO_SCOPE = ("off", "allow", "")

#: the sync debug mode armed by the innermost site, None when unarmed
_ARMED: ContextVar[Optional[str]] = ContextVar("citizens_torch_transfer_guard", default=None)


class GuardViolation(RuntimeError):
    """A runtime guard's asserted bound was exceeded."""


def transfer_mode(cfg=None, mode: Optional[str] = None) -> str:
    """The transfer-guard mode: ``mode`` when given, else
    ``cfg.transfer_guard``, else ``"disallow"``."""
    if mode is not None:
        return str(mode)
    if cfg is None:
        return "disallow"
    return str(getattr(cfg, "transfer_guard", "disallow"))


def torch_sync_mode(cfg=None, mode: Optional[str] = None) -> Optional[str]:
    """The ``torch.cuda.set_sync_debug_mode`` mode a site arms, or None for
    no scope; an unknown mode raises."""
    resolved = transfer_mode(cfg, mode)
    if resolved in _NO_SCOPE:
        return None
    if resolved not in TORCH_MODES:
        raise ValueError(
            f"unknown transfer_guard mode {resolved!r}: expected one of "
            f"{sorted(TORCH_MODES) + ['off']}"
        )
    return TORCH_MODES[resolved]


@contextmanager
def no_implicit_transfers(cfg=None, mode: Optional[str] = None):
    """Arm the guard for the launches and replays inside the scope (a no-op
    for ``"off"``). ``mode`` overrides ``cfg.transfer_guard``."""
    armed = torch_sync_mode(cfg, mode)
    if armed is None:
        yield
        return
    token = _ARMED.set(armed)
    try:
        yield
    finally:
        _ARMED.reset(token)


def armed_mode() -> Optional[str]:
    """The mode armed for the calling context, None when unarmed."""
    return _ARMED.get()


class _SyncGate:
    """The process-wide count of open launch windows and of legal syncs in
    flight outside them, under one condition lock. Windows of any threads
    may be open together, and legal syncs of any threads may run together,
    but never a window and a legal sync at once; a waiting window keeps new
    syncs from starting, so windows are not starved. Both sides are
    re-entrant per thread, and a thread inside its own window passes the
    sync side straight through (its sync is the window's, for the mode to
    catch)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._tls = threading.local()
        self._modes: Dict[str, int] = {"warn": 0, "error": 0}
        self._open = 0
        self._syncs = 0
        self._waiting = 0
        self._original = None
        self._in_force: Optional[str] = None

    def _depth(self, name: str) -> int:
        return getattr(self._tls, name, 0)

    def in_window(self) -> bool:
        """True while the calling thread has a window open."""
        return self._depth("window") > 0

    def _apply(self) -> None:
        if self._open == 0:
            mode = None
        else:
            mode = "error" if self._modes["error"] else "warn"
        if mode == self._in_force:
            return
        if self._in_force is None:
            self._original = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self._original if mode is None else mode)
        self._in_force = mode

    @contextmanager
    def window(self, mode: str):
        depth = self._depth("window")
        gated = getattr(self._tls, "gated", None)
        # a thread inside its own legal sync does not wait for itself
        own = 1 if self._depth("sync") else 0
        with self._cond:
            if depth == 0:
                self._waiting += 1
                try:
                    while self._syncs > own:
                        self._cond.wait()
                finally:
                    self._waiting -= 1
            self._modes[mode] += 1
            self._open += 1
            self._apply()
        self._tls.window = depth + 1
        try:
            if depth == 0 and gated is not None:
                # inside its own window the thread's calls need no gate:
                # take the gating mode off the stack for the window
                with _mode_lifted(gated):
                    yield
            else:
                yield
        finally:
            self._tls.window = depth
            with self._cond:
                self._modes[mode] -= 1
                self._open -= 1
                self._apply()
                if self._open == 0:
                    self._cond.notify_all()

    def sync_enter(self) -> None:
        depth = self._depth("sync")
        if depth == 0 and not self.in_window():
            with self._cond:
                while self._open or self._waiting:
                    self._cond.wait()
                self._syncs += 1
        self._tls.sync = depth + 1

    def sync_exit(self) -> None:
        depth = self._depth("sync") - 1
        self._tls.sync = depth
        if depth == 0 and not self.in_window():
            with self._cond:
                self._syncs -= 1
                if self._syncs == 0:
                    self._cond.notify_all()

    def state(self) -> dict:
        """Open windows, legal syncs in flight and the mode in force."""
        with self._cond:
            return {"open": self._open, "syncs": self._syncs, "in_force": self._in_force}


#: the one gate of the process (the sync debug mode is one setting)
GATE = _SyncGate()


@contextmanager
def guarded_launch(device=None):
    """Open a launch window on ``device`` (default: any CUDA work): the
    armed mode is in force inside it, for every thread, until the last open
    window closes. A no-op when no site is armed, when ``device`` is not
    CUDA, or when CUDA is absent."""
    armed = _ARMED.get()
    if (
        armed is None
        or (device is not None and torch.device(device).type != "cuda")
        or not torch.cuda.is_available()
    ):
        yield
        return
    with GATE.window(armed):
        yield


class readback:
    """A legal host sync outside every launch window (a readback, an upload
    from pageable memory, an event wait): waits until no window of any
    thread is open and keeps new ones from opening until it is done. Inside
    the calling thread's own window it is a pass-through."""

    __slots__ = ()

    def __enter__(self):
        GATE.sync_enter()
        return self

    def __exit__(self, *exc):
        GATE.sync_exit()
        return False


class _GatedCalls(TorchFunctionMode):
    """Every torch call of the thread outside its windows runs as a
    :class:`readback`, so a sync it makes never meets another thread's
    window (thread-local: a torch function mode is)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        GATE.sync_enter()
        try:
            return func(*args, **(kwargs or {}))
        finally:
            GATE.sync_exit()


@contextmanager
def _mode_lifted(mode: "_GatedCalls"):
    """The scope without ``mode`` on the thread's torch function stack
    (it is the top entry: windows open inside the mode's scope)."""
    from torch.overrides import _get_current_function_mode, _pop_mode_temporarily

    if _get_current_function_mode() is not mode:
        yield
        return
    with _pop_mode_temporarily():
        yield


@contextmanager
def shared_device(device=None):
    """Run the scope's torch calls beside other threads' launch windows on
    ``device`` (default: any CUDA device): each call outside the thread's
    own windows waits for open windows to close (see :class:`readback`);
    inside its windows the calls run ungated. The selection service runs
    every request under it; the calls of a single-threaded run need it
    not. Off CUDA (no windows open there) it is a no-op."""
    if (device is not None and torch.device(device).type != "cuda") or not torch.cuda.is_available():
        yield
        return
    mode = _GatedCalls()
    outer = getattr(GATE._tls, "gated", None)
    GATE._tls.gated = mode
    try:
        with mode:
            yield
    finally:
        GATE._tls.gated = outer


# --- one-time work per shape -------------------------------------------------

_COMPILE_TLS = threading.local()

#: one-time work of the whole process per label, every thread's
_ONE_TIME: Dict[str, int] = {}
_ONE_TIME_LOCK = threading.Lock()


def note_compile(label: str) -> None:
    """Count one piece of one-time work (a graph capture, a kernel library
    build) against every :class:`CompilationGuard` open on this thread,
    and in the process's tally (:func:`one_time_work`)."""
    for guard in getattr(_COMPILE_TLS, "guards", ()):
        guard.count += 1
        guard.by_name[label] = guard.by_name.get(label, 0) + 1
    with _ONE_TIME_LOCK:
        _ONE_TIME[label] = _ONE_TIME.get(label, 0) + 1


def one_time_work() -> Dict[str, int]:
    """The process's one-time work so far per label, on every thread (a
    copy): a window's captures and builds are the difference of two."""
    with _ONE_TIME_LOCK:
        return dict(_ONE_TIME)


class CompilationGuard:
    """Count the one-time work per shape inside a ``with`` scope, on the
    calling thread: CUDA-graph captures and hand-written kernel library
    builds (the port's counterpart of the JAX package's XLA compiles, and
    read under the same name, ``xla_compiles``, in the service's audit).

    ``log`` receives the count as ``xla_compiles_<name>`` on exit.
    ``max_compiles`` bounds it: a clean exit above it raises
    :class:`GuardViolation` (after the count is logged). Guards nest; each
    counts independently.
    """

    def __init__(self, name: str = "phase", log=None, max_compiles: Optional[int] = None):
        self.name = name
        self.log = log
        self.max_compiles = max_compiles
        self.count = 0
        #: one-time work per label (``cuda_graph_captures``, the library)
        self.by_name: dict = {}

    def __enter__(self) -> "CompilationGuard":
        self.count = 0
        self.by_name = {}
        _COMPILE_TLS.guards = getattr(_COMPILE_TLS, "guards", ()) + (self,)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _COMPILE_TLS.guards = tuple(g for g in _COMPILE_TLS.guards if g is not self)
        if self.log is not None and self.count:
            self.log.count(f"xla_compiles_{self.name}", self.count)
        if exc_type is None and self.max_compiles is not None and self.count > self.max_compiles:
            blame = ", ".join(
                f"{k}={v}" for k, v in sorted(self.by_name.items(), key=lambda kv: -kv[1])
            )
            raise GuardViolation(
                f"{self.name}: {self.count} captures or builds inside a scope "
                f"bounded at {self.max_compiles} — a shape left its bucket or a "
                f"graph is captured again per call" + (f" (by label: {blame})" if blame else "")
            )
