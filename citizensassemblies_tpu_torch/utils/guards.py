"""Runtime guard against host synchronisations in the device hot paths.

The JAX package wraps its jitted hot calls in ``jax.transfer_guard``, so an
implicit host↔device transfer inside them (a numpy operand re-uploaded per
call, a scalar read back mid-loop) raises. The torch counterpart of that
guard is ``torch.cuda.set_sync_debug_mode``: in mode ``"error"`` every CUDA
call that makes the host wait for the device (a blocking copy either way,
``.item()``, a bool mask index, a stream synchronise) raises, in
``"warn"`` it warns.

Two pieces:

* :func:`no_implicit_transfers` arms the guard for a site, where the JAX
  package opens its ``jax.transfer_guard`` scope (the PDHG solves, the
  device pricing dispatch, the batched LP lanes, the L2 stages, the move
  screens, the two kernel dispatches and the sharded solvers).
  ``Config.transfer_guard`` selects the mode: ``"disallow"`` → ``"error"``,
  ``"log"`` → ``"warn"``, ``"off"`` opens no scope.
* :func:`guarded_launch` is where the mode is in force: around the kernel
  launches, CUDA-graph replays and iteration blocks inside an armed site.
  A site's host readback (a residual read once per block, a harvest) lies
  outside every launch, so it stays legal, as the JAX package's explicit
  conversions do.

The sync debug mode is a process-wide setting, so a launch restores the
previous mode on exit; the arming itself rides a context variable, so a
worker thread (which starts with an empty context) is never armed by its
parent's site. On tensors off CUDA there is nothing to guard and both are
no-ops. ``CompilationGuard`` (XLA compile counting) has no counterpart
here yet; it arrives with the AOT work (ROADMAP queue A item 10).
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch

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


@contextmanager
def guarded_launch(device=None):
    """Hold the armed mode in force for a launch, replay or iteration block
    on ``device`` (default: any CUDA work); a no-op when no site is armed,
    when ``device`` is not CUDA, or when CUDA is absent."""
    armed = _ARMED.get()
    if (
        armed is None
        or (device is not None and torch.device(device).type != "cuda")
        or not torch.cuda.is_available()
    ):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(armed)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
