"""Profiler wrappers and the historical renderer imports.

The port's counterpart of the JAX package's ``utils/profiling.py``:

* ``format_timers``/``format_counters`` — re-exported from ``obs.metrics``
  (the registry behind ``RunLog``'s channels);
* :func:`profiler_trace` — a ``torch.profiler`` capture of the host and
  the card (CPU and CUDA activities) exported as a Chrome trace into a
  directory, where the port's own spans (``obs.trace``) are not enough:
  it names every kernel the card ran, the hand-written ones included;
* :func:`annotate` — a named range inside such a capture: a
  ``torch.profiler.record_function`` on the host timeline plus, when CUDA
  is present, an NVTX range on the card's.
"""

from __future__ import annotations

import os
import time
from contextlib import ExitStack, contextmanager
from typing import Optional

# re-exported for the JAX package's import surface
from citizensassemblies_tpu_torch.obs.metrics import (  # noqa: F401
    format_counters,
    format_timers,
)


@contextmanager
def profiler_trace(logdir: Optional[str]):
    """Profile the scope with ``torch.profiler`` (CPU and, when present,
    CUDA activities) and export a Chrome trace into ``logdir``; a no-op for
    ``None``. Yields the profiler (``None`` when off); the exported file's
    path is its ``trace_path`` attribute after the scope."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(str(logdir), f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextmanager
def annotate(name: str):
    """A named range on the profiler's host timeline
    (``torch.profiler.record_function``) and, when CUDA is present, on the
    card's (an NVTX range)."""
    import torch

    with ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
