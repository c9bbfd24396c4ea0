"""In-band log channel with counters, gauges and phase timers.

``RunLog`` collects the algorithm's human-readable progress lines (returned
in ``Distribution.output_lines``) and three metric channels: counters
accumulate, gauges are latest-wins in the same namespace, timers accumulate
seconds. The channels live in a typed
:class:`~citizensassemblies_tpu_torch.obs.metrics.MetricsRegistry` (the one
the service renders as Prometheus text), and :attr:`RunLog.counters` and
:attr:`RunLog.timers` return the same flat dicts as copies taken under the
registry's lock: solver code mutates one RunLog from the main thread, the
anchor-pricer worker and (in the service) several requests' threads.

With a tracer active (``self.tracer``, which the service sets so worker
threads holding the request's log attribute to it, or the ambient one of
``obs.trace.use_tracer``) every :meth:`RunLog.timer` also records a span of
the same name; without one it is the plain clock read.

``analyze_instance`` tees its report to the console and to
``<out_dir>/<name>_<k>_statistics.txt`` through :func:`tee_file` and
:meth:`RunLog.log` (the reference's ``log`` closure, ``analysis.py:552-556``).
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import IO, List, Optional

from citizensassemblies_tpu_torch.obs.metrics import MetricsRegistry


class RunLog:
    """Collects algorithm output lines; optionally echoes them to stdout and
    writes them to ``file``."""

    def __init__(self, echo: bool = True, file: Optional[IO[str]] = None):
        self.lines: List[str] = []
        self.echo = echo
        self.file = file
        #: the typed registry behind count, gauge and timer
        self.metrics = MetricsRegistry()
        #: the request's ``obs.trace.Tracer`` (set by the service), so spans
        #: of worker threads holding this log attribute to it; None: only
        #: an ambient tracer records
        self.tracer = None
        self._mutex = threading.Lock()

    def emit(self, message: str) -> str:
        with self._mutex:
            self.lines.append(message)
        if self.echo:
            print(message)
        if self.file is not None:
            self.file.write(message + "\n")
        return message

    def log(self, *info) -> None:
        """Tab-joined tee write (the reference's ``log`` at ``analysis.py:554-556``)."""
        msg = "\t".join(str(m) for m in info)
        if self.echo:
            print(*info)
        if self.file is not None:
            self.file.write(msg + "\n")
        with self._mutex:
            self.lines.append(msg)

    def count(self, name: str, inc: int = 1) -> None:
        self.metrics.counter(name).inc(inc)

    def gauge(self, name: str, value) -> None:
        self.metrics.gauge(name).set(value)

    @contextmanager
    def timer(self, name: str):
        """Accumulating phase timer; records a span of the same name when a
        tracer is active."""
        from citizensassemblies_tpu_torch.obs.trace import _resolve

        tracer = _resolve(self)
        sp = tracer.begin(name, stacked=True) if tracer is not None else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if tracer is not None:
                tracer.end(sp)
            self.metrics.timer(name).observe(dt)

    @property
    def counters(self) -> dict:
        return self.metrics.flat_counters()

    @property
    def timers(self) -> dict:
        return self.metrics.flat_timers()


def format_timers(timers: dict) -> str:
    return "Timers: " + ", ".join(f"{k}={v:.2f}s" for k, v in sorted(timers.items()))


def format_counters(counters: dict) -> str:
    return "Counters: " + ", ".join(f"{k}={v}" for k, v in sorted(counters.items()))


@contextmanager
def tee_file(path: Path, echo: bool = True):
    """Context manager yielding a RunLog that writes to ``path`` (utf-8)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        yield RunLog(echo=echo, file=fh)


def progress(i: int, total: int, every: int = 100, out: IO[str] = sys.stdout) -> None:
    """Reference-style periodic progress print (``analysis.py:181-182``)."""
    if (i + 1) % every == 0:
        out.write(f"Running iteration {i + 1} out of {total}.\n")
