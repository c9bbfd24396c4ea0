"""In-band log channel with counters, gauges and phase timers.

``RunLog`` collects the algorithm's human-readable progress lines (returned
in ``Distribution.output_lines``) and three metric channels: counters
accumulate, gauges are latest-wins in the same namespace, timers accumulate
seconds. Solver code mutates one RunLog from the main thread and from the
anchor-pricer worker thread, so every mutation takes the instance lock.

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
from typing import IO, Dict, List, Optional


class RunLog:
    """Collects algorithm output lines; optionally echoes them to stdout and
    writes them to ``file``."""

    def __init__(self, echo: bool = True, file: Optional[IO[str]] = None):
        self.lines: List[str] = []
        self.echo = echo
        self.file = file
        self._counters: Dict[str, float] = {}
        self._timers: Dict[str, float] = {}
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
        with self._mutex:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value) -> None:
        with self._mutex:
            self._counters[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._mutex:
                self._timers[name] = self._timers.get(name, 0.0) + dt

    @property
    def counters(self) -> dict:
        with self._mutex:
            return dict(self._counters)

    @property
    def timers(self) -> dict:
        with self._mutex:
            return dict(self._timers)


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
