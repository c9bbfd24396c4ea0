"""In-band log channel with counters, gauges and phase timers.

``RunLog`` collects the algorithm's human-readable progress lines (returned
in ``Distribution.output_lines``) and three metric channels: counters
accumulate, gauges are latest-wins in the same namespace, timers accumulate
seconds. Solver code mutates one RunLog from the main thread and from the
anchor-pricer worker thread, so every mutation takes the instance lock.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List


class RunLog:
    """Collects algorithm output lines; optionally echoes them to stdout."""

    def __init__(self, echo: bool = True):
        self.lines: List[str] = []
        self.echo = echo
        self._counters: Dict[str, float] = {}
        self._timers: Dict[str, float] = {}
        self._mutex = threading.Lock()

    def emit(self, message: str) -> str:
        with self._mutex:
            self.lines.append(message)
        if self.echo:
            print(message)
        return message

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
