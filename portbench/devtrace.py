"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the metric readers and the result line
need.

* ``busy_s``: the union of the intervals in which an operation (a kernel,
  a copy, a fill) ran on the card, inside the window; ``window_s`` the
  window's length, both on the profiler's clock.
* ``kernels``: per device-operation name, its count and its seconds.
* ``gaps``: the idle intervals between busy ones, each named by the
  innermost host span open at its midpoint (the benchmark's own spans
  around each request, and the program's spans when it records them).

Only device activity is recorded (no host operators, which would slow a
launch-bound window several times over). The profiler stamps events on the
host's wall clock (``time.time_ns``), so the window's ends are read on that
clock after a synchronise, and host spans taken with
``time.perf_counter_ns`` are moved onto it by the offset between the two
clocks read at the window's start.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

def _ns(event, name: str) -> int:
    """``start`` or ``duration`` of a kineto event in ns, whichever accessor
    this torch has."""
    fn = getattr(event, f"{name}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{name}_us")() * 1000)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Profile the block it wraps; :meth:`open_window` and
    :meth:`close_window` mark the measured part. After the block,
    :meth:`reduce` gives the summary."""

    def __init__(self, on_card: bool = True):
        import torch

        self._torch = torch
        self._on_card = on_card
        activity = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(
            activities=[activity.CUDA] if on_card else [activity.CPU])
        self.w0 = self.w1 = None
        self.offset: Optional[int] = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def _sync(self) -> None:
        if self._on_card:
            self._torch.cuda.synchronize()

    def open_window(self) -> None:
        self._sync()
        perf = time.perf_counter_ns()
        self.w0 = time.time_ns()
        self.offset = self.w0 - perf

    def close_window(self) -> None:
        self._sync()
        self.w1 = time.time_ns()

    def reduce(self, host_spans: Sequence[Tuple[str, int, int]] = ()) -> Dict:
        """``{"busy_s", "window_s", "kernels": {name: [count, seconds]},
        "gaps": [(label, seconds)], "device_ops": [...]}``; ``host_spans``
        are ``(name, t0_ns, t1_ns)`` on ``time.perf_counter_ns``."""
        w0, w1, offset = self.w0, self.w1, self.offset
        device: List[Tuple[str, int, int]] = []
        for ev in self._prof.profiler.kineto_results.events():
            if str(ev.device_type()).rsplit(".", 1)[-1] == "CPU" or ev.is_user_annotation():
                continue  # host calls, and host ranges mirrored on the device timeline
            start = _ns(ev, "start")
            device.append((ev.name(), start, start + _ns(ev, "duration")))
        kernels: Dict[str, List[float]] = {}
        spans: List[Tuple[int, int]] = []
        for name, a, b in device:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            entry = kernels.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (b - a) * 1e-9
            spans.append((a, b))
        busy = _union(spans)
        busy_s = sum(b - a for a, b in busy) * 1e-9
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        by_label = _label_gaps(gaps, [(t0 + offset, t1 + offset, name)
                                      for name, t0, t1 in host_spans])
        ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        first = min((a for _n, a, _b in device if a >= w0), default=None)
        return {
            "first_op_after_open_s": None if first is None else (first - w0) * 1e-9,
            "busy_s": busy_s,
            "window_s": (w1 - w0) * 1e-9,
            "kernels": kernels,
            "device_ops": [[name[:120], secs] for name, (_c, secs) in ops],
            "idle_gaps": [[label[:120], secs] for label, secs in
                          sorted(by_label.items(), key=lambda kv: -kv[1])[:10]],
        }


def _label_gaps(gaps: List[Tuple[int, int]],
                hosts: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds per label: each gap goes to the latest-opened host span
    that covers its midpoint (one sweep over both, sorted by time)."""
    hosts = sorted(hosts)
    open_spans: List[Tuple[int, int, str]] = []  # max-heap on the start
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while j < len(hosts) and hosts[j][0] <= mid:
            t0, t1, name = hosts[j]
            heapq.heappush(open_spans, (-t0, t1, name))
            j += 1
        while open_spans and open_spans[0][1] < mid:
            heapq.heappop(open_spans)
        label = open_spans[0][2] if open_spans else "host (no span)"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out

