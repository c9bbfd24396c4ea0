"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration (a file of
its own, ``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``,
whose ``request`` names a module in ``requests/``). Its ``Load`` makes
the inputs from ``--seed`` and warms up every shape (set-up, ``setup_s``);
then clients in closed loops run whole requests until ``--seconds`` have
passed and each has finished the request it started. Each metric of the
cell is read from the run by ``metrics/<metric>.py`` (see
:meth:`Cell.reader`): with ``--trace 0`` the
end-to-end ones, with ``--trace 1`` the per-layer ones, the window then
under ``torch.profiler``. Once the window has closed and the peak memory is
read, the load's plain reference judges the answers; every number
compared is printed beside its limit, last on standard error and last in
the result line, which is the last line of standard output.

A run exits with a nonzero code and prints no result when CUDA is missing
or has fewer cards than the cell asks for, when the program cannot be
imported, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "citizensassemblies_tpu")


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None


_T_IMPORT = time.perf_counter()
_AGE_AT_IMPORT = process_age_s() or 0.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """Everything the benchmark knows of one cell, found by name."""

    def __init__(self, name: str, bench: Optional[dict] = None, root: Path = ROOT):
        self.root = root
        bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(root / "portbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        self.chips = int(self.entry["chips"])

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def load(self, seed: int, device: str):
        module = importlib.import_module(f"portbench.requests.{self.traffic['request']}")
        return module.Load(self.config, self.traffic, int(seed), device)

    def reader(self, metric: str):
        """The ``read`` of ``metrics/<metric>.py``, or, where there is no such
        file, of the file named by the metric's name less its last dotted
        parts: one file a formula, so ``device_idle_pct.draws`` and
        ``device_idle_pct.estimate`` are both read by ``device_idle_pct.py``."""
        folder = self.root / "portbench" / "metrics"
        stem = metric
        while not (folder / f"{stem}.py").is_file() and "." in stem:
            stem = stem.rsplit(".", 1)[0]
        path = folder / f"{stem}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


class Run:
    """What a metric reader reads: the requests, the window, the trace."""

    def __init__(self, cell: Cell, load, seconds: float):
        self.cell = cell
        self.load = load
        self.seconds = float(seconds)
        self.records: List[Dict[str, Any]] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.device_trace: Optional[Dict[str, Any]] = None
        self.host_spans: List[tuple] = []
        self.failures: List[str] = []
        self.notes: List[str] = []
        self._lock = threading.Lock()
        self._next = 0

    def note(self, line: str) -> None:
        """A line for standard error (a reader's working figures)."""
        self.notes.append(line)

    def _take(self) -> int:
        with self._lock:
            i = self._next
            self._next += 1
            return i

    def _client(self, client: int, deadline: float) -> None:
        while time.perf_counter() < deadline:
            i = self._take()
            t0 = time.perf_counter_ns()
            try:
                record = self.load.request(i, client)
            except Exception as exc:  # a failed request is counted, the loop goes on
                import traceback

                traceback.print_exc(file=sys.stderr)
                with self._lock:
                    self.failures.append(f"request {i}: {type(exc).__name__}: {exc}")
                continue
            t1 = time.perf_counter_ns()
            print(f"request {i} (client {client}) {(t1 - t0) * 1e-9:.3f} s", file=sys.stderr,
                  flush=True)
            record.update(index=i, client=client, t0_ns=t0, t1_ns=t1, seconds=(t1 - t0) * 1e-9)
            with self._lock:
                self.records.append(record)
                self.host_spans.append((f"request.{self.cell.traffic['request']}", t0, t1))

    def window(self) -> None:
        """Closed loops of ``load.clients`` clients for ``seconds``; the
        window ends when each has finished the request it started."""
        start = time.perf_counter()
        deadline = start + self.seconds
        clients = int(self.load.clients)
        if clients == 1:
            self._client(0, deadline)
        else:
            threads = [threading.Thread(target=self._client, args=(c, deadline), daemon=True)
                       for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        self.window_s = time.perf_counter() - start
        self.records.sort(key=lambda r: r["index"])


def card_info(chips: int) -> Dict[str, Any]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips)}


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi`` (None when it cannot be
    read)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """Set up, measure and judge one run of ``cell``; returns ``(result,
    run)``. ``device`` other than CUDA is for the CPU tests of the harness:
    its numbers are no device's."""
    import torch

    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    load = cell.load(seed, device)
    load.setup()
    run = Run(cell, load, seconds)
    sync()
    run.setup_s = _AGE_AT_IMPORT + (time.perf_counter() - _T_IMPORT)
    print(f"set-up {run.setup_s:.3f} s", file=sys.stderr, flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from portbench.devtrace import DeviceTrace

        with load.tracing():
            with DeviceTrace(on_card) as dt:
                dt.open_window()
                run.window()
                dt.close_window()
        run.host_spans.extend(load.host_spans())
        run.device_trace = dt.reduce(run.host_spans)
        run.note(f"device trace: first operation {run.device_trace['first_op_after_open_s']} s "
                 f"after the window opened")
    else:
        run.window()
    sync()
    run.note(f"window {run.window_s!r} s, {len(run.records)} requests")
    peak = max(int(torch.cuda.max_memory_allocated(d)) for d in range(cell.chips)) \
        if on_card else 0
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    load.finish()

    checks = load.judge(run.records)
    correct = bool(run.records) and not run.failures and all(
        v <= limit for v, limit in checks.values())
    device_info: Dict[str, Any] = dict(card_info(cell.chips) if on_card else
                                       {"platform": "cpu", "kind": "cpu", "count": 0},
                                       memory_peak_bytes=peak)
    result: Dict[str, Any] = {
        "correct": correct,
        "attempted": len(run.records) + len(run.failures),
        "failed": len(run.failures),
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = run.device_trace["busy_s"]
        device_info["window_s"] = run.device_trace["window_s"]
        result["breakdown"] = {"device_ops": run.device_trace["device_ops"],
                               "idle_gaps": run.device_trace["idle_gaps"]}
    result["power_limit_w"] = power_limit_w() if on_card else None
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result, run


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, run = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in run.failures + run.notes:
        print(line, file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
