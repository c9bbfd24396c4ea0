"""Request kinds: the general code that turns a traffic file into requests
to the port and judges the answers.

A traffic file's ``request`` names a module here; its ``Load`` takes the
configuration, the traffic, the run's seed and the device. ``setup`` makes
the inputs and warms up, ``request(i, client)`` runs request ``i`` and
returns its record, ``finish`` releases the program's state, and ``judge(records)`` returns each number compared with
its limit (``{name: (worst value, limit)}``), the limits being the
configuration's ``checks`` for this load. ``calibrate(seed)`` gives the
numbers of request 0 of a run of ``seed`` and of the load's control
(``portbench.calibrate``, the readings the limits are set from).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np

from portbench.pools import Pool, derived_seed, make_pool

#: salts of the seeds a run derives besides its requests'
WARM, JUDGE, SAMPLER = 1, 2, 3


class BaseLoad:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.clients = int(traffic.get("clients", 1))
        self.tracer = None
        self.limits: Dict[str, float] = dict(config["checks"][traffic["request"]])

    def pool(self, index: int, salt: int = 0) -> Pool:
        """Pool ``index`` of this run (``salt``: of the warm-up)."""
        return make_pool(self.config["pool"], derived_seed(self.seed, index, salt))

    def pool_of_run(self, seed: int, index: int = 0) -> Pool:
        """The pool request ``index`` of a run of ``seed`` solves."""
        return make_pool(self.config["pool"], derived_seed(seed, index))

    def program_config(self):
        """The port's ``Config`` at its defaults, with the traffic's
        ``program_config`` overrides."""
        from citizensassemblies_tpu_torch.utils.config import Config

        return Config(**self.traffic.get("program_config", {}))

    def tracing(self):
        """The context the traced window runs under: the port's span tracer
        (``obs/trace``), ambient on the calling thread, without device
        sampling, so its spans are the host's and cost no wait."""
        from citizensassemblies_tpu_torch.obs.trace import Tracer, use_tracer

        self.tracer = Tracer(name="portbench", sample_device=False, max_spans=1_000_000)
        stack = contextlib.ExitStack()
        stack.enter_context(use_tracer(self.tracer))
        return stack

    def host_spans(self) -> List[Tuple[str, int, int]]:
        """``(name, t0_ns, t1_ns)`` host spans the program recorded."""
        if self.tracer is None:
            return []
        return [(sp.name, int(sp.t0 * 1e9), int(sp.t1 * 1e9))
                for sp in self.tracer.spans() if sp.t1 is not None]

    def finish(self) -> None:
        pass

    def worst(self, readings: List[Dict[str, float]]) -> Dict[str, Tuple[float, float]]:
        """Each number's worst reading over the answers judged, with its
        limit."""
        out: Dict[str, Tuple[float, float]] = {}
        for name, limit in self.limits.items():
            values = [r[name] for r in readings if name in r]
            out[name] = (float(max(values)) if values else float("inf"), float(limit))
        return out

    def sample(self, records: List[Dict[str, Any]], size: int) -> List[Dict[str, Any]]:
        """``size`` records drawn from the run's seed (all when fewer)."""
        if len(records) <= size:
            return list(records)
        rng = np.random.default_rng(derived_seed(self.seed, 0, JUDGE))
        return [records[i] for i in sorted(rng.choice(len(records), size=size, replace=False))]


def release(device: str) -> None:
    """Wait for the card and hand its cached blocks back (nothing on the
    CPU)."""
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def pool_arrays(pool: Pool):
    """``(A bool [n, F], qmin, qmax, cat_of_feature, k, categories)``."""
    return (pool.incidence(), pool.qmin, pool.qmax, pool.cat_of_feature, pool.k,
            len(pool.sizes))
