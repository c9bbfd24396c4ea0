"""LEGACY requests, one caller in a closed loop, each with a sampler seed of
its own drawn from the run's seed, on the run's one pool (pool 0 of the
run's seed: see ``portbench.pools.make_pool``).

Traffic keys: ``entry`` — ``sample_feasible_panels`` (the panels and their
allocation, a bincount the caller takes) or ``legacy_probabilities`` (the
paper's estimator: allocation, unique panels and the pair matrix); ``num``
(accepted panels a request asks for); ``warm_panels`` (the set-up
request's); ``judged`` (how many of the window's answers the reference
draws again, sampled from the run's seed); ``program_config`` (``mc_batch``
is the chains a batch draws, which the reference draws alike).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from portbench.requests import SAMPLER, WARM, BaseLoad, pool_arrays, release
from portbench.pools import derived_seed
from portbench.reference import legacy as ref


class Load(BaseLoad):
    def setup(self) -> None:
        from citizensassemblies_tpu_torch.interop import dense_from_arrays
        from citizensassemblies_tpu_torch.models import legacy

        self.cfg = self.program_config()
        self.batch = int(self.cfg.mc_batch)
        self.num = int(self.traffic["num"])
        self.entry = self.traffic["entry"]
        self._legacy = legacy
        self._timing = False
        self._local = threading.local()
        self.arrays = pool_arrays(self.pool(0))
        self.n = self.arrays[0].shape[0]
        self.k = int(self.arrays[4])
        self.dense = dense_from_arrays(*self.arrays, device=self.device)
        self.draw(int(self.traffic["warm_panels"]), derived_seed(self.seed, 0, WARM))

    def draw(self, num: int, seed: int) -> Dict[str, Any]:
        if self.entry == "legacy_probabilities":
            res = self._legacy.legacy_probabilities(self.dense, iterations=num, seed=seed,
                                                    cfg=self.cfg, device=self.device)
            return dict(panels=res.panels, draws=int(res.draws_attempted),
                        allocation=res.allocation, pairs=res.pair_matrix)
        panels, draws = self._legacy.sample_feasible_panels(self.dense, num, seed=seed,
                                                            cfg=self.cfg)
        allocation = np.bincount(panels.ravel(), minlength=self.n) / float(num)
        return dict(panels=panels, draws=int(draws), allocation=allocation)

    def request(self, i: int, client: int) -> Dict[str, Any]:
        seed = derived_seed(self.seed, i, SAMPLER)
        self._local.sampler_s = 0.0
        rec = self.draw(self.num, seed)
        rec.update(sampler_seed=seed, kept=self.num, steps=rec["draws"] // self.batch * self.k)
        if self._timing:
            rec["sampler_s"] = self._local.sampler_s
        return rec

    def tracing(self):
        """The base's tracing, and a host-clock timer around the sampler's
        batch loop, ``sample_feasible_panels`` (each batch ends in its
        readback), wherever the request calls it: in the estimator too,
        whose pair matrix and set of unique panels come after it. The
        seconds add up per client thread, so a request gets its own."""
        stack = super().tracing()
        collect = self._legacy.sample_feasible_panels

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return collect(*args, **kwargs)
            finally:
                self._local.sampler_s += time.perf_counter() - t0

        self._timing = True
        self._legacy.sample_feasible_panels = timed
        stack.callback(setattr, self._legacy, "sample_feasible_panels", collect)
        stack.callback(setattr, self, "_timing", False)
        return stack

    def finish(self) -> None:
        self.dense = None
        release(self.device)

    def calibrate(self, seed: int, control: bool = True):
        """Request 0 of a run of ``seed`` judged, and the control: the
        reference's own draws with a bfloat16 urgency in the program's
        place."""
        import torch

        from citizensassemblies_tpu_torch.interop import dense_from_arrays

        arrays = pool_arrays(self.pool_of_run(seed))
        self.dense = dense_from_arrays(*arrays, device=self.device)
        sampler_seed = derived_seed(seed, 0, SAMPLER)
        rec = dict(self.draw(self.num, sampler_seed), sampler_seed=sampler_seed)
        got = judge_record(rec, arrays, self.num, self.batch, self.device)
        if not control:
            return got, None
        A, qmin, qmax, _cat, k, _c = arrays
        low = ref.draw_feasible(A, qmin, qmax, k, self.num, sampler_seed, self.batch, self.device,
                                ratio_dtype=torch.bfloat16)
        ctl = dict(panels=low["panels"], draws=low["draws"], sampler_seed=sampler_seed,
                   allocation=ref.allocation(low["panels"], A.shape[0], self.num))
        if "pairs" in rec:
            ctl["pairs"] = ref.pair_matrix(low["panels"], A.shape[0], self.num, self.device)
        return got, judge_record(ctl, arrays, self.num, self.batch, self.device)

    def judge(self, records: List[Dict[str, Any]]) -> Dict[str, Tuple[float, float]]:
        readings = [judge_record(rec, self.arrays, self.num, self.batch, self.device)
                    for rec in self.sample(records, int(self.traffic["judged"]))]
        return self.worst(readings)


def judge_record(rec: Dict[str, Any], arrays, num: int, batch: int, device) -> Dict[str, float]:
    """One answer against the reference's draws from its sampler seed."""
    A, qmin, qmax, _cat, k, _c = arrays
    want = ref.draw_feasible(A, qmin, qmax, k, num, rec["sampler_seed"], batch, device)
    out = ref.judge(rec["panels"], rec["draws"], rec["allocation"], want, A.shape[0], num)
    if "pairs" in rec:
        pairs = ref.pair_matrix(want["panels"], A.shape[0], num, device)
        out["pair_gap"] = float(np.max(np.abs(rec["pairs"] - pairs)))
    release(device)
    return out
