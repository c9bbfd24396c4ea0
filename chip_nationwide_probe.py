#!/usr/bin/env python3
"""Measure the nationwide dual LP on one NVIDIA GPU at more than one
portfolio size: how many agents the portfolio leaves in no panel, and how
the port's two PDHG routes converge against HiGHS.

    python3 chip_nationwide_probe.py

Draws 8,192 feasible panels of ``nationwide_registry(n=100_000, seed=0)``
with the LEGACY sampler on the card (``models/legacy.sample_feasible_panels``,
seed 2; every agent unfixed, as the JAX package's ``dist`` bench family
builds its dual LP), and prints the agents no panel holds for every prefix
of 1,024 more panels. Then, on the first 2,048 panels and on the shortest
prefix that holds every agent (8,192 if none does), solves the dual LP by
the row-sharded PDHG on a one-rank mesh (ELL route) and by
``solve_dual_lp_pdhg`` capped at 40,960 iterations (the chained route: the
LP kernel's fit misses at 100,001 variables), each against HiGHS in a
worker process (``chip_smoke.start_highs_reference``). Prints one JSON line
per step and the card's name and power limit. Exits non-zero when CUDA is
absent.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as cs

#: the chained solve's iteration cap (the default 100,000 runs about 80 s
#: where the solve does not converge)
CHAINED_ITERS = 40_960


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.log("chip_nationwide_probe: CUDA is not available")
        return 1
    from citizensassemblies_tpu_torch.data.registry import nationwide_registry
    from citizensassemblies_tpu_torch.dist import runtime
    from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels
    from citizensassemblies_tpu_torch.parallel.mesh import make_mesh
    from citizensassemblies_tpu_torch.parallel.solver import solve_dual_lp_pdhg_sharded
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_dual_lp_pdhg
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    reg = nationwide_registry(n=cs.NATIONWIDE_N, seed=0)
    dense, _ = reg.to_dense(device="cuda")
    t0 = time.perf_counter()
    panels, draws = sample_feasible_panels(dense, 8192, seed=2, distribute=False)
    print(json.dumps(dict(sample_s=time.perf_counter() - t0, draws=draws, k=reg.k)), flush=True)
    n = reg.n
    cover = np.zeros(n, np.int64)
    covs = {}
    for m in range(1024, 8193, 1024):
        np.add.at(cover, panels[m - 1024:m].ravel(), 1)
        covs[m] = dict(uncovered=int((cover == 0).sum()), min=int(cover.min()),
                       p1=float(np.percentile(cover, 1)), mean=float(cover.mean()))
    print(json.dumps(dict(coverage=covs)), flush=True)
    full = [m for m in covs if covs[m]["uncovered"] == 0]
    sizes = [cs.NATIONWIDE_PANELS] + ([min(full)] if full else [8192])
    refs = {}
    for m in sizes:
        P = np.zeros((m, n), dtype=bool)
        P[np.repeat(np.arange(m), reg.k), panels[:m].ravel()] = True
        refs[m] = cs.start_highs_reference((P, np.full(n, -1.0)))
    mesh = make_mesh(1)
    try:
        for m in sizes:
            proc, recv, P, fixed = refs[m]
            st = {}
            t0 = time.perf_counter()
            sol = solve_dual_lp_pdhg_sharded(P, fixed, mesh, cfg=default_config(), stats=st)
            torch.cuda.synchronize()
            print(json.dumps(dict(m=m, sharded=dict(
                s=time.perf_counter() - t0, ok=sol.ok, obj=sol.objective, yhat=sol.yhat,
                iters=st["iters"], res=st["res"], route=st["route"]))), flush=True)
            rlog = RunLog(echo=False)
            t0 = time.perf_counter()
            sol2, (x, lam, mu) = solve_dual_lp_pdhg(
                P, fixed, cfg=default_config().replace(pdhg_max_iters=CHAINED_ITERS),
                device="cuda", log=rlog)
            torch.cuda.synchronize()
            print(json.dumps(dict(m=m, chained=dict(
                s=time.perf_counter() - t0, ok=sol2.ok, obj=sol2.objective, yhat=sol2.yhat,
                kkt_lp_units=cs.dual_lp_kkt(P, fixed, x, lam, mu),
                megakernel_fit_miss=int(rlog.counters.get("megakernel_fit_miss", 0))))),
                flush=True)
            t0 = time.perf_counter()
            hs, status, hobj, hyhat = recv.recv()
            proc.join()
            print(json.dumps(dict(m=m, highs=dict(s=hs, wait=time.perf_counter() - t0,
                                                  status=status, obj=hobj, yhat=hyhat))),
                  flush=True)
    finally:
        runtime.shutdown()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
