"""The dual leximin LPs of the agent-space column generation on a real-size
pool, the port's PDHG against the JAX package's.

The pool is ``sf_b_skewed_instance(seed=1)`` (n = 250, k = 20, six
categories). Its dual LPs are the first rounds of the port's agent-space
CG on the CPU with HiGHS duals (``backend="hybrid"``): round r is the LP
over the portfolio the r-th dual solve of that run sees, built by
``lp_pdhg.dual_lp_operands`` (m1 = 768 to 1024 rows over nv = 251).

Under pytest, each package solves round 0 and round 7 for a fixed length
(tolerance 0, 4096 iterations), on the port's chained route and its fused
gate's plain version; x and λ agree within 5e-4 and the objective within
5e-5 (the bars of ``tests/test_torch_lp.py``).

Run as a script, it solves each round at the path's own tolerance (1e-6)
and cap (100,000 iterations) in both packages, warm-started from the
previous round's solve when that one was ``ok`` (KKT ≤ 4·tol), as the
agent-space path chains them, and prints one JSON line per round and a
summary line::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sf_dual.py --rounds 20
"""

import argparse
import functools
import json
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.solvers import lp_pdhg as jlp
from citizensassemblies_tpu.solvers.sparse_ops import EllPack as JEll
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch.core.generator import sf_b_skewed_instance
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.models import leximin as tlex
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack as TEll
from citizensassemblies_tpu_torch.utils.config import default_config as tcfg
from citizensassemblies_tpu_torch.utils.logging import RunLog

X_TOL, OBJ_TOL = 5e-4, 5e-5
FIXED_ITERS = 4096


class _Enough(Exception):
    pass


@functools.lru_cache(maxsize=None)
def captured_rounds(rounds: int):
    """The first ``rounds`` dual LPs of the port's agent-space CG on the sf_b
    pool (CPU, HiGHS duals): a tuple of ``(P, fixed)``."""
    caps = []
    host_solve = tlex.solve_dual_lp

    def capture(P, fixed):
        caps.append((np.array(P, dtype=bool), np.array(fixed)))
        if len(caps) >= rounds:
            raise _Enough
        return host_solve(P, fixed)

    dense, space = featurize(sf_b_skewed_instance(seed=1), device="cpu")
    cfg = tcfg().replace(
        force_agent_space=True, backend="hybrid",
        decomp_device_pricing=False, lp_batch=False, mixed_precision=False,
    )
    with mock.patch.object(tlex, "solve_dual_lp", capture):
        try:
            tlex.find_distribution_leximin(dense, space, cfg=cfg, log=RunLog(echo=False), device="cpu")
        except _Enough:
            pass
    return tuple(caps)


def solve_jax(ops, tol, max_iters, warm=None):
    """The JAX package's chained ELL core (``_pdhg_core_ell``)."""
    c, G, h, A, b = ops
    cfg = jcfg().replace(pdhg_megakernel=False, pdhg_max_iters=max_iters)
    return jlp.solve_lp_ell(c, JEll.from_rows(G), h, A, b, cfg=cfg, tol=tol, warm=warm)


def solve_port(ops, tol, max_iters, warm=None, gate=False):
    """The port's chained route (``gate=False``) or the fused gate's plain
    version (``gate=True``), on the CPU."""
    c, G, h, A, b = ops
    cfg = tcfg().replace(pdhg_megakernel=gate, pdhg_max_iters=max_iters)
    return tlp.solve_lp_ell(c, TEll.from_rows(G), h, A, b, cfg=cfg, tol=tol, warm=warm, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # the port's PDHG is many small ops: intra-op threads would only contend
    # with the other test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("gate", [False, True], ids=["chained", "fused_plain"])
@pytest.mark.parametrize("rnd", [0, 7])
def test_sf_b_dual_lp_matches_reference_at_a_fixed_length(rnd, gate):
    P, fixed = captured_rounds(8)[rnd]
    ops = tlp.dual_lp_operands(P, fixed)
    want = solve_jax(ops, 0.0, FIXED_ITERS)
    got = solve_port(ops, 0.0, FIXED_ITERS, gate=gate)
    assert want.iters == got.iters == FIXED_ITERS
    assert np.max(np.abs(got.x - want.x)) < X_TOL
    assert np.max(np.abs(got.lam - want.lam)) < X_TOL
    assert abs(got.objective - want.objective) < OBJ_TOL


def _measure(rounds: int, tol: float, max_iters: int) -> int:
    from citizensassemblies_tpu_torch.solvers.highs_backend import solve_dual_lp

    caps = captured_rounds(rounds)
    warm = {"jax": None, "port": None}
    tally = {name: dict(ok=0, capped=0, seconds=0.0) for name in warm}
    for r, (P, fixed) in enumerate(caps):
        ops = tlp.dual_lp_operands(P, fixed)
        m1 = ops[1].shape[0]
        rec = dict(round=r, panels=int(P.shape[0]), m1=m1, nv=len(ops[0]),
                   highs_objective=solve_dual_lp(P.astype(np.float64), fixed).objective)
        for name, solve in (("jax", solve_jax), ("port", solve_port)):
            w = warm[name]
            if w is not None and w[1].shape[0] != m1:
                lam = np.zeros(m1)
                lam[: min(m1, w[1].shape[0])] = w[1][:m1]
                w = (w[0], lam, w[2])
            t0 = time.perf_counter()
            sol = solve(ops, tol, max_iters, warm=w)
            secs = time.perf_counter() - t0
            warm[name] = (sol.x, sol.lam, sol.mu) if sol.ok else None
            rec[name] = dict(iters=int(sol.iters), kkt=float(sol.kkt), ok=bool(sol.ok),
                             objective=float(sol.objective), seconds=secs)
            tally[name]["ok"] += int(sol.ok)
            tally[name]["capped"] += int(sol.iters >= max_iters)
            tally[name]["seconds"] += secs
        print(json.dumps(rec), flush=True)
    print(json.dumps(dict(summary=True, rounds=len(caps), tol=tol, max_iters=max_iters, **tally)), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=100_000)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.exit(_measure(args.rounds, args.tol, args.max_iters))
