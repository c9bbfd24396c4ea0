"""Spawned ``torch.distributed`` worlds for the port's distribution tests.

:func:`run_world` starts ``nprocs`` fresh processes (the ``spawn`` start
method), each joining one gloo world on the CPU through the port's own
environment contract (``CITIZENS_DIST_COORDINATOR`` as a ``file://`` init
method in the test's temporary directory, ``CITIZENS_DIST_NUM_PROCESSES``,
``CITIZENS_DIST_PROCESS_ID``), runs one job of :data:`JOBS` and writes its
result (or its traceback) to a pickle beside the store. The world joins
under a time limit; past it every process is killed and the call fails.

The jobs import only the port and numpy, never JAX: the tests compare what
they return with the JAX package in the parent process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

#: seconds a spawned world of each job may take before it is killed and
#: failed: about three times the slower of its 2- and 4-rank worlds'
#: wall time measured beside six busy pytest workers on an 8-core machine
#: (process start included), and never under 60 s
WORLD_TIMEOUT_S = {
    "dist": 120.0,
    "sampler": 60.0,
    "allocation": 60.0,
    "dropout": 60.0,
    "dual": 150.0,
    "master": 120.0,
    "sweep": 60.0,
    "routed": 70.0,
}

#: the parity fixture of tests/test_parallel.py
POOL = dict(n=48, k=6, n_categories=2, features_per_category=2, seed=0)


def run_world(nprocs: int, job: str, tmp_path: Path, timeout: float | None = None, **kwargs):
    """Run ``JOBS[job](**kwargs)`` on every rank of a fresh ``nprocs``-rank
    gloo world under ``timeout`` (default: the job's
    :data:`WORLD_TIMEOUT_S`); returns the ranks' results in rank order."""
    timeout = WORLD_TIMEOUT_S[job] if timeout is None else timeout
    ctx = mp.get_context("spawn")
    tmp_path = Path(tmp_path)
    tag = "_".join([job, str(nprocs)] + [str(v) for v in kwargs.values()])
    store = tmp_path / f"rdv_{tag}"
    outs = [tmp_path / f"{tag}_r{r}.pkl" for r in range(nprocs)]
    procs = [
        ctx.Process(target=_child, args=(r, nprocs, str(store), job, kwargs, str(outs[r])))
        for r in range(nprocs)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
    for p in procs:
        p.join(10)
    if late:
        raise AssertionError(f"the {nprocs}-rank world of {job!r} passed its {timeout:.0f} s limit")
    results = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        if not path.exists():
            raise AssertionError(f"rank {r} of {job!r} exited {p.exitcode} without a result")
        with open(path, "rb") as f:
            ok, payload = pickle.load(f)
        if not ok:
            raise AssertionError(f"rank {r} of {job!r} failed:\n{payload}")
        results.append(payload)
    return results


def _child(rank: int, nprocs: int, store: str, job: str, kwargs: dict, out: str) -> None:
    os.environ["CITIZENS_DIST_COORDINATOR"] = "file://" + store
    os.environ["CITIZENS_DIST_NUM_PROCESSES"] = str(nprocs)
    os.environ["CITIZENS_DIST_PROCESS_ID"] = str(rank)
    import torch

    torch.set_num_threads(1)
    from citizensassemblies_tpu_torch.dist import runtime

    try:
        runtime.bootstrap(device="cpu")
        result = (True, JOBS[job](**kwargs))
    except BaseException:  # the traceback goes to the parent, which fails the test
        result = (False, traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    runtime.shutdown()


# --- shared fixtures ---------------------------------------------------------------


def pool_dense():
    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.core.instance import featurize

    return featurize(random_instance(**POOL), device="cpu")[0]


def feasible_portfolio(dense, num: int = 600, seed: int = 2):
    """``num`` feasible panels of ``dense`` as a bool ``[num, n]`` matrix,
    drawn undistributed (the same on every rank and in the parent)."""
    from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels

    panels, _ = sample_feasible_panels(dense, num, seed=seed, distribute=False)
    P = np.zeros((num, dense.n), dtype=bool)
    for r, row in enumerate(panels):
        P[r, row] = True
    return P


def type_ids(A: np.ndarray) -> np.ndarray:
    """Base-type labels: agents with identical feature rows share one."""
    _, inv = np.unique(np.asarray(A), axis=0, return_inverse=True)
    return inv.reshape(-1).astype(np.int64)


def attendance(n: int, seed: int = 1) -> np.ndarray:
    return 1.0 - np.random.default_rng(seed).uniform(0.0, 0.5, n)


def master_fixture():
    """``(MT, v)`` of tests/test_parallel.py's sharded-master test: every
    composition of the pool, the uniform mixture's profile as target."""
    from citizensassemblies_tpu_torch.solvers.compositions import enumerate_compositions
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(pool_dense())
    comps = enumerate_compositions(red, cap=100000, node_budget=1000000)
    m = red.msize.astype(np.float64)
    MT = np.ascontiguousarray((comps.astype(np.float64) / m[None, :]).T)
    return MT, MT.mean(axis=1)


def sweep_problems():
    """Final ε-LPs of three portfolios of the pool (the sweep fleet)."""
    dense = pool_dense()
    P = feasible_portfolio(dense, 120, seed=5)
    rng = np.random.default_rng(7)
    out = []
    for C in (40, 80, 120):
        Pi = P[:C]
        t = Pi.T.astype(np.float64) @ rng.dirichlet(np.ones(C))
        out.append((Pi, t))
    return out


# --- jobs ---------------------------------------------------------------------------


def job_dist() -> dict:
    """The runtime and partition layer on a 4-rank world."""
    import torch
    import torch.distributed as dist

    from citizensassemblies_tpu_torch.dist import partition as dp
    from citizensassemblies_tpu_torch.dist import runtime
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh, make_mesh
    from citizensassemblies_tpu_torch.robust.inject import (
        FaultInjected,
        FaultInjector,
        use_injector,
    )
    from citizensassemblies_tpu_torch.robust.policy import DegradationLadder
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    out: dict = {"rank": dist.get_rank()}
    info = runtime.bootstrap()
    out["bootstrap"] = (info.initialized, info.coordinator.startswith("file://"),
                        info.process_index, info.process_count, runtime.bootstrap() is info)
    out["shapes"] = {}
    for a in (1, 2, 4):
        topo = runtime.build_topology(4, agents_axis=a)
        out["shapes"][a] = (topo.shape, topo.n_devices, topo.hosts, topo.devices_per_host,
                            tuple(topo.mesh.mesh_dim_names))
    errors = []
    for n, a in ((3, 2), (2, 1)):
        try:
            runtime.build_topology(n, agents_axis=a)
        except ValueError as exc:
            errors.append(str(exc))
    out["topology_errors"] = errors
    t1 = runtime.default_topology()
    out["default_cached"] = (runtime.default_topology() is t1, default_mesh() is t1.mesh)
    # the all_reduce and the mesh's sub-groups
    x = torch.full((3,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    out["all_reduce"] = x.tolist()
    mesh22 = make_mesh(4, agents_axis=2)
    out["coordinate"] = tuple(mesh22.get_coordinate())
    # effective_mesh and its gauges
    cfg = default_config()
    log = RunLog(echo=False)
    eff = runtime.effective_mesh(cfg, log=log)
    out["effective"] = (eff is not None and eff.size() == 4, {
        k: log.counters.get(k) for k in ("dist_mesh_hosts", "dist_mesh_devices", "dist_process_index")
    })
    out["effective_off"] = runtime.effective_mesh(cfg.replace(dist_mesh=False)) is None
    out["process_slice"] = [runtime.process_slice(k) for k in (7, 0, 2, 12)]
    out["host_lane"] = runtime.host_lane()
    # prepartition on the 2x2 mesh: the sequence of tests/test_dist.py
    log = RunLog(echo=False)
    sh = dp.chain_batch(mesh22, ndim=2)
    y = dp.prepartition(np.ones((16, 4), np.float32), sh, log=log)
    seq = [(log.counters.get("dist_placements", 0), dp.reshard_count(log))]
    y2 = dp.prepartition(y, sh, log=log)
    seq.append((log.counters.get("dist_placements", 0), dp.reshard_count(log), y2 is y))
    moved = dp.prepartition(y, dp.chain_rows(mesh22, ndim=2), log=log)
    seq.append((log.counters.get("dist_placements", 0), dp.reshard_count(log)))
    out["prepartition"] = seq
    out["local_shapes"] = (tuple(y.to_local().shape), tuple(moved.to_local().shape),
                           bool(torch.equal(moved.full_tensor(), torch.ones(16, 4))))
    out["declared_once"] = (
        dp.chain_batch(mesh22) is dp.chain_batch(mesh22),
        dp.portfolio(mesh22) is dp.portfolio(mesh22),
        dp.bucket(mesh22, 3) is dp.bucket(mesh22, 3),
    )
    # dist_collective walks the ladder down to dist_mesh=False
    inj = FaultInjector("dist_collective:1.0", seed=0)
    raised = False
    try:
        with use_injector(inj):
            runtime.effective_mesh(cfg, log=log)
    except FaultInjected:
        raised = True
    ladder = DegradationLadder()
    walked = cfg
    while not ladder.exhausted:
        walked = ladder.degrade(walked)
    out["fault"] = (raised, log.counters.get("fault_dist_collective"), walked.dist_mesh,
                    runtime.effective_mesh(walked) is None)
    return out


def job_sampler(world: int) -> dict:
    """The chain-parallel sampler, the Monte-Carlo round and LEGACY."""
    import torch

    from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities
    from citizensassemblies_tpu_torch.parallel import mc
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh

    dense = pool_dense()
    mesh = default_mesh()
    out: dict = {}
    for batch in (200, 203):
        p, ok = mc.distributed_sample_panels(dense, torch.Generator().manual_seed(11), batch, mesh)
        out[f"sample_{batch}"] = (p.numpy(), ok.numpy())
    p, ok, counts, pair = mc.distributed_mc_round(dense, torch.Generator().manual_seed(3), mesh, 16)
    out["mc_round"] = (p.numpy(), ok.numpy(), counts.numpy(), pair.numpy())
    out["legacy"] = legacy_probabilities(dense, iterations=4000, seed=0, device="cpu").allocation
    return out


def job_allocation(world: int) -> np.ndarray:
    """The portfolio matvec, on a ``(chains, agents)`` mesh where the world
    size allows it."""
    from citizensassemblies_tpu_torch.parallel import mc
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh, make_mesh

    P = feasible_portfolio(pool_dense())
    probs = np.random.default_rng(0).dirichlet(np.ones(len(P)))
    mesh = make_mesh(world, agents_axis=2) if world % 2 == 0 else default_mesh()
    return mc.distributed_allocation(P[:16], probs[:16] / probs[:16].sum(), mesh).numpy()


def job_dropout(world: int, draws: int) -> dict:
    """The dropout realization under every policy."""
    import torch

    from citizensassemblies_tpu_torch.parallel import mc
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh

    dense = pool_dense()
    P = feasible_portfolio(dense)
    probs = np.random.default_rng(0).dirichlet(np.ones(len(P)))
    out = {}
    for policy in mc.DROPOUT_POLICIES:
        r = mc.dropout_realization_round(
            P, probs, attendance(dense.n), type_ids(dense.A_np), dense,
            torch.Generator().manual_seed(4), draws, policy, mesh=default_mesh(), chunk=1024,
        )
        out[policy] = (r.counts, r.counts_valid, r.quota_ok_rate, r.fill_rate)
    return out


def job_dual(world: int, route: str) -> tuple:
    """The sharded dual LP on its ``"ell"`` or ``"dense"`` route."""
    from citizensassemblies_tpu_torch.parallel import solver
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh
    from citizensassemblies_tpu_torch.utils.config import default_config

    dense = pool_dense()
    P = feasible_portfolio(dense)
    st: dict = {}
    sol = solver.solve_dual_lp_pdhg_sharded(
        P, np.full(dense.n, -1.0), default_mesh(), stats=st,
        cfg=default_config().replace(sparse_ops=None if route == "ell" else False),
    )
    return sol.ok, sol.objective, sol.yhat, sol.y, st


def job_master(world: int) -> tuple:
    """The sharded face master on :func:`master_fixture`."""
    from citizensassemblies_tpu_torch.parallel import solver
    from citizensassemblies_tpu_torch.parallel.mesh import default_mesh

    MT, v = master_fixture()
    eps_real, w, p_norm, _eps_obj, _ok = solver.solve_decomp_master_sharded(
        MT, v, default_mesh(), tol=1e-7
    )
    return eps_real, float(p_norm.sum()), w, p_norm


def job_sweep(world: int) -> tuple:
    """The sweep's LP fleet dealt over the ranks."""
    from citizensassemblies_tpu_torch.parallel import sweep
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    pairs = sweep_problems()
    log = RunLog(echo=False)
    res = sweep.sweep_final_primal_eps([a for a, _ in pairs], [b for _, b in pairs],
                                       cfg=default_config(), log=log, device="cpu")
    return [(p_, e) for p_, e in res], dict(log.counters)


def job_routed(world: int) -> dict:
    """The agent-space LEXIMIN with its dual LPs routed through the sharded
    solver, and the face loop with its masters routed through the sharded
    master."""
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.parallel import solver as par_solver
    from citizensassemblies_tpu_torch.utils.config import default_config

    calls = {"n": 0}
    orig = par_solver.solve_dual_lp_pdhg_sharded

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    par_solver.solve_dual_lp_pdhg_sharded = counting
    try:
        dist_ = find_distribution_leximin(
            pool_dense(),
            cfg=default_config().replace(dual_shard_min_rows=1, force_agent_space=True),
            device="cpu",
        )
    finally:
        par_solver.solve_dual_lp_pdhg_sharded = orig
    return {"leximin": (calls["n"], dist_.allocation), "face": face_loop_sharded()}


def face_loop_sharded(max_rounds: int = 8):
    """The face loop on the pool (at most ``max_rounds`` rounds) on the
    device route (the block kernel's plain version on the CPU) with
    ``master_shard_min_types=1``: every master routed through the sharded
    face master in a world of more than one rank, the single-device master
    in a one-rank world. Returns ``(eps, counters, columns, profile)``,
    ``profile`` the realized type profile ``(C / m)ᵀ p``."""
    from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
    from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    red = TypeReduction(pool_dense())
    v, _ = tcg._leximin_relaxation(red, RunLog(echo=False))
    seeds = tcg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)
    cfg = default_config().replace(
        decomp_device_pricing=False, lp_batch=False, mixed_precision=False,
        decomp_host_master_max_types=0, master_shard_min_types=1,
    )
    log = RunLog(echo=False)
    C, p, eps, _ = tfd.realize_profile(
        red, v, list(seeds), tcg.CompositionOracle(red), cfg.decomp_accept, log=log,
        max_rounds=max_rounds, use_pdhg=True, cfg=cfg, device="cpu",
    )
    profile = (C.astype(np.float64) / red.msize.astype(np.float64)[None, :]).T @ p
    return eps, dict(log.counters), C, profile


JOBS = {
    "dist": job_dist,
    "sampler": job_sampler,
    "allocation": job_allocation,
    "dropout": job_dropout,
    "dual": job_dual,
    "master": job_master,
    "sweep": job_sweep,
    "routed": job_routed,
}


def _time_worlds() -> None:
    """Print the wall time of every world the tests spawn, one JSON line
    each: ``python tests/torch_worlds.py`` (from the repo root)."""
    import json
    import tempfile

    plan = [("dist", 4, {})] + [
        (job, n, kw)
        for job, kw in (("sampler", {}), ("allocation", {}), ("dropout", {"draws": 3000}),
                        ("dual", {"route": "ell"}), ("dual", {"route": "dense"}),
                        ("master", {}), ("sweep", {}))
        for n in (2, 4)
    ] + [("routed", 2, {})]
    for job, n, kw in plan:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            run_world(n, job, tmp, timeout=900.0, **({} if job == "dist" else {"world": n}), **kw)
        print(json.dumps(dict(job=job, ranks=n, kwargs=kw, seconds=round(time.monotonic() - t0, 1),
                              limit_s=WORLD_TIMEOUT_S[job])), flush=True)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    _time_worlds()
