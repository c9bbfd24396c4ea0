"""The generic-form PDHG LP: the port against the JAX package.

``min cᵀx, Gx ≤ h, Ax = b, x ≥ 0`` with G as packed ELL rows. The fused
route is the hand-written CUDA kernel ``csrc/lp_block.cu`` on the card; on
the CPU (``pdhg_megakernel=True``) its plain version runs the same block
loop in torch ops. Here it is held against the JAX package's Pallas
``_lp_block_kernel`` in interpret mode, and the chained route against the
JAX package's ``_pdhg_core_ell``, on two fixtures: the one of
``tests/test_megakernel.py::test_parity_generic_lp_route`` (nv = 40, m1 = 32)
and the dual leximin LP of a 200-panel portfolio over n = 60 (m1 = 256
after the bucket pad, nv = 61). The bars are the reference's own
fused-vs-chained ones: x and λ within L∞ 5e-4, the objective within 5e-5.

Iteration counts. On the dual-LP fixture the two packages stop on the same
block at the default tolerance. The generic fixture's residual sits on a
plateau near 3e-4 for some 20,000 iterations, and float32 sums taken in
another order decide on which block it leaves it (the JAX package's own
fused and chained routes stop 2,000 iterations apart there), so its
iteration counts are compared at a tolerance reached before the plateau.
"""

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.robust.inject import FaultInjector, use_injector
from citizensassemblies_tpu.solvers import highs_backend as jhb
from citizensassemblies_tpu.solvers import lp_pdhg as jlp
from citizensassemblies_tpu.solvers.sparse_ops import EllPack as JEll
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as tmk
from citizensassemblies_tpu_torch.solvers import highs_backend as thb
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack as TEll
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog

# the plain kernel version is many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

X_TOL, OBJ_TOL = 5e-4, 5e-5
#: the generic fixture's tolerance for the iteration-count check (reached
#: after 1024 iterations, before its residual plateau)
PLATEAU_FREE_TOL = 1e-3


def _generic():
    """``tests/test_megakernel.py::test_parity_generic_lp_route``'s LP."""
    r = np.random.default_rng(3)
    nv, m1 = 40, 32
    G = (r.random((m1, nv)) < 0.25) * r.random((m1, nv))
    h = G @ np.full(nv, 1.0 / nv) + 0.01
    c = r.random(nv)
    return c, np.asarray(G, np.float32), h, np.ones((1, nv)), np.ones(1)


def _portfolio(rng, n, C, k):
    return interop.portfolio_from_panels([rng.choice(n, k, replace=False) for _ in range(C)], n)


def _dual():
    rng = np.random.default_rng(0)
    n = 60
    P = _portfolio(rng, n, 200, 10)
    fixed = np.full(n, -1.0)
    chosen = rng.choice(n, 10, replace=False)
    fixed[chosen] = rng.uniform(0.05, 0.15, 10)
    return tlp.dual_lp_operands(P, fixed)


FIXTURES = {"generic": _generic, "dual": _dual}


def _jax(ops, gate, tol=None):
    c, G, h, A, b = ops
    return jlp.solve_lp_ell(
        c, JEll.from_rows(G, minor=G.shape[1]), h, A, b,
        cfg=jcfg().replace(pdhg_megakernel=gate), tol=tol,
    )


def _port(ops, gate, tol=None, log=None, warm=None):
    c, G, h, A, b = ops
    return tlp.solve_lp_ell(
        c, TEll.from_rows(G, minor=G.shape[1]), h, A, b,
        cfg=tconfig.default_config().replace(pdhg_megakernel=gate), tol=tol,
        device="cpu", log=log, warm=warm,
    )


def _assert_parity(a, b):
    assert a.ok and b.ok
    assert np.max(np.abs(a.x - b.x)) < X_TOL
    assert np.max(np.abs(a.lam - b.lam)) < X_TOL
    assert abs(a.objective - b.objective) < OBJ_TOL


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fused_plain_matches_pallas_interpret(name):
    """The fused gate's plain version against the JAX package's interpret-mode
    ``_lp_block_kernel``; one dispatch, no fit miss."""
    ops = FIXTURES[name]()
    want = _jax(ops, True)
    log = RunLog(echo=False)
    got = _port(ops, True, log=log)
    _assert_parity(want, got)
    assert log.counters["megakernel_dispatches"] == 1
    assert "megakernel_fit_miss" not in log.counters
    if name == "dual":
        assert got.iters == want.iters
    else:
        assert _port(ops, True, tol=PLATEAU_FREE_TOL).iters == _jax(ops, True, tol=PLATEAU_FREE_TOL).iters


@pytest.mark.parametrize("name", list(FIXTURES))
def test_chained_route_matches_reference(name):
    """``pdhg_megakernel=False``: the chained ELL route against the JAX
    package's ``_pdhg_core_ell``."""
    ops = FIXTURES[name]()
    want = _jax(ops, False)
    got = _port(ops, False)
    _assert_parity(want, got)
    tol = None if name == "dual" else PLATEAU_FREE_TOL
    assert _port(ops, False, tol=tol).iters == _jax(ops, False, tol=tol).iters


def test_dense_core_matches_reference():
    """The dense chained core (``solve_lp``) against the JAX package's."""
    c, G, h, A, b = _dual()
    want = jlp.solve_lp(c, G, h, A, b)
    got = tlp.solve_lp(c, G, h, A, b, device="cpu")
    _assert_parity(want, got)
    assert got.iters == want.iters


def _dual_trial(trial):
    """Trial ``trial`` of ``tests/test_solvers.py::test_pdhg_dual_lp_matches_highs``
    (one seeded stream): a 25-panel portfolio over n = 40, 8 covered agents
    fixed, and the 4 panels its warm re-solve adds."""
    rng = np.random.default_rng(5)
    for _ in range(trial + 1):
        P = _portfolio(rng, 40, 25, 8).astype(np.float64)
        n = P.shape[1]
        fixed = np.full(n, -1.0)
        covered = np.nonzero(P.any(axis=0))[0]
        chosen = rng.choice(covered, 8, replace=False)
        fixed[chosen] = rng.uniform(0.05, 0.3, 8)
        extra = _portfolio(rng, n, 4, 8)
    return P, fixed, extra


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_dual_lp_matches_highs_with_warm_resolve(trial):
    """``solve_dual_lp_pdhg`` through the fused gate against HiGHS, and the
    warm re-solve after the portfolio gains rows."""
    cfg = tconfig.default_config().replace(pdhg_megakernel=True)
    P, fixed, extra = _dual_trial(trial)
    ref = jhb.solve_dual_lp(P, fixed)
    host = thb.solve_dual_lp(P, fixed)
    got, warm = tlp.solve_dual_lp_pdhg(P, fixed, cfg=cfg, device="cpu")
    assert ref.ok and host.ok and got.ok
    assert host.objective == pytest.approx(ref.objective, abs=1e-9)
    assert got.objective == pytest.approx(ref.objective, abs=5e-5)
    assert got.yhat == pytest.approx(ref.yhat, abs=5e-5)
    P2 = np.vstack([P, extra])
    warm2 = (warm[0], np.concatenate([warm[1], np.zeros(4)]), warm[2])
    ref2 = jhb.solve_dual_lp(P2, fixed)
    got2, _ = tlp.solve_dual_lp_pdhg(P2, fixed, cfg=cfg, warm=warm2, device="cpu")
    assert got2.ok
    assert got2.objective == pytest.approx(ref2.objective, abs=5e-5)


def test_final_primal_lp_matches_reference():
    """``solve_final_primal_lp_pdhg`` against the JAX package's and against
    HiGHS (``tests/test_solvers.py::test_pdhg_final_lp_matches_highs``)."""
    rng = np.random.default_rng(9)
    P = _portfolio(rng, 40, 25, 8).astype(np.float64)
    target = rng.uniform(0.0, 0.25, P.shape[1])
    p_ref, e_ref = jhb.solve_final_primal_lp(P, target)
    p_host, e_host = thb.solve_final_primal_lp(P, target)
    p_j, e_j = jlp.solve_final_primal_lp_pdhg(P, target)
    p_t, e_t = tlp.solve_final_primal_lp_pdhg(P, target, device="cpu")
    assert e_host == pytest.approx(e_ref, abs=1e-9)
    assert e_t == pytest.approx(e_ref, abs=1e-4)
    assert e_t == pytest.approx(e_j, abs=OBJ_TOL)
    assert np.max(np.abs(p_t - p_j)) < X_TOL
    assert np.sum(p_t) == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("gate", [True, False])
def test_nan_warm_start_is_resolved_on_the_host(gate):
    """A NaN in the warm start poisons the solve: the sentinel quarantines it
    and ``solve_lp_ell`` returns the float64 host re-solve (``iters == -1``),
    as the JAX package does under its ``pdhg_nan`` fault."""
    ops = _generic()
    nv, m1 = len(ops[0]), ops[1].shape[0]
    x0 = np.zeros(nv)
    x0[0] = np.nan
    log = RunLog(echo=False)
    got = _port(ops, gate, log=log, warm=(x0, np.zeros(m1), np.zeros(1)))
    with use_injector(FaultInjector("pdhg_nan:1.0", seed=5)):
        want = _jax(ops, gate)
    for sol in (got, want):
        assert sol.iters == -1 and sol.ok and np.all(np.isfinite(sol.x))
    assert log.counters["sentinel_poisoned"] == 1
    assert log.counters["sentinel_host_resolve"] == 1
    assert abs(got.objective - want.objective) < 1e-9


def test_lp_gate_and_fit_rule(monkeypatch):
    cfg = tconfig.default_config()
    cpu = torch.device("cpu")
    assert tmk.lp_megakernel_mode(cfg, 61, 256, 1, cpu) == "off"
    assert tmk.lp_megakernel_mode(cfg.replace(pdhg_megakernel=True), 61, 256, 1, cpu) == "fused"
    assert tmk.lp_megakernel_mode(cfg.replace(pdhg_megakernel=False), 61, 256, 1, cpu) == "off"
    # the flagship dual LP (n + 1 = 1728 variables, 4096 panel rows, one
    # equality row) fits, and so does a portfolio at max_portfolio rows
    assert tmk.lp_fits(1728, 4096, 1) and tmk.lp_fits(1728, 8192, 1)
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    log = RunLog(echo=False)
    assert tmk.lp_megakernel_mode(cfg, 1728, 4096, 1, cpu, log=log) == "fused"
    assert "megakernel_fit_miss" not in log.counters
    # an LP whose staged vectors overflow shared memory, or with more
    # equality rows than the kernel holds, goes chained, counted
    max_m2 = tmk.LP_LAYOUT["kLpMaxM2"]
    assert tmk.lp_fits(1728, 4096, max_m2) and not tmk.lp_fits(1728, 4096, max_m2 + 1)
    assert not tmk.lp_fits(1728, 60_000, 1) and not tmk.lp_fits(60_000, 256, 1)
    assert tmk.lp_megakernel_mode(cfg, 1728, 60_000, 1, cpu, log=log) == "off"
    assert tmk.lp_megakernel_mode(cfg, 1728, 4096, max_m2 + 1, cpu, log=log) == "off"
    assert log.counters["megakernel_fit_miss"] == 2


def test_lp_layout_read_from_the_kernel_header():
    """The fit rule, the scratch layout and the scalar-row slots come from
    ``csrc/lp_layout.cuh``: a flagship block's bytes (m1 and nv + 1 rounded
    up to whole 16-byte vectors), the scratch, distinct slots inside the
    row."""
    layout = tmk.LP_LAYOUT
    assert layout["kLpMaxSmem"] == 232_448 and layout["kLpThreads"] == 512
    assert layout["kLpMaxM2"] >= 8
    assert tmk.lp_smem_bytes(1728, 4096) == (4096 + 2 * 1732 + 344 + 6 * 8) * 4
    assert tmk.lp_smem_bytes(251, 1023, 1000) == (1024 + 2 * 252 + 344 + 6 * 8 + 1000) * 4
    assert tmk.lp_scratch_floats(251, 1023, 9) == 5 * 252 + 5 * 1024 + 22 * 9 + 2
    slots = [v for k, v in layout.items() if k.startswith("L_") and k != "L_N"]
    assert len(slots) == 9 and len(set(slots)) == 9
    assert all(0 <= s < layout["L_N"] for s in slots)


def _dual_pack(nv, m1, kp, seed=0):
    """The packed rows of a dual leximin LP as the path builds them: m1
    random panels of k = kp - (1 to 8) members over n = nv - 1 agents, each
    row the panel's ones and -1 on the last variable, ŷ, which is thus in
    every row."""
    r = np.random.default_rng(seed)
    n = nv - 1
    k = {16: 12, 24: 20, 112: 110}[kp]
    idx = np.zeros((m1, kp), np.int32)
    val = np.zeros((m1, kp), np.float32)
    for row in range(m1):
        idx[row, :k] = np.sort(r.choice(n, size=k, replace=False))
        idx[row, k] = n
        val[row, :k] = 1.0
        val[row, k] = -1.0
    return idx, val


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", [(121, 256, 16), (251, 1024, 24), (1728, 4096, 112)])
def test_lp_launch_plan_owns_every_row_and_variable(shape, sms):
    """The LP kernel's plan, from the planner the two-sided kernel uses:
    every row and every variable owned by exactly one block (a variable a
    tile holds with fewer mates than the block has warps gets consecutive
    warps of that block), ŷ's block no heavier than twice the mean, the
    block count by the small-LP rule, and the resident/streaming choice by
    the layout header's rule. One block is a legal plan too."""
    nv, m1, kp = shape
    idx, val = _dual_pack(nv, m1, kp)
    _, rowptr, _ = tmk.csr_transpose(idx, val, nv)
    nnz = int(rowptr[-1])
    plan = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, sms)
    nb = plan.blocks_per_lane
    # the small-LP rule: one block up to LP_ONE_BLOCK_ENTRIES pack entries,
    # else one per LP_ENTRIES_PER_BLOCK
    work = m1 * kp + nnz
    assert nb == tmk.lp_block_count(m1, kp, nnz, sms)
    assert nb == (1 if work <= tmk.LP_ONE_BLOCK_ENTRIES
                  else max(1, min(sms, -(-work // tmk.LP_ENTRIES_PER_BLOCK))))
    assert plan.lanes == 1 and plan.grid == nb
    assert nb == {121: 1, 251: 23, 1728: sms}[nv]
    for bounds, n in ((plan.col_bounds, m1), (plan.type_bounds, nv)):
        assert len(bounds) == nb + 1 and bounds[0] == 0 and bounds[-1] == n
        assert np.all(np.diff(bounds) >= 0)
        assert len(np.repeat(np.arange(nb), np.diff(bounds))) == n
    assert np.all(np.diff(plan.col_bounds) <= -(-m1 // nb))
    # ŷ's block: no more than twice the mean share, and ŷ's CSR run split
    # over consecutive warps when its tile leaves warps spare
    weight = np.diff(rowptr.astype(np.int64)) + 32
    tiles = [int(weight[a:b].sum()) for a, b in zip(plan.type_bounds[:-1], plan.type_bounds[1:])]
    home = int(np.searchsorted(plan.type_bounds, nv - 1, side="right")) - 1
    assert plan.type_bounds[home] <= nv - 1 < plan.type_bounds[home + 1]
    assert tiles[home] <= 2 * weight.sum() / nb
    warps = tmk.LP_LAYOUT["kLpThreads"] // 32
    nt = int(plan.type_bounds[home + 1] - plan.type_bounds[home])
    parts = warps // nt if nt < warps else 1
    local = nv - 1 - int(plan.type_bounds[home])
    assert list(range(local * parts, (local + 1) * parts)) == [
        job for job in range(nt * parts) if job // parts == local
    ]
    if nv == 1728:
        assert parts > 1
    # resident when the largest share and its state fit beside the staged
    # vectors, by the header's constants
    L = tmk.LP_LAYOUT
    need = (
        2 * (np.diff(plan.col_bounds) * kp + np.diff(rowptr[plan.type_bounds].astype(np.int64)))
        + L["kLpOwnRowVectors"] * np.diff(plan.col_bounds)
        + (L["kLpOwnVarVectors"] + 1) * np.diff(plan.type_bounds)
    )
    fits = tmk.lp_smem_bytes(nv, m1, int(need.max())) <= L["kLpMaxSmem"]
    assert plan.tile_floats == (int(need.max()) if fits else 0)
    # a card that holds two streaming blocks an SM but one resident one:
    # the plan keeps the shares resident on one block an SM
    two = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, lambda tile: sms if tile else 2 * sms)
    assert (two.grid, two.tile_floats > 0) == ((sms, True) if nb == sms else (nb, bool(plan.tile_floats)))
    one = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, sms, blocks=1)
    assert one.grid == 1 and list(one.col_bounds) == [0, m1] and list(one.type_bounds) == [0, nv]
