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

import ctypes
import dataclasses
import os

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
    # an LP whose staged lambda overflows shared memory, or with more
    # equality rows than the kernel holds, goes chained, counted; one whose
    # x-bar alone overflows it takes the global-x-bar route
    max_m2 = tmk.LP_LAYOUT["kLpMaxM2"]
    assert tmk.lp_fits(1728, 4096, max_m2) and not tmk.lp_fits(1728, 4096, max_m2 + 1)
    assert not tmk.lp_fits(1728, 60_000, 1) and tmk.lp_fits(60_000, 256, 1)
    assert not tmk.lp_stage_x(60_000, 256) and not tmk.lp_fits(60_000, 60_000, 1)
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
    k = {16: 12, 24: 20, 112: 110, 320: 316}[kp]
    idx = np.zeros((m1, kp), np.int32)
    val = np.zeros((m1, kp), np.float32)
    for row in range(m1):
        idx[row, :k] = np.sort(r.choice(n, size=k, replace=False))
        idx[row, k] = n
        val[row, :k] = 1.0
        val[row, k] = -1.0
    return idx, val


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize(
    "shape", [(121, 256, 16), (251, 1024, 24), (1728, 4096, 112), (100_001, 2048, 320)]
)
def test_lp_launch_plan_owns_every_row_and_variable(shape, sms):
    """The LP kernel's plan, from the planner the two-sided kernel uses:
    every row and every variable owned by exactly one block (a variable a
    tile holds with fewer mates than the block has warps gets consecutive
    warps of that block), ŷ's block no heavier than twice the mean, the
    block count by the small-LP rule, and x̄'s route and the
    resident/streaming choice by the layout header's rule. The nationwide
    dual LP (n = 100,000 agents, 2,048 panels of 316) takes the global-x̄
    route; a plan forced onto that route keeps the staged plan's tiles.
    One block is a legal plan too, on the global route at every shape and
    on the staged one where x̄ fits."""
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
    assert nb == {121: 1, 251: 23, 1728: sms, 100_001: sms}[nv]
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
    # x-bar staged where it fits beside lambda, else read where it is
    # published
    L = tmk.LP_LAYOUT
    assert plan.stage_x == (tmk.lp_smem_bytes(nv, m1) <= L["kLpMaxSmem"]) == (nv != 100_001)
    # resident when the largest share and its state fit beside the staged
    # vectors, by the header's constants
    need = (
        2 * (np.diff(plan.col_bounds) * kp + np.diff(rowptr[plan.type_bounds].astype(np.int64)))
        + L["kLpOwnRowVectors"] * np.diff(plan.col_bounds)
        + (L["kLpOwnVarVectors"] + 1) * np.diff(plan.type_bounds)
    )
    fits = tmk.lp_smem_bytes(nv, m1, int(need.max()), plan.stage_x) <= L["kLpMaxSmem"]
    assert plan.tile_floats == (int(need.max()) if fits else 0)
    # the global route forced: the same tiles, resident by its own bytes
    forced = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, sms, stage_x=False)
    assert not forced.stage_x and forced.grid == nb
    assert np.array_equal(forced.col_bounds, plan.col_bounds)
    assert np.array_equal(forced.type_bounds, plan.type_bounds)
    fits_g = tmk.lp_smem_bytes(nv, m1, int(need.max()), False) <= L["kLpMaxSmem"]
    assert forced.tile_floats == (int(need.max()) if fits_g else 0)
    # a card that holds two streaming blocks an SM but one resident one:
    # the plan keeps the shares resident on one block an SM
    two = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, lambda tile: sms if tile else 2 * sms)
    assert (two.grid, two.tile_floats > 0) == ((sms, True) if nb == sms else (nb, bool(plan.tile_floats)))
    for stage_x in (None, False):
        one = tmk.lp_launch_plan(nv, m1, 1, kp, rowptr, sms, blocks=1, stage_x=stage_x)
        assert one.grid == 1 and list(one.col_bounds) == [0, m1] and list(one.type_bounds) == [0, nv]
        assert one.stage_x == (stage_x is None and plan.stage_x)


def test_lp_routes_follow_the_layout_header(monkeypatch):
    """x̄'s two routes by ``csrc/lp_layout.cuh``: a block's bytes on each
    (staged: λ, x̄ and a row pointer over all nv + 1 variables; global: λ
    alone, nothing of nv), the route the nationwide dual LP takes (x̄ past
    shared memory, the global route fits), a forced staged route there
    raising, any count of variables fitting the global route, and a λ past
    shared memory, or more equality rows than the kernel holds, still a
    counted fit miss."""
    L = tmk.LP_LAYOUT
    fixed = 344 + 6 * 8  # the reduction scratch and the mu vectors
    assert tmk.lp_smem_bytes(100_001, 2048) == (2048 + 2 * 100_004 + fixed) * 4
    assert tmk.lp_smem_bytes(100_001, 2048, stage_x=False) == (2048 + fixed) * 4
    assert tmk.lp_smem_bytes(7, 2048, stage_x=False) == tmk.lp_smem_bytes(100_001, 2048, 0, False)
    assert tmk.lp_smem_bytes(251, 1023, 1000, stage_x=False) == (1024 + fixed + 1000) * 4
    assert tmk.lp_smem_bytes(100_001, 2048) > L["kLpMaxSmem"]
    assert tmk.lp_smem_bytes(100_001, 2048, stage_x=False) <= L["kLpMaxSmem"]
    assert tmk.lp_fits(100_001, 2048, 1) and not tmk.lp_stage_x(100_001, 2048)
    assert tmk.lp_stage_x(1728, 4096) and not tmk.lp_stage_x(1728, 4096, stage_x=False)
    with pytest.raises(ValueError):
        tmk.lp_stage_x(100_001, 2048, stage_x=True)
    idx, val = _dual_pack(100_001, 2048, 320)
    _, rowptr, _ = tmk.csr_transpose(idx, val, 100_001)
    with pytest.raises(ValueError):
        tmk.lp_launch_plan(100_001, 2048, 1, 320, rowptr, 132, stage_x=True)
    with pytest.raises(ValueError):
        tmk.lp_launch_inputs(idx, val, 100_001, 1, "cpu", stage_x=True)
    # the most rows a global-route block stages; variables without limit
    m1_max = L["kLpMaxSmem"] // 4 - fixed
    assert tmk.lp_fits(100_001, m1_max, 1) and not tmk.lp_fits(100_001, m1_max + 4, 1)
    assert tmk.lp_fits(10_000_001, 256, 1) and not tmk.lp_stage_x(10_000_001, 256)
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    log = RunLog(echo=False)
    cfg = tconfig.default_config()
    cpu = torch.device("cpu")
    assert tmk.lp_megakernel_mode(cfg, 100_001, 2048, 1, cpu, log=log) == "fused"
    assert "megakernel_fit_miss" not in log.counters
    assert tmk.lp_megakernel_mode(cfg, 100_001, m1_max + 4, 1, cpu, log=log) == "off"
    assert tmk.lp_megakernel_mode(cfg, 100_001, 2048, L["kLpMaxM2"] + 1, cpu, log=log) == "off"
    assert log.counters["megakernel_fit_miss"] == 2


def test_lp_library_builds_its_routes_in_two_units(tmp_path):
    """The LP library compiles its global-x̄ instances
    (``csrc/lp_block_global_x.cu``) beside ``lp_block.cu``, each in a
    process of its own, and links both objects into the one library: a
    unit's symbols reach the other's, a unit that does not compile fails
    the build with its own exit code, and no object is left behind. Run
    with the host C compiler standing in for ``nvcc`` (same flags but the
    CUDA ones)."""
    import shutil

    from citizensassemblies_tpu_torch.kernels import cuda_lib

    assert [os.path.basename(u) for u in tmk.LP_KERNEL.units] == ["lp_block_global_x.cu"]
    with open(tmk.LP_KERNEL.units[0]) as fh:
        unit = fh.read()
    assert "#define LP_BLOCK_GLOBAL_X_UNIT" in unit and '#include "lp_block.cu"' in unit
    cc = shutil.which("cc")
    if cc is None:
        pytest.skip("no host C compiler")
    (tmp_path / "a.c").write_text("int lp_global(void);\nint lp_staged(void) { return lp_global() + 1; }\n")
    (tmp_path / "b.c").write_text("int lp_global(void) { return 41; }\n")
    cmd = [cc, "-shared", "-fPIC", "-O2"]
    lib = str(tmp_path / "lib.so")
    build = cuda_lib._UnitsBuild(cmd, [str(tmp_path / "a.c"), str(tmp_path / "b.c")], lib)
    build.communicate()
    assert build.returncode == 0 and ctypes.CDLL(lib).lp_staged() == 42
    broken = cuda_lib._UnitsBuild(cmd, [str(tmp_path / "a.c"), str(tmp_path / "c.c")],
                                  str(tmp_path / "lib2.so"))
    _out, err = broken.communicate()
    assert broken.returncode != 0 and b"c.c" in err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.c", "b.c", "lib.so"]


def _nationwide_ops():
    """The nationwide dual LP's operands (``lp_pdhg.dual_lp_operands``,
    every agent unfixed) over :func:`_dual_pack`'s 2,048 synthetic panels:
    ``(c, idx, val, h, A, b)``."""
    nv = 100_001
    idx, val = _dual_pack(nv, 2048, 320)
    c = np.zeros(nv)
    c[-1] = 1.0
    A = np.ones((1, nv))
    A[0, -1] = 0.0
    return c, idx, val, np.zeros(2048), A, np.ones(1)


def test_wrapper_passes_the_route_and_counts_global_x_launches_apart(monkeypatch):
    """``lp_blocks_cuda`` hands the kernel its plan's x̄ route (the
    argument before the stream) and counts a launch on the global route
    under ``lp_solve_launch.global_x``, and in all; a plan that stages x̄
    where it does not fit is refused before any launch. Run on CPU tensors
    with the C call, the device check and the stream stood in for, so the
    launch arguments are what the card would get."""
    calls = []
    monkeypatch.setattr(tmk.CudaLibrary, "run", lambda self, fname, *a: calls.append((fname, a)) or 0)
    monkeypatch.setattr(tmk, "_require_cuda", lambda dev, *tensors: None)
    monkeypatch.setattr(tmk, "stream_of", lambda t: None)
    monkeypatch.setattr(tmk.LP_KERNEL, "launches", 0)
    monkeypatch.setattr(tmk.LP_KERNEL, "entry_launches", {})
    c, G, h, A, b = _dual()
    small = TEll.from_rows(G, minor=G.shape[1])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    for (c, idx, val, h, A, b), stage_x in (
        ((c, small.idx, small.val, h, A, b), None),
        ((c, small.idx, small.val, h, A, b), False),
        (_nationwide_ops(), None),
    ):
        nv, (m1, kp) = len(c), idx.shape
        csr = tmk.csr_to_device(idx, val, nv, "cpu")
        plan = tmk.lp_launch_plan(nv, m1, 1, kp, csr[1].numpy(), 132, stage_x=stage_x).upload("cpu")
        idx_t = torch.as_tensor(idx)
        zeros = (torch.zeros(nv), torch.zeros(m1), torch.zeros(1))
        pre, state = tmk.lp_setup(f32(c), idx_t, f32(val), f32(h), f32(A), f32(b), *zeros, csr)
        kw = dict(max_iters=1024, check_every=128, sentinel=True)
        tmk.lp_blocks_cuda(csr, plan, idx_t, pre, state, 1e-6, **kw)
        fname, args = calls[-1]
        assert fname == "lp_solve_launch"
        assert args[20:30] == (nv, m1, 1, kp, plan.blocks_per_lane, plan.tile_floats, 128, 1024, 1,
                               int(plan.stage_x))
        assert plan.stage_x == (stage_x is None and nv == 61)
    assert tmk.LP_KERNEL.launches == 3
    assert tmk.LP_KERNEL.entry_launches == {"lp_solve_launch": 1, "lp_solve_launch.global_x": 2}
    staged = dataclasses.replace(plan, stage_x=True)
    with pytest.raises(ValueError):
        tmk.lp_blocks_cuda(csr, staged, idx_t, pre, state, 1e-6, **kw)
    assert len(calls) == 3 and tmk.LP_KERNEL.launches == 3


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("shape", [(300, 50), (256, 7), (1, 3), (0, 5), (513, 120)])
def test_dual_lp_pack_is_the_dense_pack(shape, weights):
    """``solve_dual_lp_pdhg``'s ELL pack, built from the portfolio's
    nonzeros, is ``EllPack.from_rows`` of ``dual_lp_operands``' dense ``G``
    array for array: slot count, indices, values (float64 weights rounded
    alike, a NaN kept), the bucket's padding rows, the counters. An empty
    panel row and a portfolio with no rows included."""
    C, n = shape
    r = np.random.default_rng(C + n)
    P = r.random((C, n)) < 0.2
    if C > 3:
        P[3] = False
    if weights:
        P = P * r.uniform(0.1, 2.0, (C, n))
        if C:
            P[0, 0] = np.nan
    c, G, h, A, b = tlp.dual_lp_operands(P, np.full(n, -1.0))
    want = TEll.from_rows(G)
    got = tlp._dual_lp_pack(P, G.shape[0])
    assert (got.minor, got.nnz_total, got.pack_rows) == (want.minor, want.nnz_total, want.pack_rows)
    assert got.idx.dtype == want.idx.dtype and got.val.dtype == want.val.dtype
    assert np.array_equal(got.idx, want.idx)
    assert np.array_equal(got.val, want.val, equal_nan=True)


@pytest.mark.parametrize("uncovered", ["unfixed", "fixed_at_zero"])
def test_dist_family_dual_lp_matches_jax_and_highs(uncovered):
    """The JAX package's ``dist`` bench family's dual LP
    (``bench.py:2716-2771``: feasible panels of ``nationwide_registry(n=2000,
    seed=0)`` from the LEGACY sampler, seed 2) at 512 panels, a row count
    that keeps each case near a minute or less on one CPU worker (the family's own
    768 take over a minute here): the port's ``solve_dual_lp_pdhg`` through
    the fused gate (on the CPU the LP kernel's plain version; on the card
    the nationwide LP of the same construction takes the kernel's global-x̄
    route, ``chip_smoke.py`` phase 16) and the JAX package's at its
    defaults, each within 1e-4 of HiGHS in objective and ŷ (the card
    phase's tolerance) and within 5e-5 of each other, each ``y`` within
    1e-4 of the LP's feasible set. Five agents sit in no panel. With every
    agent unfixed, as the family builds it and as at the nationwide cell's
    2,048 panels, y puts its mass on them and the optimum is 0; with those
    five fixed at probability 0, as a leximin run fixes agents no panel
    holds, the optimum is ŷ ≈ 0.0091 and every y counts."""
    from citizensassemblies_tpu_torch.data.registry import nationwide_registry
    from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels

    reg = nationwide_registry(n=2000, seed=0)
    dense, _space = reg.to_dense(device="cpu")
    rows = 512
    panels, _draws = sample_feasible_panels(dense, rows, seed=2, distribute=False)
    P = np.zeros((rows, reg.n), dtype=bool)
    P[np.repeat(np.arange(rows), reg.k), np.asarray(panels).ravel()] = True
    fixed = np.full(reg.n, -1.0)
    empty = P.sum(axis=0) == 0
    assert int(empty.sum()) == 5
    if uncovered == "fixed_at_zero":
        fixed[empty] = 0.0
    ref = thb.solve_dual_lp(P, fixed)
    assert ref.ok and (ref.objective > 5e-3) == (uncovered == "fixed_at_zero")
    log = RunLog(echo=False)
    got, _ = tlp.solve_dual_lp_pdhg(
        P, fixed, cfg=tconfig.default_config().replace(pdhg_megakernel=True), device="cpu", log=log
    )
    want, _ = jlp.solve_dual_lp_pdhg(P, fixed)
    assert got.ok and want.ok
    assert log.counters["megakernel_dispatches"] == 1
    for sol in (got, want):
        assert sol.objective == pytest.approx(ref.objective, abs=1e-4)
        assert sol.yhat == pytest.approx(ref.yhat, abs=1e-4)
        y = np.asarray(sol.y, np.float64)
        assert y.min() >= -1e-4 and abs(y[fixed < 0].sum() - 1.0) <= 1e-4
        assert (P.astype(np.float64) @ y).max() <= sol.yhat + 1e-4
    assert got.objective == pytest.approx(want.objective, abs=OBJ_TOL)
    assert got.yhat == pytest.approx(want.yhat, abs=OBJ_TOL)
