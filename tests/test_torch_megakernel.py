"""The two-sided PDHG master: the port against the JAX package.

The fused route is the hand-written CUDA block kernel on the card; on the
CPU (``pdhg_megakernel=True``) its plain version runs the same block loop
in torch ops. Here it is held against the JAX package's Pallas block kernel
in interpret mode (``two_sided_megakernel_core(..., interpret=True)``) on the
fixtures of ``tests/test_megakernel.py``, rebuilt from the same seeds, at
one lane and at three lanes with prefix column masks. The bars are the
reference's own fused-vs-chained ones: x and λ within L∞ 5e-4, the
objective within 5e-5, and equal per-lane iteration counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citizensassemblies_tpu.kernels import pdhg_megakernel as jmk
from citizensassemblies_tpu.solvers import lp_pdhg as jlp
from citizensassemblies_tpu.solvers.sparse_ops import EllPack as JEll
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as tmk
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack as TEll
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog

# the plain kernel versions are many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

X_TOL, OBJ_TOL = 5e-4, 5e-5
TOL = 1e-5
MAX_ITERS = 4096
CHECK_EVERY = 128


def _flagship_master(seed=7, T=24, C=96):
    """``tests/test_megakernel.py::_flagship_master``: composition counts
    over T types scaled by 1/8, ``v`` realised by the uniform mix."""
    r = np.random.default_rng(seed)
    comps = (r.random((C, T)) < 0.2) * r.integers(1, 4, (C, T))
    MT = (comps / 8.0).T.astype(np.float64)
    return MT, MT @ np.full(C, 1.0 / C)


def _household_master(seed=11, T=40, C=64):
    """``tests/test_megakernel.py::_household_master``."""
    r = np.random.default_rng(seed)
    comps = (r.random((C, T)) < 0.12) * r.integers(1, 3, (C, T))
    comps[:, 0] = 1
    MT = (comps / 4.0).T.astype(np.float64)
    return MT, MT @ np.full(C, 1.0 / C)


FIXTURES = {"flagship": _flagship_master, "household": _household_master}


def _lanes(MT, v, caps, nan_lane=None):
    """numpy operands of a B-lane solve over the shared column pack."""
    T, C = MT.shape
    idx, val = TEll.from_rows(np.asarray(MT, np.float32).T, minor=T).padded(C)
    B = len(caps)
    colmask = np.zeros((B, C), np.float32)
    for b, cap in enumerate(caps):
        colmask[b, :cap] = 1.0
    x0 = np.zeros((B, C + 1), np.float32)
    if nan_lane is not None:
        x0[nan_lane, 0] = np.nan
    return dict(
        idx=idx, val=val, v=np.asarray(v, np.float32), colmask=colmask, x0=x0,
        lam0=np.zeros((B, 2 * T), np.float32), mu0=np.zeros(B, np.float32),
        tol=np.full(B, TOL, np.float32),
    )


def _jax_fused(ops):
    out = jmk.two_sided_megakernel_core(
        *(jnp.asarray(ops[k]) for k in ("idx", "val", "v", "colmask", "x0", "lam0", "mu0", "tol")),
        max_iters=MAX_ITERS, check_every=CHECK_EVERY, sentinel=True, interpret=True,
    )
    return [np.asarray(o) for o in out]


def _port_fused(ops, log=None):
    t = {k: torch.as_tensor(ops[k]) for k in ("v", "colmask", "x0", "lam0", "mu0", "tol")}
    out = tmk.dispatch_two_sided(
        ops["idx"], ops["val"], t["v"], t["colmask"], t["x0"], t["lam0"], t["mu0"], t["tol"],
        max_iters=MAX_ITERS, check_every=CHECK_EVERY, sentinel=True, log=log,
    )
    return [o.numpy() for o in out]


def _assert_parity(a, b, lanes):
    """``a``/``b``: ``(x, lam, mu, it, res, flags)`` of two routes."""
    C = a[0].shape[1] - 1
    for lane in lanes:
        assert np.max(np.abs(a[0][lane] - b[0][lane])) < X_TOL
        assert np.max(np.abs(a[1][lane] - b[1][lane])) < X_TOL
        assert abs(a[0][lane, C] - b[0][lane, C]) < OBJ_TOL
        assert int(a[3][lane]) == int(b[3][lane])


@pytest.mark.parametrize("caps", ["one", "prefix"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_fused_plain_matches_pallas_interpret(name, caps):
    MT, v = FIXTURES[name]()
    C = MT.shape[1]
    caps = [C] if caps == "one" else [C // 4, C // 2, C]
    ops = _lanes(MT, v, caps)
    want = _jax_fused(ops)
    log = RunLog(echo=False)
    got = _port_fused(ops, log=log)
    _assert_parity(want, got, range(len(caps)))
    assert np.all(got[3] > 0) and np.all(got[5] == 0)
    assert log.counters["megakernel_dispatches"] == 1
    assert log.counters["megakernel_lanes"] == len(caps)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_chained_route_matches_reference(name):
    """``pdhg_megakernel=False``: the chained ELL route against the JAX
    package's ``_pdhg_two_sided_core_ell`` (through the master entry point)."""
    MT, v = FIXTURES[name]()
    T = MT.shape[0]
    rows = np.asarray(MT, np.float32).T
    a = jlp.solve_two_sided_master_ell(
        JEll.from_rows(rows, minor=T), v, cfg=jcfg().replace(pdhg_megakernel=False)
    )
    b = tlp.solve_two_sided_master_ell(
        TEll.from_rows(rows, minor=T), v,
        cfg=tconfig.default_config().replace(pdhg_megakernel=False), device="cpu",
    )
    assert a.ok and b.ok
    assert np.max(np.abs(a.x - b.x)) < X_TOL
    assert np.max(np.abs(a.lam - b.lam)) < X_TOL
    assert abs(a.objective - b.objective) < OBJ_TOL
    assert a.iters == b.iters


def test_dense_master_matches_reference():
    """The dense-``MT`` master entry point (packed by columns, chained
    route) against the reference's dense core."""
    MT, v = _flagship_master()
    a = jlp.solve_two_sided_master(MT, v, cfg=jcfg().replace(pdhg_megakernel=False))
    b = tlp.solve_two_sided_master(
        MT, v, cfg=tconfig.default_config().replace(pdhg_megakernel=False), device="cpu"
    )
    assert a.ok and b.ok
    assert np.max(np.abs(a.x - b.x)) < X_TOL
    assert abs(a.objective - b.objective) < OBJ_TOL
    assert a.iters == b.iters


def test_nan_lane_quarantined_mates_bit_identical():
    """A NaN-warmed lane freezes at iteration 0 with a non-finite KKT and the
    poisoned flag; its mates match a clean run bit for bit, and the JAX
    package quarantines the same lane the same way."""
    MT, v = _flagship_master()
    caps = [24, 48, 96]
    clean = _port_fused(_lanes(MT, v, caps))
    ops = _lanes(MT, v, caps, nan_lane=1)
    mixed = _port_fused(ops)
    ref = _jax_fused(ops)
    for out in (mixed, ref):
        assert int(out[3][1]) == 0 and not np.isfinite(out[4][1])
        assert int(out[5][1]) & tlp.FLAG_POISONED
    for lane in (0, 2):
        np.testing.assert_array_equal(mixed[0][lane], clean[0][lane])
        np.testing.assert_array_equal(mixed[1][lane], clean[1][lane])
        assert mixed[3][lane] == clean[3][lane]
    _assert_parity(ref, mixed, (0, 2))
    # the blocking readback reports the quarantined lane as not ok
    h = tlp._handle(*(torch.as_tensor(o[1]) for o in mixed), Cp=96, T=24, tol=TOL)
    assert not tlp.finish_two_sided_master(h).ok


def test_warm_start_survives_bucket_repad():
    """A warm triple from a 128-column bucket re-sliced into a 256-column one
    (``tests/test_megakernel.py::test_warm_slot_survives_bucket_repad``):
    warm beats cold on the fused and the chained route, and both agree."""
    r7 = np.random.default_rng(7)
    comps = (r7.random((96, 24)) < 0.2) * r7.integers(1, 4, (96, 24))
    r19 = np.random.default_rng(19)
    extra = (r19.random((64, 24)) < 0.2) * r19.integers(1, 4, (64, 24))
    _, v = _flagship_master()
    small = TEll.from_rows((comps / 8.0).astype(np.float32), minor=24)
    big = TEll.from_rows(np.concatenate([comps / 8.0, extra / 8.0]).astype(np.float32), minor=24)
    fused = tconfig.default_config().replace(pdhg_megakernel=True)
    chained = tconfig.default_config().replace(pdhg_megakernel=False)
    kw = dict(bucket=128, device="cpu")
    s = tlp.solve_two_sided_master_ell(small, v, cfg=fused, **kw)
    warm = interop.warm_from_arrays(s.x, s.lam, s.mu)
    cold_f = tlp.solve_two_sided_master_ell(big, v, cfg=fused, **kw)
    warm_f = tlp.solve_two_sided_master_ell(big, v, cfg=fused, warm=warm, **kw)
    cold_c = tlp.solve_two_sided_master_ell(big, v, cfg=chained, **kw)
    warm_c = tlp.solve_two_sided_master_ell(big, v, cfg=chained, warm=warm, **kw)
    assert warm_f.ok and warm_c.ok
    assert warm_f.iters < cold_f.iters and warm_c.iters < cold_c.iters
    assert abs(warm_f.objective - warm_c.objective) < OBJ_TOL


def test_gate_and_fit_rule(monkeypatch):
    cfg = tconfig.default_config()
    cpu = torch.device("cpu")
    # auto is off on the CPU, True engages the plain version, False is off
    assert tmk.megakernel_mode(cfg, 24, 128, cpu) == "off"
    assert tmk.megakernel_mode(cfg.replace(pdhg_megakernel=True), 24, 128, cpu) == "fused"
    assert tmk.megakernel_mode(cfg.replace(pdhg_megakernel=False), 24, 128, cpu) == "off"
    # the flagship master (T=814, Cp up to 6144) fits, at up to a lane per SM
    assert tmk.two_sided_fits(814, 6144)
    assert tmk.two_sided_fits(814, 6144, lanes=tmk.H100_SMS)
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    log = RunLog(echo=False)
    assert tmk.megakernel_mode(cfg, 814, 6144, cpu, log=log) == "fused"
    assert "megakernel_fit_miss" not in log.counters
    # a block whose staged y and p-bar overflow shared memory goes chained,
    # counted
    assert not tmk.two_sided_fits(814, 60_000)
    assert tmk.megakernel_mode(cfg, 814, 60_000, cpu, log=log) == "off"
    assert log.counters["megakernel_fit_miss"] == 1
    # so do more lanes than co-resident blocks
    assert not tmk.two_sided_fits(814, 6144, lanes=tmk.H100_SMS + 1)
    assert tmk.megakernel_mode(cfg, 814, 6144, cpu, log=log, lanes=tmk.H100_SMS + 1) == "off"
    assert log.counters["megakernel_fit_miss"] == 2


def test_layout_read_from_the_kernel_header():
    """The fit rule, the scratch layout and the scalar-row slots come from
    the kernel's own header: a flagship block's bytes, a lane's scratch, and
    distinct slots inside the row."""
    layout = tmk.LAYOUT
    # T and Cp rounded up to whole 16-byte vectors
    assert tmk.two_sided_smem_bytes(814, 6144) == (816 + 6144 + 312) * 4
    assert tmk.two_sided_smem_bytes(814, 6144, 1000) == (816 + 6144 + 312 + 1000) * 4
    assert tmk.two_sided_scratch_floats(814, 6144, 133) == 5 * 6144 + 8 * 816 + 9 * 133 + 3
    assert layout["kMaxSmem"] == 232_448 and layout["kThreads"] == 512
    slots = [v for k, v in layout.items() if k.startswith("S_") and k != "S_N"]
    assert len(slots) == 15 and len(set(slots)) == 15
    assert all(0 <= s < layout["S_N"] for s in slots)


def _skewed_rowptr(T=814, C=6144, k=110, seed=3):
    """The type-major row pointer of C random k-member panels over T types
    drawn with Zipf-like weights, as skewed as the flagship pool's."""
    r = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, T + 1)
    counts = np.zeros(T, np.int64)
    for _ in range(C):
        counts[np.unique(r.choice(T, size=k, p=w / w.sum()))] += 1
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("lanes", [1, 2, 3, 7])
def test_launch_plan_owns_every_column_and_type(lanes, sms, monkeypatch):
    """Every column and every type of each lane is owned by exactly one
    block of that lane's group, the groups are disjoint and co-resident, the
    type tiles are balanced by CSR entries, and one lane more than the card
    holds blocks is a counted fit miss."""
    T, Cp = 814, 6144
    coresident = 2 * sms
    rowptr = _skewed_rowptr(T, Cp)
    plan = tmk.launch_plan(lanes, T, Cp, coresident, rowptr, kp=112)
    nb = plan.blocks_per_lane
    assert nb == coresident // lanes and plan.grid <= coresident
    for bounds, n in ((plan.col_bounds, Cp), (plan.type_bounds, T)):
        assert len(bounds) == nb + 1 and bounds[0] == 0 and bounds[-1] == n
        assert np.all(np.diff(bounds) >= 0)
        owner = np.repeat(np.arange(nb), np.diff(bounds))
        assert len(owner) == n  # each index in exactly one tile
    groups = [set(range(g * nb, (g + 1) * nb)) for g in range(lanes)]
    assert sum(len(g) for g in groups) == len(set().union(*groups)) == plan.grid
    # no type tile carries more than an even share plus its heaviest type
    weight = np.diff(rowptr.astype(np.int64)) + 32
    tiles = [weight[a:b].sum() for a, b in zip(plan.type_bounds[:-1], plan.type_bounds[1:])]
    assert max(tiles) <= weight.sum() / nb + weight.max()
    assert np.all(np.diff(plan.col_bounds) <= -(-Cp // nb))
    # a resident plan holds every block's share of both pack layouts and
    # its column and type state
    need = (
        2 * (np.diff(plan.col_bounds) * 112 + np.diff(rowptr[plan.type_bounds]))
        + 6 * np.diff(plan.col_bounds) + 13 * np.diff(plan.type_bounds)
    )
    if plan.tile_floats:
        assert plan.tile_floats == need.max()
        assert tmk.two_sided_smem_bytes(T, Cp, plan.tile_floats) <= tmk.LAYOUT["kMaxSmem"]
    else:
        assert tmk.two_sided_smem_bytes(T, Cp, need.max()) > tmk.LAYOUT["kMaxSmem"]
    with pytest.raises(ValueError):
        tmk.launch_plan(coresident + 1, T, Cp, coresident, rowptr)
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    log = RunLog(echo=False)
    cfg = tconfig.default_config()
    cpu = torch.device("cpu")
    mode = tmk.megakernel_mode(cfg, T, Cp, cpu, log=log, lanes=lanes, coresident=coresident)
    assert mode == "fused"
    assert tmk.megakernel_mode(
        cfg, T, Cp, cpu, log=log, lanes=coresident + 1, coresident=coresident
    ) == "off"
    assert log.counters["megakernel_fit_miss"] == 1


def test_csr_forward_matches_scatter():
    """The forward product as a segment sum over the type-major CSR (the
    prelude's, the plain version's and the chained route's) equals the
    ``index_add_`` scatter on a 3-lane prefix-masked pack."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_scatter_mv

    MT, v = _flagship_master()
    ops = _lanes(MT, v, [24, 48, 96])
    T = MT.shape[0]
    idx = torch.as_tensor(ops["idx"])
    _, vals_s = tmk.two_sided_prelude(
        idx, torch.as_tensor(ops["val"]), torch.as_tensor(ops["v"]), torch.as_tensor(ops["colmask"])
    )
    csr = tmk.csr_to_device(ops["idx"], ops["val"], T, "cpu")
    p = torch.as_tensor(np.random.default_rng(5).random((3, 96)).astype(np.float32))
    got = tmk.csr_forward(csr, vals_s)(p).numpy()
    want = ell_scatter_mv(idx, vals_s, p, T).numpy()
    assert got.shape == (3, T)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # and it is a fixed order: the same bits on a second call
    np.testing.assert_array_equal(tmk.csr_forward(csr, vals_s)(p).numpy(), got)


def test_gate_off_bitwise_identity():
    """Auto on the CPU and ``False`` are the same chained route, bit for bit."""
    MT, v = _flagship_master()
    ell = TEll.from_rows(np.asarray(MT, np.float32).T, minor=24)
    cfg = tconfig.default_config()
    auto = tlp.solve_two_sided_master_ell(ell, v, cfg=cfg, device="cpu")
    off = tlp.solve_two_sided_master_ell(ell, v, cfg=cfg.replace(pdhg_megakernel=False), device="cpu")
    np.testing.assert_array_equal(auto.x, off.x)
    np.testing.assert_array_equal(auto.lam, off.lam)
    assert auto.iters == off.iters and auto.kkt == off.kkt


def test_config_maps_from_reference():
    ref = jcfg()
    port = interop.config_from_dict(dataclasses.asdict(ref))
    fields = [f.name for f in dataclasses.fields(tconfig.Config)]
    for name in fields:
        if name in interop.CARD_FIELDS:
            # the machine's own value: the card's float32 ridge
            assert getattr(port, name) == getattr(tconfig.default_config(), name), name
            continue
        assert getattr(port, name) == getattr(ref, name), name
    assert port == tconfig.default_config()
    assert port.obs_roofline_ridge == 20.0 and ref.obs_roofline_ridge == 10.0
    # mixed precision and the face checkpoints, once refused, resolve: the
    # mapped knobs engage demotion and the checkpointer
    from types import SimpleNamespace

    from citizensassemblies_tpu_torch.robust.checkpoint import FaceCheckpointer
    from citizensassemblies_tpu_torch.solvers.batch_lp import lp_batch_enabled
    from citizensassemblies_tpu_torch.solvers.device_pricing import device_pricing_enabled
    from citizensassemblies_tpu_torch.utils.precision import mixed_precision_enabled

    cpu = torch.device("cpu")
    mapped = interop.config_from_dict(dataclasses.asdict(ref.replace(
        mixed_precision=True, robust_checkpoint_every=1, robust_checkpoint_dir="ckpt",
        fault_sites="pdhg_nan:0.5", fault_seed=7,
    )))
    assert mixed_precision_enabled(mapped, cpu) and not mixed_precision_enabled(port, cpu)
    red = SimpleNamespace(type_feature=np.zeros((2, 1)), qmin=np.zeros(1), qmax=np.ones(1),
                          msize=np.ones(2), k=1)
    assert FaceCheckpointer(mapped, red, np.ones(2), 1e-3).enabled
    assert not FaceCheckpointer(port, red, np.ones(2), 1e-3).enabled
    assert (mapped.fault_sites, mapped.fault_seed) == ("pdhg_nan:0.5", 7)
    # device pricing and the batched LP engine are ported: forced on, on
    forced = port.replace(decomp_device_pricing=True, lp_batch=True)
    assert device_pricing_enabled(forced, cpu) and lp_batch_enabled(forced, cpu)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_polish_screen_plan_at_the_flagship_shape():
    """The polish screen's launch at the flagship: three prefix lanes of a
    2048-column support (``batch_lp._bucket_dim``) over T=814 types pass the
    fit gate with no miss, split the card's 132 blocks into three groups of
    44 (only the real lanes launch; the JAX package pads to four), and
    keep each block's pack share resident."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers.batch_lp import _bucket_dim
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    red = TypeReduction(featurize(sf_e_skewed_instance(seed=1), device="cpu")[0])
    rng = np.random.default_rng(0)
    comps = np.zeros((2048, red.T))
    for c in range(2048):
        np.add.at(comps[c], red.type_id[rng.choice(red.n, size=red.k, replace=False)], 1.0)
    pack = TEll.from_rows((comps / red.msize[None, :]).astype(np.float32), minor=red.T)
    Cp = _bucket_dim(len(pack), tconfig.default_config().lp_batch_bucket_max)
    assert (red.T, Cp) == (814, 2048)
    log = RunLog(echo=False)
    cfg = tconfig.default_config().replace(pdhg_megakernel=True)
    assert tmk.megakernel_mode(cfg, red.T, Cp, "cpu", log=log, lanes=3) == "fused"
    assert "megakernel_fit_miss" not in log.counters
    idx, val = pack.padded(Cp)
    _perm, rowptr, _colT = tmk.csr_transpose(idx, val, red.T)
    plan = tmk.launch_plan(3, red.T, Cp, tmk.H100_SMS, rowptr, kp=idx.shape[1])
    assert plan.lanes == 3 and plan.blocks_per_lane == 44 and plan.grid == tmk.H100_SMS
    assert plan.tile_floats > 0
    assert tmk.two_sided_smem_bytes(red.T, Cp, plan.tile_floats) <= tmk.LAYOUT["kMaxSmem"]
