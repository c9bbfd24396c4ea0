"""The ELL operator layer: the port against the JAX package.

The same packed matrices, made from numpy seeds, go through both packages:
packing and the ``EllPack`` append/take/padded contract must agree exactly,
the matvecs within float32 summation noise (atol 1e-6), and the port's
plain gather (the CPU route of the CUDA gather kernel) within 1e-6 of the
JAX package's Pallas gather kernel run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citizensassemblies_tpu.kernels.ell_matvec import ell_gather_mv_pallas
from citizensassemblies_tpu.solvers import sparse_ops as jso

from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.kernels import ell_matvec as tem
from citizensassemblies_tpu_torch.solvers import sparse_ops as tso

ATOL = 1e-6


def _rows(seed, J, minor, p=0.1):
    """A sparse ``[J, minor]`` matrix with entries of the master's size
    (type counts over msize, a few tenths), so a row's sum stays O(1) and
    float32 summation noise stays below the 1e-6 bar."""
    r = np.random.default_rng(seed)
    return ((r.random((J, minor)) < p) * 0.1 * r.normal(size=(J, minor))).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(300, 90, 0.1), (64, 814, 0.02), (17, 5, 0.6)])
def test_pack_rows_round_trip_matches(shape):
    J, minor, p = shape
    M = _rows(1, J, minor, p)
    ji, jv, jn = jso.ell_pack_rows(M)
    ti, tv, tn = tso.ell_pack_rows(M)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(tso.ell_unpack_rows(ti, tv, minor), M.astype(np.float64))
    with pytest.raises(ValueError):
        tso.ell_pack_rows(M, k_pad=max(1, int(tn.max()) - 1))


def test_ellpack_append_take_padded_matches():
    minor = 60
    batches = [_rows(2, 40, minor, 0.05), _rows(3, 25, minor, 0.3), _rows(4, 10, minor, 0.1)]
    jp, tp = jso.EllPack(minor=minor), tso.EllPack(minor=minor)
    for rows in batches:
        jp.append(rows)
        tp.append(rows)
        np.testing.assert_array_equal(jp.idx, tp.idx)
        np.testing.assert_array_equal(jp.val, tp.val)
        assert (len(jp), jp.k_pad, jp.nnz_total, jp.pack_rows) == (
            len(tp), tp.k_pad, tp.nnz_total, tp.pack_rows
        )
        assert jp.fill == tp.fill
    # the slot bucket grew across appends, and the first rows kept their values
    dense = np.concatenate(batches)
    np.testing.assert_array_equal(tso.ell_unpack_rows(tp.idx, tp.val, minor), dense.astype(np.float64))
    sel = np.random.default_rng(5).permutation(len(tp))[:31]
    jt, tt = jp.take(sel), tp.take(sel)
    np.testing.assert_array_equal(jt.idx, tt.idx)
    np.testing.assert_array_equal(jt.val, tt.val)
    assert jt.nnz_total == tt.nnz_total
    for n in (len(tt), 2048):
        for a, b in zip(jt.padded(n), tt.padded(n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tt.padded(len(tt) - 1)
    back = interop.ellpack_from_arrays(jt.idx, jt.val, minor)
    np.testing.assert_array_equal(back.idx, tt.idx)
    assert back.nnz_total == tt.nnz_total and back.k_pad == tt.k_pad


def test_gather_and_scatter_match():
    minor = 90
    M = _rows(9, 300, minor)
    idx, val, _ = jso.ell_pack_rows(M)
    r = np.random.default_rng(10)
    y = r.normal(size=minor).astype(np.float32)
    x = r.normal(size=300).astype(np.float32)
    got = tso.ell_gather_mv(_t(idx), _t(val), _t(y)).numpy()
    want = np.asarray(jso.ell_gather_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got = tso.ell_scatter_mv(_t(idx), _t(val), _t(x), minor).numpy()
    want = np.asarray(jso.ell_scatter_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), minor))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_batched_gather_and_scatter_match():
    """The lane-batched forms the two-sided prelude uses: ``y [B, minor]``
    against a shared pack, and a per-lane ``val [B, C, k_pad]``."""
    minor, B = 70, 3
    M = _rows(11, 128, minor, 0.15)
    idx, val, _ = jso.ell_pack_rows(M)
    r = np.random.default_rng(12)
    Y = r.normal(size=(B, minor)).astype(np.float32)
    X = r.normal(size=(B, 128)).astype(np.float32)
    scale = r.random((B, 1, 1)).astype(np.float32)
    got = tso.ell_gather_mv(_t(idx), _t(val), _t(Y)).numpy()
    want = np.asarray(jso.batched_ell_gather_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(Y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got = tso.ell_scatter_mv(_t(idx), _t(val), _t(X), minor).numpy()
    want = np.asarray(
        jso.batched_ell_scatter_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(X), minor)
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    vb = val[None] * scale
    got = tso.ell_gather_mv(_t(idx), _t(vb), _t(Y)).numpy()
    got_s = tso.ell_scatter_mv(_t(idx), _t(vb), _t(X), minor).numpy()
    for b in range(B):
        want = np.asarray(jso.ell_gather_mv(jnp.asarray(idx), jnp.asarray(vb[b]), jnp.asarray(Y[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=ATOL)
        want = np.asarray(jso.ell_scatter_mv(jnp.asarray(idx), jnp.asarray(vb[b]), jnp.asarray(X[b]), minor))
        np.testing.assert_allclose(got_s[b], want, rtol=0, atol=ATOL)


def test_row_absmax_and_ruiz_match():
    minor = 50
    M = _rows(13, 200, minor, 0.2)
    M[:, 7] = 0.0  # a minor no slot hits keeps max 0 and scale 1
    idx, val, _ = jso.ell_pack_rows(M)
    got = tso.ell_row_absmax(_t(idx), _t(val), minor).numpy()
    want = np.asarray(jso.ell_row_absmax(jnp.asarray(idx), jnp.asarray(val), minor))
    np.testing.assert_array_equal(got, want)
    dj, di = tso.ell_ruiz_equilibrate(_t(idx), _t(val), minor)
    ej, ei = jso.ell_ruiz_equilibrate(jnp.asarray(idx), jnp.asarray(val), minor)
    np.testing.assert_allclose(dj.numpy(), np.asarray(ej), rtol=1e-6, atol=0)
    np.testing.assert_allclose(di.numpy(), np.asarray(ei), rtol=1e-6, atol=0)
    assert di[7].item() == 1.0


@pytest.mark.parametrize("shape", [(300, 90), (6144 // 8, 814)])
def test_plain_gather_matches_pallas_interpret(shape):
    """The gather kernel's plain version against the Pallas kernel it
    replaces, run in interpret mode."""
    C, minor = shape
    M = _rows(14, C, minor, 0.1 if minor < 200 else 0.03)
    idx, val, _ = jso.ell_pack_rows(M)
    y = np.random.default_rng(15).normal(size=minor).astype(np.float32)
    want = np.asarray(ell_gather_mv_pallas(idx, val, y, interpret=True))
    got = tem.ell_gather_mv_plain(_t(idx), _t(val), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the wrapper takes the plain version for a CPU tensor, and counts no launch
    before = tem.KERNEL.launches
    np.testing.assert_array_equal(tem.ell_gather_mv(_t(idx), _t(val), _t(y)).numpy(), got)
    assert tem.KERNEL.launches == before


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_gather_matches_pallas_interpret_at_a_nationwide_minor(bf16):
    """A pack of the nationwide dual LP's width (256 rows of 320 slots, up
    to 317 of them live) over a ``y`` of 100,001 minors, which the kernel
    reads from the L2: the kernel's plain version against the Pallas
    kernel it replaces (interpret mode) and the JAX package's XLA gather,
    with float32 values and with values bf16 holds (the JAX side takes
    them widened to float32). The values are scaled so a row's sum spreads
    as :func:`_rows`' rows of a few dozen entries do (about 0.5), which
    keeps float32 summation noise under the 1e-6 bar."""
    C, kp, T = 256, 320, 100_001
    r = np.random.default_rng(22)
    idx = np.zeros((C, kp), np.int32)
    val = np.zeros((C, kp), np.float32)
    for c in range(C):
        live = int(r.integers(kp - 40, kp - 2))
        idx[c, :live] = np.sort(r.choice(T, size=live, replace=False))
        val[c, :live] = 0.03 * r.normal(size=live)
    y = r.normal(size=T).astype(np.float32)
    vt = _t(val)
    if bf16:
        vt = vt.to(torch.bfloat16)
        val = vt.float().numpy()
    assert not tem.launch_plan(C, kp, T, 1, 132, bf16=bf16).stage_y
    got = tem.ell_gather_mv_plain(_t(idx), vt, _t(y)).numpy()
    want = np.asarray(ell_gather_mv_pallas(idx, val, y, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want = np.asarray(jso.ell_gather_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tem.ell_gather_mv(_t(idx), vt, _t(y)).numpy(), got)


def test_batched_plain_gather_matches_pallas_interpret():
    """The batched shape the two-sided prelude gathers at: a per-lane
    ``[3, C, k_pad]`` value pack with ``y [3, T]``, through the kernel's
    plain version, against the Pallas kernel (which takes one lane) run in
    interpret mode lane by lane, within 1e-6 of the lane's largest entry.
    The kernel's plan at the path's shapes gives every lane one block per
    SM, within the thread cap."""
    C, minor, B = 6144 // 8, 814, 3
    M = _rows(17, C, minor, 0.03)
    idx, val, _ = jso.ell_pack_rows(M)
    r = np.random.default_rng(18)
    vb = (val[None] * r.random((B, 1, 1))).astype(np.float32)
    Y = r.normal(size=(B, minor)).astype(np.float32)
    got = tem.ell_gather_mv_plain(_t(idx), _t(vb), _t(Y)).numpy()
    assert got.shape == (B, C)
    for b in range(B):
        want = np.asarray(ell_gather_mv_pallas(idx, vb[b], Y[b], interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the wrapper takes the plain version for CPU tensors, bit for bit
    np.testing.assert_array_equal(tem.ell_gather_mv(_t(idx), _t(vb), _t(Y)).numpy(), got)
    for cols, T, lanes in ((6144, 814, 1), (4096, 1727, 1), (6144, 814, 3)):
        for sms in (132, 114):
            plan = tem.launch_plan(cols, 112, T, lanes, sms)
            assert plan.G == 4 and (112 // 4) % plan.G == 0
            assert plan.threads % 32 == 0 and plan.threads <= tem.MAX_THREADS
            # every lane has one block per SM at these shapes: a whole
            # number of blocks for every SM, each within the thread cap
            assert plan.blocks == sms and plan.blocks_per_sm == lanes
            assert plan.threads >= -(-cols // plan.blocks) * plan.G


#: (C, k_pad, T) of the gather's path shapes (the flagship master, XMIN's
#: portfolio, the flagship and sf_b dual LPs), the lint registration's,
#: packs with fewer columns than SMs, ranges of 9 and 8 columns (at G = 4 a
#: block of 8 leaves its last warp without a column), and the nationwide
#: dual LP's, whose y takes the L2 route
PLAN_SHAPES = [
    (6144, 112, 814), (15313, 112, 1727), (4096, 112, 1728), (1024, 24, 251),
    (256, 16, 128), (100, 16, 128), (7, 8, 50), (132 * 8 + 50, 16, 128), (2048, 320, 100_001),
]


def _stages_of(plan, block):
    """``[(c0, n), ...]``: the columns of each ring stage of a lane's block
    ``block``: the kernel's last ``tma_warps`` warps, ``32 / G`` columns
    each, none past the range."""
    c0, n = plan.range_of(block)
    sc = 32 // plan.G
    first = plan.threads // 32 - plan.tma_warps
    return [(c0 + w * sc, min(sc, n - w * sc)) for w in range(first, plan.threads // 32)
            if w * sc < n]


def _lane_rule(kp, bf16):
    G = next(g for g in (8, 4, 2, 1) if (kp // 4) % g == 0)
    return max(G // 2, 1) if bf16 else G


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_gather_launch_plan_owns_every_pair_once(shape, sms, bf16, lanes):
    """The gather kernel's plan: every (lane, column) pair in exactly one
    block, no block empty, a lane's column ranges within one column of each
    other, a whole number of blocks for every SM (fewer only where a lane
    has fewer columns); the ring's stages the block's last warps' columns,
    each span of indices and of values (shared or per lane) starting on a
    16-byte boundary and a multiple of 16 bytes long; the mbarriers, the
    ring and a staged ``y`` (where it fits beside one stage) within 227 KB
    and within a block's share of the SM;
    ``G`` by the lane rule (halved for bf16); threads for the longest
    range, ``G`` a column."""
    C, kp, T = shape
    lane_values = lanes > 1
    plan = tem.launch_plan(C, kp, T, lanes, sms, bf16=bf16)
    assert plan.G == _lane_rule(kp, bf16)
    assert plan.threads % 32 == 0 and plan.threads <= tem.MAX_THREADS
    if plan.blocks < C:
        assert 0 <= plan.blocks * lanes - plan.blocks_per_sm * sms < lanes
    else:
        assert plan.blocks == C
    es = 2 if bf16 else 4
    sc = 32 // plan.G  # a warp's columns
    warps = plan.threads // 32
    assert 1 <= plan.tma_warps <= min(warps, tem.TMA_WARPS)
    assert plan.stage_bytes == sc * kp * (4 + es)
    assert plan.stage_y == (tem.smem_bytes(T, kp, plan.G, bf16, 1) <= tem.BLOCK_SMEM)
    assert plan.smem_bytes == tem.smem_bytes(
        T, kp, plan.G, bf16, plan.tma_warps, plan.stage_y) <= tem.BLOCK_SMEM
    per_sm = -(-plan.blocks * lanes // sms)
    room = tem.SM_SMEM // per_sm - tem.BLOCK_RESERVED_SMEM
    if plan.tma_warps < min(warps, tem.TMA_WARPS):  # cut to fit the SM's share
        assert tem.smem_bytes(T, kp, plan.G, bf16, plan.tma_warps + 1, plan.stage_y) > room
    if plan.tma_warps > 1:
        assert plan.smem_bytes <= room
    owned = np.zeros((lanes, C), np.int64)
    staged = np.zeros(C, np.int64)
    sizes = []
    for blk in range(plan.blocks):
        c0, n = plan.range_of(blk)
        assert n >= 1 and n * plan.G <= plan.threads
        sizes.append(n)
        owned[:, c0:c0 + n] += 1
        stages = _stages_of(plan, blk)
        assert len(stages) <= plan.tma_warps
        # the stages are the last warps' columns: the range's tail, in order
        # (a range one column short may leave the last warp without one)
        assert not stages or stages[-1][0] + stages[-1][1] == c0 + n
        for (s0, m), nxt in zip(stages, stages[1:] + [(c0 + n, 0)]):
            assert 1 <= m <= sc and s0 + m == nxt[0] and (s0 - c0) % sc == 0
            staged[s0:s0 + m] += 1
            assert (s0 * kp * 4) % 16 == 0 and (m * kp * 4) % 16 == 0
            assert m * kp * (4 + es) <= plan.stage_bytes
            for b in range(lanes):
                assert (((b * C if lane_values else 0) + s0) * kp * es) % 16 == 0
                assert (m * kp * es) % 16 == 0
    np.testing.assert_array_equal(owned, 1)
    assert staged.max() <= 1
    assert max(sizes) - min(sizes) <= 1
    vec = 8 if bf16 else 4  # slots of a 16-byte vector
    vecs = tem.PREFETCH_BYTES // (vec * (4 + es))
    assert vecs == (4 if bf16 else 6)
    load_cols = max(0, min(max(sizes), (warps - plan.tma_warps) * sc))
    assert plan.prefetch_bytes == load_cols * min(vecs * plan.G * vec, kp) * (4 + es)


@pytest.mark.parametrize("warps,tma", [(1, 1), (2, 2), (3, 3), (4, 3), (5, 3), (6, 3), (8, 3)])
def test_gather_tma_warp_rule(warps, tma):
    """Three of a block's warps take their spans by TMA, all of a smaller
    block: blocks of ``warps`` warps (8 columns a warp at k_pad 16)."""
    plan = tem.launch_plan(132 * 8 * warps, 16, 128, 1, 132)
    assert plan.threads == 32 * warps and plan.tma_warps == tma


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lanes", [1, 3])
def test_plan_walk_matches_plain_gather_bit_for_bit(lanes, bf16):
    """A plain walk of the plan, lane by lane, block by block and, in each
    block, warp by warp (the load warps' columns, then each ring stage's),
    with the plain version, equals the unchunked plain version bit for
    bit: the plan drops and repeats no column. 301 columns on four SMs make
    uneven ranges, and a ring of two stages the last of which is short.
    The same holds on the L2 route, over a ``y`` of 60,000 minors (above
    every staged limit at k_pad 24), whose plan keeps the staged plan's
    ranges and stages."""
    C = 301
    r = np.random.default_rng(20)
    staged = None
    for T, p in ((90, 0.1), (60_000, 10 / 60_000)):
        M = _rows(19, C, T, p)
        idx, val, _ = jso.ell_pack_rows(M, k_pad=24)
        Y = torch.as_tensor(r.normal(size=(lanes, T)).astype(np.float32))
        vals = torch.as_tensor((val[None] * r.random((lanes, 1, 1))).astype(np.float32))
        if bf16:
            vals = vals.to(torch.bfloat16)
        lane_values = lanes > 1
        V = vals if lane_values else vals[0]
        want = tem.ell_gather_mv_plain(_t(idx), V, Y)
        plan = tem.launch_plan(C, 24, T, lanes, 4, bf16=bf16)
        assert plan.stage_y == (T == 90)
        if staged is None:
            staged = plan
        assert [_stages_of(plan, blk) for blk in range(plan.blocks)] == [
            _stages_of(staged, blk) for blk in range(staged.blocks)]
        assert len({plan.range_of(blk)[1] for blk in range(plan.blocks)}) == 2
        assert any(len(_stages_of(plan, blk)) >= 2 for blk in range(plan.blocks))
        got = torch.full((lanes, C), float("nan"))
        I = _t(idx)
        for b in range(lanes):
            for blk in range(plan.blocks):
                c0, n = plan.range_of(blk)
                stages = _stages_of(plan, blk)
                for s0, m in [(c0, stages[0][0] - c0)] + stages:
                    v = V[b, s0:s0 + m] if lane_values else V[s0:s0 + m]
                    got[b, s0:s0 + m] = tem.ell_gather_mv_plain(I[s0:s0 + m], v, Y[b])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_plan_raises_where_y_does_not_fit():
    """A ``y`` too long to fit a block's shared memory beside one ring
    stage takes the L2 route (``stage_y`` False, no ``y`` in shared memory)
    and raises only where the staged route is forced; blocks per SM that
    leave a block more threads than the kernel takes, or more TMA warps
    than a block has, raise before any launch."""
    for T in (60_000, 58_000):
        plan = tem.launch_plan(64, 16, T, 1, 132)
        assert not plan.stage_y and plan.tma_warps >= 1
        assert plan.smem_bytes == tem.smem_bytes(T, 16, plan.G, False, plan.tma_warps, False)
        assert plan.smem_bytes == tem.smem_bytes(128, 16, plan.G, False, plan.tma_warps, False)
        with pytest.raises(ValueError, match="cannot hold y"):
            tem.launch_plan(64, 16, T, 1, 132, stage_y=True)
    # y alone fits at 58,000 floats, but not beside a stage of 8 columns
    assert tem.smem_bytes(58_000) <= tem.BLOCK_SMEM
    staged = tem.launch_plan(64, 16, 57_500, 1, 132)
    assert staged.stage_y and staged.tma_warps == 1
    # the L2 route, forced where y fits, frees y's room for the ring
    l2 = tem.launch_plan(64, 16, 57_500, 1, 132, stage_y=False)
    assert not l2.stage_y and l2.tma_warps == min(l2.threads // 32, tem.TMA_WARPS)
    assert (l2.blocks, l2.threads, l2.G) == (staged.blocks, staged.threads, staged.G)
    with pytest.raises(ValueError, match="blocks an SM"):
        tem.launch_plan(15313, 112, 1727, 1, 132, blocks_per_sm=1)
    with pytest.raises(ValueError, match="TMA"):
        tem.launch_plan(6144, 112, 814, 1, 132, tma_warps=7)


#: (k_pad, bf16) → the largest ``T`` whose ``y`` the kernel stages beside one
#: ring stage at C=4,096, one lane, 132 SMs
STAGED_LIMIT = {
    (24, False): 57_336, (24, True): 56_952, (112, False): 56_312, (112, True): 55_416,
    (320, False): 55_544, (320, True): 54_264,
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kp", [24, 112, 320])
def test_gather_plan_routes_y_through_l2_above_the_staged_limit(kp, bf16):
    """The plan stages ``y`` exactly where ``y`` and one ring stage fit a
    block's shared memory and takes the L2 route one float above; at a
    nationwide registry's 100,001 minors and at 1,000,001 it plans the L2
    route with shared memory that does not depend on ``T``; the staged
    route forced above the limit raises; the L2 route keeps the staged
    plan's ranges, threads and lanes a column."""
    limit = STAGED_LIMIT[(kp, bf16)]
    C, sms = 4096, 132
    below = tem.launch_plan(C, kp, limit, 1, sms, bf16=bf16)
    assert below.stage_y and below.smem_bytes <= tem.BLOCK_SMEM
    assert tem.smem_bytes(limit + 1, kp, below.G, bf16, 1) > tem.BLOCK_SMEM
    above = tem.launch_plan(C, kp, limit + 1, 1, sms, bf16=bf16)
    assert not above.stage_y
    far = [tem.launch_plan(C, kp, T, 1, sms, bf16=bf16) for T in (100_001, 1_000_001)]
    for plan in [above] + far:
        assert not plan.stage_y
        assert plan.smem_bytes == above.smem_bytes <= tem.BLOCK_SMEM
        assert plan.smem_bytes == tem.smem_bytes(1, kp, plan.G, bf16, plan.tma_warps, False)
        assert (plan.blocks, plan.threads, plan.G) == (below.blocks, below.threads, below.G)
        assert plan.tma_warps == min(plan.threads // 32, tem.TMA_WARPS)
    for T in (limit + 1, 100_001):
        with pytest.raises(ValueError, match="cannot hold y"):
            tem.launch_plan(C, kp, T, 1, sms, bf16=bf16, stage_y=True)


def test_padding_slots_carry_nan_from_row_zero():
    """Padding slots index row 0 with value 0: a NaN at ``y[0]`` reaches
    every column with a padding slot, in the port as in the reference."""
    M = _rows(16, 40, 30, 0.1)
    idx, val, nnz = jso.ell_pack_rows(M)
    y = np.ones(30, np.float32)
    y[0] = np.nan
    got = tso.ell_gather_mv(_t(idx), _t(val), _t(y)).numpy()
    want = np.asarray(jso.ell_gather_mv(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    padded = nnz < idx.shape[1]
    assert padded.any() and np.isnan(got[padded]).all()


def test_wrapper_passes_the_route_and_counts_l2_launches_apart(monkeypatch):
    """The wrapper hands the kernel its plan's route (``stage_y``, the
    argument before the stream) and counts an L2-route launch under its
    entry point's ``.l2`` key, float32 and bf16 alike, and in all. Run on
    CPU tensors with the C call, the SM count and the stream stood in
    for, so the launch arguments are what the card would get."""
    calls = []
    monkeypatch.setattr(tem.CudaLibrary, "run", lambda self, fname, *a: calls.append((fname, a)) or 0)
    monkeypatch.setattr(tem, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tem, "_READY", {0})
    monkeypatch.setattr(tem, "stream_of", lambda t: None)
    monkeypatch.setattr(tem.KERNEL, "launches", 0)
    monkeypatch.setattr(tem.KERNEL, "entry_launches", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    r = np.random.default_rng(23)
    C, kp = 64, 320
    idx = _t(np.sort(r.integers(0, 814, size=(C, kp)), axis=1).astype(np.int32))
    val = _t(r.random((C, kp)).astype(np.float32))
    for T in (814, 100_001, 60_000):
        for v in (val, val.to(torch.bfloat16)):
            y = torch.zeros(T)
            tem.ell_gather_mv_cuda(idx, v, y)
            plan = tem.launch_plan(C, kp, T, 1, 132, bf16=v.dtype == torch.bfloat16)
            fname, args = calls[-1]
            assert fname == ("ell_gather_bf16_launch" if plan.bf16 else "ell_gather_launch")
            assert args[5:14] == (1, T, C, kp, plan.G, plan.threads, plan.blocks, plan.tma_warps,
                                  int(plan.stage_y))
            assert plan.stage_y == (T == 814)
    assert tem.KERNEL.launches == 6
    assert tem.KERNEL.entry_launches == {
        "ell_gather_launch": 1, "ell_gather_bf16_launch": 1,
        "ell_gather_launch.l2": 2, "ell_gather_bf16_launch.l2": 2,
    }
