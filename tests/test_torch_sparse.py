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


def test_batched_plain_gather_matches_pallas_interpret():
    """The batched shape the two-sided prelude gathers at: a per-lane
    ``[3, C, k_pad]`` value pack with ``y [3, T]``, through the kernel's
    plain version, against the Pallas kernel (which takes one lane) run in
    interpret mode lane by lane, within 1e-6 of the lane's largest entry.
    The kernel's launch shape at the path's shapes covers every SM with
    16-byte loads and no idle lane."""
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
    for cols, lanes in ((6144, 1), (4096, 1), (6144, 3)):
        for sms in (132, 114):
            G, threads, blocks = tem.launch_shape(cols, 112, lanes, sms)
            assert G == 4 and (112 // 4) % G == 0
            assert threads % 32 == 0 and threads <= 32 * tem.MAX_WARPS
            assert blocks >= sms and blocks * threads >= cols * G * lanes


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
