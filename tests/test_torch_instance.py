"""Instances and the host solver layer: the port against the JAX package.

``featurize`` and ``TypeReduction`` must agree exactly, the native oracle
and slicers must return the same answers, and ``robust_linprog`` the same
results, on the same instances built by both packages' generators.
"""

import time

import numpy as np
import pytest

import citizensassemblies_tpu.core.generator as jgen
import citizensassemblies_tpu.solvers.native_oracle as jno
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.solvers import lp_util as jlp

import citizensassemblies_tpu_torch.core.generator as tgen
import citizensassemblies_tpu_torch.solvers.native_oracle as tno
from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.solvers import lp_util as tlp

INSTANCES = {
    "example_small_like": lambda g: g.example_small_like_instance(),
    "skewed_160": lambda g: g.skewed_instance(n=160, k=14, n_categories=4, seed=2),
    "sf_e_skewed_seed1": lambda g: g.sf_e_skewed_instance(seed=1),
}

_cache = {}


def _pair(name):
    """(JAX dense, port dense, JAX reduction, port reduction) for ``name``."""
    if name not in _cache:
        jd, _ = j_featurize(INSTANCES[name](jgen))
        td, _ = t_featurize(INSTANCES[name](tgen), device="cpu")
        _cache[name] = (jd, td, jno.TypeReduction(jd), tno.TypeReduction(td))
    return _cache[name]


def _jax_natives():
    """Load the JAX package's native libraries, retrying a load that lost a
    compile race with another test process (its loader writes the library
    in place)."""
    for _ in range(10):
        if jno._load() and jno._load_repair() and jno._load_slicer():
            return
        jno._lib_failed = jno._repair_failed = jno._slicer_failed = False
        time.sleep(0.5)
    pytest.fail("the JAX package's native libraries did not load")


@pytest.mark.parametrize("name", list(INSTANCES))
def test_featurize_matches(name):
    jd, td, _, _ = _pair(name)
    np.testing.assert_array_equal(np.asarray(jd.A_np), td.A_np)
    np.testing.assert_array_equal(np.asarray(jd.qmin_np), td.qmin_np)
    np.testing.assert_array_equal(np.asarray(jd.qmax_np), td.qmax_np)
    np.testing.assert_array_equal(np.asarray(jd.cat_of_feature), td.cat_of_feature_np)
    assert (jd.k, jd.n_categories) == (td.k, td.n_categories)
    assert td.A.device.type == "cpu" and td.A.shape == td.A_np.shape


@pytest.mark.parametrize("name", list(INSTANCES))
def test_type_reduction_matches(name):
    _, _, jr, tr = _pair(name)
    assert (jr.T, jr.F, jr.n, jr.k) == (tr.T, tr.F, tr.n, tr.k)
    for field in ("type_id", "msize", "type_feature", "qmin", "qmax"):
        np.testing.assert_array_equal(getattr(jr, field), getattr(tr, field), err_msg=field)
    if name == "sf_e_skewed_seed1":
        assert tr.T == 814 and tr.F == 26 and int(tr.msize.max()) == 21


def test_dense_from_arrays_round_trip():
    jd, td, _, _ = _pair("skewed_160")
    back = interop.dense_from_arrays(
        jd.A_np, jd.qmin_np, jd.qmax_np, np.asarray(jd.cat_of_feature), jd.k,
        jd.n_categories, device="cpu",
    )
    assert back.host == td.host
    np.testing.assert_array_equal(back.cat_of_feature_np, td.cat_of_feature_np)


# exact pricing from scratch at the flagship size is a long branch and bound
# (the solver reaches it with an incumbent); the small pools keep it quick
@pytest.mark.parametrize("name", ["example_small_like", "skewed_160"])
def test_price_exact_matches(name):
    _jax_natives()
    jd, _, jr, tr = _pair(name)
    rng = np.random.default_rng(4)
    for _ in range(3):
        w = rng.random(jd.n)
        a = jno.price_exact(jr, w)
        b = tno.price_exact(tr, w)
        assert a is not None and b is not None
        assert a[0] == b[0]
        assert a[1] == b[1]


@pytest.mark.parametrize("name", ["skewed_160", "sf_e_skewed_seed1"])
def test_slice_stream_matches(name):
    _jax_natives()
    _, _, jr, tr = _pair(name)
    rng = np.random.default_rng(5)
    x = rng.dirichlet(np.ones(tr.T)) * tr.k
    x = np.minimum(x, tr.msize)
    for j0, chunks in ((0, 1), (1 << 20, 4)):
        a = jno.slice_stream_native(jr, x, R=64, max_passes=3 * tr.F, j0=j0, chunks=chunks)
        b = tno.slice_stream_native(tr, x, R=64, max_passes=3 * tr.F, j0=j0, chunks=chunks)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b)


def test_repair_and_greedy_decompose_match():
    _jax_natives()
    _, _, jr, tr = _pair("skewed_160")
    rng = np.random.default_rng(6)
    x = np.minimum(rng.dirichlet(np.ones(tr.T)) * tr.k, tr.msize)
    c0 = np.minimum(np.floor(x).astype(np.int64), tr.msize)
    tf = np.zeros((tr.T, tr.F), np.int64)
    tf[np.repeat(np.arange(tr.T), tr.type_feature.shape[1]), tr.type_feature.ravel()] = 1
    need = x - c0
    outs = []
    for mod, red in ((jno, jr), (tno, tr)):
        c = c0.astype(np.int32).copy()
        counts = (c.astype(np.int64) @ tf).astype(np.int32)
        ok = mod.repair_slice_native(red, c, counts, need.copy(), 3, 3 * tr.F)
        outs.append((ok, c, counts))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])

    comps = tno.slice_stream_native(tr, x, R=32, max_passes=3 * tr.F)
    probs = np.full(len(comps), 1.0 / len(comps))
    per_type_need = (probs @ comps) / tr.msize
    a = jno.greedy_decompose_native(jr, comps, probs, per_type_need, max_panels=512)
    b = tno.greedy_decompose_native(tr, comps, probs, per_type_need, max_panels=512)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_robust_linprog_matches():
    rng = np.random.default_rng(7)
    for _ in range(3):
        n, m = 12, 8
        A = rng.random((m, n))
        b = A @ rng.random(n) + 0.1
        c = -rng.random(n)
        kw = dict(A_ub=A, b_ub=b, A_eq=np.ones((1, n)), b_eq=[3.0], bounds=[(0, 1)] * n)
        a = jlp.robust_linprog(c, **kw)
        t = tlp.robust_linprog(c, **kw)
        assert a.status == t.status == 0
        np.testing.assert_array_equal(a.x, t.x)
        assert a.fun == t.fun
