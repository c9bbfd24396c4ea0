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


#: the bench families ported with the analysis layer, each built by both
#: packages' generators from its default seed
FAMILIES = {
    "cca": lambda g: g.cca_skewed_instance(),
    "obf": lambda g: g.obf_skewed_instance(),
    "hd": lambda g: g.hd_skewed_instance(),
    "nexus": lambda g: g.nexus_skewed_instance(),
    "sf_a": lambda g: g.sf_a_skewed_instance(),
    "sf_c": lambda g: g.sf_c_skewed_instance(),
    "sf_e_like": lambda g: g.sf_e_like_instance(),
    "sf_e_schema": lambda g: g.sf_e_schema_instance(),
    "sf_e_schema_small": lambda g: g.sf_e_schema_instance(n=120, k=24),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generator_family_matches(name):
    j, t = FAMILIES[name](jgen), FAMILIES[name](tgen)
    assert (t.k, t.name, t.columns_data) == (j.k, j.name, j.columns_data)
    # dict equality ignores order; the feature axis is built in file order
    assert list(t.categories) == list(j.categories)
    assert [list(f.items()) for f in t.categories.values()] == [
        list(f.items()) for f in j.categories.values()
    ]
    assert t.agents == j.agents


@pytest.mark.parametrize("name", ["example_small_like", "sf_e_skewed_seed1"])
def test_write_read_instance_round_trip(name, tmp_path):
    """``write_instance_csvs`` → ``read_instance_dir`` keeps the order of
    categories, features and agents, so the featurized pool is the one in
    memory; the port writes the JAX package's bytes."""
    from citizensassemblies_tpu_torch.core.instance import read_instance_dir

    inst = INSTANCES[name](tgen)
    d = tmp_path / "port" / f"{name}_{inst.k}"
    tgen.write_instance_csvs(inst, d)
    jgen.write_instance_csvs(INSTANCES[name](jgen), tmp_path / "jax")
    for f in ("categories.csv", "respondents.csv"):
        assert (d / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    back = read_instance_dir(d)
    assert (back.k, back.name) == (inst.k, d.name)
    assert list(back.categories) == list(inst.categories)
    assert [list(f.items()) for f in back.categories.values()] == [
        list(f.items()) for f in inst.categories.values()
    ]
    assert back.agents == inst.agents
    a, _ = t_featurize(inst, device="cpu")
    b, _ = t_featurize(back, device="cpu")
    assert a.host == b.host
    np.testing.assert_array_equal(a.cat_of_feature_np, b.cat_of_feature_np)
    with pytest.raises(ValueError, match="panel size"):
        read_instance_dir(tmp_path / "port")


@pytest.mark.parametrize("quotas,k,raises", [
    ({"g": {"a": (1, 3), "b": (1, 3)}}, 4, None),
    ({"g": {"a": (3, 3), "b": (2, 3)}}, 4, "lower quotas"),
    ({"g": {"a": (0, 1), "b": (0, 2)}, "h": {"x": (0, 4)}}, 4, "upper quotas"),
])
def test_validate_quotas_matches(quotas, k, raises):
    from citizensassemblies_tpu.core.instance import Instance as JInstance
    from citizensassemblies_tpu.core.instance import SelectionError as JSelectionError
    from citizensassemblies_tpu.core.instance import validate_quotas as j_validate

    from citizensassemblies_tpu_torch.core.instance import Instance as TInstance
    from citizensassemblies_tpu_torch.core.instance import SelectionError as TSelectionError
    from citizensassemblies_tpu_torch.core.instance import validate_quotas as t_validate

    agents = [{c: next(iter(f)) for c, f in quotas.items()}] * 6
    if raises is None:
        j_validate(JInstance(k=k, categories=quotas, agents=agents))
        t_validate(TInstance(k=k, categories=quotas, agents=agents))
        return
    with pytest.raises(JSelectionError, match=raises) as j_exc:
        j_validate(JInstance(k=k, categories=quotas, agents=agents))
    with pytest.raises(TSelectionError, match=raises) as t_exc:
        t_validate(TInstance(k=k, categories=quotas, agents=agents))
    assert str(t_exc.value) == str(j_exc.value)


def test_panels_matrix_round_trip_matches():
    from citizensassemblies_tpu.core.instance import matrix_to_panels as j_m2p
    from citizensassemblies_tpu.core.instance import panels_to_matrix as j_p2m

    from citizensassemblies_tpu_torch.core.instance import matrix_to_panels as t_m2p
    from citizensassemblies_tpu_torch.core.instance import panels_to_matrix as t_p2m

    rng = np.random.default_rng(8)
    panels = [tuple(sorted(rng.choice(50, 7, replace=False).tolist())) for _ in range(30)]
    P = t_p2m(panels, 50)
    np.testing.assert_array_equal(P, j_p2m(panels, 50))
    assert P.dtype == bool and P.shape == (30, 50)
    assert t_m2p(P) == j_m2p(P) == panels
