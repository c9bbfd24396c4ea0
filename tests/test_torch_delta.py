"""The port's registry churn and delta re-certification against the JAX package's.

The cases of ``tests/test_delta.py`` that do not start the service, run
through both packages on the same seeded registries on the CPU:

* registries and churn trails equal to the JAX package's exactly (every
  array of every intermediate registry, every edit's fields);
* the type-system projection after a trail equal to a rebuild, and to the
  JAX package's;
* ``delta.screen_columns`` (the torch screen on the CPU): its feasibility
  mask equal to the JAX package's, its price gaps within 1e-6;
* base and re-certified type values within 1e-6 of the JAX package's, the
  same certificate mode on every edit, and the delta answer within the
  1e-3 L∞ contract of a from-scratch certification, as the JAX test holds.
"""

import copy

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.data import registry as jreg
from citizensassemblies_tpu.solvers import delta as jdelta
from citizensassemblies_tpu.utils.config import default_config as jcfg

from citizensassemblies_tpu_torch.data.registry import (
    RegistryEdit,
    apply_edit,
    churn_trail,
    nationwide_registry,
)
from citizensassemblies_tpu_torch.solvers import delta as gd
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

#: certified values of the same LPs in both packages
CERT_TOL = 1e-6
#: the screen's float32 price gaps in both packages
GAP_TOL = 1e-6


def _kw(n=1500, k=45, seed=2, regions=6, slack=0.02):
    return dict(n=n, k=k, seed=seed, categories=(("region", [f"r{i}" for i in range(regions)]),),
                quota_slack=slack)


def _registry(**kw):
    return nationwide_registry(**_kw(**kw))


def _same_registry(a, b):
    for f in ("name", "k", "categories", "features", "seed"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("assignments", "qmin", "qmax", "household_id", "witness"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _same_edit(a, b):
    for f in ("kind", "cell", "dlo", "dhi", "category", "feature"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("rows", "agents"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


def _type_linf(state_a, state_b):
    """L∞ over matched live types == the per-agent L∞ the contract uses."""
    ia = {tuple(int(v) for v in row): t for t, row in enumerate(state_a.system.type_feature)}
    worst = 0.0
    for t_b, row in enumerate(state_b.system.type_feature):
        if state_b.system.msize[t_b] == 0:
            continue
        t_a = ia.get(tuple(int(v) for v in row))
        if t_a is None:
            return float("inf")
        worst = max(worst, abs(float(state_a.type_values[t_a]) - float(state_b.type_values[t_b])))
    return worst


def _same_state(t, j):
    """A port delta state against the JAX package's: the same hull, pack and
    system, values and stage certificates within ``CERT_TOL``."""
    np.testing.assert_array_equal(t.comps, j.comps)
    np.testing.assert_array_equal(t.pack.idx, j.pack.idx)
    np.testing.assert_array_equal(t.pack.val, j.pack.val)
    np.testing.assert_array_equal(t.system.msize, j.system.msize)
    np.testing.assert_array_equal(t.system.rows, j.system.rows)
    np.testing.assert_allclose(t.type_values, j.type_values, atol=CERT_TOL)
    assert len(t.certs) == len(j.certs)
    for a, b in zip(t.certs, j.certs):
        assert abs(a.z - b.z) <= CERT_TOL and abs(a.mu - b.mu) <= CERT_TOL
        np.testing.assert_array_equal(a.fixed_after < 0, b.fixed_after < 0)


# --- churn trail ------------------------------------------------------------------


def test_registry_equals_the_jax_registry():
    for kw in (_kw(), _kw(n=4000, k=63, seed=0, regions=7, slack=0.01), dict(n=3000, seed=5)):
        _same_registry(nationwide_registry(**kw), jreg.nationwide_registry(**kw))
    reg = _registry()
    dense, space = reg.to_dense(device="cpu")
    jdense, jspace = jreg.nationwide_registry(**_kw()).to_dense()
    np.testing.assert_array_equal(dense.A_np, np.asarray(jdense.A))
    np.testing.assert_array_equal(dense.qmin_np, np.asarray(jdense.qmin))
    np.testing.assert_array_equal(dense.cat_of_feature_np, np.asarray(jdense.cat_of_feature))
    assert (space.categories, space.cells) == (jspace.categories, jspace.cells)
    assert dense.device == torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_churn_trail_deterministic_and_feasible(seed):
    reg = _registry()
    trail_a = churn_trail(reg, 20, seed=seed, max_edit_agents=16)
    trail_b = churn_trail(reg, 20, seed=seed, max_edit_agents=16)
    trail_j = jreg.churn_trail(jreg.nationwide_registry(**_kw()), 20, seed=seed, max_edit_agents=16)
    assert len(trail_a) == 20
    for ea, eb, ej in zip(trail_a, trail_b, trail_j):
        assert ea.kind == eb.kind and ea.magnitude == eb.magnitude
        assert ea.describe() == eb.describe() == ej.describe()
        _same_edit(ea, ej)
    cur, jcur = reg, jreg.nationwide_registry(**_kw())
    for edit, jedit in zip(trail_a, trail_j):
        cur, jcur = apply_edit(cur, edit), jreg.apply_edit(jcur, jedit)
        assert cur.check_witness(), f"witness infeasible after {edit.describe()}"
        _same_registry(cur, jcur)


def test_churn_trail_covers_edit_classes():
    reg = _registry()
    kinds = {e.kind for e in churn_trail(reg, 40, seed=3, max_edit_agents=16)}
    assert {"agents_add", "agents_drop", "quota_relax", "quota_tighten"} <= kinds


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_churn_relax_never_widens_both_arms(seed):
    """A ``quota_relax`` edit moves exactly one band edge."""
    weights = {"quota_relax": 0.7, "quota_tighten": 0.3}
    trail = churn_trail(_registry(), 60, seed=seed, max_edit_agents=16, weights=weights)
    jtrail = jreg.churn_trail(jreg.nationwide_registry(**_kw()), 60, seed=seed,
                              max_edit_agents=16, weights=weights)
    relaxes = [e for e in trail if e.kind == "quota_relax"]
    assert relaxes, "weighted trail emitted no quota_relax edits"
    for e in relaxes:
        assert (e.dlo, e.dhi) in ((-1, 0), (0, 1)), f"dlo={e.dlo} dhi={e.dhi}"
    for e, ej in zip(trail, jtrail):
        _same_edit(e, ej)


def test_drop_witness_member_rejected():
    reg = _registry()
    edit = RegistryEdit(kind="agents_drop", agents=np.asarray([int(reg.witness[0])], dtype=np.int64))
    with pytest.raises(ValueError, match="witness"):
        apply_edit(reg, edit)


# --- type-system projection -------------------------------------------------------


def test_typesystem_update_matches_rebuild():
    reg = _registry()
    system = gd.TypeSystem.from_registry(reg)
    jsystem = jdelta.TypeSystem.from_registry(jreg.nationwide_registry(**_kw()))
    cur, jcur = reg, jreg.nationwide_registry(**_kw())
    jtrail = jreg.churn_trail(jcur, 15, seed=5, max_edit_agents=16)
    for edit, jedit in zip(churn_trail(reg, 15, seed=5, max_edit_agents=16), jtrail):
        system, info = system.update(edit, cur)
        jsystem, jinfo = jsystem.update(jedit, jcur)
        assert info == jinfo
        cur, jcur = apply_edit(cur, edit), jreg.apply_edit(jcur, jedit)
    rebuilt = gd.TypeSystem.from_registry(cur)
    assert np.array_equal(system.lo, rebuilt.lo)
    assert np.array_equal(system.hi, rebuilt.hi)
    idx = {tuple(int(v) for v in row): t for t, row in enumerate(system.type_feature)}
    for t_r, row in enumerate(rebuilt.type_feature):
        t_s = idx.get(tuple(int(v) for v in row))
        assert t_s is not None
        assert int(system.msize[t_s]) == int(rebuilt.msize[t_r])
    for f in ("rows", "msize", "lo", "hi"):
        np.testing.assert_array_equal(getattr(system, f), getattr(jsystem, f), err_msg=f)


# --- the screen ---------------------------------------------------------------------


def test_screen_matches_jax():
    """The torch screen against the JAX package's jitted one on a relaxed
    quota (new columns admitted), on agent churn (pool sizes shift) and on
    a tighten (columns die): the same mask, gaps within ``GAP_TOL``."""
    cfg = default_config()
    reg = _registry()
    jr = jreg.nationwide_registry(**_kw())
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    jstate = jdelta.certify_base(jr, cfg=jcfg())
    _same_state(state, jstate)
    edits = [
        RegistryEdit(kind="quota_relax", cell=1, dlo=-1, dhi=0),
        RegistryEdit(kind="quota_tighten", cell=2, dlo=1, dhi=-1),
        churn_trail(reg, 1, seed=4, max_edit_agents=16, weights={"agents_add": 1.0})[0],
    ]
    for edit in edits:
        system, info = state.system.update(edit, reg)
        jsystem, _ = jstate.system.update(edit, jr)
        new = [gd._enumerate_region(system, *r) for r in gd._admitted_regions(system, info)]
        rows = np.concatenate(new) if new else np.zeros((0, system.T), dtype=np.int32)
        comps = np.concatenate([state.comps, rows]) if len(rows) else state.comps
        pack = state.pack.take(np.arange(len(state.pack)))
        jpack = jstate.pack.take(np.arange(len(jstate.pack)))
        if len(rows):
            pack.append(rows)
            jpack.append(rows)
        log = RunLog(echo=False)
        feas, gap = gd.screen_columns(pack, comps, system, state.certs, cfg.delta_cert_margin,
                                      cfg=cfg, log=log, device="cpu")
        jfeas, jgap = jdelta.screen_columns(jpack, comps, jsystem, jstate.certs,
                                            jcfg().delta_cert_margin, cfg=jcfg())
        np.testing.assert_array_equal(feas, jfeas, err_msg=edit.describe())
        assert gap.shape == jgap.shape == (len(state.certs), len(comps))
        assert np.abs(gap - jgap).max() <= GAP_TOL, edit.describe()
        assert log.counters["delta_screen_dispatches"] == 1
        if edit.kind == "quota_tighten":
            assert not feas.all()
        if edit.kind == "quota_relax":
            assert len(rows) > 0 and feas[len(state.comps):].any()


# --- delta soundness ------------------------------------------------------------------


def test_delta_matches_from_scratch_along_trail():
    cfg = default_config()
    reg = _registry()
    jr = jreg.nationwide_registry(**_kw())
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    jstate = jdelta.certify_base(jr, cfg=jcfg())
    assert state is not None
    checked_kinds = set()
    cur, jcur = reg, jr
    jtrail = jreg.churn_trail(jr, 12, seed=11, max_edit_agents=16)
    for edit, jedit in zip(churn_trail(reg, 12, seed=11, max_edit_agents=16), jtrail):
        nxt, jnxt = apply_edit(cur, edit), jreg.apply_edit(jcur, jedit)
        out = gd.recertify(state, edit, cur, cfg=cfg, device="cpu")
        jout = jdelta.recertify(jstate, jedit, jcur, cfg=jcfg())
        assert (out is None) == (jout is None), edit.describe()
        if out is None:
            state = gd.certify_base(nxt, cfg=cfg, device="cpu")
            jstate = jdelta.certify_base(jnxt, cfg=jcfg())
            assert state is not None
        else:
            assert out.cert["mode"] == jout.cert["mode"] in ("cache_hit", "resume", "full_ladder")
            assert out.cert["eps_bound"] <= 1e-3
            state, jstate = out.state, jout.state
        np.testing.assert_allclose(state.type_values, jstate.type_values, atol=CERT_TOL)
        scratch = gd.certify_base(nxt, cfg=cfg, device="cpu")
        assert scratch is not None
        linf = _type_linf(state, scratch)
        assert linf <= 1e-3, f"{edit.describe()}: L∞ {linf:.2e}"
        checked_kinds.add(edit.kind)
        cur, jcur = nxt, jnxt
    assert len(checked_kinds) >= 3


def test_cache_hit_certificate_validated_against_resolve():
    cfg = default_config()
    kw = dict(n=20_000, k=141, seed=4, regions=8, slack=0.003)
    reg = _registry(**kw)
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    assert state is not None
    rows = reg.assignments[:4].astype(np.int32)
    edit = RegistryEdit(kind="agents_add", rows=rows)
    out = gd.recertify(state, edit, reg, cfg=cfg, device="cpu")
    assert out is not None
    assert out.cert["mode"] == "cache_hit"
    assert out.cert["lp_solves"] == 0
    assert out.state.lp_solves == state.lp_solves
    scratch = gd.certify_base(apply_edit(reg, edit), cfg=cfg, device="cpu")
    assert scratch is not None
    linf = _type_linf(out.state, scratch)
    assert linf <= 1e-3
    assert linf <= out.cert["eps_bound"] + 1e-9
    # the JAX package certifies the same hit with the same values
    jr = jreg.nationwide_registry(**_kw(**kw))
    jout = jdelta.recertify(jdelta.certify_base(jr, cfg=jcfg()), edit, jr, cfg=jcfg())
    assert jout.cert["mode"] == "cache_hit"
    np.testing.assert_allclose(out.state.type_values, jout.state.type_values, atol=CERT_TOL)
    assert abs(out.cert["eps_bound"] - jout.cert["eps_bound"]) <= CERT_TOL


def test_warm_resume_pinned_instance():
    cfg = default_config()
    kw = dict(n=4000, k=63, seed=0, regions=7, slack=0.01)
    reg = _registry(**kw)
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    assert state is not None
    assert len(state.certs) == 5
    edit = RegistryEdit(kind="quota_relax", cell=5, dlo=-1, dhi=0)
    out = gd.recertify(state, edit, reg, cfg=cfg, device="cpu")
    assert out is not None
    assert out.cert["mode"] == "resume"
    assert out.cert["resume_stage"] == 1
    assert out.cert["stages_rerun"] == 4
    scratch = gd.certify_base(apply_edit(reg, edit), cfg=cfg, device="cpu")
    assert _type_linf(out.state, scratch) <= 1e-3
    jr = jreg.nationwide_registry(**_kw(**kw))
    jout = jdelta.recertify(jdelta.certify_base(jr, cfg=jcfg()), edit, jr, cfg=jcfg())
    _same_state(out.state, jout.state)


def test_tighten_that_kills_support_falls_back_soundly():
    cfg = default_config()
    reg = _registry()
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    assert state is not None
    counts = np.zeros(len(reg.qmin), dtype=int)
    wrows = reg.assignments[reg.witness]
    for c in range(reg.n_categories):
        off = int(reg.cell_offsets[c])
        vals, cnt = np.unique(wrows[:, c], return_counts=True)
        counts[off + vals] = cnt
    cell = 2
    edit = RegistryEdit(kind="quota_tighten", cell=cell, dlo=int(counts[cell] - reg.qmin[cell]),
                        dhi=int(counts[cell] - reg.qmax[cell]))
    nxt = apply_edit(reg, edit)
    assert nxt.check_witness()
    out = gd.recertify(state, edit, reg, cfg=cfg, device="cpu")
    scratch = gd.certify_base(nxt, cfg=cfg, device="cpu")
    assert scratch is not None
    jr = jreg.nationwide_registry(**_kw())
    jout = jdelta.recertify(jdelta.certify_base(jr, cfg=jcfg()), edit, jr, cfg=jcfg())
    assert (out is None) == (jout is None)
    if out is None:
        return  # the hull died: the envelope exit is the sound answer
    assert out.cert["mode"] == jout.cert["mode"] in ("cache_hit", "resume", "full_ladder")
    assert _type_linf(out.state, scratch) <= 1e-3
    np.testing.assert_allclose(out.state.type_values, jout.state.type_values, atol=CERT_TOL)


# --- ladder resume hooks ----------------------------------------------------------------


def test_capture_certs_leaves_ladder_unchanged():
    from citizensassemblies_tpu_torch.solvers.compositions import leximin_over_compositions

    system = gd.TypeSystem.from_registry(_registry())
    comps = gd._enumerate_region(
        system, np.zeros(system.T, dtype=np.int64), np.minimum(system.msize, system.k),
        system.lo, system.hi,
    )
    jsystem = jdelta.TypeSystem.from_registry(jreg.nationwide_registry(**_kw()))
    np.testing.assert_array_equal(comps, jdelta._enumerate_region(
        jsystem, np.zeros(jsystem.T, dtype=np.int64), np.minimum(jsystem.msize, jsystem.k),
        jsystem.lo, jsystem.hi,
    ))
    msize = np.maximum(system.msize, 1).astype(np.float64)
    plain = leximin_over_compositions(comps, msize, device="cpu")
    with_certs = leximin_over_compositions(comps, msize, capture_certs=True, device="cpu")
    assert plain.stage_certs is None
    assert with_certs.stage_certs is not None
    assert len(with_certs.stage_certs) == with_certs.stages
    np.testing.assert_array_equal(plain.probabilities, with_certs.probabilities)
    np.testing.assert_array_equal(plain.type_values, with_certs.type_values)
    resumed = leximin_over_compositions(comps, msize, fixed_init=with_certs.stage_certs[0].fixed_after,
                                        device="cpu")
    np.testing.assert_allclose(resumed.type_values, with_certs.type_values, atol=1e-9)


def test_project_to_reduction_consistency_guard():
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    cfg = default_config()
    reg = _registry()
    state = gd.certify_base(reg, cfg=cfg, device="cpu")
    dense, _ = reg.to_dense(device="cpu")
    reduction = TypeReduction(dense)
    ts = gd.project_to_reduction(state, reduction)
    assert ts is not None
    assert ts.compositions.shape == (len(state.comps), reduction.T)
    per_type = ts.probabilities @ (
        ts.compositions.astype(np.float64) / reduction.msize.astype(np.float64)[None, :]
    )
    np.testing.assert_allclose(per_type, ts.type_values, atol=1e-9)
    bad_system = copy.copy(state.system)
    bad_system.msize = state.system.msize + 1
    bad = gd.DeltaState(
        system=bad_system, comps=state.comps, probabilities=state.probabilities,
        type_values=state.type_values, eps_dev=state.eps_dev, certs=state.certs, pack=state.pack,
    )
    assert gd.project_to_reduction(bad, reduction) is None
