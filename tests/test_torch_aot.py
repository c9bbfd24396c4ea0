"""The port's graph store (``citizensassemblies_tpu_torch/aot/``) on the CPU.

The contract of ``tests/test_aot.py`` for the port's store, which keeps
captured CUDA graphs per signature and a JSON manifest instead of
serialized executables. On CPU tensors a "capture" binds the block rebuilt
from its block factory to static copies of its operands and arguments and runs
it there: the static-buffer protocol of the card without the graph. So the
cases below run the real protocol:

* round trip: a recorded entry, saved and loaded, is captured by the boot
  prewarm and serves the same call as a hit, bit for bit the eager block;
* no store installed, the runner still reuses the process's graph; a
  request with ``aot_cache=False`` is store-blind; a miss counts and
  captures; a corrupt artifact gives an empty store, a fingerprint
  mismatch marks every entry stale, a JAX artifact (a pickle) loads stale;
* the tri-state ``boot``, the service booting the store and stamping
  ``audit["aot"]``, ``aot_cache=True`` without an artifact failing at
  construction, a hit counting no one-time work;
* a closed-over operand: for each graph site, instance B replaying
  instance A's stored entry equals B solved fresh (the store cleared) bit
  for bit, and B solved op by op;
* parity with the JAX package: ``COLDBOOT_SPEC``, ``COLDBOOT_LATTICE`` and
  the stamp's keys; the build CLI on the CPU.

What the CPU cannot reach: the CUDA graph itself (device pointers baked at
capture, the replay's kernels, a graph captured on one thread's stream
replayed on another's). ``chip_smoke.py``'s ``graph_store_reuse`` phase
holds those on the card.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from citizensassemblies_tpu_torch import aot
from citizensassemblies_tpu_torch.aot import build as tbuild
from citizensassemblies_tpu_torch.aot import store as tstore
from citizensassemblies_tpu_torch.service.context import RequestContext, use_context
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.guards import CompilationGuard

torch.set_num_threads(1)


@tstore.register_block("test.tiny")
def _tiny_factory(scale: float = 2.0):
    def make(w):
        def block(x):
            return (x * w * scale + 1.0,)

        return block

    return make


@pytest.fixture(autouse=True)
def _clean_globals():
    """The store, the recorder and the process's graphs are globals."""
    tstore.install_store(None)
    tstore.install_recorder(None)
    tstore.GRAPHS.clear()
    yield
    tstore.install_store(None)
    tstore.install_recorder(None)
    tstore.GRAPHS.clear()


def _tiny(w, family="test.tiny", graph=True):
    return tstore.SeededGraph(
        family, "test.tiny", {"scale": 2.0}, (w,),
        eager=tstore.block_factory("test.tiny")(scale=2.0)(w), graph=graph,
    )


def _build_tiny(tmp_path):
    """A one-entry artifact built the way ``aot/build.py`` builds: record a
    live call, save the recorder's entries."""
    rec = tstore.Recorder()
    tstore.install_recorder(rec)
    w = torch.arange(5, dtype=torch.float32)
    x = torch.ones(5)
    expected = _tiny(w)(x)
    tstore.install_recorder(None)
    tstore.GRAPHS.clear()
    path = str(tmp_path / "store.json")
    sha = tstore.save_artifact(path, list(rec.entries.values()), device="cpu")
    return w, x, expected, path, sha


def test_roundtrip_hit_is_bit_identical(tmp_path):
    w, x, expected, path, sha = _build_tiny(tmp_path)
    store = aot.boot(default_config().replace(aot_cache=True, aot_cache_path=path), device="cpu")
    assert store.sha == sha and store.prewarmed == 1 and len(tstore.GRAPHS) == 1
    run = _tiny(w)
    got = run(x)  # eager first call of this solve
    got2 = run(x)  # the stored entry
    assert torch.equal(got[0], expected[0]) and torch.equal(got2[0], expected[0])
    assert store.stamp()["hits"] == 1 and store.stamp()["misses"] == 0


def test_store_off_is_pass_through():
    w, x = torch.arange(3, dtype=torch.float32), torch.ones(3)
    eager = _tiny(w, graph=False)
    assert torch.equal(eager(x)[0], eager(x)[0]) and len(tstore.GRAPHS) == 0
    # no store installed: the process still keeps the graph (jit's cache)
    run = _tiny(w)
    run(x)
    assert torch.equal(run(x)[0], eager(x)[0]) and len(tstore.GRAPHS) == 1
    # a request with aot_cache=False is store-blind: its own capture, kept nowhere
    tstore.GRAPHS.clear()
    ctx = RequestContext.create(cfg=default_config().replace(aot_cache=False))
    with use_context(ctx):
        blind = _tiny(w)
        blind(x)
        assert torch.equal(blind(x)[0], eager(x)[0])
    assert len(tstore.GRAPHS) == 0


def test_prewarm_touches_entries(tmp_path):
    _w, _x, _e, path, _sha = _build_tiny(tmp_path)
    store = tstore.load_store(path, device="cpu")
    assert store.prewarm(device="cpu") == 1 and store.prewarmed == 1
    assert store.prewarm(device="cpu") == 0  # already captured: skipped
    assert store.prewarm(families=("other.",), device="cpu") == 0


def test_signature_miss_counts_and_falls_back(tmp_path):
    _w, _x, _e, path, _sha = _build_tiny(tmp_path)
    store = aot.boot(default_config().replace(aot_cache_path=path), device="cpu")
    w, x = torch.arange(7, dtype=torch.float32), torch.ones(7)  # another shape
    run = _tiny(w)
    run(x)
    with CompilationGuard(name="miss") as guard:
        got = run(x)
    assert torch.equal(got[0], x * w * 2.0 + 1.0)
    assert store.stamp()["misses"] == 1 and store.stamp()["hits"] == 0 and guard.count == 1
    # the next solve of that signature hits and counts no one-time work
    again = _tiny(w)
    again(x)
    with CompilationGuard(name="hit") as guard:
        got = again(x)
    assert torch.equal(got[0], x * w * 2.0 + 1.0)
    assert store.stamp()["hits"] == 1 and guard.count == 0


def test_corrupt_artifact_is_empty_store(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{ not json")
    store = tstore.load_store(str(path), device="cpu")
    assert store is not None and store.status == "corrupt" and len(store) == 0
    with pytest.raises(RuntimeError, match="unreadable"):
        tstore.load_store(str(path), require=True, device="cpu")


def test_fingerprint_mismatch_marks_all_stale(tmp_path):
    _w, _x, _e, path, _sha = _build_tiny(tmp_path)
    doc = json.loads(open(path).read())
    doc["fingerprint"]["torch"] = "0.0-other"
    open(path, "w").write(json.dumps(doc))
    store = tstore.load_store(path, device="cpu")
    assert store.status == "fingerprint_mismatch" and store.stale == len(doc["entries"]) == 1
    with pytest.raises(RuntimeError, match="was built for"):
        tstore.load_store(path, require=True, device="cpu")


def test_jax_artifact_loads_stale(tmp_path):
    """The JAX package's artifact (a pickle of serialized executables) at
    the path: an empty store, counted stale, never a crash."""
    path = tmp_path / "aot_cache_cpu.pkl"
    path.write_bytes(pickle.dumps({"schema_version": 1, "entries": [], "sha": "x"}))
    store = tstore.load_store(str(path), device="cpu")
    assert store.status == "fingerprint_mismatch" and store.stale == 1 and len(store) == 0
    with pytest.raises(RuntimeError, match="JAX package artifact"):
        tstore.load_store(str(path), require=True, device="cpu")


def test_boot_tri_state(tmp_path):
    missing = str(tmp_path / "nope.json")
    cfg = default_config().replace(aot_cache=None, aot_cache_path=missing)
    assert aot.boot(cfg, device="cpu") is None  # auto: boots cold
    assert aot.boot(cfg.replace(aot_cache=False), device="cpu") is None  # hard off
    with pytest.raises(RuntimeError, match="aot build"):
        aot.boot(cfg.replace(aot_cache=True), device="cpu")  # required: fails loud


def test_boot_installs_store(tmp_path):
    _w, _x, _e, path, sha = _build_tiny(tmp_path)
    cfg = default_config().replace(aot_cache=True, aot_cache_path=path, aot_prewarm=False)
    store = aot.boot(cfg, device="cpu")
    assert store is not None and store.sha == sha and tstore.active_store() is store
    assert store.prewarmed == 0 and len(tstore.GRAPHS) == 0  # prewarm off


def test_service_boots_store_and_stamps_audit(tmp_path):
    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService

    _w, _x, _e, path, sha = _build_tiny(tmp_path)
    cfg = default_config().replace(aot_cache=True, aot_cache_path=path)
    with SelectionService(cfg, device="cpu") as svc:
        assert svc.aot_store is not None and svc.aot_store.sha == sha
        res = svc.run(
            SelectionRequest(instance=random_instance(n=12, k=3, n_categories=2, seed=0)),
            timeout=600,
        )
        assert res.audit["aot"]["cache_sha"] == sha and res.audit["aot"]["status"] == "ok"
        text = svc.metrics_text()
        assert "aot_cache_hit" in text and "aot_cache_stale" in text
    # a service without a store stamps no aot block, as the JAX package's
    with SelectionService(cfg.replace(aot_cache=False), device="cpu") as svc:
        assert svc.aot_store is None


def test_service_requires_cache_fails_at_construction(tmp_path):
    from citizensassemblies_tpu_torch.service import SelectionService

    cfg = default_config().replace(aot_cache=True, aot_cache_path=str(tmp_path / "absent.json"))
    with pytest.raises(RuntimeError, match="aot build"):
        SelectionService(cfg, device="cpu")


def test_call_signature_statics_by_value_scalars_by_type():
    x = torch.zeros((4, 8), dtype=torch.float32)
    a = tstore.call_signature((x,), {"k": 3}, static_argnames=("k",))
    b = tstore.call_signature((x,), {"k": 4}, static_argnames=("k",))
    assert a != b  # statics change the captured kernels
    assert tstore.call_signature((x, 3), {}) == tstore.call_signature((x, 4), {})
    # dtype (a demoted bf16 operand) and layout are part of the key
    assert tstore.call_signature((x.to(torch.bfloat16),), {}) != tstore.call_signature((x,), {})
    assert tstore.call_signature((x.t(),), {}) != tstore.call_signature((x.t().contiguous(),), {})


def test_platform_fingerprint_identity():
    fp = tstore.platform_fingerprint("cpu")
    assert fp == tstore.platform_fingerprint("cpu")
    assert {"torch", "cuda", "device", "capability", "schema"} <= set(fp)


def test_stamp_schema_equals_jax():
    from citizensassemblies_tpu.aot.store import ExecStore as JExecStore

    assert set(tstore.ExecStore(sha="abc").stamp()) == set(JExecStore(sha="abc").stamp())


def test_coldboot_constants_equal_jax():
    from citizensassemblies_tpu.aot import build as jbuild

    assert tbuild.COLDBOOT_SPEC == jbuild.COLDBOOT_SPEC
    assert tbuild.COLDBOOT_LATTICE == jbuild.COLDBOOT_LATTICE
    for profile in ("smoke", "service"):
        assert tbuild.lattice_points(profile) == jbuild.lattice_points(profile)
    inst, jinst = tbuild.flagship_instance(), jbuild.flagship_instance()
    assert inst.k == jinst.k and inst.categories == jinst.categories


def test_entry_counts_its_bytes():
    w, x = torch.arange(4, dtype=torch.float32), torch.ones(4)
    run = _tiny(w)
    run(x)
    run(x)
    (entry,) = [tstore.GRAPHS[k] for k in tstore.GRAPHS]
    assert entry.nbytes == 2 * 4 * 4  # static operand and argument
    from citizensassemblies_tpu_torch.obs.memory import owner_attribution

    assert owner_attribution().get("aot_graphs", 0) >= entry.nbytes


# --- a closed-over operand -------------------------------------------------------


def _lp_instance(seed):
    rng = np.random.default_rng(seed)
    m1, m2, nv = 12, 1, 10
    G = rng.uniform(-1.0, 1.0, (m1, nv)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, m1).astype(np.float32)
    A = np.ones((m2, nv), np.float32)
    b = np.ones(m2, np.float32)
    c = rng.uniform(-1.0, 1.0, nv).astype(np.float32)
    return [torch.as_tensor(a) for a in (c, G, h, A, b)] + [
        torch.zeros(nv), torch.zeros(m1), torch.zeros(m2)
    ]


def _dense_lp(seed, graph):
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _pdhg_body

    return _pdhg_body(*_lp_instance(seed), 1e-6, max_iters=2048, check_every=64, graph=graph,
                      family="test.pdhg_core")


def _two_sided_instance(seed):
    """A two-sided master whose columns hold 3 of the T types each: one
    nonzero count and one pack shape for every seed, other positions and
    values."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    rng = np.random.default_rng(seed)
    T, C = 9, 24
    MT = np.zeros((T, C), np.float32)
    for col in range(C):
        MT[rng.choice(T, 3, replace=False), col] = rng.uniform(0.5, 1.5, 3)
    ell = EllPack.from_rows(MT.T, minor=T)
    idx, val = ell.padded(C)
    v = (MT.mean(axis=1) * 0.8).astype(np.float32)
    csr = mk.csr_to_device(idx, val, T, "cpu")
    return (torch.as_tensor(idx), torch.as_tensor(val), torch.as_tensor(v), torch.ones((1, C)),
            torch.zeros((1, C + 1)), torch.zeros((1, 2 * T)), torch.zeros(1),
            torch.full((1,), 1e-6), csr)


def _two_sided(seed, graph):
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _pdhg_two_sided_body_ell

    return _pdhg_two_sided_body_ell(*_two_sided_instance(seed), max_iters=2048, check_every=64,
                                    graph=graph, family="test.two_sided")


def _ascent_dense(seed, graph):
    from citizensassemblies_tpu_torch.solvers import qp

    rng = np.random.default_rng(seed)
    P = torch.as_tensor((rng.uniform(size=(20, 8)) < 0.4).astype(np.float32))
    t = torch.as_tensor(rng.uniform(0.2, 0.5, 8).astype(np.float32))
    return qp._min_norm_dual_ascent(P, t, torch.tensor(0.01), torch.tensor(0.05),
                                    torch.zeros(16), 3 * qp.L2_CHUNK, graph=graph)


def _ascent_ell(seed, graph):
    from citizensassemblies_tpu_torch.solvers import qp
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    rng = np.random.default_rng(seed)
    P = np.zeros((20, 8), np.float32)
    for row in range(20):
        P[row, rng.choice(8, 3, replace=False)] = 1.0
    ell = EllPack.from_rows(P)
    t = torch.as_tensor(rng.uniform(0.2, 0.5, 8).astype(np.float32))
    return qp._min_norm_dual_ascent_ell(
        torch.as_tensor(ell.idx), torch.as_tensor(ell.val), t, torch.tensor(0.01),
        torch.tensor(0.05), torch.zeros(16), 3 * qp.L2_CHUNK, graph=graph,
    )


@pytest.mark.parametrize("site", [_dense_lp, _two_sided, _ascent_dense, _ascent_ell],
                         ids=["pdhg_core", "two_sided_core_ell", "l2_dual_ascent",
                              "l2_dual_ascent_ell"])
def test_stored_entry_computes_with_the_next_instances_operands(site):
    """Instance A captures; instance B of the same signature replays A's
    stored entry with its own operands copied in, and equals B solved
    fresh (the store cleared) and B op by op, bit for bit."""
    a = site(0, graph=True)
    n_entries = len(tstore.GRAPHS)
    assert n_entries >= 1
    store = tstore.ExecStore(sha="test")
    tstore.install_store(store)
    with CompilationGuard(name="b") as guard:
        b_stored = site(1, graph=True)
    assert len(tstore.GRAPHS) == n_entries and store.hits >= 1 and store.misses == 0
    assert guard.count == 0
    tstore.install_store(None)
    tstore.GRAPHS.clear()
    b_fresh = site(1, graph=True)
    b_eager = site(1, graph=False)
    for got, fresh, eager, other in zip(b_stored, b_fresh, b_eager, a):
        got, fresh, eager = (torch.as_tensor(v) for v in (got, fresh, eager))
        assert torch.equal(got, fresh) and torch.equal(got, eager)
    # the instances differ, so a stale operand would have shown
    assert not all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(b_stored, a))


def test_build_cli_records_and_boots_on_cpu(tmp_path, capsys):
    """``python -m citizensassemblies_tpu_torch.aot build --device cpu``:
    the coldboot request and the lattice record the ``batch_lp.vmapped``
    family at every bucket; a boot from the artifact captures them all."""
    from citizensassemblies_tpu_torch.aot.__main__ import main

    path = str(tmp_path / "built.json")
    assert main(["build", "--out", path, "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["entries"] > 0 and report["skipped"] == []
    # the manifest walk records every registered core whose block the graph
    # store replays (12 of the 24) and lists the others
    assert report["manifest_cores_recorded"] == 12
    assert len(report["manifest_unwrapped"]) == 12
    assert "kernels.pallas_ell_matvec" in report["manifest_unwrapped"]
    assert report["lattice_buckets"] == len(tbuild.COLDBOOT_LATTICE)
    assert any(f.startswith("batch_lp.vmapped[") for f in report["families"])
    assert {"lp_pdhg.pdhg_core", "qp.l2_dual_ascent"} <= set(report["families"])
    doc = json.loads(open(path).read())
    graphs = [e for e in doc["entries"] if e["kind"] == "graph"]
    # the lattice's six distinct (m1, m2, nv) buckets at least
    assert len({tuple(e["operands"][0][1][0]) for e in graphs}) >= 6
    # the manifest walk's entries (the distributed cores' collective blocks
    # among them) are recorded tagged, and a boot prewarms none of them
    manifest = [e for e in graphs if e.get("manifest")]
    assert len(manifest) == 14
    assert {e["factory"] for e in manifest} >= {"parallel.sharded_block_dense", "qp.ascent_ell"}
    tstore.GRAPHS.clear()
    store = aot.boot(default_config().replace(aot_cache=True, aot_cache_path=path), device="cpu")
    assert store.prewarmed == len(graphs) - len(manifest) and store.stale == 0
    # a later recording merged into the artifact (as ``chip_smoke.py``'s
    # serve_flagship does) keeps the manifest's entries, unchecked
    merged = str(tmp_path / "merged.json")
    again = tbuild.write_recorded(merged, tstore.Recorder(), device="cpu",
                                  entries={(e["family"], e["sig"]): e for e in doc["entries"]})
    assert again["skipped"] == [] and again["entries"] == len(doc["entries"])
