"""LEXIMIN's column-generation checkpoints: the port against the JAX package.

The six cases of ``tests/test_checkpoint.py``, each through both packages
on the same inputs: the save/load/clear round trip (and each package
reading the other's file, the layout being the same), a finished run
removing its checkpoint, a crafted mid-run state resumed to the leximin
allocation, a checkpoint of another problem and a corrupt file ignored, and
the type-space state's round trip. ``checkpoint_path=`` runs on the CPU
here (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from citizensassemblies_tpu.core.generator import cross_product_instance as j_cross
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.utils import checkpoint as jck
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

from citizensassemblies_tpu_torch.core.generator import cross_product_instance as t_cross
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.utils import checkpoint as tck
from citizensassemblies_tpu_torch.utils.config import default_config as tcfg
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

torch.set_num_threads(1)

#: the JAX package's bars in tests/test_checkpoint.py: a resumed run against
#: the uninterrupted one (allocation, least probability); the two packages'
#: uninterrupted allocations are held at the contract
RESUME_TOL = 2e-2
RESUME_MIN_TOL = 1e-2
CONTRACT = 1e-3


def _small(cross, featurize, **kw):
    inst = cross(
        categories=["gender", "age"],
        features=[["f", "m"], ["y", "o"]],
        quotas=[[(2, 4), (2, 4)], [(2, 4), (2, 4)]],
        counts=[8, 8, 8, 8],
        k=6,
        name="ckpt_6",
    )
    return featurize(inst, **kw)


@pytest.fixture(scope="module")
def small():
    return _small(j_cross, j_featurize), _small(t_cross, t_featurize, device="cpu")


@pytest.fixture(scope="module")
def references(small):
    """Each package's uninterrupted LEXIMIN on the pool."""
    (jd, js), (td, ts) = small
    return j_leximin(jd, js), t_leximin(td, ts, device="cpu")


def _state(mod, n=10):
    return mod.CGState(
        portfolio=np.eye(4, n, dtype=bool),
        fixed=np.array([0.1, -1.0, 0.2, -1.0, 0.3, -1.0, 0.1, 0.1, -1.0, 0.2]),
        covered=np.ones(n, dtype=bool),
        key=np.array([0, 42], dtype=np.uint32),
        reduction_counter=1,
        dual_solves=7,
        exact_prices=2,
    )


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_clear_roundtrip(tmp_path, writer):
    """Either package's file loads in the port (and the port's in the JAX
    package): same arrays and counters, the wrong pool size ignored,
    clearing idempotent."""
    path = tmp_path / "cg.npz"
    w, r = (tck, jck) if writer == "port" else (jck, tck)
    w.save_cg_state(path, _state(w))
    for mod in (tck, jck):
        loaded = mod.load_cg_state(path, n=10)
        assert loaded is not None
        np.testing.assert_array_equal(loaded.portfolio, _state(tck).portfolio)
        np.testing.assert_array_equal(loaded.fixed, _state(tck).fixed)
        assert (loaded.dual_solves, loaded.exact_prices, loaded.reduction_counter) == (7, 2, 1)
        assert mod.load_cg_state(path, n=11) is None
    r.clear_cg_state(path)
    assert tck.load_cg_state(path, n=10) is None
    tck.clear_cg_state(path)  # idempotent


def test_completion_clears_checkpoint(small, references, tmp_path):
    (jd, js), (td, ts) = small
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jdist = j_leximin(jd, js, checkpoint_path=str(jpath))
    tdist = t_leximin(td, ts, checkpoint_path=str(tpath), device="cpu")
    assert not jpath.exists() and not tpath.exists(), "a finished run removes its checkpoint"
    assert abs(tdist.allocation.sum() - td.k) < 1e-3
    assert float(np.abs(tdist.allocation - jdist.allocation).max()) <= CONTRACT
    np.testing.assert_array_equal(tdist.allocation, references[1].allocation)


def _crafted(mod, dense, ref, cfg, seed):
    """A mid-run state: the reference's whole portfolio, half the agents'
    leximin values fixed (a tranche boundary)."""
    n = dense.n
    fixed = ref.fixed_probabilities.copy()
    fixed[np.argsort(fixed)[n // 2:]] = -1.0
    return mod.CGState(
        portfolio=ref.committees, fixed=fixed, covered=ref.covered,
        key=np.array([0, seed], dtype=np.uint32),
        fingerprint=mod.problem_fingerprint(dense, cfg),
    )


def test_resume_from_mid_state(small, references, tmp_path):
    """Both packages resume the crafted state (logging it), remove the file
    and land on their uninterrupted leximin allocation; the resumed
    allocations agree within the contract."""
    (jd, js), (td, ts) = small
    jref, tref = references
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jck.save_cg_state(jpath, _crafted(jck, jd, jref, jcfg(), 123))
    tck.save_cg_state(tpath, _crafted(tck, td, tref, tcfg(), 123))
    jlog, tlog = JLog(echo=False), TLog(echo=False)
    jdist = j_leximin(jd, js, checkpoint_path=str(jpath), log=jlog)
    tdist = t_leximin(td, ts, checkpoint_path=str(tpath), log=tlog, device="cpu")
    for log, path in ((jlog, jpath), (tlog, tpath)):
        assert any("Resumed checkpoint" in line for line in log.lines)
        assert not path.exists()
    np.testing.assert_allclose(tdist.allocation, tref.allocation, atol=RESUME_TOL)
    assert abs(tdist.allocation.min() - tref.allocation.min()) < RESUME_MIN_TOL
    assert float(np.abs(tdist.allocation - jdist.allocation).max()) <= CONTRACT


def test_foreign_checkpoint_ignored(small, references, tmp_path):
    """A checkpoint written for another problem starts fresh in both."""
    (jd, js), (td, ts) = small
    jref, tref = references
    out = []
    for name, mod, leximin, dense, space, ref, Log, kw in (
        ("j", jck, j_leximin, jd, js, jref, JLog, {}),
        ("t", tck, t_leximin, td, ts, tref, TLog, dict(device="cpu")),
    ):
        path = tmp_path / f"{name}.npz"
        mod.save_cg_state(path, mod.CGState(
            portfolio=ref.committees, fixed=np.full(dense.n, -1.0), covered=ref.covered,
            key=np.array([0, 1], dtype=np.uint32), fingerprint="deadbeef-some-other-problem",
        ))
        log = Log(echo=False)
        dist = leximin(dense, space, checkpoint_path=str(path), log=log, **kw)
        assert not any("Resumed checkpoint" in line for line in log.lines)
        np.testing.assert_allclose(dist.allocation, ref.allocation, atol=RESUME_TOL)
        out.append(dist.allocation)
    assert float(np.abs(out[0] - out[1]).max()) <= CONTRACT


def test_corrupt_checkpoint_ignored(small, tmp_path):
    (jd, js), (td, ts) = small
    path = tmp_path / "cg.npz"
    path.write_bytes(b"not an npz at all")
    assert tck.load_cg_state(path, td.n) is None and jck.load_cg_state(path, jd.n) is None
    tdist = t_leximin(td, ts, checkpoint_path=str(path), device="cpu")
    assert abs(tdist.allocation.sum() - td.k) < 1e-3


def test_typespace_state_roundtrip(tmp_path):
    """The type-space state through both packages' writers and loaders:
    wrong type count or fingerprint ignored, and the agent-space loader does
    not take a type-space file for its own."""
    for name, w in (("t", tck), ("j", jck)):
        path = tmp_path / f"ts_{name}.npz"
        w.save_ts_state(path, w.TypeCGState(
            compositions=np.arange(12, dtype=np.int32).reshape(4, 3),
            v_relax=np.array([0.1, 0.2, 0.3]),
            coverable=np.array([True, True, False]),
            key=np.array([0, 7], dtype=np.uint32),
            round=5,
            fingerprint="fp",
        ))
        for r in (tck, jck):
            loaded = r.load_ts_state(path, T=3, fingerprint="fp")
            assert loaded is not None and loaded.round == 5
            np.testing.assert_array_equal(loaded.compositions, np.arange(12).reshape(4, 3))
            np.testing.assert_array_equal(loaded.v_relax, [0.1, 0.2, 0.3])
            assert r.load_ts_state(path, T=4) is None
            assert r.load_ts_state(path, T=3, fingerprint="other") is None
            assert r.load_cg_state(path, n=3) is None


def test_generator_state_round_trips_through_the_key():
    """The agent-space CG's pricing generator: its state saved as the key
    restores the same draws; a ``[0, s]`` key seeds it with ``s``."""
    g = torch.Generator().manual_seed(5)
    torch.rand(7, generator=g)
    key = tck.generator_key(g)
    want = torch.rand(5, generator=g)
    h = tck.restore_generator(torch.Generator(), key)
    assert torch.equal(torch.rand(5, generator=h), want)
    h = tck.restore_generator(torch.Generator(), np.array([0, 123], dtype=np.uint32))
    assert torch.equal(torch.rand(5, generator=h), torch.rand(5, generator=torch.Generator().manual_seed(123)))


def test_typespace_checkpoint_resumes_on_many_types(tmp_path):
    """On a pool past the enumeration (type-space column generation), the
    seed columns and targets saved before the face decomposition resume a
    second run (``Resumed type-space checkpoint``), which realizes the same
    allocation; the finished runs leave no file."""
    from citizensassemblies_tpu_torch.core.generator import skewed_instance
    from citizensassemblies_tpu_torch.solvers import face_decompose

    td, ts = t_featurize(skewed_instance(n=120, k=12, n_categories=3, seed=1), device="cpu")
    path = tmp_path / "ts.npz"
    saved = {}
    realize = face_decompose.realize_profile

    def keep_file(*a, **kw):
        saved["bytes"] = path.read_bytes()
        return realize(*a, **kw)

    log = TLog(echo=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(face_decompose, "realize_profile", keep_file)
        first = t_leximin(td, ts, checkpoint_path=str(path), log=log, device="cpu")
    assert "Type-space column generation" in "\n".join(log.lines)
    assert not path.exists() and saved
    path.write_bytes(saved["bytes"])
    log2 = TLog(echo=False)
    again = t_leximin(td, ts, checkpoint_path=str(path), log=log2, device="cpu")
    assert any("Resumed type-space checkpoint" in line for line in log2.lines)
    assert not path.exists()
    assert "relax_leximin" not in log2.timers
    np.testing.assert_array_equal(again.allocation, first.allocation)
