"""The face decomposition on the device route: the port against the JAX package.

``realize_profile(..., use_pdhg=True)`` with ``decomp_host_master_max_types=0``
sends every master to the two-sided PDHG (on the CPU: the port's plain
version of the block kernel, the JAX package's Pallas kernel in interpret
mode), in the slice's configuration (device pricing, the B-lane polish
screen and mixed precision off). Both must certify the profile within the
acceptance bar, on the same relaxation and the same seed columns.
"""

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.solvers import cg_typespace as jcg
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

# the plain kernel versions are many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

SLICE = dict(
    decomp_device_pricing=False, lp_batch=False, mixed_precision=False,
    decomp_host_master_max_types=0, pdhg_megakernel=True,
)
MAX_ROUNDS = 8


def _skewed(gen):
    return gen.skewed_instance(n=160, k=14, n_categories=4, seed=2)


@pytest.fixture(scope="module")
def profiles():
    """(reduction, relaxation, seed columns) of both packages."""
    jred = JRed(j_featurize(_skewed(jgen))[0])
    tred = TRed(t_featurize(_skewed(tgen), device="cpu")[0])
    jv, _ = jcg._leximin_relaxation(jred, JLog(echo=False))
    tv, _ = tcg._leximin_relaxation(tred, TLog(echo=False))
    # under-seeded (R=4) so the face loop runs several rounds
    jseeds = jcg._slice_relaxation(jv * jred.msize.astype(np.float64), jred, R=4)
    tseeds = tcg._slice_relaxation(tv * tred.msize.astype(np.float64), tred, R=4)
    return (jred, jv, jseeds), (tred, tv, tseeds)


def test_relaxation_and_seeds_match(profiles):
    (jred, jv, jseeds), (tred, tv, tseeds) = profiles
    assert tred.T == jred.T == 54
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
    assert len(jseeds) == len(tseeds) and len(tseeds) > 0
    for a, b in zip(jseeds, tseeds):
        np.testing.assert_array_equal(a, b)


def _certified(red, v, C, p, eps, bar, arithmetic=True):
    """``eps`` within ``bar`` and the mixture's realized residual within it
    too; an ``arithmetic`` eps (a device master's certificate) is that
    residual itself, a host LP's is the LP's value up to its tolerance."""
    assert eps <= bar
    mix = p @ (C.astype(np.float64) / red.msize[None, :])
    realized = float(np.abs(mix - v).max())
    assert realized <= (eps + 1e-12 if arithmetic else bar)
    assert abs(p.sum() - 1.0) <= 1e-9 and p.min() >= 0.0


def test_device_route_certifies_like_reference(profiles):
    (jred, jv, jseeds), (tred, tv, tseeds) = profiles
    jc = jcfg().replace(**SLICE)
    tc = tconfig.default_config().replace(**SLICE)
    bar = max(tc.decomp_accept, tc.decomp_accept_stalled)
    jlog, tlog = JLog(echo=False), TLog(echo=False)
    Cj, pj, ej, _ = jfd.realize_profile(
        jred, jv, list(jseeds), jcg.CompositionOracle(jred), tc.decomp_accept,
        log=jlog, max_rounds=MAX_ROUNDS, use_pdhg=True, cfg=jc,
    )
    Ct, pt, et, _ = tfd.realize_profile(
        tred, tv, list(tseeds), tcg.CompositionOracle(tred), tc.decomp_accept,
        log=tlog, max_rounds=MAX_ROUNDS, use_pdhg=True, cfg=tc, device="cpu",
    )
    _certified(jred, jv, Cj, pj, ej, bar)
    _certified(tred, tv, Ct, pt, et, bar)
    c = tlog.counters
    # every master went through the fused route, none missed the fit rule
    assert c["megakernel_dispatches"] >= c["decomp_rounds"] >= 1
    assert "megakernel_fit_miss" not in c
    # the two loops took the same path: as many rounds, warm and cold masters
    for key in ("decomp_rounds", "decomp_master_cold", "decomp_master_warm"):
        assert c.get(key, 0) == jlog.counters.get(key, 0), key
    # the master's readback and the move screen's are a round's only syncs
    steady = c.get("decomp_host_syncs", 0) - c.get("decomp_polish_syncs", 0)
    assert steady <= 2 * c["decomp_rounds"]


def test_host_masters_without_pdhg(profiles):
    """``use_pdhg=False``: every master is the host LP; the port certifies."""
    _, (tred, tv, tseeds) = profiles
    tc = tconfig.default_config().replace(**SLICE)
    log = TLog(echo=False)
    C, p, eps, _ = tfd.realize_profile(
        tred, tv, list(tseeds), tcg.CompositionOracle(tred), tc.decomp_accept,
        log=log, max_rounds=MAX_ROUNDS, use_pdhg=False, cfg=tc, device="cpu",
    )
    _certified(
        tred, tv, C, p, eps, max(tc.decomp_accept, tc.decomp_accept_stalled), arithmetic=False
    )
    assert "megakernel_dispatches" not in log.counters


@pytest.mark.parametrize(
    "knobs", [dict(mixed_precision=True), dict(robust_checkpoint_every=1)], ids=["bf16", "checkpoint"]
)
def test_slice_config_refuses_missing_paths(profiles, knobs, tmp_path):
    """Mixed precision and face-loop checkpointing, refused until ROADMAP
    queue A items 3 and 4 were ported, now run. bf16: every master on the
    device route (the block kernel's plain version) with demotion on
    returns the loop with it off bit for bit, each master's pack counted
    (its values are fractions c/m, so each stays float32 as a lossy skip).
    Checkpoint: the loop saves its running best each round and removes the
    file once it returns certified."""
    _, (tred, tv, tseeds) = profiles
    if "mixed_precision" in knobs:
        out = {}
        for mp in (False, True):
            cfg = tconfig.default_config().replace(**{**SLICE, "mixed_precision": mp})
            log = TLog(echo=False)
            out[mp] = tfd.realize_profile(
                tred, tv, list(tseeds), tcg.CompositionOracle(tred), 6.5e-4, log=log,
                max_rounds=2, use_pdhg=True, cfg=cfg, device="cpu",
            )[:3] + (log.counters,)
        (C0, p0, e0, c0), (C1, p1, e1, c1) = out[False], out[True]
        np.testing.assert_array_equal(C1, C0)
        np.testing.assert_array_equal(p1, p0)
        assert e1 == e0
        assert c1["mp_lossy_skip"] == c1["megakernel_dispatches"] >= 2
        assert "mp_lossy_skip" not in c0
        return
    cfg = tconfig.default_config().replace(robust_checkpoint_dir=str(tmp_path), **knobs)
    log = TLog(echo=False)
    C, p, eps, _ = tfd.realize_profile(
        tred, tv, list(tseeds), tcg.CompositionOracle(tred), 6.5e-4, log=log,
        use_pdhg=True, cfg=cfg, device="cpu",
    )
    _certified(tred, tv, C, p, eps, max(cfg.decomp_accept, cfg.decomp_accept_stalled),
               arithmetic=False)
    assert log.counters.get("robust_checkpoint_saved", 0) >= 1
    assert not list(tmp_path.glob("face_*.npz"))


@pytest.mark.parametrize("batched", [False, True])
def test_neighbor_columns_match_reference(profiles, batched):
    """The move screen (numpy, or one batch of torch ops) returns the same
    candidate columns as the JAX package's numpy screen, below the cap."""
    (jred, jv, jseeds), (tred, tv, tseeds) = profiles
    comps = np.stack(tseeds).astype(np.int16)
    r_norm = np.random.default_rng(3).normal(size=tred.T) / tred.msize
    want = jfd.neighbor_columns(comps, jred, r_norm, batched=False)
    got = tfd.neighbor_columns(comps, tred, r_norm, batched=batched, device="cpu")
    assert 0 < len(want) <= 16_384
    np.testing.assert_array_equal(got, want)
