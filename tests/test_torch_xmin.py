"""XMIN and LEXIMIN's ``final_stage="l2"``: the port against the JAX package.

Both packages run on ``skewed_instance(n=120, k=12, n_categories=3,
seed=1)`` on the CPU. The deterministic XMIN case seeds both with ONE
LEXIMIN result (the JAX package's, carried over by
``interop.distribution_from_arrays``) and replays the JAX package's draws
through the port's sampler, so the grown portfolio is the same and the
min-L2 stage and the spread compare value by value. The statistical case
lets the port draw from its own generator: its streams differ from JAX's,
so what is held is the contract, the expansion size, every panel's quotas
and the support. ``final_stage="l2"`` LEXIMIN runs on type space and on
agent space. Each check states its tolerance.
"""

import re

import jax
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models import legacy as jlegacy
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.models.xmin import find_distribution_xmin as j_xmin
from citizensassemblies_tpu.utils.config import default_config as jcfg

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.interop import distribution_from_arrays
from citizensassemblies_tpu_torch.models import xmin as txmin
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils.logging import RunLog

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

#: the routes the CPU takes in both packages; the expansion cut to 4n new
#: panels and the ascent to 4,000 iterations (the defaults, 8n and 20,000,
#: only lengthen the CPU run)
BASE = dict(mixed_precision=False, decomp_device_pricing=False, lp_batch=False,
            xmin_iterations_factor=4, xmin_qp_iters=4000)
ROUTES = {
    # the serial route: the LEXIMIN donor is tight, so no anchor runs
    "serial": {},
    # the fused route: a band under the donor's deviation opens the anchor
    # gate (0.5 · band), and lp_batch=True runs anchor and ascent fused
    "fused": dict(lp_batch=True, sparse_ops=True, xmin_linf_band=1e-7),
}
#: same portfolio, same donor: the float32 ascents of the two packages
#: differ in summation order only (tests/test_torch_qp.py), and the float64
#: blend and spread that follow are the same arithmetic
PROB_TOL = 1e-5
ALLOC_TOL = 1e-6
CONTRACT = 1e-3
#: the leximin values: LP optima both packages compute with HiGHS on the
#: host from identical inputs
FIXED_TOL = 1e-6
#: the l2 LEXIMIN realizations of the two packages: the same ascent
#: arithmetic on the same portfolio (type space: the same expansion of the
#: same certificate within FIXED_TOL)
DEV_TOL = 1e-5


def _pool(gen):
    return gen.skewed_instance(n=120, k=12, n_categories=3, seed=1)


def _cfgs(route):
    kw = dict(BASE, **ROUTES[route])
    return jcfg().replace(**kw), tconfig.default_config().replace(**kw)


_memo = {}


def _jax_run(route):
    """The JAX package's LEXIMIN and XMIN on the pool (memoized per route)."""
    if route not in _memo:
        jd, js = j_featurize(_pool(jgen))
        jc, _ = _cfgs(route)
        lex = j_leximin(jd, js, cfg=jc)
        _memo[route] = (jd, lex, j_xmin(jd, js, cfg=jc, leximin=lex))
    return _memo[route]


def _carried(lex):
    return distribution_from_arrays(
        lex.committees, lex.probabilities, lex.allocation, lex.fixed_probabilities,
        lex.covered, lex.realization_dev, lex.contract_ok,
    )


def _gamma(dist):
    lines = [ln for ln in dist.output_lines if ln.startswith("XMIN spread")]
    return re.search(r"γ = ([0-9.]+)", lines[0]).group(1) if lines else None


def _assert_panels_feasible(dense, committees):
    """Every panel has k members and meets every quota."""
    h = dense.host
    assert (committees.sum(axis=1) == dense.k).all()
    counts = committees.astype(np.int64) @ np.asarray(h.A, dtype=np.int64)
    assert (counts >= h.qmin[None, :]).all() and (counts <= h.qmax[None, :]).all()


@pytest.mark.parametrize("route", list(ROUTES))
def test_xmin_matches_reference_on_the_same_draws(route, monkeypatch):
    jd, lex, ref = _jax_run(route)
    key = {"k": jax.random.PRNGKey(jcfg().solver_seed + 1)}

    def replay(dense, generator, batch, **kw):
        # the JAX package's expansion draws, in its key order
        key["k"], sub = jax.random.split(key["k"])
        panels, ok = jlegacy.sample_panels_batch(jd, sub, batch)
        return torch.tensor(np.asarray(panels)), torch.tensor(np.asarray(ok))

    monkeypatch.setattr(txmin, "sample_panels_batch", replay)
    td, ts = t_featurize(_pool(tgen), device="cpu")
    _, tc = _cfgs(route)
    log = RunLog(echo=False)
    dist = txmin.find_distribution_xmin(td, ts, cfg=tc, log=log, leximin=_carried(lex), device="cpu")
    np.testing.assert_array_equal(dist.committees, ref.committees)
    assert float(np.abs(dist.probabilities - ref.probabilities).max()) <= PROB_TOL
    assert float(np.abs(dist.allocation - ref.allocation).max()) <= ALLOC_TOL
    assert _gamma(dist) == _gamma(ref)
    assert int((dist.probabilities > 1e-11).sum()) == int((ref.probabilities > 1e-11).sum())
    assert dist.contract_ok and ref.contract_ok
    assert abs(dist.probabilities.sum() - 1.0) <= 1e-9
    assert ("lp_batch_l2_fused" in log.counters) is (route == "fused")
    assert "xmin_draws" in log.timers and "xmin_dedup" in log.timers and "xmin_l2" in log.timers


def test_xmin_with_its_own_draws_meets_the_contract():
    """The port's own generator: the contract, as many expansion panels as
    the JAX package's run, every panel feasible and distinct, and a support
    at least 0.9× the JAX package's."""
    _jd, lex, ref = _jax_run("serial")
    td, ts = t_featurize(_pool(tgen), device="cpu")
    _, tc = _cfgs("serial")
    dist = txmin.find_distribution_xmin(td, ts, cfg=tc, leximin=_carried(lex), device="cpu")
    assert dist.contract_ok and dist.realization_dev <= CONTRACT
    n_lex = lex.committees.shape[0]
    assert dist.committees.shape[0] - n_lex == ref.committees.shape[0] - n_lex > 0
    np.testing.assert_array_equal(dist.committees[:n_lex], lex.committees)
    _assert_panels_feasible(td, dist.committees)
    assert len({row.tobytes() for row in dist.committees}) == dist.committees.shape[0]
    support = int((dist.probabilities > 1e-11).sum())
    assert support >= 0.9 * int((ref.probabilities > 1e-11).sum())
    assert support > int((lex.probabilities > 1e-11).sum())
    assert abs(dist.probabilities.sum() - 1.0) <= 1e-9


def test_xmin_repeat_runs_are_identical():
    """Two runs with the same seed draw the same portfolio and spread it the
    same way, bit for bit."""
    _jd, lex, _ = _jax_run("serial")
    td, ts = t_featurize(_pool(tgen), device="cpu")
    _, tc = _cfgs("serial")
    tc = tc.replace(xmin_iterations_factor=2, xmin_qp_iters=1000)
    a = txmin.find_distribution_xmin(td, ts, cfg=tc, leximin=_carried(lex), device="cpu")
    b = txmin.find_distribution_xmin(td, ts, cfg=tc, leximin=_carried(lex), device="cpu")
    np.testing.assert_array_equal(a.committees, b.committees)
    np.testing.assert_array_equal(a.probabilities, b.probabilities)


def _agent_pool(gen):
    return gen.random_instance(n=40, k=8, n_categories=2, features_per_category=2, seed=11)


@pytest.mark.parametrize("space", ["type", "agent"])
def test_leximin_l2_final_stage_matches_reference(space):
    """Type space on the XMIN pool; agent space (its column generation on
    the host LP) on a 40-agent pool, since the JAX package's agent-space l2
    call runs the ascent at its default 20,000 iterations."""
    kw = dict(BASE, force_agent_space=space == "agent")
    pool = _pool
    if space == "agent":
        kw.update(backend="highs")
        pool = _agent_pool
    jd, js = j_featurize(pool(jgen))
    td, ts = t_featurize(pool(tgen), device="cpu")
    ref = j_leximin(jd, js, cfg=jcfg().replace(**kw), final_stage="l2")
    log = RunLog(echo=False)
    dist = t_leximin(td, ts, cfg=tconfig.default_config().replace(**kw), log=log, device="cpu",
                     final_stage="l2")
    for d in (ref, dist):
        assert d.contract_ok and d.realization_dev <= CONTRACT
        assert abs(d.probabilities.sum() - 1.0) <= 1e-9
    np.testing.assert_allclose(dist.fixed_probabilities, ref.fixed_probabilities, rtol=0, atol=FIXED_TOL)
    assert float(np.abs(dist.allocation - ref.allocation).max()) <= CONTRACT
    assert abs(dist.realization_dev - ref.realization_dev) <= DEV_TOL
    assert "l2_dual_ascent" in log.timers
    if space == "type":
        # the rotation expansion is the portfolio, the same in both packages
        np.testing.assert_array_equal(dist.committees, ref.committees)
    else:
        assert "l2_eps_lp" in log.timers


def test_xmin_refuses_households():
    """XMIN refused households until ROADMAP queue A item 2 was ported; now
    it runs with them (its LEXIMIN seed included): every panel of the grown
    portfolio is household-disjoint, and the contract holds."""
    td, ts = t_featurize(_pool(tgen), device="cpu")
    couples = np.arange(td.n) // 2
    _, tc = _cfgs("serial")
    dist = txmin.find_distribution_xmin(td, ts, cfg=tc, households=couples, device="cpu")
    assert dist.contract_ok and dist.realization_dev <= CONTRACT
    _assert_panels_feasible(td, dist.committees)
    for row in dist.committees:
        members = np.nonzero(row)[0]
        assert len(set(couples[members].tolist())) == len(members)


def test_xmin_without_a_device_needs_cuda(monkeypatch):
    """No device given: CUDA, and without CUDA a clear error (no quiet
    fall-back to the CPU)."""
    td, ts = t_featurize(_pool(tgen), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        txmin.find_distribution_xmin(td, ts)
