"""LEXIMIN and XMIN with households: the port against the JAX package.

Both packages run on the CPU on the household fixtures of
``tests/test_households.py``: ``house_4`` (20 agents in 10 households of
2), 32 couples of ``skewed_instance(n=64, k=10, n_categories=3, seed=5)``,
and mixed household structures on a 24-agent cross-product pool. Type
space runs on the household quotient in both packages. The agent-space
route with households is forced by four warm-start panels, drawn by the
JAX package's sampler and handed to both. ``final_stage="l2"`` and XMIN
(seeded with one LEXIMIN result, the JAX package's draws replayed through
the port's sampler) run on the couples. Every panel must be
household-disjoint; each check states its tolerance. A face-loop error is
re-raised, never turned into an agent-space fallback.
"""

import jax
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models import legacy as jlegacy
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.models.xmin import find_distribution_xmin as j_xmin
from citizensassemblies_tpu.solvers import qp as jqp
from citizensassemblies_tpu.utils.config import default_config as jcfg

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.interop import distribution_from_arrays
from citizensassemblies_tpu_torch.models import xmin as txmin
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.solvers import compositions as tcomp
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers import qp as tqp
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils.logging import RunLog

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

#: the routes the CPU takes in both packages (device pricing and the
#: batched engine resolve off there)
BASE = dict(mixed_precision=False)
CONTRACT = 1e-3
#: the leximin values: LP optima both packages compute with HiGHS on the
#: host from identical inputs (the quotient's arrays are equal,
#: tests/test_torch_quotient.py)
FIXED_TOL = 1e-6
#: XMIN on the same portfolio from the same donor: the float32 ascents of
#: the two packages differ in summation order only (tests/test_torch_xmin.py)
XMIN_PROB_TOL = 1e-5
#: the min-L2 stage's ε*: the same float64 floor pick on the same portfolio
EPS_TOL = 1e-6
#: the XMIN expansion cut to 4n new panels and the ascent to 4,000
#: iterations (the defaults, 8n and 20,000, only lengthen the CPU run)
XMIN_CUT = dict(xmin_iterations_factor=4, xmin_qp_iters=4000)


def _house(gen):
    return gen.cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(0, 4), (0, 4)]],
        counts=[10, 10], k=4, name="house_4",
    )


def _couples(gen):
    return gen.skewed_instance(n=64, k=10, n_categories=3, seed=5, features_per_category=[2, 3, 2])


def _mixed(gen):
    return gen.cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(2, 6), (2, 6)]],
        counts=[12, 12], k=8, name="mixed_8",
    )


def _mixed_households():
    hh = np.arange(24, dtype=np.int32)
    hh[1] = hh[0]  # a same-type couple
    hh[12] = hh[2]  # a mixed couple
    hh[13] = hh[14] = hh[3]  # a triple
    return hh


POOLS = {
    "house_4": (_house, lambda: (np.arange(20) // 2).astype(np.int32)),
    "couples_64": (_couples, lambda: (np.arange(64) // 2).astype(np.int32)),
    "mixed_24": (_mixed, _mixed_households),
}

_ref = {}


def _reference(name, **kw):
    key = (name, repr(sorted(kw.items())))
    if key not in _ref:
        make, households = POOLS[name]
        jd, js = j_featurize(make(jgen))
        _ref[key] = j_leximin(jd, js, cfg=jcfg().replace(**BASE), households=households(), **kw)
    return _ref[key]


def _port(name, cfg=None, **kw):
    make, households = POOLS[name]
    td, ts = t_featurize(make(tgen), device="cpu")
    log = RunLog(echo=False)
    cfg = cfg or tconfig.default_config().replace(**BASE)
    dist = t_leximin(td, ts, cfg=cfg, log=log, device="cpu", households=households(), **kw)
    return dist, log


def _assert_disjoint(dist, hh):
    for panel in dist.panels:
        assert len(set(hh[list(panel)].tolist())) == len(panel), panel


@pytest.mark.parametrize("name", list(POOLS))
def test_leximin_with_households_matches_reference(name):
    """The orbit-space solve: fixed probabilities within ``FIXED_TOL`` of
    the JAX package's, both allocations within the contract, every panel
    household-disjoint, and on the mixed structures the orbit-constancy
    checks of tests/test_households.py:146-154."""
    ref = _reference(name)
    dist, log = _port(name)
    hh = POOLS[name][1]()
    assert any(line.startswith("Household quotient:") for line in log.lines)
    assert not any("falling back" in line for line in log.lines)
    for d in (ref, dist):
        assert d.contract_ok and d.realization_dev <= CONTRACT
        assert abs(d.probabilities.sum() - 1.0) <= 1e-9
    np.testing.assert_allclose(dist.fixed_probabilities, ref.fixed_probabilities, rtol=0, atol=FIXED_TOL)
    np.testing.assert_array_equal(dist.covered, ref.covered)
    _assert_disjoint(dist, hh)
    k = int(ref.committees.sum(axis=1)[0])
    assert (dist.committees.sum(axis=1) == k).all()
    assert abs(dist.allocation.sum() - k) < 1e-3
    if name == "house_4":
        assert dist.allocation.min() > 0
    if name == "mixed_24":
        a = dist.allocation
        assert abs(a[0] - a[1]) < 2e-3  # the same-type couple is one orbit
        assert abs(a[13] - a[14]) < 2e-3  # the triple's two type-b members
        singles = a[4:12]
        assert float(singles.max() - singles.min()) < 2e-3


def _jax_draws():
    """Four household-disjoint panels of the JAX package's sampler
    (tests/test_households.py:79-86)."""
    jd, _ = j_featurize(_couples(jgen))
    hh = POOLS["couples_64"][1]()
    panels, ok = jlegacy.sample_panels_batch(jd, jax.random.PRNGKey(7), 32, households=hh)
    panels = np.sort(np.asarray(panels), axis=1)
    return [tuple(panels[b].tolist()) for b in np.nonzero(np.asarray(ok))[0][:4]]


def test_agent_space_with_households_matches_reference():
    """Four warm-start panels force the agent-space CG with the household
    rows in the exact oracle: its allocation within the contract of the
    port's own quotient solve and of the JAX package's agent-space
    result."""
    seed_panels = _jax_draws()
    assert len(seed_panels) == 4
    ref = _reference("couples_64", initial_panels=seed_panels)
    dist, log = _port("couples_64", initial_panels=seed_panels)
    quotient, _ = _port("couples_64")
    hh = POOLS["couples_64"][1]()
    assert not any(line.startswith("Household quotient:") for line in log.lines)
    assert log.counters.get("oracle_backend_highs", 0) > 0
    assert "oracle_backend_native" not in log.counters
    assert dist.contract_ok
    assert float(np.abs(dist.allocation - quotient.allocation).max()) <= CONTRACT
    assert float(np.abs(dist.allocation - ref.allocation).max()) <= CONTRACT
    _assert_disjoint(dist, hh)


def _recording_l2(monkeypatch, module, seen):
    inner = module.solve_final_primal_l2

    def recorded(*a, **kw):
        probs, eps = inner(*a, **kw)
        seen.append(float(eps))
        return probs, eps

    monkeypatch.setattr(module, "solve_final_primal_l2", recorded)


def test_l2_final_stage_with_households_matches_reference(monkeypatch):
    """``final_stage="l2"`` realizes the quotient's certificate through the
    household-disjoint decomposition: ε* of the min-L2 stage within
    ``EPS_TOL`` of the JAX package's, every panel household-disjoint."""
    j_eps, t_eps = [], []
    _recording_l2(monkeypatch, jqp, j_eps)
    _recording_l2(monkeypatch, tqp, t_eps)
    ref = _reference("couples_64", final_stage="l2")
    dist, log = _port("couples_64", final_stage="l2")
    assert len(j_eps) == len(t_eps) == 1
    assert abs(t_eps[0] - j_eps[0]) <= EPS_TOL
    np.testing.assert_allclose(dist.fixed_probabilities, ref.fixed_probabilities, rtol=0, atol=FIXED_TOL)
    np.testing.assert_array_equal(dist.committees, ref.committees)
    assert dist.realization_dev <= CONTRACT and dist.contract_ok
    _assert_disjoint(dist, POOLS["couples_64"][1]())


def test_xmin_with_households_on_the_same_draws(monkeypatch):
    """XMIN from one LEXIMIN result (the JAX package's), the JAX package's
    household-disjoint expansion draws replayed through the port's
    sampler: the same portfolio, probabilities within ``XMIN_PROB_TOL``,
    every panel household-disjoint, the contract met."""
    hh = POOLS["couples_64"][1]()
    jd, js = j_featurize(_couples(jgen))
    jc = jcfg().replace(**BASE, **XMIN_CUT)
    lex = j_leximin(jd, js, cfg=jc, households=hh)
    ref = j_xmin(jd, js, cfg=jc, households=hh, leximin=lex)
    key = {"k": jax.random.PRNGKey(jc.solver_seed + 1)}
    calls = []

    def replay(dense, generator, batch, households=None, **kw):
        calls.append(households)
        key["k"], sub = jax.random.split(key["k"])
        panels, ok = jlegacy.sample_panels_batch(jd, sub, batch, households=households)
        return torch.tensor(np.asarray(panels)), torch.tensor(np.asarray(ok))

    monkeypatch.setattr(txmin, "sample_panels_batch", replay)
    td, ts = t_featurize(_couples(tgen), device="cpu")
    carried = distribution_from_arrays(
        lex.committees, lex.probabilities, lex.allocation, lex.fixed_probabilities,
        lex.covered, lex.realization_dev, lex.contract_ok,
    )
    dist = txmin.find_distribution_xmin(
        td, ts, cfg=tconfig.default_config().replace(**BASE, **XMIN_CUT), households=hh,
        leximin=carried, device="cpu",
    )
    assert calls and all(h is hh for h in calls)
    np.testing.assert_array_equal(dist.committees, ref.committees)
    assert float(np.abs(dist.probabilities - ref.probabilities).max()) <= XMIN_PROB_TOL
    assert dist.contract_ok and dist.realization_dev <= CONTRACT
    assert abs(dist.realization_dev - ref.realization_dev) <= CONTRACT
    assert dist.committees.shape[0] > lex.committees.shape[0]
    _assert_disjoint(dist, hh)


@pytest.mark.parametrize("error", [RuntimeError, tcomp.HouseholdPickError])
def test_quotient_errors_other_than_infeasible_picks_propagate(error, monkeypatch):
    """A ``RuntimeError`` of the face loop (a kernel's build or launch
    failure raises one) propagates out of the household solve; only a
    broken class cap (``HouseholdPickError``) or a ``SelectionError``
    sends the run to the agent-space CG."""

    def broken(*a, **kw):
        raise error("face loop failed")

    monkeypatch.setattr(tfd, "realize_profile", broken)
    if error is RuntimeError:
        with pytest.raises(RuntimeError, match="face loop failed"):
            _port("couples_64")
        return
    dist, log = _port("couples_64")
    assert any("falling back to agent-space CG" in line for line in log.lines)
    assert dist.contract_ok
    _assert_disjoint(dist, POOLS["couples_64"][1]())
