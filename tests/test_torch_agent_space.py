"""The agent-space LEXIMIN column generation: the port against the JAX package.

``Config.force_agent_space`` bypasses the type-space solvers: the portfolio
is seeded by the LEGACY sampler, each inner round solves the dual LP over it
(HiGHS under ``backend="hybrid"``, PDHG on the device under ``"jax"``) and
prices new panels, and the exact oracle certifies every fix. The two
packages draw different random panels, so their portfolios differ, but the
leximin allocation is unique up to interchangeable agents: the sorted
allocation profiles must agree within 1e-3 (``tests/test_certification.py``'s
bar), with the JAX package's agent-space result and with the port's own
type-space result, and the port must meet its 1e-3 contract.
"""

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.utils.config import default_config as jcfg

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.solvers import compositions as tcomp
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog

# the plain kernel versions are many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

SLICE = dict(decomp_device_pricing=False, lp_batch=False, mixed_precision=False)
PROFILE_TOL = 1e-3
#: iteration cap of the PDHG dual LPs under backend="jax" in both packages:
#: the plain version runs eager torch ops per iteration on the CPU, and a
#: solve that does not converge under it takes the path's own HiGHS fallback
JAX_BACKEND_MAX_ITERS = 8192

INSTANCES = {
    "mass_like": lambda g: g.mass_like_instance(),
    "n40": lambda g: g.random_instance(
        n=40, k=8, n_categories=2, features_per_category=2, seed=11
    ),
}

_ref = {}


def _reference(name, backend):
    """The JAX package's agent-space result (cached per process)."""
    if (name, backend) not in _ref:
        jd, js = j_featurize(INSTANCES[name](jgen))
        cfg = jcfg().replace(force_agent_space=True, backend=backend)
        if backend == "jax":
            cfg = cfg.replace(pdhg_max_iters=JAX_BACKEND_MAX_ITERS)
        _ref[name, backend] = j_leximin(jd, js, cfg=cfg)
    return _ref[name, backend]


def _port(name, log=None, **kw):
    td, ts = t_featurize(INSTANCES[name](tgen), device="cpu")
    cfg = tconfig.default_config().replace(**SLICE, **kw.pop("cfg", {}))
    return t_leximin(td, ts, cfg=cfg, log=log, device="cpu", **kw)


def _profile_dev(a, b) -> float:
    return float(np.abs(np.sort(a.allocation) - np.sort(b.allocation)).max())


def _check(dist, ref, typespace):
    assert dist.contract_ok
    assert dist.probabilities.sum() == pytest.approx(1.0, abs=1e-9)
    assert dist.allocation.sum() == pytest.approx(float(dist.committees[0].sum()), abs=1e-6)
    assert _profile_dev(dist, ref) <= PROFILE_TOL
    assert _profile_dev(dist, typespace) <= PROFILE_TOL


@pytest.mark.parametrize("name", list(INSTANCES))
def test_agent_space_hybrid_matches_reference(name):
    log = RunLog(echo=False)
    dist = _port(name, log=log, cfg=dict(force_agent_space=True, backend="hybrid"))
    _check(dist, _reference(name, "hybrid"), _port(name))
    assert "dual_lp" in log.timers and "typespace_lp" not in log.timers
    assert log.counters["agent_space_dual_solves"] >= 1


def test_agent_space_device_dual_lps(monkeypatch):
    """``backend="jax"``: every dual LP by PDHG on the device route, here the
    LP block kernel's plain version (the device routes forced on CPU tensors
    through the port's one routing predicate)."""
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    log = RunLog(echo=False)
    dist = _port("n40", log=log, cfg=dict(
        force_agent_space=True, backend="jax", pdhg_max_iters=JAX_BACKEND_MAX_ITERS,
    ))
    monkeypatch.undo()
    _check(dist, _reference("n40", "jax"), _port("n40"))
    c = log.counters
    assert c["megakernel_dispatches"] >= 1
    assert "megakernel_fit_miss" not in c


def test_initial_panels_warm_start():
    """``initial_panels`` seeds the portfolio and routes to agent space."""
    ref = _reference("n40", "hybrid")
    panels = [tuple(np.nonzero(row)[0].tolist()) for row in ref.committees[:12]]
    log = RunLog(echo=False)
    dist = _port("n40", log=log, initial_panels=panels)
    _check(dist, ref, _port("n40"))
    assert "dual_lp" in log.timers
    seen = {tuple(np.nonzero(row)[0].tolist()) for row in dist.committees}
    assert set(panels) <= seen


def _force_realization_miss(monkeypatch, shift: float = 2e-3):
    """``tests/test_certification.py::_force_realization_miss`` on the port:
    the type-space realization is blended toward one panel, so it misses the
    1e-3 contract."""
    real = tcomp.decompose_with_pricing

    def miss(*args, **kwargs):
        P, probs, eps = real(*args, **kwargs)
        probs = np.asarray(probs, dtype=np.float64).copy()
        if len(probs) >= 2:
            b = int(np.argmax(probs))
            probs *= 1.0 - 2.0 * shift
            probs[b] += 2.0 * shift
        return P, probs, eps

    monkeypatch.setattr(tcomp, "decompose_with_pricing", miss)


def test_contract_miss_falls_back_to_agent_space(monkeypatch):
    """A type-space realization that misses the contract routes to the
    agent-space CG, which meets it; with a spent ``agent_space_budget_s`` the
    certified type-space profile ships instead, flagged."""
    typespace = _port("n40")
    _force_realization_miss(monkeypatch)
    log = RunLog(echo=False)
    dist = _port("n40", log=log)
    _check(dist, _reference("n40", "hybrid"), typespace)
    assert any("falling back to agent-space CG" in line for line in dist.output_lines)
    rescued = _port("n40", cfg=dict(agent_space_budget_s=1e-9))
    assert not rescued.contract_ok and rescued.realization_dev > 1e-3
    assert any("budget" in line for line in rescued.output_lines)
    assert _profile_dev(rescued, typespace) <= 5e-3
