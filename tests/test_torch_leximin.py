"""LEXIMIN end to end: the port against the JAX package.

Both packages run ``find_distribution_leximin`` on the same instances in the
configuration whose routes the CPU takes in both (device pricing, the
batched LP engine and mixed precision off): ``example_small_like_instance`` takes the enumerated
type-space path, ``skewed_instance(n=160, k=14, n_categories=4, seed=2)``
(T = 54 > ``enum_max_types``) the column-generation path with the face
decomposition. Each side must meet its 1e-3 L∞ contract, and the two
allocations must agree within 1e-3 L∞. A second port run forces the device
routing on the CPU through the port's one routing predicate, so every
master goes through the block kernel's plain version.
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
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils.logging import RunLog

# the plain kernel versions are many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

SLICE = dict(decomp_device_pricing=False, lp_batch=False, mixed_precision=False)
CONTRACT = 1e-3
#: the leximin values are LP optima both packages compute with HiGHS on the
#: host from identical inputs
FIXED_TOL = 1e-6

INSTANCES = {
    "example_small_like": lambda g: g.example_small_like_instance(),
    "skewed_160": lambda g: g.skewed_instance(n=160, k=14, n_categories=4, seed=2),
}

_ref = {}


def _reference(name):
    if name not in _ref:
        jd, js = j_featurize(INSTANCES[name](jgen))
        _ref[name] = j_leximin(jd, js, cfg=jcfg().replace(**SLICE))
    return _ref[name]


def _port(name, cfg=None):
    td, ts = t_featurize(INSTANCES[name](tgen), device="cpu")
    log = RunLog(echo=False)
    cfg = cfg or tconfig.default_config().replace(**SLICE)
    return t_leximin(td, ts, cfg=cfg, log=log, device="cpu"), log


def _check(ref, dist):
    for d in (ref, dist):
        assert d.contract_ok
        assert float(np.max(np.abs(d.allocation - d.fixed_probabilities))) <= CONTRACT
        assert abs(d.probabilities.sum() - 1.0) <= 1e-9
    np.testing.assert_allclose(dist.fixed_probabilities, ref.fixed_probabilities, rtol=0, atol=FIXED_TOL)
    assert float(np.max(np.abs(dist.allocation - ref.allocation))) <= CONTRACT
    np.testing.assert_array_equal(dist.covered, ref.covered)
    # every panel is a k-subset
    k = int(ref.committees.sum(axis=1)[0])
    assert (dist.committees.sum(axis=1) == k).all()


@pytest.mark.parametrize("name", list(INSTANCES))
def test_leximin_matches_reference(name):
    dist, log = _port(name)
    _check(_reference(name), dist)
    if name == "skewed_160":
        assert "typespace_cg" in log.timers
    else:
        assert "typespace_lp" in log.timers


def test_leximin_forced_device_routing(monkeypatch):
    """Every master on the device route (the block kernel's plain version on
    the CPU): the same bar against the reference."""
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    cfg = tconfig.default_config().replace(decomp_host_master_max_types=0, **SLICE)
    dist, log = _port("skewed_160", cfg=cfg)
    _check(_reference("skewed_160"), dist)
    c = log.counters
    assert c.get("megakernel_dispatches", 0) >= 1
    assert "megakernel_fit_miss" not in c


@pytest.mark.parametrize("path", ["households", "XMIN", "mixed precision", "checkpointing"])
def test_leximin_refuses_paths_not_ported(path, tmp_path):
    """Paths the port once refused, each naming its ROADMAP item, now run.
    Households (queue A item 2) in LEXIMIN and in XMIN: a distribution
    within the contract whose every panel is household-disjoint. Mixed
    precision (item 3): the agent-space route with device dual LPs demotes
    their 0/1 operands and returns the run with demotion off bit for bit.
    Checkpointing (item 4): ``checkpoint_path`` runs to the contract and
    leaves no file behind."""
    from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin

    if path in ("households", "XMIN"):
        # the couples of tests/test_households.py:70 (on example_small_like's
        # quotient, T=16, the enumeration spends its whole node budget first)
        pool = tgen.skewed_instance(n=64, k=10, n_categories=3, seed=5,
                                    features_per_category=[2, 3, 2])
    elif path == "mixed precision":
        pool = tgen.random_instance(n=24, k=5, n_categories=2, seed=3)
    else:
        pool = INSTANCES["example_small_like"](tgen)
    td, ts = t_featurize(pool, device="cpu")
    couples = np.arange(td.n) // 2
    if path in ("households", "XMIN"):
        entry = find_distribution_xmin if path == "XMIN" else t_leximin
        kw = dict(households=couples)
        if path == "XMIN":
            # the expansion and the ascent cut short: only the household path
            # is under test here (tests/test_torch_households.py holds XMIN
            # against the JAX package)
            kw["cfg"] = tconfig.default_config().replace(xmin_iterations_factor=1, xmin_qp_iters=1000)
        dist = entry(td, ts, device="cpu", **kw)
        assert dist.contract_ok
        for panel in dist.panels:
            assert len(set(couples[list(panel)].tolist())) == len(panel)
        return
    if path == "mixed precision":
        out = {}
        for mp in (False, True):
            cfg = tconfig.default_config().replace(
                mixed_precision=mp, force_agent_space=True, backend="jax")
            log = RunLog(echo=False)
            out[mp] = (t_leximin(td, ts, cfg=cfg, log=log, device="cpu"), log.counters)
        (off, c_off), (on, c_on) = out[False], out[True]
        assert on.contract_ok
        np.testing.assert_array_equal(on.allocation, off.allocation)
        np.testing.assert_array_equal(on.probabilities, off.probabilities)
        assert c_on["agent_space_dual_solves"] == c_off["agent_space_dual_solves"]
        assert c_on.get("mp_demoted_operands", 0) >= 2 and "mp_demoted_operands" not in c_off
        return
    path_ = tmp_path / "ckpt.npz"
    dist = t_leximin(td, ts, checkpoint_path=str(path_), device="cpu")
    assert dist.contract_ok and not path_.exists()
