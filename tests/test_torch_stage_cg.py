"""The stage-CG fallback after a stalled face loop: the port against the JAX package.

``decomp_accept = decomp_accept_stalled = 1e-7`` is a bar the face loop
cannot meet on ``skewed_instance(n=80, k=8, n_categories=3, seed=3)`` (19
types, over ``enum_max_types``), so both packages fall back to certified
stage-wise column generation over compositions. On the CPU their stage LPs
are host IPM solves; the pricing draws come from a ``torch.Generator`` in
the port and from ``jax.random`` in the JAX package, so the portfolios
differ, and the run is held to the stage values, not the columns: the same
number of stages, the fixed probabilities within ``FIXED_TOL`` (the bar of
``tests/test_torch_leximin.py``) and the 1e-3 contract.
"""

import numpy as np
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models.leximin import find_distribution_leximin as j_leximin
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin as t_leximin
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

torch.set_num_threads(1)

STALL = dict(decomp_accept=1e-7, decomp_accept_stalled=1e-7, mixed_precision=False)
FIXED_TOL = 1e-6
CONTRACT = 1e-3


def _inst(gen):
    return gen.skewed_instance(n=80, k=8, n_categories=3, seed=3)


def _stages(log):
    return sum(1 for ln in log.lines if ln.startswith("Fixed ") or "meets relaxation bound" in ln)


def test_stage_cg_fallback_matches_reference():
    jd, js = j_featurize(_inst(jgen))
    jlog = JLog(echo=False)
    ref = j_leximin(jd, js, cfg=jcfg().replace(**STALL), log=jlog)
    td, ts = t_featurize(_inst(tgen), device="cpu")
    tlog = TLog(echo=False)
    got = t_leximin(td, ts, cfg=tconfig.default_config().replace(**STALL), log=tlog, device="cpu")
    for log in (jlog, tlog):
        assert any("falling back to stage CG" in ln for ln in log.lines)
    assert TypeReduction(td).T > tconfig.default_config().enum_max_types
    assert _stages(tlog) == _stages(jlog) >= 2
    assert tlog.counters["stage_cg_stages"] == _stages(tlog)
    for d in (ref, got):
        assert d.contract_ok
        assert float(np.max(np.abs(d.allocation - d.fixed_probabilities))) <= CONTRACT
    np.testing.assert_allclose(got.fixed_probabilities, ref.fixed_probabilities, rtol=0, atol=FIXED_TOL)
    assert float(np.max(np.abs(got.allocation - ref.allocation))) <= CONTRACT


def test_stage_lp_pdhg_matches_host_stage_lp():
    """The device stage LP (the dense chained PDHG, columns padded to 4096)
    against the host IPM on one stage of the fixture's portfolio: the stage
    value within the PDHG's tolerance scale, its duals a valid pricing
    direction (nonnegative, on the unfixed types)."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_stage_lp_pdhg

    td, _ = t_featurize(_inst(tgen), device="cpu")
    red = TypeReduction(td)
    v, _ = tcg._leximin_relaxation(red, TLog(echo=False))
    comps = np.stack(tcg._slice_relaxation(v * red.msize.astype(np.float64), red, R=64))
    MT = np.ascontiguousarray((comps / red.msize[None, :].astype(np.float64)).T)
    fixed = np.full(red.T, -1.0)
    z_h, y_h, _mu_h, _p_h = tcg._stage_lp(MT, fixed)
    z, y, _mu, p, ok, warm = solve_stage_lp_pdhg(
        MT, fixed, cfg=tconfig.default_config().replace(pdhg_max_iters=20_000), tol=1e-5,
        device="cpu",
    )
    assert abs(z - z_h) <= 1e-3
    assert (y >= 0).all() and y.shape == (red.T,)
    assert p.shape == (MT.shape[1],) and warm[0].shape[0] == 4096 + 1
