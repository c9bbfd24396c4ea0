"""bf16 operand demotion: the port against the JAX package.

The same seeded inputs go through the JAX package's ``utils/precision.py``
and solvers and the port's. The port's demotion is lossless by the same
round-trip rule, and its consumers widen a demoted operand exactly before
any product, so an engaged run must equal the run with demotion off bit for
bit on every route (the JAX package's own test asks 1e-3 there,
``tests/test_prec.py:438-500``); it must lie within 1e-3 of the JAX
package's engaged run, and count ``mp_demoted_operands`` and
``mp_lossy_skip`` as the JAX package does. The JAX package counts the
demotions of its master, stage and generic LP solves on the ambient
request's log, so its runs here go through a ``RequestContext`` holding the
log the port's run is given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.service.context import RequestContext, use_context
from citizensassemblies_tpu.solvers import cg_typespace as jcg
from citizensassemblies_tpu.solvers import face_decompose as jfd
from citizensassemblies_tpu.solvers import lp_pdhg as jlp
from citizensassemblies_tpu.solvers import qp as jqp
from citizensassemblies_tpu.solvers.native_oracle import TypeReduction as JRed
from citizensassemblies_tpu.solvers.quotient import build_household_quotient as j_quotient
from citizensassemblies_tpu.utils import precision as jprec
from citizensassemblies_tpu.utils.config import default_config as jcfg
from citizensassemblies_tpu.utils.logging import RunLog as JLog

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.kernels import ell_matvec as tem
from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
from citizensassemblies_tpu_torch.solvers import face_decompose as tfd
from citizensassemblies_tpu_torch.solvers import lp_pdhg as tlp
from citizensassemblies_tpu_torch.solvers import qp as tqp
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction as TRed
from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient as t_quotient
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
from citizensassemblies_tpu_torch.utils import config as tconfig
from citizensassemblies_tpu_torch.utils import device as tdevice
from citizensassemblies_tpu_torch.utils import precision as tprec
from citizensassemblies_tpu_torch.utils.logging import RunLog as TLog

# the plain kernel versions are many small ops: intra-op threads would only
# contend with the other test workers for the cores
torch.set_num_threads(1)

#: the port's engaged run against the JAX package's (the JAX package's own
#: engaged-vs-off bar, tests/test_prec.py)
ENGAGED_TOL = 1e-3
MP_KEYS = ("mp_demoted_operands", "mp_lossy_skip")


def _mp(counters):
    return {k: int(counters.get(k, 0)) for k in MP_KEYS}


class _CountLog:
    def __init__(self):
        self.counts = {}

    def count(self, name, inc=1):
        self.counts[name] = self.counts.get(name, 0) + inc


def test_iterate_dtype_floors_half_at_f32():
    pairs = ((jnp.bfloat16, torch.bfloat16), (np.float16, torch.float16),
             (np.float32, torch.float32), (np.float64, torch.float64))
    for jdt, tdt in pairs:
        want = jprec.iterate_dtype(jdt)
        got = tprec.iterate_dtype(tdt)
        assert str(got) == f"torch.{want.name}"
        assert tprec.is_half_dtype(tdt) == jprec.is_half_dtype(jdt)
    assert tprec.demote_dtype() is torch.bfloat16


def test_gate_semantics_tri_state(monkeypatch):
    """``None`` follows the run's device, never whether the machine has a
    GPU: off for a CPU run and for no device, on for a CUDA device (no
    card needed to resolve it) and wherever the routing predicate says
    accelerator; ``True``/``False`` force."""
    cfg = tconfig.default_config()
    assert cfg.mixed_precision is None
    assert tprec.mixed_precision_enabled(cfg, torch.device("cpu")) is False
    assert tprec.mixed_precision_enabled(cfg) is False
    assert tprec.mixed_precision_enabled(cfg, torch.device("cuda")) is True
    assert tprec.mixed_precision_enabled(cfg.replace(mixed_precision=True), "cpu") is True
    assert tprec.mixed_precision_enabled(cfg.replace(mixed_precision=False), "cuda") is False
    # the JAX package's auto gate is off on its CPU backend too
    assert jprec.mixed_precision_enabled(jcfg()) is False
    monkeypatch.setattr(tdevice, "on_accelerator", lambda dev: True)
    assert tprec.mixed_precision_enabled(cfg, torch.device("cpu")) is True


def test_demote_operator_lossless_only():
    """``tests/test_prec.py``'s arrays through both packages: the exact one
    demotes, the lossy one stays float32 and is counted, an off gate or an
    uncertified core or argument returns the array untouched and uncounted;
    the counts are the JAX package's."""
    jprec._plan_demotable.cache_clear()
    tprec._plan_demotable.cache_clear()
    exact = np.arange(64, dtype=np.float32).reshape(8, 8)
    lossy = exact + np.float32(0.1)
    core = dict(core="lp_pdhg.pdhg_core", arg=1)
    j_on, j_off = jcfg().replace(mixed_precision=True), jcfg().replace(mixed_precision=False)
    t_on = tconfig.default_config().replace(mixed_precision=True)
    t_off = tconfig.default_config().replace(mixed_precision=False)

    for arr, want_dtype in ((exact, torch.bfloat16), (lossy, None)):
        jlog, tlog = _CountLog(), _CountLog()
        jout = jprec.demote_operator(jnp.asarray(arr), j_on, log=jlog, **core)
        tout = tprec.demote_operator(arr, t_on, log=tlog, device="cpu", **core)
        assert tlog.counts == jlog.counts
        if want_dtype is None:
            assert tout is arr and jout.dtype == jnp.float32
        else:
            assert tout.dtype == want_dtype and jout.dtype == jnp.bfloat16
            np.testing.assert_array_equal(tout.float().numpy(), arr)
            np.testing.assert_array_equal(np.asarray(jout, np.float32), arr)
    assert _CountLog().counts == {}
    tlog = _CountLog()
    assert tprec.demote_operator(exact, t_off, log=tlog, device="cpu", **core) is exact
    assert tprec.demote_operator(exact, t_on, core="lp_pdhg.pdhg_core", arg=0, log=tlog) is exact
    assert tprec.demote_operator(exact, t_on, core="no.such_core", arg=1, log=tlog) is exact
    # a float64 array is not an operand the plan demotes
    assert tprec.demote_operator(exact.astype(np.float64), t_on, log=tlog, **core).dtype == np.float64
    assert tlog.counts == {}
    # the port reads the JAX package's committed plan as it stands
    assert tprec._plan_demotable() == jprec._plan_demotable()


def test_gather_plain_bf16_equals_float32():
    """The gather's plain version on bf16 values (a lossless pack) equals
    the float32 values' bit for bit, one lane or three, and the kernel's
    launch plan for bf16 halves the float32 path's lanes per column."""
    rng = np.random.default_rng(0)
    rows = (rng.random((37, 90)) < 0.2).astype(np.float32) * rng.integers(1, 5, (37, 90))
    pack = EllPack.from_rows(rows)
    idx = torch.as_tensor(pack.idx)
    val = torch.as_tensor(pack.val)
    for y in (torch.as_tensor(rng.normal(size=90), dtype=torch.float32),
              torch.as_tensor(rng.normal(size=(3, 90)), dtype=torch.float32)):
        want = tem.ell_gather_mv(idx, val, y)
        got = tem.ell_gather_mv(idx, val.to(torch.bfloat16), y)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    for kp, g32 in ((112, 4), (16, 4), (64, 8), (8, 2)):
        assert tem.launch_plan(5000, kp, 90, 1, 132).G == g32
        assert tem.launch_plan(5000, kp, 90, 1, 132, bf16=True).G == g32 // 2


def test_gather_wrapper_takes_float32_or_bf16_only():
    """The kernel wrapper's checks (reached before any launch): float16
    values and a bf16 pack whose slots are not a multiple of 8 raise."""
    idx = torch.zeros((4, 8), dtype=torch.int32)
    y = torch.zeros(3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tem.ell_gather_mv_cuda(idx, torch.zeros((4, 8), dtype=torch.float16), y)
    with pytest.raises(ValueError, match="k_pad % 8"):
        tem.ell_gather_mv_cuda(
            torch.zeros((4, 4), dtype=torch.int32), torch.zeros((4, 4), dtype=torch.bfloat16), y
        )


def _dual_lp_fixture(n=20, rows=30, seed=3):
    """``tests/test_prec.py``'s flagship dual-LP fixture."""
    rng = np.random.default_rng(seed)
    P01 = (rng.random((rows, n)) < 0.4).astype(np.float64)
    P01[:n, :n] += np.eye(n)
    P01 = np.clip(P01, 0.0, 1.0)
    c = np.concatenate([np.zeros(n), [1.0]])
    G = np.hstack([P01, -np.ones((rows, 1))])
    h = np.zeros(rows)
    A = np.concatenate([np.ones(n), [0.0]])[None, :]
    b = np.array([1.0])
    return c, G, h, A, b


@pytest.mark.parametrize("route", ["dense", "ell_chained", "ell_fused"])
def test_mixed_precision_dual_lp_contract(route):
    """The dual-LP fixture: the port's engaged solve equals its off solve
    bit for bit on the dense route (``lp_pdhg.pdhg_core``) and both ELL
    routes (``pdhg_core_ell``, chained and the LP kernel's plain version);
    it lies within 1e-3 of the JAX package's engaged solve, and demotes
    ``G`` and ``A`` as the JAX package does."""
    c, G, h, A, b = _dual_lp_fixture()
    jc = jcfg().replace(mixed_precision=True)
    jlog = JLog(echo=False)
    with use_context(RequestContext.create(cfg=jc, log=jlog)):
        if route == "dense":
            jsol = jlp.solve_lp(c, G, h, A, b, cfg=jc)
        else:
            from citizensassemblies_tpu.solvers.sparse_ops import EllPack as JEll

            jsol = jlp.solve_lp_ell(c, JEll.from_rows(G), h, A, b, cfg=jc)
    mk = dict(pdhg_megakernel=route == "ell_fused")
    out = {}
    for mp in (False, True):
        tc = tconfig.default_config().replace(mixed_precision=mp, **mk)
        tlog = TLog(echo=False)
        if route == "dense":
            sol = tlp.solve_lp(c, G, h, A, b, cfg=tc, device="cpu", log=tlog)
        else:
            sol = tlp.solve_lp_ell(c, EllPack.from_rows(G), h, A, b, cfg=tc, device="cpu", log=tlog)
        out[mp] = (sol, tlog)
    (off, off_log), (on, on_log) = out[False], out[True]
    np.testing.assert_array_equal(on.x, off.x)
    np.testing.assert_array_equal(on.lam, off.lam)
    assert on.iters == off.iters and on.kkt == off.kkt
    assert _mp(off_log.counters) == {k: 0 for k in MP_KEYS}
    assert _mp(on_log.counters) == _mp(jlog.counters) == {"mp_demoted_operands": 2, "mp_lossy_skip": 0}
    assert on.ok and jsol.ok
    assert float(np.max(np.abs(on.x - jsol.x))) <= ENGAGED_TOL
    assert abs(on.objective - jsol.objective) <= ENGAGED_TOL


def _committee_qp_fixture():
    """``tests/test_prec.py``'s committee-QP fixture: 60 panels over 16
    agents, targets realized exactly by a mixture of the first 20, and a
    loose donor on those 20 (the mixture blended with the uniform one), so
    a donor-fed call runs the min-ε anchor."""
    rng = np.random.default_rng(11)
    C, n = 60, 16
    P = (rng.random((C, n)) < 0.35).astype(bool)
    P[:n, :n] |= np.eye(n, dtype=bool)
    donor = np.zeros(C)
    donor[:20] = rng.random(20)
    donor /= donor.sum()
    t = np.clip(P[:20].T.astype(np.float64) @ donor[:20], 0.0, 1.0)
    return P, t, 0.9 * donor[:20] + 0.1 / 20


#: the min-L2 stage's four demotion sites: (sparse_ops, lp_batch, donor,
#: whether the two packages' blends agree on this fixture)
QP_ROUTES = {
    "serial_dense": (False, False, False, False),  # qp.l2_dual_ascent
    "serial_ell": (True, False, False, True),  # qp.l2_dual_ascent_ell
    "fused_dense": (False, True, True, True),  # qp.l2_fused_core
    "fused_ell": (True, True, True, True),  # qp.l2_fused_core_ell
}


@pytest.mark.parametrize("route", list(QP_ROUTES))
def test_mixed_precision_committee_qp_contract(route):
    """The committee-QP fixture through ``solve_final_primal_l2`` on each of
    its four demotion sites: the port's engaged run equals its off run bit
    for bit and demotes the panel matrix once, as the JAX package does; ε
    and the floor every agent is held to (the largest shortfall below
    ``t − ε``) lie within 1e-3 of the JAX package's engaged run.

    p itself lies within 1e-3 of the JAX package's where both packages'
    blends agree: on three routes (measured: within 2.2e-4). On the serial
    dense route the ascent iterates agree to 1.3e-8, but ε is 1e-6 (the
    host LP realizes the targets exactly) and one agent's float32
    shortfall below ``t − ε`` lies within 5e-8 of the blend's slack
    (1.2e-7): the port blends in the host LP's vertex (β = 0.148) and the
    JAX package does not, and p differs by 0.034, with demotion off as
    well (ROADMAP §C)."""
    P, t, donor = _committee_qp_fixture()
    sparse, batch, use_donor, blends_agree = QP_ROUTES[route]
    knobs = dict(sparse_ops=sparse, lp_batch=batch)
    kw = dict(iters=4000, floor_donor=donor if use_donor else None)
    jc = jcfg().replace(mixed_precision=True, **knobs)
    jlog = JLog(echo=False)
    with use_context(RequestContext.create(cfg=jc, log=jlog)):
        p_j, e_j = jqp.solve_final_primal_l2(P, t, cfg=jc, log=jlog, **kw)
    out = {}
    for mp in (False, True):
        tc = tconfig.default_config().replace(mixed_precision=mp, **knobs)
        tlog = TLog(echo=False)
        out[mp] = tqp.solve_final_primal_l2(P, t, cfg=tc, log=tlog, device="cpu", **kw) + (tlog,)
    (p_off, e_off, off_log), (p_on, e_on, on_log) = out[False], out[True]
    np.testing.assert_array_equal(p_on, p_off)
    assert e_on == e_off
    assert on_log.counters.get("lp_batch_l2_fused", 0) == int(batch)
    assert _mp(on_log.counters) == _mp(jlog.counters) == {"mp_demoted_operands": 1, "mp_lossy_skip": 0}
    assert abs(e_on - e_j) <= ENGAGED_TOL
    PT = P.T.astype(np.float64)
    short_t = float((t - e_on - PT @ p_on).max())
    short_j = float((t - e_j - PT @ p_j).max())
    assert abs(short_t - short_j) <= ENGAGED_TOL
    if blends_agree:
        assert float(np.max(np.abs(p_on - p_j))) <= ENGAGED_TOL


#: the forced device route of tests/test_torch_face.py: every master on the
#: two-sided PDHG (the block kernel's plain version, the Pallas kernel in
#: interpret mode), device pricing and the batched engine off
FORCED = dict(decomp_device_pricing=False, lp_batch=False, decomp_host_master_max_types=0,
              pdhg_megakernel=True)


def _face_profiles(make, households=None):
    """(reduction, relaxation, R=4 seed columns) of both packages, on the
    household quotient with ``households``."""
    jdense = j_featurize(make(jgen))[0]
    tdense = t_featurize(make(tgen), device="cpu")[0]
    if households is not None:
        jdense = j_quotient(jdense, households(jdense.n)).dense_aug
        tdense = t_quotient(tdense, households(tdense.n)).dense_aug
    out = []
    for red, cg, Log in ((JRed(jdense), jcg, JLog), (TRed(tdense), tcg, TLog)):
        v, _ = cg._leximin_relaxation(red, Log(echo=False))
        out.append((red, v, cg._slice_relaxation(v * red.msize.astype(np.float64), red, R=4)))
    return out


FACE_CASES = {
    # type sizes 1-16: every master's pack holds fractions c/m bf16 cannot
    # hold, so every master stays float32 and counts a lossy skip
    "skewed_160": (lambda g: g.skewed_instance(n=160, k=14, n_categories=4, seed=2), None, 8),
    # couples: orbit sizes 1 and 2, so every master's pack is exact in bf16
    # and demotes; two rounds keep the interpret-mode run short
    "couples_120": (lambda g: g.skewed_instance(n=120, k=12, n_categories=3, seed=1),
                    lambda n: np.arange(n) // 2, 2),
}


@pytest.mark.parametrize("case", list(FACE_CASES))
def test_forced_device_route_counters_match_reference(case):
    """The face loop on the forced device route with ``mixed_precision=True``
    in both packages: the demotion counters equal the JAX package's (lossy
    skips at the skewed pool, demotions at the couples quotient); the port's
    engaged loop equals its off loop bit for bit (columns, mixture, ε,
    rounds) and takes the JAX package's rounds with the same ε."""
    make, households, rounds = FACE_CASES[case]
    (jred, jv, jseeds), (tred, tv, tseeds) = _face_profiles(make, households)
    jc = jcfg().replace(mixed_precision=True, **FORCED)
    jlog = JLog(echo=False)
    with use_context(RequestContext.create(cfg=jc, log=jlog)):
        _, _, ej, _ = jfd.realize_profile(
            jred, jv, list(jseeds), jcg.CompositionOracle(jred), jc.decomp_accept,
            log=jlog, max_rounds=rounds, use_pdhg=True, cfg=jc,
        )
    out = {}
    for mp in (False, True):
        tc = tconfig.default_config().replace(mixed_precision=mp, **FORCED)
        tlog = TLog(echo=False)
        out[mp] = tfd.realize_profile(
            tred, tv, list(tseeds), tcg.CompositionOracle(tred), tc.decomp_accept,
            log=tlog, max_rounds=rounds, use_pdhg=True, cfg=tc, device="cpu",
        )[:3] + (tlog.counters,)
    (C0, p0, e0, c0), (C1, p1, e1, c1) = out[False], out[True]
    np.testing.assert_array_equal(C1, C0)
    np.testing.assert_array_equal(p1, p0)
    assert e1 == e0 and c1["decomp_rounds"] == c0["decomp_rounds"]
    want = _mp(jlog.counters)
    assert _mp(c1) == want
    # one per master: the rounds' and the end-game polish's
    assert want["mp_demoted_operands" if households else "mp_lossy_skip"] > c1["decomp_rounds"]
    assert c1["decomp_rounds"] == jlog.counters["decomp_rounds"]
    assert abs(e1 - ej) <= ENGAGED_TOL
