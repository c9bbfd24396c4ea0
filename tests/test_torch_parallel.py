"""The port's distributed paths against its undistributed ones and the JAX package.

The JAX side runs on the conftest's 8-device virtual CPU mesh, as
``tests/test_parallel.py`` runs it. The port runs in-process (a one-rank
gloo world) and on spawned gloo worlds of 2 and 4 ranks
(``tests/torch_worlds.py``; the 4-rank world's portfolio matvec on a 2×2
``(chains, agents)`` mesh). Each concern has worlds of its own, each a
module fixture under its own time limit, so a slow world fails only the
tests that read it. What is held, with its tolerance:

* sampler and Monte-Carlo round: every world size bit for bit the
  undistributed port, counts and pair matrix exactly a recount, LEGACY
  against the JAX package within 5 binomial standard deviations per agent
  (``tests/test_torch_legacy.py``'s bound);
* ``distributed_allocation`` within 1e-6 of float64 ``Pᵀp``;
* the dropout realization bit for bit across world sizes and ``mesh=None``,
  and against JAX within 5σ per agent, on the parity pool and on the
  flagship pool;
* the sharded dual LP: objective and ŷ within 1e-4 of HiGHS and of the JAX
  sharded solve, N ranks within 1e-5 of one rank, on both routes;
* the sharded master: ``eps_real`` ≤ 5e-4 on the fixture of
  ``tests/test_parallel.py``, its aiming duals ``w`` and mixture ``p`` at
  any world size within 1e-5 of one rank and of the JAX sharded master;
  the 2-rank face loop's realized profile within 1e-3 of the
  single-device loop's;
* a 2-rank agent-space LEXIMIN with ``dual_shard_min_rows=1`` takes the
  sharded dual LP on every rank and lands within 1e-3 of the host run;
* the sweep: each instance bit for bit the per-instance sampler on the same
  noise rows, within 0.08 of JAX per agent; its LP fleet dealt over the
  ranks equal to the undistributed engine.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_worlds

import citizensassemblies_tpu.core.generator as jgen
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.models import legacy as jleg
from citizensassemblies_tpu.parallel import mc as jmc
from citizensassemblies_tpu.parallel import solver as jsolver
from citizensassemblies_tpu.parallel import sweep as jsweep
from citizensassemblies_tpu.parallel.mesh import make_mesh as j_make_mesh
from citizensassemblies_tpu.utils.config import default_config as j_default_config

import citizensassemblies_tpu_torch.core.generator as tgen
from citizensassemblies_tpu_torch.core.instance import featurize as t_featurize
from citizensassemblies_tpu_torch.dist import runtime as trt
from citizensassemblies_tpu_torch.models import legacy as tleg
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.parallel import mc as tmc
from citizensassemblies_tpu_torch.parallel import solver as tsolver
from citizensassemblies_tpu_torch.parallel import sweep as tsweep
from citizensassemblies_tpu_torch.parallel.mesh import make_mesh
from citizensassemblies_tpu_torch.solvers.highs_backend import solve_dual_lp, solve_final_primal_lp
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

POLICIES = ("type", "naive", "none")
DRAWS = 3000


def _five_sigma(a, b, N):
    p = np.clip((np.asarray(a) + np.asarray(b)) / 2, 1.0 / N, 1 - 1.0 / N)
    return np.abs(np.asarray(a) - np.asarray(b)) <= 5 * np.sqrt(2 * p * (1 - p) / N)


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo world in this process for the module, ended after."""
    assert not dist.is_initialized()
    trt.reset_for_tests()
    mesh = make_mesh(1, device="cpu")
    yield mesh
    trt.shutdown()


def _both(tmp_path_factory, job: str, **kwargs) -> dict:
    """``job`` on a 2-rank and on a 4-rank world, each under its own limit."""
    return {
        n: torch_worlds.run_world(n, job, tmp_path_factory.mktemp(f"{job}{n}"), world=n, **kwargs)
        for n in (2, 4)
    }


@pytest.fixture(scope="module")
def sampler_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "sampler")


@pytest.fixture(scope="module")
def allocation_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "allocation")


@pytest.fixture(scope="module")
def dropout_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "dropout", draws=DRAWS)


@pytest.fixture(scope="module")
def dual_ell_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "dual", route="ell")


@pytest.fixture(scope="module")
def dual_dense_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "dual", route="dense")


@pytest.fixture(scope="module")
def master_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "master")


@pytest.fixture(scope="module")
def sweep_worlds(tmp_path_factory):
    return _both(tmp_path_factory, "sweep")


@pytest.fixture(scope="module")
def routed_world(tmp_path_factory):
    return torch_worlds.run_world(2, "routed", tmp_path_factory.mktemp("routed2"), world=2)


@pytest.fixture(scope="module")
def td():
    return torch_worlds.pool_dense()


@pytest.fixture(scope="module")
def jd():
    return j_featurize(jgen.random_instance(**torch_worlds.POOL))[0]


@pytest.fixture(scope="module")
def portfolio(td):
    P = torch_worlds.feasible_portfolio(td)
    return P, np.random.default_rng(0).dirichlet(np.ones(len(P)))


def _ranks(worlds):
    """``(name, result)`` of every rank of every world, 2 ranks first."""
    return [(f"rank {r} of {n}", res) for n, w in sorted(worlds.items()) for r, res in enumerate(w)]


def test_the_pool_is_the_jax_pool(td, jd):
    np.testing.assert_array_equal(td.A_np, np.asarray(jd.A))
    np.testing.assert_array_equal(td.qmin_np, np.asarray(jd.qmin))


@pytest.mark.parametrize("batch", [200, 203])
def test_sample_panels_bit_identical_at_every_world_size(td, mesh1, sampler_worlds, batch):
    want_p, want_ok = tleg.sample_panels_batch(
        td, torch.Generator().manual_seed(11), batch, distribute=False
    )
    log = RunLog(echo=False)
    got_p, got_ok = tmc.distributed_sample_panels(
        td, torch.Generator().manual_seed(11), batch, mesh1, log=log
    )
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_ok.numpy(), want_ok.numpy())
    assert log.counters.get("dist_placements") == 1 and "dist_reshards" not in log.counters
    for name, res in _ranks(sampler_worlds):
        p, ok = res[f"sample_{batch}"]
        np.testing.assert_array_equal(p, want_p.numpy(), err_msg=name)
        np.testing.assert_array_equal(ok, want_ok.numpy(), err_msg=name)
    assert want_ok.any()


def test_distribute_true_and_none_draw_the_undistributed_panels(td, mesh1):
    want = tleg.sample_panels_batch(td, torch.Generator().manual_seed(2), 64, distribute=False)
    for distribute in (True, None):
        got = tleg.sample_panels_batch(td, torch.Generator().manual_seed(2), 64,
                                       distribute=distribute)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_mc_round_counts_and_pairs_are_exact(td, mesh1, sampler_worlds, ranks):
    if ranks == 1:
        p, ok, counts, pair = (
            t.numpy() for t in tmc.distributed_mc_round(td, torch.Generator().manual_seed(3), mesh1, 16)
        )
        results = [(p, ok, counts, pair)]
    else:
        results = [res["mc_round"] for res in sampler_worlds[ranks]]
    want_p, want_ok = tleg.sample_panels_batch(
        td, torch.Generator().manual_seed(3), 16 * ranks, distribute=False
    )
    for p, ok, counts, pair in results:
        np.testing.assert_array_equal(p, want_p.numpy())
        np.testing.assert_array_equal(ok, want_ok.numpy())
        S = np.zeros((len(p), td.n))
        for b in range(len(p)):
            if ok[b]:
                S[b, p[b]] = 1.0
        np.testing.assert_array_equal(counts, S.sum(axis=0))
        brute = S.T @ S
        np.fill_diagonal(brute, 0.0)
        np.testing.assert_array_equal(pair, brute)
        assert counts.sum() == ok.sum() * td.k


def test_legacy_estimator_distributed_equals_undistributed_and_jax(td, jd, sampler_worlds):
    N = 4000
    want = tleg.legacy_probabilities(td, iterations=N, seed=0, distribute=False, device="cpu")
    for _name, res in _ranks(sampler_worlds):
        np.testing.assert_array_equal(res["legacy"], want.allocation)
    jax_alloc = jleg.legacy_probabilities(jd, iterations=N, seed=0, distribute=True).allocation
    assert np.all(_five_sigma(want.allocation, jax_alloc, N))


def test_distributed_allocation_within_1e6_of_float64(portfolio, mesh1, allocation_worlds):
    P, probs = portfolio
    P16, p16 = P[:16], probs[:16] / probs[:16].sum()
    want = P16.T.astype(np.float64) @ p16
    got = [tmc.distributed_allocation(P16, p16, mesh1).numpy()]
    got += [res for _name, res in _ranks(allocation_worlds)]
    jax_alloc = np.asarray(jmc.distributed_allocation(
        P16.astype(np.float32), p16.astype(np.float32), j_make_mesh(8, agents_axis=2)
    ))
    for a in got:
        assert a.shape == want.shape
        assert np.abs(a - want).max() <= 1e-6
        assert np.abs(a - jax_alloc).max() <= 1e-6


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_bit_identical_across_world_sizes(td, portfolio, mesh1, dropout_worlds, policy):
    P, probs = portfolio
    args = (P, probs, torch_worlds.attendance(td.n), torch_worlds.type_ids(td.A_np), td)
    plain = tmc.dropout_realization_round(*args, torch.Generator().manual_seed(4), DRAWS, policy,
                                          mesh=None, chunk=1024)
    one = tmc.dropout_realization_round(*args, torch.Generator().manual_seed(4), DRAWS, policy,
                                        mesh=mesh1, chunk=1024)
    want = (plain.counts, plain.counts_valid, plain.quota_ok_rate, plain.fill_rate)
    got = [(one.counts, one.counts_valid, one.quota_ok_rate, one.fill_rate)]
    got += [res[policy] for _name, res in _ranks(dropout_worlds)]
    for g in got:
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[1], want[1])
        assert g[2:] == want[2:]
    assert plain.draws == DRAWS and plain.counts.sum() == pytest.approx(
        plain.fill_rate * td.k * DRAWS)


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_against_jax_in_distribution(td, jd, portfolio, policy):
    P, probs = portfolio
    att, tid = torch_worlds.attendance(td.n), torch_worlds.type_ids(td.A_np)
    got = tmc.dropout_realization_round(P, probs, att, tid, td, torch.Generator().manual_seed(9),
                                        DRAWS, policy)
    want = jmc.dropout_realization_round(P, probs, att, tid, jd, jax.random.PRNGKey(9), DRAWS,
                                         policy)
    assert np.all(_five_sigma(got.frequencies, want.frequencies, DRAWS))
    assert np.all(_five_sigma(got.frequencies_valid, want.frequencies_valid, DRAWS))
    assert _five_sigma([got.quota_ok_rate], [want.quota_ok_rate], DRAWS).all()
    # fill is a mean of k Bernoulli seats a draw
    assert _five_sigma([got.fill_rate], [want.fill_rate], DRAWS * td.k).all()
    if policy == "type":
        # same-type refills keep every quota of a feasible portfolio
        assert got.quota_ok_rate == want.quota_ok_rate == 1.0 and got.fill_rate == 1.0
    if policy == "none":
        assert got.fill_rate < 1.0


@pytest.fixture(scope="module")
def flagship_dropout():
    """The flagship pool (``sf_e_skewed_instance(seed=1)``, n=1727, T=814
    types) in both packages, 256 of its LEGACY panels with Dirichlet
    weights, and the attendance of ``chip_smoke.py``'s dropout phase."""
    td = t_featurize(tgen.sf_e_skewed_instance(seed=1), device="cpu")[0]
    jd = j_featurize(jgen.sf_e_skewed_instance(seed=1))[0]
    P = torch_worlds.feasible_portfolio(td, 256, seed=2)
    probs = np.random.default_rng(0).dirichlet(np.ones(len(P)))
    att = 1.0 - np.random.default_rng(0).uniform(0.0, 0.5, size=td.n)
    return td, jd, P, probs, att, torch_worlds.type_ids(td.A_np)


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_on_the_flagship_pool_against_jax(flagship_dropout, policy):
    """At the flagship pool's size the two packages agree within 5σ; there
    many types have a single agent, so a same-type refill cannot fill every
    seat and no draw of any policy keeps every quota, in either package."""
    td, jd, P, probs, att, tid = flagship_dropout
    N = 1024
    got = tmc.dropout_realization_round(P, probs, att, tid, td, torch.Generator().manual_seed(9),
                                        N, policy)
    want = jmc.dropout_realization_round(P, probs, att, tid, jd, jax.random.PRNGKey(9), N, policy)
    assert tid.max() + 1 == 814
    assert np.all(_five_sigma(got.frequencies, want.frequencies, N))
    assert np.all(_five_sigma(got.frequencies_valid, want.frequencies_valid, N))
    assert _five_sigma([got.fill_rate], [want.fill_rate], N * td.k).all()
    assert got.quota_ok_rate == want.quota_ok_rate == 0.0
    if policy == "type":
        assert got.fill_rate < 0.9 and want.fill_rate < 0.9
    if policy == "naive":
        assert got.fill_rate == want.fill_rate == 1.0


#: the nationwide case of the sharded dual LP: a registry of 60,000 agents
#: (y of 60,001, above every staged limit of the gather kernel, so on the
#: card its products read y from the L2) and its panels, few enough that
#: the JAX package's solves stay within a minute each
NATIONWIDE_N = 60_000
NATIONWIDE_PANELS = 96


@pytest.fixture(scope="module")
def nationwide():
    """The dual LP as the JAX package's ``dist`` bench family builds it,
    over ``nationwide_registry(n=60_000, seed=0)``: feasible panels, every
    agent unfixed. The panels are uniform k-subsets kept where every quota
    holds (uniform over the feasible panels), which a CPU draws in a
    fraction of the LEGACY sampler's time at this n."""
    from citizensassemblies_tpu_torch.data.registry import nationwide_registry

    reg = nationwide_registry(n=NATIONWIDE_N, seed=0)
    inc = reg.incidence()
    rng = np.random.default_rng(2)
    P = np.zeros((NATIONWIDE_PANELS, reg.n), dtype=bool)
    r = 0
    while r < NATIONWIDE_PANELS:
        panel = rng.choice(reg.n, size=reg.k, replace=False)
        counts = inc[panel].sum(axis=0)
        if np.all((counts >= reg.qmin) & (counts <= reg.qmax)):
            P[r, panel] = True
            r += 1
    return P, np.full(reg.n, -1.0)


@pytest.mark.parametrize("route,knob,pool", [
    pytest.param("ell", None, "flagship", id="ell-None"),
    pytest.param("dense", False, "flagship", id="dense-False"),
    pytest.param("ell", None, "nationwide", id="ell-None-nationwide"),
    pytest.param("dense", False, "nationwide", id="dense-False-nationwide"),
])
def test_sharded_dual_lp_matches_highs_and_jax(request, td, portfolio, mesh1, route, knob, pool):
    """The row-sharded dual LP on each route against HiGHS and the JAX
    package's, on one rank and (on the flagship pool's portfolio) on worlds
    of 2 and 4 ranks. The nationwide case (feasible panels of a
    nationwide registry, every agent unfixed) runs at a ``y`` the gather
    kernel reads from the L2."""
    if pool == "nationwide":
        from citizensassemblies_tpu_torch.kernels import ell_matvec as tem
        from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_pack_rows

        P, fixed = request.getfixturevalue("nationwide")
        assert P.shape == (NATIONWIDE_PANELS, NATIONWIDE_N)
        G = np.hstack([P, -np.ones((NATIONWIDE_PANELS, 1))]).astype(np.float32)
        kp = ell_pack_rows(G)[0].shape[1]
        assert not tem.launch_plan(NATIONWIDE_PANELS, kp, NATIONWIDE_N + 1, 1, 132).stage_y
    else:
        P, _ = portfolio
        fixed = np.full(td.n, -1.0)
    exact = solve_dual_lp(P, fixed)
    assert exact.ok
    jgot = jsolver.solve_dual_lp_pdhg_sharded(
        P, fixed, j_make_mesh(8, agents_axis=2), cfg=j_default_config().replace(sparse_ops=knob)
    )
    st = {}
    one = tsolver.solve_dual_lp_pdhg_sharded(
        P, fixed, mesh1, cfg=default_config().replace(sparse_ops=knob), stats=st
    )
    assert st["route"] == route and st["iters"] == 512 * st["blocks"]
    sols = [(one.ok, one.objective, one.yhat, one.y)]
    if pool == "flagship":
        worlds = request.getfixturevalue(f"dual_{route}_worlds")
        sols += [res[:4] for _name, res in _ranks(worlds)]
    for ok, obj, yhat, y in sols:
        assert ok
        assert abs(obj - exact.objective) < 1e-4 and abs(yhat - exact.yhat) < 1e-4
        assert abs(obj - jgot.objective) < 1e-4 and abs(yhat - jgot.yhat) < 1e-4
        # any world size within 1e-5 of one rank
        assert abs(obj - one.objective) < 1e-5 and abs(yhat - one.yhat) < 1e-5
        assert np.abs(y - one.y).max() < 1e-5


def test_sharded_master_realizes_the_fixture(mesh1, master_worlds):
    from citizensassemblies_tpu.solvers.compositions import enumerate_compositions
    from citizensassemblies_tpu.solvers.native_oracle import TypeReduction

    MT, v = torch_worlds.master_fixture()
    red = TypeReduction(j_featurize(jgen.random_instance(**torch_worlds.POOL))[0])
    comps = enumerate_compositions(red, cap=100000, node_budget=1000000)
    jMT = np.ascontiguousarray((comps.astype(np.float64) / red.msize.astype(np.float64)[None, :]).T)
    np.testing.assert_array_equal(MT, jMT)
    assert MT.shape[1] >= 8
    eps_real, w, p_norm, _obj, _ok = tsolver.solve_decomp_master_sharded(MT, v, mesh1, tol=1e-7)
    assert w.shape == (MT.shape[0],) and p_norm.shape == (MT.shape[1],)
    _je, jw, jp, _jobj, _jok = jsolver.solve_decomp_master_sharded(
        MT, v, j_make_mesh(8, agents_axis=2), tol=1e-7
    )
    # the aiming duals carry the rows of every rank, in rank order
    assert np.abs(w).sum() > 1e-3
    results = [(eps_real, float(p_norm.sum()), w, p_norm)]
    results += [res for _name, res in _ranks(master_worlds)]
    for eps, total, w_r, p_r in results:
        assert eps <= 5e-4, eps
        assert abs(total - 1.0) < 1e-6
        # any world size within 1e-5 of one rank, and of the JAX sharded master
        assert np.abs(w_r - w).max() < 1e-5 and np.abs(p_r - p_norm).max() < 1e-5
        assert np.abs(w_r - jw).max() < 1e-5 and np.abs(p_r - jp).max() < 1e-5


def test_leximin_routes_its_dual_lp_through_the_sharded_solver(td, routed_world):
    host = find_distribution_leximin(
        td, cfg=default_config().replace(backend="highs", force_agent_space=True), device="cpu"
    )
    for calls, alloc in (res["leximin"] for res in routed_world):
        assert calls > 0, "sharded dual path never taken"
        np.testing.assert_allclose(alloc, host.allocation, atol=1e-3)
        np.testing.assert_allclose(np.sort(alloc), np.sort(host.allocation), atol=1e-3)


def test_face_loop_routes_its_masters_through_the_sharded_master(mesh1, routed_world):
    """``master_shard_min_types=1`` on a 2-rank world: every master of the
    face loop is the sharded one, on every rank, with the same result,
    and the realized profile within 1e-3 of the single-device loop's."""
    (eps0, c0, C0, prof0), (eps1, c1, C1, prof1) = (res["face"] for res in routed_world)
    for c in (c0, c1):
        assert c["decomp_master_sharded"] == c["decomp_rounds"] >= 2
        assert c["dist_mesh_devices"] == 2
        assert "megakernel_dispatches" not in c
    assert np.isfinite(eps0) and eps0 == eps1
    np.testing.assert_array_equal(C0, C1)
    np.testing.assert_array_equal(prof0, prof1)
    # the one-rank world of this process: the single-device master
    eps_s, c_s, _C_s, prof_s = torch_worlds.face_loop_sharded()
    assert "decomp_master_sharded" not in c_s and c_s["decomp_rounds"] >= 2
    assert np.abs(prof0 - prof_s).max() <= 1e-3
    assert abs(eps0 - eps_s) <= 1e-3


def _sweep_pools(pkg):
    return [
        pkg.random_instance(n=n, k=8, n_categories=2, features_per_category=2, seed=seed)
        for seed, n in ((0, 40), (1, 56), (2, 48))
    ]


def test_sweep_draws_each_instance_bit_for_bit():
    denses = [t_featurize(i, device="cpu")[0] for i in _sweep_pools(tgen)]
    stacked, n_real = tsweep.pad_and_stack(denses)
    B = 256
    panels, ok = tsweep.sweep_panels(stacked, B, torch.Generator().manual_seed(7))
    alloc, rate = tsweep.allocation_from_panels(panels, ok, stacked.shape[1])
    for i, d in enumerate(denses):
        gen = torch.Generator().manual_seed(7)

        def noise_at(_step, i=i, n=d.n):
            return tleg.gumbel(gen, stacked.shape[:1] + (B, stacked.shape[1]), "cpu")[i, :, :n]

        p_i, ok_i = tleg._sample_panels_kernel(d, B, noise_at)
        np.testing.assert_array_equal(panels[i].numpy(), p_i.numpy())
        np.testing.assert_array_equal(ok[i].numpy(), ok_i.numpy())
        a_i, r_i = tsweep.allocation_from_panels(p_i, ok_i, stacked.shape[1])
        np.testing.assert_array_equal(alloc[i].numpy(), a_i.numpy())
        assert float(rate[i]) == float(r_i)
        assert np.all(alloc[i, n_real[i]:].numpy() == 0.0)


def test_sweep_allocations_against_jax():
    jd = [j_featurize(i)[0] for i in _sweep_pools(jgen)]
    td = [t_featurize(i, device="cpu")[0] for i in _sweep_pools(tgen)]
    want, _ = jsweep.sweep_legacy_allocations(jd, chains_per_instance=2048, seed=7)
    got, rate = tsweep.sweep_legacy_allocations(td, chains_per_instance=2048, seed=7)
    assert got.shape == want.shape == (3, 56)
    assert np.all(rate > 0.5)
    for i, d in enumerate(td):
        assert np.all(got[i, d.n:] == 0.0)
        assert np.max(np.abs(got[i, : d.n] - want[i, : d.n])) < 0.08


def test_sweep_rejects_mixed_k():
    d1 = t_featurize(tgen.random_instance(n=30, k=5, n_categories=2, seed=0), device="cpu")[0]
    d2 = t_featurize(tgen.random_instance(n=30, k=6, n_categories=2, seed=0), device="cpu")[0]
    with pytest.raises(ValueError, match="common panel size"):
        tsweep.pad_and_stack([d1, d2])


def test_sweep_final_primal_eps_dealt_over_ranks(sweep_worlds):
    pairs = torch_worlds.sweep_problems()
    Ps, ts = [a for a, _ in pairs], [b for _, b in pairs]
    log = RunLog(echo=False)
    local = tsweep.sweep_final_primal_eps(Ps, ts, cfg=default_config(), log=log, device="cpu")
    assert "dist_placements" not in log.counters
    jres = jsweep.sweep_final_primal_eps(Ps, ts)
    for (p, eps), (jp, jeps), P, t in zip(local, jres, Ps, ts):
        _p_h, eps_h = solve_final_primal_lp(P, t)
        assert abs(p.sum() - 1.0) < 1e-9 and eps <= eps_h + 1e-4
        assert abs(eps - jeps) < 1e-4
    for _name, (dealt, counters) in _ranks(sweep_worlds):
        # each bucket's lanes dealt in the declared bucket layout
        assert counters["dist_placements"] == counters["lp_batch_dispatches"]
        assert "dist_reshards" not in counters
        for (p, eps), (pd, epsd) in zip(local, dealt):
            np.testing.assert_array_equal(pd, p)
            assert epsd == eps
