"""The port's distribution runtime against the JAX package's.

The JAX side runs on the conftest's 8-device virtual CPU mesh, as
``tests/test_dist.py`` runs it; the port runs in-process (no process group,
then a one-rank gloo world) and on one spawned 4-rank gloo world
(``tests/torch_worlds.py``), which builds the 4×1 and the 2×2
``(chains, agents)`` meshes. The JAX package's contracts are held here on
the port: topology shapes and their errors, the cached default topology,
the bootstrap env contract, the ``effective_mesh`` gate and gauges,
``process_slice``, the prepartition counts of ``tests/test_dist.py``'s
sequence, the declared-once layouts, the ``dist_collective`` fault down the
degradation ladder, the fleet contract and the transfer guard's modes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_worlds

from citizensassemblies_tpu.dist import partition as jpart
from citizensassemblies_tpu.dist import runtime as jrt
from citizensassemblies_tpu.parallel.mesh import make_mesh as j_make_mesh
from citizensassemblies_tpu.robust import policy as jpol
from citizensassemblies_tpu.utils.config import default_config as j_default_config
from citizensassemblies_tpu.utils.logging import RunLog as JLog

from citizensassemblies_tpu_torch import interop
from citizensassemblies_tpu_torch.dist import partition as tpart
from citizensassemblies_tpu_torch.dist import runtime as trt
from citizensassemblies_tpu_torch.parallel import mesh as tmesh
from citizensassemblies_tpu_torch.robust import policy as tpol
from citizensassemblies_tpu_torch.utils import guards
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils.logging import RunLog

torch.set_num_threads(1)

DIST_FIELDS = (
    "dual_shard_min_rows", "master_shard_min_types", "dist_mesh", "dist_coordinator",
    "dist_prepartition", "fleet_processes", "transfer_guard",
)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every rank's results of the 4-rank runtime job."""
    return torch_worlds.run_world(4, "dist", tmp_path_factory.mktemp("world4"))


@pytest.fixture
def no_world():
    """A process with no group and no cached runtime state, left so."""
    assert not dist.is_initialized()
    trt.reset_for_tests()
    yield
    trt.shutdown()


def test_config_fields_carry_the_jax_names_and_defaults():
    jc, tc = j_default_config(), default_config()
    for name in DIST_FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    mapped = interop.config_from_dict(dataclasses.asdict(jc.replace(
        dual_shard_min_rows=7, master_shard_min_types=9, dist_mesh=False,
        dist_coordinator="h:1", dist_prepartition=False, fleet_processes=3,
        transfer_guard="log",
    )))
    assert (mapped.dual_shard_min_rows, mapped.master_shard_min_types, mapped.dist_mesh,
            mapped.dist_coordinator, mapped.dist_prepartition, mapped.fleet_processes,
            mapped.transfer_guard) == (7, 9, False, "h:1", False, 3, "log")


def test_axis_names_and_env_contract_match():
    assert (trt.AXIS_CHAINS, trt.AXIS_AGENTS, trt.CHAIN_AXES) == (
        jrt.AXIS_CHAINS, jrt.AXIS_AGENTS, jrt.CHAIN_AXES)
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_FLEET_PROCESSES", "ENV_FLEET_INDEX"):
        assert getattr(trt, name) == getattr(jrt, name)


def test_bootstrap_single_process_fallback(no_world):
    info = trt.bootstrap()
    want = jrt.bootstrap()
    assert (info.process_count, info.process_index, info.initialized, info.coordinator) == (
        want.process_count, want.process_index, want.initialized, want.coordinator)
    assert trt.bootstrap() is info
    assert not dist.is_initialized()


def test_effective_mesh_is_none_on_one_device(no_world):
    log = RunLog(echo=False)
    assert trt.effective_mesh(default_config(), log=log) is None
    assert "dist_mesh_devices" not in log.counters
    # no mesh was needed, so no world started
    assert not dist.is_initialized()
    assert trt.process_slice(7) == (0, 7) and trt.process_slice(0) == (0, 0)


def test_one_rank_world_is_real_and_torn_down(no_world):
    mesh = tmesh.make_mesh(1, device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    store = trt._OWN_STORE
    assert store is not None and os.path.isdir(store)
    x = torch.ones(3)
    dist.all_reduce(x)
    assert x.tolist() == [1.0, 1.0, 1.0]
    topo = trt.default_topology()
    assert topo.shape == {"chains": 1, "agents": 1} and topo.n_devices == 1
    assert tmesh.default_mesh() is topo.mesh and tuple(mesh.get_coordinate()) == (0, 0)
    # one device: the routing gate stays undistributed
    assert trt.effective_mesh(default_config()) is None
    with pytest.raises(ValueError, match="whole world"):
        tmesh.make_mesh(2)
    trt.shutdown()
    assert not dist.is_initialized() and not os.path.exists(store)


def test_make_mesh_without_world_needs_one_device(no_world):
    with pytest.raises(ValueError, match="world"):
        tmesh.make_mesh(2, device="cpu")
    assert not dist.is_initialized()


def test_layouts_are_declared_once_with_the_jax_specs(no_world):
    mesh = tmesh.make_mesh(1, device="cpu")
    want = {
        "chain_batch": (Shard(0), Shard(0)), "portfolio": (Shard(0), Shard(1)),
        "chain_rows": (Shard(0), Replicate()), "bucket": (Shard(0), Shard(0)),
        "rows": (Shard(0), Shard(0)), "replicated": (Replicate(), Replicate()),
    }
    assert set(tpart.ROLE_BUILDERS) == set(jpart.ROLE_BUILDERS) == set(want)
    for role, placements in want.items():
        lay = tpart.role_layout(mesh, role, 2)
        assert lay.placements == placements and lay is tpart.role_layout(mesh, role, 2)
    assert tpart.layout_cache_stats()["size"] >= len(want)


def test_prepartition_counts_on_one_device_match_jax(no_world):
    """On a one-device mesh every layout is the same placement: JAX counts
    the host upload and nothing after it, and so does the port."""
    jmesh = j_make_mesh(1)
    jlog = JLog(echo=False)
    y = jpart.prepartition(np.ones((16, 4), np.float32), jpart.chain_batch(jmesh, 2), log=jlog)
    jpart.prepartition(y, jpart.chain_batch(jmesh, 2), log=jlog)
    jpart.prepartition(y, jpart.chain_rows(jmesh, 2), log=jlog)
    mesh = tmesh.make_mesh(1, device="cpu")
    log = RunLog(echo=False)
    t = tpart.prepartition(np.ones((16, 4), np.float32), tpart.chain_batch(mesh, 2), log=log)
    assert tpart.prepartition(t, tpart.chain_batch(mesh, 2), log=log) is t
    assert tpart.prepartition(t, tpart.chain_rows(mesh, 2), log=log) is t
    for key in ("dist_placements", "dist_reshards"):
        assert log.counters.get(key, 0) == jlog.counters.get(key, 0), key


def test_four_rank_bootstrap_through_the_env_contract(world4):
    for r, res in enumerate(world4):
        initialized, file_init, index, count, cached = res["bootstrap"]
        assert initialized and file_init and cached
        assert (index, count) == (r, 4) and res["rank"] == r
        assert res["all_reduce"] == [10.0, 10.0, 10.0]
        assert res["host_lane"] == r


def test_topology_shapes_and_errors_match_jax(world4):
    for res in world4:
        for a in (1, 2, 4):
            shape, n_dev, hosts, per_host, names = res["shapes"][a]
            jt = jrt.build_topology(4, agents_axis=a)
            assert shape == jt.shape and n_dev == jt.n_devices == 4
            assert names == tuple(jt.mesh.axis_names)
            # one process per device: four processes of one device each
            assert (hosts, per_host) == (4, 1)
        assert res["topology_errors"][0] == "n_devices=3 not divisible by agents_axis=2"
        with pytest.raises(ValueError, match="not divisible"):
            jrt.build_topology(6, agents_axis=4)
        assert "whole world" in res["topology_errors"][1]
        assert res["default_cached"] == (True, True)
    assert [res["coordinate"] for res in world4] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_effective_mesh_gate_and_gauges(world4):
    for r, res in enumerate(world4):
        handed, gauges = res["effective"]
        assert handed
        assert gauges == {"dist_mesh_hosts": 4, "dist_mesh_devices": 4, "dist_process_index": r}
        assert res["effective_off"]
    jlog = JLog(echo=False)
    assert jrt.effective_mesh(j_default_config(), log=jlog) is not None
    assert jrt.effective_mesh(j_default_config().replace(dist_mesh=False)) is None


def test_process_slice_matches_the_jax_rule(world4):
    for r, res in enumerate(world4):
        for n, got in zip((7, 0, 2, 12), res["process_slice"]):
            topo = jrt.Topology(mesh=j_make_mesh(1), hosts=4, devices_per_host=1, agents_axis=1)
            if r == 0:
                assert got == jrt.process_slice(n, topo)
            per = -(-n // 4)
            assert got == (min(r * per, n), min((r + 1) * per, n))
    assert [res["process_slice"][0] for res in world4] == [(0, 2), (2, 4), (4, 6), (6, 7)]


def test_prepartition_counts_match_jax(world4):
    """tests/test_dist.py's sequence on a 2×2 mesh against JAX's on 4×2: one
    placement, a pass-through of the same object, one reshard."""
    jmesh = j_make_mesh(8, agents_axis=2)
    jlog = JLog(echo=False)
    y = jpart.prepartition(np.ones((16, 4), np.float32), jpart.chain_batch(jmesh, 2), log=jlog)
    want = [(jlog.counters.get("dist_placements", 0), jpart.reshard_count(jlog))]
    y2 = jpart.prepartition(y, jpart.chain_batch(jmesh, 2), log=jlog)
    want.append((jlog.counters.get("dist_placements", 0), jpart.reshard_count(jlog), y2 is y))
    jpart.prepartition(y, jpart.chain_rows(jmesh, 2), log=jlog)
    want.append((jlog.counters.get("dist_placements", 0), jpart.reshard_count(jlog)))
    for res in world4:
        assert res["prepartition"] == want
        # chain_batch: 16 rows over 4 devices; chain_rows: over the 2 chains rows
        assert res["local_shapes"] == ((4, 4), (8, 4), True)
        assert res["declared_once"] == (True, True, True)


def test_dist_collective_fault_walks_the_ladder(world4):
    for res in world4:
        raised, fired, dist_mesh, undistributed = res["fault"]
        assert raised and fired == 1
        assert dist_mesh is False and undistributed


def test_degradation_ladder_ends_on_the_mesh_rung():
    names = [name for name, _ in tpol.DEGRADATION_LADDER]
    assert names[-1] == "mesh_to_single_device"
    assert dict(tpol.DEGRADATION_LADDER)["mesh_to_single_device"] == dict(
        jpol.DEGRADATION_LADDER)["mesh_to_single_device"] == {"dist_mesh": False}


@pytest.mark.parametrize(
    "env,cfg_n,path",
    [({}, 0, "artifacts/trace.json"),
     ({"CITIZENS_FLEET_PROCESSES": "3", "CITIZENS_FLEET_INDEX": "2"}, 0, "a/metrics.prom"),
     ({"CITIZENS_FLEET_INDEX": "1"}, 5, "trace")],
)
def test_fleet_contract_matches_jax(monkeypatch, no_world, env, cfg_n, path):
    for k in ("CITIZENS_FLEET_PROCESSES", "CITIZENS_FLEET_INDEX"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tc, jc = default_config().replace(fleet_processes=cfg_n), j_default_config().replace(
        fleet_processes=cfg_n)
    assert trt.fleet_process_count(tc) == jrt.fleet_process_count(jc)
    assert trt.fleet_process_index() == jrt.fleet_process_index()
    assert trt.scoped_artifact_path(path) == jrt.scoped_artifact_path(path)


@pytest.mark.parametrize(
    "mode,want", [("disallow", "error"), ("log", "warn"), ("off", None), ("allow", None)]
)
def test_transfer_guard_modes(mode, want):
    assert guards.torch_sync_mode(default_config().replace(transfer_guard=mode)) == want
    assert guards.torch_sync_mode(None, mode) == want
    with guards.no_implicit_transfers(default_config(), mode=mode):
        assert guards.armed_mode() == want
        # on the CPU a launch scope has nothing to guard
        with guards.guarded_launch("cpu"):
            assert guards.armed_mode() == want
    assert guards.armed_mode() is None


def test_transfer_guard_defaults_and_rejects_unknown_modes():
    assert guards.transfer_mode(None) == "disallow" == default_config().transfer_guard
    with guards.no_implicit_transfers():
        assert guards.armed_mode() == "error"
        with guards.no_implicit_transfers(mode="off"):
            # "off" opens no scope: the outer arming stays
            assert guards.armed_mode() == "error"
    with pytest.raises(ValueError, match="transfer_guard"):
        with guards.no_implicit_transfers(mode="sometimes"):
            pass
    assert issubclass(guards.GuardViolation, RuntimeError)
