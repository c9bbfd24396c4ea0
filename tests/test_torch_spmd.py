"""The port's SPMD pass on the CPU: world sizes 1, 2, 4 and 8 in this
process over torch's fake process group, no rank spawned.

The census of every registered core holds against the committed
``lint/spmd_budget.json``; the distributed cores' counts are pinned here
beside the JAX package's ``SPMD_BUDGET.json`` with the cause of each
difference. Planted faults (a collective inside the iteration loop, a
declared role placed otherwise, an undeclared operand above
``Config.spmd_replicated_bytes_max``) each fail by name.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from citizensassemblies_tpu_torch.lint import spmd
from citizensassemblies_tpu_torch.lint.registry import CoreEntry, IRCase, SpmdEntry

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def report():
    torch.set_num_threads(1)
    return spmd.run_spmd_checks(device="cpu")


def test_census_holds_at_every_world_size(report):
    assert report.ok, spmd.render_spmd_report(report)
    assert report.mesh_sizes == [1, 2, 4, 8]
    assert len(report.cores) == 24
    assert not dist.is_initialized()


def test_pinned_counts_beside_the_jax_census(report):
    census = {r.name: r.census for r in report.cores}
    jax = json.loads((REPO / "SPMD_BUDGET.json").read_text())["cores"]
    # the dropout realization all-reduces its counts and tallies once per
    # round at every size, as the JAX core does
    for key in ("mesh1", "mesh2", "mesh4", "mesh8"):
        assert census["mc.dropout_realization"][key] == jax["mc.dropout_realization"][key] == {
            "all-reduce": 2}
    # the batched engine: the JAX core all-reduces once from 2 devices on; the
    # port deals a bucket's lanes by rank and gathers the solutions back with
    # all_gather_object, which issues two all-gathers (the sizes, then the
    # pickled payloads); on one rank nothing is dealt or gathered
    assert census["batch_lp.vmapped_core"]["mesh1"] == jax["batch_lp.vmapped_core"]["mesh1"] == {}
    for key in ("mesh2", "mesh4", "mesh8"):
        assert jax["batch_lp.vmapped_core"][key] == {"all-reduce": 1}
        assert census["batch_lp.vmapped_core"][key] == {"all-gather": 2}
    # the sharded dual LP: the JAX census counts 11 all-reduce instructions
    # of the compiled program, each while body once; the port counts the
    # collectives one call issues, its loops unrolled: 8 Ruiz column-max
    # all-reduces, 25 power-iteration transposed products and the squared
    # norm of h, one transposed product per iteration of a 16-iteration
    # block, 2 KKT evaluations = 52 at every size (the IR core: one
    # 128-iteration block and no KKT, 162)
    for name in ("parallel.sharded_dual_lp", "parallel.sharded_dual_lp_ell"):
        for key in ("mesh1", "mesh2", "mesh4", "mesh8"):
            assert jax[name][key] == {"all-reduce": 11}
            assert census[name][key] == {"all-reduce": 8 + 25 + 1 + 16 + 2}
        assert census[name]["base"] == {"all-reduce": 8 + 25 + 1 + 128}
    # every other core issues no collective, in both packages
    for name, c in census.items():
        if name not in ("mc.dropout_realization", "batch_lp.vmapped_core",
                        "parallel.sharded_dual_lp", "parallel.sharded_dual_lp_ell"):
            assert c == {"base": {}}, name
            assert jax[name] == {"base": {}}, name


def test_per_iteration_collectives_are_the_exempted_ones(report):
    per = {r.name: r.per_iteration for r in report.cores if r.per_iteration}
    assert set(per) == {"mc.dropout_realization", "batch_lp.vmapped_core",
                        "parallel.sharded_dual_lp", "parallel.sharded_dual_lp_ell"}
    for name in ("parallel.sharded_dual_lp", "parallel.sharded_dual_lp_ell"):
        # one all-reduce of G^T lambda per extra iteration (16 more at scale 2)
        assert all(v == {"all-reduce": 16} for v in per[name].values())
    assert all(v == {} for v in per["mc.dropout_realization"].values())
    assert all(v == {} for v in per["batch_lp.vmapped_core"].values())


# --- planted faults -------------------------------------------------------------------


def _entries(fn, args, roles=None, exempt=None, name="fixture.core"):
    core = CoreEntry(name=name, path="fixture.py", line=1,
                     build=lambda device="cpu": IRCase(fn=lambda *a: a[0] * 1.0, args=(torch.ones(2),)))

    def build(mesh, device="cpu", scale=1):
        return IRCase(fn=fn, args=args, static=dict(mesh=mesh, scale=scale), arg_roles=roles)

    return [core], [SpmdEntry(name=name, path="fixture.py", line=1, build=build,
                              loop_collectives=exempt)]


def _rules(rep):
    return {(v.rule, v.name) for v in rep.violations}


def _mid_loop(x, *, mesh, scale):
    for _ in range(4 * scale):
        y = x.clone()
        dist.all_reduce(y)
    return y


def _once(x, *, mesh, scale):
    y = x.clone()
    for _ in range(4 * scale):
        y = y * 2.0
    dist.all_reduce(y)
    return y


def test_planted_mid_loop_all_reduce_fails(tmp_path):
    entries, spmd_entries = _entries(_mid_loop, (torch.ones(4),))
    rep = spmd.run_spmd_checks(entries, spmd_entries, budget_path=tmp_path / "b.json",
                               update_budget=True, mesh_sizes=(1, 2))
    assert ("S2", "collective-in-loop-body") in _rules(rep)
    exempt = spmd.run_spmd_checks(*_entries(_mid_loop, (torch.ones(4),), exempt="the algorithm"),
                                  budget_path=tmp_path / "c.json", update_budget=True,
                                  mesh_sizes=(1, 2))
    assert exempt.ok, spmd.render_spmd_report(exempt)
    once = spmd.run_spmd_checks(*_entries(_once, (torch.ones(4),)), budget_path=tmp_path / "d.json",
                                update_budget=True, mesh_sizes=(1, 2, 4, 8))
    assert once.ok and once.cores[0].census["mesh8"] == {"all-reduce": 1}


def _placed(G, h, *, mesh, scale):
    from citizensassemblies_tpu_torch.dist import partition as dp

    dp.place(G, dp.replicated(mesh, 2))
    dp.place(h, dp.rows(mesh, 1))
    return torch.zeros(1)


def test_declared_role_placed_otherwise_fails(tmp_path):
    G, h = np.ones((8, 3), np.float32), np.ones(8, np.float32)
    rep = spmd.run_spmd_checks(*_entries(_placed, (G, h), roles=("rows", "rows")),
                               budget_path=tmp_path / "b.json", update_budget=True, mesh_sizes=(2,))
    hits = [v for v in rep.violations if v.name == "placement-contract-mismatch"]
    assert len(hits) == 1 and "argument 0" in hits[0].message
    ok = spmd.run_spmd_checks(*_entries(_placed, (G, h), roles=("replicated", "rows")),
                              budget_path=tmp_path / "c.json", update_budget=True, mesh_sizes=(2,))
    assert ok.ok, spmd.render_spmd_report(ok)
    never = spmd.run_spmd_checks(*_entries(_once, (torch.ones(4),), roles=("rows",)),
                                 budget_path=tmp_path / "d.json", update_budget=True, mesh_sizes=(2,))
    assert ("S2", "unplaced-declared-operand") in _rules(never)


def test_undeclared_mega_operand_fails_above_one_rank(tmp_path):
    from citizensassemblies_tpu_torch.utils.config import default_config

    big = torch.zeros(default_config().spmd_replicated_bytes_max // 4 + 1)
    rep = spmd.run_spmd_checks(*_entries(_once, (big,)), budget_path=tmp_path / "b.json",
                               update_budget=True, mesh_sizes=(1, 2))
    hits = [v for v in rep.violations if v.name == "implicit-replication"]
    assert len(hits) == 1 and "mesh2" in hits[0].message
    declared = spmd.run_spmd_checks(*_entries(_once, (big,), roles=("replicated",)),
                                    budget_path=tmp_path / "c.json", update_budget=True,
                                    mesh_sizes=(1, 2))
    assert declared.ok


def test_census_ratchet_new_and_exceeded(tmp_path):
    budget = tmp_path / "b.json"
    assert spmd.run_spmd_checks(*_entries(_once, (torch.ones(4),)), budget_path=budget,
                                update_budget=True, mesh_sizes=(1, 2)).ok
    data = json.loads(budget.read_text())
    data["cores"]["fixture.core"]["mesh2"] = {}
    budget.write_text(json.dumps(data))
    rep = spmd.run_spmd_checks(*_entries(_once, (torch.ones(4),)), budget_path=budget, mesh_sizes=(1, 2))
    assert ("S1", "new-collective") in _rules(rep)
    stale = spmd.run_spmd_checks([], [], budget_path=budget, mesh_sizes=(1,))
    assert ("S1", "stale-budget-entry") in _rules(stale)


def test_fake_world_refuses_a_running_group(tmp_path):
    with spmd.fake_world(2) as mesh:
        assert int(mesh.size()) == 2
        with pytest.raises(RuntimeError, match="process group is running"):
            with spmd.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_spmd_replicated_bytes_max_round_trips():
    from citizensassemblies_tpu.utils.config import default_config as jax_default_config
    from citizensassemblies_tpu_torch.interop import config_from_dict
    from citizensassemblies_tpu_torch.utils.config import Config, default_config

    import dataclasses

    assert default_config().spmd_replicated_bytes_max == jax_default_config().spmd_replicated_bytes_max
    jax_cfg = jax_default_config().replace(spmd_replicated_bytes_max=4096)
    port = config_from_dict({f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)})
    assert port.spmd_replicated_bytes_max == 4096
    # the TPU-VMEM knob stays out of the port's Config
    assert "pdhg_megakernel_vmem_mb" not in {f.name for f in dataclasses.fields(Config)}


def test_cli_spmd_json(tmp_path, capsys, monkeypatch):
    from citizensassemblies_tpu_torch.lint import cli

    entries, spmd_entries = _entries(_once, (torch.ones(4),))
    monkeypatch.setattr(spmd, "collect", lambda: entries)
    monkeypatch.setattr(spmd, "collect_spmd", lambda: spmd_entries)
    budget, diff = tmp_path / "b.json", tmp_path / "d.json"
    assert cli.main(["--spmd", "--device", "cpu", "--budget", str(budget), "--update-budget"]) == 0
    capsys.readouterr()
    assert cli.main(["--spmd", "--device", "cpu", "--budget", str(budget), "--format", "json",
                     "--diff-out", str(diff)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["pass"] == "spmd" and doc["ok"] is True and doc["mesh_sizes"] == [1, 2, 4, 8]
    assert json.loads(diff.read_text())["cores"]["fixture.core"]["status"] == "PASS"
