"""The analysis layer: the port against the JAX package.

The cases of ``tests/test_analysis.py`` on its ``tiny_4`` pool (n=24, k=4,
four symmetric types), run through the port on the CPU, and the port's
``analyze_instance`` held against the JAX package's on the same instance:

- LEXIMIN's numbers value by value (both solve the same LPs with HiGHS on
  the host, and their statistics differ by float32 summation order only,
  ``F32_TOL``);
- XMIN's within ``XMIN_TOL``: each package grows its portfolio from its own
  random draws, and each holds its allocation within ``xmin_linf_band`` of
  the same leximin values;
- LEGACY statistically: the two packages draw from different random streams.
  Every bound is stated where it is used, from the sampling noise of
  ``DRAWS`` draws.

A cache written by either package is read by the other without
recomputing.
"""

import csv
import math
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import citizensassemblies_tpu.analysis.cache as jcache
import citizensassemblies_tpu.ops.intersections as jint
from citizensassemblies_tpu.analysis.report import analyze_instance as j_analyze
from citizensassemblies_tpu.core.generator import cross_product_instance as j_cross
from citizensassemblies_tpu.core.instance import featurize as j_featurize
from citizensassemblies_tpu.utils.config import default_config as j_default

import citizensassemblies_tpu_torch.analysis.cache as tcache
from citizensassemblies_tpu_torch.analysis.cache import (
    AlgorithmRun,
    run_legacy_or_retrieve,
    run_leximin_or_retrieve,
)
from citizensassemblies_tpu_torch.analysis.cli import main
from citizensassemblies_tpu_torch.analysis.report import analyze_instance
from citizensassemblies_tpu_torch.core.generator import (
    cross_product_instance,
    sf_e_schema_instance,
    write_instance_csvs,
)
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.ops.intersections import DIFF_PAIRS
from citizensassemblies_tpu_torch.utils.config import default_config

# many small ops: intra-op threads would only contend with the other test
# workers for the cores
torch.set_num_threads(1)

DRAWS = 500
F32_TOL = 1e-6
#: both XMIN allocations lie within the band of the same leximin values
XMIN_TOL = 2 * default_config().xmin_linf_band
#: the statistics.txt labels whose lines carry no LEGACY number
EXACT_LABELS = (
    "instance:", "pool size n:", "panel size k:", "# quota categories:",
    "mean selection probability k/n:", "LEXIMIN minimum probability (exact):",
    "XMIN minimum probability (exact):", "LEXIMIN number of unique panels possible:",
    "XMIN number of unique panels possible:", "gini coefficient of LEXIMIN:",
    "gini coefficient of XMIN:", "geometric mean of LEXIMIN:", "geometric mean of XMIN:",
)


def _tiny(gen):
    # n=24, k=4: two binary categories, loose quotas — fast exact LEXIMIN
    return gen(
        categories=["gender", "age"],
        features=[["f", "m"], ["young", "old"]],
        quotas=[[(1, 3), (1, 3)], [(1, 3), (1, 3)]],
        counts=[6, 6, 6, 6],
        k=4,
        name="tiny_4",
    )


@pytest.fixture(scope="module")
def tiny_instance():
    return _tiny(cross_product_instance)


@pytest.fixture(scope="module")
def fast_cfg():
    return default_config().replace(mc_iterations=DRAWS, mc_batch=512)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Each package's ``analyze_instance`` on tiny_4, with its own output
    and cache directories: ``{"jax"|"port": (result, out_dir, cache_dir)}``."""
    root = tmp_path_factory.mktemp("both")
    runs = {}
    for tag, analyze, inst, cfg, kw in (
        ("jax", j_analyze, _tiny(j_cross), j_default(), {}),
        ("port", analyze_instance, _tiny(cross_product_instance), default_config(),
         {"device": "cpu"}),
    ):
        out, cache = root / tag / "analysis", root / tag / "distributions"
        res = analyze(
            inst, out_dir=out, cache_dir=cache, skip_timing=True,
            cfg=cfg.replace(mc_iterations=DRAWS, mc_batch=512), echo=False, **kw,
        )
        runs[tag] = (res, out, cache)
        assert res.statistics_path == out / "tiny_4_statistics.txt"
    return runs


def _lines(path):
    return path.read_text(encoding="utf-8").splitlines()


def _label(line):
    return line.split("\t")[0]


# --- the cache ---------------------------------------------------------------


def test_cache_roundtrip(tiny_instance, fast_cfg, tmp_path):
    dense, _ = featurize(tiny_instance, device="cpu")
    run1 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                  device="cpu")
    assert (tmp_path / "tiny_4_legacy_first.pickle").exists()
    assert not (tmp_path / "tiny_4_legacy_first.pickle.tmp").exists()
    with mock.patch.object(tcache, "legacy_probabilities", side_effect=AssertionError("recomputed")):
        run2 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                      device="cpu")
    np.testing.assert_array_equal(run1.allocation, run2.allocation)
    assert run1.unique_panels == run2.unique_panels

    # payload is plain numpy and Python, reloadable without torch's classes
    with open(tmp_path / "tiny_4_legacy_first.pickle", "rb") as fh:
        payload = pickle.load(fh)
    assert set(payload) >= {"algorithm", "allocation", "unique_panels", "pair_matrix"}
    for key in ("allocation", "pair_matrix"):
        assert type(payload[key]) is np.ndarray and payload[key].dtype == np.float64
    assert not any(isinstance(v, torch.Tensor) for v in payload.values())
    rt = AlgorithmRun.from_payload(payload)
    np.testing.assert_array_equal(rt.allocation, run1.allocation)


def test_cache_invalidated_on_config_change(tiny_instance, fast_cfg, tmp_path):
    dense, _ = featurize(tiny_instance, device="cpu")
    run1 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                  device="cpu")
    assert run1.num_draws == DRAWS
    # a different --mc-iterations must recompute, not silently reuse the cache
    run2 = run_legacy_or_retrieve(
        dense, name="tiny", k=4, cache_dir=tmp_path,
        cfg=fast_cfg.replace(mc_iterations=200), device="cpu",
    )
    assert run2.num_draws == 200
    assert abs(run2.allocation.sum() - 4) < 1e-6


def test_corrupt_cache_recomputes(tiny_instance, fast_cfg, tmp_path):
    dense, _ = featurize(tiny_instance, device="cpu")
    run1 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                  device="cpu")
    path = tmp_path / "tiny_4_legacy_first.pickle"
    path.write_bytes(b"\x80truncated")  # a crash mid-write of older code
    run2 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                  device="cpu")
    np.testing.assert_array_equal(run1.allocation, run2.allocation)
    # and the repaired cache is loadable again
    run3 = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path, cfg=fast_cfg,
                                  device="cpu")
    np.testing.assert_array_equal(run2.allocation, run3.allocation)


def test_households_change_cache_key(tiny_instance, fast_cfg, tmp_path):
    dense, _ = featurize(tiny_instance, device="cpu")
    baseline = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path,
                                      cfg=fast_cfg, device="cpu")
    h = np.repeat(np.arange(12), 2).astype(np.int32)  # 12 households of 2
    constrained = run_legacy_or_retrieve(dense, name="tiny", k=4, cache_dir=tmp_path,
                                         cfg=fast_cfg, households=h, device="cpu")
    # the constrained run must NOT be served from the unconstrained cache
    for panel in constrained.unique_panels:
        assert len(set(h[list(panel)])) == len(panel)
    assert not np.array_equal(baseline.allocation, constrained.allocation)
    with open(tmp_path / "tiny_4_legacy_first.pickle", "rb") as fh:
        key = pickle.load(fh)["config_key"]
    assert key == jcache._config_key(j_default().replace(mc_iterations=DRAWS, mc_batch=512),
                                     "legacy", h)


def test_leximin_cached_allocation_sums_to_k(tiny_instance, fast_cfg, tmp_path):
    dense, space = featurize(tiny_instance, device="cpu")
    run = run_leximin_or_retrieve(dense, space, name="tiny", k=4,
                                  cache_dir=tmp_path, cfg=fast_cfg, device="cpu")
    assert abs(run.allocation.sum() - 4) < 1e-3
    # every supported panel satisfies quotas
    for panel in run.unique_panels:
        x = np.zeros(dense.n, dtype=np.float64)
        x[list(panel)] = 1.0
        counts = dense.A_np.T @ x
        assert (counts >= dense.qmin_np).all()
        assert (counts <= dense.qmax_np).all()
    # the pair matrix: symmetric, zero diagonal, rows summing to (k−1)·π
    M = run.pair_matrix
    np.testing.assert_array_equal(M, M.T)
    assert not np.diag(M).any()
    np.testing.assert_allclose(M.sum(axis=1), 3 * run.allocation, atol=1e-5)


#: the solver each cached pass calls on a miss
_SOLVERS = {"legacy_first": "legacy_probabilities", "leximin": "find_distribution_leximin",
            "xmin": "find_distribution_xmin"}


@pytest.mark.parametrize("tag", list(_SOLVERS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_reads_across_packages(both, writer, tag):
    """A pickle written by one package is served by the other with its
    solver patched to raise: the same file layout, payload and key."""
    cache = both[writer][2]
    written = pickle.loads((cache / f"tiny_4_{tag}.pickle").read_bytes())
    if writer == "jax":  # the port reads
        mod, cfg, kw = tcache, default_config(), {"device": "cpu"}
        dense, space = featurize(_tiny(cross_product_instance), device="cpu")
    else:
        mod, cfg, kw = jcache, j_default(), {}
        dense, space = j_featurize(_tiny(j_cross))
    kw.update(name="tiny", k=4, cache_dir=cache, cfg=cfg.replace(mc_iterations=DRAWS, mc_batch=512))
    with mock.patch.object(mod, _SOLVERS[tag], side_effect=AssertionError("recomputed")):
        if tag == "legacy_first":
            run = mod.run_legacy_or_retrieve(dense, **kw)
        else:
            run = getattr(mod, f"run_{tag}_or_retrieve")(dense, space, **kw)
    np.testing.assert_array_equal(run.allocation, written["allocation"])
    np.testing.assert_array_equal(run.pair_matrix, written["pair_matrix"])
    assert run.unique_panels == set(map(tuple, written["unique_panels"]))
    assert (run.num_draws, run.contract_ok) == (written["num_draws"], written["contract_ok"])


# --- analyze_instance against the JAX package ----------------------------------


def test_report_layout_matches(both):
    """statistics.txt: the same lines in the same order; every line that
    carries no LEGACY number reads the same."""
    # the figure lines name each package's own output directory
    jl, tl = (
        [x.replace(str(both[tag][1]), "OUT") for x in _lines(both[tag][0].statistics_path)]
        for tag in ("jax", "port")
    )
    assert [_label(x) for x in tl] == [_label(x) for x in jl]
    for a, b in zip(tl, jl):
        if _label(a) in EXACT_LABELS:
            assert a == b
        elif "realization contract" in a:
            # the status word; the deviation is XMIN's own portfolio's
            assert a.split("\t")[1].split(" ")[0] == b.split("\t")[1].split(" ")[0] == "satisfied"
    text = "\n".join(tl)
    # fork statistics.txt layout (analysis/example_small_20_statistics.txt)
    for needle in [
        "instance:\ttiny",
        "pool size n:\t24",
        "panel size k:\t4",
        "# quota categories:\t2",
        "LEGACY minimum probability:",
        "LEXIMIN minimum probability (exact):",
        "XMIN minimum probability (exact):",
        "LEGACY number of unique panels seen:",
        "gini coefficient of XMIN:",
        "geometric mean of LEGACY:",
        "share selected by LEGACY with probability below LEXIMIN",
        "Skip timing.",
    ]:
        assert needle in text, f"missing line: {needle}"


def test_outputs_and_csv_headers(both):
    res, out, _ = both["port"]
    stem = "tiny_4"
    for suffix in [
        "_prob_allocs.pdf",
        "_prob_allocs_data.csv",
        "_pair_probability_graph.pdf",
        "_number_of_unique_panels.pdf",
        "_ratio_product.pdf",
        "_ratio_product_data.csv",
    ]:
        assert (out / f"{stem}{suffix}").exists(), f"missing output {suffix}"
    jout = both["jax"][1]
    for name, header in (
        ("_prob_allocs_data.csv", ["algorithm", "percentile of pool members",
                                   "selection probability"]),
        ("_ratio_product_data.csv", ["ratio product", "selection probability"]),
    ):
        with open(out / f"{stem}{name}", encoding="utf-8") as fh:
            rows = list(csv.reader(fh))
        with open(jout / f"{stem}{name}", encoding="utf-8") as fh:
            jrows = list(csv.reader(fh))
        assert rows[0] == jrows[0] == header
        assert len(rows) == len(jrows)
        if name == "_prob_allocs_data.csv":
            # LEXIMIN's rows are the same allocation's, rounded alike
            assert [r for r in rows if r[0] == "LEXIMIN"] == [r for r in jrows if r[0] == "LEXIMIN"]
        else:
            np.testing.assert_allclose([float(r[0]) for r in rows[1:]],
                                       [float(r[0]) for r in jrows[1:]], rtol=F32_TOL)


def test_exact_statistics_match(both):
    j, t = both["jax"][0], both["port"][0]
    np.testing.assert_array_equal(t.runs["leximin"].allocation, j.runs["leximin"].allocation)
    assert t.runs["leximin"].unique_panels == j.runs["leximin"].unique_panels
    np.testing.assert_allclose(t.runs["leximin"].pair_matrix, j.runs["leximin"].pair_matrix,
                               atol=F32_TOL)
    assert t.runs["leximin"].realization_dev == pytest.approx(j.runs["leximin"].realization_dev,
                                                              abs=F32_TOL)
    for field in ("gini", "geometric_mean", "min"):
        assert abs(t.stats["leximin"][field] - j.stats["leximin"][field]) <= F32_TOL, field
        assert abs(t.stats["xmin"][field] - j.stats["xmin"][field]) <= XMIN_TOL, field
    np.testing.assert_allclose(t.runs["xmin"].allocation, j.runs["xmin"].allocation,
                               atol=XMIN_TOL)
    # XMIN grows LEXIMIN's support by xmin_iterations_factor·n new panels
    assert t.runs["xmin"].num_draws == j.runs["xmin"].num_draws
    assert len(t.runs["xmin"].unique_panels) == len(j.runs["xmin"].unique_panels)
    for res in (j, t):
        assert res.runs["leximin"].contract_ok and res.runs["xmin"].contract_ok
        assert res.stats["leximin"]["min"] >= res.stats["legacy"]["min"] - 1e-6
    assert t.intersection_mses is None and t.timing_median_s is None


def test_legacy_statistics_agree(both):
    """LEGACY from two random streams. On tiny_4 every agent's LEGACY
    probability is p = k/n by symmetry, so a DRAWS-draw estimate has noise
    σ = √(p(1−p)/DRAWS) per agent, the difference of two estimates √2·σ."""
    j, t = both["jax"][0], both["port"][0]
    n, k = 24, 4
    p = k / n
    sigma = math.sqrt(p * (1 - p) / DRAWS)
    for tag in ("legacy",):
        ja, ta = j.runs[tag].allocation, t.runs[tag].allocation
        assert ta.sum() == pytest.approx(k) and ta.shape == ja.shape == (n,)
        # each agent within 4 standard deviations of the difference
        pbar = (ja + ta) / 2
        assert (np.abs(ta - ja) <= 4 * np.sqrt(2 * pbar * (1 - pbar) / DRAWS)).all()
        # the second sample's unique panels: duplicate counts are about
        # Poisson, so their difference is within 4·√(dup_j + dup_t)
        dup_j, dup_t = DRAWS - len(j.runs[tag].unique_panels), DRAWS - len(t.runs[tag].unique_panels)
        assert abs(dup_t - dup_j) <= 4 * math.sqrt(dup_j + dup_t + 1)
    for res in (j, t):
        g = res.stats["legacy"]
        # pure noise: the Gini of n values of spread σ around μ = p is about
        # σ/(μ√π); each within twice that
        assert 0.0 <= g["gini"] <= 2 * sigma / (p * math.sqrt(math.pi))
        # the geometric mean of p·(1 + noise) is about p·exp(−σ²/2p²), its
        # log's noise σ/(p√n): each within 4 of those of the expectation
        expect = p * math.exp(-(sigma ** 2) / (2 * p ** 2))
        assert abs(g["geometric_mean"] - expect) <= 4 * expect * sigma / (p * math.sqrt(n))
    assert abs(t.stats["legacy"]["min"] - j.stats["legacy"]["min"]) <= 4 * math.sqrt(2) * sigma
    # the Jeffreys bound moves with the minimizer's second-sample estimate
    assert abs(t.minimizer_ucb - j.minimizer_ucb) <= 4 * math.sqrt(2) * sigma
    # a share of n agents near the LEXIMIN minimum (a knife edge at p)
    assert abs(t.share_below_leximin_min - j.share_below_leximin_min) <= 4 * math.sqrt(0.5 / n)


def test_rerun_hits_cache(both, tiny_instance, fast_cfg):
    res, out, cache = both["port"]
    with mock.patch.object(tcache, "legacy_probabilities", side_effect=AssertionError), \
            mock.patch.object(tcache, "find_distribution_leximin", side_effect=AssertionError), \
            mock.patch.object(tcache, "find_distribution_xmin", side_effect=AssertionError):
        again = analyze_instance(tiny_instance, out_dir=out, cache_dir=cache, skip_timing=True,
                                 cfg=fast_cfg, echo=False, device="cpu")
    assert again.stats == res.stats
    assert again.minimizer_ucb == res.minimizer_ucb


@pytest.mark.parametrize("entry", ["analyze_instance", "cli"])
def test_entry_points_default_to_cuda(entry, tiny_instance, fast_cfg, tmp_path):
    """No device named: CUDA, which this CPU-only build lacks, so both raise
    before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "analyze_instance":
            analyze_instance(tiny_instance, out_dir=tmp_path, cache_dir=None, skip_timing=True,
                             cfg=fast_cfg, echo=False)
        else:
            write_instance_csvs(tiny_instance, tmp_path / "data" / "tiny_4")
            main(["tiny", "4", "--data-dir", str(tmp_path / "data"), "--no-cache",
                  "--out-dir", str(tmp_path / "analysis"), "--skiptiming"])
    assert not (tmp_path / "analysis").exists()


# --- intersections through the report ------------------------------------------


def test_analyze_instance_emits_mse_lines(tmp_path):
    """``analyze_instance`` picks up an intersections.csv and writes the 7
    golden-format ``MSE(...)\\t...`` lines + the jointplot (C21 through C22,
    reference ``analysis.py:615-619``); its MSEs are the JAX package's
    ``intersection_mses`` of the same allocations."""
    inst = sf_e_schema_instance(n=120, k=24)
    # a miniature intersections file in the reference schema, over features
    # guaranteed present in the pool
    path = tmp_path / "intersections.csv"
    with open(path, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(["category 1", "feature 1", "category 2", "feature 2",
                    "population share"])
        w.writerow(["a", "a1", "b", "b1", "0.12"])
        w.writerow(["a", "a2", "b", "b2", "0.08"])
        w.writerow(["f", "f1", "g", "g2", "0.25"])

    cfg = default_config().replace(
        mc_iterations=300, mc_batch=256, xmin_iterations_factor=1,
        xmin_qp_iters=2_000,
    )
    result = analyze_instance(
        inst, out_dir=tmp_path / "analysis", cache_dir=None,
        intersections_path=path, skip_timing=True, cfg=cfg, echo=False, device="cpu",
    )
    assert result.intersection_mses is not None
    assert list(result.intersection_mses) == list(DIFF_PAIRS)

    stem = f"{inst.name}_{inst.k}"
    stats = (tmp_path / "analysis" / f"{stem}_statistics.txt").read_text(encoding="utf-8")
    for s1, s2 in DIFF_PAIRS:
        # golden line format has no colon (sf_e_110_statistics.txt:15-21)
        assert f"MSE({s1}, {s2})\t{result.intersection_mses[(s1, s2)]:.2e}" in stats, (s1, s2)
    assert (tmp_path / "analysis" / f"{stem}_intersections.pdf").exists()

    # LEGACY's first sample is not kept on the result: the LEXIMIN pairs,
    # whose inputs it carries, through the JAX package's functions
    from citizensassemblies_tpu.core.generator import sf_e_schema_instance as j_schema

    jd, jspace = j_featurize(j_schema(n=120, k=24))
    leximin_pairs = [pair for pair in DIFF_PAIRS if "LEGACY" not in "".join(pair)]
    shares = jint.intersection_shares(
        jint.read_intersections(path, jd, jspace), 24,
        {"LEXIMIN": result.runs["leximin"].allocation},
    )
    want = jint.intersection_mses(shares, leximin_pairs)
    assert len(want) == 3
    for pair, mse in want.items():
        assert result.intersection_mses[pair] == pytest.approx(mse, rel=1e-5, abs=1e-12), pair


# --- the CLI -----------------------------------------------------------------------


def test_cli_generate_and_analyze(tmp_path, monkeypatch):
    data = tmp_path / "data"
    # --generate writes the example datasets (reference data/generate_examples),
    # byte for byte the JAX package's
    assert main(["--generate", "--data-dir", str(data)]) == 0
    from citizensassemblies_tpu.analysis.cli import main as j_main

    assert j_main(["--generate", "--data-dir", str(tmp_path / "jax")]) == 0
    for d in ("example_small_20", "example_large_200"):
        for f in ("categories.csv", "respondents.csv"):
            assert (data / d / f).read_bytes() == (tmp_path / "jax" / d / f).read_bytes()

    # drive a real analysis over a *small custom* instance for speed
    tiny = cross_product_instance(
        categories=["g"], features=[["a", "b"]], quotas=[[(1, 3), (1, 3)]],
        counts=[8, 8], k=4, name="mini_4",
    )
    write_instance_csvs(tiny, data / "mini_4")
    monkeypatch.chdir(tmp_path)
    rc = main([
        "mini", "4", "--skiptiming", "--data-dir", str(data),
        "--out-dir", str(tmp_path / "analysis"),
        "--cache-dir", str(tmp_path / "distributions"),
        "--mc-iterations", "300", "--device", "cpu",
    ])
    assert rc == 0
    assert (tmp_path / "analysis" / "mini_4_statistics.txt").exists()
    assert len(list((tmp_path / "distributions").glob("mini_4_*.pickle"))) == 4


def test_cli_rejects_missing_instance(tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["nope", "9", "--data-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["nope", "9", "--device", "tpu"])
    assert "invalid choice: 'tpu'" in capsys.readouterr().err


def test_cli_address_columns_households(tmp_path, monkeypatch):
    """--address-columns drives the reference's check_same_address capability
    end-to-end: no emitted panel contains two members of the same household."""
    data = tmp_path / "data" / "mini_4"
    data.mkdir(parents=True)
    with open(data / "categories.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["category", "feature", "min", "max"])
        for f, lo, hi in (("a", 1, 3), ("b", 1, 3)):
            w.writerow(["g", f, lo, hi])
    with open(data / "respondents.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["g", "address"])
        for i in range(16):
            w.writerow(["a" if i < 8 else "b", f"house{i // 2}"])  # pairs share
    monkeypatch.chdir(tmp_path)
    rc = main([
        "mini", "4", "--skiptiming", "--data-dir", str(tmp_path / "data"),
        "--out-dir", str(tmp_path / "analysis"),
        "--cache-dir", str(tmp_path / "distributions"), "--mc-iterations", "200",
        "--address-columns", "address", "--device", "cpu",
    ])
    assert rc == 0
    assert (tmp_path / "analysis" / "mini_4_statistics.txt").exists()

    # the constraint on every cached distribution's panels
    hh = np.repeat(np.arange(8), 2)
    for tag in ("legacy_first", "legacy_second", "leximin", "xmin"):
        payload = pickle.loads((tmp_path / "distributions" / f"mini_4_{tag}.pickle").read_bytes())
        assert payload["config_key"]["households"] is not None
        for panel in payload["unique_panels"]:
            assert len(set(hh[list(panel)].tolist())) == len(panel), (tag, panel)
