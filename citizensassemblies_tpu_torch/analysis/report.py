"""The ``analyze_instance`` orchestrator (reference ``analysis.py:533-636``).

Runs the four cached algorithm passes (LEGACY twice with seeds 0/1, LEXIMIN,
XMIN), computes every statistic the reference reports, tees them to console and
``<out_dir>/<name>_<k>_statistics.txt`` in the fork's layout (asterisk-ruled
sections, ``analysis/example_small_20_statistics.txt``), renders all five
plots, and finally times three fresh LEXIMIN runs and reports the median
(``analysis.py:625-634``) unless ``skip_timing``. Every pass and every
statistic runs on the device the caller names (CUDA unless the caller asks
for the CPU); the timed runs end in ``torch.cuda.synchronize()`` on CUDA, so
the median is the card's wall-clock.

Two fork bugs noted in SURVEY §2 are fixed here: the XMIN geometric-mean line
prints the XMIN value (the fork printed LEXIMIN's, ``analysis.py:598``), and
the probability-allocation figure is saved as ``_prob_allocs.pdf`` with its
raw-data CSV restored (the fork saved ``_prob_allocs_data.pdf`` and no CSV,
``analysis.py:406``).
"""

from __future__ import annotations

import dataclasses
import statistics as pystats
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from citizensassemblies_tpu_torch.analysis.cache import (
    AlgorithmRun,
    run_legacy_or_retrieve,
    run_leximin_or_retrieve,
    run_xmin_or_retrieve,
)
from citizensassemblies_tpu_torch.analysis import plots
from citizensassemblies_tpu_torch.core.instance import Instance, featurize, validate_quotas
from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
from citizensassemblies_tpu_torch.ops.intersections import (
    intersection_mses,
    intersection_shares,
    read_intersections,
)
from citizensassemblies_tpu_torch.ops.ratio import compute_ratio_products
from citizensassemblies_tpu_torch.ops.stats import (
    prob_allocation_stats,
    share_below,
    upper_confidence_bound,
)
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog, tee_file

_RULE = "*" * 80


def _percent(v: float) -> str:
    """Reference percent formatting (``analysis.py:547``-style ``{:.1%}``)."""
    return f"{v:.1%}"


@dataclasses.dataclass
class AnalysisResult:
    """Everything ``analyze_instance`` computed, for programmatic consumers."""

    runs: Dict[str, AlgorithmRun]
    stats: Dict[str, dict]
    minimizer_ucb: float
    share_below_leximin_min: float
    intersection_mses: Optional[Dict] = None
    timing_median_s: Optional[float] = None
    statistics_path: Optional[Path] = None


def analyze_instance(
    instance: Instance,
    out_dir: Union[str, Path] = "analysis",
    cache_dir: Optional[Union[str, Path]] = "distributions",
    intersections_path: Optional[Union[str, Path]] = None,
    skip_timing: bool = False,
    cfg: Optional[Config] = None,
    echo: bool = True,
    households=None,
    device: DeviceLike = None,
) -> AnalysisResult:
    """Full analysis pass over one instance (``analysis.py:533-636``).

    ``households`` (int32[n] group ids, from
    :func:`~citizensassemblies_tpu_torch.core.instance.compute_households`) enables
    the reference's ``check_same_address`` capability end-to-end: at most one
    member per household in every panel, in all four algorithm passes (the
    reference carries the flag through its uniform signature,
    ``leximin.py:338-341``, though its own analysis always passes False).
    ``device``: where the passes and the statistics run, CUDA unless the
    caller passes another; raises when CUDA is absent and no device was
    passed.
    """
    cfg = cfg or default_config()
    dev = resolve_device(device)
    dense, space = featurize(instance, device=dev)
    validate_quotas(instance)  # quota sanity asserts (analysis.py:174-176)
    n, k = dense.n, dense.k
    # the directory stem is <name>_<k>; the report's "instance:" line strips
    # the trailing _<k> (reference statistics.txt line 1)
    name = instance.name or "instance"
    stem = name if name.endswith(f"_{k}") else f"{name}_{k}"
    base = stem[: -len(f"_{k}")] if stem.endswith(f"_{k}") else stem

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stats_path = out_dir / f"{stem}_statistics.txt"

    with tee_file(stats_path, echo=echo) as log:
        # --- four cached algorithm passes (analysis.py:536-543) -------------
        legacy_first = run_legacy_or_retrieve(dense, name=base, k=k, resample=False,
                                              cache_dir=cache_dir, cfg=cfg,
                                              households=households, device=dev)
        legacy_second = run_legacy_or_retrieve(dense, name=base, k=k, resample=True,
                                               cache_dir=cache_dir, cfg=cfg,
                                               households=households, device=dev)
        leximin = run_leximin_or_retrieve(dense, space, name=base, k=k,
                                          cache_dir=cache_dir, cfg=cfg,
                                          households=households, device=dev)
        xmin = run_xmin_or_retrieve(dense, space, name=base, k=k,
                                    cache_dir=cache_dir, cfg=cfg,
                                    households=households, device=dev)
        # the reference plots the *second* (seed-1) LEGACY sample and reports
        # its unique-panel count (analysis.py:575-589,604-607), while stats,
        # share-below, ratio and intersections use the first (:548,600,612,615)
        runs = {"legacy": legacy_second, "leximin": leximin, "xmin": xmin}

        # --- headline stats (analysis.py:548-602) ----------------------------
        st = {
            "legacy": dataclasses.asdict(
                prob_allocation_stats(legacy_first.allocation, cap_for_geometric_mean=True,
                                      device=dev)
            ),
            "leximin": dataclasses.asdict(
                prob_allocation_stats(leximin.allocation, cap_for_geometric_mean=False,
                                      device=dev)
            ),
            "xmin": dataclasses.asdict(
                prob_allocation_stats(xmin.allocation, cap_for_geometric_mean=False,
                                      device=dev)
            ),
        }

        # minimizer cross-validation: argmin over sample 1, unbiased estimate
        # from sample 2, Jeffreys 99% UCB (analysis.py:564-571)
        minimizer = int(np.argmin(legacy_first.allocation))
        resampled_prob = float(legacy_second.allocation[minimizer])
        # trial count comes from the cached run itself, not the live config —
        # a cache produced under a different --mc-iterations must not tighten
        # the confidence bound
        num_trials = legacy_second.num_draws or cfg.mc_iterations
        ucb = upper_confidence_bound(num_trials, resampled_prob)

        frac_below = float(
            share_below(
                torch.as_tensor(legacy_first.allocation, dtype=torch.float32, device=dev),
                st["leximin"]["min"],
            )
        )

        log.log("instance:", base)
        log.log("pool size n:", n)
        log.log("panel size k:", k)
        log.log("# quota categories:", dense.n_categories)
        log.log("mean selection probability k/n:", _percent(k / n))
        log.log(_RULE)
        log.log(
            "LEGACY minimum probability:",
            f"≤ {resampled_prob if ucb == 1.0 else ucb:.2%} (99% upper confidence bound "
            f"based on Jeffreys interval for a binomial parameter, calculated from sample "
            f"proportion {resampled_prob:.4f} and sample size {num_trials:,})",
        )
        log.log("LEXIMIN minimum probability (exact):", _percent(st["leximin"]["min"]))
        log.log("XMIN minimum probability (exact):", _percent(st["xmin"]["min"]))
        log.log(_RULE)
        log.log("LEGACY number of unique panels seen:", len(legacy_second.unique_panels))
        log.log("LEXIMIN number of unique panels possible:", len(leximin.unique_panels))
        log.log("XMIN number of unique panels possible:", len(xmin.unique_panels))
        log.log(_RULE)
        log.log("gini coefficient of LEGACY:", _percent(st["legacy"]["gini"]))
        log.log("gini coefficient of LEXIMIN:", _percent(st["leximin"]["gini"]))
        log.log("gini coefficient of XMIN:", _percent(st["xmin"]["gini"]))
        log.log(_RULE)
        log.log("geometric mean of LEGACY:", _percent(st["legacy"]["geometric_mean"]))
        log.log("geometric mean of LEXIMIN:", _percent(st["leximin"]["geometric_mean"]))
        log.log("geometric mean of XMIN:", _percent(st["xmin"]["geometric_mean"]))
        log.log(_RULE)
        log.log(
            "share selected by LEGACY with probability below LEXIMIN minimum "
            "selection probability:",
            _percent(frac_below),
        )
        # realization-contract status of the exact algorithms: a
        # budget-expired rescue ships contract_ok=False and ε-wide
        # probabilities, and the report must say so, not just output_lines
        log.log(_RULE)
        for tag in ("leximin", "xmin"):
            run = runs[tag]
            if run.contract_ok is None:
                continue
            status = (
                "satisfied"
                if run.contract_ok
                else "MISSED — per-agent probabilities exact only to the stated deviation"
            )
            log.log(
                f"{tag.upper()} realization contract (L-inf <= 1e-3):",
                f"{status} (max |alloc - certified profile| = "
                f"{run.realization_dev:.2e})",
            )

        # --- plots (analysis.py:578-619) -------------------------------------
        plots.plot_number_of_panels(
            {
                "legacy": len(legacy_second.unique_panels),
                "leximin": len(leximin.unique_panels),
                "xmin": len(xmin.unique_panels),
            },
            out_dir, stem,
        )
        plots.plot_pair_probability(
            {tag: run.pair_matrix for tag, run in runs.items()}, n, k, out_dir, stem
        )
        pdf = plots.plot_probability_allocations(
            {tag: run.allocation for tag, run in runs.items()}, out_dir, stem
        )
        log.log(f"Plot of probability allocation created at {pdf}.")
        ratio = compute_ratio_products(dense).cpu().numpy()
        pdf = plots.plot_ratio_products(ratio, legacy_first.allocation, out_dir, stem)
        log.log(f"Plot of ratio products created at {pdf}.")

        # --- intersectional representation (analysis.py:459-530) -------------
        mses = None
        if intersections_path is not None and Path(intersections_path).exists():
            table = read_intersections(intersections_path, dense, space)
            shares = intersection_shares(
                table, k,
                {"LEGACY": legacy_first.allocation, "LEXIMIN": leximin.allocation},
                device=dev,
            )
            mses = intersection_mses(shares)
            log.log(_RULE)
            # golden layout has no colon on these lines
            # (reference_output/sf_e_110_statistics.txt:15-21)
            for (s1, s2), mse in mses.items():
                log.log(f"MSE({s1}, {s2})", f"{mse:.2e}")
            plots.plot_intersectional_representation(shares, out_dir, stem)

        # --- timing harness (analysis.py:625-634) -----------------------------
        timing_median = None
        if skip_timing:
            log.log("Skip timing.")
        else:
            durations = []
            for _ in range(3):
                t0 = time.perf_counter()
                find_distribution_leximin(dense, space, cfg=cfg, log=RunLog(echo=False),
                                          households=households, device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                durations.append(time.perf_counter() - t0)
            timing_median = pystats.median(durations)
            log.log(
                # two decimals, not the reference's one: a sub-second median
                # would round to a meaningless "0.0 seconds"
                f"Out of 3 runs, LEXIMIN took a median running time of "
                f"{timing_median:.2f} seconds."
            )

    return AnalysisResult(
        runs=runs,
        stats=st,
        minimizer_ucb=ucb,
        share_below_leximin_min=frac_below,
        intersection_mses=mses,
        timing_median_s=timing_median,
        statistics_path=stats_path,
    )
