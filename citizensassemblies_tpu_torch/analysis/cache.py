"""Pickle memoization of algorithm runs (reference ``analysis.py:271-327``).

Each (instance, k, algorithm) result is cached as
``<cache_dir>/<name>_<k>_<tag>.pickle`` with tags ``legacy_first`` /
``legacy_second`` / ``leximin`` / ``xmin`` — the same file layout the reference
uses under ``./distributions/``. LEGACY runs twice with seeds 0 and 1
(``analysis.py:277-282``): the first sample locates the minimizer agent, the
second gives an unbiased estimate of that agent's probability
(``analysis.py:564-571``).

The cached payload is a plain dict of float64 numpy arrays, Python scalars
and lists, never a tensor, under the JAX package's keys and cache key: a
cache written by either package reads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path
from typing import List, Optional, Set, Tuple, Union

import numpy as np

from citizensassemblies_tpu_torch.core.instance import DenseInstance, FeatureSpace
from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities
from citizensassemblies_tpu_torch.models.leximin import Distribution, find_distribution_leximin
from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin
from citizensassemblies_tpu_torch.ops.pairs import pair_matrix_from_portfolio
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.logging import RunLog


@dataclasses.dataclass
class AlgorithmRun:
    """The (allocation, unique panels, pair matrix) triple every
    ``*_probabilities`` adapter returns (``analysis.py:162,194,213``)."""

    algorithm: str  # "legacy" | "leximin" | "xmin"
    allocation: np.ndarray  # float64[n] per-agent selection probability
    unique_panels: Set[Tuple[int, ...]]
    pair_matrix: np.ndarray  # float64[n, n] pair co-selection probabilities
    output_lines: List[str]
    #: number of Monte-Carlo draws (LEGACY) or committees in support (others)
    num_draws: int = 0
    #: the exact algorithms' realization-contract report (None for LEGACY):
    #: max |allocation − certified profile| and whether it met the 1e-3 L∞
    #: contract (``Distribution.contract_ok``); the statistics report states it.
    realization_dev: Optional[float] = None
    contract_ok: Optional[bool] = None

    def to_payload(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "allocation": np.asarray(self.allocation, dtype=np.float64),
            "unique_panels": sorted(self.unique_panels),
            "pair_matrix": np.asarray(self.pair_matrix, dtype=np.float64),
            "output_lines": list(self.output_lines),
            "num_draws": int(self.num_draws),
            "realization_dev": self.realization_dev,
            "contract_ok": self.contract_ok,
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "AlgorithmRun":
        return cls(
            algorithm=payload["algorithm"],
            allocation=np.asarray(payload["allocation"]),
            unique_panels=set(map(tuple, payload["unique_panels"])),
            pair_matrix=np.asarray(payload["pair_matrix"]),
            output_lines=list(payload["output_lines"]),
            num_draws=int(payload.get("num_draws", 0)),
            realization_dev=payload.get("realization_dev"),
            contract_ok=payload.get("contract_ok"),
        )


#: config fields that determine each algorithm's output — the cache key
#: includes them so a result computed under different settings is recomputed,
#: not silently reused (the reference's fixed-filename cache has this hazard)
_KEY_FIELDS = {
    "legacy": ("mc_iterations", "mc_batch", "mc_max_resample_rounds"),
    "leximin": (
        "eps", "fixed_prob_relax_step", "support_eps", "mw_rounds_factor",
        "pricing_batch", "seed_batch",
        "cg_columns_per_round", "max_portfolio", "pdhg_max_iters", "pdhg_tol",
        "backend", "solver_seed", "force_agent_space",
    ),
}
_KEY_FIELDS["xmin"] = _KEY_FIELDS["leximin"] + (
    "xmin_iterations_factor", "xmin_dedup_attempts_factor", "xmin_qp_iters",
)


def _config_key(cfg: Config, algorithm: str, households=None) -> dict:
    key = {f: getattr(cfg, f) for f in _KEY_FIELDS[algorithm]}
    # household constraints change every algorithm's output; key their digest
    # so constrained and unconstrained runs are never interchanged
    key["households"] = (
        None
        if households is None
        else hashlib.sha256(np.asarray(households, dtype=np.int64).tobytes()).hexdigest()
    )
    return key


def _cache_path(cache_dir: Union[str, Path], name: str, k: int, tag: str) -> Path:
    return Path(cache_dir) / f"{name}_{k}_{tag}.pickle"


def _load_or_compute(path: Optional[Path], compute, config_key: dict) -> AlgorithmRun:
    if path is not None and path.exists():
        try:
            with open(path, "rb") as fh:
                payload = pickle.load(fh)
        except Exception:
            payload = None  # corrupt/truncated cache ⇒ recompute, don't crash
        if payload is not None and payload.get("config_key") == config_key:
            return AlgorithmRun.from_payload(payload)
    run = compute()
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = run.to_payload()
        payload["config_key"] = config_key
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(payload, fh)
        os.replace(tmp, path)  # atomic: a crash mid-dump leaves no partial cache
    return run


def _run_from_distribution(
    algorithm: str, dist: Distribution, support_eps: float, device
) -> AlgorithmRun:
    probs = np.asarray(dist.probabilities, dtype=np.float64)
    keep = probs > support_eps  # reference filters the support (analysis.py:209)
    P = dist.committees[keep]
    # one n×n product on the device, brought back to the host once
    pair = pair_matrix_from_portfolio(P, probs[keep], device=device).cpu().numpy()
    return AlgorithmRun(
        algorithm=algorithm,
        allocation=np.asarray(dist.allocation, dtype=np.float64),
        unique_panels={tuple(np.nonzero(row)[0].tolist()) for row in P},
        pair_matrix=pair.astype(np.float64),
        output_lines=list(dist.output_lines),
        num_draws=int(keep.sum()),
        realization_dev=float(dist.realization_dev),
        contract_ok=bool(dist.contract_ok),
    )


def run_legacy_or_retrieve(
    dense: DenseInstance,
    name: str,
    k: int,
    resample: bool = False,
    cache_dir: Optional[Union[str, Path]] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> AlgorithmRun:
    """Monte-Carlo LEGACY estimate, memoized (``analysis.py:271-293``), drawn
    on ``device`` (CUDA unless the caller passes another).

    ``resample=False`` uses seed 0 (tag ``legacy_first``); ``resample=True``
    uses seed 1 (tag ``legacy_second``) for the unbiased minimizer estimate.
    """
    cfg = cfg or default_config()
    dev = resolve_device(device)
    seed = 1 if resample else 0
    tag = "legacy_second" if resample else "legacy_first"
    path = _cache_path(cache_dir, name, k, tag) if cache_dir is not None else None

    def compute() -> AlgorithmRun:
        res = legacy_probabilities(dense, iterations=cfg.mc_iterations, seed=seed, cfg=cfg,
                                   households=households, device=dev)
        run = AlgorithmRun(
            algorithm="legacy",
            allocation=res.allocation,
            unique_panels=res.unique_panels,
            pair_matrix=res.pair_matrix,
            output_lines=[],
            num_draws=cfg.mc_iterations,
        )
        assert abs(run.allocation.sum() - k) < 1e-6 * k + 1e-6  # analysis.py:292
        return run

    return _load_or_compute(path, compute, _config_key(cfg, "legacy", households))


def run_leximin_or_retrieve(
    dense: DenseInstance,
    space: FeatureSpace,
    name: str,
    k: int,
    cache_dir: Optional[Union[str, Path]] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> AlgorithmRun:
    """Exact LEXIMIN distribution, memoized (``analysis.py:313-327``),
    solved on ``device`` (CUDA unless the caller passes another)."""
    cfg = cfg or default_config()
    dev = resolve_device(device)
    path = _cache_path(cache_dir, name, k, "leximin") if cache_dir is not None else None

    def compute() -> AlgorithmRun:
        dist = find_distribution_leximin(
            dense, space, cfg=cfg, households=households, log=RunLog(echo=False), device=dev
        )
        run = _run_from_distribution("leximin", dist, cfg.support_eps, dev)
        assert abs(run.allocation.sum() - k) < 1e-4 * k + 1e-4  # analysis.py:326
        return run

    return _load_or_compute(path, compute, _config_key(cfg, "leximin", households))


def run_xmin_or_retrieve(
    dense: DenseInstance,
    space: FeatureSpace,
    name: str,
    k: int,
    cache_dir: Optional[Union[str, Path]] = None,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> AlgorithmRun:
    """XMIN distribution, memoized (``analysis.py:296-310``), solved on
    ``device`` (CUDA unless the caller passes another)."""
    cfg = cfg or default_config()
    dev = resolve_device(device)
    path = _cache_path(cache_dir, name, k, "xmin") if cache_dir is not None else None

    def compute() -> AlgorithmRun:
        dist = find_distribution_xmin(
            dense, space, cfg=cfg, households=households, log=RunLog(echo=False), device=dev
        )
        run = _run_from_distribution("xmin", dist, cfg.support_eps, dev)
        assert abs(run.allocation.sum() - k) < 1e-4 * k + 1e-4  # analysis.py:309
        return run

    return _load_or_compute(path, compute, _config_key(cfg, "xmin", households))
