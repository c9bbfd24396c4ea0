"""Plotting suite (reference ``analysis.py:330-456`` + jointplot ``:519-528``).

Five figures + two raw-data CSVs, written to ``<out_dir>/`` with the upstream
filename conventions:

* ``<stem>_prob_allocs.pdf`` + ``<stem>_prob_allocs_data.csv`` — sorted
  per-agent selection probabilities per algorithm (``analysis.py:381-408``),
  the CSV in the upstream ``algorithm,percentile of pool members,selection
  probability`` schema.
* ``<stem>_pair_probability_graph.pdf`` — sorted pair co-selection
  probabilities per algorithm plus the uniform C(n,2) baseline
  (``analysis.py:330-353``).
* ``<stem>_number_of_unique_panels.pdf`` — bar chart of unique-panel counts
  (``analysis.py:356-378``).
* ``<stem>_ratio_product.pdf`` + ``<stem>_ratio_product_data.csv`` — feature
  over-representation ratio products vs LEGACY probability
  (``analysis.py:434-456``).
* ``<stem>_intersections.pdf`` — seaborn jointplot of intersectional panel
  shares vs population shares (``analysis.py:519-528``).

The writers take host arrays. Matplotlib (Agg backend, no display) is
imported at the first figure, never when this module is imported, and each
CSV is written before it: without matplotlib the package still imports and
a figure writer raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from citizensassemblies_tpu_torch.ops.pairs import sorted_pair_values, uniform_pair_value

#: display names per algorithm tag (reference legend labels, ``analysis.py:399``)
_LABELS = {"legacy": "Legacy", "leximin": "LEXIMIN", "xmin": "XMIN"}


def _label(tag: str) -> str:
    return _LABELS.get(tag, tag)


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("the analysis figures need matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_probability_allocations(
    allocations: Dict[str, np.ndarray],
    out_dir: Union[str, Path],
    stem: str,
) -> Path:
    """Sorted selection-probability curves + raw-data CSV
    (``analysis.py:381-408``; CSV schema from
    ``reference_output/example_small_20_prob_allocs_data.csv:1``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pdf_path = out_dir / f"{stem}_prob_allocs.pdf"
    csv_path = out_dir / f"{stem}_prob_allocs_data.csv"

    curves = []
    with open(csv_path, "w", encoding="utf-8", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["algorithm", "percentile of pool members", "selection probability"])
        for tag, alloc in allocations.items():
            alloc = np.sort(np.asarray(alloc, dtype=np.float64))
            n = alloc.shape[0]
            pct = 100.0 * np.arange(n) / n
            curves.append((tag, pct, alloc))
            for p, a in zip(pct, alloc):
                writer.writerow([_label(tag), p, round(float(a), 4)])

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for tag, pct, alloc in curves:
        ax.plot(pct, alloc, label=_label(tag))
    ax.set_xlabel("percentile of pool members")
    ax.set_ylabel("selection probability")
    ax.set_ylim(bottom=0.0)
    ax.legend()
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)
    return pdf_path


def plot_pair_probability(
    pair_matrices: Dict[str, np.ndarray],
    n: int,
    k: int,
    out_dir: Union[str, Path],
    stem: str,
) -> Path:
    """Sorted pair co-selection probability curves + the uniform baseline
    ``k(k-1)/(n(n-1))`` over all C(n,2) pairs (``analysis.py:330-353``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pdf_path = out_dir / f"{stem}_pair_probability_graph.pdf"

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for tag, M in pair_matrices.items():
        vals = sorted_pair_values(M)
        pct = 100.0 * np.arange(vals.shape[0]) / max(vals.shape[0], 1)
        ax.plot(pct, vals, label=_label(tag))
    # uniform co-selection baseline C(k,2)/C(n,2) = k(k-1)/(n(n-1))
    uniform = uniform_pair_value(n) * (k * (k - 1) // 2)
    ax.axhline(uniform, linestyle="--", color="gray", label="uniform")
    ax.set_xlabel("percentile of pairs")
    ax.set_ylabel("pair selection probability")
    ax.legend()
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)
    return pdf_path


def plot_number_of_panels(
    counts: Dict[str, int],
    out_dir: Union[str, Path],
    stem: str,
) -> Path:
    """Unique-panel count bar chart (``analysis.py:356-378``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pdf_path = out_dir / f"{stem}_number_of_unique_panels.pdf"

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    labels = [_label(t) for t in counts]
    values = list(counts.values())
    bars = ax.bar(labels, values)
    ax.bar_label(bars)
    ax.set_ylabel("number of unique panels")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)
    return pdf_path


def plot_ratio_products(
    ratio_products: np.ndarray,
    legacy_allocation: np.ndarray,
    out_dir: Union[str, Path],
    stem: str,
) -> Path:
    """Ratio-product scatter + CSV (``analysis.py:434-456``; CSV schema from
    ``reference_output/example_small_20_ratio_product_data.csv:1``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pdf_path = out_dir / f"{stem}_ratio_product.pdf"
    csv_path = out_dir / f"{stem}_ratio_product_data.csv"

    rp = np.asarray(ratio_products, dtype=np.float64)
    alloc = np.asarray(legacy_allocation, dtype=np.float64)
    with open(csv_path, "w", encoding="utf-8", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["ratio product", "selection probability"])
        for r, a in zip(rp, alloc):
            writer.writerow([float(r), round(float(a), 4)])

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.scatter(rp, alloc, s=12, alpha=0.6)
    ax.set_xlabel("ratio product")
    ax.set_ylabel("LEGACY selection probability")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)
    return pdf_path


def plot_intersectional_representation(
    shares: Dict[str, np.ndarray],
    out_dir: Union[str, Path],
    stem: str,
    pairs: Sequence[str] = ("panel share LEXIMIN", "panel share LEGACY"),
    against: str = "population share",
) -> Optional[Path]:
    """Jointplot of intersectional panel shares vs population share
    (``analysis.py:519-528``); falls back to a scatter grid if seaborn is
    unavailable."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pdf_path = out_dir / f"{stem}_intersections.pdf"

    plt = _pyplot()
    try:
        import pandas as pd
        import seaborn as sns

        frames = []
        for col in pairs:
            if col not in shares:
                continue
            frames.append(
                pd.DataFrame(
                    {
                        against: shares[against],
                        "panel share": shares[col],
                        "algorithm": _label(col.replace("panel share ", "").lower()),
                    }
                )
            )
        if not frames:
            return None
        df = pd.concat(frames, ignore_index=True)
        grid = sns.jointplot(data=df, x=against, y="panel share", hue="algorithm", height=6)
        lim = float(max(df[against].max(), df["panel share"].max())) * 1.05
        grid.ax_joint.plot([0, lim], [0, lim], linestyle="--", color="gray", linewidth=1)
        grid.savefig(pdf_path)
        plt.close("all")
    except Exception:  # pragma: no cover — seaborn/pandas missing or headless quirk
        fig, ax = plt.subplots(figsize=(6, 6))
        for col in pairs:
            if col in shares:
                ax.scatter(shares[against], shares[col], s=10, alpha=0.6, label=_label(col))
        ax.set_xlabel(against)
        ax.set_ylabel("panel share")
        ax.legend()
        fig.tight_layout()
        fig.savefig(pdf_path)
        plt.close(fig)
    return pdf_path
