"""The analysis CLI (reference ``analysis.py:646-705``).

``python -m citizensassemblies_tpu_torch <name> <k> [--skiptiming]`` scans
``<data_dir>`` for ``<name>_<k>`` instance directories containing
``categories.csv`` + ``respondents.csv`` (``analysis.py:649-668``), lists the
valid ones in the argparse epilog (``:669-686``), and dispatches to
``read_instance`` + ``analyze_instance`` (``:703-705``). An
``intersections.csv`` in the instance directory is picked up automatically
(``analysis.py:483-506``).

Extras over the reference: ``--data-dir``/``--out-dir``/``--cache-dir``
overrides, ``--no-cache``, ``--mc-iterations``, and a ``--generate`` mode that
writes the synthetic example datasets (reference
``data/generate_examples/main.py``) so the repo ships no CSV data.
``--device {cuda,cpu}`` (default ``cuda``) names where the passes run.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from citizensassemblies_tpu_torch.utils.config import default_config


def _valid_instances(data_dir: Path) -> List[Tuple[str, int]]:
    """Scan for ``<name>_<k>`` dirs holding both CSVs (``analysis.py:649-668``)."""
    found = []
    if not data_dir.is_dir():
        return found
    for entry in sorted(data_dir.iterdir()):
        if not entry.is_dir():
            continue
        stem, _, k_str = entry.name.rpartition("_")
        if not stem or not k_str.isdigit():
            continue
        if (entry / "categories.csv").exists() and (entry / "respondents.csv").exists():
            found.append((stem, int(k_str)))
    return found


def _generate_examples(data_dir: Path) -> None:
    """Write the synthetic example datasets (reference
    ``data/generate_examples/main.py:37-44`` — with the reference's
    ``categories.cvs`` typo fixed so the CLI accepts them)."""
    from citizensassemblies_tpu_torch.core.generator import (
        cross_product_instance,
        example_small_like_instance,
        write_instance_csvs,
    )

    small = example_small_like_instance()
    write_instance_csvs(small, data_dir / "example_small_20")
    large = cross_product_instance(
        categories=["gender", "political leaning"],
        features=[["female", "male"], ["liberal", "conservative"]],
        quotas=[[(99, 200), (99, 200)], [(99, 200), (99, 200)]],
        counts=[999, 1, 0, 1000],
        k=200,
        name="example_large_200",
    )
    write_instance_csvs(large, data_dir / "example_large_200")
    print(f"Wrote example datasets under {data_dir}/.")


def build_parser(data_dir: Path) -> argparse.ArgumentParser:
    instances = _valid_instances(data_dir)
    epilog_lines = ["valid instances (<name> <k>):"] + [
        f"  {name} {k}" for name, k in instances
    ]
    if not instances:
        epilog_lines.append(
            "  (none found — run with --generate to create the example datasets)"
        )
    parser = argparse.ArgumentParser(
        prog="citizensassemblies_tpu_torch",
        description="Fair citizens'-assembly selection analysis (PyTorch, CUDA)",
        epilog="\n".join(epilog_lines),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("name", nargs="?", help="instance name (directory stem)")
    parser.add_argument("k", nargs="?", type=int, help="panel size")
    parser.add_argument("--skiptiming", action="store_true",
                        help="skip the 3-run LEXIMIN timing harness")
    parser.add_argument("--data-dir", default=str(data_dir), help="instance data root")
    parser.add_argument("--out-dir", default="analysis", help="reports/plots output dir")
    parser.add_argument("--cache-dir", default="distributions",
                        help="pickle memoization dir")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable pickle memoization")
    parser.add_argument("--mc-iterations", type=int, default=None,
                        help="override the 10,000 LEGACY Monte-Carlo draws")
    parser.add_argument("--generate", action="store_true",
                        help="generate the synthetic example datasets and exit")
    parser.add_argument("--address-columns", nargs="+", default=None,
                        metavar="COL",
                        help="respondents.csv columns identifying a household; "
                             "when given, every algorithm selects at most one "
                             "member per household (the reference's "
                             "check_same_address capability)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the algorithms and statistics run")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # resolve --data-dir before building the epilog scan
    data_dir = Path("data")
    for i, a in enumerate(argv):
        if a == "--data-dir" and i + 1 < len(argv):
            data_dir = Path(argv[i + 1])
        elif a.startswith("--data-dir="):
            data_dir = Path(a.split("=", 1)[1])

    parser = build_parser(data_dir)
    args = parser.parse_args(argv)
    data_dir = Path(args.data_dir)

    if args.generate:
        _generate_examples(data_dir)
        return 0

    if args.name is None or args.k is None:
        parser.print_help()
        return 2

    inst_dir = data_dir / f"{args.name}_{args.k}"
    if not (inst_dir / "categories.csv").exists() or not (
        inst_dir / "respondents.csv"
    ).exists():
        parser.error(
            f"instance directory {inst_dir} must contain categories.csv and "
            f"respondents.csv (see --help for valid instances)"
        )

    from citizensassemblies_tpu_torch.analysis.report import analyze_instance
    from citizensassemblies_tpu_torch.core.instance import read_instance_dir

    cfg = default_config()
    if args.mc_iterations is not None:
        cfg = cfg.replace(mc_iterations=args.mc_iterations)

    households = None
    if args.address_columns:
        from citizensassemblies_tpu_torch.core.instance import (
            compute_households,
            read_instance,
        )

        instance = read_instance(
            inst_dir / "categories.csv",
            inst_dir / "respondents.csv",
            k=args.k,
            name=inst_dir.name,
            extra_columns=args.address_columns,
        )
        households = compute_households(instance, args.address_columns)
    else:
        instance = read_instance_dir(inst_dir, k=args.k)
    intersections = inst_dir / "intersections.csv"
    analyze_instance(
        instance,
        out_dir=args.out_dir,
        cache_dir=None if args.no_cache else args.cache_dir,
        intersections_path=intersections if intersections.exists() else None,
        skip_timing=args.skiptiming,
        cfg=cfg,
        households=households,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
