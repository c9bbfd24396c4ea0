"""CLI: ``python -m citizensassemblies_tpu_torch.aot build [--out PATH]
[--profile smoke|service] [--device cuda|cpu]``.

Builds every kernel library, records the coldboot request class and the
bucket lattice through a real ``SelectionService`` and writes the graph
store's artifact (``aot/build.py``). Prints the build report as one JSON
document; exits 0 when at least one entry was written, 2 when none was.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m citizensassemblies_tpu_torch.aot")
    sub = parser.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="record the service's shapes and write the artifact")
    b.add_argument(
        "--out", default=None,
        help="artifact path (default: CITIZENS_AOT_CACHE or the per-user file)",
    )
    b.add_argument(
        "--profile", choices=("smoke", "service"), default="smoke",
        help="shape coverage: smoke = the coldboot request and the lattice; "
        "service = + the wider pool-size sweep",
    )
    b.add_argument("--device", default=None, help="device (default: cuda)")
    args = parser.parse_args(argv)

    from citizensassemblies_tpu_torch.aot.build import build_cache

    report = build_cache(path=args.out, profile=args.profile, device=args.device)
    json.dump(report, sys.stdout, indent=2, default=repr)
    print()
    return 0 if report["entries"] else 2


if __name__ == "__main__":
    sys.exit(main())
