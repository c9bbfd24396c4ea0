#!/usr/bin/env python3
"""Time what the transfer guard costs on the main path, on one GPU.

    python3 chip_dist_probe.py

Runs LEXIMIN at the defaults on ``sf_e_skewed_instance(seed=1)`` and XMIN
from its distribution with ``Config.transfer_guard`` ``"off"`` (no guard
scope) and ``"disallow"`` (every wired launch and CUDA-graph replay under
``torch.cuda.set_sync_debug_mode("error")``): a warm-up pair, then
``PAIRS`` timed pairs, the order within a pair alternating (off first in
the even pairs, disallow first in the odd ones). Prints the card's name
and power limit, one JSON line per run (host seconds ending in a device
synchronisation, the allocation's gap to the first run's), and a summary
line: per mode the median and the interquartile range of each time, and
the median of the pairs' differences (disallow − off). Exits non-zero
without CUDA.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

#: timed off/disallow pairs after the warm-up pair
PAIRS = 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_dist_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import cuda_lib
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    print(json.dumps({"card": cs.card_line()}), flush=True)
    cuda_lib.build_all([em.KERNEL, mk.KERNEL, mk.LP_KERNEL])
    dense, space = featurize(sf_e_skewed_instance(seed=1), device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ref = None
    runs = []
    order = [("off", "disallow")] + [
        ("off", "disallow") if i % 2 == 0 else ("disallow", "off") for i in range(PAIRS)
    ]
    for pair, modes in enumerate(order):
        for mode in modes:
            cfg = default_config().replace(transfer_guard=mode)
            lex, lex_s = timed(lambda: find_distribution_leximin(dense, space, cfg=cfg))
            xmin, xmin_s = timed(lambda: find_distribution_xmin(dense, space, cfg=cfg, leximin=lex))
            if ref is None:
                ref = (lex.allocation, xmin.allocation)
            rec = dict(
                pair=pair, mode=mode, leximin_s=lex_s, xmin_s=xmin_s,
                contract_ok=bool(lex.contract_ok),
                leximin_gap=float(np.abs(lex.allocation - ref[0]).max()),
                xmin_gap=float(np.abs(xmin.allocation - ref[1]).max()),
            )
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    timed_runs = [r for r in runs if r["pair"] > 0]  # pair 0 warms up

    def spread(values):
        q25, q50, q75 = np.percentile(values, [25, 50, 75])
        return {"median": float(q50), "q25": float(q25), "q75": float(q75),
                "iqr": float(q75 - q25)}

    summary = {"pairs": PAIRS}
    for key in ("leximin_s", "xmin_s"):
        by_mode = {m: [r[key] for r in timed_runs if r["mode"] == m] for m in ("off", "disallow")}
        diffs = [
            next(r[key] for r in timed_runs if r["pair"] == i and r["mode"] == "disallow")
            - next(r[key] for r in timed_runs if r["pair"] == i and r["mode"] == "off")
            for i in range(1, PAIRS + 1)
        ]
        summary[key] = {m: spread(v) for m, v in by_mode.items()}
        summary[key]["paired_diff"] = spread(diffs)
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all(r["contract_ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
