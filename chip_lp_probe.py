#!/usr/bin/env python3
"""Measure the generic-LP kernel on one NVIDIA GPU: against an earlier
version of it, and across block counts.

    python3 chip_lp_probe.py [--parent DIR] [--sweep] [--iters N]

Builds the kernels from ``citizensassemblies_tpu_torch/csrc`` and, for the
dual leximin LPs of three pools as the agent-space path builds them
(``chip_smoke.dual_lp_operands``: 256 and 768 panel rows of
``skewed_instance(n=120, k=12, n_categories=3, seed=1)``, 1024 of
``sf_b_skewed_instance(seed=1)``, 4096 of ``sf_e_skewed_instance(seed=1)``):

* holds the kernel against its plain version at ``chip_smoke.LP_CHECK_TOL``
  (x and λ at ``LP_X_TOL``, the objective at ``LP_OBJ_TOL``, equal
  iterations) and a second kernel solve from a fresh prelude against the
  first, bit for bit;
* with ``--parent DIR``, a directory holding an earlier ``lp_block.cu``
  with the one-block interface (``lp_solve_launch`` over a slot-major pack,
  as the kernel had before it spanned the card) and its headers: builds
  it, and times it and the
  current kernel for ``--iters`` iterations at tolerance 0 on the same
  prelude output, in turns (earlier, current, current, earlier);
* with ``--sweep``: the current kernel's µs per iteration at each block
  count from 1 to the co-resident count, for ``--iters`` iterations.

Prints one JSON line per measurement and the card's name and power limit.
Exits non-zero when CUDA is absent or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke as cs


def shapes():
    from citizensassemblies_tpu_torch.core.generator import (
        sf_b_skewed_instance,
        sf_e_skewed_instance,
        skewed_instance,
    )

    n120 = skewed_instance(n=120, k=12, n_categories=3, seed=1)
    return {
        "n120": cs.dual_lp_operands(m1=256, pool=n120),
        "n120_768": cs.dual_lp_operands(m1=768, pool=n120),
        "sf_b": cs.dual_lp_operands(m1=1024, pool=sf_b_skewed_instance(seed=1)),
        "sf_e": cs.dual_lp_operands(m1=4096, pool=sf_e_skewed_instance(seed=1)),
    }


def check(name, ops):
    """Kernel against plain at LP_CHECK_TOL, and a repeat bit for bit."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    inputs = cs.lp_inputs(ops)
    plan = inputs[1]
    cmp = cs.lp_compare(inputs, np.asarray(ops[0], np.float64), cs.LP_CHECK_TOL, cs.LP_MAX_ITERS)
    again = mk.lp_blocks_cuda(*cs.lp_inputs(ops), cs.LP_CHECK_TOL, max_iters=cs.LP_MAX_ITERS,
                              check_every=128, sentinel=True)
    k = cmp["out_k"]
    repeat = bool(all(torch.equal(a, b) for a, b in zip(k[:3], again[:3])) and int(k[3]) == int(again[3]))
    rec = dict(
        probe="check", shape=name, nv=len(ops[0]), m1=len(ops[1]), k_pad=int(ops[1].idx.shape[1]),
        grid=plan.grid, resident_tile_floats=plan.tile_floats, ms=cmp["ms"], plain_ms=cmp["plain_ms"],
        it_k=cmp["it_k"], it_p=cmp["it_p"], err_x=cmp["err_x"], err_lam=cmp["err_lam"],
        err_obj=cmp["err_obj"], repeat_bit_identical=repeat,
    )
    rec["ok"] = bool(cs.lp_close(cmp) and cmp["it_k"] == cmp["it_p"] and repeat)
    print(json.dumps(rec), flush=True)
    return rec["ok"]


def build_parent(src_dir):
    from citizensassemblies_tpu_torch.kernels.cuda_lib import NVCC_FLAGS, nvcc

    out = os.path.join(src_dir, "libparent_lp.so")
    subprocess.run([nvcc()] + NVCC_FLAGS + [f"-I{src_dir}", "-o", out,
                    os.path.join(src_dir, "lp_block.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.lp_solve_launch.restype = ctypes.c_int
    lib.lp_solve_launch.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def parent_solve(lib, inputs, iters):
    """The earlier one-block kernel on the same prelude output, for
    ``iters`` iterations at tolerance 0; returns the iterations run."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.kernels.cuda_lib import ptr, stream_of

    csr, _, idx, pre, state = inputs
    x, lam, mu, norm, scale = state
    nv, m1, m2 = x.shape[0], lam.shape[0], mu.shape[0]
    kp = idx.shape[1]
    perm, rowptr, rowT = csr
    idxS = idx.t().contiguous()
    vsS = pre.vals_s.t().contiguous()
    vsT = pre.vals_s.reshape(-1)[perm].contiguous()
    xk, lamk, muk = x.clone(), lam.clone(), mu.clone()
    xav, lav, mav = xk.clone(), lamk.clone(), muk.clone()
    L = mk.LP_LAYOUT
    scal = torch.zeros(L["L_N"], dtype=torch.float32, device=x.device)
    for slot, val in (("L_RES", float("inf")), ("L_OMEGA", 1.0), ("L_BEST", float("inf")),
                      ("L_NORM", norm), ("L_SCALE", scale), ("L_TOL", 0.0)):
        scal[L[slot]] = val
    it = torch.zeros(1, dtype=torch.int32, device=x.device)
    scratch = torch.empty((3, m1), dtype=torch.float32, device=x.device)
    rc = lib.lp_solve_launch(
        ptr(idxS), ptr(vsS), ptr(rowptr), ptr(rowT), ptr(vsT), ptr(pre.As.contiguous()),
        ptr(pre.cs.contiguous()), ptr(pre.hs.contiguous()), ptr(pre.bs.contiguous()), ptr(xk),
        ptr(xav), ptr(lamk), ptr(lav), ptr(muk), ptr(mav), ptr(scal), ptr(it), ptr(scratch[0]),
        ptr(scratch[1]), ptr(scratch[2]), nv, m1, m2, kp, 128, int(iters), 1, stream_of(xk),
    )
    if rc != 0:
        raise RuntimeError(f"earlier LP kernel failed with cudaError_t {rc}")
    return it


def current_solve(inputs, iters):
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    csr, plan, idx, pre, state = inputs
    return mk.lp_blocks_cuda(csr, plan, idx, pre, state, 0.0, max_iters=int(iters),
                             check_every=128, sentinel=True)[3]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("chip_lp_probe: CUDA is not available")
        return 2
    from citizensassemblies_tpu_torch.kernels import cuda_lib
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    card = cs.card_line()
    libs = [em.KERNEL, mk.KERNEL, mk.LP_KERNEL]
    build_s = cuda_lib.build_all(libs)
    print(json.dumps(dict(probe="build", seconds=build_s)), flush=True)
    for lib in libs:
        cs.log(f"--- ptxas report, {lib.name} ---\n{lib.build_log.strip()}")
    parent = build_parent(args.parent) if args.parent else None
    ok = True
    for name, ops in shapes().items():
        ok = check(name, ops) and ok
        inputs = cs.lp_inputs(ops)
        if parent is not None:
            times = []
            for who in ("parent", "current", "current", "parent"):
                run = (lambda: parent_solve(parent, inputs, args.iters)) if who == "parent" else (
                    lambda: current_solve(inputs, args.iters))
                box = {}
                ms = cs.cuda_ms(lambda: box.update(it=run()), reps=1, warmup=0)
                times.append(dict(who=who, ms=ms, iters=int(box["it"])))
            per = {w: [1e3 * t["ms"] / t["iters"] for t in times if t["who"] == w]
                   for w in ("parent", "current")}
            print(json.dumps(dict(
                probe="parent_vs_current", shape=name, grid=inputs[1].grid, runs=times,
                parent_us_per_iter=per["parent"], current_us_per_iter=per["current"],
                ratio=float(np.mean(per["current"]) / np.mean(per["parent"])),
            )), flush=True)
        if args.sweep:
            c, ell = ops[0], ops[1]
            cores = mk.lp_coresident_blocks(len(c), len(ell), torch.device("cuda"))
            counts = sorted({b for b in (1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 48, 64, 96, 132)
                             if b <= cores} | {inputs[1].grid})
            row = []
            for b in counts:
                inp = cs.lp_inputs(ops, blocks=b)
                box = {}
                ms = cs.cuda_ms(lambda: box.update(it=current_solve(inp, args.iters)), reps=1,
                                warmup=1)
                row.append([b, inp[1].tile_floats > 0, 1e3 * ms / int(box["it"])])
            print(json.dumps(dict(probe="sweep", shape=name, rule_grid=inputs[1].grid,
                                  coresident=cores, blocks_resident_us_per_iter=row)), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
