#!/usr/bin/env python3
"""Measure the generic-LP kernel on one NVIDIA GPU: against an earlier
version of it, and across block counts.

    python3 chip_lp_probe.py [--parent DIR [--quads Q]] [--sweep] [--iters N]

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
  with the cooperative interface the kernel had before x̄ got its global
  route (``lp_solve_launch`` and ``lp_occupancy`` without the route
  argument) and its headers: builds it, and runs it and the current
  kernel through the same wrapper, plan and prelude output (the staged
  route) at the path's tolerance and cap, in turns (earlier, current,
  current, earlier; ``--quads`` such rounds); the two must give x, λ, μ,
  iterations, residual and flags bit for bit. It also compares the two
  libraries' SASS (``cuobjdump -sass``) for the staged instances, the
  earlier ``lp_solve_kernel<resident>`` against the current
  ``lp_solve_kernel<resident, true>``: instruction counts and the lines
  that differ, encodings and addresses left out;
* with ``--sweep``: the current kernel's µs per iteration at each block
  count from 1 to the co-resident count, for ``--iters`` iterations.

Prints one JSON line per measurement and the card's name and power limit.
Exits non-zero when CUDA is absent or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import os
import re
import shutil
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
    """The earlier kernel's library, behind the current entry points'
    arguments (:class:`ParentLibrary`)."""
    from citizensassemblies_tpu_torch.kernels.cuda_lib import NVCC_FLAGS, nvcc

    out = os.path.join(src_dir, "libparent_lp.so")
    done = subprocess.run([nvcc()] + NVCC_FLAGS + [f"-I{src_dir}", "-o", out,
                           os.path.join(src_dir, "lp_block.cu")], check=True, capture_output=True,
                          text=True)
    cs.log(f"--- ptxas report, earlier lp_block ---\n{done.stderr.strip()}")
    lib = ctypes.CDLL(os.path.abspath(out))
    lib.lp_solve_launch.restype = ctypes.c_int
    lib.lp_solve_launch.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.lp_occupancy.restype = ctypes.c_int
    lib.lp_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return ParentLibrary(lib, out)


class ParentLibrary:
    """The earlier library under the current entry points: the x̄ route
    argument dropped (the earlier kernel always stages x̄)."""

    def __init__(self, lib, path):
        self.lib = lib
        self.path = path

    def lp_solve_launch(self, *args):
        *head, _stage_x, stream = args
        return self.lib.lp_solve_launch(*head, stream)

    def lp_occupancy(self, smem, resident, _stage_x, out):
        return self.lib.lp_occupancy(smem, resident, out)


def parent_solve(parent, inputs):
    """:func:`chip_smoke.lp_path_solve` with the earlier kernel behind the
    wrapper: ``(ms, iterations, kkt, raw output)``."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    current = mk.LP_KERNEL.lib()
    mk.LP_KERNEL._lib = parent
    try:
        return cs.lp_path_solve(inputs)
    finally:
        mk.LP_KERNEL._lib = current


def sass_functions(path):
    """Each kernel's SASS in a library (``cuobjdump -sass``), encodings
    and addresses left out: ``{mangled name: [instruction, ...]}``."""
    from citizensassemblies_tpu_torch.kernels.cuda_lib import nvcc

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], check=True, capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head[1], [])
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and ins:
            cur.append(ins[1])
    return funcs


def sass_compare(parent_path, current_path):
    """The staged instances' SASS, earlier against current: one record
    for each of the resident and the streaming instance."""
    old, new = sass_functions(parent_path), sass_functions(current_path)
    out = []
    for r in ("0", "1"):
        a = next(v for k, v in old.items() if k.endswith(f"lp_solve_kernelILb{r}EEEvNS_6ParamsE"))
        b = next(v for k, v in new.items() if k.endswith(f"lp_solve_kernelILb{r}ELb1EEEvNS_6ParamsE"))
        ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
        changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")
        out.append(dict(probe="sass", resident=r == "1", parent_instructions=len(a),
                        current_instructions=len(b), identical=a == b, differing_lines=changed))
    return out


def current_solve(inputs, iters):
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    csr, plan, idx, pre, state = inputs
    return mk.lp_blocks_cuda(csr, plan, idx, pre, state, 0.0, max_iters=int(iters),
                             check_every=128, sentinel=True)[3]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--quads", type=int, default=1)
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
    if parent is not None:
        for rec in sass_compare(parent.path, mk.LP_KERNEL.library_path()):
            print(json.dumps(rec), flush=True)
    ok = True
    for name, ops in shapes().items():
        ok = check(name, ops) and ok
        inputs = cs.lp_inputs(ops)
        if parent is not None:
            times, outs = [], {}
            for who in ("parent", "current", "current", "parent") * args.quads:
                run = parent_solve(parent, inputs) if who == "parent" else cs.lp_path_solve(inputs)
                times.append(dict(who=who, ms=run[0], iters=run[1], kkt=run[2]))
                outs.setdefault(who, run[3])
            per = {w: [1e3 * t["ms"] / t["iters"] for t in times if t["who"] == w]
                   for w in ("parent", "current")}
            same = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["current"]))
            ok = same and ok
            print(json.dumps(dict(
                probe="parent_vs_current", shape=name, plan=cs.plan_record(inputs[1]), runs=times,
                parent_us_per_iter=per["parent"], current_us_per_iter=per["current"],
                ratio=float(np.mean(per["current"]) / np.mean(per["parent"])),
                bit_identical=bool(same),
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
