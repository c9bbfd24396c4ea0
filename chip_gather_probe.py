#!/usr/bin/env python3
"""Measure the ELL gather kernel on one NVIDIA GPU: against an earlier
version of it, and across the settings of its launch plan.

    python3 chip_gather_probe.py [--parent DIR] [--sweep] [--reps N]

Builds the kernels from ``citizensassemblies_tpu_torch/csrc`` and, at the
gather's path shapes:

* ``flagship``: the flagship master's pack (``chip_smoke.flagship_pack``:
  C=6144, k_pad=112, T=814);
* ``xmin``: a pack of XMIN's portfolio shape: 15,313 random 110-member
  panels of ``sf_e_skewed_instance(seed=1)``'s 1,727 agents, 0/1 values;
* ``dual_flagship`` and ``dual_sf_b``: the ``G`` packs of the flagship and
  sf_b dual LPs (``chip_smoke.dual_lp_operands``: 4096 panels of the sf_e
  pool, 1024 of ``sf_b_skewed_instance(seed=1)``);
* ``edge`` (checked, not timed): :func:`edge_pack`;

runs the float32 and the bf16-value entry points, one lane, three lanes
with shared values and three with per-lane values, and holds each against
the plain version at ``chip_smoke.GATHER_TOL`` and the bf16 path (on
values bf16 holds exactly) against the float32 path bit for bit;

* with ``--parent DIR``, a directory holding an earlier ``ell_gather.cu``
  and ``ell_gather.cuh`` with the grid-per-column interface (``G`` and
  ``threads`` after ``kp``, as the kernel had before its plan became a
  persistent one): builds it, holds the current kernel bit for bit against
  it in every case above and with a NaN at ``y[0]``, and times both in
  turns (earlier, current, current, earlier) at one lane (float32 and
  bf16) and at three lanes with per-lane values, with the pack hot in the
  L2 and with the L2 flushed before each call;
* with ``--sweep``: the current kernel at every count of a block's warps
  that take their spans by TMA (none to all) and at its
  plan's blocks per SM, one more and twice as many, each held bit for bit
  against the default plan and timed hot and flushed.

Times are device times from ``torch.profiler`` (``chip_smoke.device_ms``)
over ``--reps`` calls (a quarter of them flushed). Prints one JSON line per
measurement and the card's name and power limit. Exits non-zero when CUDA
is absent or a check fails.
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

#: XMIN's portfolio at the flagship (panels, members, agents)
XMIN_SHAPE = (15313, 110, 1727)


def xmin_pack():
    """0/1 rows of XMIN's portfolio shape over the sf_e pool's agents."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    C, k, n = XMIN_SHAPE
    rng = np.random.default_rng(7)
    rows = np.zeros((C, n), np.float32)
    for c in range(C):
        rows[c, rng.choice(n, size=k, replace=False)] = 1.0
    return EllPack.from_rows(rows)


def edge_pack():
    """1,106 random rows of 12 entries (16 slots) over 128: on 132 SMs,
    ranges of 9 and 8 columns at 4 lanes a column, so a block of 8 has a
    TMA warp without a column."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    rng = np.random.default_rng(11)
    rows = np.zeros((132 * 8 + 50, 128), np.float32)
    for r in rows:
        r[rng.choice(128, size=12, replace=False)] = rng.random(12) + 0.5
    return EllPack.from_rows(rows)


def packs():
    from citizensassemblies_tpu_torch.core.generator import sf_b_skewed_instance

    flagship, _, _ = cs.flagship_pack()
    return {
        "flagship": flagship,
        "xmin": xmin_pack(),
        "dual_flagship": cs.dual_lp_operands()[1],
        "dual_sf_b": cs.dual_lp_operands(m1=1024, pool=sf_b_skewed_instance(seed=1))[1],
        "edge": edge_pack(),
    }


def parent_shape(C, kp, B, sms, bf16):
    """``(G, threads)`` of the earlier kernel (its ``launch_shape``): up to
    four warps a block while the grid still covers every SM."""
    kv = kp // 4
    G = next(g for g in (8, 4, 2, 1) if kv % g == 0)
    if bf16:
        G = max(G // 2, 1)
    warps = 4
    while warps > 1 and B * -(-(C * G) // (32 * warps)) < sms:
        warps -= 1
    return G, 32 * warps


def build_parent(src_dir):
    from citizensassemblies_tpu_torch.kernels.cuda_lib import NVCC_FLAGS, nvcc

    out = os.path.join(src_dir, "libparent_gather.so")
    subprocess.run([nvcc()] + NVCC_FLAGS + [f"-I{src_dir}", "-o", out,
                    os.path.join(src_dir, "ell_gather.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    for name in ("ell_gather_launch", "ell_gather_bf16_launch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def parent_gather(lib, sms, idx, val, Y):
    """The earlier kernel on the same inputs; ``[B, C]``."""
    import torch

    from citizensassemblies_tpu_torch.kernels.cuda_lib import ptr, stream_of

    C, kp = idx.shape
    B, T = Y.shape
    bf16 = val.dtype == torch.bfloat16
    G, threads = parent_shape(C, kp, B, sms, bf16)
    out = torch.empty((B, C), dtype=torch.float32, device=Y.device)
    fn = lib.ell_gather_bf16_launch if bf16 else lib.ell_gather_launch
    rc = fn(ptr(idx), ptr(val), ctypes.c_longlong(C * kp if val.dim() == 3 else 0), ptr(Y),
            ptr(out), B, T, C, kp, G, threads, stream_of(Y))
    if rc != 0:
        raise RuntimeError(f"earlier gather kernel failed with cudaError_t {rc}")
    return out


def cases(pack):
    """``{name: (idx, val, Y)}`` on the card (``chip_smoke.gather_cases``):
    float32 and bf16 values, one lane, three lanes with shared values, three
    with per-lane values."""
    import torch

    dev = torch.device("cuda")
    idx_np, val_np = pack.padded(len(pack))
    idx = torch.as_tensor(idx_np, device=dev)
    val = torch.as_tensor(val_np, device=dev)
    return {case: (idx, v, Y) for case, (v, Y) in cs.gather_cases(idx, val, pack.minor, 3).items()}


def check(name, pack, parent, sms):
    """Every case against the plain version, bf16 against float32 where
    bf16 holds the values, and against the earlier kernel bit for bit."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    ok = True
    runs = cases(pack)
    for case, (idx, val, Y) in runs.items():
        z = em.ell_gather_mv(idx, val, Y)
        torch.cuda.synchronize()
        err = float((z - em.ell_gather_mv_plain(idx, val, Y)).abs().max())
        rec = dict(probe="check", shape=name, case=case, C=int(idx.shape[0]), k_pad=int(idx.shape[1]),
                   T=pack.minor, plan=cs.gather_plan_record(em.launch_plan(
                       idx.shape[0], idx.shape[1], pack.minor, Y.shape[0], sms,
                       bf16=val.dtype == torch.bfloat16)),
                   max_abs_err=err, tolerance=cs.GATHER_TOL, ok=err <= cs.GATHER_TOL)
        i32, v32, y32 = runs[case.replace("bf16", "f32")]
        if val.dtype == torch.bfloat16 and torch.equal(val.float(), v32):
            rec["bitwise_vs_f32"] = cs.bits_equal(z, em.ell_gather_mv(i32, v32, y32))
            rec["ok"] = rec["ok"] and rec["bitwise_vs_f32"]
        if parent is not None:
            rec["bitwise_vs_parent"] = cs.bits_equal(z, parent_gather(parent, sms, idx, val, Y))
            ynan = Y.clone()
            ynan[:, 0] = float("nan")
            rec["bitwise_vs_parent_nan_y0"] = cs.bits_equal(
                em.ell_gather_mv(idx, val, ynan), parent_gather(parent, sms, idx, val, ynan))
            rec["ok"] = rec["ok"] and rec["bitwise_vs_parent"] and rec["bitwise_vs_parent_nan_y0"]
        print(json.dumps(rec), flush=True)
        ok = ok and rec["ok"]
    return ok, runs


def bound_ms(idx, val, Y):
    import torch

    from citizensassemblies_tpu_torch.obs import roofline

    C, kp = idx.shape
    return roofline.bound(roofline.gather_cost(
        C, kp, Y.shape[1], lanes=Y.shape[0], value_bytes=2 if val.dtype == torch.bfloat16 else 4,
        lane_values=val.dim() == 3))[0]


def times(fn, reps):
    """``(hot_ms, flushed_ms)`` device time per call of the gather kernels
    (every kernel whose name holds ``gather``: the package's and the
    earlier one's)."""
    return (cs.device_ms(fn, reps, "gather"),
            cs.device_ms(fn, max(reps // 4, 10), "gather", flush_l2=True))


def turns(name, case, inputs, parent, sms, reps):
    """The kernels in turns, each hot and flushed: the earlier one, the
    current one, the current one, the earlier one."""
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    idx, val, Y = inputs
    runs = {"parent": lambda: parent_gather(parent, sms, idx, val, Y),
            "current": lambda: em.ell_gather_mv(idx, val, Y)}
    order = list(runs)
    seq = []
    for who in order + order[::-1]:
        hot, flushed = times(runs[who], reps)
        seq.append(dict(who=who, hot_ms=hot, flushed_ms=flushed))
    mean = {w: {k: float(np.mean([t[k] for t in seq if t["who"] == w])) for k in ("hot_ms", "flushed_ms")}
            for w in order}
    spread = {w: {k: float(np.ptp([t[k] for t in seq if t["who"] == w])) for k in ("hot_ms", "flushed_ms")}
              for w in order}
    b = bound_ms(idx, val, Y)
    rec = dict(probe="turns", shape=name, case=case, runs=seq, mean=mean, spread=spread,
               bound_ms=b, bound_by="bytes",
               flushed_bound_share={w: b / mean[w]["flushed_ms"] for w in order})
    for w in order:
        if w != "current":
            rec[f"hot_ratio_vs_{w}"] = mean["current"]["hot_ms"] / mean[w]["hot_ms"]
            rec[f"flushed_ratio_vs_{w}"] = mean["current"]["flushed_ms"] / mean[w]["flushed_ms"]
    print(json.dumps(rec), flush=True)


def sweep(name, case, inputs, sms, reps):
    """The current kernel at every count of TMA warps (none to all) and at
    its plan's blocks per SM, one more and twice as many, hot and flushed,
    each held bit for bit to the default plan."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    idx, val, Y = inputs
    C, kp = idx.shape
    B, T = Y.shape
    bf16 = val.dtype == torch.bfloat16
    want = em.ell_gather_mv(idx, val, Y)
    plan0 = em.launch_plan(C, kp, T, B, sms, bf16=bf16)
    warps = plan0.threads // 32
    settings = [(plan0.blocks_per_sm, tw) for tw in range(warps + 1)]
    settings += [(bps, None) for bps in (plan0.blocks_per_sm + 1, 2 * plan0.blocks_per_sm)]
    row = []
    ok = True
    for bps, tw in settings:
        plan = em.launch_plan(C, kp, T, B, sms, bf16=bf16, blocks_per_sm=bps, tma_warps=tw)
        if plan.smem_bytes > em.BLOCK_SMEM:
            continue
        same = cs.bits_equal(cs.planned_gather(plan, idx, val, Y), want)
        ok = ok and same
        hot, flushed = times(lambda: cs.planned_gather(plan, idx, val, Y), reps)
        row.append(dict(blocks_per_sm=bps, blocks=plan.blocks * plan.B, threads=plan.threads,
                        tma_warps=plan.tma_warps, hot_ms=hot, flushed_ms=flushed, bitwise=same))
    print(json.dumps(dict(probe="sweep", shape=name, case=case, bound_ms=bound_ms(idx, val, Y),
                          default=cs.gather_plan_record(plan0), settings=row, ok=ok)), flush=True)
    return ok


#: the cases timed at each shape
TIMED = ("f32_b1", "bf16_b1", "f32_b3_lane", "bf16_b3_lane")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("chip_gather_probe: CUDA is not available")
        return 2
    from citizensassemblies_tpu_torch.kernels import cuda_lib
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    card = cs.card_line()
    build_s = cuda_lib.build_all([em.KERNEL])
    print(json.dumps(dict(probe="build", seconds=build_s)), flush=True)
    cs.log(f"--- ptxas report, {em.KERNEL.name} ---\n{em.KERNEL.build_log.strip()}")
    parent = build_parent(args.parent) if args.parent else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for name, pack in packs().items():
        good, runs = check(name, pack, parent, sms)
        ok = ok and good
        for case in TIMED if name != "edge" else ():
            if parent is not None:
                turns(name, case, runs[case], parent, sms, args.reps)
            if args.sweep:
                ok = sweep(name, case, runs[case], sms, args.reps) and ok
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
