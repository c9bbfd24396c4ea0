#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU: kernels, then LEXIMIN end to end.

    python3 chip_smoke.py            # the whole check (one GPU)

Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit;
2. build: both hand-written CUDA kernels from ``citizensassemblies_tpu_torch/csrc``
   (one ``nvcc`` per source, started together);
3. kernels, each held against its plain PyTorch version on the card at the
   flagship shapes (T=814 types of ``sf_e_skewed_instance(seed=1)``, a
   6144-column pack): the ELL gather, and the two-sided PDHG solve at B=1,
   at B=3 with prefix column masks 1536/3072/6144, and at B=3 with one
   NaN-warmed lane;
4. a small-input reference: LEXIMIN on ``skewed_instance(n=160, k=14,
   n_categories=4, seed=2)`` on the GPU with every master forced onto the
   device route, against the same solve on the CPU;
5. the main path: ``find_distribution_leximin`` on ``sf_e_skewed_instance(seed=1)``
   on the GPU with the launch counters zeroed just before it.

Prints one JSON line per kernel phase, the ``{"kernels": [...]}`` summary,
the card line, and as its last line ``{"ok": true, "device": {...}}``. It
exits non-zero, with no result line, when CUDA is absent or the package
cannot be imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: the JAX package's Pallas kernel each CUDA kernel replaces
REPLACES = {
    "ell_gather": "citizensassemblies_tpu/kernels/ell_matvec.py:42",
    "two_sided_block": "citizensassemblies_tpu/kernels/pdhg_megakernel.py:161",
}

GATHER_TOL = 1e-4
#: kernel vs plain two-sided solve on the same prelude output. Both sum in
#: float32 and differ only in the order of their sums (measured on the card:
#: a few 1e-9 on x, about 1e-8 on lambda, 0 on the objective). At C=6144 an
#: entry of x is about 1/C, near 1.6e-4, so 1e-6 is under 1 % of one.
SOLVE_X_TOL = 1e-6
SOLVE_LAM_TOL = 1e-6
SOLVE_OBJ_TOL = 1e-7
#: the face loop's master tolerance at the flagship, 0.02 * the 6.5e-4 bar
MASTER_TOL = 0.02 * 6.5e-4
SOLVE_MAX_ITERS = 8192

E2E_CONTRACT = 1e-3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per ``fn()`` call: the summed self time of every
    GPU kernel the profiler saw over ``reps`` calls, divided by ``reps``;
    NaN when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        total_us += float(t or 0.0)
    return total_us / 1e3 / reps if total_us > 0 else float("nan")


def timed(fn, reps: int, warmup: int):
    """``(ms, call_ms)``: device time per call from the profiler (the event
    time where the profiler saw none) and the event time per call, which
    includes the host's launch overhead."""
    call_ms = cuda_ms(fn, reps=reps, warmup=warmup)
    dev = device_ms(fn, reps)
    return (dev if dev == dev else call_ms), call_ms


def flagship_pack(C: int = 6144, seed: int = 0):
    """A composition pack at the flagship shape: ``C`` random 110-member
    panels of the ``sf_e_skewed_instance(seed=1)`` pool as type counts over
    the T=814 types, scaled by 1/msize (the master's column scaling).
    Returns ``(EllPack, MT float64 [T, C], msize)``."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    dense, _ = featurize(sf_e_skewed_instance(seed=1), device="cpu")
    red = TypeReduction(dense)
    rng = np.random.default_rng(seed)
    comps = np.zeros((C, red.T), np.float64)
    for c in range(C):
        members = rng.choice(red.n, size=red.k, replace=False)
        np.add.at(comps[c], red.type_id[members], 1.0)
    rows = comps / red.msize[None, :]
    return EllPack.from_rows(rows.astype(np.float32), minor=red.T), rows.T, red.msize


def gather_phase(pack):
    """The ELL gather kernel against its plain version and against one
    ``torch.sparse.mm`` over a CSR of the same matrix (a yardstick only)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    dev = torch.device("cuda")
    launches0 = em.KERNEL.launches
    idx_np, val_np = pack.padded(6144)
    C, kp = idx_np.shape
    T = pack.minor
    idx = torch.as_tensor(idx_np, device=dev)
    val = torch.as_tensor(val_np, device=dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    y = torch.randn(T, generator=g).to(dev)
    yb = torch.randn((3, T), generator=g).to(dev)
    valb = (val[None] * torch.rand((3, 1, 1), generator=g).to(dev)).contiguous()

    z = em.ell_gather_mv(idx, val, y)
    zb = em.ell_gather_mv(idx, valb, yb)
    torch.cuda.synchronize()
    err = max(
        float((z - em.ell_gather_mv_plain(idx, val, y)).abs().max()),
        float((zb - em.ell_gather_mv_plain(idx, valb, yb)).abs().max()),
    )
    ms, call_ms = timed(lambda: em.ell_gather_mv(idx, val, y), reps=200, warmup=10)
    plain_ms, plain_call_ms = timed(lambda: em.ell_gather_mv_plain(idx, val, y), reps=200, warmup=10)
    rows = torch.as_tensor(np.repeat(np.arange(C), kp), device=dev)
    keep = val.reshape(-1) != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], idx.reshape(-1)[keep].long()]), val.reshape(-1)[keep], (C, T)
    ).coalesce()
    csr = coo.to_sparse_csr()
    ycol = y[:, None].contiguous()
    lib_err = float((torch.sparse.mm(csr, ycol)[:, 0] - z).abs().max())
    library_ms, library_call_ms = timed(lambda: torch.sparse.mm(csr, ycol), reps=200, warmup=10)
    # each input read once (the padded pack, y), the output written once
    nbytes = C * kp * 8 + T * 4 + C * 4
    flops = 2 * C * kp
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    rec = dict(
        phase="gather", name="ell_gather", replaces=REPLACES["ell_gather"],
        shape=dict(C=C, k_pad=kp, T=T, lanes=[1, 3]),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=lib_err,
        call_ms=call_ms, plain_call_ms=plain_call_ms, library_call_ms=library_call_ms,
        bound_ms=bound_ms, bound_by="bytes", max_abs_err=err, tolerance=GATHER_TOL,
        launches=em.KERNEL.launches - launches0, ok=err <= GATHER_TOL,
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"gather kernel disagrees with its plain version: {err}")
    return rec


def _solve_lanes(pack, MT, caps, nan_lane=None, max_iters=SOLVE_MAX_ITERS):
    """Inputs of a B-lane two-sided solve over the flagship pack: lane b
    sees the first ``caps[b]`` columns; ``v`` is realizable by the first
    1536 columns, so every lane's LP has optimum 0. Lane b's tolerance is
    the face loop's master tolerance scaled by ``C / caps[b]`` (a narrower
    lane converges more slowly), so every lane stops on its tolerance well
    before ``max_iters`` and its iteration count is a check of its own."""
    import torch

    dev = torch.device("cuda")
    T, C = MT.shape
    rng = np.random.default_rng(1)
    p_true = np.zeros(C)
    p_true[:1536] = rng.dirichlet(np.ones(1536))
    v = MT @ p_true
    B = len(caps)
    colmask = np.zeros((B, C), np.float32)
    for b, cap in enumerate(caps):
        colmask[b, :cap] = 1.0
    x0 = np.zeros((B, C + 1), np.float32)
    if nan_lane is not None:
        x0[nan_lane, 0] = np.nan
    f32 = dict(dtype=torch.float32, device=dev)
    idx_np, val_np = pack.padded(C)
    tol = np.array([MASTER_TOL * C / cap for cap in caps], np.float32)
    lanes = (
        torch.as_tensor(v.astype(np.float32), **f32), torch.as_tensor(colmask, **f32),
        torch.as_tensor(x0, **f32), torch.zeros((B, 2 * T), **f32),
        torch.zeros(B, **f32), torch.as_tensor(tol, **f32),
    )
    return idx_np, val_np, lanes, dict(max_iters=max_iters, check_every=128, sentinel=True)


def solve_phase(pack, MT, caps, label, nan_lane=None, clean=None):
    """One two-sided solve through the block kernel and through its plain
    version, on the same prelude output on the card. With ``nan_lane`` the
    clean run's prelude is reused and that lane's warm start is poisoned,
    so the lane's mates must match the clean kernel run bit for bit (the
    prelude's ``index_add_`` sums with atomics, so two preludes are not
    bitwise equal on the card)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import unscale

    launches0 = mk.KERNEL.launches
    idx_np, val_np, lanes, kw = _solve_lanes(pack, MT, caps)
    v, colmask, x0, lam0, mu0, tol = lanes
    T = v.shape[0]
    if clean is None:
        csr = mk.csr_to_device(idx_np, val_np, T, v.device)
        idx, vals_s, pre, state = mk.two_sided_setup(idx_np, val_np, v, colmask, x0, lam0, mu0)
    else:
        csr, idx, vals_s, pre, state = clean["prepared"]
    if nan_lane is not None:
        p_bad = state[0].clone()
        p_bad[nan_lane, 0] = float("nan")
        state = (p_bad,) + tuple(state[1:])
    out_k = {}

    def run_kernel():
        out_k["v"] = mk.two_sided_blocks_cuda(csr, idx, vals_s, pre, state, tol, **kw)

    out_p = {}

    def run_plain():
        out_p["v"] = mk.two_sided_blocks_plain(idx, vals_s, pre, state, tol, **kw)

    ms, call_ms = timed(run_kernel, reps=1, warmup=1)
    plain_ms, plain_call_ms = timed(run_plain, reps=1, warmup=0)
    k_out, p_out = out_k["v"], out_p["v"]
    xk, lk, _ = unscale(pre, *k_out[:5])
    xp, lp, _ = unscale(pre, *p_out[:5])
    it_k = k_out[5].cpu().numpy()
    it_p = p_out[5].cpu().numpy()
    res_k = k_out[6].cpu().numpy()
    flags_k = k_out[7].cpu().numpy()
    live = [b for b in range(len(caps)) if b != nan_lane]
    xk_n, xp_n = xk.cpu().numpy(), xp.cpu().numpy()
    lk_n, lp_n = lk.cpu().numpy(), lp.cpu().numpy()
    err_x = float(np.abs(xk_n[live] - xp_n[live]).max())
    err_lam = float(np.abs(lk_n[live] - lp_n[live]).max())
    err_obj = float(np.abs(xk_n[live, -1] - xp_n[live, -1]).max())
    # every live lane must stop on its tolerance, before the iteration cap,
    # after the same number of iterations in both versions
    tol_n = tol.cpu().numpy()
    converged = bool(np.all(res_k[live] <= tol_n[live]) and np.all(it_k[live] < kw["max_iters"]))
    same_iters = bool(np.array_equal(it_k[live], it_p[live]))
    ok = (
        err_x <= SOLVE_X_TOL and err_lam <= SOLVE_LAM_TOL and err_obj <= SOLVE_OBJ_TOL
        and converged and same_iters
    )
    notes = dict(converged=converged, same_iters=same_iters)
    if nan_lane is not None:
        quarantined = (
            int(it_k[nan_lane]) == 0 and not np.isfinite(res_k[nan_lane])
            and bool(flags_k[nan_lane] & 1)
        )
        notes["nan_lane_quarantined"] = quarantined
        ok = ok and quarantined
        if clean is not None:
            same = all(
                np.array_equal(xk_n[b], clean["x"][b]) and int(it_k[b]) == int(clean["it"][b])
                for b in live
            )
            notes["mates_bit_identical"] = same
            ok = ok and same
    C = idx_np.shape[0]
    kp = idx_np.shape[1]
    B = len(caps)
    nnz = int(csr[0].shape[0])
    # the least the card could take for this solve: each input read once
    # (the shared indices, every lane's values, the lane vectors) and each
    # output written once, against the float32 operations this run's
    # iterations need: per iteration and per KKT evaluation (two a block),
    # both matvec directions over the nonzeros (a multiply and an add each)
    # and about ten operations per entry of the C- and T-length vectors
    nbytes = C * kp * 4 * (1 + B) + B * (4 * C + 6 * T) * 4
    evals = sum(int(i) + 2 * (int(i) // kw["check_every"]) for i in it_k)
    flops = evals * (4 * nnz + 10 * (C + 2 * T))
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
    # the kernel as designed reads the pack from memory on every evaluation,
    # both layouts (slot-major C*kp*8 bytes, type-major nnz*8 bytes)
    iter_bytes_ms = 1e3 * evals * (C * kp * 8 + nnz * 8) / HBM_BYTES_PER_S
    rec = dict(
        phase=label, name="two_sided_block", replaces=REPLACES["two_sided_block"],
        shape=dict(C=C, k_pad=kp, T=T, nnz=nnz, caps=caps),
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        iter_bytes_ms=iter_bytes_ms, launches=mk.KERNEL.launches - launches0,
        call_ms=call_ms, plain_call_ms=plain_call_ms,
        iters_kernel=it_k.tolist(), iters_plain=it_p.tolist(), max_iters=kw["max_iters"],
        kkt_kernel=res_k.tolist(), lane_tol=tol_n.tolist(), max_abs_x=float(np.abs(xp_n[live]).max()),
        max_abs_err=max(err_x, err_lam), max_abs_err_x=err_x, max_abs_err_lam=err_lam,
        obj_err=err_obj,
        tolerance=dict(x=SOLVE_X_TOL, lam=SOLVE_LAM_TOL, obj=SOLVE_OBJ_TOL, iters=0),
        ok=bool(ok), **notes,
    )
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(f"two-sided kernel phase {label} failed")
    return rec, dict(x=xk_n, it=it_k, prepared=(csr, idx, vals_s, pre, state))


def leximin_run(inst, device, cfg):
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, space = featurize(inst, device=device)
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    dist = find_distribution_leximin(dense, space, cfg=cfg, log=log, device=device)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    linf = float(np.max(np.abs(dist.allocation - dist.fixed_probabilities)))
    return dist, log, secs, linf


def reference_phase(slice_cfg):
    """LEXIMIN on a small pool on the GPU, every master forced onto the
    device route, against the same solve on the CPU (host masters)."""
    from citizensassemblies_tpu_torch.core.generator import skewed_instance

    inst = skewed_instance(n=160, k=14, n_categories=4, seed=2)
    d_cpu, _, s_cpu, l_cpu = leximin_run(inst, "cpu", slice_cfg)
    d_gpu, log_gpu, s_gpu, l_gpu = leximin_run(
        inst, "cuda", slice_cfg.replace(decomp_host_master_max_types=0)
    )
    fixed_gap = float(np.max(np.abs(d_cpu.fixed_probabilities - d_gpu.fixed_probabilities)))
    alloc_gap = float(np.max(np.abs(d_cpu.allocation - d_gpu.allocation)))
    c = log_gpu.counters
    rec = dict(
        phase="reference_small", n=160, k=14, seconds_cpu=s_cpu, seconds_gpu=s_gpu,
        linf_cpu=l_cpu, linf_gpu=l_gpu, fixed_gap=fixed_gap, alloc_gap=alloc_gap,
        device_masters=int(c.get("megakernel_dispatches", 0)),
        ok=bool(
            d_cpu.contract_ok and d_gpu.contract_ok and fixed_gap <= 1e-9
            and alloc_gap <= 2 * E2E_CONTRACT and c.get("megakernel_dispatches", 0) > 0
        ),
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("small-input reference phase failed")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 2
    try:
        from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
        from citizensassemblies_tpu_torch.kernels import cuda_lib
        from citizensassemblies_tpu_torch.kernels import ell_matvec as em
        from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
        from citizensassemblies_tpu_torch.utils.config import default_config
        from citizensassemblies_tpu_torch.utils.device import resolve_device
    except ImportError as exc:
        log(f"chip_smoke: the port is not importable here ({exc})")
        return 2
    resolve_device("cuda")  # full float32: TF32 off for matmul and cuDNN
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    build_s = cuda_lib.build_all([em.KERNEL, mk.KERNEL])
    print(json.dumps(dict(phase="build", seconds=build_s)), flush=True)
    for lib in (em.KERNEL, mk.KERNEL):
        log(f"--- ptxas report, {lib.name} ---\n{lib.build_log.strip()}")

    pack, MT, _ = flagship_pack()
    gather = gather_phase(pack)
    b1, _ = solve_phase(pack, MT, [6144], "two_sided_b1")
    b3, clean = solve_phase(pack, MT, [1536, 3072, 6144], "two_sided_b3_prefix")
    bnan, _ = solve_phase(pack, MT, [1536, 3072, 6144], "two_sided_b3_nan", nan_lane=1, clean=clean)

    slice_cfg = default_config().replace(
        decomp_device_pricing=False, lp_batch=False, mixed_precision=False
    )
    reference_phase(slice_cfg)

    # the main path, with every launch counter zeroed just before it
    em.KERNEL.launches = 0
    mk.KERNEL.launches = 0
    dist, elog, secs, linf = leximin_run(sf_e_skewed_instance(seed=1), "cuda", slice_cfg)
    launches = {"ell_gather": em.KERNEL.launches, "two_sided_block": mk.KERNEL.launches}
    c, tm = elog.counters, elog.timers
    alloc = dist.allocation
    mean = alloc.mean()
    gini = float(np.abs(alloc[:, None] - alloc[None, :]).mean() / (2 * mean)) if mean else 0.0
    e2e = dict(
        phase="leximin_sf_e_skewed_seed1", seconds=secs, contract_ok=bool(dist.contract_ok),
        linf=linf, min_prob=float(alloc.min()), gini=gini,
        panels=int(len(dist.probabilities)), launches=launches,
        megakernel_fit_miss=int(c.get("megakernel_fit_miss", 0)),
        decomp_rounds=int(c.get("decomp_rounds", 0)),
        decomp_host_syncs=int(c.get("decomp_host_syncs", 0)),
        megakernel_dispatches=int(c.get("megakernel_dispatches", 0)),
        timers={k: tm.get(k, 0.0) for k in (
            "relax_leximin", "inject", "decomp_master", "decomp_polish",
            "decomp_expand", "decomp_oracle", "final_stage", "decomp",
        )},
    )
    e2e["ok"] = bool(
        dist.contract_ok and linf <= E2E_CONTRACT and np.isfinite(alloc).all()
        and alloc.shape == (1727,) and launches["ell_gather"] > 0
        and launches["two_sided_block"] > 0 and e2e["megakernel_fit_miss"] == 0
    )
    print(json.dumps(e2e), flush=True)

    def summary(name, rec, phase_recs):
        return dict(
            name=name, route="cuda", source=f"citizensassemblies_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in phase_recs), ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], passed=all(r["ok"] for r in phase_recs),
        )

    kernels = [
        summary("ell_gather", gather, [gather]),
        summary("two_sided_block", b1, [b1, b3, bnan]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total seconds: {time.perf_counter() - t0:.1f}")
    print(card, flush=True)
    if not e2e["ok"]:
        log("chip_smoke: the main path failed its checks")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
