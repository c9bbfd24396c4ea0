#!/usr/bin/env python3
"""Time the operations of XMIN's min-L2 ascent at the flagship's shape on one GPU.

    python3 chip_qp_probe.py

A portfolio of 15,309 random 110-member panels over n = 1,727 agents (the
shape XMIN grows on ``sf_e_skewed_instance(seed=1)``; agents drawn with
skewed popularity), packed as ELL rows. Prints one JSON line per operation
of one ascent iteration (``solvers/qp``): the gather kernel (``P·w``), the
transpose product ``Pᵀp`` as the port takes it (a 1-D segment sum over the
agent-major CSR, ``kernels/pdhg_megakernel.csr_forward``) and three other
ways (the same sums with the lane on a trailing axis, a dense float32 GEMV,
``index_add_``), the sort, the fixed-order prefix sum, the projection and
one whole iteration launched op by op. Each line holds the device
microseconds per call from ``torch.profiler`` and the CUDA-event
microseconds per call (which include the host's launch overhead), with the
card's name and power limit on the first line. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_qp_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from citizensassemblies_tpu_torch.kernels import cuda_lib
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers import qp
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(json.dumps({"card": cs.card_line()}), flush=True)
    cuda_lib.build_all([em.KERNEL])
    rng = np.random.default_rng(0)
    n, k, C = 1727, 110, 15309
    popularity = rng.dirichlet(np.ones(n) * 0.5)
    P = np.zeros((C, n), bool)
    for r in range(C):
        P[r, rng.choice(n, k, replace=False, p=popularity)] = True
    ell = EllPack.from_rows(P.astype(np.float32))
    csr = mk.csr_to_device(ell.idx, ell.val, n, dev)
    idx = torch.as_tensor(ell.idx, device=dev)
    val = torch.as_tensor(ell.val, device=dev)
    p = torch.rand(C, device=dev)
    w = torch.rand(n, device=dev)
    perm, rowptr, colT = csr
    vals_t = val.reshape(-1)[perm]
    vals_lane = vals_t[:, None].contiguous()
    Pd = torch.as_tensor(P.astype(np.float32), device=dev)
    forward = mk.csr_forward(csr, val[None])
    z = em.ell_gather_mv(idx, val, w)
    t = torch.rand(n, device=dev)
    eps = torch.tensor(1e-3, device=dev)
    lr = torch.tensor(0.01, device=dev)
    gather, scatter = qp._ell_ops(idx, val, n, csr)
    step = qp._ascent_step(
        lambda lam: qp.project_simplex(gather(lam[:n] - lam[n:]) / 2.0), scatter, t, eps, lr
    )
    lam = torch.rand(2 * n, device=dev)
    ops = {
        "gather P·w (kernel)": lambda: em.ell_gather_mv(idx, val, w),
        "Pᵀp, 1-D segment sum (the port's)": lambda: forward(p[None]),
        "Pᵀp, segment sum, lane on a trailing axis": lambda: torch.segment_reduce(
            vals_lane * p[colT][:, None], "sum", offsets=rowptr, axis=0, unsafe=True
        ),
        "Pᵀp, dense float32 GEMV": lambda: Pd.t() @ p,
        "Pᵀp, index_add_": lambda: torch.zeros(n, device=dev).index_add_(
            0, idx.reshape(-1), (val * p[:, None]).reshape(-1)
        ),
        "sort (15,309 floats)": lambda: torch.sort(z, descending=True),
        "fixed-order prefix sum": lambda: qp._prefix_sum_fixed_order(z),
        "project_simplex": lambda: qp.project_simplex(z),
        "one ascent iteration, op by op": lambda: step(lam),
    }
    for name, fn in ops.items():
        device_us = 1e3 * cs.device_ms(fn, 200)
        event_us = 1e3 * cs.cuda_ms(fn, reps=200, warmup=5)
        print(json.dumps({"op": name, "device_us": device_us, "event_us": event_us}), flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
