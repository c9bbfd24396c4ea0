"""Row-sharded PDHG for the dual leximin LP and the face master.

The framework's scaling axis is the portfolio (pool) size: the dual LP's
constraint matrix is the C×n committee matrix and the face master's is the
2T×C type profile, and their two matvecs per PDHG iteration are the
memory-bound hot loop. Here the constraint rows are laid out over the
world's mesh (the declared ``rows`` layout of ``dist/partition.py``, both
mesh axes flattened into one row-parallel axis) and each rank iterates on
its own row shard:

* ``G x̄`` needs only local rows — no communication (on the ELL route the
  hand-written gather kernel, ``csrc/ell_gather.cu``, on a CUDA shard);
* ``Gᵀ λ`` is a local transposed product followed by one
  ``all_reduce(SUM)`` over the world;
* the Ruiz column maxima are ``all_reduce(MAX)`` of local partials, and the
  KKT residual's row sums one packed ``all_reduce(SUM)``.

The primal iterate ``x`` and the equality dual ``μ`` are replicated (they
are n+1 long); every rank computes the same update from the reduced
gradient. The host reads the residual once per ``block_iters`` block, as
the JAX package's on-device loop checks it, so the solve is one host sync
per block. Sums in another order than the JAX package's ``psum`` make the
result differ from it in the last bits.

Routing: ``find_distribution_leximin`` sends its agent-space dual LP here
(``models/leximin.py``) when ``dist.runtime.effective_mesh`` hands out a
mesh and the portfolio has at least ``Config.dual_shard_min_rows`` rows,
the face loop its master (``solvers/face_decompose.py``) at
``Config.master_shard_min_types`` types. Exactness contract: that of the
single-device PDHG — a non-converged result (``ok=False``) sends the caller
to host HiGHS; a collective or kernel error raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from citizensassemblies_tpu_torch.aot.store import SeededGraph, register_block
from citizensassemblies_tpu_torch.dist import partition as dist_partition
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core, register_spmd_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.solvers.highs_backend import DualSolution
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.guards import (
    guarded_launch,
    no_implicit_transfers,
    readback,
)

Apply = Callable[[torch.Tensor], torch.Tensor]


def _rsqrt_norm(m: torch.Tensor) -> torch.Tensor:
    """Ruiz divisor: sqrt of a positive max, 1 where the max is 0."""
    return torch.where(m > 0, torch.sqrt(torch.clamp_min(m, 1e-10)), torch.ones_like(m))


def _all_reduced(G_rmv_local: Apply) -> Apply:
    def G_rmv(y):
        g = G_rmv_local(y)
        dist.all_reduce(g)
        return g

    return G_rmv


def _sharded_block(G_mv: Apply, G_rmv_local: Apply, hs_l, cs, as_row, bs, tau, sigma,
                   block_iters: int):
    """One block of the sharded PDHG: ``block_iters`` iterations, the
    transposed product summed over the world each iteration."""
    G_rmv = _all_reduced(G_rmv_local)

    def block(x, lam_l, mu):
        xs, ls, ms = torch.zeros_like(x), torch.zeros_like(lam_l), torch.zeros_like(mu)
        for _ in range(block_iters):
            grad = cs + G_rmv(lam_l) + as_row * mu[0]
            x_new = torch.clamp_min(x - tau * grad, 0.0)
            xb = 2.0 * x_new - x
            lam_l = torch.clamp_min(lam_l + sigma * (G_mv(xb) - hs_l), 0.0)
            mu = mu + sigma * ((as_row @ xb)[None] - bs)
            x = x_new
            xs, ls, ms = xs + x, ls + lam_l, ms + mu
        return x, lam_l, mu, xs, ls, ms

    return block


@register_block("parallel.sharded_block_dense", collective=True)
def _sharded_dense_factory(block_iters: int):
    """The graph store's block factory of a dense sharded block over ``(Gs,
    Gs_t, hs_l, cs, as_row, bs, tau, sigma)``."""

    def make(Gs, Gs_t, hs_l, cs, as_row, bs, tau, sigma):
        return _sharded_block(lambda x: Gs @ x, lambda y: Gs_t @ y, hs_l, cs, as_row, bs, tau,
                              sigma, int(block_iters))

    return make


@register_block("parallel.sharded_block_ell", collective=True)
def _sharded_ell_factory(block_iters: int):
    """The graph store's block factory of an ELL sharded block over the shard's
    ``kernels/pdhg_megakernel.lp_operator_tensors`` and ``(hs_l, cs,
    as_row, bs, tau, sigma)``."""

    def make(idx, vals_s, vals_t, rowT, rowptr, hs_l, cs, as_row, bs, tau, sigma):
        from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import lp_operators_from

        G_mv, G_rmv_local = lp_operators_from(idx, vals_s, vals_t, rowT, rowptr)
        return _sharded_block(G_mv, G_rmv_local, hs_l, cs, as_row, bs, tau, sigma,
                              int(block_iters))

    return make


def _sharded_pdhg(G_mv: Apply, G_rmv_local: Apply, hs_l, cs, as_row, bs, tol: float,
                  block_iters: int, max_blocks: int, stats: Optional[dict] = None,
                  graph: Optional[bool] = None, seed=None):
    """The restart-to-average PDHG of the sharded cores in scaled
    coordinates: ``G_mv`` the local rows' product, ``G_rmv_local`` the local
    transposed product (summed over the world here). With ``graph``
    (default: on CUDA tensors) a solve that reaches its second block
    replays the block's ``block_iters`` iterations, collectives included,
    as a CUDA graph from the graph store (``aot/store.py``: the same
    kernels in the same order; ``seed`` is ``(family, factory, operator
    tensors)``). Returns the scaled ``(x, lam_l, mu, res)``; ``stats``
    receives ``blocks``, ``iters`` and ``graph``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _prepare

    dev = cs.device
    f32 = dict(dtype=torch.float32, device=dev)
    nv = cs.shape[0]
    m_l = hs_l.shape[0]
    G_rmv = _all_reduced(G_rmv_local)
    tau, sigma, scale = _sharded_steps(G_mv, G_rmv, hs_l, cs, as_row, bs)

    def kkt(x, lam_l, mu):
        # one packed reduction: [pri_l, λ·h, Gᵀλ]
        packed = torch.cat([
            torch.sum(torch.clamp_min(G_mv(x) - hs_l, 0.0) ** 2)[None],
            (lam_l @ hs_l)[None],
            G_rmv_local(lam_l),
        ])
        dist.all_reduce(packed)
        pri = torch.sqrt(packed[0] + (as_row @ x - bs[0]) ** 2)
        grad = cs + packed[2:] + as_row * mu[0]
        dua = torch.linalg.norm(torch.clamp_max(grad, 0.0))
        pobj = cs @ x
        dobj = -packed[1] - mu[0] * bs[0]
        gap = torch.abs(pobj - dobj)
        return (pri + dua) / scale + gap / (1.0 + torch.abs(pobj) + torch.abs(dobj))

    x = torch.zeros(nv, **f32)
    lam_l = torch.zeros(m_l, **f32)
    mu = torch.zeros(1, **f32)
    xa, la, ma = x, lam_l, mu
    inv = 1.0 / block_iters
    graph = cs.is_cuda if graph is None else graph
    run = block = _sharded_block(G_mv, G_rmv_local, hs_l, cs, as_row, bs, tau, sigma, block_iters)
    if graph and seed is None:
        raise ValueError("a graph-replayed solve takes its operands (seed=)")
    if seed is not None:
        family, factory, op_tensors = seed
        run = SeededGraph(
            family, factory, {"block_iters": int(block_iters)},
            tuple(op_tensors) + (hs_l, cs, as_row, bs, tau, sigma), eager=block, graph=graph,
        )
    it, res = 0, float("inf")
    while res > tol and it < max_blocks:
        _prepare(run, x, lam_l, mu)
        with guarded_launch(dev):
            x, lam_l, mu, xs, ls, ms = run(x, lam_l, mu)
            xa = (xa + xs * inv) * 0.5
            la = (la + ls * inv) * 0.5
            ma = (ma + ms * inv) * 0.5
            r_cur = kkt(x, lam_l, mu)
            r_avg = kkt(xa, la, ma)
            better = r_avg < r_cur
            x = torch.where(better, xa, x)
            lam_l = torch.where(better, la, lam_l)
            mu = torch.where(better, ma, mu)
            r = torch.minimum(r_cur, r_avg)
        # the block's one host read
        with readback():
            res = float(r)
        it += 1
    if stats is not None:
        stats.update(blocks=it, iters=it * block_iters, graph=bool(graph))
    return x, lam_l, mu, res


def _sharded_steps(G_mv: Apply, G_rmv: Apply, hs_l, cs, as_row, bs):
    """The sharded PDHG's steps and KKT scale: ‖K‖₂ by power iteration
    over the world (``G_rmv`` summed over it). Returns ``(tau, sigma,
    scale)``."""
    nv = cs.shape[0]
    v = torch.ones(nv, dtype=torch.float32, device=cs.device) / np.sqrt(np.float32(nv))
    for _ in range(24):
        w = G_rmv(G_mv(v)) + as_row * (as_row @ v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    norm = torch.sqrt(torch.linalg.norm(G_rmv(G_mv(v)) + as_row * (as_row @ v)) + 1e-12)
    tau = sigma = 0.9 / norm
    hsq = torch.sum(hs_l**2)
    dist.all_reduce(hsq)
    scale = 1.0 + torch.linalg.norm(cs) + torch.sqrt(hsq) + torch.abs(bs[0])
    return tau, sigma, scale


def _family(name: str, block_iters: int, max_blocks: int) -> str:
    """The store family of a sharded core: its world size rides the name,
    so a graph captured on one world never serves another."""
    return f"parallel.{name}[{dist.get_world_size()},{int(block_iters)},{int(max_blocks)}]"


def _ruiz(absrow_max: Callable, abscol_max_local: Callable, a_row, m_l: int, nv: int, dev):
    """Eight Ruiz sweeps on the row shard: row maxima local, column maxima
    ``all_reduce(MAX)`` over the world (the equality row joins the column
    maxima, its own scale stays 1). ``absrow_max(d_r, d_c)`` and
    ``abscol_max_local(d_r, d_c)`` give the scaled shard's row and column
    maxima. Returns ``(d_r_l, d_c)``."""
    d_r = torch.ones(m_l, dtype=torch.float32, device=dev)
    d_c = torch.ones(nv, dtype=torch.float32, device=dev)
    for _ in range(8):
        rmax = absrow_max(d_r, d_c)
        cmax = abscol_max_local(d_r, d_c)
        dist.all_reduce(cmax, op=dist.ReduceOp.MAX)
        cmax = torch.maximum(cmax, torch.abs(a_row) * d_c)
        d_r, d_c = d_r / _rsqrt_norm(rmax), d_c / _rsqrt_norm(cmax)
    return d_r, d_c


def sharded_dense_core(G_l, h_l, c, a_row, b, tol: float, block_iters: int, max_blocks: int,
                       stats: Optional[dict] = None, graph: Optional[bool] = None):
    """The sharded solve of ``min cᵀx s.t. Gx ≤ h, a_rowᵀx = b, x ≥ 0`` on
    this rank's dense row shard ``G_l [rows_l, nv]`` (and its ``h_l``),
    everything else replicated. Returns the unscaled ``(x, lam_l, mu,
    res)``."""
    absG = G_l.abs()
    d_r, d_c = _ruiz(
        lambda r, cc: (r[:, None] * absG * cc[None, :]).amax(dim=1),
        lambda r, cc: (r[:, None] * absG * cc[None, :]).amax(dim=0),
        a_row, G_l.shape[0], c.shape[0], G_l.device,
    )
    Gs = d_r[:, None] * G_l * d_c[None, :]
    Gs_t = Gs.t().contiguous()
    x, lam_l, mu, res = _sharded_pdhg(
        lambda x: Gs @ x, lambda y: Gs_t @ y, h_l * d_r, c * d_c, a_row * d_c, b, tol,
        block_iters, max_blocks, stats, graph,
        seed=(_family("sharded", block_iters, max_blocks), "parallel.sharded_block_dense",
              (Gs, Gs_t)),
    )
    return x * d_c, lam_l * d_r, mu, res


def sharded_ell_core(idx_l, val_l, h_l, c, a_row, b, tol: float, block_iters: int,
                     max_blocks: int, stats: Optional[dict] = None, graph: Optional[bool] = None):
    """:func:`sharded_dense_core` with the row shard as a packed ELL pack
    ``idx_l`` int32 / ``val_l`` float32 ``[rows_l, k_pad]`` over the nv
    variables: ``G x̄`` is ``kernels/ell_matvec.ell_gather_mv`` (the gather kernel
    on a CUDA shard), ``Gᵀ λ`` the shard's variable-major CSR transpose
    summed in row order (``kernels/pdhg_megakernel.lp_operators``, no
    atomics, so a solve repeats bit for bit), the Ruiz column maxima a
    per-variable amax over the slots."""
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import (
        csr_to_device,
        lp_operators_from,
    )

    nv = c.shape[0]
    # the shard's transpose, built once on the host from its positions
    with readback():
        csr = csr_to_device(idx_l.cpu().numpy(), val_l.cpu().numpy(), nv, idx_l.device)
    d_r, d_c, ops = _sharded_ell_scaled(idx_l, val_l, a_row, nv, csr)
    G_mv, G_rmv_local = lp_operators_from(*ops)
    x, lam_l, mu, res = _sharded_pdhg(
        G_mv, G_rmv_local, h_l * d_r, c * d_c, a_row * d_c, b, tol, block_iters, max_blocks,
        stats, graph,
        seed=(_family("sharded_ell", block_iters, max_blocks), "parallel.sharded_block_ell", ops),
    )
    return x * d_c, lam_l * d_r, mu, res


def _sharded_ell_scaled(idx_l, val_l, a_row, nv: int, csr):
    """Ruiz on the ELL row shard (row maxima local, column maxima over the
    world) and the scaled shard's operator tensors
    (``kernels/pdhg_megakernel.lp_operator_tensors``). Returns ``(d_r, d_c,
    ops)``."""
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import lp_operator_tensors
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_row_absmax

    absV = val_l.abs()
    idx64 = idx_l.to(torch.int64)
    d_r, d_c = _ruiz(
        lambda r, cc: (absV * r[:, None] * cc[idx64]).amax(dim=1),
        lambda r, cc: ell_row_absmax(idx64, absV * r[:, None] * cc[idx64], nv),
        a_row, idx_l.shape[0], nv, idx_l.device,
    )
    vals_s = (val_l * d_r[:, None] * d_c[idx64]).contiguous()
    return d_r, d_c, lp_operator_tensors(idx_l, vals_s, csr)


def _place(mesh: DeviceMesh, rows_arrays, rep_arrays) -> Tuple[list, list]:
    """The local row shards (``rows`` layout) and the replicated operands on
    the mesh's device: the one hand-off of a sharded solve."""
    local = [
        dist_partition.place(a, dist_partition.rows(mesh, a.ndim)).to_local()
        for a in rows_arrays
    ]
    rep = [
        dist_partition.place(a, dist_partition.replicated(mesh, a.ndim)).to_local()
        for a in rep_arrays
    ]
    return local, rep


def solve_dual_lp_pdhg_sharded(
    P_mat: np.ndarray,
    fixed: np.ndarray,
    mesh: DeviceMesh,
    cfg: Optional[Config] = None,
    tol: Optional[float] = None,
    max_blocks: int = 120,
    block_iters: int = 512,
    stats: Optional[dict] = None,
    graph: Optional[bool] = None,
) -> DualSolution:
    """The dual leximin LP (``leximin.py:300-328``) by row-sharded PDHG over
    ``mesh``, on the mesh's device.

    Variables ``z = [y (n), ŷ]``; ``min ŷ − Σ fixedᵢ yᵢ`` s.t. ``P y − ŷ·1
    ≤ 0``, ``Σ_unfixed y = 1``, ``z ≥ 0``. Rows pad to a multiple of the
    mesh size (a zero row adds ŷ ≥ 0, already implied). The ELL route
    (``Config.sparse_ops``, by the fill) carries panel rows of k + 1
    nonzeros. ``graph`` (default: on CUDA) replays each block after the
    first as a CUDA graph. ``stats`` receives ``route``, ``blocks``,
    ``iters``, ``graph`` and ``res``. Returns the standard :class:`DualSolution` (``ok=False`` ⇒ use
    the host fallback)."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_pack_rows, sparse_enabled

    cfg = cfg or default_config()
    tol = float(cfg.pdhg_tol if tol is None else tol)
    P_mat = np.asarray(P_mat, dtype=np.float32)
    C, n = P_mat.shape
    ndev = int(mesh.size())
    fixed = np.asarray(fixed, dtype=np.float64)
    unfixed = fixed < 0
    fixed_vals = np.where(unfixed, 0.0, fixed)
    rows = -(-C // ndev) * ndev
    G = np.zeros((rows, n + 1), dtype=np.float32)
    G[:C, :n] = P_mat
    G[:, n] = -1.0
    a_row = np.concatenate([unfixed.astype(np.float32), [0.0]]).astype(np.float32)
    b = np.array([1.0], dtype=np.float32)
    c = np.concatenate([-fixed_vals, [1.0]]).astype(np.float32)
    h = np.zeros(rows, dtype=np.float32)
    stats = {} if stats is None else stats
    fill = float(np.count_nonzero(G)) / max(G.size, 1)
    with no_implicit_transfers(cfg):
        if sparse_enabled(cfg, fill):
            idx_r, val_r, _nnz = ell_pack_rows(G)
            (idx_l, val_l, h_l), (c_, a_, b_) = _place(mesh, (idx_r, val_r, h), (c, a_row, b))
            stats["route"] = "ell"
            with dispatch_span(
                "parallel.sharded_dual_lp_ell", cfg=cfg, rows=int(rows) // ndev,
                kp=int(idx_r.shape[1]),
            ) as ds:
                x, _lam, _mu, res = sharded_ell_core(
                    idx_l, val_l, h_l, c_, a_, b_, tol, block_iters, max_blocks, stats, graph
                )
                ds.out = x
        else:
            (G_l, h_l), (c_, a_, b_) = _place(mesh, (G, h), (c, a_row, b))
            stats["route"] = "dense"
            with dispatch_span(
                "parallel.sharded_dual_lp", cfg=cfg, rows=int(rows) // ndev, nv=int(n + 1),
            ) as ds:
                x, _lam, _mu, res = sharded_dense_core(
                    G_l, h_l, c_, a_, b_, tol, block_iters, max_blocks, stats, graph
                )
                ds.out = x
    stats["res"] = res
    x = x.cpu().numpy().astype(np.float64)
    return DualSolution(
        ok=bool(res <= tol * 4.0), y=x[:n], yhat=float(x[n]),
        objective=float(c.astype(np.float64) @ x),
    )


def solve_decomp_master_sharded(
    MT: np.ndarray,
    v: np.ndarray,
    mesh: DeviceMesh,
    cfg: Optional[Config] = None,
    tol: Optional[float] = None,
    max_blocks: int = 120,
    block_iters: int = 512,
    stats: Optional[dict] = None,
    graph: Optional[bool] = None,
):
    """The face-decomposition two-sided ε-LP with its 2T rows sharded over
    ``mesh`` (dense core, on the mesh's device).

    Same LP as ``cg_typespace._decomp_lp`` / ``face_decompose._master_pdhg``:
    variables ``[p (C), ε]``, ``min ε`` s.t. ``v − ε ≤ M p ≤ v + ε``,
    ``Σp = 1``, all ≥ 0. Columns pad to a bucket of 2048 (a zero column
    stays at its zero start). Returns ``(eps_realized, w, p_norm, eps_obj,
    ok)``: the float64 arithmetic ``‖M p − v‖∞`` of the normalized mixture,
    the aiming duals ``w = y_lo − y_up`` (gathered from every rank's rows),
    the mixture, the LP's ε and whether the solve converged."""
    cfg = cfg or default_config()
    tol = float(cfg.pdhg_tol if tol is None else tol)
    MT = np.asarray(MT, dtype=np.float64)
    T, C = MT.shape
    ndev = int(mesh.size())
    v = np.asarray(v, dtype=np.float64)
    bucket = 2048
    Cp = -(-(C + 1) // bucket) * bucket
    rows = -(-(2 * T) // ndev) * ndev
    G = np.zeros((rows, Cp), dtype=np.float32)
    G[:T, :C] = -MT
    G[T : 2 * T, :C] = MT
    G[: 2 * T, C] = -1.0
    h = np.zeros(rows, dtype=np.float32)
    h[:T] = -v
    h[T : 2 * T] = v
    a_row = np.zeros(Cp, dtype=np.float32)
    a_row[:C] = 1.0
    b = np.array([1.0], dtype=np.float32)
    c = np.zeros(Cp, dtype=np.float32)
    c[C] = 1.0
    with no_implicit_transfers(cfg):
        (G_l, h_l), (c_, a_, b_) = _place(mesh, (G, h), (c, a_row, b))
        x, lam_l, _mu, res = sharded_dense_core(
            G_l, h_l, c_, a_, b_, tol, block_iters, max_blocks, stats, graph
        )
    parts = [torch.empty_like(lam_l) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, lam_l)
    lam = torch.cat(parts).cpu().numpy().astype(np.float64)
    x = x.cpu().numpy().astype(np.float64)
    if stats is not None:
        stats["res"] = res
    p = np.maximum(x[:C], 0.0)
    total = p.sum()
    if not np.isfinite(total) or total <= 0.0:
        return float("inf"), np.zeros(T), np.full(C, 1.0 / max(C, 1)), float("inf"), False
    p_norm = p / total
    eps_real = float(np.abs(MT @ p_norm - v).max())
    w = np.maximum(lam[:T], 0.0) - np.maximum(lam[T : 2 * T], 0.0)
    return eps_real, w, p_norm, float(x[C]), bool(res <= tol * 4.0)


# --- registered cores (lint/registry.py) ----------------------------------------
# The IR cores are a solve to its first host read (the scaling, the steps and
# one block, through the graph store with ``graph=True``) on a one-rank
# world, whatever the world size: the budgets must not depend on the host's
# ranks. The SPMD cores are the whole hand-off and solve (``_place``, then a
# fixed ``max_blocks`` blocks: fake collectives return no real sums, so a
# solve to a tolerance might never end) at every swept world size.

_IR_ROWS, _IR_NV, _IR_KP, _IR_BLOCK = 64, 33, 8, 128


def sharded_first_block(G_l, h_l, c, a_row, b, tol, *, block_iters: int, graph: bool = False):
    """:func:`sharded_dense_core` to its first host read. Returns the
    unscaled ``(x, lam_l, mu)`` after one block."""
    absG = G_l.abs()
    d_r, d_c = _ruiz(
        lambda r, cc: (r[:, None] * absG * cc[None, :]).amax(dim=1),
        lambda r, cc: (r[:, None] * absG * cc[None, :]).amax(dim=0),
        a_row, G_l.shape[0], c.shape[0], G_l.device,
    )
    Gs = d_r[:, None] * G_l * d_c[None, :]
    Gs_t = Gs.t().contiguous()
    x, lam_l, mu = _sharded_one_block(
        lambda x: Gs @ x, lambda y: Gs_t @ y, h_l * d_r, c * d_c, a_row * d_c, b, block_iters,
        graph, "sharded", "parallel.sharded_block_dense", (Gs, Gs_t),
    )
    return x * d_c, lam_l * d_r, mu


def sharded_ell_first_block(idx_l, val_l, h_l, c, a_row, b, tol, *, csr, block_iters: int,
                            graph: bool = False):
    """:func:`sharded_ell_core` to its first host read (``csr`` the shard's
    transpose, which the core builds on the host)."""
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import lp_operators_from

    d_r, d_c, ops = _sharded_ell_scaled(idx_l, val_l, a_row, c.shape[0], csr)
    G_mv, G_rmv_local = lp_operators_from(*ops)
    x, lam_l, mu = _sharded_one_block(
        G_mv, G_rmv_local, h_l * d_r, c * d_c, a_row * d_c, b, block_iters, graph,
        "sharded_ell", "parallel.sharded_block_ell", ops,
    )
    return x * d_c, lam_l * d_r, mu


def _sharded_one_block(G_mv, G_rmv_local, hs_l, cs, as_row, bs, block_iters: int, graph: bool,
                       name: str, factory: str, op_tensors):
    tau, sigma, _scale = _sharded_steps(G_mv, _all_reduced(G_rmv_local), hs_l, cs, as_row, bs)
    f32 = dict(dtype=torch.float32, device=cs.device)
    args = (torch.zeros(cs.shape[0], **f32), torch.zeros(hs_l.shape[0], **f32), torch.zeros(1, **f32))
    if graph:
        run = SeededGraph(_family(name, block_iters, 1), factory, {"block_iters": int(block_iters)},
                          tuple(op_tensors) + (hs_l, cs, as_row, bs, tau, sigma))
    else:
        run = _sharded_block(G_mv, G_rmv_local, hs_l, cs, as_row, bs, tau, sigma, block_iters)
    return run(*args)[:3]


def sharded_dispatch(G, h, c, a_row, b, *, mesh, tol: float, block_iters: int, max_blocks: int):
    """The dense sharded dual LP's hand-off and solve
    (:func:`solve_dual_lp_pdhg_sharded` after building its rows): full
    host operands on every rank, ``_place``, :func:`sharded_dense_core`."""
    (G_l, h_l), (c_, a_, b_) = _place(mesh, (G, h), (c, a_row, b))
    return sharded_dense_core(G_l, h_l, c_, a_, b_, tol, block_iters, max_blocks, graph=False)[:3]


def sharded_ell_dispatch(idx, val, h, c, a_row, b, *, mesh, tol: float, block_iters: int,
                         max_blocks: int):
    """The ELL twin of :func:`sharded_dispatch`."""
    (idx_l, val_l, h_l), (c_, a_, b_) = _place(mesh, (idx, val, h), (c, a_row, b))
    return sharded_ell_core(idx_l, val_l, h_l, c_, a_, b_, tol, block_iters, max_blocks,
                            graph=False)[:3]


def _dual_rows(r, rows: int, nv: int):
    """A seeded dual-LP row block ``[P | -1]`` of panel rows (k = 6 members
    of nv - 1 agents), ``h = 0``, ``c``, ``a_row``, ``b`` as the dual LP
    builds them (:func:`solve_dual_lp_pdhg_sharded`). Host arrays."""
    n = nv - 1
    G = np.zeros((rows, nv), np.float32)
    members = np.argsort(r.rng.random((rows, n)), axis=1)[:, :6]
    np.put_along_axis(G, members, 1.0, axis=1)
    G[:, n] = -1.0
    c = np.concatenate([-r.rng.uniform(0.0, 0.2, n), [1.0]]).astype(np.float32)
    return G, np.zeros(rows, np.float32), c, np.concatenate([np.ones(n, np.float32), [0.0]]).astype(
        np.float32), np.ones(1, np.float32)


def _one_rank_world(device) -> None:
    """A one-rank world on ``device`` when no process group runs (the IR
    cores' collectives need one)."""
    if not dist.is_initialized():
        from citizensassemblies_tpu_torch.parallel.mesh import make_mesh

        make_mesh(1, device=device)


@register_ir_core("parallel.sharded_dual_lp", span="parallel.sharded_dual_lp")
def _ir_sharded_dual_lp(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    _one_rank_world(device)
    r = Seeded(41, device)
    G, h, c, a_row, b = _dual_rows(r, _IR_ROWS, _IR_NV)
    return IRCase(
        fn=sharded_first_block, args=tuple(r.t(a) for a in (G, h, c, a_row, b)) + (1e-6,),
        static=dict(block_iters=_IR_BLOCK, graph=False), device=str(device),
        graph=f"parallel.sharded[1,{_IR_BLOCK},1]",
    )


@register_ir_core("parallel.sharded_dual_lp_ell", dense_ref="parallel.sharded_dual_lp",
                  span="parallel.sharded_dual_lp_ell")
def _ir_sharded_dual_lp_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_pack_rows

    _one_rank_world(device)
    r = Seeded(42, device)
    G, h, c, a_row, b = _dual_rows(r, _IR_ROWS, _IR_NV)
    idx, val, _nnz = ell_pack_rows(G, _IR_KP)
    return IRCase(
        fn=sharded_ell_first_block,
        args=tuple(r.t(a) for a in (idx, val, h, c, a_row, b)) + (1e-6,),
        static=dict(block_iters=_IR_BLOCK, graph=False, csr=csr_to_device(idx, val, _IR_NV, r.device)),
        device=str(device), graph=f"parallel.sharded_ell[1,{_IR_BLOCK},1]",
    )


#: the SPMD cases' block: ``scale`` blocks of this many iterations
_SPMD_BLOCK = 16


@register_spmd_core(
    "parallel.sharded_dual_lp",
    loop_collectives=(
        "row-sharded GEMV: the per-iteration all-reduce of G^T lambda IS the algorithm, each "
        "rank owns a row shard and the dual ascent direction is their sum (_sharded_block)"
    ),
)
def _spmd_sharded_dual_lp(mesh, device="cpu", scale: int = 1) -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    G, h, c, a_row, b = _dual_rows(Seeded(41, device), _IR_ROWS, _IR_NV)
    return IRCase(
        fn=sharded_dispatch, args=(G, h, c, a_row, b),
        static=dict(mesh=mesh, tol=0.0, block_iters=_SPMD_BLOCK * int(scale), max_blocks=1),
        arg_roles=("rows", "rows", "replicated", "replicated", "replicated"), device=str(device),
    )


@register_spmd_core(
    "parallel.sharded_dual_lp_ell",
    loop_collectives=(
        "row-sharded ELL GEMV: the same per-iteration all-reduce as the dense twin, the sum over "
        "row shards is the dual ascent step itself"
    ),
)
def _spmd_sharded_dual_lp_ell(mesh, device="cpu", scale: int = 1) -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_pack_rows

    G, h, c, a_row, b = _dual_rows(Seeded(42, device), _IR_ROWS, _IR_NV)
    idx, val, _nnz = ell_pack_rows(G, _IR_KP)
    return IRCase(
        fn=sharded_ell_dispatch, args=(idx, val, h, c, a_row, b),
        static=dict(mesh=mesh, tol=0.0, block_iters=_SPMD_BLOCK * int(scale), max_blocks=1),
        arg_roles=("rows", "rows", "rows", "replicated", "replicated", "replicated"),
        device=str(device),
    )
