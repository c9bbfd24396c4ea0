"""The PDHG block kernels: two hand-written CUDA kernels, one launch per solve.

**Two-sided master.**

The chained route (``solvers/lp_pdhg._two_sided_iterate``) runs each PDHG
iteration as a dozen small torch ops and reads every lane's residual on the
host after each block. The fused route here runs the whole block loop of a
solve — ``check_every`` iterations per block, the KKT of the current and the
averaged iterate, the restart, the ω rebalance, the sentinel freeze and the
per-lane active mask — inside ``csrc/two_sided_block.cu``, one thread block
per lane, in one launch. It replaces the JAX package's
``kernels/pdhg_megakernel.py:_two_sided_block_kernel``.

Around the kernel, in torch ops shared with the chained ELL route:

* :func:`two_sided_prelude` — Ruiz equilibration on the packed columns,
  the scaled data rows, per lane (the lanes of a batch share the pack and
  differ in their column masks);
* the power-iteration ‖K‖ estimate and the warm-start scaling
  (``solvers/lp_pdhg``), whose gathers launch the ELL gather kernel.

The kernel takes the pack twice: slot-major (``[k_pad, C]``, for its
adjoint gather, one thread per column) and as a type-major CSR transpose
(for its forward product, one warp per type); both are built here, the CSR
structure on the host from the numpy pack, so no step has a data-dependent
shape and nothing synchronises before the kernel.

**Generic-form LP** (``min cᵀx, Gx ≤ h, Ax = b, x ≥ 0``, G as packed ELL
rows): ``csrc/lp_block.cu`` runs the whole block loop of one solve in one
thread block, replacing the JAX package's
``kernels/pdhg_megakernel.py:_lp_block_kernel``. Around it, in torch ops
shared with the chained route ``solvers/lp_pdhg._pdhg_body_ell``:
:func:`lp_setup` (Ruiz on the stacked ``[G; A]``, the power-iteration ‖K‖,
the scaled warm start). The kernel takes the pack slot-major (its ``G x``,
one thread per row) and as a variable-major CSR transpose built on the host
(its ``Gᵀλ``, one warp per variable). The torch ops take ``Gᵀλ`` over the
same CSR (:func:`lp_operators`), so no step of an LP solve sums with
atomics and two runs on the same inputs take the same iterations.

Gate (``Config.pdhg_megakernel``), for both kernels: ``None`` — the kernel
on CUDA when the solve fits shared memory (:func:`two_sided_fits`,
:func:`lp_fits`); ``True`` — the kernel on CUDA tensors and its plain
version (:func:`two_sided_blocks_plain`, :func:`lp_blocks_plain`) on CPU
tensors; ``False`` — the chained route. A shape that does not fit goes to
the chained route and is counted (``megakernel_fit_miss``).
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from citizensassemblies_tpu_torch.kernels.cuda_lib import CSRC, CudaLibrary, ptr, stream_of
from citizensassemblies_tpu_torch.kernels.ell_matvec import ell_gather_mv, ell_gather_mv_plain
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils import device as _device

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaLibrary(
    "two_sided_block",
    "two_sided_block.cu",
    ["ell_gather.cuh", "two_sided_layout.cuh"],
    {"two_sided_solve_launch": (ctypes.c_int, [_P] * 20 + [_I] * 8 + [_P])},
)


LP_KERNEL = CudaLibrary(
    "lp_block",
    "lp_block.cu",
    ["ell_gather.cuh", "lp_layout.cuh"],
    {"lp_solve_launch": (ctypes.c_int, [_P] * 20 + [_I] * 7 + [_P])},
)


def _read_layout(header: str) -> Dict[str, int]:
    """A kernel's fit-rule constants and scalar-row slots, read from its
    layout header under ``csrc/`` (the one place they are defined)."""
    with open(os.path.join(CSRC, header)) as fh:
        text = fh.read()
    return {m[1]: int(m[2]) for m in re.finditer(r"^constexpr int (\w+) = (\d+);", text, re.M)}


LAYOUT = _read_layout("two_sided_layout.cuh")
LP_LAYOUT = _read_layout("lp_layout.cuh")


def two_sided_smem_bytes(T: int, Cp: int) -> int:
    """Shared memory one lane of the kernel needs: the T-length vectors,
    the C-length p-bar scratch and the reduction scratch."""
    return (LAYOUT["kTVectors"] * int(T) + int(Cp) + LAYOUT["kRedFloats"]) * 4


def two_sided_fits(T: int, Cp: int) -> bool:
    """The fit rule: the lane's shared-memory working set fits one block."""
    return two_sided_smem_bytes(T, Cp) <= LAYOUT["kMaxSmem"]


def _gate(cfg: Optional[Config], fits: bool, device, log) -> str:
    cfg = cfg or default_config()
    gate = cfg.pdhg_megakernel
    if gate is False or (gate is None and not _device.on_accelerator(device)):
        return "off"
    if not fits:
        if log is not None:
            log.count("megakernel_fit_miss")
        return "off"
    return "fused"


def megakernel_mode(cfg: Optional[Config], T: int, Cp: int, device, log=None) -> str:
    """Resolve the tri-state gate for a (T, Cp) master on ``device`` to
    ``"fused"`` or ``"off"``. A gate that would engage but does not fit is
    counted as ``megakernel_fit_miss`` on ``log``."""
    return _gate(cfg, two_sided_fits(T, Cp), device, log)


def lp_smem_bytes(nv: int, m1: int, m2: int) -> int:
    """Shared memory one generic-LP solve needs: the nv-length vectors, the
    dense equality block, the m2-length vectors, λ and the reduction
    scratch."""
    L = LP_LAYOUT
    return (
        L["kNvVectors"] * nv + m2 * nv + L["kM2Vectors"] * m2 + L["kM1Vectors"] * m1
        + L["kLpRedFloats"]
    ) * 4


def lp_fits(nv: int, m1: int, m2: int) -> bool:
    """The LP kernel's fit rule: its shared-memory working set fits one block."""
    return lp_smem_bytes(nv, m1, m2) <= LP_LAYOUT["kLpMaxSmem"]


def lp_megakernel_mode(cfg: Optional[Config], nv: int, m1: int, m2: int, device, log=None) -> str:
    """:func:`megakernel_mode` for a generic LP of nv variables, m1
    inequality and m2 equality rows."""
    return _gate(cfg, lp_fits(nv, m1, m2), device, log)


def two_sided_prelude(idx: torch.Tensor, val: torch.Tensor, v: torch.Tensor, colmask: torch.Tensor):
    """Ruiz equilibration of the two-sided master on the packed columns,
    per lane. ``idx``/``val`` ``[C, k_pad]`` (shared), ``v [T]``,
    ``colmask [B, C]``. Returns ``(scaled, vals_s [B, C, k_pad])``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _root, _TwoSidedScaled
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_row_absmax

    T = v.shape[0]
    B, C = colmask.shape
    dev = val.device
    absV = val.abs()
    d_r = torch.ones((B, T), dtype=torch.float32, device=dev)
    d_e = torch.ones(B, dtype=torch.float32, device=dev)
    d_c = torch.ones((B, C), dtype=torch.float32, device=dev)
    d_eps = torch.ones(B, dtype=torch.float32, device=dev)
    for _ in range(8):
        S = absV * d_r[:, idx] * d_c[:, :, None]
        row_ineq = torch.maximum(ell_row_absmax(idx, S, T), d_r * d_eps[:, None])
        row_eq = (d_e[:, None] * d_c * colmask).amax(dim=1)
        col = torch.maximum(S.amax(dim=2), d_e[:, None] * d_c * colmask)
        col_eps = d_r.amax(dim=1) * d_eps
        d_r = d_r / _root(row_ineq)
        d_e = d_e / _root(row_eq)
        d_c = d_c / _root(col)
        d_eps = d_eps / _root(col_eps)
    vals_s = (val * d_r[:, idx] * d_c[:, :, None]).contiguous()
    pre = _TwoSidedScaled(
        d_r=d_r, d_e=d_e, d_c=d_c, d_eps=d_eps,
        e_col=d_r * d_eps[:, None], a_row=d_e[:, None] * d_c * colmask,
        hs_lo=-v[None, :] * d_r, hs_up=v[None, :] * d_r,
        bs=1.0 * d_e, cs_eps=1.0 * d_eps,
    )
    return pre, vals_s


def ell_operators(idx, vals_s, pre, gather=ell_gather_mv):
    """The scaled two-sided operator pair over the packed columns:
    ``K_apply(p, eps) -> (r_lo, r_up, r_eq)``, ``KT_apply(l_lo, l_up, mu)
    -> (g_p, g_e)``. ``gather`` is the kernel wrapper (CUDA) by default."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_scatter_mv

    T = pre.d_r.shape[1]

    def K_apply(p, eps):
        u = ell_scatter_mv(idx, vals_s, p, T)
        ec = pre.e_col * eps[:, None]
        return -u - ec, u - ec, (pre.a_row * p).sum(1)

    def KT_apply(l_lo, l_up, mu):
        g_p = gather(idx, vals_s, l_up - l_lo) + mu[:, None] * pre.a_row
        g_e = -(pre.e_col * (l_lo + l_up)).sum(1)
        return g_p, g_e

    return K_apply, KT_apply


def two_sided_blocks_plain(idx, vals_s, pre, state, tol, *, max_iters, check_every, sentinel):
    """The block kernel's plain version: the same block loop in torch ops
    (``lp_pdhg._two_sided_iterate`` over the plain packed matvecs)."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _two_sided_iterate

    K_apply, KT_apply = ell_operators(idx, vals_s, pre, gather=ell_gather_mv_plain)
    p, eps, l_lo, l_up, mu, norm, scale = state
    return _two_sided_iterate(
        K_apply, KT_apply, pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs,
        p, eps, l_lo, l_up, mu, norm, scale, tol,
        max_iters, check_every, sentinel=sentinel,
    )


def csr_transpose(idx_np: np.ndarray, val_np: np.ndarray, T: int):
    """Type-major transpose of a column pack: ``(perm, rowptr, colT)`` with
    ``perm`` the flat pack positions of the nonzero slots ordered by type
    (stable, so each type's entries stay in column order)."""
    kp = idx_np.shape[1]
    nz = np.flatnonzero(val_np.reshape(-1) != 0)
    keys = idx_np.reshape(-1)[nz]
    order = np.argsort(keys, kind="stable")
    perm = nz[order].astype(np.int64)
    rowptr = np.zeros(T + 1, dtype=np.int32)
    rowptr[1:] = np.cumsum(np.bincount(keys, minlength=T)).astype(np.int32)
    return perm, rowptr, (perm // kp).astype(np.int32)


def csr_to_device(idx_np: np.ndarray, val_np: np.ndarray, T: int, device):
    """:func:`csr_transpose` uploaded to ``device``. Callers upload it before
    they queue the solve's other device work: a copy from pageable host
    memory waits for the stream, so uploading it later would block the host
    until the prelude has run."""
    return tuple(torch.as_tensor(a, device=device) for a in csr_transpose(idx_np, val_np, T))


def two_sided_blocks_cuda(csr, idx, vals_s, pre, state, tol, *,
                          max_iters, check_every, sentinel):
    """Launch the block kernel on the prelude's output; ``csr`` is
    :func:`csr_to_device` of the same pack. Returns the scaled ``(p, eps,
    l_lo, l_up, mu, it, res, flags)`` like the plain version."""
    p, eps, l_lo, l_up, mu, norm, scale = state
    B, C = p.shape
    T = l_lo.shape[1]
    kp = idx.shape[1]
    dev = p.device
    if not two_sided_fits(T, C):
        raise ValueError(f"a lane at T={T}, C={C} does not fit the block kernel")
    perm, rowptr, colT = csr
    nnz = int(perm.shape[0])
    idxS = idx.t().contiguous()
    vsS = vals_s.transpose(1, 2).contiguous()
    vsT = vals_s.reshape(B, -1)[:, perm].contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    p_k = p.contiguous().clone()
    pav = p_k.clone()
    llo = l_lo.contiguous().clone()
    lup = l_up.contiguous().clone()
    llav, luav = llo.clone(), lup.clone()
    scal = torch.zeros((B, LAYOUT["S_N"]), **f32)
    for slot, val in (
        ("S_EPS", eps), ("S_MU", mu), ("S_EAV", eps), ("S_MAV", mu),
        ("S_RES", float("inf")), ("S_OMEGA", 1.0), ("S_BEST", float("inf")),
        ("S_BS", pre.bs), ("S_CEPS", pre.cs_eps), ("S_NORM", norm),
        ("S_TOL", tol), ("S_SCALE", scale),
    ):
        scal[:, LAYOUT[slot]] = val
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    p0 = torch.empty((B, C), **f32)
    avn = torch.empty((B, C), **f32)
    ps = torch.empty((B, C), **f32)
    ecol = pre.e_col.contiguous()
    hlo = pre.hs_lo.contiguous()
    hup = pre.hs_up.contiguous()
    arow = pre.a_row.contiguous()
    KERNEL.call(
        "two_sided_solve_launch",
        ptr(idxS), ptr(vsS), ptr(rowptr), ptr(colT), ptr(vsT), ptr(ecol),
        ptr(hlo), ptr(hup), ptr(arow), ptr(p_k), ptr(pav), ptr(llo), ptr(lup),
        ptr(llav), ptr(luav), ptr(scal), ptr(iters), ptr(p0), ptr(avn), ptr(ps),
        B, T, C, kp, nnz, int(check_every), int(max_iters), int(bool(sentinel)),
        stream_of(p_k),
    )
    out = {slot: scal[:, LAYOUT[slot]] for slot in ("S_EPS", "S_MU", "S_RES", "S_POIS", "S_STALL")}
    flags = (out["S_POIS"] > 0).to(torch.int32) + 2 * (out["S_STALL"] > 0).to(torch.int32)
    return (p_k, out["S_EPS"], llo, lup, out["S_MU"], iters, out["S_RES"], flags)


def two_sided_setup(idx_np: np.ndarray, val_np: np.ndarray, v, colmask, x0, lam0, mu0):
    """Everything before the block loop: the pack on ``v``'s device, the
    Ruiz prelude, the power-iteration ‖K‖ and the scaled warm start.
    Returns ``(idx, vals_s, pre, state)`` for :func:`two_sided_blocks_cuda`
    and :func:`two_sided_blocks_plain`."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import kkt_scale, power_norm, warm_scaled

    dev = v.device
    idx = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32), device=dev)
    val = torch.as_tensor(np.ascontiguousarray(val_np, dtype=np.float32), device=dev)
    B, C = colmask.shape
    pre, vals_s = two_sided_prelude(idx, val, v, colmask)
    K_apply, KT_apply = ell_operators(idx, vals_s, pre)
    norm = power_norm(K_apply, KT_apply, B, C, dev)
    state = warm_scaled(pre, x0, lam0, mu0) + (norm, kkt_scale(pre))
    return idx, vals_s, pre, state


def dispatch_two_sided(
    idx_np: np.ndarray, val_np: np.ndarray, v, colmask, x0, lam0, mu0, tol, *,
    max_iters: int, check_every: int, sentinel: bool, log=None,
):
    """The fused two-sided solve for a batch of lanes sharing one column
    pack (numpy ``[C, k_pad]``, moved to ``v``'s device here). Lane tensors:
    ``colmask [B, C]``, ``x0 [B, C+1]``, ``lam0 [B, 2T]``, ``mu0 [B]``,
    ``tol [B]``. Returns ``(x [B, C+1], lam [B, 2T], mu [B], it [B],
    res [B], flags [B])``; the block loop is the kernel on a CUDA device and
    its plain version on the CPU."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import unscale

    on_cuda = v.device.type == "cuda"
    if on_cuda:
        csr = csr_to_device(idx_np, val_np, v.shape[0], v.device)
    idx, vals_s, pre, state = two_sided_setup(idx_np, val_np, v, colmask, x0, lam0, mu0)
    kw = dict(max_iters=max_iters, check_every=check_every, sentinel=sentinel)
    if on_cuda:
        out = two_sided_blocks_cuda(csr, idx, vals_s, pre, state, tol, **kw)
    else:
        out = two_sided_blocks_plain(idx, vals_s, pre, state, tol, **kw)
    p, eps, l_lo, l_up, mu, it, res, flags = out
    if log is not None:
        log.count("megakernel_dispatches")
        log.count("megakernel_lanes", colmask.shape[0])
    return unscale(pre, p, eps, l_lo, l_up, mu) + (it, res, flags)


# --- the generic-form LP ------------------------------------------------------


def lp_prelude(c, idx, val, h, A, b):
    """Ruiz equilibration of the stacked ``[G; A]`` with G as packed rows
    ``idx``/``val`` ``[m1, k_pad]`` over the nv variables (8 sweeps; the
    column norms of G are a ``scatter_reduce`` max over the packed values).
    Returns the :class:`~citizensassemblies_tpu_torch.solvers.lp_pdhg.LPScaled`
    data."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import LPScaled, _root
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_row_absmax

    m1 = idx.shape[0]
    nv = c.shape[0]
    dev = val.device
    absV = val.abs()
    absA = A.abs()
    d_r = torch.ones(m1 + A.shape[0], dtype=torch.float32, device=dev)
    d_c = torch.ones(nv, dtype=torch.float32, device=dev)
    for _ in range(8):
        Sg = absV * d_r[:m1, None] * d_c[idx]
        Sa = d_r[m1:, None] * absA * d_c[None, :]
        rmax = torch.cat([Sg.amax(dim=1), Sa.amax(dim=1)])
        cmax = torch.maximum(ell_row_absmax(idx, Sg, nv), Sa.amax(dim=0))
        d_r, d_c = d_r / _root(rmax), d_c / _root(cmax)
    return LPScaled(
        d_r=d_r, d_c=d_c, vals_s=(val * d_r[:m1, None] * d_c[idx]).contiguous(),
        As=(d_r[m1:, None] * A * d_c[None, :]).contiguous(), cs=c * d_c,
        hs=h * d_r[:m1], bs=b * d_r[m1:],
    )


def lp_operators(idx, vals_s, csr, gather=ell_gather_mv):
    """``(G_mv, G_rmv)`` over the scaled packed rows: the row gather
    (``gather``, the kernel wrapper by default) and its transpose over the
    variable-major CSR ``csr`` (:func:`csr_to_device` of the pack), each
    variable's products summed in row order by ``torch.segment_reduce``: a
    fixed order with no atomics, so an iteration count depends on the
    inputs alone, on the card as on the host."""
    perm, rowptr, rowT = csr
    vals_t = vals_s.reshape(-1)[perm]

    def G_rmv(y):
        return torch.segment_reduce(vals_t * y[rowT], "sum", offsets=rowptr)

    return (lambda x: gather(idx, vals_s, x)), G_rmv


def lp_setup(c, idx, val, h, A, b, x0, lam0, mu0, csr):
    """Everything before the block loop of a generic LP (tensors on one
    device; ``csr`` the pack's :func:`csr_to_device`): the Ruiz prelude,
    the power-iteration ‖K‖ and the scaled warm start. Returns ``(pre, (x,
    lam, mu, norm, scale))``."""
    pre = lp_prelude(c, idx, val, h, A, b)
    nv = c.shape[0]
    G_mv, G_rmv = lp_operators(idx, pre.vals_s, csr)
    As = pre.As

    def KtK(v):
        return G_rmv(G_mv(v)) + As.t() @ (As @ v)

    v = torch.ones(nv, dtype=torch.float32, device=c.device) / np.sqrt(np.float32(nv))
    for _ in range(40):
        w = KtK(v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    norm = torch.sqrt(torch.linalg.norm(KtK(v)) + 1e-12)
    return pre, pre.warm(x0, lam0, mu0) + (norm, pre.kkt_scale())


def lp_blocks_plain(csr, idx, pre, state, tol, *, max_iters, check_every, sentinel):
    """The LP block kernel's plain version: the same block loop in torch ops
    (``lp_pdhg._lp_iterate`` over the plain packed matvecs). Returns the
    scaled ``(x, lam, mu, it, res, flags)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _lp_iterate

    G_mv, G_rmv = lp_operators(idx, pre.vals_s, csr, gather=ell_gather_mv_plain)
    return _lp_iterate(
        G_mv, G_rmv, pre.As, pre.cs, pre.hs, pre.bs, *state, tol,
        max_iters, check_every, sentinel=sentinel,
    )


def lp_blocks_cuda(csr, idx, pre, state, tol, *, max_iters, check_every, sentinel):
    """Launch the LP block kernel on the prelude's output; ``csr`` is
    :func:`csr_to_device` of the same pack over the nv variables. Returns
    the scaled ``(x, lam, mu, it, res, flags)`` like the plain version, with
    ``it``/``res``/``flags`` as 0-d device tensors."""
    x, lam, mu, norm, scale = state
    nv, m1, m2 = x.shape[0], lam.shape[0], mu.shape[0]
    kp = idx.shape[1]
    dev = x.device
    if not lp_fits(nv, m1, m2):
        raise ValueError(f"an LP at nv={nv}, m1={m1}, m2={m2} does not fit the block kernel")
    perm, rowptr, rowT = csr
    idxS = idx.t().contiguous()
    vsS = pre.vals_s.t().contiguous()
    vsT = pre.vals_s.reshape(-1)[perm].contiguous()
    xk, lamk, muk = x.contiguous().clone(), lam.contiguous().clone(), mu.contiguous().clone()
    xav, lav, mav = xk.clone(), lamk.clone(), muk.clone()
    scal = torch.zeros(LP_LAYOUT["L_N"], dtype=torch.float32, device=dev)
    for slot, val in (
        ("L_RES", float("inf")), ("L_OMEGA", 1.0), ("L_BEST", float("inf")),
        ("L_NORM", norm), ("L_SCALE", scale), ("L_TOL", tol),
    ):
        scal[LP_LAYOUT[slot]] = val
    iters = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.empty((3, m1), dtype=torch.float32, device=dev)
    cs, hs, bs = pre.cs.contiguous(), pre.hs.contiguous(), pre.bs.contiguous()
    LP_KERNEL.call(
        "lp_solve_launch",
        ptr(idxS), ptr(vsS), ptr(rowptr), ptr(rowT), ptr(vsT), ptr(pre.As), ptr(cs),
        ptr(hs), ptr(bs), ptr(xk), ptr(xav), ptr(lamk), ptr(lav), ptr(muk), ptr(mav),
        ptr(scal), ptr(iters), ptr(scratch[0]), ptr(scratch[1]), ptr(scratch[2]),
        nv, m1, m2, kp, int(check_every), int(max_iters), int(bool(sentinel)),
        stream_of(xk),
    )
    flags = (scal[LP_LAYOUT["L_POIS"]] > 0).to(torch.int32) + 2 * (
        scal[LP_LAYOUT["L_STALL"]] > 0
    ).to(torch.int32)
    return xk, lamk, muk, iters[0], scal[LP_LAYOUT["L_RES"]], flags


def dispatch_lp(
    c, idx_np: np.ndarray, val_np: np.ndarray, h, A, b, x0, lam0, mu0, tol, *,
    device, max_iters: int, check_every: int, sentinel: bool, log=None,
):
    """The fused generic-LP solve on ``device``: numpy operands (the pack
    ``[m1, k_pad]`` over nv = ``len(c)`` variables, the dense ``A [m2, nv]``,
    the unscaled warm start). Returns the unscaled ``(x, lam, mu)`` tensors
    and ``(it, res, flags)`` as Python numbers; the block loop is the kernel
    on a CUDA device and its plain version on the CPU."""
    dev = torch.device(device)
    nv = len(c)
    csr = csr_to_device(idx_np, val_np, nv, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    t = [torch.as_tensor(np.asarray(a, np.float32), **f32) for a in (c, val_np, h, A, b, x0, lam0, mu0)]
    idx = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32), device=dev)
    pre, state = lp_setup(t[0], idx, *t[1:], csr)
    kw = dict(max_iters=max_iters, check_every=check_every, sentinel=sentinel)
    if dev.type == "cuda":
        out = lp_blocks_cuda(csr, idx, pre, state, tol, **kw)
    else:
        out = lp_blocks_plain(csr, idx, pre, state, tol, **kw)
    x, lam, mu, it, res, flags = out
    if log is not None:
        log.count("megakernel_dispatches")
        log.count("megakernel_lanes")
    return pre.unscale(x, lam, mu) + (int(it), float(res), int(flags))
