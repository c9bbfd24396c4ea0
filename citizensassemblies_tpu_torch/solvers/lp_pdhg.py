"""Two-sided decomposition master: restarted, preconditioned PDHG in torch.

The face decomposition's master LP

    min ε  s.t.  v − ε ≤ M p ≤ v + ε,  Σp = 1,  p ≥ 0, ε ≥ 0

is solved by primal-dual hybrid gradient (Chambolle–Pock) with Ruiz
equilibration, iterate averaging, restarts to the averaged iterate whenever
its KKT residual beats the current one, and a PDLP-style primal weight ω.
Termination is checked every ``cfg.pdhg_check_every`` iterations (a
*block*). Everything runs in float32.

Two routes compute the same solve (``Config.pdhg_megakernel``), both over
the master's columns packed as an ELL pack (a dense ``MT`` is packed first):

* **fused** — the hand-written CUDA block kernel
  (``kernels/pdhg_megakernel.py``): the whole block loop in one launch; its
  plain version on CPU tensors;
* **chained, ELL** — :func:`_pdhg_two_sided_body_ell`: the same prelude and
  :func:`_two_sided_iterate` over the packed operator (the gather kernel of
  ``kernels/ell_matvec.py`` on CUDA for the adjoint, a segment sum over
  the pack's type-major CSR for the forward product).

The chained route reads every lane's residual on the host after each
block; the fused route never does. Both freeze a lane exactly as the
JAX package's ``while_loop`` does, and share the ``(x, lam, mu)`` layout:
``x = [p (Cp), ε]``, ``lam = [λ_lo (T), λ_up (T)]``, ``mu = [μ]``.

Under ``Config.mixed_precision`` the read-only operator matrices go to the
device as bf16 where the committed plan certifies them and their round
trip is exact (``utils/precision.demote_operator``, at the JAX package's
four sites); the preludes widen them exactly, so the iterates are bitwise
those of the float32 operands. Each solve consults the ``pdhg_nan`` fault
site (``robust/inject.py``), which poisons its warm start for the sentinel
to quarantine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.aot.store import GraphEntry, SeededGraph, register_block
from citizensassemblies_tpu_torch.lint.operands import (
    LP_RANGES,
    RANGE_WIDE,
    TWO_SIDED_RANGES,
    dense_lp_operands,
    ell_operands,
    two_sided_lanes,
)
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.obs.trace import DeviceValue
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.utils.guards import (
    guarded_launch,
    no_implicit_transfers,
    readback,
)
from citizensassemblies_tpu_torch.utils.precision import demote_operator, iterate_dtype, operand_tensor


@dataclasses.dataclass
class LPSolution:
    """Result of a PDHG solve."""

    ok: bool
    x: np.ndarray
    lam: np.ndarray
    mu: np.ndarray
    objective: float
    iters: int
    kkt: float


# --- numerical sentinels -----------------------------------------------------
# With ``Config.robust_sentinels`` on, a block whose KKT residual goes
# non-finite is REJECTED (the carry freezes at the last finite iterate), the
# lane exits with bit 1 set and the caller re-solves it on the float64 host
# path. Bit 2 is the report-only stall flag: _STALL_BLOCKS consecutive checks
# without a new best residual. Zero-fault runs are identical with the
# sentinel on or off.

#: consecutive convergence checks without a new best residual before the
#: stall bit is reported
_STALL_BLOCKS = 64

FLAG_POISONED = 1
FLAG_STALLED = 2


def sentinels_enabled(cfg: Optional[Config]) -> bool:
    cfg = cfg or default_config()
    return bool(cfg.robust_sentinels)


Apply = Callable[..., Tuple[torch.Tensor, ...]]


def _two_sided_block(K_apply: Apply, KT_apply: Apply, cs_eps, hs_lo, hs_up, bs, check_every: int):
    """One block of the two-sided master: ``check_every`` PDHG iterations
    from ``(q, e, lo, up, m)`` at steps ``(tau, sigma)``, returning the last
    iterate and the block's sums."""

    def block(q, e, lo, up, m, tau, sigma):
        ps = torch.zeros_like(q)
        es = torch.zeros_like(e)
        lls = torch.zeros_like(lo)
        lus = torch.zeros_like(up)
        ms = torch.zeros_like(m)
        for _ in range(check_every):
            g_p, g_e = KT_apply(lo, up, m)
            q_new = torch.clamp_min(q - tau[:, None] * g_p, 0.0)
            e_new = torch.clamp_min(e - tau * (g_e + cs_eps), 0.0)
            qb = 2.0 * q_new - q
            eb = 2.0 * e_new - e
            r_lo, r_up, r_eq = K_apply(qb, eb)
            lo = torch.clamp_min(lo + sigma[:, None] * (r_lo - hs_lo), 0.0)
            up = torch.clamp_min(up + sigma[:, None] * (r_up - hs_up), 0.0)
            m = m + sigma * (r_eq - bs)
            q, e = q_new, e_new
            ps, es, lls, lus, ms = ps + q, es + e, lls + lo, lus + up, ms + m
        return q, e, lo, up, m, ps, es, lls, lus, ms

    return block


@register_block("lp_pdhg.two_sided_block")
def _two_sided_block_factory(check_every: int, sentinel: bool = False):
    """The two-sided block over the packed operator's tensors
    (``kernels/pdhg_megakernel.ell_operator_tensors``) and the scaled
    ``(cs_eps, hs_lo, hs_up, bs)``: the graph store's block factory."""

    def make(idx, vals_s, vals_t, colT, offsets, e_col, a_row, cs_eps, hs_lo, hs_up, bs):
        from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

        K_apply, KT_apply = mk.ell_operators_from(idx, vals_s, vals_t, colT, offsets, e_col, a_row)
        return _two_sided_block(K_apply, KT_apply, cs_eps, hs_lo, hs_up, bs, int(check_every))

    return make


def _prepare(run, *args) -> None:
    """Let a store-backed runner acquire its graph before the caller opens
    the launch window (``aot/store.SeededGraph.prepare``)."""
    prepare = getattr(run, "prepare", None)
    if prepare is not None:
        prepare(*args)


def _two_sided_iterate(
    K_apply: Apply, KT_apply: Apply, cs_eps, hs_lo, hs_up, bs,
    p, eps, l_lo, l_up, mu, norm, scale, tol,
    max_iters: int, check_every: int, sentinel: bool = False, graph: Optional[bool] = None,
    seed=None,
):
    """The restart-to-average PDHG block loop of the two-sided master,
    batched over lanes (leading axis B on every vector, ``[B]`` scalars),
    generic over the scaled operator pair ``K_apply(p, eps) -> (r_lo, r_up,
    r_eq)`` and ``KT_apply(l_lo, l_up, mu) -> (g_p, g_e)``.

    A lane runs blocks while ``res > tol & it < max_iters`` and (with the
    sentinel) it is not poisoned; a lane whose mask is clear keeps its state
    unchanged. The loop stops when no lane is active, which reads the masks
    on the host once per block. With ``graph`` (default: on CUDA tensors)
    a solve that reaches its second block replays the block's
    ``check_every`` iterations as a CUDA graph from the graph store
    (``aot/store.py``), as :func:`_lp_iterate` does: ``seed`` is ``(family,
    operands)``, the store family and the operator's tensors the block
    reads (:func:`_two_sided_block_factory`). Returns the scaled ``(p, eps,
    l_lo, l_up, mu, it, res, flags)``.
    """
    B = p.shape[0]
    dev = p.device
    graph = p.is_cuda if graph is None else graph

    def kkt(p, eps, l_lo, l_up, mu):
        r_lo, r_up, r_eq = K_apply(p, eps)
        pri = torch.sqrt(
            torch.sum(torch.clamp_min(r_lo - hs_lo, 0.0) ** 2, dim=1)
            + torch.sum(torch.clamp_min(r_up - hs_up, 0.0) ** 2, dim=1)
            + (r_eq - bs) ** 2
        )
        g_p, g_e = KT_apply(l_lo, l_up, mu)
        dua = torch.sqrt(
            torch.sum(torch.clamp_max(g_p, 0.0) ** 2, dim=1)
            + torch.clamp_max(g_e + cs_eps, 0.0) ** 2
        )
        pobj = cs_eps * eps
        dobj = -(l_lo * hs_lo).sum(1) - (l_up * hs_up).sum(1) - mu * bs
        gap = torch.abs(pobj - dobj)
        return (pri + dua) / scale + gap / (1.0 + torch.abs(pobj) + torch.abs(dobj))

    p_av, e_av, ll_av, lu_av, m_av = p, eps, l_lo, l_up, mu
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    res = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    omega = torch.ones(B, dtype=torch.float32, device=dev)
    pois = torch.zeros(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.bool, device=dev)
    best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros(B, dtype=torch.int32, device=dev)
    inv = 1.0 / check_every

    def sel(mask, new, old):
        return torch.where(mask.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

    run = block = _two_sided_block(K_apply, KT_apply, cs_eps, hs_lo, hs_up, bs, check_every)
    if graph and seed is None:
        raise ValueError("a graph-replayed solve takes its operands (seed=)")
    if seed is not None:
        family, operands = seed
        run = SeededGraph(
            family, "lp_pdhg.two_sided_block",
            {"check_every": int(check_every), "sentinel": bool(sentinel)},
            tuple(operands) + (cs_eps, hs_lo, hs_up, bs), eager=block, graph=graph,
        )
    while True:
        active = (res > tol) & (it < max_iters) & ~pois
        with readback():
            done = not bool(active.any())
        if done:
            break
        tau = 0.9 * omega / norm
        sigma = 0.9 / (omega * norm)
        p_in, e_in, ll_in, lu_in, mu_in = p, eps, l_lo, l_up, mu
        _prepare(run, p, eps, l_lo, l_up, mu, tau, sigma)
        with guarded_launch(dev):
            q, e, lo, up, m, ps, es, lls, lus, ms = run(p, eps, l_lo, l_up, mu, tau, sigma)
        pa = (p_av + ps * inv) * 0.5
        ea = (e_av + es * inv) * 0.5
        lla = (ll_av + lls * inv) * 0.5
        lua = (lu_av + lus * inv) * 0.5
        ma = (m_av + ms * inv) * 0.5
        r_cur = kkt(q, e, lo, up, m)
        r_avg = kkt(pa, ea, lla, lua, ma)
        better = r_avg < r_cur
        q, e = sel(better, pa, q), sel(better, ea, e)
        lo, up, m = sel(better, lla, lo), sel(better, lua, up), sel(better, ma, m)
        res_new = torch.minimum(r_cur, r_avg)
        dx = torch.sqrt(torch.sum((q - p_in) ** 2, dim=1))
        dy = torch.sqrt(
            torch.sum((lo - ll_in) ** 2, dim=1)
            + torch.sum((up - lu_in) ** 2, dim=1)
            + (m - mu_in) ** 2
        )
        moved = (dx > 1e-12) & (dy > 1e-12)
        omega_new = torch.sqrt(
            omega * torch.clamp(dy / torch.clamp_min(dx, 1e-12), 1e-4, 1e4)
        )
        omega_out = torch.where(moved, torch.clamp(omega_new, 1.0 / 64.0, 64.0), omega)
        it_out = it + check_every
        if sentinel:
            # a non-finite residual reverts the whole carry to the block
            # start and quarantines the lane
            ok = torch.isfinite(res_new)
        else:
            ok = torch.ones(B, dtype=torch.bool, device=dev)
        q, e = sel(ok, q, p_in), sel(ok, e, e_in)
        lo, up, m = sel(ok, lo, ll_in), sel(ok, up, lu_in), sel(ok, m, mu_in)
        pa, ea = sel(ok, pa, p_av), sel(ok, ea, e_av)
        lla, lua, ma = sel(ok, lla, ll_av), sel(ok, lua, lu_av), sel(ok, ma, m_av)
        it_out = torch.where(ok, it_out, it)
        res_new = torch.where(ok, res_new, res)
        omega_out = torch.where(ok, omega_out, omega)
        if sentinel:
            improved = ok & (res_new < best)
            best_new = torch.where(improved, res_new, best)
            since_new = torch.where(improved, torch.zeros_like(since), since + 1)
            pois_new = pois | ~ok
            stall_new = stall | (since_new >= _STALL_BLOCKS)
        else:
            best_new, since_new, pois_new, stall_new = best, since, pois, stall
        p, eps = sel(active, q, p), sel(active, e, eps)
        l_lo, l_up, mu = sel(active, lo, l_lo), sel(active, up, l_up), sel(active, m, mu)
        p_av, e_av = sel(active, pa, p_av), sel(active, ea, e_av)
        ll_av, lu_av, m_av = sel(active, lla, ll_av), sel(active, lua, lu_av), sel(active, ma, m_av)
        it = torch.where(active, it_out, it)
        res = torch.where(active, res_new, res)
        omega = torch.where(active, omega_out, omega)
        best = torch.where(active, best_new, best)
        since = torch.where(active, since_new, since)
        pois = torch.where(active, pois_new, pois)
        stall = torch.where(active, stall_new, stall)
    flags = pois.to(torch.int32) * FLAG_POISONED + stall.to(torch.int32) * FLAG_STALLED
    return p, eps, l_lo, l_up, mu, it, res, flags


def _root(x: torch.Tensor) -> torch.Tensor:
    """Ruiz divisor: sqrt of a positive norm, 1 where the norm is 0."""
    return torch.where(x > 0, torch.sqrt(torch.clamp_min(x, 1e-10)), 1.0)


@dataclasses.dataclass
class _TwoSidedScaled:
    """Scalings and scaled data of a batch of two-sided masters."""

    d_r: torch.Tensor  # [B, T]
    d_e: torch.Tensor  # [B]
    d_c: torch.Tensor  # [B, C]
    d_eps: torch.Tensor  # [B]
    e_col: torch.Tensor  # [B, T]
    a_row: torch.Tensor  # [B, C]
    hs_lo: torch.Tensor  # [B, T]
    hs_up: torch.Tensor  # [B, T]
    bs: torch.Tensor  # [B]
    cs_eps: torch.Tensor  # [B]


def power_norm(K_apply: Apply, KT_apply: Apply, B: int, C: int, device) -> torch.Tensor:
    """‖K‖₂ per lane by 40 power iterations on KᵀK."""
    pv = torch.ones((B, C), dtype=torch.float32, device=device) / np.sqrt(np.float32(C + 1))
    ev = torch.ones(B, dtype=torch.float32, device=device) / np.sqrt(np.float32(C + 1))
    for _ in range(40):
        r_lo, r_up, r_eq = K_apply(pv, ev)
        g_p, g_e = KT_apply(r_lo, r_up, r_eq)
        nrm = torch.sqrt(torch.sum(g_p**2, dim=1) + g_e**2) + 1e-12
        pv, ev = g_p / nrm[:, None], g_e / nrm
    r_lo, r_up, r_eq = K_apply(pv, ev)
    g_p, g_e = KT_apply(r_lo, r_up, r_eq)
    return torch.sqrt(torch.sqrt(torch.sum(g_p**2, dim=1) + g_e**2) + 1e-12)


def warm_scaled(pre: _TwoSidedScaled, x0, lam0, mu0):
    """Map unscaled warm starts into scaled coordinates (``x = D_c x̃``)."""
    T = pre.d_r.shape[1]
    C = pre.d_c.shape[1]
    p = x0[:, :C] / torch.clamp_min(pre.d_c, 1e-12)
    eps = x0[:, C] / torch.clamp_min(pre.d_eps, 1e-12)
    l_lo = torch.clamp_min(lam0[:, :T] / torch.clamp_min(pre.d_r, 1e-12), 0.0)
    l_up = torch.clamp_min(lam0[:, T:] / torch.clamp_min(pre.d_r, 1e-12), 0.0)
    mu = mu0 / torch.clamp_min(pre.d_e, 1e-12)
    return p, eps, l_lo, l_up, mu


def kkt_scale(pre: _TwoSidedScaled) -> torch.Tensor:
    return (
        1.0
        + torch.abs(pre.cs_eps)
        + torch.sqrt(torch.sum(pre.hs_lo**2, dim=1) + torch.sum(pre.hs_up**2, dim=1))
        + torch.abs(pre.bs)
    )


def unscale(pre: _TwoSidedScaled, p, eps, l_lo, l_up, mu):
    """Scaled iterates → ``(x [B, C+1], lam [B, 2T], mu [B])``."""
    x_out = torch.cat([p * pre.d_c, (eps * pre.d_eps)[:, None]], dim=1)
    lam_out = torch.cat([l_lo * pre.d_r, l_up * pre.d_r], dim=1)
    return x_out, lam_out, mu * pre.d_e


def _solve_scaled(pre, K_apply, KT_apply, x0, lam0, mu0, tol, max_iters, check_every, sentinel,
                  graph: Optional[bool] = None, seed=None):
    B, C = pre.d_c.shape
    norm = power_norm(K_apply, KT_apply, B, C, pre.d_c.device)
    p, eps, l_lo, l_up, mu = warm_scaled(pre, x0, lam0, mu0)
    p, eps, l_lo, l_up, mu, it, res, flags = _two_sided_iterate(
        K_apply, KT_apply, pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs,
        p, eps, l_lo, l_up, mu, norm, kkt_scale(pre), tol,
        max_iters, check_every, sentinel=sentinel, graph=graph, seed=seed,
    )
    x_out, lam_out, mu_out = unscale(pre, p, eps, l_lo, l_up, mu)
    return x_out, lam_out, mu_out, it, res, flags


def _pdhg_two_sided_body_ell(
    idx, val, v, colmask, x0, lam0, mu0, tol, csr,
    max_iters: int, check_every: int, sentinel: bool = False, graph: Optional[bool] = None,
    family: str = "lp_pdhg.two_sided_core_ell",
):
    """The chained ELL route: the two-sided master over the packed columns
    ``idx``/``val`` ``[C, k_pad]`` (minor axis = the T types; ``csr`` their
    type-major transpose, ``kernels/pdhg_megakernel.csr_to_device``),
    batched over the lanes of ``colmask``/``x0``/``lam0``/``mu0``/``tol``.
    Same prelude as the fused route
    (``kernels/pdhg_megakernel.two_sided_prelude``), then
    :func:`_two_sided_iterate` with the packed matvecs, its blocks replayed
    as a CUDA graph of the store's ``family`` with ``graph`` (default: on
    CUDA tensors)."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    pre, vals_s = mk.two_sided_prelude(idx, val, v, colmask)
    ops = mk.ell_operator_tensors(idx, vals_s, pre, csr)
    K_apply, KT_apply = mk.ell_operators_from(*ops)
    return _solve_scaled(
        pre, K_apply, KT_apply, x0, lam0, mu0, tol, max_iters, check_every, sentinel, graph=graph,
        seed=(family, ops),
    )


@dataclasses.dataclass
class MasterHandle:
    """An in-flight two-sided master solve: device outputs plus the decode
    metadata; :func:`finish_two_sided_master` is the blocking readback."""

    out: torch.Tensor  # [Cp+1 + 2T + 4] f32: x, lam, mu, it, res, flags
    Cp: int
    T: int
    tol: float

    @property
    def lam(self) -> torch.Tensor:
        """The solve's unscaled duals ``[λ_lo (T), λ_up (T)]`` on the device
        (a view: work queued on it runs behind the solve in stream order)."""
        return self.out[self.Cp + 1 : self.Cp + 1 + 2 * self.T]


def _handle(x, lam, mu, it, res, flags, Cp: int, T: int, tol: float) -> MasterHandle:
    """Pack one lane's outputs into one device vector, so the readback is
    a single copy."""
    tail = torch.stack([mu.reshape(()), it.to(torch.float32).reshape(()),
                        res.reshape(()), flags.to(torch.float32).reshape(())])
    return MasterHandle(
        out=torch.cat([x.reshape(-1), lam.reshape(-1), tail]), Cp=Cp, T=T, tol=tol
    )


def finish_two_sided_master(h: MasterHandle) -> LPSolution:
    """Blocking readback half of the async master solve. A sentinel-
    quarantined solve comes back with ``ok=False``."""
    host = h.out.cpu().numpy().astype(np.float64)
    n_x = h.Cp + 1
    x = host[:n_x]
    lam = host[n_x : n_x + 2 * h.T]
    mu, it, res_f, flags = host[n_x + 2 * h.T :]
    poisoned = bool(int(flags) & FLAG_POISONED)
    return LPSolution(
        ok=bool(res_f <= h.tol * 4.0) and not poisoned,
        x=x,
        lam=lam,
        mu=np.array([mu]),
        objective=float(x[h.Cp]),
        iters=int(it),
        kkt=float(res_f),
    )


def _warm_arrays(warm, C: int, Cp: int, T: int):
    """Warm triple (x, λ, μ) re-sliced into a ``Cp``-column bucket."""
    x0 = np.zeros(Cp + 1, dtype=np.float32)
    lam0 = np.zeros(2 * T, dtype=np.float32)
    mu0 = np.float32(0.0)
    if warm is not None:
        m = min(C, len(warm[0]) - 1)
        x0[:m] = warm[0][:m]
        x0[Cp] = warm[0][-1]
        lam0[: min(2 * T, len(warm[1]))] = warm[1][: 2 * T]
        mu0 = np.float32(warm[2][0] if np.ndim(warm[2]) else warm[2])
    return x0, lam0, mu0


def solve_two_sided_master_async(
    MT: np.ndarray,
    v: np.ndarray,
    cfg: Optional[Config] = None,
    warm=None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    bucket: int = 2048,
    device: DeviceLike = None,
    log=None,
) -> MasterHandle:
    """Dispatch half of :func:`solve_two_sided_master`: the outputs stay on
    the device until :func:`finish_two_sided_master`. The dense master is
    packed by columns and solved by :func:`solve_two_sided_master_ell_async`
    (the same LP), on whichever route the gate picks."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    T = MT.shape[0]
    with dispatch_span(
        "lp_pdhg.two_sided_core", cfg=cfg, log=log, T=int(T), cols=int(MT.shape[1]),
    ) as ds:
        ds.out = handle = solve_two_sided_master_ell_async(
            EllPack.from_rows(np.asarray(MT, np.float32).T, minor=T), v, cfg=cfg, warm=warm,
            tol=tol, max_iters=max_iters, bucket=bucket, device=device, log=log,
        )
    return handle


def solve_two_sided_master(MT, v, cfg=None, warm=None, tol=None, max_iters=None,
                           bucket: int = 2048, device: DeviceLike = None, log=None) -> LPSolution:
    """Device solve of the two-sided ε master over a dense ``MT`` (blocking)."""
    return finish_two_sided_master(
        solve_two_sided_master_async(
            MT, v, cfg=cfg, warm=warm, tol=tol, max_iters=max_iters,
            bucket=bucket, device=device, log=log,
        )
    )


def solve_two_sided_master_ell_async(
    ell,
    v: np.ndarray,
    cfg: Optional[Config] = None,
    warm=None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    bucket: int = 2048,
    device: DeviceLike = None,
    log=None,
) -> MasterHandle:
    """Dispatch half of :func:`solve_two_sided_master_ell`. ``ell`` is an
    :class:`~citizensassemblies_tpu_torch.solvers.sparse_ops.EllPack` of the
    master's COLUMNS (minor axis = the T types); columns pad to ``bucket``
    (all-zero packed rows are inert)."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    cfg = cfg or default_config()
    dev = resolve_device(device)
    tol = float(tol if tol is not None else cfg.pdhg_tol)
    T = int(ell.minor)
    C = len(ell)
    Cp = ((C + bucket - 1) // bucket) * bucket
    idx_p, val_p = ell.padded(Cp)
    x0, lam0, mu0 = _warm_arrays(warm, C, Cp, T)
    if inject.site("pdhg_nan", log):
        x0[0] = np.nan  # the sentinel must quarantine, the round recover
    val_d = demote_operator(
        val_p, cfg, core="lp_pdhg.two_sided_core_ell", arg=1, log=log, device=dev
    )
    colmask = np.zeros(Cp, dtype=np.float32)
    colmask[:C] = 1.0
    mi = int(max_iters if max_iters is not None else cfg.pdhg_max_iters)
    ce = int(cfg.pdhg_check_every)
    sent = sentinels_enabled(cfg)
    fused = mk.megakernel_mode(cfg, T, Cp, dev, log=log) != "off"
    if not fused:
        # uploaded before the lane vectors, so the copy does not wait
        csr = mk.csr_to_device(idx_p, val_p, T, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lanes = (
        torch.as_tensor(np.asarray(v, np.float32), **f32),
        torch.as_tensor(colmask, **f32)[None],
        torch.as_tensor(x0, **f32)[None],
        torch.as_tensor(lam0, **f32)[None],
        torch.full((1,), float(mu0), **f32),
        torch.full((1,), tol, **f32),
    )
    with dispatch_span(
        "lp_pdhg.two_sided_core_ell", cfg=cfg, log=log, T=T, cols=int(Cp),
        kp=int(idx_p.shape[1]), nnz=int(np.count_nonzero(val_p)), lanes=1, check_every=ce,
    ) as ds, no_implicit_transfers(cfg):
        if fused:
            # fused route: one kernel launch for the whole solve
            out = mk.dispatch_two_sided(
                idx_p, val_d, *lanes, max_iters=mi, check_every=ce, sentinel=sent,
                log=log, cfg=cfg,
            )
        else:
            out = _pdhg_two_sided_body_ell(
                torch.as_tensor(idx_p, dtype=torch.int32, device=dev),
                operand_tensor(val_d, dev), *lanes, csr,
                max_iters=mi, check_every=ce, sentinel=sent,
            )
        ds.out = out
        ds.note(iters=DeviceValue(out[3]))
    return _handle(*(o[0] for o in out), Cp=Cp, T=T, tol=tol)


def solve_two_sided_master_ell(ell, v, cfg=None, warm=None, tol=None, max_iters=None,
                               bucket: int = 2048, device: DeviceLike = None, log=None) -> LPSolution:
    """Blocking wrapper of :func:`solve_two_sided_master_ell_async` (same
    (x, lam, mu) layout and warm-start contract as the dense master)."""
    return finish_two_sided_master(
        solve_two_sided_master_ell_async(
            ell, v, cfg=cfg, warm=warm, tol=tol, max_iters=max_iters,
            bucket=bucket, device=device, log=log,
        )
    )


# --- generic-form PDHG: min cᵀx  s.t.  Gx ≤ h, Ax = b, x ≥ 0 ------------------
# The dual leximin LP of the agent-space column generation and the final
# primal LP. Variables x = D_c x̃, duals y = D_r ỹ after Ruiz equilibration of
# the stacked [G; A]; the same restart-to-average block loop as the two-sided
# master, one lane. Two ELL routes (``Config.pdhg_megakernel``): the fused
# block kernel (``kernels/pdhg_megakernel.dispatch_lp``) and the chained
# :func:`_pdhg_body_ell`; a dense chained core :func:`_pdhg_body` serves
# inequality blocks above the ELL fill cutoff.


def _replay_closure(static, outs, replay: Callable, captured) -> Callable:
    """The function that runs a captured graph over argument buffers
    ``static`` (no operands): copy the arguments in, ``replay()``, count the
    ``captured`` launches and return clones of its ``outs``, under the
    graph's own lock (``aot/store.GraphEntry``)."""
    entry = GraphEntry((), static, outs, replay, captured)

    def run(*a):
        return entry.run((), a)

    return run


def _lp_block(G_mv: Apply, G_rmv: Apply, As, cs, hs, bs, check_every: int):
    """One block of the generic LP: ``check_every`` PDHG iterations from
    ``(q, y, m)`` at steps ``(tau, sigma)``, returning the last iterate and
    the block's sums."""

    def block(q, y, m, tau, sigma):
        xs, ls, ms = torch.zeros_like(q), torch.zeros_like(y), torch.zeros_like(m)
        for _ in range(check_every):
            grad = cs + G_rmv(y) + As.t() @ m
            q_new = torch.clamp_min(q - tau * grad, 0.0)
            qb = 2.0 * q_new - q
            y = torch.clamp_min(y + sigma * (G_mv(qb) - hs), 0.0)
            m = m + sigma * (As @ qb - bs)
            q = q_new
            xs, ls, ms = xs + q, ls + y, ms + m
        return q, y, m, xs, ls, ms

    return block


@register_block("lp_pdhg.lp_block_dense")
def _lp_block_dense_factory(check_every: int, m1: int, sentinel: bool = False):
    """The dense LP block over the scaled stacked ``Ks = [G; A]`` (rows
    ``:m1`` the inequality block) and the scaled ``(cs, hs, bs)``: the graph
    store's block factory."""

    def make(Ks, cs, hs, bs):
        Gs, As = Ks[: int(m1)], Ks[int(m1):]
        return _lp_block(lambda q: Gs @ q, lambda y: Gs.t() @ y, As, cs, hs, bs, int(check_every))

    return make


def _lp_iterate(
    G_mv: Apply, G_rmv: Apply, As, cs, hs, bs, x, lam, mu, norm, scale, tol,
    max_iters: int, check_every: int, sentinel: bool = False, graph: bool = False, seed=None,
):
    """The restart-to-average PDHG block loop of the generic LP in scaled
    coordinates, generic over ``G_mv(x) -> Gx`` and ``G_rmv(λ) -> Gᵀλ``
    (``As`` is the dense scaled equality block). Runs blocks while ``res >
    tol`` and ``it < max_iters`` and (with the sentinel) the solve is not
    poisoned; reads the residual on the host once per block. With ``graph``
    (CUDA tensors, matvecs of plain torch ops only) a solve that reaches its
    second block replays the block's ``check_every`` iterations as a CUDA
    graph from the graph store (``aot/store.py``): the same kernels in the
    same order, without a host launch per operation. ``seed`` is
    ``(family, (Ks, m1))``, the store family and the scaled stacked matrix
    the dense block reads (:func:`_lp_block_dense_factory`). Returns the
    scaled ``(x, lam, mu, it, res, flags)`` with ``it``/``flags`` ints and
    ``res`` a float."""
    tol32 = float(np.float32(tol))
    run = block = _lp_block(G_mv, G_rmv, As, cs, hs, bs, check_every)
    if graph and seed is None:
        raise ValueError("a graph-replayed solve takes its operands (seed=)")
    if seed is not None:
        family, (Ks, m1) = seed
        run = SeededGraph(
            family, "lp_pdhg.lp_block_dense",
            {"check_every": int(check_every), "m1": int(m1), "sentinel": bool(sentinel)},
            (Ks, cs, hs, bs), eager=block, graph=graph,
        )

    def kkt(x, lam, mu):
        pri_ineq = torch.clamp_min(G_mv(x) - hs, 0.0)
        pri_eq = As @ x - bs
        pri = torch.sqrt(torch.sum(pri_ineq**2) + torch.sum(pri_eq**2))
        grad = cs + G_rmv(lam) + As.t() @ mu
        dua = torch.sqrt(torch.sum(torch.clamp_max(grad, 0.0) ** 2))
        pobj = torch.sum(cs * x)
        dobj = -torch.sum(lam * hs) - torch.sum(mu * bs)
        gap = torch.abs(pobj - dobj)
        return (pri + dua) / scale + gap / (1.0 + torch.abs(pobj) + torch.abs(dobj))

    x_av, lam_av, mu_av = x, lam, mu
    it = 0
    res = float("inf")
    omega = torch.ones((), dtype=torch.float32, device=x.device)
    pois = stall = False
    best = float("inf")
    since = 0
    inv = 1.0 / check_every
    while res > tol32 and it < max_iters and not pois:
        tau = 0.9 * omega / norm
        sigma = 0.9 / (omega * norm)
        x_in, lam_in, mu_in = x, lam, mu
        _prepare(run, x, lam, mu, tau, sigma)
        with guarded_launch(x.device):
            q, y, m, xs, ls, ms = run(x, lam, mu, tau, sigma)
        xa = (x_av + xs * inv) * 0.5
        la = (lam_av + ls * inv) * 0.5
        ma = (mu_av + ms * inv) * 0.5
        r_cur = kkt(q, y, m)
        r_avg = kkt(xa, la, ma)
        better = r_avg < r_cur
        q, y, m = torch.where(better, xa, q), torch.where(better, la, y), torch.where(better, ma, m)
        res_t = torch.minimum(r_cur, r_avg)
        dx = torch.sqrt(torch.sum((q - x_in) ** 2))
        dy = torch.sqrt(torch.sum((y - lam_in) ** 2) + torch.sum((m - mu_in) ** 2))
        moved = (dx > 1e-12) & (dy > 1e-12)
        omega_new = torch.sqrt(omega * torch.clamp(dy / torch.clamp_min(dx, 1e-12), 1e-4, 1e4))
        omega_out = torch.where(moved, torch.clamp(omega_new, 1.0 / 64.0, 64.0), omega)
        with readback():
            res_new = float(res_t)
        # the sentinel rejects a block whose residual is not finite: the
        # carry stays at the block start and the solve is quarantined
        ok = not sentinel or bool(np.isfinite(res_new))
        if ok:
            x, lam, mu = q, y, m
            x_av, lam_av, mu_av = xa, la, ma
            it += check_every
            res = res_new
            omega = omega_out
        if sentinel:
            if ok and res < best:
                best, since = res, 0
            else:
                since += 1
            pois = pois or not ok
            stall = stall or since >= _STALL_BLOCKS
    flags = FLAG_POISONED * int(pois) + FLAG_STALLED * int(stall)
    return x, lam, mu, it, res, flags


def _pdhg_body_ell(
    c, idx, val, h, A, b, x0, lam0, mu0, tol, csr,
    max_iters: int, check_every: int, sentinel: bool = False,
):
    """The chained ELL route of the generic LP: ``G`` as packed rows
    ``idx``/``val`` ``[m1, k_pad]`` over the nv variables (``csr`` its
    variable-major transpose, ``kernels/pdhg_megakernel.csr_to_device``),
    the dense equality block ``A [m2, nv]``. Same prelude as the fused route
    (``kernels/pdhg_megakernel.lp_setup``), then :func:`_lp_iterate` with
    the packed matvecs (the gather kernel on CUDA, a segment sum over the
    CSR for the transpose). Returns the unscaled ``(x, lam, mu, it, res,
    flags)``."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    pre, state = mk.lp_setup(c, idx, val, h, A, b, x0, lam0, mu0, csr)
    G_mv, G_rmv = mk.lp_operators(idx, pre.vals_s, csr)
    out = _lp_iterate(
        G_mv, G_rmv, pre.As, pre.cs, pre.hs, pre.bs, *state, tol,
        max_iters, check_every, sentinel=sentinel,
    )
    return pre.unscale(*out[:3]) + out[3:]


def _pdhg_body(
    c, G, h, A, b, x0, lam0, mu0, tol,
    max_iters: int, check_every: int, sentinel: bool = False, graph: Optional[bool] = None,
    family: str = "lp_pdhg.pdhg_core",
):
    """The dense chained core of the generic LP (``G`` a dense ``[m1, nv]``
    tensor; ``G`` and ``A`` float32 or demoted bf16): Ruiz on the stacked
    ``[G; A]``, the power-iteration ‖K‖ and
    :func:`_lp_iterate` with dense matvecs, its blocks replayed as a CUDA
    graph of the store's ``family`` when ``graph`` (default: on CUDA
    tensors). Returns the unscaled ``(x, lam, mu, it, res, flags)``."""
    m1 = G.shape[0]
    pre, Ks, state = _dense_lp_setup(c, G, h, A, b, x0, lam0, mu0)
    Gs = Ks[:m1]
    out = _lp_iterate(
        lambda q: Gs @ q, lambda y: Gs.t() @ y, pre.As, pre.cs, pre.hs, pre.bs,
        *state, tol, max_iters, check_every, sentinel=sentinel,
        graph=Ks.is_cuda if graph is None else graph, seed=(family, (Ks, m1)),
    )
    return pre.unscale(*out[:3]) + out[3:]


def _dense_lp_setup(c, G, h, A, b, x0, lam0, mu0):
    """Everything before the dense LP's block loop: Ruiz on the stacked
    ``[G; A]``, the power-iteration ‖K‖ and the scaled warm start. Returns
    ``(pre, Ks, (x, lam, mu, norm, scale))``."""
    m1, nv = G.shape
    # a demoted bf16 G or A is widened exactly by the products with the
    # float32 scalings below: Ks and every matvec are float32
    K = torch.cat([G, A], dim=0)
    d_r = torch.ones(K.shape[0], dtype=iterate_dtype(K.dtype), device=K.device)
    d_c = torch.ones(nv, dtype=iterate_dtype(K.dtype), device=K.device)
    absK = K.abs()
    for _ in range(8):
        S = d_r[:, None] * absK * d_c[None, :]
        d_r, d_c = d_r / _root(S.amax(dim=1)), d_c / _root(S.amax(dim=0))
    Ks = d_r[:, None] * K * d_c[None, :]
    pre = LPScaled(d_r=d_r, d_c=d_c, vals_s=None, As=Ks[m1:], cs=c * d_c,
                   hs=h * d_r[:m1], bs=b * d_r[m1:])
    v = torch.ones(nv, dtype=torch.float32, device=K.device) / np.sqrt(np.float32(nv))
    for _ in range(40):
        w = Ks.t() @ (Ks @ v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    norm = torch.sqrt(torch.linalg.norm(Ks.t() @ (Ks @ v)) + 1e-12)
    return pre, Ks, pre.warm(x0, lam0, mu0) + (norm, pre.kkt_scale())


@dataclasses.dataclass
class LPScaled:
    """Scalings and scaled data of one generic LP (rows of ``d_r``: the m1
    inequality rows, then the m2 equality rows)."""

    d_r: torch.Tensor  # [m1 + m2]
    d_c: torch.Tensor  # [nv]
    vals_s: Optional[torch.Tensor]  # [m1, k_pad] scaled pack (ELL routes)
    As: torch.Tensor  # [m2, nv]
    cs: torch.Tensor  # [nv]
    hs: torch.Tensor  # [m1]
    bs: torch.Tensor  # [m2]

    @property
    def m1(self) -> int:
        return self.hs.shape[0]

    def warm(self, x0, lam0, mu0):
        """Unscaled warm start → scaled ``(x, lam, mu)``."""
        m1 = self.m1
        x = x0 / torch.clamp_min(self.d_c, 1e-12)
        lam = torch.clamp_min(lam0 / torch.clamp_min(self.d_r[:m1], 1e-12), 0.0)
        mu = mu0 / torch.clamp_min(self.d_r[m1:], 1e-12)
        return x, lam, mu

    def kkt_scale(self) -> torch.Tensor:
        return 1.0 + torch.linalg.norm(self.cs) + torch.linalg.norm(self.hs) + torch.linalg.norm(self.bs)

    def unscale(self, x, lam, mu):
        m1 = self.m1
        return x * self.d_c, lam * self.d_r[:m1], mu * self.d_r[m1:]


def _host_resolve_lp(c, G, h, A, b) -> Optional[LPSolution]:
    """Float64 host re-solve of a quarantined solve (HiGHS through the
    presolve/method retry ladder); None when the host solver fails too."""
    from citizensassemblies_tpu_torch.solvers.lp_util import robust_linprog

    c64 = np.asarray(c, dtype=np.float64)
    res = robust_linprog(
        c64,
        A_ub=np.asarray(G, dtype=np.float64),
        b_ub=np.asarray(h, dtype=np.float64),
        A_eq=np.asarray(A, dtype=np.float64),
        b_eq=np.asarray(b, dtype=np.float64),
        bounds=(0, None),
    )
    if res is None or res.status != 0:
        return None
    x = np.asarray(res.x, dtype=np.float64)
    lam = np.zeros(np.shape(G)[0])
    mu = np.zeros(np.shape(A)[0])
    try:
        # scipy/HiGHS marginals: ≤ 0 for the A_ub rows of a min problem
        lam = np.maximum(-np.asarray(res.ineqlin.marginals, np.float64), 0.0)
        mu = -np.asarray(res.eqlin.marginals, np.float64)
    except Exception:  # marginals missing on some method fallbacks
        pass
    return LPSolution(ok=True, x=x, lam=lam, mu=mu, objective=float(c64 @ x), iters=-1, kkt=0.0)


def _generic_warm(warm, nv: int, m1: int, m2: int, log=None):
    """The float32 warm triple of a generic LP (copies: the ``pdhg_nan``
    fault site poisons ``x0`` in place when it fires)."""
    if warm is not None:
        x0, lam0, mu0 = (np.array(w, np.float32).reshape(-1) for w in warm)
    else:
        x0, lam0, mu0 = np.zeros(nv, np.float32), np.zeros(m1, np.float32), np.zeros(m2, np.float32)
    if inject.site("pdhg_nan", log):
        x0[0] = np.nan  # the sentinel must quarantine, the host re-solve recover
    return x0, lam0, mu0


def _finish_lp(c, G_dense, h, A, b, out, tol: float, log) -> LPSolution:
    """The acceptance contract shared by both generic entry points: a
    quarantined solve is re-solved on the host (``G_dense()`` builds the
    dense inequality block only then); ``ok`` is ``kkt ≤ 4·tol`` and not
    poisoned."""
    x, lam, mu, it, res, flags = out
    if flags & FLAG_POISONED:
        if log is not None:
            log.count("sentinel_poisoned")
        host = _host_resolve_lp(c, G_dense(), h, A, b)
        if host is not None:
            if log is not None:
                log.count("sentinel_host_resolve")
            return host
    if flags & FLAG_STALLED and log is not None:
        log.count("sentinel_stalled")
    x = x.cpu().numpy().astype(np.float64)
    return LPSolution(
        ok=bool(res <= tol * 4.0) and not (flags & FLAG_POISONED),
        x=x,
        lam=lam.cpu().numpy().astype(np.float64),
        mu=mu.cpu().numpy().astype(np.float64),
        objective=float(np.asarray(c, dtype=np.float64) @ x),
        iters=int(it),
        kkt=float(res),
    )


def solve_lp(c, G, h, A, b, cfg: Optional[Config] = None, warm=None, tol: Optional[float] = None,
             device: DeviceLike = None, log=None) -> LPSolution:
    """Solve ``min cᵀx s.t. Gx ≤ h, Ax = b, x ≥ 0`` (dense ``G``) by the
    chained PDHG on ``device``. ``warm`` is an optional unscaled ``(x, λ,
    μ)`` start."""
    cfg = cfg or default_config()
    dev = resolve_device(device)
    tol = float(tol if tol is not None else cfg.pdhg_tol)
    G = np.asarray(G)
    m1, nv = G.shape
    m2 = np.shape(A)[0]
    f32 = dict(dtype=torch.float32, device=dev)
    x0, lam0, mu0 = (torch.as_tensor(w, **f32) for w in _generic_warm(warm, nv, m1, m2, log))
    G_d, A_d = (
        demote_operator(np.asarray(a, np.float32), cfg, core="lp_pdhg.pdhg_core", arg=i, log=log,
                        device=dev)
        for i, a in ((1, G), (3, A))
    )
    c_, h_, b_ = (torch.as_tensor(np.asarray(a, np.float32), **f32) for a in (c, h, b))
    G_t, A_t = operand_tensor(G_d, dev), operand_tensor(A_d, dev)
    with dispatch_span(
        "lp_pdhg.pdhg_core", cfg=cfg, log=log, nv=int(nv), m1=int(m1), m2=int(m2),
        check_every=int(cfg.pdhg_check_every),
    ) as ds, no_implicit_transfers(cfg):
        ds.out = out = _pdhg_body(
            c_, G_t, h_, A_t, b_,
            x0, lam0, mu0, tol, max_iters=int(cfg.pdhg_max_iters),
            check_every=int(cfg.pdhg_check_every), sentinel=sentinels_enabled(cfg),
        )
        ds.note(iters=int(out[3]))
    return _finish_lp(c, lambda: G, h, A, b, out, tol, log)


def solve_lp_ell(c, ell, h, A, b, cfg: Optional[Config] = None, warm=None, tol: Optional[float] = None,
                 device: DeviceLike = None, log=None) -> LPSolution:
    """:func:`solve_lp` with the inequality block packed as ELL rows
    (``ell`` an :class:`~citizensassemblies_tpu_torch.solvers.sparse_ops.EllPack`
    over the nv variables), on the route ``Config.pdhg_megakernel`` picks:
    the fused block kernel (one launch per solve) or the chained ops. Same
    acceptance contract and warm semantics."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_unpack_rows

    cfg = cfg or default_config()
    dev = resolve_device(device)
    tol = float(tol if tol is not None else cfg.pdhg_tol)
    nv, m1, m2 = len(c), len(ell), np.shape(A)[0]
    x0, lam0, mu0 = _generic_warm(warm, nv, m1, m2, log)
    val_d = demote_operator(ell.val, cfg, core="lp_pdhg.pdhg_core_ell", arg=2, log=log, device=dev)
    A_d = demote_operator(
        np.asarray(A, np.float32), cfg, core="lp_pdhg.pdhg_core_ell", arg=4, log=log, device=dev
    )
    kw = dict(max_iters=int(cfg.pdhg_max_iters), check_every=int(cfg.pdhg_check_every),
              sentinel=sentinels_enabled(cfg))
    span = dispatch_span(
        "lp_pdhg.pdhg_core_ell", cfg=cfg, log=log, nv=nv, m1=m1, m2=int(m2),
        kp=int(ell.k_pad), nnz=int(np.count_nonzero(ell.val)), check_every=kw["check_every"],
    )
    if mk.lp_megakernel_mode(cfg, nv, m1, m2, dev, log=log) == "fused":
        # fused route: one kernel launch for the whole solve
        with span as ds, no_implicit_transfers(cfg):
            ds.out = out = mk.dispatch_lp(c, ell.idx, val_d, h, A_d, b, x0, lam0, mu0, tol,
                                          device=dev, log=log, cfg=cfg, **kw)
    else:
        f32 = dict(dtype=torch.float32, device=dev)
        csr = mk.csr_to_device(ell.idx, ell.val, nv, dev)
        c_, h_, b_, x0_, lam0_, mu0_ = (
            torch.as_tensor(np.asarray(a, np.float32), **f32) for a in (c, h, b, x0, lam0, mu0)
        )
        idx = torch.as_tensor(ell.idx, dtype=torch.int32, device=dev)
        val_t, A_t = operand_tensor(val_d, dev), operand_tensor(A_d, dev)
        with span as ds, no_implicit_transfers(cfg):
            ds.out = out = _pdhg_body_ell(
                c_, idx, val_t, h_, A_t, b_, x0_, lam0_, mu0_, tol, csr, **kw
            )
    ds.note(iters=int(out[3]))
    return _finish_lp(c, lambda: ell_unpack_rows(ell.idx, ell.val, nv), h, A, b, out, tol, log)


#: the dual leximin LP's committee rows pad to a multiple of this
_DUAL_LP_BUCKET = 256


def _dual_lp_vectors(fixed: np.ndarray, C: int, bucket: int):
    """``(Cp, c, h, A, b)`` of :func:`dual_lp_operands` for ``C`` committee
    rows: the padded row count and everything but ``G``."""
    fixed = np.asarray(fixed, dtype=np.float64)
    unfixed = fixed < 0
    Cp = ((C + bucket - 1) // bucket) * bucket
    c = np.concatenate([-np.where(unfixed, 0.0, fixed), [1.0]])
    A = np.concatenate([unfixed.astype(np.float64), [0.0]])[None, :]
    return Cp, c, np.zeros(Cp), A, np.array([1.0])


def dual_lp_operands(P: np.ndarray, fixed: np.ndarray, bucket: int = _DUAL_LP_BUCKET):
    """The dual leximin LP's ``(c, G, h, A, b)`` (dense float64) for the
    portfolio ``P [C, n]`` and the fixed probabilities (``< 0``: unfixed):
    variables ``z = [y (n), ŷ]``, ``min ŷ − Σ fixedᵢ yᵢ`` s.t. ``P y − ŷ·1
    ≤ 0``, ``Σ_{unfixed} y = 1``, ``z ≥ 0``. The committee rows pad to a
    multiple of ``bucket``: a zero row is the constraint −ŷ ≤ 0, already
    implied by ŷ ≥ 0, so the solution is unchanged."""
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    Cp, c, h, A, b = _dual_lp_vectors(fixed, C, bucket)
    Ppad = np.zeros((Cp, n))
    Ppad[:C] = P
    G = np.hstack([Ppad, -np.ones((Cp, 1))])
    return c, G, h, A, b


def _dual_lp_pack(P: np.ndarray, Cp: int):
    """``EllPack.from_rows`` of :func:`dual_lp_operands`' ``G`` (``[P, −1]``,
    rows past ``P`` ``[0, −1]``) built from ``P``'s nonzeros: the same
    arrays, without the dense ``Cp × (n + 1)`` float64 matrix (1.6 GB at a
    nationwide registry's 100,000 agents and 2,048 panels)."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack, _round_slots

    C, n = P.shape
    rows, cols = np.nonzero(P)
    counts = np.bincount(rows, minlength=Cp)
    kp = _round_slots(int(counts.max(initial=0)) + 1)
    idx = np.zeros((Cp, kp), np.int32)
    val = np.zeros((Cp, kp), np.float32)
    starts = np.cumsum(counts) - counts
    slot = np.arange(rows.size) - starts[rows]
    idx[rows, slot] = cols
    val[rows, slot] = np.asarray(P[rows, cols], dtype=np.float64)
    every = np.arange(Cp)
    idx[every, counts] = n
    val[every, counts] = -1.0
    pack = EllPack(minor=n + 1, idx=idx, val=val)
    pack.nnz_total = int(counts.sum()) + Cp
    pack.pack_rows = Cp
    return pack


def solve_dual_lp_pdhg(P: np.ndarray, fixed: np.ndarray, cfg: Optional[Config] = None, warm=None,
                       device: DeviceLike = None, log=None):
    """The dual leximin LP (``highs_backend.solve_dual_lp``, operands from
    :func:`dual_lp_operands`) by PDHG on ``device``. Returns the
    ``DualSolution`` and the raw ``(x, λ, μ)`` triple for warm starts."""
    from citizensassemblies_tpu_torch.solvers.highs_backend import DualSolution
    from citizensassemblies_tpu_torch.solvers.sparse_ops import sparse_enabled

    cfg = cfg or default_config()
    P = np.asarray(P)
    C, n = P.shape
    Cp, c, h, A, b = _dual_lp_vectors(fixed, C, _DUAL_LP_BUCKET)
    if warm is not None and warm[1].shape[0] != Cp:
        lam_w = np.zeros(Cp)
        lam_w[: min(Cp, warm[1].shape[0])] = warm[1][:Cp]
        warm = (warm[0], lam_w, warm[2])
    # panel rows hold k + 1 nonzeros of n + 1 columns: the ELL routes carry
    # the solve whenever the fill clears the cutoff, packed from P's
    # nonzeros
    fill = (float(np.count_nonzero(P)) + C) / max(Cp * (n + 1), 1)
    kw = dict(cfg=cfg, warm=warm, device=device, log=log)
    if sparse_enabled(cfg, fill):
        sol = solve_lp_ell(c, _dual_lp_pack(P, Cp), h, A, b, **kw)
    else:
        sol = solve_lp(c, dual_lp_operands(P, fixed)[1], h, A, b, **kw)
    return (
        DualSolution(ok=sol.ok, y=sol.x[:n], yhat=float(sol.x[n]), objective=sol.objective),
        (sol.x, sol.lam, sol.mu),
    )


def solve_final_primal_lp_pdhg(
    P: np.ndarray, target: np.ndarray, cfg: Optional[Config] = None,
    max_iters: Optional[int] = None, tol: Optional[float] = None,
    host_fallback: bool = True, device: DeviceLike = None, log=None,
) -> Tuple[np.ndarray, float]:
    """The final primal LP (``highs_backend.solve_final_primal_lp``) by PDHG
    on ``device``: ``min ε`` s.t. ``Σp = 1``, ``(Pᵀp)ᵢ ≥ targetᵢ − ε``,
    ``p, ε ≥ 0``. Returns ``(p, ε)``; an unconverged solve is re-solved on
    the host unless ``host_fallback=False``."""
    cfg = cfg or default_config()
    if max_iters is not None:
        cfg = cfg.replace(pdhg_max_iters=int(max_iters))
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    target = np.asarray(target, dtype=np.float64)
    c = np.zeros(C + 1)
    c[-1] = 1.0
    G = np.hstack([-P.T, -np.ones((n, 1))])
    A = np.concatenate([np.ones(C), [0.0]])[None, :]
    sol = solve_lp(c, G, -target, A, np.array([1.0]), cfg=cfg, tol=tol, device=device, log=log)
    if not sol.ok and host_fallback:
        from citizensassemblies_tpu_torch.solvers.highs_backend import solve_final_primal_lp

        return solve_final_primal_lp(P, target)
    return sol.x[:C], float(max(sol.x[C], 0.0))


def stage_lp_operands(MT: np.ndarray, fixed: np.ndarray):
    """The generic-form ``(c, G, h, A, b)`` of the type-space stage LP over
    the portfolio ``MT`` (``[T, C]``) given ``fixed`` (−1 where unfixed),
    its columns padded to a multiple of 4096 (see
    :func:`solve_stage_lp_pdhg`)."""
    T, C = MT.shape
    fixed = np.asarray(fixed, dtype=np.float64)
    unfixed = fixed < 0
    h = np.where(unfixed, 0.0, -(np.maximum(fixed, 0.0) - 1e-9))
    bucket = 4096
    Cp = ((C + bucket - 1) // bucket) * bucket
    G = np.zeros((T, Cp + 1))
    G[:, :C] = -MT
    G[unfixed, Cp] = 1.0
    A = np.zeros((1, Cp + 1))
    A[0, :C] = 1.0
    b = np.array([1.0])
    c = np.zeros(Cp + 1)
    c[Cp] = -1.0
    return c, G, h, A, b


def solve_stage_lp_pdhg(
    MT: np.ndarray,
    fixed: np.ndarray,
    cfg: Optional[Config] = None,
    warm: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    tol: Optional[float] = None,
    device: DeviceLike = None,
    log=None,
):
    """The type-space stage LP (max the min unfixed type value) by the dense
    chained PDHG (:func:`solve_lp`) on ``device``.

    Variables ``x = [p (C), z]``; min −z s.t. z − M_t·p ≤ 0 (t unfixed),
    −M_t·p ≤ −f_t (t fixed), Σp = 1, x ≥ 0. The λ duals of the ≤-rows are
    the per-type weights the stage CG prices with. The columns pad to a
    multiple of 4096 (zero G and equality coefficients, zero cost: padding
    variables stay at 0), so a warm start carries across rounds as the
    portfolio grows. Returns ``(z, y, mu, p, ok)`` plus the raw warm triple.
    """
    cfg = cfg or default_config()
    C = MT.shape[1]
    c, G, h, A, b = stage_lp_operands(MT, fixed)
    Cp = G.shape[1] - 1
    if warm is not None and warm[0].shape[0] != Cp + 1:
        x_w = np.zeros(Cp + 1)
        m = min(C, warm[0].shape[0] - 1)
        x_w[:m] = warm[0][:m]
        x_w[Cp] = warm[0][-1]
        warm = (x_w, warm[1], warm[2])
    sol = solve_lp(c, G, h, A, b, cfg=cfg, warm=warm, tol=tol, device=device, log=log)
    z = float(sol.x[Cp])
    y = np.maximum(sol.lam, 0.0)
    mu = float(sol.mu[0])
    p = sol.x[:C]
    return z, y, mu, p, sol.ok, (sol.x, sol.lam, sol.mu)


# --- registered cores (lint/registry.py) ----------------------------------------
# A core is the device work of one dispatch up to its first host read: the
# prelude and the first block, the block through the graph store with
# ``graph=True``. ``tol`` is read by the host loop after the block, so no core
# reads it. Shapes and P1 ranges are the JAX registrations'.


def first_runner(block, family: str, factory: str, statics, operands, graph: bool):
    """``block``, or with ``graph`` its replay from the graph store."""
    if not graph:
        return block
    return SeededGraph(family, factory, statics, operands)


def lp_first_block(c, G, h, A, b, x0, lam0, mu0, tol, *, check_every: int, graph: bool = False,
                   family: str = "lp_pdhg.pdhg_core"):
    """The dense LP core (:func:`_pdhg_body`) to its first host read: the
    prelude and one block from the warm start. Returns the unscaled
    ``(x, lam, mu)`` after the block."""
    m1 = G.shape[0]
    pre, Ks, (x, lam, mu, norm, _scale) = _dense_lp_setup(c, G, h, A, b, x0, lam0, mu0)
    Gs = Ks[:m1]
    block = _lp_block(lambda q: Gs @ q, lambda y: Gs.t() @ y, pre.As, pre.cs, pre.hs, pre.bs,
                      int(check_every))
    run = first_runner(block, family, "lp_pdhg.lp_block_dense",
                       {"check_every": int(check_every), "m1": int(m1), "sentinel": False},
                       (Ks, pre.cs, pre.hs, pre.bs), graph)
    omega = torch.ones((), dtype=torch.float32, device=x.device)
    q, y, m = run(x, lam, mu, 0.9 * omega / norm, 0.9 / (omega * norm))[:3]
    return pre.unscale(q, y, m)


def _lp_ell_first_block(c, idx, val, h, A, b, x0, lam0, mu0, tol, *, csr, check_every: int):
    """The ELL LP core (:func:`_pdhg_body_ell`, no graph site) to its first
    host read."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    pre, (x, lam, mu, norm, _scale) = mk.lp_setup(c, idx, val, h, A, b, x0, lam0, mu0, csr)
    G_mv, G_rmv = mk.lp_operators(idx, pre.vals_s, csr)
    block = _lp_block(G_mv, G_rmv, pre.As, pre.cs, pre.hs, pre.bs, int(check_every))
    omega = torch.ones((), dtype=torch.float32, device=x.device)
    q, y, m = block(x, lam, mu, 0.9 * omega / norm, 0.9 / (omega * norm))[:3]
    return pre.unscale(q, y, m)


def two_sided_first_block(idx, val, v, colmask, x0, lam0, mu0, tol, *, csr, check_every: int,
                          graph: bool = False, family: str = "lp_pdhg.two_sided_core_ell"):
    """The two-sided ELL core (:func:`_pdhg_two_sided_body_ell`) to its
    first host read: the prelude, ‖K‖, the scaled warm start and one block
    over the lanes. Returns the unscaled ``(x, lam, mu)``."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    pre, vals_s = mk.two_sided_prelude(idx, val, v, colmask)
    ops = mk.ell_operator_tensors(idx, vals_s, pre, csr)
    K_apply, KT_apply = mk.ell_operators_from(*ops)
    B, C = pre.d_c.shape
    norm = power_norm(K_apply, KT_apply, B, C, v.device)
    p, eps, l_lo, l_up, mu = warm_scaled(pre, x0, lam0, mu0)
    block = _two_sided_block(K_apply, KT_apply, pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs,
                             int(check_every))
    run = first_runner(block, family, "lp_pdhg.two_sided_block",
                       {"check_every": int(check_every), "sentinel": False},
                       tuple(ops) + (pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs), graph)
    omega = torch.ones(B, dtype=torch.float32, device=v.device)
    q, e, lo, up, m = run(p, eps, l_lo, l_up, mu, 0.9 * omega / norm, 0.9 / (omega * norm))[:5]
    return unscale(pre, q, e, lo, up, m)


@register_ir_core("lp_pdhg.pdhg_core", span="lp_pdhg.pdhg_core")
def _ir_pdhg_core(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    return IRCase(
        fn=lp_first_block, args=dense_lp_operands(Seeded(11, device), 65, 64, 1),
        static=dict(check_every=128, graph=False), arg_ranges=LP_RANGES,
        prec_demote=(1, 3),  # G, A
        device=str(device), graph="lp_pdhg.pdhg_core",
    )


@register_ir_core("lp_pdhg.pdhg_core_ell", dense_ref="lp_pdhg.pdhg_core", span="lp_pdhg.pdhg_core_ell")
def _ir_pdhg_core_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(12, device)
    nv, m1, m2, kp = 65, 64, 1, 8
    idx, val = ell_operands(r, m1, nv, kp)
    return IRCase(
        fn=_lp_ell_first_block,
        args=(r.f32(nv, -1.0, 1.0), r.t(idx), r.t(val), r.f32(m1, 0.5, 1.5), r.ones((m2, nv)),
              r.ones(m2), r.zeros(nv), r.zeros(m1), r.zeros(m2), r.full((), 1e-6)),
        static=dict(check_every=128, csr=csr_to_device(idx, val, nv, r.device)),
        arg_ranges=(RANGE_WIDE, None) + LP_RANGES[1:],
        prec_demote=(2, 4),  # ELL values, A
        device=str(device),
    )


@register_ir_core("lp_pdhg.two_sided_core", span="lp_pdhg.two_sided_core")
def _ir_two_sided_core(device="cpu") -> IRCase:
    """The port packs the dense master by columns on the host
    (:func:`solve_two_sided_master_async`) and solves the ELL master, so its
    core is the ELL core at the dense master's fill: the JAX core's ``MT``
    is the packed values (argument 1), its other arguments follow."""
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    r = Seeded(13, device)
    T, C = 128, 256
    idx, val = EllPack.from_rows(r.counts((C, T), 3, 0.9), minor=T).padded(C)
    return IRCase(
        fn=two_sided_first_block,
        args=(r.t(idx), r.t(val)) + two_sided_lanes(r, T, C),
        static=dict(check_every=128, graph=False, csr=csr_to_device(idx, val, T, r.device)),
        arg_ranges=TWO_SIDED_RANGES,
        prec_demote=(1,),  # MT, as its packed values
        device=str(device), graph="lp_pdhg.two_sided_core_ell",
        jax_args=(None, 0, 1, 2, 3, 4, 5, 6),
    )


@register_ir_core("lp_pdhg.two_sided_core_ell", dense_ref="lp_pdhg.two_sided_core",
                  span="lp_pdhg.two_sided_core_ell")
def _ir_two_sided_core_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(14, device)
    T, C, kp = 128, 256, 16
    idx, val = ell_operands(r, C, T, kp)
    return IRCase(
        fn=two_sided_first_block,
        args=(r.t(idx), r.t(val)) + two_sided_lanes(r, T, C),
        static=dict(check_every=128, graph=False, csr=csr_to_device(idx, val, T, r.device)),
        arg_ranges=TWO_SIDED_RANGES,
        prec_demote=(1,),  # ELL values
        device=str(device), graph="lp_pdhg.two_sided_core_ell",
    )
