"""Min-norm distribution recovery: XMIN's min-L2 stage, in torch.

XMIN's final stage (the reference's ``xmin.py:447-455``) realizes the
per-agent targets over a grown portfolio with minimal L2 norm, which spreads
probability over as many panels as possible. The solve is lexicographic: an
ε floor first — from the caller's feasible donor distribution, tightened by
a short min-ε PDHG anchor when the donor's deviation is loose; the host LP
only on donor-less calls — then ``min Σ p²`` subject to realizing the
targets within that ε.

The QP ``min_{p ∈ Δ, t − ε ≤ Pᵀp ≤ t + ε} pᵀp`` is solved by projected dual
ascent: for multipliers λ ≥ 0 on both sides of the coverage constraints the
inner minimization over the simplex is ``p(λ) = proj_Δ(P (λ_lo − λ_up) / 2)``
and the dual gradient is the constraint residual, two matvecs an iteration.

Under ``Config.lp_batch`` the anchor, the donor-vs-anchor floor pick and the
ascent run as one fused core (:func:`_get_l2_fused_core`,
:func:`_get_l2_fused_core_ell`), the ascent in 512-iteration chunks with one
read of the chunk's movement on the host after each. On the card the
anchor's PDHG blocks and the ascent's chunks are replayed as CUDA graphs,
and so are the serial ascent's (``l2_dual_ascent``: its fixed iteration
count in 512-iteration chunks, no read between them):
launched op by op they were host-bound (0.82 ms an ascent iteration against
0.22 ms replayed, NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py`` phases
``xmin_l2_hold`` and ``xmin_sf_e_skewed``). The float64 floor and blend
arithmetic and every acceptance decision stay on the host either way.

On the ELL route (panels packed as rows, ``solvers/sparse_ops``) ``P·w`` is
the packed gather (the CUDA kernel of ``kernels/ell_matvec.py`` on CUDA
tensors) and ``Pᵀp`` a segment sum over the pack's agent-major CSR
transpose on CUDA (``index_add_`` sums with atomics there, so repeat runs
would not be bit-identical), ``index_add_`` on the CPU. Prefix sums run in
a fixed order on CUDA too (:func:`_prefix_sum`).

Under ``Config.mixed_precision`` the portfolio (the 0/1 panel matrix, so
its bf16 round trip is exact) goes to the device as bf16 at the JAX
package's four sites (``qp.l2_fused_core[_ell]``, ``qp.l2_dual_ascent[_ell]``
of the committed plan): on the ELL route the gather kernel reads the bf16
values (its bf16-value path) and the agent-major CSR gathers them from the
pack in the same dtype; the dense route widens the matrix on the device
before its products (a dense ``matmul`` takes no mixed dtypes). Every
product is float32 and bitwise that of the float32 operand. The fused
cores consult the ``qp_nan`` fault site, which poisons the donor for the
sentinel to quarantine.

The fused cores and the dual ascents run under the transfer guard
(``utils/guards.no_implicit_transfers``): a host synchronisation inside a
PDHG block or an ascent chunk raises under ``Config.transfer_guard =
"disallow"``. Left out until their ROADMAP queue A items land: the serving
context and its pack memo (item 9), dispatch spans (items 9-10) and the
AOT/IR registrations (item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from citizensassemblies_tpu_torch.aot.store import SeededGraph, register_block
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_gather_mv, ell_scatter_mv
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device, upload
from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.utils.logging import RunLog
from citizensassemblies_tpu_torch.utils.memo import LRU
from citizensassemblies_tpu_torch.utils.precision import demote_operator, iterate_dtype

#: ascent iterations between two convergence reads of the fused cores
L2_CHUNK = 512
#: iteration cap of the fused cores' min-ε anchor
ANCHOR_ITERS = 12_288
#: the fused cores' anchor tolerance and per-chunk movement tolerance
ANCHOR_TOL = 1e-5
ASCENT_TOL = 1e-7
#: row width of the two-level prefix sum on CUDA
_SCAN_ROW = 256

Csr = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _prefix_sum_fixed_order(u: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor in a fixed summation order: rows
    of :data:`_SCAN_ROW` entries scanned along the row, then the row totals
    down a column, each a sequential loop per row or column."""
    d = u.shape[0]
    rows = max(2, -(-d // _SCAN_ROW))
    s = F.pad(u, (0, rows * _SCAN_ROW - d)).view(rows, _SCAN_ROW).cumsum(1)
    tot = s[:, -1]
    # two identical columns: a 2-D scan down dim 0 is the per-column loop
    inc = torch.stack([tot, tot], 1).cumsum(0)[:, 0]
    off = F.pad(inc[:-1], (1, 0))
    return (s + off[:, None]).reshape(-1)[:d]


def _prefix_sum(u: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum: ``torch.cumsum`` on the CPU. PyTorch lists a
    float ``torch.cumsum`` on CUDA among its nondeterministic operations
    (``torch.use_deterministic_algorithms``): a 1-D one is a single-pass
    scan whose sums depend on the timing of its tiles. There
    :func:`_prefix_sum_fixed_order` runs instead."""
    if not u.is_cuda:
        return torch.cumsum(u, 0)
    return _prefix_sum_fixed_order(u)


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the probability simplex (sort-based), with
    no host synchronisation."""
    d = v.shape[0]
    u = torch.sort(v, descending=True).values
    css = _prefix_sum(u) - 1.0
    idx = torch.arange(1, d + 1, dtype=iterate_dtype(v.dtype), device=v.device)
    cond = u - css / idx > 0
    rho = cond.sum() - 1
    # an all-false mask (NaN input) indexes the last entry, as an index of
    # −1 does in the JAX package
    rho = torch.where(rho < 0, rho + d, rho)
    theta = css.index_select(0, rho.reshape(1))[0] / (rho + 1).to(v.dtype)
    return torch.clamp_min(v - theta, 0.0)


def _csr_tensors(val, csr: Optional[Csr]) -> Tuple[torch.Tensor, ...]:
    """The tensors the CUDA transpose product reads
    (``kernels/pdhg_megakernel.csr_forward_operands`` of one lane); none on
    CPU tensors."""
    if not val.is_cuda:
        return ()
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_forward_operands

    if csr is None:
        raise ValueError("on CUDA the transpose product takes the agent-major CSR (csr=)")
    return csr_forward_operands(csr, val[None])


def _ell_ops_from(idx, val, n: int, csr_ops: Tuple[torch.Tensor, ...]):
    """:func:`_ell_ops` over :func:`_csr_tensors`."""
    if csr_ops:
        from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_forward_from

        forward = csr_forward_from(*csr_ops)

        def scatter(p):
            return forward(p[None])[0]
    else:
        def scatter(p):
            return ell_scatter_mv(idx, val, p, n)

    def gather(w):
        return ell_gather_mv(idx, val, w)

    return gather, scatter


def _ell_ops(idx, val, n: int, csr: Optional[Csr]):
    """``(P·w, Pᵀp)`` over the packed rows: the gather, and the transpose
    on CUDA tensors as a segment sum per agent in panel order over ``csr``,
    the pack's agent-major CSR transpose
    (``kernels/pdhg_megakernel.csr_to_device``, no atomics), on CPU tensors
    by ``index_add_`` (``csr`` unused there)."""
    return _ell_ops_from(idx, val, n, _csr_tensors(val, csr))


def _ascent_step(p_of, alloc_of, t, eps, lr):
    """One two-sided dual-ascent iteration ``λ ↦ max(λ + lr·residual, 0)``."""

    def step(lam):
        alloc = alloc_of(p_of(lam))
        resid_lo = (t - eps) - alloc  # violated ⇒ positive ⇒ raise λ_lo
        resid_up = alloc - (t + eps)  # violated ⇒ positive ⇒ raise λ_up
        return torch.clamp_min(lam + lr * torch.cat([resid_lo, resid_up]), 0.0)

    return step


def _chunk_block(step, chunk: int):
    """λ through ``chunk`` iterations of ``step``; returns a 1-tuple."""

    def block(lam):
        for _ in range(chunk):
            lam = step(lam)
        return (lam,)

    return block


def _dense_ascent(P, t, eps, lr):
    """``(p_of, step)`` of the two-sided dual ascent over a dense float32
    ``P [C, n]``."""
    n = P.shape[1]
    PT = P.t()

    def p_of(lam):
        return project_simplex((P @ (lam[:n] - lam[n:])) / 2.0)

    return p_of, _ascent_step(p_of, lambda p: PT @ p, t, eps, lr)


def _ell_ascent(idx, val, csr_ops, t, eps, lr):
    """``(p_of, step)`` of the two-sided dual ascent over the ELL pack
    (``csr_ops``: :func:`_csr_tensors`)."""
    n = t.shape[0]
    gather, scatter = _ell_ops_from(idx, val, n, tuple(csr_ops))

    def p_of(lam):
        return project_simplex(gather(lam[:n] - lam[n:]) / 2.0)

    return p_of, _ascent_step(p_of, scatter, t, eps, lr)


@register_block("qp.ascent_dense")
def _ascent_dense_factory(chunk: int):
    """The graph store's block factory of a dense ascent chunk over ``(P, t, eps,
    lr)``."""

    def make(P, t, eps, lr):
        return _chunk_block(_dense_ascent(P, t, eps, lr)[1], int(chunk))

    return make


@register_block("qp.ascent_ell")
def _ascent_ell_factory(chunk: int):
    """The graph store's block factory of an ELL ascent chunk over ``(idx, val,
    *csr tensors, t, eps, lr)`` (no CSR tensors on the CPU)."""

    def make(idx, val, *rest):
        *csr_ops, t, eps, lr = rest
        return _chunk_block(_ell_ascent(idx, val, csr_ops, t, eps, lr)[1], int(chunk))

    return make


def _chunk_runner(step, chunk: int, lam, graph: bool, seed=None):
    """A function taking λ through ``chunk`` iterations of ``step``: op by
    op, or with ``graph`` a replay of the graph store's CUDA graph of the
    chunk (``aot/store.SeededGraph``; ``seed`` is ``(family, factory,
    operands)``, the operands every tensor the chunk reads), the same kernels
    in the same order without a host launch for each, so the op-by-op
    result bit for bit. Returns a 1-tuple; a caller calls
    ``lp_pdhg._prepare`` on it before each launch window."""
    block = _chunk_block(step, chunk)
    if seed is None:
        if graph:
            raise ValueError("a graph-replayed chunk takes its operands (seed=)")
        return block
    family, factory, operands = seed
    return SeededGraph(family, factory, {"chunk": int(chunk)}, operands, eager=block,
                       graph=graph, eager_calls=0)


def _iterate(step, lam, iters: int, graph: bool, seed=None):
    """``iters`` iterations of ``step`` from ``lam`` with no convergence
    read: whole :data:`L2_CHUNK`-iteration chunks through
    :func:`_chunk_runner`, the rest op by op."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _prepare

    chunks, rest = divmod(int(iters), L2_CHUNK)
    if chunks:
        run = _chunk_runner(step, L2_CHUNK, lam, graph, seed)
        for _ in range(chunks):
            _prepare(run, lam)
            with guarded_launch(lam.device):
                (lam,) = run(lam)
    with guarded_launch(lam.device):
        for _ in range(rest):
            lam = step(lam)
    return lam


def _min_norm_dual_ascent(P, t, eps, lr, lam0, iters: int, graph: Optional[bool] = None):
    """Two-sided dual ascent over a dense ``P [C, n]``: multipliers on BOTH
    ``Pᵀp ≥ t − ε`` and ``Pᵀp ≤ t + ε`` (one-sided floors let the spread
    re-route surplus mass upward, several ×ε onto single agents). ``lam0``
    is the warm-start carry; ``graph`` (default: on CUDA tensors) replays
    the iterations in CUDA-graph chunks (:func:`_iterate`). A demoted bf16
    ``P`` is widened first. Returns ``(p, lam)``."""
    P = P.to(iterate_dtype(P.dtype))
    p_of, step = _dense_ascent(P, t, eps, lr)
    lam = _iterate(step, lam0, iters, P.is_cuda if graph is None else graph,
                   seed=("qp.l2_dual_ascent", "qp.ascent_dense", (P, t, eps, lr)))
    return p_of(lam), lam


def _min_norm_dual_ascent_ell(idx, val, t, eps, lr, lam0, iters: int, csr: Optional[Csr] = None,
                              graph: Optional[bool] = None):
    """:func:`_min_norm_dual_ascent` on the ELL pack of the portfolio's rows
    (each panel: its member columns of the n agents): ``P·w`` a per-row
    gather, ``Pᵀp`` a per-agent sum, O(C·k) an iteration instead of O(C·n).
    ``csr`` is the pack's agent-major transpose, needed on CUDA. Same
    two-sided semantics, ``graph`` and return contract as the dense
    ascent."""
    csr_ops = _csr_tensors(val, csr)
    p_of, step = _ell_ascent(idx, val, csr_ops, t, eps, lr)
    lam = _iterate(step, lam0, iters, val.is_cuda if graph is None else graph,
                   seed=("qp.l2_dual_ascent_ell", "qp.ascent_ell", (idx, val, *csr_ops, t, eps, lr)))
    return p_of(lam), lam


def _power_norm(K: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """‖K‖₂ by power iteration on KᵀK (the JAX package's
    ``lp_pdhg._power_norm``); a demoted bf16 ``K`` is widened first."""
    dt = iterate_dtype(K.dtype)
    K = K.to(dt)
    v = torch.ones(K.shape[1], dtype=dt, device=K.device) / np.sqrt(np.float32(K.shape[1]))
    for _ in range(iters):
        w = K.t() @ (K @ v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    return torch.sqrt(torch.linalg.norm(K.t() @ (K @ v)) + 1e-12)


def _ell_power_norm(idx, val, n: int, iters: int = 40, csr: Optional[Csr] = None) -> torch.Tensor:
    """‖P‖₂ power estimate via the ELL matvec pair (the dense
    :func:`_power_norm` on the packed rep)."""
    gather, scatter = _ell_ops(idx, val, n, csr)
    v = torch.ones(n, dtype=iterate_dtype(val.dtype), device=val.device) / np.sqrt(np.float32(n))
    for _ in range(iters):
        w = scatter(gather(v))
        v = w / (torch.linalg.norm(w) + 1e-12)
    return torch.sqrt(torch.linalg.norm(scatter(gather(v))) + 1e-12)


def _ascent_chunks(p_of, step, n: int, dev, chunk: int, max_chunks: int, ascent_tol,
                   sentinel: bool, graph: bool = False, seed=None):
    """The fused cores' ascent from λ = 0: ``chunk`` iterations at a time
    until the spread iterate moves by at most ``ascent_tol`` over a chunk or
    ``max_chunks`` ran. The movement is read on the host once per chunk,
    nothing inside one. With the sentinel, a non-finite movement keeps the
    carry of the chunk before and stops flagged (bit 1). With ``graph``
    (CUDA tensors) each chunk is a replay of one captured CUDA graph
    (:func:`_chunk_runner`, ``seed`` its store family, block factory and
    operands). Returns ``(p, chunks, flags, replays)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _prepare

    tol = float(np.float32(ascent_tol))
    replays = 0
    lam = torch.zeros(2 * n, dtype=torch.float32, device=dev)
    p = p_of(lam)
    run = _chunk_runner(step, chunk, lam, graph, seed)
    k, delta, flags = 0, float("inf"), 0
    while delta > tol and k < max_chunks:
        _prepare(run, lam)
        with guarded_launch(dev):
            (lam_new,) = run(lam)
        replays += int(graph)
        p_new = p_of(lam_new)
        d = float((p_new - p).abs().max())
        if sentinel and not np.isfinite(d):
            flags = 1
            break
        lam, p, k, delta = lam_new, p_new, k + 1, d
    return p, k, flags, replays


def _floor_pick(q_x, alloc_of, t, p_don, eps_margin):
    """The fused cores' ε-floor pick on the device: the anchor's normalized
    iterate or the donor, whichever deviates less, and the ε it realizes
    plus the margin. Returns ``(p_floor, eps)``."""
    q = torch.clamp(q_x, 0.0, 1.0)
    s = q.sum()
    q_n = torch.where(s > 0, q / torch.clamp_min(s, 1e-30), p_don)
    dev_q = (alloc_of(q_n) - t).abs().max()
    dev_don = (alloc_of(p_don) - t).abs().max()
    use_q = (s > 0) & (dev_q < dev_don)
    p_floor = torch.where(use_q, q_n, p_don)
    eps = torch.minimum(torch.where(s > 0, dev_q, torch.full_like(dev_q, float("inf"))), dev_don)
    return p_floor, eps + eps_margin


#: memoized fused L2 cores per iteration schedule, LRU-bounded so schedule
#: sweeps cannot accrete them (utils/memo)
_L2_FUSED_CORES: LRU = LRU(cap=4, name="l2_fused_cores")


def _get_l2_fused_core(
    eps_iters: int, check_every: int, chunk: int, max_chunks: int, sentinel: bool = False,
    graph: Optional[bool] = None,
):
    """Build (once per schedule) the FUSED min-ε + dual-ascent core over a
    dense portfolio ``P [C, n]``: (1) the min-ε anchor PDHG on the recovery
    LP (``lp_pdhg._pdhg_body``, the same generic core as the serial
    solver, constraint matrix built on the device), (2) the donor-vs-anchor
    ε-floor pick, (3) the dual ascent in ``chunk``-iteration blocks until
    the spread iterate's per-block movement drops below tolerance.

    The core is ``fused(P, t, p_don, eps_margin, eps_tol, ascent_tol,
    log=None)`` (``P`` float32 or demoted bf16) and returns ``(p, p_floor,
    it_eps, ascent_iters)`` —
    ``+ (flags,)`` with the sentinel (the anchor's flags | bit 1 for a
    frozen ascent). ``graph`` replays the anchor's PDHG blocks and each
    ascent chunk as CUDA graphs (``None``: on CUDA tensors), bit for bit
    the op-by-op run. A ``log`` gets the timers ``l2_anchor`` and
    ``l2_ascent`` and the gauge ``l2_ascent_replays``."""
    key = (int(eps_iters), int(check_every), int(chunk), int(max_chunks), bool(sentinel), graph)
    core = _L2_FUSED_CORES.get(key)
    if core is not None:
        return core
    eps_iters, check_every, chunk, max_chunks, sentinel = key[:5]
    family = "qp.l2_fused[" + ",".join(str(int(v)) for v in key[:5]) + "]"

    def fused(P, t, p_don, eps_margin, eps_tol, ascent_tol, log=None):
        from citizensassemblies_tpu_torch.solvers.lp_pdhg import _pdhg_body

        # a demoted bf16 P is widened on the device before its products
        P = P.to(iterate_dtype(P.dtype))
        C, n = P.shape
        dev = P.device
        f32 = dict(dtype=torch.float32, device=dev)
        PT = P.t()
        log = log if log is not None else RunLog(echo=False)
        use_graph = P.is_cuda if graph is None else graph
        # --- stage 1: min-ε anchor on the recovery LP -----------------------
        with log.timer("l2_anchor"):
            # built on the device: an element store of a python number
            # would copy it from pageable host memory, a host sync
            c = torch.cat([torch.zeros(C, **f32), torch.ones(1, **f32)])
            G = torch.cat([-PT, -torch.ones((n, 1), **f32)], dim=1)
            A = torch.cat([torch.ones(C, **f32), torch.zeros(1, **f32)])[None, :]
            x, _lam, _mu, it_eps, _res, flags1 = _pdhg_body(
                c, G, -t, A, torch.ones(1, **f32),
                torch.zeros(C + 1, **f32), torch.zeros(n, **f32), torch.zeros(1, **f32),
                float(eps_tol), max_iters=eps_iters, check_every=check_every, sentinel=sentinel,
                graph=use_graph, family=family + "/anchor",
            )
        # --- stage 2: ε-floor pick, donor vs anchor, on the device ----------
        p_floor, eps = _floor_pick(x[:C], lambda p: PT @ p, t, p_don, eps_margin)
        # --- stage 3: dual ascent, movement read once per chunk -------------
        sigma_sq = _power_norm(P) ** 2
        lr = 1.0 / torch.clamp_min(sigma_sq / 2.0, 1.0)
        p_of, step = _dense_ascent(P, t, eps, lr)
        with log.timer("l2_ascent"):
            p, k, flags3, replays = _ascent_chunks(
                p_of, step, n, dev, chunk, max_chunks, ascent_tol, sentinel, graph=use_graph,
                seed=(family + "/ascent", "qp.ascent_dense", (P, t, eps, lr)),
            )
        log.gauge("l2_ascent_replays", replays)
        out = (p, p_floor, int(it_eps), k * chunk)
        return out + (int(flags1) | flags3,) if sentinel else out

    _L2_FUSED_CORES[key] = fused
    return fused


#: memoized ELL fused cores per schedule
_L2_FUSED_CORES_ELL: LRU = LRU(cap=4, name="l2_fused_cores_ell")


def _get_l2_fused_core_ell(
    eps_iters: int, check_every: int, chunk: int, max_chunks: int, sentinel: bool = False,
    graph: Optional[bool] = None,
):
    """The fused L2 stage on the ELL pack of the portfolio's rows: the same
    three stages as :func:`_get_l2_fused_core`, every matvec on the packed
    ``idx``/``val``. The anchor is the two-sided ε master over the portfolio
    (``lp_pdhg._pdhg_two_sided_body_ell`` with the n agents as its minor
    axis, one lane; its arithmetic deviation is what the floor pick judges
    anyway).

    The core is ``fused(idx, val, t, p_don, eps_margin, eps_tol,
    ascent_tol, csr, log=None)`` (``val`` float32 or demoted bf16: the
    anchor's prelude widens it, the ascent's gathers read it as it is) with
    ``csr`` the pack's agent-major CSR
    transpose on the pack's device; it returns what the dense core returns,
    and ``graph`` and ``log`` are the dense core's."""
    key = (int(eps_iters), int(check_every), int(chunk), int(max_chunks), bool(sentinel), graph)
    core = _L2_FUSED_CORES_ELL.get(key)
    if core is not None:
        return core
    eps_iters, check_every, chunk, max_chunks, sentinel = key[:5]
    family = "qp.l2_fused_ell[" + ",".join(str(int(v)) for v in key[:5]) + "]"

    def fused(idx, val, t, p_don, eps_margin, eps_tol, ascent_tol, csr, log=None):
        from citizensassemblies_tpu_torch.solvers.lp_pdhg import _pdhg_two_sided_body_ell

        C = idx.shape[0]
        n = t.shape[0]
        dev = val.device
        f32 = dict(dtype=torch.float32, device=dev)
        log = log if log is not None else RunLog(echo=False)
        use_graph = val.is_cuda if graph is None else graph
        # --- stage 1: min-ε anchor, the two-sided ε master over the pack ----
        with log.timer("l2_anchor"):
            x, _lam, _mu, it, _res, flags = _pdhg_two_sided_body_ell(
                idx, val, t, torch.ones((1, C), **f32), torch.zeros((1, C + 1), **f32),
                torch.zeros((1, 2 * n), **f32), torch.zeros(1, **f32),
                torch.full((1,), float(eps_tol), **f32), csr,
                max_iters=eps_iters, check_every=check_every, sentinel=sentinel,
                graph=use_graph, family=family + "/anchor",
            )
            it_eps, flags1 = int(it[0]), int(flags[0])
        csr_ops = _csr_tensors(val, csr)
        _gather, scatter = _ell_ops_from(idx, val, n, csr_ops)
        # --- stage 2: ε-floor pick, donor vs anchor, on the device ----------
        p_floor, eps = _floor_pick(x[0, :C], scatter, t, p_don, eps_margin)
        # --- stage 3: dual ascent, movement read once per chunk -------------
        sigma_sq = _ell_power_norm(idx, val, n, csr=csr) ** 2
        lr = 1.0 / torch.clamp_min(sigma_sq / 2.0, 1.0)
        p_of, step = _ell_ascent(idx, val, csr_ops, t, eps, lr)
        with log.timer("l2_ascent"):
            p, k, flags3, replays = _ascent_chunks(
                p_of, step, n, dev, chunk, max_chunks, ascent_tol, sentinel, graph=use_graph,
                seed=(family + "/ascent", "qp.ascent_ell", (idx, val, *csr_ops, t, eps, lr)),
            )
        log.gauge("l2_ascent_replays", replays)
        out = (p, p_floor, it_eps, k * chunk)
        return out + (flags1 | flags3,) if sentinel else out

    _L2_FUSED_CORES_ELL[key] = fused
    return fused


def _min_eps_pdhg(P: np.ndarray, PT: np.ndarray, target: np.ndarray, cfg=None,
                  device: DeviceLike = None, log=None):
    """Approximate min-ε recovery LP on ``device`` via
    ``lp_pdhg.solve_final_primal_lp_pdhg`` with NO host fallback: the caller
    validates the normalized iterate arithmetically and keeps the better of
    this and its donor. A short budget: the iterate only has to beat a
    loose donor. Returns ``(p_normalized, two_sided_dev)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_final_primal_lp_pdhg

    x, _eps = solve_final_primal_lp_pdhg(
        P, target, cfg=cfg, max_iters=ANCHOR_ITERS, tol=ANCHOR_TOL, host_fallback=False,
        device=device, log=log,
    )
    p = np.clip(x, 0.0, 1.0)
    s = p.sum()
    if not np.isfinite(s) or s <= 0:
        return np.full(P.shape[0], 1.0 / max(P.shape[0], 1)), float("inf")
    p = p / s
    return p, float(np.abs(PT @ p - np.asarray(target)).max())


def solve_final_primal_l2(
    P: np.ndarray,
    target: np.ndarray,
    iters: int = 20_000,
    eps_margin: float = 1e-6,
    log: Optional[RunLog] = None,
    floor_donor: Optional[np.ndarray] = None,
    cfg: Optional[Config] = None,
    anchor_if_above: Optional[float] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, float]:
    """Committee probabilities realizing ``target`` within the minimal ε, with
    minimal L2 norm (maximal spread), on ``device`` (CUDA unless the caller
    passes another). Returns ``(p, ε)``.

    ``floor_donor`` is a KNOWN feasible probability vector over (a prefix
    of) ``P``'s rows, e.g. the LEXIMIN distribution the XMIN expansion grew
    from. With a donor the host ε-LP never runs: the ε floor is the better
    of the donor's own deviation and one device min-ε anchor, run only when
    the donor deviates by more than ``anchor_if_above`` (default half of
    ``Config.xmin_linf_band``). With ``Config.lp_batch`` the anchor, the
    floor pick and the ascent run fused (timer ``l2_fused``, counter
    ``lp_batch_l2_fused``; gauges ``l2_anchor_iters`` and
    ``l2_ascent_iters``); otherwise ``l2_eps_pdhg`` and ``l2_dual_ascent``.
    Without a donor, the host ``l2_eps_lp`` and the ascent. The ELL pack
    and its agent-major CSR are built once a call (timer ``sparse_pack``)
    when ``Config.sparse_ops`` routes the portfolio sparse; under a request
    context with a tenant session the pack comes from the session's pack
    memo when the same portfolio was packed before
    (``session_pack_hit``)."""
    from citizensassemblies_tpu_torch.solvers.batch_lp import lp_batch_enabled
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import FLAG_POISONED, sentinels_enabled
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack, sparse_enabled

    cfg = cfg or default_config()
    log = log if log is not None else RunLog(echo=False)
    dev = resolve_device(device)
    if anchor_if_above is None:
        # the gate tracks the configured spread band, so a tightened band
        # cannot skip the anchor while the donor already exceeds the band
        anchor_if_above = 0.5 * cfg.xmin_linf_band
    PT = P.T.astype(np.float64)
    tgt = np.asarray(target, dtype=np.float64)
    n = tgt.shape[0]
    fused_p: Optional[np.ndarray] = None
    Pnp = np.asarray(P)
    p_fill = float(np.count_nonzero(Pnp)) / max(Pnp.size, 1)
    ell = csr = None
    if sparse_enabled(cfg, p_fill):
        from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
        from citizensassemblies_tpu_torch.service.context import current_context

        # the tenant session's pack memo (service layer): a repeat solve over
        # the same portfolio reuses its pack (content-hashed, LRU-capped per
        # tenant; a failed request's teardown rolls back the packs it wrote)
        ctx = current_context()
        pack_key = None
        if ctx is not None and ctx.session is not None:
            import hashlib

            pack_key = "ell:" + hashlib.sha256(Pnp.tobytes()).hexdigest()
            ell = ctx.session.pack_get(pack_key)
            if ell is not None:
                log.count("session_pack_hit")
        with log.timer("sparse_pack"):
            if ell is None:
                ell = EllPack.from_rows(Pnp.astype(np.float32))
                if pack_key is not None:
                    ctx.session.pack_put(pack_key, ell, request_id=ctx.request_id)
            # the agent-major transpose goes up before any other device work
            # of the call: a copy from pageable memory waits for the stream
            csr = csr_to_device(ell.idx, ell.val, n, dev)
            idx_t = upload(ell.idx, dev)
        log.gauge("sparse_fill_pct", int(round(100 * ell.fill)))
        log.count("sparse_hit")
    else:
        log.count("sparse_miss")
    if floor_donor is not None:
        p_don = np.zeros(P.shape[0], dtype=np.float64)
        p_don[: len(floor_donor)] = np.asarray(floor_donor, dtype=np.float64)
        s = p_don.sum()
        if s <= 0:
            raise ValueError("floor donor carries no probability mass")
        p_don = p_don / s
        dev_don = float(np.abs(PT @ p_don - tgt).max())
        p_lp, eps_star = p_don, dev_don
        if dev_don > anchor_if_above and lp_batch_enabled(cfg, dev):
            # FUSED: anchor, floor pick and ascent as one device core; the
            # float64 floor/blend arithmetic below is unchanged
            sent = sentinels_enabled(cfg)
            max_chunks = max(1, -(-int(iters) // L2_CHUNK))
            check_every = int(cfg.pdhg_check_every or 128)
            with log.timer("l2_fused"):
                tj = upload(np.asarray(target, np.float32), dev)
                dj_h = np.asarray(p_don, np.float32)
                if inject.site("qp_nan", log):
                    # poison the donor: the QP sentinel must quarantine and
                    # the serial route recover
                    dj_h = dj_h.copy()
                    dj_h[0] = np.nan
                dj = upload(dj_h, dev)
                margin = torch.tensor(eps_margin, dtype=torch.float32, device=dev)
                if ell is not None:
                    core = _get_l2_fused_core_ell(
                        ANCHOR_ITERS, check_every, L2_CHUNK, max_chunks, sentinel=sent
                    )
                    val_t = upload(demote_operator(
                        ell.val, cfg, core="qp.l2_fused_core_ell", arg=1, log=log, device=dev
                    ), dev)
                    with dispatch_span(
                        "qp.l2_fused_core_ell", cfg=cfg, log=log, rows=int(idx_t.shape[0]),
                        kp=int(idx_t.shape[1]), n=int(n),
                    ) as ds, no_implicit_transfers(cfg):
                        ds.out = out = core(
                            idx_t, val_t, tj, dj, margin, ANCHOR_TOL, ASCENT_TOL, csr, log=log
                        )
                else:
                    core = _get_l2_fused_core(
                        ANCHOR_ITERS, check_every, L2_CHUNK, max_chunks, sentinel=sent
                    )
                    Pj = upload(demote_operator(
                        np.asarray(P, np.float32), cfg, core="qp.l2_fused_core", arg=0, log=log,
                        device=dev,
                    ), dev)
                    with dispatch_span(
                        "qp.l2_fused_core", cfg=cfg, log=log, rows=int(Pj.shape[0]), n=int(n),
                    ) as ds, no_implicit_transfers(cfg):
                        ds.out = out = core(Pj, tj, dj, margin, ANCHOR_TOL, ASCENT_TOL, log=log)
                fused_p = out[0].cpu().numpy().astype(np.float64)
                p_floor = np.clip(out[1].cpu().numpy().astype(np.float64), 0.0, 1.0)
            log.count("lp_batch_l2_fused")
            log.gauge("l2_anchor_iters", out[2])
            log.gauge("l2_ascent_iters", out[3])
            fused_flags = out[4] if sent else 0
            if (fused_flags & FLAG_POISONED) or not np.all(np.isfinite(fused_p)):
                # quarantine: the serial ascent below re-runs from the clean
                # donor and the float64 arithmetic judges it as always
                log.count("sentinel_quarantined")
                log.count("sentinel_host_resolve")
                fused_p = p_floor = None
            sf = p_floor.sum() if p_floor is not None else np.nan
            if np.isfinite(sf) and sf > 0:
                p_floor = p_floor / sf
                # the certified ε is recomputed in float64 from the returned
                # floor vector: the device's float32 pick only chose WHICH
                # vector
                dev_floor = float(np.abs(PT @ p_floor - tgt).max())
                if dev_floor < dev_don:
                    p_lp, eps_star = p_floor, dev_floor
        elif dev_don > anchor_if_above:
            with log.timer("l2_eps_pdhg"):
                p_pd, dev_pd = _min_eps_pdhg(P, PT, tgt, cfg=cfg, device=dev, log=log)
            if dev_pd < dev_don:
                p_lp, eps_star = p_pd, dev_pd
    else:
        from citizensassemblies_tpu_torch.solvers.highs_backend import solve_final_primal_lp

        with log.timer("l2_eps_lp"):
            p_lp, eps_star = solve_final_primal_lp(P, target)
    eps = eps_star + eps_margin

    if fused_p is not None:
        p = fused_p
    else:
        tj = upload(np.asarray(target, np.float32), dev)
        # dual-gradient Lipschitz constant σ_max(P)²/2 by power iteration:
        # the closed-form row·column-sum bound overestimates σ² by orders of
        # magnitude on expanded portfolios, stalling the spread
        if ell is not None:
            val_t = upload(demote_operator(
                ell.val, cfg, core="qp.l2_dual_ascent_ell", arg=1, log=log, device=dev
            ), dev)
            sigma_sq = float(_ell_power_norm(idx_t, val_t, n, csr=csr)) ** 2
        else:
            Pj = upload(demote_operator(
                np.asarray(P, np.float32), cfg, core="qp.l2_dual_ascent", arg=0, log=log, device=dev
            ), dev)
            sigma_sq = float(_power_norm(Pj)) ** 2
        L = max(sigma_sq / 2.0, 1.0)
        with log.timer("l2_dual_ascent"):
            eps_dev = torch.tensor(eps, dtype=torch.float32, device=dev)
            step_dev = torch.tensor(1.0 / L, dtype=torch.float32, device=dev)
            lam0 = torch.zeros(2 * n, dtype=torch.float32, device=dev)
            span = dispatch_span(
                "qp.l2_dual_ascent_ell" if ell is not None else "qp.l2_dual_ascent",
                cfg=cfg, log=log, iters=int(iters), rows=int(P.shape[0]), n=int(n),
                **({"kp": int(ell.k_pad)} if ell is not None else {}),
            )
            with span as ds, no_implicit_transfers(cfg):
                if ell is not None:
                    p, _lam = _min_norm_dual_ascent_ell(
                        idx_t, val_t, tj, eps_dev, step_dev, lam0, iters, csr=csr
                    )
                else:
                    p, _lam = _min_norm_dual_ascent(Pj, tj, eps_dev, step_dev, lam0, iters)
                ds.out = p
            p = p.cpu().numpy().astype(np.float64)
    p = np.clip(p, 0.0, 1.0)
    s = p.sum()
    if s <= 0:
        p = np.asarray(p_lp, dtype=np.float64)
    else:
        p = p / s
    # the float32 ascent converges to O(1e-3) residual; restore the exact ε
    # floor by blending with the (feasible) LP solution — the largest convex
    # weight on the spread iterate that keeps every agent above target − ε.
    # Support stays the union of both supports, so the spread survives.
    p_lp = np.clip(np.asarray(p_lp, dtype=np.float64), 0.0, 1.0)
    p_lp = p_lp / p_lp.sum()
    alloc_l2 = PT @ p
    alloc_lp = PT @ p_lp
    floor = np.asarray(target, dtype=np.float64) - eps
    deficit = floor - alloc_l2  # > 0 where the ascent iterate undershoots
    gain = alloc_lp - alloc_l2
    # a deficit below the float32 ulp of the allocation scale is
    # representation noise of the iterate, not an undershoot: blending on it
    # divides two O(ulp) numbers, so β would chatter with rounding choices
    slack = float(np.finfo(np.float32).eps) * max(
        1.0, float(np.abs(alloc_l2).max()) if alloc_l2.size else 1.0
    )
    mask = deficit > slack
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(mask & (gain > 0), deficit / gain, np.nan)
    finite = ratios[np.isfinite(ratios)]
    beta = float(finite.max()) if finite.size else (1.0 if mask.any() else 0.0)
    beta = min(max(beta, 0.0), 1.0)
    p = (1.0 - beta) * p + beta * p_lp
    return p, float(eps_star)


# --- registered cores (lint/registry.py) ----------------------------------------
# The ascents read nothing on the host for a fixed iteration count, so their
# cores are the whole functions. The fused cores read the host once per stage
# window (the anchor's blocks, the ascent's movement), so theirs stop at each
# stage's first window. Shapes, schedules and P1 ranges are the JAX
# registrations'.

#: the JAX registrations' fused schedule: anchor iterations, check interval,
#: ascent chunk, chunks
_IR_SCHEDULE = (1024, 128, 256, 8)


def _schedule_family(name: str) -> str:
    return name + "[" + ",".join(str(v) for v in _IR_SCHEDULE + (0,)) + "]"


def l2_fused_first_windows(P, t, p_don, eps_margin, eps_tol, ascent_tol, *, graph: bool = False):
    """The dense fused core (:func:`_get_l2_fused_core`) with each stage cut
    to its first window: the anchor's prelude and first PDHG block, the
    ε-floor pick, the power norm and the first ascent chunk. Returns ``(p,
    p_floor)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import lp_first_block

    _iters, check_every, chunk, _chunks = _IR_SCHEDULE
    family = _schedule_family("qp.l2_fused")
    P = P.to(iterate_dtype(P.dtype))
    C, n = P.shape
    f32 = dict(dtype=torch.float32, device=P.device)
    PT = P.t()
    c = torch.cat([torch.zeros(C, **f32), torch.ones(1, **f32)])
    G = torch.cat([-PT, -torch.ones((n, 1), **f32)], dim=1)
    A = torch.cat([torch.ones(C, **f32), torch.zeros(1, **f32)])[None, :]
    x = lp_first_block(
        c, G, -t, A, torch.ones(1, **f32), torch.zeros(C + 1, **f32), torch.zeros(n, **f32),
        torch.zeros(1, **f32), eps_tol, check_every=check_every, graph=graph,
        family=family + "/anchor",
    )[0]
    p_floor, eps = _floor_pick(x[:C], lambda p: PT @ p, t, p_don, eps_margin)
    lr = 1.0 / torch.clamp_min(_power_norm(P) ** 2 / 2.0, 1.0)
    p_of, step = _dense_ascent(P, t, eps, lr)
    run = _chunk_runner(step, chunk, None, graph,
                        (family + "/ascent", "qp.ascent_dense", (P, t, eps, lr)))
    (lam,) = run(torch.zeros(2 * n, **f32))
    return p_of(lam), p_floor


def l2_fused_ell_first_windows(idx, val, t, p_don, eps_margin, eps_tol, ascent_tol, *, csr,
                               graph: bool = False):
    """The ELL fused core (:func:`_get_l2_fused_core_ell`) with each stage
    cut to its first window (the two-sided anchor's first block over the
    pack, then as the dense one). Returns ``(p, p_floor)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import two_sided_first_block

    _iters, check_every, chunk, _chunks = _IR_SCHEDULE
    family = _schedule_family("qp.l2_fused_ell")
    C = idx.shape[0]
    n = t.shape[0]
    f32 = dict(dtype=torch.float32, device=val.device)
    x = two_sided_first_block(
        idx, val, t, torch.ones((1, C), **f32), torch.zeros((1, C + 1), **f32),
        torch.zeros((1, 2 * n), **f32), torch.zeros(1, **f32), eps_tol[None], csr=csr,
        check_every=check_every, graph=graph, family=family + "/anchor",
    )[0]
    csr_ops = _csr_tensors(val, csr)
    _gather, scatter = _ell_ops_from(idx, val, n, csr_ops)
    p_floor, eps = _floor_pick(x[0, :C], scatter, t, p_don, eps_margin)
    lr = 1.0 / torch.clamp_min(_ell_power_norm(idx, val, n, csr=csr) ** 2 / 2.0, 1.0)
    p_of, step = _ell_ascent(idx, val, csr_ops, t, eps, lr)
    run = _chunk_runner(step, chunk, None, graph,
                        (family + "/ascent", "qp.ascent_ell", (idx, val, *csr_ops, t, eps, lr)))
    (lam,) = run(torch.zeros(2 * n, **f32))
    return p_of(lam), p_floor


def _qp_operands(r, C: int, n: int, kp: Optional[int]):
    """A seeded portfolio (dense ``P`` or its ELL pack of ``kp`` members a
    panel) and target ``t``."""
    from citizensassemblies_tpu_torch.lint.operands import ell_operands

    idx, val = ell_operands(r, C, n, kp if kp else 8, p_zero=0.0)
    if kp is None:
        P = np.zeros((C, n), np.float32)
        np.put_along_axis(P, idx.astype(np.int64), 1.0, axis=1)
        return (r.t(P),), r.f32(n, 0.05, 0.2)
    return (r.t(idx), r.t(np.ones_like(val))), r.f32(n, 0.05, 0.2)


_ASCENT_RANGES = ((0.0, 1.0, False), (1e-8, 1e-2, False), (0.0, 1.0, False), (-1e4, 1e4, False))
_FUSED_RANGES = ((0.0, 1.0, False), (0.0, 1.0, False), (1e-8, 1e-2, False), (1e-8, 1e-2, False),
                 (1e-8, 1e-2, False))


@register_ir_core("qp.l2_dual_ascent", span="qp.l2_dual_ascent")
def _ir_dual_ascent(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(31, device)
    C, n = 96, 64
    (P,), t = _qp_operands(r, C, n, None)
    return IRCase(
        fn=_min_norm_dual_ascent,
        args=(P, t, r.full((), 1e-3), r.full((), 0.5), r.zeros(2 * n)),
        static=dict(iters=2048, graph=False),
        arg_ranges=((0.0, 256.0, True),) + _ASCENT_RANGES,
        prec_demote=(0,),  # P
        device=str(device), graph="qp.l2_dual_ascent",
    )


@register_ir_core("qp.l2_dual_ascent_ell", dense_ref="qp.l2_dual_ascent", span="qp.l2_dual_ascent_ell")
def _ir_dual_ascent_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(32, device)
    C, n, kp = 96, 64, 8
    (idx, val), t = _qp_operands(r, C, n, kp)
    csr = csr_to_device(idx.cpu().numpy(), val.cpu().numpy(), n, r.device)
    return IRCase(
        fn=_min_norm_dual_ascent_ell,
        args=(idx, val, t, r.full((), 1e-3), r.full((), 0.5), r.zeros(2 * n)),
        static=dict(iters=2048, csr=csr, graph=False),
        arg_ranges=(None, (0.0, 256.0, True)) + _ASCENT_RANGES,
        prec_demote=(1,),  # ELL values
        device=str(device), graph="qp.l2_dual_ascent_ell",
    )


@register_ir_core("qp.l2_fused_core", span="qp.l2_fused_core")
def _ir_l2_fused(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(33, device)
    C, n = 96, 64
    (P,), t = _qp_operands(r, C, n, None)
    return IRCase(
        fn=l2_fused_first_windows,
        args=(P, t, r.full((C,), 1.0 / C), r.full((), 1e-4), r.full((), 1e-5), r.full((), 1e-7)),
        static=dict(graph=False),
        arg_ranges=((0.0, 256.0, True),) + _FUSED_RANGES,
        prec_demote=(0,),  # P
        device=str(device), graph=_schedule_family("qp.l2_fused"),
    )


@register_ir_core("qp.l2_fused_core_ell", dense_ref="qp.l2_fused_core", span="qp.l2_fused_core_ell")
def _ir_l2_fused_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(34, device)
    C, n, kp = 96, 64, 8
    (idx, val), t = _qp_operands(r, C, n, kp)
    csr = csr_to_device(idx.cpu().numpy(), val.cpu().numpy(), n, r.device)
    return IRCase(
        fn=l2_fused_ell_first_windows,
        args=(idx, val, t, r.full((C,), 1.0 / C), r.full((), 1e-4), r.full((), 1e-5),
              r.full((), 1e-7)),
        static=dict(csr=csr, graph=False),
        arg_ranges=(None, (0.0, 256.0, True)) + _FUSED_RANGES,
        prec_demote=(1,),  # ELL values
        device=str(device), graph=_schedule_family("qp.l2_fused_ell"),
    )
