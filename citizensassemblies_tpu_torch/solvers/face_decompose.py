"""Realize a leximin profile as a mixture of feasible compositions, fast.

Phase 1 of the type-space solver (``cg_typespace.py``) must express the
probe-certified profile ``v`` as ``M p = v`` over feasible compositions.
Three ingredients do it:

* **Aimed slices** (``cg_typespace._slice_relaxation``) seed the hull around
  the target marginal ``x* = v·m``.
* **Face-neighbour expansion** generates columns combinatorially: for the
  support columns of the current master, every feasible single-unit move
  ``t → t'`` that shifts mass from over-served to under-served types (or
  along the near-optimal face) is itself a feasible composition. Quota
  feasibility of all (composition, move) pairs is checked with per-feature
  bitmasks packed into machine words.
* **An approximate master on the device**: each round's two-sided ε-LP is
  the warm-started PDHG of ``lp_pdhg.py`` over an incrementally maintained
  ELL pack (the hand-written block kernel on CUDA). Its duals aim the
  expansion, and acceptance needs no trusted solver: the certificate is the
  float64 identity ``ε = ‖M p − v‖∞`` on the returned mixture. A host
  interior-point solve runs only in the end-game, when the device polish
  misses the bar.

The loop is pipelined: the anchor MILPs run on a worker thread one round
behind the master (``_AnchorPricer``; the column schedule is identical
threaded or inline), the master's iterate carries across rounds, prunes and
bucket growths with a stall-triggered cold restart (``_WarmStall``), and the
per-round move screen runs as one batch of torch ops on the device
(``_batched_move_screen``), with two synchronisations a round: the master's
readback and the screen's.

In device-pricing mode (``Config.decomp_device_pricing``, on by default on
CUDA) the anchors are priced on the card (``solvers/device_pricing``; a
miss still goes to the host MILP) and the move screen chains onto the
master's device duals (``_FusedScreen``), so a steady round synchronises
once. With the batched LP engine (``Config.lp_batch``) the end-game screens
nested polish faces as lanes of one two-sided solve
(``batch_lp.solve_polish_screen_ell``) before the deep polish.

With ``Config.robust_checkpoint_every``/``robust_checkpoint_dir`` the
loop saves, after every N rounds, its running best certified state and its
whole state at the next round's top (``robust/checkpoint.FaceCheckpointer``);
a run of the same problem resumes at that round and replays the rounds the
uninterrupted run would have run, and a certified return removes the file.
A snapshot without the loop state (the JAX package's) resumes its columns
first with its mixture warming the first master. The fault sites ``face_abort``
(each round's start), ``oracle_raise`` (each anchor MILP; retried once,
then skipped) and ``device_dispatch`` (each device pricing dispatch) are
consulted here. Only an injected fault (``FaultInjected``) at
``device_dispatch`` degrades the run to host-MILP anchors
(``robust_degrade_device_pricing``); any other error of the dispatch, a
kernel's among them, propagates.

The per-request deadline (``RequestContext.deadline``, the context passed
as ``ctx`` or else the ambient one, ``service/context.py``) is checked once
a round, at the round's top: one host clock read, no device sync. Past it
the loop raises ``DeadlineExceeded`` with ``partial={"decomp_rounds",
"best_eps"}``, the rounds run and the best certified ε so far.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import ExitStack
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from citizensassemblies_tpu_torch.dist.runtime import effective_mesh
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.robust.policy import DegradationLadder
from citizensassemblies_tpu_torch.robust.checkpoint import (
    FaceCheckpointer,
    FaceLoopState,
    FaceSubmit,
)
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.utils.config import default_config
from citizensassemblies_tpu_torch.utils import device as _device
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device, upload
from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers
from citizensassemblies_tpu_torch.aot.store import note_eager
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.utils.logging import RunLog

#: compositions per screening batch: ``realize_profile`` expands at most the
#: top 512 support columns
_SCREEN_ROWS = 512

#: minimum mass-bearing support before the batched polish-face screen pays:
#: below it the candidate prefixes would all be small and the deep polish is
#: already one small solve
_POLISH_SCREEN_MIN_SUP = 256


def _feature_bitmasks(reduction: TypeReduction):
    """Per-type feature masks for the move-feasibility screen.

    The quota conditions of a unit move collapse to bit tests: moving a unit
    *out* of type ``t`` decrements each of ``t``'s features, which is safe
    iff the composition's count stays ≥ lo there; moving *in* increments,
    safe iff ≤ hi. One 64-bit word covers every category whose features all
    index below 64; the other categories are screened by direct gathers.
    Returns ``(feat_mask[T] uint64, leftover_cats)``, or ``None`` when no
    category fits a word.
    """
    feat_of = np.asarray(reduction.type_feature)
    ncat = feat_of.shape[1]
    word_cats = [ci for ci in range(ncat) if int(feat_of[:, ci].max()) < 64]
    if not word_cats:
        return None
    masks = np.zeros(reduction.T, dtype=np.uint64)
    for ci in word_cats:
        masks |= np.uint64(1) << feat_of[:, ci].astype(np.uint64)
    leftover = [ci for ci in range(ncat) if ci not in word_cats]
    return masks, leftover


def _move_pairs(
    reduction: TypeReduction,
    r_norm: np.ndarray,
    pool_cap: int,
    face_pairs: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The expansion's candidate (donor, receiver) pairs: the improving
    extremes of the residual direction plus the smallest-|Δ| face pairs.
    Returns ``(ti, tj)``."""
    T = reduction.T
    order = np.argsort(-r_norm)
    # improving pairs: extremes of the residual direction
    donors = order[:pool_cap]
    receivers = order[::-1][:pool_cap]
    ti_a, tj_a = np.meshgrid(donors, receivers, indexing="ij")
    pairs = [np.stack([ti_a.ravel(), tj_a.ravel()], axis=1)]
    # face pairs: smallest |Δ| over a broad random pool (full T² only for
    # small T)
    if T * T <= 1 << 18:
        di = np.repeat(np.arange(T), T)
        dj = np.tile(np.arange(T), T)
    else:
        rng = np.random.default_rng(T)
        di = rng.integers(0, T, size=face_pairs * 8)
        dj = rng.integers(0, T, size=face_pairs * 8)
    delta = np.abs(r_norm[di] - r_norm[dj])
    sel = np.argsort(delta)[:face_pairs]
    pairs.append(np.stack([di[sel], dj[sel]], axis=1))
    tp = np.concatenate(pairs, axis=0)
    tp = tp[tp[:, 0] != tp[:, 1]]
    tp = np.unique(tp, axis=0)
    return tp[:, 0], tp[:, 1]


def _comp_feature_counts(comps: np.ndarray, reduction: TypeReduction) -> np.ndarray:
    """Per-composition feature counts [S, F] (float32 BLAS, then cast: the
    counts are ≤ k, far inside float32's exact-integer range)."""
    T = reduction.T
    feat_of = np.asarray(reduction.type_feature)
    ncat = feat_of.shape[1]
    tf = np.zeros((T, reduction.F), dtype=np.float32)
    tf[np.repeat(np.arange(T), ncat), feat_of.ravel()] = 1.0
    return (comps.astype(np.float32) @ tf).astype(np.int64)


def _screen_feasible(
    comps_i, counts_nb, lo_nb, hi_nb, counts_full, lo_f, hi_f,
    m_t, ti, tj, valid, need_sub, need_add, lf_ai, lf_aj, lf_donor,
):
    """The [S, P] (composition, move) feasibility check shared by the two
    device screens: base bounds by two gathers, the per-feature quota
    conditions by packed 64-bit words (int64 lanes; the bit patterns are
    those of the numpy uint64 masks), the leftover categories by direct
    gathers (``lf_donor`` host booleans: whether a category's donor side
    needs a check at all)."""
    dev = comps_i.device
    nb = counts_nb.shape[1]
    ok = (comps_i[:, ti] > 0) & (comps_i[:, tj] < m_t[tj][None, :]) & valid[None, :]
    fbit = torch.ones(nb, dtype=torch.int64, device=dev) << torch.arange(nb, dtype=torch.int64, device=dev)
    can_sub = ((counts_nb - 1 >= lo_nb[None, :]).long() * fbit).sum(1)
    can_add = ((counts_nb + 1 <= hi_nb[None, :]).long() * fbit).sum(1)
    ok &= (need_sub[None, :] & ~can_sub[:, None]) == 0
    ok &= (need_add[None, :] & ~can_add[:, None]) == 0
    for a_i, a_j, donor in zip(lf_ai, lf_aj, lf_donor):
        same = a_i == a_j
        add_ok = counts_full[:, a_j] + 1 <= hi_f[a_j][None, :]
        if donor:
            add_ok &= counts_full[:, a_i] - 1 >= lo_f[a_i][None, :]
        ok &= same[None, :] | add_ok
    return ok


def _first_true(flat: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-size nonzero of a flat bool tensor: the indices of its
    first ``cap`` true entries in order, padded with −1, and the true count
    — both on the device, by a cumulative sum and one scatter, so nothing
    waits on the host. Returns ``(idx [cap] int32, total)``."""
    n = flat.shape[0]
    pos = torch.cumsum(flat, dim=0, dtype=torch.int64) - 1
    slot = torch.where(flat & (pos < cap), pos, torch.full_like(pos, cap))
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=flat.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=flat.device))
    return out[:cap].to(torch.int32), flat.sum(dtype=torch.int32)


def _screen_statics(reduction: TypeReduction, leftover, device):
    """The per-instance screen operands: feature quotas (``nb`` word bits,
    full), the leftover categories' feature columns and donor flags."""
    F = reduction.F
    nb = min(F, 64)
    lo = reduction.qmin.astype(np.int64)
    hi = reduction.qmax.astype(np.int64)
    feat_of = np.asarray(reduction.type_feature)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)

    lf_donor = [bool((lo[feat_of[:, ci]] > 0).any()) for ci in leftover]
    return dict(
        lo_nb=dev(lo[:nb]), hi_nb=dev(hi[:nb]), lo_f=dev(lo), hi_f=dev(hi),
        lf_feat=[dev(feat_of[:, ci]) for ci in leftover], lf_donor=lf_donor,
    )


def _move_screen_dispatch(
    comps: np.ndarray,
    counts: np.ndarray,
    reduction: TypeReduction,
    m: np.ndarray,
    ti: np.ndarray,
    tj: np.ndarray,
    packed,
    per_round_cap: int,
    device: torch.device,
):
    """The upload and device half of the move screen, up to but not
    including the readback: the operands go up without blocking the host
    (``utils.device.upload``) and the feasible (composition, pair) indices
    come back as a fixed-size device vector (:func:`_first_true`, row-major,
    so below the cap the index set is the numpy screen's). Returns
    ``(idx device [cap], total device, P)``."""
    masks, leftover = packed
    nb = min(reduction.F, 64)
    st = _screen_statics(reduction, leftover, device)
    i64 = torch.int64

    def up(a):
        return upload(np.asarray(a), device, i64)

    diff = masks[ti] ^ masks[tj]
    feat_of = np.asarray(reduction.type_feature)
    ti_t, tj_t = up(ti), up(tj)
    operands = (
        up(comps.astype(np.int64)), up(counts[:, :nb]), st["lo_nb"], st["hi_nb"], up(counts),
        st["lo_f"], st["hi_f"], up(np.asarray(m, np.int64)), ti_t, tj_t,
        torch.ones(len(ti), dtype=torch.bool, device=device),
        up((masks[ti] & diff).view(np.int64)), up((masks[tj] & diff).view(np.int64)),
        [up(feat_of[ti, ci]) for ci in leftover], [up(feat_of[tj, ci]) for ci in leftover],
        st["lf_donor"],
    )
    # an eager family: recorded for the graph store, no one-time work
    note_eager("face_decompose.move_screen", operands[:13], {"cap": int(per_round_cap)})
    with dispatch_span("face_decompose.move_screen", pairs=int(len(ti))) as ds:
        with guarded_launch(device):
            ok = _screen_feasible(*operands)
            idx, total = _first_true(ok.reshape(-1), int(per_round_cap))
        ds.out = idx
    return idx, total, len(ti)


def _batched_move_screen(
    comps: np.ndarray,
    counts: np.ndarray,
    reduction: TypeReduction,
    m: np.ndarray,
    ti: np.ndarray,
    tj: np.ndarray,
    packed,
    per_round_cap: int,
    device: torch.device,
    cfg=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The whole [S, P] (composition, move) feasibility check as one batch
    of torch ops on ``device`` (:func:`_move_screen_dispatch`), then its one
    readback: the first ``per_round_cap`` feasible (composition, pair)
    indices in row-major order. Returns ``(si, pi, total_feasible)``."""
    with no_implicit_transfers(cfg):
        idx_dev, total_dev, P = _move_screen_dispatch(
            comps, counts, reduction, m, ti, tj, packed, per_round_cap, device
        )
    idx = idx_dev.cpu().numpy()
    idx = idx[idx >= 0]
    return idx // P, idx % P, int(total_dev)


def neighbor_columns(
    comps: np.ndarray,
    reduction: TypeReduction,
    r_norm: np.ndarray,
    pool_cap: int = 128,
    face_pairs: int = 12_288,
    per_round_cap: int = 16_384,
    batched: bool = False,
    device: DeviceLike = "cpu",
    cfg=None,
) -> np.ndarray:
    """Feasible single-unit moves from ``comps`` along and across the face.

    Two pair classes feed the expansion: **improving** pairs move a unit
    from an over-served type (``r_norm > 0``) to an under-served one;
    **face-preserving** pairs (``|Δ(w/m)| ≈ 0``) enumerate the near-optimal
    face. A move ``t → t'`` from composition ``c`` is feasible iff
    ``c_t > 0``, ``c_{t'} < m_{t'}`` and, in every category where the two
    types' features differ, the donor's feature stays ≥ its lower quota and
    the receiver's ≤ its upper. With ``batched=True`` the screen runs as one
    batch of torch ops on ``device`` (``_batched_move_screen``): identical
    index set below ``per_round_cap``; above it the first (mass-ordered,
    since callers pass support-ordered compositions) feasible moves are kept
    where the numpy path subsamples randomly. Returns the new compositions
    (int16 [N, T]).
    """
    comps = comps.astype(np.int16, copy=False)
    S, T = comps.shape
    feat_of = np.asarray(reduction.type_feature)
    ncat = feat_of.shape[1]
    F = reduction.F
    # no composition holds more than k of a type: the receiver check only
    # needs min(m, k + 1), which also keeps the int16 cast in range
    m = np.minimum(reduction.msize, reduction.k + 1).astype(np.int16)
    lo = reduction.qmin.astype(np.int64)
    hi = reduction.qmax.astype(np.int64)

    ti, tj = _move_pairs(reduction, r_norm, pool_cap, face_pairs)
    P = len(ti)
    if P == 0:
        return np.zeros((0, T), dtype=np.int16)

    counts = _comp_feature_counts(comps, reduction)  # [S, F]

    packed = _feature_bitmasks(reduction)
    if batched and packed is not None and S <= _SCREEN_ROWS:
        si, pi, _total = _batched_move_screen(
            comps, counts, reduction, m, ti, tj, packed, per_round_cap,
            torch.device(device), cfg=cfg,
        )
        if len(si) == 0:
            return np.zeros((0, T), dtype=np.int16)
        out = comps[si].astype(np.int16)
        idx = np.arange(len(si))
        out[idx, ti[pi]] -= 1
        out[idx, tj[pi]] += 1
        return out

    ok = (comps[:, ti] > 0) & (comps[:, tj] < m[tj][None, :])  # [S, P]
    if packed is not None:
        masks, leftover = packed
        # bit f set ⇔ this composition may donate (resp. receive) a unit of
        # feature f without breaking its quota
        nb = min(F, 64)
        fbit = np.uint64(1) << np.arange(nb, dtype=np.uint64)
        can_sub = ((counts[:, :nb] - 1 >= lo[None, :nb]).astype(np.uint64) * fbit).sum(
            axis=1, dtype=np.uint64
        )
        can_add = ((counts[:, :nb] + 1 <= hi[None, :nb]).astype(np.uint64) * fbit).sum(
            axis=1, dtype=np.uint64
        )
        # features touched by the move: symmetric difference of the two
        # types' feature sets (shared features cancel)
        diff = masks[ti] ^ masks[tj]
        need_sub = masks[ti] & diff
        need_add = masks[tj] & diff
        ok &= (need_sub[None, :] & ~can_sub[:, None]) == 0
        ok &= (need_add[None, :] & ~can_add[:, None]) == 0
        for ci in leftover:
            a_i = feat_of[ti, ci]
            a_j = feat_of[tj, ci]
            same = a_i == a_j
            add_ok = counts[:, a_j] + 1 <= hi[a_j][None, :]
            if (lo[feat_of[:, ci]] > 0).any():
                add_ok &= counts[:, a_i] - 1 >= lo[a_i][None, :]
            ok &= same[None, :] | add_ok
    else:  # pragma: no cover - every instance has some ≤64-feature category
        for ci in range(ncat):
            a_i = feat_of[ti, ci]
            a_j = feat_of[tj, ci]
            same = a_i == a_j
            sub_ok = counts[:, a_i] - 1 >= lo[a_i][None, :]
            add_ok = counts[:, a_j] + 1 <= hi[a_j][None, :]
            ok &= same[None, :] | (sub_ok & add_ok)

    si, pi = np.nonzero(ok)
    if len(si) == 0:
        return np.zeros((0, T), dtype=np.int16)
    if len(si) > per_round_cap:
        sel = np.random.default_rng(len(si)).choice(len(si), per_round_cap, replace=False)
        si, pi = si[sel], pi[sel]
    out = comps[si].astype(np.int16)
    idx = np.arange(len(si))
    out[idx, ti[pi]] -= 1
    out[idx, tj[pi]] += 1
    return out


def _stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``x``, ties to the lower
    index (the order of ``jax.lax.top_k``; ``torch.topk`` leaves it open)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def fused_screen_core(
    lam, m_f, comps_i, counts_nb, lo_nb, hi_nb, counts_full, lo_f, hi_f, m_t,
    mask, cand_di, cand_dj, lf_feat, lf_donor, cap: int, pool_cap: int, face_pairs: int,
):
    """The fused move screen on the master's device duals ``lam [2T]``: the
    pair selection of :func:`_move_pairs` on the device (improving pairs as
    the meshgrid of the residual's ``pool_cap`` extremes, face pairs as the
    ``face_pairs`` smallest |Δ| over the static candidate pool ``cand_di``/
    ``cand_dj``), the need-masks from the per-type feature words ``mask``
    (int64), then :func:`_screen_feasible`. Returns ``(idx [cap] int32,
    total, ti, tj)`` on the device; nothing synchronises with the host."""
    T = m_f.shape[0]
    w = lam[:T] - lam[T:]
    r = -w / m_f
    donors = _stable_top(r, pool_cap)
    receivers = _stable_top(-r, pool_cap)
    delta = torch.abs(r[cand_di] - r[cand_dj])
    sel = _stable_top(-delta, face_pairs)
    ti = torch.cat([donors[:, None].expand(pool_cap, pool_cap).reshape(-1), cand_di[sel]])
    tj = torch.cat([receivers.repeat(pool_cap), cand_dj[sel]])
    diff = mask[ti] ^ mask[tj]
    ok = _screen_feasible(
        comps_i, counts_nb, lo_nb, hi_nb, counts_full, lo_f, hi_f, m_t, ti, tj, ti != tj,
        mask[ti] & diff, mask[tj] & diff,
        [f[ti] for f in lf_feat], [f[tj] for f in lf_feat], lf_donor,
    )
    idx, total = _first_true(ok.reshape(-1), cap)
    return idx, total, ti.to(torch.int32), tj.to(torch.int32)


class _FusedScreen:
    """Same-round device move screen chained onto the master's device duals.

    The classic round reads the master's duals back to pick the move pairs
    on the host, then reads the screen's result back: two synchronisations a
    round. Here the pair selection runs on the device
    (:func:`fused_screen_core`): ``dispatch`` is called with the master's
    duals still on the device and queues the screen behind the solve, and
    the round's one blocking readback (the master's) leaves the screen
    complete, so ``harvest`` decodes it without waiting on compute. The
    screened block is the round's master columns (mass-ordered prefix from
    the previous prune), known before the master returns; the pairs come
    from the current duals.
    """

    def __init__(self, reduction: TypeReduction, per_round_cap: int, cfg=None,
                 device: DeviceLike = None):
        self.red = reduction
        self.cap = int(per_round_cap)
        self.cfg = cfg
        self.device = resolve_device(device)
        packed = _feature_bitmasks(reduction)
        self.ok = packed is not None
        self._pending = None  # (idx, ti, tj, comps) or None
        if not self.ok:  # pragma: no cover - every instance has a word category
            return
        masks, leftover = packed
        T = reduction.T
        dev = self.device
        # device-resident static operands: uploaded once per instance
        self._mask = torch.as_tensor(masks.view(np.int64), device=dev)
        self._st = _screen_statics(reduction, leftover, dev)
        # static face-pair candidate pool (the construction of _move_pairs:
        # full T² when small, a T-seeded random pool otherwise)
        if T * T <= 1 << 18:
            di = np.repeat(np.arange(T), T)
            dj = np.tile(np.arange(T), T)
        else:
            rng = np.random.default_rng(T)
            di = rng.integers(0, T, size=12_288 * 8)
            dj = rng.integers(0, T, size=12_288 * 8)
        self._cand_di = torch.as_tensor(di.astype(np.int64), device=dev)
        self._cand_dj = torch.as_tensor(dj.astype(np.int64), device=dev)
        self.pool_cap = min(128, T)
        self.face_pairs = min(12_288, len(di))
        self._m_t = torch.as_tensor(
            np.minimum(reduction.msize, reduction.k + 1).astype(np.int64), device=dev
        )
        self._m_f = torch.as_tensor(reduction.msize.astype(np.float32), device=dev)

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def dispatch(self, comps: np.ndarray, lam_dev: torch.Tensor) -> bool:
        """Queue the screen behind the in-flight master whose device duals
        are ``lam_dev`` (async: the operands go up through pinned memory and
        nothing is read back here)."""
        if not self.ok or len(comps) > _SCREEN_ROWS:  # pragma: no cover
            self._pending = None
            return False
        comps = comps.astype(np.int16, copy=False)
        counts = _comp_feature_counts(comps, self.red)
        nb = min(self.red.F, 64)
        dev = self.device
        st = self._st
        operands = (
            lam_dev, self._m_f, upload(comps, dev, torch.int64),
            upload(counts[:, :nb], dev), st["lo_nb"], st["hi_nb"], upload(counts, dev),
            st["lo_f"], st["hi_f"], self._m_t, self._mask, self._cand_di, self._cand_dj,
            st["lf_feat"], st["lf_donor"], self.cap, self.pool_cap, self.face_pairs,
        )
        note_eager("face_decompose.fused_screen", operands[:15],
                   {"cap": self.cap, "pool_cap": self.pool_cap, "face_pairs": self.face_pairs})
        with dispatch_span("face_decompose.fused_screen", cfg=self.cfg, rows=int(len(comps))) as ds:
            with no_implicit_transfers(self.cfg), guarded_launch(dev):
                idx, _total, ti, tj = fused_screen_core(*operands)
            ds.out = idx
        self._pending = (idx, ti, tj, comps)
        return True

    def harvest(self) -> np.ndarray:
        """Decode the screen results (complete by the time the master's
        readback returned) into new compositions int16 [N, T]."""
        pending, self._pending = self._pending, None
        if pending is None:
            return np.zeros((0, self.red.T), dtype=np.int16)
        idx_dev, ti_dev, tj_dev, comps = pending
        idx = idx_dev.cpu().numpy()
        ti = ti_dev.cpu().numpy()
        tj = tj_dev.cpu().numpy()
        idx = idx[idx >= 0]
        if len(idx) == 0:
            return np.zeros((0, self.red.T), dtype=np.int16)
        P = len(ti)
        si, pi = idx // P, idx % P
        out = comps[si].astype(np.int16)
        rows = np.arange(len(si))
        out[rows, ti[pi]] -= 1
        out[rows, tj[pi]] += 1
        return out


def _master_pdhg(
    MT: np.ndarray,
    v: np.ndarray,
    cfg,
    warm,
    max_iters: int,
    tol: float,
    ell=None,
    device: DeviceLike = None,
    log: Optional[RunLog] = None,
    screen=None,
) -> Tuple[float, np.ndarray, np.ndarray, float, Optional[tuple], bool]:
    """One approximate master solve on ``device``: the two-sided ε-LP
    through ``lp_pdhg.solve_two_sided_master[_ell]_async`` (over the ELL
    pack ``ell`` when given). The readback in ``finish_two_sided_master`` is
    the solve's one blocking synchronisation. ``screen`` (device-pricing
    mode) is called with the master's device duals the moment the solve is
    queued: the fused move screen it dispatches runs behind the solve, so
    that readback stays the round's one synchronisation.

    Returns ``(eps_realized, w, p_norm, eps_obj, warm', ok)`` where
    ``eps_realized = ‖M p_norm − v‖∞`` is the float64 certificate of the
    normalized primal iterate (valid whether or not the solver converged),
    ``w = y_lo − y_up`` the aiming duals, ``eps_obj`` the iterate's
    objective value (a stall indicator, not a bound) and ``ok`` the
    solver's own convergence flag.
    """
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import (
        finish_two_sided_master,
        solve_two_sided_master_async,
        solve_two_sided_master_ell_async,
    )

    T, C = MT.shape
    kw = dict(cfg=cfg, warm=warm, tol=tol, max_iters=max_iters, device=device, log=log)
    if ell is not None:
        handle = solve_two_sided_master_ell_async(ell, v, **kw)
    else:
        handle = solve_two_sided_master_async(MT, v, **kw)
    if screen is not None:
        screen(handle.lam)
    sol = finish_two_sided_master(handle)
    p = np.maximum(sol.x[:C], 0.0)
    total = p.sum()
    if not np.isfinite(total) or total <= 0.0:
        return float("inf"), np.zeros(T), np.full(C, 1.0 / max(C, 1)), float("inf"), None, False
    p_norm = p / total
    eps_real = float(np.abs(MT @ p_norm - v).max())
    lam = np.maximum(sol.lam, 0.0)
    w = lam[:T] - lam[T:]
    return eps_real, w, p_norm, float(sol.objective), (sol.x, sol.lam, sol.mu), sol.ok


class _AnchorPricer:
    """Double-buffered pricing for the face loop's anchor MILPs.

    The anchors (one dual-direction optimum, alternate-round noisy variants,
    up to three forced-inclusion columns for persistent deficits) are
    heuristic columns — acceptance is the master iterate's arithmetic
    residual — so their aim may lag the duals by one round. Round r's MILPs
    are submitted the moment round r's duals exist and harvested at round
    r+1's expansion; with ``overlap=True`` they run on a worker thread while
    the main thread runs the expansion and the next device master (HiGHS
    releases the GIL inside its solve, and the main thread releases it while
    it waits on the device). ``overlap=False`` runs the same schedule inline:
    the column stream is identical in both modes. The noisy perturbations
    are drawn on the caller's thread at submit time.

    With ``device`` set (``solvers/device_pricing.DevicePricer``, behind the
    ``Config.decomp_device_pricing`` gate) the worker is the card instead of
    a host thread: ``submit`` prices the whole task batch in one async
    device dispatch and ``harvest`` decodes it. Tasks the device served skip
    their host MILP (``decomp_oracle_device_hit``); tasks with no surviving
    lane still get the exact host MILP (``decomp_oracle_device_miss``).
    An injected fault at the dispatch (site ``device_dispatch``) walks the
    degradation ladder (``robust/policy.DegradationLadder``) one rung; its
    first rung turns device pricing off, which drops the device for the
    rest of the run, the host MILPs carrying the anchors
    (``robust_degrade_device_pricing``). Any other failure of the dispatch
    raises.
    """

    def __init__(
        self,
        oracle,
        rng: np.random.Generator,
        reduction: TypeReduction,
        overlap: bool,
        log: Optional[RunLog] = None,
        device=None,
        cfg=None,
    ):
        self.oracle = oracle
        self.rng = rng
        self.red = reduction
        self.log = log
        self.device = device
        self.cfg = cfg or default_config()
        self._ladder = DegradationLadder()
        # the fault injector rides a context variable: the worker thread is
        # outside the caller's context, so it is captured here
        self._inj = inject.active_injector()
        self._pool = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="anchor-pricer")
            if overlap and device is None
            else None
        )
        self._pending: Optional[Union[Future, List[np.ndarray], tuple]] = None

    def _run(self, tasks) -> List[np.ndarray]:
        out = []
        for weights, forced in tasks:
            # an oracle failure retries once, then skips the task: a missing
            # anchor costs convergence speed, never exactness
            for attempt in (0, 1):
                try:
                    inject.raise_if("oracle_raise", self.log, inj=self._inj)
                    # a 1 % MILP gap: anchor optimality buys nothing
                    got = self.oracle.maximize(weights, forced_type=forced, rel_gap=1e-2)
                    if got is not None:
                        out.append(got[0][None, :].astype(np.int16))
                    break
                except Exception:
                    if self.log is not None:
                        self.log.count("robust_oracle_skip" if attempt else "robust_oracle_retry")
        return out

    def submit(
        self,
        rnd: int,
        r_norm: np.ndarray,
        eps: float,
        realized: Optional[np.ndarray],
        v: np.ndarray,
    ) -> None:
        """Queue round ``rnd``'s anchor MILPs (noise drawn here, on the
        caller's thread)."""
        tasks: List[Tuple[np.ndarray, Optional[int]]] = [(-r_norm, None)]
        if rnd % 2 == 0:
            # noisy variants only diversify, so they run on alternate rounds
            scale = float(np.mean(np.abs(r_norm))) + 1e-12
            for _ in range(2):
                tasks.append((-r_norm + self.rng.normal(0.0, 0.5 * scale, len(r_norm)), None))
        if realized is not None:
            # forced-inclusion anchors on the worst under-served types: a
            # persistent deficit needs columns that contain the type
            deficit = v - realized
            worst = np.argsort(-deficit)[:3]
            for t in worst:
                if deficit[t] > 0.25 * eps and self.red.msize[t] > 0:
                    tasks.append((-r_norm, int(t)))
        if self.device is not None:
            # the card is the worker: one async dispatch prices the whole
            # batch; the handle is decoded at the next harvest
            try:
                inject.raise_if("device_dispatch", self.log, inj=self._inj)
            except inject.FaultInjected:
                # one rung of the ladder; its first turns device pricing
                # off, and the exact host MILPs carry the anchors from here
                # on (the device only ever saved host work, so this is a
                # slowdown, never another result). Only an injected fault
                # walks it: a real failure of the dispatch raises out of
                # the loop.
                self.cfg = self._ladder.degrade(self.cfg, self.log)
                if self.cfg.decomp_device_pricing is False:
                    if self.log is not None:
                        self.log.count("robust_degrade_device_pricing")
                    self.device = None
            else:
                self._pending = ("device", self.device.dispatch(tasks), tasks)
                return
        if self._pool is not None:
            self._pending = self._pool.submit(self._run, tasks)
        else:
            self._pending = self._run(tasks)

    def _harvest_device(self, handle, tasks) -> List[np.ndarray]:
        """Decode a device pricing dispatch: device-served tasks in task
        order, then the host-MILP results for the misses (inline: misses are
        the exception)."""
        if handle is None:
            return []
        hits, missed = self.device.harvest(handle)
        if self.log is not None:
            if hits:
                self.log.count("decomp_oracle_device_hit", len(hits))
                self.log.count("oracle_backend_device", len(hits))
            if missed:
                self.log.count("decomp_oracle_device_miss", len(missed))
        out = [comp for _i, comp in hits]
        if missed:
            out.extend(self._run([tasks[i] for i in missed]))
        return out

    def harvest(self) -> List[np.ndarray]:
        """Collect the previously submitted round's columns (blocks only
        when the worker has not finished; the overlap counters say which)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return []
        if isinstance(pending, tuple) and pending and pending[0] == "device":
            return self._harvest_device(pending[1], pending[2])
        if isinstance(pending, list):
            if self.log is not None:
                self.log.count("decomp_oracle_inline")
            return pending
        if self.log is not None:
            self.log.count(
                "decomp_oracle_overlap_hit" if pending.done() else "decomp_oracle_overlap_wait"
            )
        return pending.result()

    def close(self) -> None:
        """Drop any un-harvested job and stop the worker."""
        pending, self._pending = self._pending, None
        if isinstance(pending, Future):
            pending.cancel()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class _WarmStall:
    """Cold-restart policy for the warm-started PDHG master: a warm-started
    round that fails to beat the running-best ε by ≥ ``(1 − improve)``
    extends a streak; ``patience`` consecutive such rounds drop the warm
    iterate once. Cold rounds never extend the streak."""

    def __init__(self, patience: int, improve: float = 0.98):
        self.patience = max(int(patience), 1)
        self.improve = improve
        self.best = float("inf")
        self.streak = 0

    def update(self, eps: float, warm_used: bool) -> bool:
        improved = eps < self.best * self.improve
        self.best = min(self.best, eps)
        if improved or not warm_used:
            if improved:
                self.streak = 0
            return False
        self.streak += 1
        if self.streak >= self.patience:
            self.streak = 0
            return True
        return False


def realize_profile(
    reduction: TypeReduction,
    v: np.ndarray,
    seed_comps: List[np.ndarray],
    oracle,
    accept: float,
    log: Optional[RunLog] = None,
    max_rounds: int = 60,
    master_cap: int = 6_000,
    use_pdhg: Optional[bool] = None,
    cfg=None,
    device: DeviceLike = None,
    ctx=None,
) -> Tuple[np.ndarray, Optional[np.ndarray], float, int]:
    """Find compositions + probabilities with ``‖Mp − v‖∞ ≤ accept``.

    The per-round master is the warm-started PDHG on ``device`` when
    ``use_pdhg`` (default: ``device`` is an accelerator), else the host
    interior point. Its duals aim the neighbour expansion and the float64
    residual of its normalized iterate is the acceptance certificate. When
    the approximate master's objective dips near ``accept`` but its iterate
    lags, an end-game polish on the mass-bearing support (a deep device
    solve, then the host IPM) extracts the optimum. Aggressive pruning keeps
    every master at ≤ ``master_cap`` columns.

    ``ctx`` (default the ambient ``service.RequestContext``) supplies the
    ``cfg`` and ``log`` not given and the per-round ``deadline``.

    Returns ``(compositions int32 [C, T], probabilities float64 [C], eps,
    lp_solves)``.
    """
    from citizensassemblies_tpu_torch.solvers.cg_typespace import _decomp_lp
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack, sparse_enabled

    ctx, cfg, log = resolve_context(ctx, cfg, log)
    deadline = ctx.deadline if ctx is not None else None
    dev = resolve_device(device)
    T = reduction.T
    m = reduction.msize.astype(np.float64)
    if use_pdhg is None:
        use_pdhg = _device.on_accelerator(dev)
    accel = bool(use_pdhg)
    if T <= cfg.decomp_host_master_max_types:
        # small-T instances stay on host masters end to end: cap the column
        # set so the expansion cannot push the master past the host's sweet
        # spot
        master_cap = min(master_cap, cfg.decomp_host_master_max_cols)

    seen: Dict[bytes, int] = {}
    cols: List[np.ndarray] = []

    def add(c: np.ndarray) -> bool:
        kb = c.astype(np.int16).tobytes()
        if kb in seen:
            return False
        seen[kb] = len(cols)
        cols.append(c.astype(np.int16))
        return True

    # --- crash-consistent checkpoints (robust/checkpoint) --------------------
    # a matching snapshot resumes here. With its loop state the round's
    # column set is restored as it was (the seeds were spent before the
    # save); without it (a JAX package snapshot) its columns seed the hull
    # first (so its mixture maps positionally onto the first master's warm
    # start) and the seeds dedup in behind them
    ckpt = FaceCheckpointer(cfg, reduction, v, accept)
    resume = ckpt.load(T)
    loop_state: Optional[FaceLoopState] = resume.loop if resume is not None else None
    if resume is not None:
        for c in resume.compositions if loop_state is None else loop_state.cols:
            add(c)
        log.count("robust_resume")
        log.emit(
            f"  face checkpoint resumed: {len(cols)} columns from round "
            f"{resume.round} (eps {resume.eps:.2e})."
        )

    if loop_state is None:
        for c in seed_comps:
            add(c)

    # --- structured-sparse master state (solvers/sparse_ops) ----------------
    # master columns are compositions (≤ k nonzeros of T types); the ELL pack
    # is maintained incrementally in lockstep with ``cols``: appends pack only
    # the new columns, a prune subsets, a column-set replacement resets it
    sparse_try = accel and cfg.sparse_ops is not False
    ell_pack: Optional[EllPack] = EllPack(minor=T) if sparse_try else None
    if ell_pack is not None and loop_state is not None and loop_state.ell_kpad > 0:
        # the pack's slot width only grows: start at the saved one so the
        # master reads the same padded layout as the uninterrupted run
        kp = loop_state.ell_kpad
        ell_pack = EllPack(
            minor=T, idx=np.zeros((0, kp), np.int32), val=np.zeros((0, kp), np.float32)
        )

    def ell_synced() -> Optional[EllPack]:
        """Append any columns added since the last sync; returns the pack,
        or None when the sparse path is off."""
        nonlocal ell_pack
        if ell_pack is None:
            return None
        if len(ell_pack) > len(cols):  # pragma: no cover - defensive
            ell_pack = EllPack(minor=T)
        if len(ell_pack) < len(cols):
            with log.timer("sparse_pack"):
                new = np.stack(cols[len(ell_pack):]).astype(np.float64) / m[None, :]
                ell_pack.append(new)
        return ell_pack

    def top_mass(p: np.ndarray, cap: int = 2048, frac: float = 1.0 - 1e-10):
        """Indices of the smallest column set carrying ``frac`` of the mass."""
        order = np.argsort(-p)
        cum = np.cumsum(p[order])
        cut = int(np.searchsorted(cum, frac * cum[-1])) + 1
        return order[: min(max(cut, 1), cap)]

    if not cols:
        return np.zeros((0, T), np.int32), np.zeros(0), float("inf"), 0

    def polish_support(
        p_now: Optional[np.ndarray],
        bar: Optional[float] = None,
        master_warm: Optional[tuple] = None,
    ):
        """End-game solve on the mass-bearing support: a deep device PDHG
        (warm-started from the master's iterate restricted to the support
        and its row duals) accepted when its float64 residual reaches the
        bar; the host IPM otherwise.

        With the batched LP engine on, nested mass-ranked support prefixes
        (¼, ½ and all of the support) are screened first as lanes of one
        two-sided solve, each judged by its own float64 residual: a smaller
        face that already realizes ``v`` converges in a fraction of the deep
        solve's iterations. On a miss the deep polish runs as before."""
        nonlocal lp_solves
        if p_now is not None and len(p_now) == len(cols):
            sup = top_mass(p_now, cap=2048)
        else:
            sup = np.arange(len(cols))[:4096]
        C_sup = np.stack([cols[i] for i in sup]).astype(np.int32)
        MTs = np.ascontiguousarray((C_sup.astype(np.float64) / m[None, :]).T)
        the_bar = bar if bar is not None else stalled_band
        ell_sup = None
        if sparse_try:
            if (
                ell_pack is not None
                and p_now is not None
                and len(p_now) == len(cols)
                and len(ell_pack) == len(cols)
            ):
                cand_pack = ell_pack.take(sup)
            else:
                with log.timer("sparse_pack"):
                    cand_pack = EllPack.from_rows(MTs.T, minor=T)
            if sparse_enabled(cfg, cand_pack.fill):
                ell_sup = cand_pack
        if accel and batch_screen and len(sup) > _POLISH_SCREEN_MIN_SUP:
            from citizensassemblies_tpu_torch.solvers.batch_lp import (
                solve_lp_batch,
                solve_polish_screen_ell,
                two_sided_master_batch_lp,
            )

            caps = sorted({max(len(sup) // 4, 1), max(len(sup) // 2, 1), len(sup)})
            warm_ok = (
                cfg.decomp_warm_start
                and master_warm is not None
                and p_now is not None
                and len(p_now) == len(cols)
            )

            def prefix_warm(c_):
                x0 = np.concatenate([p_now[sup[:c_]], [max(float(master_warm[0][-1]), 0.0)]])
                return (x0, master_warm[1], master_warm[2])

            with log.timer("decomp_polish_screen"):
                if ell_sup is not None:
                    # one shared pack feeds every prefix lane; the lanes
                    # differ only in their column masks
                    sols = solve_polish_screen_ell(
                        ell_sup, v, caps, [prefix_warm(c_) if warm_ok else None for c_ in caps],
                        tol=0.25 * master_tol, max_iters=24_576, cfg=cfg, log=log, device=dev,
                    )
                else:
                    insts = []
                    for c_ in caps:
                        inst = two_sided_master_batch_lp(MTs[:, :c_], v, tol=0.25 * master_tol)
                        if warm_ok:
                            inst.warm = prefix_warm(c_)
                        insts.append(inst)
                    sols = solve_lp_batch(
                        insts, cfg=cfg, log=log, warm_key="decomp_polish_screen",
                        max_iters=24_576, common_bucket=True, device=dev,
                    )
            log.count("decomp_host_syncs")
            log.count("decomp_polish_syncs")  # end-game, not steady-state
            lp_solves += 1
            best_s = None
            for c_, sol in zip(caps, sols):
                p_s = np.maximum(sol.x[:c_], 0.0)
                tot = p_s.sum()
                if not np.isfinite(tot) or tot <= 0:
                    continue
                p_s = p_s / tot
                eps_s = float(np.abs(MTs[:, :c_] @ p_s - v).max())
                if best_s is None or eps_s < best_s[2]:
                    best_s = (c_, p_s, eps_s)
            if best_s is not None and best_s[2] <= the_bar:
                c_, p_s, eps_s = best_s
                log.count("lp_batch_polish_hit")
                return C_sup[:c_], p_s, eps_s
            log.count("lp_batch_polish_miss")
        if accel:
            from citizensassemblies_tpu_torch.solvers.lp_pdhg import (
                solve_two_sided_master,
                solve_two_sided_master_ell,
            )

            warm_s = None
            if (
                cfg.decomp_warm_start
                and master_warm is not None
                and p_now is not None
                and len(p_now) == len(cols)
            ):
                # x: the master iterate's mass on the support columns, ε from
                # the master's own ε; λ/μ transfer verbatim (same T rows)
                x0 = np.concatenate([p_now[sup], [max(float(master_warm[0][-1]), 0.0)]])
                warm_s = (x0, master_warm[1], master_warm[2])
                log.count("decomp_polish_warm")
            kw = dict(cfg=cfg, warm=warm_s, tol=0.25 * master_tol, max_iters=98_304,
                      device=dev, log=log)
            if ell_sup is not None:
                sol = solve_two_sided_master_ell(ell_sup, v, **kw)
            else:
                sol = solve_two_sided_master(MTs, v, **kw)
            lp_solves += 1
            log.count("decomp_host_syncs")  # deep device polish round trip
            log.count("decomp_polish_syncs")  # end-game, not steady-state
            p_s = np.maximum(sol.x[: MTs.shape[1]], 0.0)
            tot = p_s.sum()
            if np.isfinite(tot) and tot > 0:
                p_s = p_s / tot
                eps_s = float(np.abs(MTs @ p_s - v).max())
                if eps_s <= the_bar:
                    return C_sup, p_s, eps_s
        eps_s, _w, _mu, p_s = _decomp_lp(MTs, v)
        lp_solves += 1
        return C_sup, p_s, float(eps_s)

    lp_solves = 0
    eps = np.inf
    p = np.zeros(0)
    rng = np.random.default_rng(0)
    eps_hist: List[float] = []
    pdhg_warm = None
    if loop_state is not None:
        pdhg_warm = loop_state.warm
    elif resume is not None and len(resume.probabilities) <= len(cols):
        # the first master starts from the checkpointed mixture (its columns
        # came first, so it maps positionally), the ε slot at the certified
        # residual of the save
        x_w = np.zeros(len(cols) + 1)
        x_w[: len(resume.probabilities)] = resume.probabilities
        x_w[-1] = max(float(resume.eps), 0.0)
        pdhg_warm = (x_w, np.zeros(2 * T), np.zeros(1))
    best: Optional[Tuple[np.ndarray, np.ndarray, float]] = None
    t_start = time.time()
    # the stalled-acceptance band the caller still accepts outright
    stalled_band = max(accept, cfg.decomp_accept_stalled)
    # f32 KKT tolerance of the approximate master: two orders below the
    # acceptance bar
    master_tol = max(0.02 * accept, cfg.pdhg_tol)
    # cooldown after a failed polish: without it a near-accept optimum would
    # trigger a polish every remaining round
    polish_after = 0
    # device-pricing mode: the anchor worker is the card (one dispatch prices
    # the whole batch, the host MILP runs only for the tasks it misses), and
    # the move screen chains onto the master's device duals (_FusedScreen),
    # so a steady round synchronises with the device once
    dev_pricer = None
    if accel:
        from citizensassemblies_tpu_torch.solvers.device_pricing import (
            DevicePricer,
            device_pricing_enabled,
        )

        if device_pricing_enabled(cfg, dev):
            dev_pricer = DevicePricer(reduction, cfg=cfg, log=log, device=dev)
    pricer = _AnchorPricer(
        oracle, rng, reduction, overlap=bool(cfg.decomp_oracle_overlap), log=log,
        device=dev_pricer, cfg=cfg,
    )
    warm_enabled = bool(cfg.decomp_warm_start)
    warm_stall = _WarmStall(int(cfg.decomp_warm_stall_rounds))
    batched_expand = bool(cfg.decomp_batched_expand) and accel
    fused_screen = (
        _FusedScreen(reduction, per_round_cap=16_384, cfg=cfg, device=dev)
        if dev_pricer is not None and batched_expand
        else None
    )
    if fused_screen is not None and not fused_screen.ok:  # pragma: no cover
        fused_screen = None
    # the batched polish-face screen of the end-game (solvers/batch_lp)
    from citizensassemblies_tpu_torch.solvers.batch_lp import clear_warm_slots, lp_batch_enabled

    batch_screen = accel and lp_batch_enabled(cfg, dev)
    if batch_screen:
        # the screen's warm slots are per-run state: a previous profile's
        # iterate must not leak into this one
        clear_warm_slots("decomp_polish_screen")

    # the anchor batch submitted last and not yet harvested (a snapshot
    # replays it)
    submitted: Optional[FaceSubmit] = None
    start_round = 0
    if loop_state is not None:
        # restore the loop where the snapshot left it: the next master, the
        # running best and history, the pricing stream (its in-flight batch
        # submitted again from the generator state that drew it) and the
        # polish screen's warm slots
        start_round = loop_state.next_round
        p, eps = loop_state.p, float(loop_state.eps)
        eps_hist = [float(e) for e in loop_state.eps_hist]
        best = (np.asarray(resume.compositions, dtype=np.int16), resume.probabilities,
                float(resume.eps))
        lp_solves = int(loop_state.lp_solves)
        polish_after = int(loop_state.polish_after)
        warm_stall.best, warm_stall.streak = float(loop_state.stall[0]), int(loop_state.stall[1])
        t_start = time.time() - float(loop_state.elapsed)
        if loop_state.device_degraded:
            pricer.device = None
        if loop_state.pending is not None:
            q = loop_state.pending
            rng.bit_generator.state = q.rng_state
            pricer.submit(q.rnd, q.r_norm, q.eps, q.realized, v)
            submitted = q
        rng.bit_generator.state = loop_state.rng_state
        if batch_screen:
            from citizensassemblies_tpu_torch.solvers.batch_lp import restore_warm_slots

            restore_warm_slots("decomp_polish_screen", loop_state.slots)

    def snapshot(rnd: int) -> None:
        """Save the best certified state after round ``rnd − 1`` with the
        loop state of round ``rnd``'s top."""
        if best is None or len(best[1]) != len(best[0]) or not ckpt.due(rnd - 1):
            return
        from citizensassemblies_tpu_torch.solvers.batch_lp import warm_slots

        loop = FaceLoopState(
            next_round=rnd, cols=np.stack(cols), p=np.asarray(p, dtype=np.float64),
            eps=float(eps), eps_hist=np.asarray(eps_hist, dtype=np.float64), warm=pdhg_warm,
            stall=(warm_stall.best, warm_stall.streak), polish_after=polish_after,
            lp_solves=lp_solves, rng_state=rng.bit_generator.state, pending=submitted,
            device_degraded=dev_pricer is not None and pricer.device is None,
            ell_kpad=ell_pack.k_pad if ell_pack is not None else -1,
            slots=warm_slots("decomp_polish_screen") if batch_screen else {},
            elapsed=time.time() - t_start,
        )
        ckpt.maybe_save(rnd - 1, best[0], best[1], best[2], log=log, loop=loop)

    def rank_add(cand: List[np.ndarray], r_norm: np.ndarray) -> int:
        """Grow the master where it helps: most negative <r, c/m> first."""
        if not cand:
            return 0
        added = 0
        with log.timer("decomp_expand"):
            batch = np.concatenate([np.atleast_2d(c) for c in cand], axis=0)
            vals = batch.astype(np.float64) @ r_norm
            order = np.argsort(vals)
            cap = max(256, master_cap - len(cols))
            for i in order[:cap]:
                added += add(batch[i])
        return added

    scope = ExitStack()
    scope.enter_context(use_context(ctx))
    try:
        for rnd in range(start_round, max_rounds):
            t_round = time.time()
            if rnd > 0:
                snapshot(rnd)
            # the request's deadline: a host clock read at the round's top
            if deadline is not None:
                deadline.check(
                    "face_decompose round", log=log,
                    partial={
                        "decomp_rounds": rnd,
                        "best_eps": float(best[2]) if best is not None else None,
                    },
                )
            # the kill switch the checkpoint/resume contract is tested with
            inject.raise_if("face_abort", log)
            # stall detection on the running best: the best of the last 4
            # rounds failed to beat the best of all earlier rounds by ≥ 2 %
            if len(eps_hist) >= 7 and min(eps_hist[-4:]) > min(eps_hist[:-4]) * 0.98:
                log.emit(f"  face rounds stalling at eps={eps_hist[-1]:.2e}; stopping early.")
                break
            log.count("decomp_rounds")
            C = np.stack(cols, axis=0)
            MT = np.ascontiguousarray((C.astype(np.float64) / m[None, :]).T)
            # per-round master selection: small problems solve exactly on the
            # host faster than one device round trip
            use_pdhg = accel and (
                T > cfg.decomp_host_master_max_types
                or len(cols) > cfg.decomp_host_master_max_cols
            )
            polish_warm = None
            # beyond one card's row set: the master's 2T rows sharded over
            # the world's mesh (no warm start: the sharded regime trades it
            # for scale-out)
            mesh = (
                effective_mesh(cfg, log)
                if use_pdhg and T >= cfg.master_shard_min_types
                else None
            )
            if mesh is not None:
                from citizensassemblies_tpu_torch.parallel.solver import (
                    solve_decomp_master_sharded,
                )

                with log.timer("decomp_master"):
                    eps, w, p, eps_obj, _ok = solve_decomp_master_sharded(
                        MT, v, mesh, cfg=cfg, tol=master_tol
                    )
                pdhg_warm = None
                lp_solves += 1
                log.count("decomp_master_sharded")
                # one upload and one harvest per sharded master
                log.count("decomp_host_syncs")
            elif use_pdhg:
                # adaptive budget: far from acceptance the duals only need to
                # be roughly right to aim the expansion
                far = not eps_hist or eps_hist[-1] > 6 * accept
                warm_arg = pdhg_warm if warm_enabled else None
                log.count("decomp_master_warm" if warm_arg is not None else "decomp_master_cold")
                # sparse routing: sync the incremental pack, gate on its fill
                ell_now = ell_synced()
                use_sparse = False
                if ell_now is not None:
                    use_sparse = sparse_enabled(cfg, ell_now.fill)
                    log.gauge("sparse_fill_pct", int(round(100 * ell_now.fill)))
                    log.count("sparse_hit" if use_sparse else "sparse_miss")
                screen_cb = None
                if fused_screen is not None:
                    # the screened block is this master's own columns in
                    # mass-ranked order (the previous prune's support
                    # first), known before the master returns
                    comps_block = C[:_SCREEN_ROWS]

                    def screen_cb(lam_dev, _blk=comps_block):
                        with log.timer("decomp_expand"):
                            fused_screen.dispatch(_blk, lam_dev)

                with log.timer("decomp_master"):
                    eps, w, p, eps_obj, pdhg_warm, _ok = _master_pdhg(
                        MT, v, cfg, warm_arg,
                        max_iters=4_096 if far else 12_288, tol=master_tol,
                        ell=ell_now if use_sparse else None, device=dev, log=log,
                        screen=screen_cb,
                    )
                lp_solves += 1
                # the master's readback; in device-pricing mode the fused
                # screen and the lagged anchor batch ride on it
                log.count("decomp_host_syncs")
                if not np.isfinite(eps):
                    # quarantined master (the sentinel froze the lane, or its
                    # mixture went non-finite): re-solve this round on the
                    # float64 host path and cold-start the next master
                    log.count("sentinel_quarantined")
                    log.count("robust_host_resolve")
                    with log.timer("decomp_master"):
                        eps, w, _mu_h, p = _decomp_lp(MT, v)
                    eps_obj = float(eps)
                    pdhg_warm = None
                    lp_solves += 1
                polish_warm = pdhg_warm
                if not warm_enabled:
                    pdhg_warm = None
                elif warm_stall.update(eps, warm_arg is not None):
                    pdhg_warm = None
                    log.count("decomp_warm_cold_restart")
                    log.emit(
                        f"  warm-started master stalling at eps={eps:.2e}; "
                        "cold-restarting the iterate."
                    )
                # end-game: the objective says the support should realize v
                # but the first-order iterate lags — polish once on the
                # support (wider trigger deep into the time budget)
                deep = time.time() - t_start > 0.6 * cfg.decomp_time_budget_s
                near = (
                    eps <= accept * 1.25
                    or eps_obj <= accept * 1.05
                    or (deep and eps_obj <= 1.2 * accept)
                )
                if eps > accept and near and rnd >= polish_after:
                    with log.timer("decomp_polish"):
                        C_sup, p_sup, eps_sup = polish_support(
                            p, bar=(stalled_band if deep else accept), master_warm=polish_warm,
                        )
                    log.emit(
                        f"  polish: {len(C_sup)} support cols -> eps={eps_sup:.2e} "
                        f"(iterate eps={eps:.2e}, obj~{eps_obj:.2e})."
                    )
                    if eps_sup <= (stalled_band if deep else accept):
                        log.emit(
                            f"Face decomposition: eps = {eps_sup:.2e} certified on "
                            f"{len(C_sup)} support columns ({lp_solves} master solves, "
                            f"end-game polish)."
                        )
                        ckpt.clear()  # certified: no stale resume point
                        return C_sup, p_sup, eps_sup, lp_solves
                    # a failed polish value is the optimum of a support
                    # subset: keep it out of eps/eps_hist/best
                    polish_after = rnd + 2
            else:
                with log.timer("decomp_master"):
                    eps, w, _mu, p = _decomp_lp(MT, v)
                lp_solves += 1
            eps_hist.append(eps)
            if best is None or eps < best[2]:
                best = (C, p, eps)
            if (
                time.time() - t_start > cfg.decomp_time_budget_s
                and best[2] <= stalled_band
                and eps > accept
            ):
                # budget exhausted with a residual the caller accepts anyway
                log.emit(
                    f"  face rounds over time budget ({cfg.decomp_time_budget_s:.0f}s) "
                    f"with best eps={best[2]:.2e} inside the stalled band; stopping."
                )
                break
            if eps <= accept:
                log.emit(
                    f"Face decomposition: eps = {eps:.2e} certified on {len(cols)} "
                    f"columns ({lp_solves} master solves)."
                )
                ckpt.clear()  # certified: no stale resume point
                return C.astype(np.int32), p, float(eps), lp_solves
            # the duals w (= y_lo − y_up) mark over-served (w < 0) vs
            # under-served (w > 0) types; move units down the gradient
            r_norm = -w / m
            sup_idx = top_mass(p)  # mass-ordered, largest first
            # prune before expanding: the next master sees only the
            # mass-bearing support plus this round's additions
            n_before = len(cols)
            kept = [cols[i] for i in sup_idx]
            kept_p = p[sup_idx]
            cols.clear()
            seen.clear()
            for c in kept:
                add(c)
            if ell_pack is not None:
                # the prune is a pure subset/reorder; a pack out of sync
                # (host-master rounds) restarts empty
                ell_pack = ell_pack.take(sup_idx) if len(ell_pack) == n_before else EllPack(minor=T)
            # re-align the warm start with the pruned column order
            if pdhg_warm is not None:
                x_w = np.zeros(len(kept) + 1)
                x_w[: len(kept)] = kept_p
                x_w[-1] = max(eps, 0.0)
                pdhg_warm = (x_w, pdhg_warm[1], pdhg_warm[2])
            base = len(cols)
            cand: List[np.ndarray] = []
            # pipeline: harvest round r-1's anchors, submit round r's
            with log.timer("decomp_oracle"):
                cand.extend(pricer.harvest())
                realized = MT @ p if len(p) == MT.shape[1] else None
                submitted = FaceSubmit(rnd, r_norm, eps, realized, rng.bit_generator.state)
                pricer.submit(rnd, r_norm, eps, realized, v)
            if fused_screen is not None and fused_screen.pending:
                with log.timer("decomp_expand"):
                    # dispatched behind this round's master on its device
                    # duals, complete by the time the master's readback
                    # returned: decoding it costs no further synchronisation
                    moved = fused_screen.harvest()
                    if len(moved):
                        cand.append(moved)
            elif kept:
                with log.timer("decomp_expand"):
                    cand.append(
                        neighbor_columns(
                            np.stack(kept[:_SCREEN_ROWS]), reduction, r_norm,
                            batched=batched_expand, device=dev, cfg=cfg,
                        )
                    )
                if batched_expand:
                    # the screen's index readback
                    log.count("decomp_host_syncs")
            if T <= cfg.decomp_host_master_max_types and rnd == 0 and eps <= 6 * accept:
                # small-T near-miss after the first master: a deeper aimed-
                # slice pass (phase-shifted so it does not repeat the
                # injected slices) closes the hull in one host round
                from citizensassemblies_tpu_torch.solvers.cg_typespace import _slice_relaxation

                deep_slices = _slice_relaxation(v * m, reduction, R=2048, j0=1 << 20, chunks=4)
                if deep_slices:
                    cand.append(np.stack(deep_slices).astype(np.int16))
            added = rank_add(cand, r_norm)
            if added == 0:
                # this round's anchor job is still pending: wait for it
                # rather than conclude exhaustion with columns in flight
                with log.timer("decomp_oracle"):
                    late = pricer.harvest()
                submitted = None
                if dev_pricer is not None:
                    # the just-dispatched device batch had no master solve
                    # to hide behind: this harvest waits on it
                    log.count("decomp_host_syncs")
                added = rank_add(late, r_norm)
            obj_note = f" obj~{eps_obj:.2e}" if use_pdhg else ""
            log.emit(
                f"  face round {rnd + 1}: eps={eps:.2e}{obj_note} added {added} "
                f"(master {base}+{added}, {time.time() - t_round:.1f}s)."
            )
            if added == 0:
                break

        # out of rounds / stalled: one end-game solve on the best support
        if best is not None and (len(p) != len(cols) or eps > accept):
            C_best, p_best, _ = best
            cols = [c for c in C_best]
            p = p_best
            if ell_pack is not None:
                # the column set was replaced: re-pack from scratch
                ell_pack = EllPack(minor=T)
        with log.timer("decomp_polish"):
            # final polish at the tight bar
            C_sup, p_sup, eps = polish_support(
                p if len(p) == len(cols) else None, bar=accept, master_warm=pdhg_warm,
            )
        log.emit(
            f"Face decomposition: eps = {eps:.2e} on {len(C_sup)} support columns "
            f"({lp_solves} master solves)."
        )
        ckpt.clear()  # the loop ran to its end: no stale resume point
        return C_sup, p_sup, float(eps), lp_solves
    finally:
        pricer.close()
        scope.close()


# --- registered cores (lint/registry.py) ----------------------------------------
# Both screens are whole cores (no host read) at the JAX registrations'
# shapes: 512 composition rows over 32 types and 40 features, one leftover
# category.


def move_screen_core(comps_i, counts_nb, lo_nb, hi_nb, counts_full, lo_f, hi_f, m_t, ti, tj, valid,
                     need_sub, need_add, lf_ai, lf_aj, *, lf_donor, cap: int):
    """:func:`_move_screen_dispatch`'s device work: the feasibility check
    and its fixed-size nonzero."""
    ok = _screen_feasible(comps_i, counts_nb, lo_nb, hi_nb, counts_full, lo_f, hi_f, m_t, ti, tj,
                          valid, need_sub, need_add, lf_ai, lf_aj, lf_donor)
    return _first_true(ok.reshape(-1), int(cap))


def _screen_operands(r, rows: int = _SCREEN_ROWS, T: int = 32, F: int = 40):
    i64 = torch.int64
    comps = r.rng.integers(0, 3, (rows, T))
    counts = r.rng.integers(0, 6, (rows, F))
    return dict(
        comps_i=r.t(comps, i64), counts_nb=r.t(counts, i64), lo_nb=r.t(np.ones(F), i64),
        hi_nb=r.t(np.full(F, 5), i64), counts_full=r.t(counts, i64), lo_f=r.t(np.ones(F), i64),
        hi_f=r.t(np.full(F, 5), i64), m_t=r.t(r.rng.integers(1, 4, T), i64),
    )


@register_ir_core("face_decompose.move_screen", span="face_decompose.move_screen")
def _ir_move_screen(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(91, device)
    T, F, P = 32, 40, 4096
    s = _screen_operands(r, T=T, F=F)
    i64 = torch.int64
    ti, tj = r.ints(P, T, dtype=i64), r.ints(P, T, dtype=i64)
    return IRCase(
        fn=move_screen_core,
        args=tuple(s.values()) + (
            ti, tj, ti != tj, r.ints(P, 1 << 20, dtype=i64), r.ints(P, 1 << 20, dtype=i64),
            [r.ints(P, F, dtype=i64)], [r.ints(P, F, dtype=i64)],
        ),
        static=dict(lf_donor=[True], cap=P), device=str(device),
    )


@register_ir_core("face_decompose.fused_screen", span="face_decompose.fused_screen")
def _ir_fused_screen(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(92, device)
    T, F, Q = 32, 40, 1024
    s = _screen_operands(r, T=T, F=F)
    i64 = torch.int64
    return IRCase(
        fn=fused_screen_core,
        args=(r.f32(2 * T, -1.0, 1.0), r.t(r.counts(T, 3))) + tuple(s.values()) + (
            r.ints(T, 1 << 20, dtype=i64), r.ints(Q, T, dtype=i64), r.ints(Q, T, dtype=i64),
            [r.ints(T, F, dtype=i64)],
        ),
        static=dict(lf_donor=[True], cap=1024, pool_cap=8, face_pairs=64), device=str(device),
    )
