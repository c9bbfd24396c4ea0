"""Device anchor pricing for the face-decomposition loop.

The face loop's anchor oracle prices a bounded integer program over type
cells: ``max Σ_t w_t c_t`` over compositions ``c ∈ Z^T`` with ``0 ≤ c_t ≤
m_t``, ``Σ c_t = k`` and per-feature quotas ``qmin ≤ tfᵀ c ≤ qmax`` (the
type-space collapse of the committee ILP, ``cg_typespace.CompositionOracle``).
Pricing it on the host (one HiGHS MILP per anchor) keeps each round waiting
on host solver calls; here one device dispatch per round prices the whole
anchor batch (dual-direction optimum, alternate-round noisy variants,
forced-inclusion anchors), and the exact host MILP runs only for the tasks
the device misses.

Two routes, both plain torch ops on ``[B, T]`` int32 state (the JAX package
jits them; neither is a Pallas kernel):

* **β-ladder greedy lanes** (:func:`greedy_lanes`) — every anchor task fans
  out into ``_LANES`` deterministic constructive builds, lane ``l`` scoring
  types by ``β_l · ŵ + urgency`` on the log-spaced ladder of
  ``pricing.beta_ladder``. A loop over the k slots builds all lanes at once:
  per step a type is eligible iff its count is below the pool size, every
  feature it carries stays ≤ its upper quota, and — in any category whose
  remaining lower-quota deficit equals the remaining slots — it covers a
  deficit feature; the most urgent deficit cell constrains the pick. All
  state is integer, and argmax ties take the first index as in the JAX
  package, so the lanes equal the JAX core's compositions.
* **exact DP** (:func:`exact_dp`) — for single-category reductions every
  type maps 1:1 to a feature, so the program is a bounded exact knapsack:
  a DP over (type, slots used) with a backtrack, exact over the uploaded
  float32 weights.

Both return candidate compositions and device feasibility flags; the
harvest re-validates every candidate in exact host int64 arithmetic before
it may enter the master (an anchor later becomes real panels, so
feasibility is a hard contract). A dispatch only queues device work: the
weights go up through pinned memory and nothing reads back until
:meth:`DevicePricer.harvest`. Routing is the ``Config.decomp_device_pricing``
tri-state (``None``: on when the run's device is CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
from citizensassemblies_tpu_torch.solvers.pricing import beta_ladder
from citizensassemblies_tpu_torch.utils import device as _device
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device, upload
from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers
from citizensassemblies_tpu_torch.aot.store import note_eager
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.utils.logging import RunLog

_NEG = -1e30

#: β-ladder lanes per anchor task: urgency-dominated (β = 0.1) through
#: weight-greedy (β ≈ 300)
_LANES = 6

#: urgency weight added per deficit feature a type covers, against per-lane
#: weights normalized to max |ŵ| = 1 then scaled by β
_URGENCY = 2.0


def device_pricing_enabled(cfg: Optional[Config], device) -> bool:
    """Resolve ``Config.decomp_device_pricing``: ``True``/``False`` force;
    ``None`` engages the device pricer when ``device`` takes the accelerator
    routes (``utils.device.on_accelerator``)."""
    knob = getattr(cfg, "decomp_device_pricing", None)
    if knob is not None:
        return bool(knob)
    return _device.on_accelerator(device)


def greedy_lanes(feat_of, cat_of, msize, qmin, qmax, weights, forced, k: int, ncat: int):
    """The β-ladder greedy core over ``B`` lanes: ``feat_of [T, ncat]``,
    ``cat_of [F]``, ``msize [T]``, ``qmin``/``qmax [F]`` (int64 index
    tensors / int32 counts), ``weights [B, T]`` float32, ``forced [B]``
    (−1: none). Returns ``(comps [B, T] int32, ok [B] bool)`` on the
    weights' device; ``k`` steps of torch ops, no host synchronisation."""
    B, T = weights.shape
    F = qmin.shape[0]
    dev = weights.device
    i32 = dict(dtype=torch.int32, device=dev)
    ar_T = torch.arange(T, device=dev)
    in_pool = msize > 0
    seed = (ar_T[None, :] == forced[:, None].long()) & in_pool[None, :]
    seed_any = seed.any(dim=1)
    c = seed.to(torch.int32)
    s = torch.zeros((B, F), **i32)
    seed_feat = feat_of[torch.clamp_min(forced.long(), 0)]  # [B, ncat]
    s.scatter_add_(1, seed_feat, seed_any.to(torch.int32)[:, None].expand(B, ncat).contiguous())
    used = seed_any.to(torch.int32)
    # a forced type outside the pool can never be priced here: fail the lane
    # so the task routes to the host MILP
    failed = (forced >= 0) & ~seed_any
    feat_cols = [feat_of[:, ci] for ci in range(ncat)]
    qmax_t = qmax[feat_of]  # [T, ncat]
    for _ in range(int(k)):
        rem = int(k) - used
        deficit = torch.clamp_min(qmin[None, :] - s, 0)  # [B, F]
        cat_def = torch.zeros((B, ncat), **i32).index_add_(1, cat_of, deficit)
        # more lower-quota deficit in one category than slots remain: the
        # lane cannot recover
        failed = failed | ((rem > 0) & (cat_def.amax(dim=1) > rem))
        tight = cat_def >= rem[:, None]
        d_t = deficit[:, feat_of]  # [B, T, ncat]
        up_ok = torch.all(s[:, feat_of] + 1 <= qmax_t[None], dim=2)
        tight_ok = torch.all(~tight[:, None, :] | (d_t > 0), dim=2)
        eligible = (c < msize[None, :]) & up_ok & tight_ok
        # urgent cell: deficit / remaining supply over ELIGIBLE types, the
        # supply counted exactly in integers
        avail = (msize[None, :] - c) * eligible.to(torch.int32)
        supply = torch.zeros((B, F), **i32)
        for col in feat_cols:
            supply.index_add_(1, col, avail)
        starved = (deficit > 0) & (supply < deficit)
        failed = failed | ((rem > 0) & starved.any(dim=1))
        urgent = deficit > 0
        ratio = torch.where(
            urgent, deficit.float() / torch.clamp_min(supply.float(), 1.0),
            torch.full((), _NEG, dtype=torch.float32, device=dev),
        )
        cell = torch.argmax(ratio, dim=1)  # first index on ties
        in_cell = torch.any(feat_of[None] == cell[:, None, None], dim=2)
        pick_ok = eligible & torch.where(urgent.any(dim=1)[:, None], in_cell, True)
        need = (d_t > 0).sum(dim=2).float()
        score = weights + _URGENCY * need
        pick = torch.argmax(
            torch.where(pick_ok, score, torch.full((), _NEG, dtype=torch.float32, device=dev)), dim=1
        )
        any_ok = pick_ok.any(dim=1)
        active = (rem > 0) & ~failed
        failed = failed | (active & ~any_ok)
        inc = (active & any_ok).to(torch.int32)
        c.scatter_add_(1, pick[:, None], inc[:, None])
        s.scatter_add_(1, feat_of[pick], inc[:, None].expand(B, ncat).contiguous())
        used = used + inc
    ok = (
        ~failed & (used == int(k))
        & torch.all(s >= qmin[None, :], dim=1) & torch.all(s <= qmax[None, :], dim=1)
    )
    return c, ok


def exact_dp(feat1, msize, qmin, qmax, weights, forced, k: int):
    """The exact DP over (type, slots used) for single-category reductions,
    batched over ``B`` lanes: per type ``c_t ∈ [max(qmin_f, 0), min(m_t,
    qmax_f)]`` (at least 1 for the forced type), the value table updated by
    ``val'[s] = max_c val[s−c] + w_t·c`` with the argmax choices kept for
    the backtrack. Returns ``(comps [B, T] int32, ok [B] bool)``."""
    B, T = weights.shape
    dev = weights.device
    K1 = int(k) + 1
    lo_t = torch.clamp_min(qmin[feat1], 0).to(torch.int32)
    hi_t = torch.minimum(msize, qmax[feat1]).to(torch.int32)
    cand = torch.arange(K1, dtype=torch.int32, device=dev)
    lo = torch.where(
        torch.arange(T, device=dev)[None, :] == forced[:, None].long(),
        torch.clamp_min(lo_t, 1)[None, :], lo_t[None, :],
    )  # [B, T]
    s_idx = cand[:, None]
    c_idx = cand[None, :]
    gather_at = torch.clamp_min(s_idx - c_idx, 0).long().reshape(-1)  # [K1*K1]
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    val = torch.where(cand == 0, 0.0, neg)[None, :].expand(B, K1).contiguous()
    choices = []
    for t in range(T):
        w_t = weights[:, t][:, None, None]
        feas = (
            (c_idx[None] >= lo[:, t][:, None, None]) & (c_idx[None] <= hi_t[t])
            & (c_idx <= s_idx)[None]
        )
        prev = val[:, gather_at].reshape(B, K1, K1)
        tot = torch.where(feas, prev + w_t * c_idx[None].float(), neg)
        val = tot.amax(dim=2)
        choices.append(torch.argmax(tot, dim=2))
    s = torch.full((B,), int(k), dtype=torch.int64, device=dev)
    comp = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in reversed(range(T)):
        c_t = choices[t].gather(1, s[:, None])[:, 0]
        comp[:, t] = c_t.to(torch.int32)
        s = s - c_t
    return comp, val[:, int(k)] > _NEG * 0.5


@dataclasses.dataclass
class PricingHandle:
    """An in-flight device pricing dispatch: device tensors plus the task
    list needed to decode them at harvest. ``lanes`` is the per-task fan-out
    (1 on the exact DP route)."""

    comps: torch.Tensor  # [B, T] int32
    ok: torch.Tensor  # [B] bool
    tasks: List[Tuple[np.ndarray, Optional[int]]]
    lanes: int
    exact: bool


class DevicePricer:
    """Host wrapper: device-resident static operands, dispatch and harvest.

    The quota structure uploads once at construction and stays on the
    device; a dispatch ships only the round's ``[B, T]`` lane weights and
    the forced-type vector and returns at once, so the pricing runs behind
    the next master in stream order. ``harvest`` is where results cross
    back: every candidate is re-validated in exact host integer arithmetic,
    the best feasible lane per task becomes that task's anchor, and tasks
    with no surviving lane are reported as misses for the caller's
    host-MILP fallback.
    """

    def __init__(
        self,
        reduction: TypeReduction,
        cfg: Optional[Config] = None,
        log: Optional[RunLog] = None,
        lanes: int = _LANES,
        device: DeviceLike = None,
    ):
        self.red = reduction
        self.cfg = cfg
        self.log = log
        self.lanes = int(lanes)
        self.device = resolve_device(device)
        self.exact = reduction.n_cats == 1
        feat_of = np.asarray(reduction.type_feature, dtype=np.int64)
        # feature → category map (features are one-hot per category, so each
        # feature index appears in exactly one column of type_feature)
        cat_of = np.zeros(reduction.F, dtype=np.int64)
        for ci in range(reduction.n_cats):
            cat_of[np.unique(feat_of[:, ci])] = ci
        dev = self.device
        self._feat_of = torch.as_tensor(feat_of, device=dev)
        self._cat_of = torch.as_tensor(cat_of, device=dev)
        self._msize = torch.as_tensor(reduction.msize.astype(np.int32), device=dev)
        self._qmin = torch.as_tensor(reduction.qmin.astype(np.int32), device=dev)
        self._qmax = torch.as_tensor(reduction.qmax.astype(np.int32), device=dev)
        # host-side exact validation operands (int64 — no float tolerance)
        self._tf = np.zeros((reduction.T, reduction.F), dtype=np.int64)
        if reduction.n_cats:
            self._tf[
                np.repeat(np.arange(reduction.T), reduction.n_cats),
                feat_of.ravel(),
            ] = 1

    def dispatch(
        self, tasks: Sequence[Tuple[np.ndarray, Optional[int]]]
    ) -> Optional[PricingHandle]:
        """Price the whole anchor batch in one device dispatch (async).

        ``tasks`` are ``(weights float64[T], forced_type or None)`` exactly
        as the host oracle takes them. Weights are normalized per task
        (argmax-invariant; values are recomputed in float64 at harvest) and
        fanned out over the β ladder on the greedy route; the exact DP route
        prices each task once.
        """
        if not tasks:
            return None
        W = np.stack([np.asarray(w, dtype=np.float64) for w, _f in tasks])
        W = W / (np.abs(W).max(axis=1, keepdims=True) + 1e-12)
        forced_np = np.array(
            [(-1 if f is None else int(f)) for _w, f in tasks], dtype=np.int32
        )
        if self.exact:
            lanes = 1
            lane_w = W.astype(np.float32)
            lane_f = forced_np
        else:
            lanes = self.lanes
            betas = beta_ladder(lanes)  # the pricing.py steering ladder
            lane_w = (betas[None, :, None] * W[:, None, :]).reshape(
                len(tasks) * lanes, -1
            ).astype(np.float32)
            lane_f = np.repeat(forced_np, lanes)
        w_dev = upload(lane_w, self.device)
        f_dev = upload(lane_f, self.device)
        k = int(self.red.k)
        # an eager family: recorded for the graph store, no one-time work
        note_eager("device_pricing.dp" if self.exact else "device_pricing.greedy",
                   (w_dev, f_dev), {"k": k})
        with dispatch_span(
            "device_pricing.exact_dp" if self.exact else "device_pricing.greedy_lanes",
            cfg=self.cfg, log=self.log, lanes=int(lane_w.shape[0]), types=int(lane_w.shape[1]),
        ) as ds:
            with no_implicit_transfers(self.cfg), guarded_launch(self.device):
                if self.exact:
                    comps, ok = exact_dp(
                        self._feat_of[:, 0], self._msize, self._qmin, self._qmax, w_dev, f_dev, k
                    )
                else:
                    comps, ok = greedy_lanes(
                        self._feat_of, self._cat_of, self._msize, self._qmin, self._qmax,
                        w_dev, f_dev, k, int(self.red.n_cats),
                    )
            ds.out = (comps, ok)
        if self.log is not None:
            self.log.count("device_pricing_dispatches")
        return PricingHandle(comps=comps, ok=ok, tasks=list(tasks), lanes=lanes, exact=self.exact)

    def _validate(self, comps: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Exact host integer re-validation of every candidate lane: the
        device flag is integer math and should agree, but an anchor becomes
        a portfolio column the panel decomposition later realizes as actual
        panels — feasibility is a hard contract, so it is re-proven in int64
        on host before a column may enter the master."""
        red = self.red
        counts = comps.astype(np.int64) @ self._tf
        feas = np.asarray(ok, dtype=bool).copy()
        feas &= comps.sum(axis=1) == red.k
        feas &= (comps >= 0).all(axis=1)
        feas &= (comps <= red.msize[None, :]).all(axis=1)
        feas &= (counts >= red.qmin[None, :]).all(axis=1)
        feas &= (counts <= red.qmax[None, :]).all(axis=1)
        return feas

    def harvest(
        self, handle: PricingHandle
    ) -> Tuple[List[Tuple[int, np.ndarray]], List[int]]:
        """Read the dispatch back and decode per task.

        Returns ``(hits, missed)``: ``hits`` as ``(task_index, composition
        int16 [1, T])`` pairs — the best surviving lane per task by exact
        float64 value — and ``missed`` as the task indices with no surviving
        lane (the caller's host-MILP fallback set). In the steady-state
        round the device work completed while the master solved, so this
        readback does not block on in-flight compute.
        """
        comps = handle.comps.cpu().numpy()
        ok = handle.ok.cpu().numpy()
        feas = self._validate(comps, ok)
        if self.log is not None and int((np.asarray(ok) & ~feas).sum()):
            # device said feasible, exact host arithmetic disagreed — should
            # never happen (integer state both sides); surfaced, not hidden
            self.log.count(
                "decomp_oracle_device_invalid",
                int((np.asarray(ok) & ~feas).sum()),
            )
        hits: List[Tuple[int, np.ndarray]] = []
        missed: List[int] = []
        L = handle.lanes
        for i, (w, f) in enumerate(handle.tasks):
            sl = slice(i * L, (i + 1) * L)
            lane_feas = feas[sl]
            if f is not None:
                lane_feas = lane_feas & (comps[sl, int(f)] >= 1)
            if not lane_feas.any():
                missed.append(i)
                continue
            vals = comps[sl].astype(np.float64) @ np.asarray(w, np.float64)
            vals = np.where(lane_feas, vals, -np.inf)
            best = int(np.argmax(vals))
            hits.append((i, comps[sl][best][None, :].astype(np.int16)))
        return hits, missed


# --- registered cores (lint/registry.py) ----------------------------------------
# Both pricers are whole cores (no host read). Shapes are the JAX
# registrations'.


@register_ir_core("device_pricing.greedy_lanes", span="device_pricing.greedy_lanes")
def _ir_greedy_lanes(device="cpu") -> IRCase:
    """The β-ladder greedy pricer at 8 lanes, 32 types, 12 features over 3
    categories, k = 8 slots."""
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(71, device)
    B, T, ncat, per = 8, 32, 3, 4
    feat_of = np.stack([ci * per + r.rng.integers(0, per, T) for ci in range(ncat)], axis=1)
    F = ncat * per
    return IRCase(
        fn=greedy_lanes,
        args=(r.t(feat_of, torch.int64), r.t(np.arange(F) // per, torch.int64),
              r.ints(T, 4, lo=1), r.t(np.ones(F), torch.int32), r.t(np.full(F, 4), torch.int32),
              r.f32((B, T), -1.0, 1.0), r.t(np.r_[-1, r.rng.integers(0, T, B - 1)], torch.int64)),
        static=dict(k=8, ncat=ncat), device=str(device),
    )


@register_ir_core("device_pricing.exact_dp", span="device_pricing.exact_dp")
def _ir_exact_dp(device="cpu") -> IRCase:
    """The exact single-category DP at 4 lanes, 16 types, k = 8: the value
    table over (type, slots used) and the backtrack."""
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(72, device)
    B, T = 4, 16
    return IRCase(
        fn=exact_dp,
        args=(r.t(np.arange(T), torch.int64), r.ints(T, 4, lo=1), r.t(np.zeros(T), torch.int32),
              r.t(np.full(T, 3), torch.int32), r.f32((B, T), -1.0, 1.0),
              r.t(np.r_[-1, r.rng.integers(0, T, B - 1)], torch.int64)),
        static=dict(k=8), device=str(device),
    )
