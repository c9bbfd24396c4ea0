"""Incremental re-certification under registry churn.

A registry changes: volunteers join and drop, quotas get amended. A
from-scratch solve repeats the O(n) type reduction, the full composition
enumeration and the whole LEXIMIN stage ladder on every edit; the previous
certified portfolio makes most of that redundant. This module re-certifies
in ~O(edit), as the JAX package's ``solvers/delta.py`` does:

1. **Edit projection.** :class:`TypeSystem` mirrors the type reduction at
   the registry level (type rows, pool sizes, quota bands), and
   :meth:`TypeSystem.update` maps a :class:`~citizensassemblies_tpu_torch.
   data.registry.RegistryEdit` onto it in O(edit).
2. **Dual screening on the device.** One batch of torch ops on the run's
   device (:func:`screen_columns`) re-prices the surviving column hull
   against the edited instance: integer feasibility per column (Σc = k,
   per-type caps, quota bands) and the per-stage dual price gap
   ``μ_s − Σ_t y_t c_t/m_t``, in float32, with one readback. Feasibility
   is re-proven on the host in int64 and near-margin gaps are re-derived
   in float64 before any certificate reads them. The ELL pack is kept
   incrementally (``EllPack.append`` / ``take``).
3. **Sensitivity cache certificate.** When the old support survives, every
   newly admitted column prices strictly below every stage's support price
   by ``Config.delta_cert_margin`` and the pool-size drift bound stays
   inside the margin, the old mixture is still within the 1e-3 L∞ contract:
   a cache hit, with no LP solve.
4. **Warm resume.** When only deeper stages are invalidated, the ladder
   resumes from the stored ``fixed_after`` vector of the last valid stage
   (``leximin_over_compositions(fixed_init=…)``); otherwise it re-runs in
   full over the screened hull plus the incrementally enumerated region.

The float64 host certificates (:class:`~citizensassemblies_tpu_torch.
solvers.compositions.StageCert`) stay float64; only the screen runs in
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.data.registry import Registry, RegistryEdit
from citizensassemblies_tpu_torch.aot.store import note_eager
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.solvers.compositions import (
    StageCert,
    leximin_over_compositions,
)
from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device, upload
from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers
from citizensassemblies_tpu_torch.utils.logging import RunLog
from citizensassemblies_tpu_torch.utils.precision import iterate_dtype

#: the framework's hard L∞ exactness contract (``models/leximin.py``)
CONTRACT_LINF = 1e-3

#: support cutoff: a column below this mass is not part of the certificate
_SUPPORT_EPS = 1e-9

#: host float64 re-pricing window, in margins: device f32 gaps inside it are
#: re-derived exactly before any certificate decision reads them
_FLAG_WINDOW = 64.0


# --- the registry-level type system ------------------------------------------


@dataclasses.dataclass
class TypeSystem:
    """The type reduction carried at the *registry* level so edits update it
    in O(edit) — the piece a from-scratch solve rebuilds with an O(n) pass.

    ``rows`` stores each type's per-category feature SLOTS (the registry's
    ``assignments`` row), not global feature ids: a ``new_type`` edit appends
    a slot at the end of its category, so existing keys never shift. Types
    are append-only — a type whose pool empties keeps its index with
    ``msize = 0`` (the screen kills every column using it), so stored
    columns, duals and packs never need re-indexing.
    """

    k: int
    features: Tuple[Tuple[str, ...], ...]  # per-category feature names
    rows: np.ndarray  # int32 [T, C] per-category feature slots
    msize: np.ndarray  # int64 [T] pool size per type
    lo: np.ndarray  # int64 [F] flat quota lower bounds
    hi: np.ndarray  # int64 [F] flat quota upper bounds

    def __post_init__(self):
        self._index: Dict[Tuple[int, ...], int] = {
            tuple(int(v) for v in row): t for t, row in enumerate(self.rows)
        }

    @property
    def T(self) -> int:
        return self.rows.shape[0]

    @property
    def n_cats(self) -> int:
        return self.rows.shape[1]

    @property
    def F(self) -> int:
        return len(self.lo)

    @property
    def cell_offsets(self) -> np.ndarray:
        sizes = [len(f) for f in self.features]
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)

    @property
    def type_feature(self) -> np.ndarray:
        """int64 [T, n_cats] global feature ids, ascending per row (the same
        key layout as ``TypeReduction.type_feature``)."""
        return self.cell_offsets[None, :] + self.rows.astype(np.int64)

    @classmethod
    def from_registry(cls, reg: Registry) -> "TypeSystem":
        rows, counts = np.unique(reg.assignments, axis=0, return_counts=True)
        return cls(
            k=int(reg.k),
            features=tuple(tuple(f) for f in reg.features),
            rows=rows.astype(np.int32),
            msize=counts.astype(np.int64),
            lo=reg.qmin.astype(np.int64),
            hi=reg.qmax.astype(np.int64),
        )

    def update(
        self, edit: RegistryEdit, reg_before: Registry
    ) -> Tuple["TypeSystem", dict]:
        """Project ``edit`` onto the type space in O(edit).

        Returns the updated system plus an info dict the re-certifier
        consumes: ``changed`` (existing types whose pool moved, with old/new
        sizes), ``new_types`` (appended type indices), and the edited quota
        ``cell`` with its ``old_band``/``new_band``.
        """
        info: dict = {"kind": edit.kind, "changed": [], "new_types": []}
        features = tuple(tuple(f) for f in self.features)
        rows, msize = self.rows, self.msize.copy()
        lo, hi = self.lo.copy(), self.hi.copy()

        if edit.kind in ("agents_add", "new_type"):
            erows = np.asarray(edit.rows, dtype=np.int32)
            if edit.kind == "new_type":
                c = int(edit.category)
                name = edit.feature or f"{c}_new"
                new_slot = len(features[c])
                at = int(self.cell_offsets[c]) + new_slot
                features = tuple(
                    f + (name,) if ci == c else f for ci, f in enumerate(features)
                )
                lo = np.insert(lo, at, 0)
                hi = np.insert(hi, at, min(int(edit.dhi), self.k))
                info["cell"] = at
            uniq, counts = np.unique(erows, axis=0, return_counts=True)
            new_rows: List[np.ndarray] = []
            for row, cnt in zip(uniq, counts):
                t = self._index.get(tuple(int(v) for v in row))
                if t is None:
                    info["new_types"].append(self.T + len(new_rows))
                    new_rows.append(row)
                    msize = np.append(msize, int(cnt))
                else:
                    info["changed"].append((t, int(msize[t]), int(msize[t]) + int(cnt)))
                    msize[t] += int(cnt)
            if new_rows:
                rows = np.concatenate([rows, np.stack(new_rows)], axis=0)
        elif edit.kind == "agents_drop":
            drop = np.asarray(edit.agents, dtype=np.int64)
            uniq, counts = np.unique(
                reg_before.assignments[drop], axis=0, return_counts=True
            )
            for row, cnt in zip(uniq, counts):
                t = self._index[tuple(int(v) for v in row)]
                info["changed"].append((t, int(msize[t]), int(msize[t]) - int(cnt)))
                msize[t] -= int(cnt)
                if msize[t] < 0:
                    raise ValueError("agents_drop exceeds the type's pool")
        elif edit.kind in ("quota_relax", "quota_tighten"):
            f = int(edit.cell)
            info["cell"] = f
            info["old_band"] = (int(lo[f]), int(hi[f]))
            lo[f] = max(0, int(lo[f]) + int(edit.dlo))
            hi[f] = min(self.k, int(hi[f]) + int(edit.dhi))
            info["new_band"] = (int(lo[f]), int(hi[f]))
        else:
            raise ValueError(f"unknown edit kind {edit.kind!r}")

        return (
            TypeSystem(
                k=self.k, features=features, rows=rows, msize=msize, lo=lo, hi=hi
            ),
            info,
        )


# --- delta state: the portable certificate -----------------------------------


@dataclasses.dataclass
class DeltaState:
    """Everything the delta solver needs to re-certify after the next edit:
    the column hull, the certified mixture, the per-stage dual certificates
    and the incrementally kept ELL pack. ``fingerprint`` names the
    certified instance's content (the serving layer keys its delta store by
    it, so a revised instance never picks up a stale state)."""

    system: TypeSystem
    comps: np.ndarray  # int32 [C, T] surviving column hull
    probabilities: np.ndarray  # float64 [C] certified mixture
    type_values: np.ndarray  # float64 [T] served leximin values
    eps_dev: float  # the ladder's own arithmetic ε
    certs: List[StageCert]  # per-stage dual certificates
    pack: EllPack  # ELL pack of ``comps`` (minor = T)
    fingerprint: str = ""  # content fingerprint of the certified instance
    lp_solves: int = 0  # cumulative LP count across base + deltas
    #: certified L∞ bound of the served values vs the true leximin optimum:
    #: equals ``eps_dev`` after any ladder run, grows by the drift bound on
    #: each sensitivity cache hit — a hit is refused before it can cross
    #: the 1e-3 contract
    eps_bound: float = 0.0
    #: accumulated dual/value drift vs the stored stage certificates (reset
    #: to 0 by any ladder re-run); consumes ``delta_cert_margin`` headroom
    cert_drift: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReviseSpec:
    """The ``revise`` payload of a ``service.SelectionRequest``: one registry
    edit against an identified base solve. ``base_fingerprint`` names the
    tenant session's stored :class:`DeltaState` (empty: the fingerprint of
    ``reg_before``); a mismatch falls back to the from-scratch solve rather
    than re-certifying against the wrong portfolio. ``reg_before`` carries
    the pre-edit registry, so drops project onto types without an O(n)
    diff."""

    edit: RegistryEdit
    reg_before: Registry
    base_fingerprint: str = ""


@dataclasses.dataclass
class DeltaOutcome:
    """One re-certification step: the successor state and the certificate
    block (``mode``, ``lp_solves``, ``eps_bound``, the screen's counts)
    saying how the answer was obtained."""

    state: DeltaState
    cert: dict


# --- the device screen ------------------------------------------------------


def _screen_core(idx, val, tfeat, minv, lo, hi, Y, mu, k: int):
    """Integer feasibility of every packed column against the edited
    instance and its per-stage dual price gap, as torch ops on the
    operands' device.

    ``idx``/``val`` ``[C, P]`` ELL slots (type index, member count);
    ``tfeat [T, ncat]`` global feature ids; ``minv [T]`` pool sizes;
    ``lo``/``hi [F]`` quota bands; ``Y [S, T]`` stage duals; ``mu [S]``
    support prices. Counts are small integers, exact in float32, so the
    ±0.5 comparisons are exact integer tests. Returns ``float32 [1 + S,
    C]``: the feasibility flag, then the gaps ``mu_s − price_s(c)``."""
    C, P = idx.shape
    idx64 = idx.to(torch.int64)
    ok_k = (val.sum(dim=1) - float(k)).abs() < 0.5
    mv = minv[idx64]  # [C, P]
    ok_cap = (val <= mv + 0.5).all(dim=1)
    ncat = tfeat.shape[1]
    feat = tfeat[idx64].reshape(C, P * ncat)  # [C, P·ncat]
    counts = torch.zeros((C, lo.shape[0]), dtype=iterate_dtype(val.dtype), device=val.device)
    counts.scatter_add_(1, feat, val[:, :, None].expand(C, P, ncat).reshape(C, P * ncat))
    ok_band = ((counts >= lo[None, :] - 0.5) & (counts <= hi[None, :] + 0.5)).all(dim=1)
    feas = ok_k & ok_cap & ok_band
    w = val / torch.clamp_min(mv, 1.0)  # [C, P] allocation weights
    price = torch.einsum("scp,cp->sc", Y[:, idx64], w)  # [S, C]
    return torch.cat([feas.to(torch.float32)[None, :], mu[:, None] - price], dim=0)


def _host_feasible(comps: np.ndarray, system: TypeSystem) -> np.ndarray:
    """Exact int64 feasibility re-proof of every column (the same hard
    discipline as ``DevicePricer._validate``: a column the screen keeps
    becomes part of a served certificate, so its feasibility is re-proven
    in exact host arithmetic before the device verdict is trusted)."""
    T, F = system.T, system.F
    c64 = comps.astype(np.int64)
    tf = np.zeros((T, F), dtype=np.int64)
    if system.n_cats:
        tfe = system.type_feature
        tf[np.repeat(np.arange(T), system.n_cats), tfe.ravel()] = 1
    counts = c64 @ tf
    feas = c64.sum(axis=1) == system.k
    feas &= (c64 <= system.msize[None, :]).all(axis=1)
    feas &= (counts >= system.lo[None, :]).all(axis=1)
    feas &= (counts <= system.hi[None, :]).all(axis=1)
    return feas


def screen_columns(
    pack: EllPack,
    comps: np.ndarray,
    system: TypeSystem,
    certs: List[StageCert],
    margin: float,
    cfg=None,
    log: Optional[RunLog] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Screen the packed column hull against the edited instance in one
    batch of torch ops on ``device`` (CUDA unless the caller passes
    another), read back once.

    Returns ``(feas bool [C], gap float64 [S, C])`` with ``gap[s, c] = μ_s −
    price_s(c)``. Feasibility is re-proven on the host in int64; float32
    gaps within ``_FLAG_WINDOW`` margins of the certificate threshold are
    re-derived on the host in float64 before any certificate decision reads
    them."""
    log = log or RunLog(echo=False)
    dev = resolve_device(device)
    C, T = comps.shape
    S_n = len(certs)
    tfeat = np.zeros((T, max(system.n_cats, 1)), dtype=np.int64)
    if system.n_cats:
        tfeat[:] = system.type_feature
    Y = np.zeros((S_n, T), dtype=np.float32)
    mu = np.zeros(S_n, dtype=np.float32)
    for s, cert in enumerate(certs):
        Y[s] = cert.y
        mu[s] = cert.mu
    with no_implicit_transfers(cfg):
        operands = (
            upload(pack.idx, dev), upload(pack.val, dev), upload(tfeat, dev),
            upload(np.minimum(system.msize, np.iinfo(np.int32).max), dev, torch.float32),
            upload(system.lo, dev, torch.float32), upload(system.hi, dev, torch.float32),
            upload(Y, dev), upload(mu, dev),
        )
        # an eager family: recorded for the graph store, no one-time work
        note_eager("delta.screen", operands, {"k": int(system.k)})
        with dispatch_span(
            "delta.screen", cfg=cfg, log=log, cols=int(C), stages=int(S_n),
        ) as ds:
            with guarded_launch(dev):
                out_d = _screen_core(*operands, k=int(system.k))
            ds.out = out_d
    log.count("delta_screen_dispatches")
    out = out_d.cpu().numpy()
    feas = (out[0] > 0.5) & _host_feasible(comps, system)
    gap = out[1:].astype(np.float64)
    if S_n and C:
        # float64 re-pricing of the near-margin set: the certificate
        # threshold must never ride on float32 round-off
        flagged = np.nonzero(np.min(gap, axis=0) < _FLAG_WINDOW * margin)[0]
        if flagged.size:
            log.count("delta_screen_flag", int(flagged.size))
            mm = np.maximum(system.msize.astype(np.float64), 1.0)
            M = comps[flagged].astype(np.float64) / mm[None, :]
            Ys = np.stack([c.y for c in certs])  # [S, T]
            mus = np.asarray([c.mu for c in certs])
            gap[:, flagged] = mus[:, None] - Ys @ M.T
    return feas, gap


# --- incremental enumeration of newly-admitted regions -----------------------


def _enumerate_region(
    system: TypeSystem,
    tlo: np.ndarray,
    thi: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    cap: int = 200_000,
    node_budget: int = 3_000_000,
) -> Optional[np.ndarray]:
    """All compositions with per-type bounds ``tlo ≤ c_t ≤ thi`` and quota
    bands ``lo ≤ counts ≤ hi`` (int32 [R, T]); None if the region exceeds
    ``cap`` columns or ``node_budget`` search nodes (the caller falls back
    to a from-scratch solve). The same suffix-pruned DFS as
    ``enumerate_compositions``, generalised to type LOWER bounds so an
    edit's newly-admitted region — and only it — is enumerated."""
    T, F, k = system.T, system.F, system.k
    tlo = np.maximum(np.asarray(tlo, dtype=np.int64), 0)
    thi = np.minimum(np.asarray(thi, dtype=np.int64), k)
    if np.any(tlo > thi):
        return np.zeros((0, T), dtype=np.int32)
    tf = np.zeros((T, F), dtype=np.int64)
    tfe = system.type_feature
    if system.n_cats:
        tf[np.repeat(np.arange(T), system.n_cats), tfe.ravel()] = 1
    suf_max = np.zeros((T + 1, F), dtype=np.int64)
    suf_min = np.zeros((T + 1, F), dtype=np.int64)
    suf_max_t = np.zeros(T + 1, dtype=np.int64)
    suf_min_t = np.zeros(T + 1, dtype=np.int64)
    for i in range(T - 1, -1, -1):
        suf_max[i] = suf_max[i + 1] + tf[i] * int(thi[i])
        suf_min[i] = suf_min[i + 1] + tf[i] * int(tlo[i])
        suf_max_t[i] = suf_max_t[i + 1] + int(thi[i])
        suf_min_t[i] = suf_min_t[i + 1] + int(tlo[i])

    out: List[np.ndarray] = []
    counts = np.zeros(F, dtype=np.int64)
    cur = np.zeros(T, dtype=np.int32)
    nodes = 0

    def rec(i: int, total: int) -> bool:
        nonlocal nodes
        nodes += 1
        if nodes > node_budget:
            return False
        if i == T:
            if total == k and np.all(counts >= lo) and np.all(counts <= hi):
                out.append(cur.copy())
                if len(out) > cap:
                    return False
            return True
        if total + suf_max_t[i] < k or total + suf_min_t[i] > k:
            return True
        if np.any(counts + suf_min[i] > hi) or np.any(counts + suf_max[i] < lo):
            return True
        row = tfe[i]
        c_hi = min(int(thi[i]), k - total - int(suf_min_t[i + 1]))
        for c in range(c_hi, int(tlo[i]) - 1, -1):
            cur[i] = c
            counts[row] += c
            ok = rec(i + 1, total + c)
            counts[row] -= c
            cur[i] = 0
            if not ok:
                return False
        return True

    if not rec(0, 0) or len(out) > cap:
        return None
    if not out:
        return np.zeros((0, T), dtype=np.int32)
    return np.stack(out, axis=0)


def _admitted_regions(
    system: TypeSystem, info: dict
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Disjoint (tlo, thi, lo, hi) regions covering exactly the columns the
    edit newly admits. Tighten/drop edits admit nothing; a quota relaxation
    admits the widened band minus the old band (one region per side); raised
    per-type caps (joins, new types) admit columns exceeding the old cap,
    deduplicated by capping each earlier raised type back at its old size."""
    T, k = system.T, system.k
    base_tlo = np.zeros(T, dtype=np.int64)
    base_thi = np.minimum(system.msize, k)
    lo, hi = system.lo.copy(), system.hi.copy()
    kind = info["kind"]
    if kind in ("quota_tighten", "agents_drop"):
        return []
    regions = []
    if kind == "quota_relax":
        f = info["cell"]
        ol, oh = info["old_band"]
        nl, nh = info["new_band"]
        if nl < ol:
            l2, h2 = lo.copy(), hi.copy()
            l2[f], h2[f] = nl, ol - 1
            regions.append((base_tlo, base_thi, l2, h2))
        if nh > oh:
            l2, h2 = lo.copy(), hi.copy()
            l2[f], h2[f] = oh + 1, nh
            regions.append((base_tlo, base_thi, l2, h2))
        return regions
    raised = [(t, m0) for (t, m0, m1) in info["changed"] if m1 > m0]
    raised += [(t, 0) for t in info["new_types"]]
    for i, (t, m_old) in enumerate(raised):
        tlo, thi = base_tlo.copy(), base_thi.copy()
        tlo[t] = m_old + 1
        for tj, mj in raised[:i]:
            thi[tj] = min(int(thi[tj]), mj)
        regions.append((tlo, thi, lo, hi))
    return regions


# --- base certification ------------------------------------------------------


def certify_base(
    reg: Registry,
    cfg=None,
    log: Optional[RunLog] = None,
    fingerprint: str = "",
    device: DeviceLike = None,
) -> Optional[DeltaState]:
    """Solve the registry from scratch once, capturing everything the delta
    path needs: the full enumeration, the mixture, the per-stage dual
    certificates and the ELL pack. The LEXIMIN ladder's device work runs on
    ``device`` (CUDA unless the caller passes another). Returns None when
    the instance is out of the enumerable regime (too many types or
    columns): delta re-certification is scoped to the enumerated tier."""
    log = log or RunLog(echo=False)
    dev = resolve_device(device)
    system = TypeSystem.from_registry(reg)
    max_types = getattr(cfg, "enum_max_types", 16) if cfg else 16
    if system.T > max_types:
        return None
    cap = getattr(cfg, "enum_cap", 200_000) if cfg else 200_000
    budget = getattr(cfg, "enum_node_budget", 3_000_000) if cfg else 3_000_000
    comps = _enumerate_region(
        system,
        np.zeros(system.T, dtype=np.int64),
        np.minimum(system.msize, system.k),
        system.lo,
        system.hi,
        cap=cap,
        node_budget=budget,
    )
    if comps is None or len(comps) == 0:
        return None
    ts = leximin_over_compositions(
        comps,
        np.maximum(system.msize, 1).astype(np.float64),
        probe_tol=getattr(cfg, "probe_tol", 1e-7) if cfg else 1e-7,
        log=log,
        cfg=cfg,
        capture_certs=True,
        device=dev,
    )
    pack = EllPack.from_rows(comps, minor=system.T)
    return DeltaState(
        system=system,
        comps=comps,
        probabilities=ts.probabilities,
        type_values=ts.type_values,
        eps_dev=ts.eps_dev,
        certs=ts.stage_certs,
        pack=pack,
        fingerprint=fingerprint,
        lp_solves=ts.lp_solves,
        eps_bound=ts.eps_dev,
        cert_drift=0.0,
    )


# --- re-certification --------------------------------------------------------


def _embed_cert(cert: StageCert, T_new: int) -> StageCert:
    """Embed a stage certificate into a grown type space: appended types
    carry zero dual weight and stay OPEN (-1) in the fixed vector."""
    T_old = len(cert.y)
    if T_new == T_old:
        return cert
    return StageCert(
        z=cert.z,
        y=np.concatenate([cert.y, np.zeros(T_new - T_old)]),
        mu=cert.mu,
        fixed_after=np.concatenate(
            [cert.fixed_after, np.full(T_new - T_old, -1.0)]
        ),
    )


def _drift_bound(info: dict, comps_surviving: np.ndarray) -> float:
    """Conservative per-stage value drift from pool-size changes: the LP
    matrix rows scale by ``m_t/m'_t``, so any mixture's type-t value moves
    by at most ``max_c c_t · |1/m'_t − 1/m_t|`` — evaluated with the max
    count over the SURVIVING hull (tighter than k)."""
    d = 0.0
    for t, m0, m1 in info.get("changed", []):
        cmax = float(comps_surviving[:, t].max()) if len(comps_surviving) else 0.0
        d = max(
            d, cmax * abs(1.0 / max(m1, 1) - 1.0 / max(m0, 1))
        )
    return d


def recertify(
    state: DeltaState,
    edit: RegistryEdit,
    reg_before: Registry,
    cfg=None,
    log: Optional[RunLog] = None,
    fingerprint: str = "",
    device: DeviceLike = None,
) -> Optional[DeltaOutcome]:
    """Re-certify the portfolio after one registry edit in ~O(edit).

    Decision ladder (each rung strictly cheaper than the next):

    1. **cache hit** — old support survives, every newly-admitted column
       prices out at every stage, drift bound inside the margin: serve the
       old mixture with exactly recomputed values, zero LP solves;
    2. **warm resume** — only stages ≥ s are invalidated by priced-in new
       columns: resume the ladder from stage s's stored fixed vector;
    3. **full ladder** — re-run the fixing ladder over the screened hull
       plus the incremental region (still no O(n) reduction, no full
       enumeration).

    The screen and the ladder's device work run on ``device`` (CUDA unless
    the caller passes another). Returns None when the edit leaves the delta
    envelope (region enumeration over budget, or the hull died): the caller
    falls back to a from-scratch :func:`certify_base`.
    """
    log = log or RunLog(echo=False)
    dev = resolve_device(device)
    margin = getattr(cfg, "delta_cert_margin", 2.0e-4) if cfg else 2.0e-4
    with log.timer("delta_recertify"):
        sys_new, info = state.system.update(edit, reg_before)
        T0, T1 = state.system.T, sys_new.T
        comps_old = state.comps
        if T1 > T0:
            comps_old = np.pad(comps_old, ((0, 0), (0, T1 - T0)))
        certs = [_embed_cert(c, T1) for c in state.certs]

        # 1) incremental enumeration of the newly-admitted regions
        cap = getattr(cfg, "enum_cap", 200_000) if cfg else 200_000
        budget = getattr(cfg, "enum_node_budget", 3_000_000) if cfg else 3_000_000
        new_parts: List[np.ndarray] = []
        for tlo, thi, lo2, hi2 in _admitted_regions(sys_new, info):
            r = _enumerate_region(sys_new, tlo, thi, lo2, hi2, cap, budget)
            if r is None:
                return None
            new_parts.append(r)
        new_rows = (
            np.concatenate(new_parts, axis=0)
            if new_parts
            else np.zeros((0, T1), dtype=np.int32)
        )
        if len(new_rows):
            log.count("delta_new_columns", int(len(new_rows)))

        # 2) incremental pack maintenance + ONE screening dispatch
        pack = state.pack.take(np.arange(len(state.pack)))  # copy, not alias
        pack.minor = T1
        if len(new_rows):
            pack.append(new_rows)
        comps_all = np.concatenate([comps_old, new_rows], axis=0)
        with log.timer("delta_screen"):
            feas, gap = screen_columns(
                pack, comps_all, sys_new, certs, margin, cfg=cfg, log=log, device=dev
            )
        n_old = len(comps_old)
        feas_old, feas_new = feas[:n_old], feas[n_old:]
        dropped = int((~feas_old).sum())
        if dropped:
            log.count("delta_screen_drop", dropped)
        if not feas.any():
            return None  # the hull died: the edited instance needs a fresh solve

        support = state.probabilities > _SUPPORT_EPS
        support_ok = bool(feas_old[support].all())
        dropped_mass = float(state.probabilities[~feas_old].sum())

        # per-stage price verdict on the new feasible columns
        S_n = len(certs)
        new_feas = np.nonzero(feas_new)[0]
        margin_eff = margin - state.cert_drift
        if S_n and len(new_feas):
            gap_new = gap[:, n_old + new_feas]  # [S, R]
            priced_out = bool((gap_new > margin_eff).all())
            bad_stages = np.nonzero((gap_new <= margin_eff).any(axis=1))[0]
            first_bad = int(bad_stages[0]) if len(bad_stages) else None
        else:
            priced_out = True
            first_bad = None

        # a new TYPE covered by feasible new columns changes the leximin
        # OBJECTIVE (a fresh min to raise), not just the column set — no
        # stage face argument applies, so neither cache hit nor resume may
        # claim; only an uncoverable new type (no feasible column carries
        # it) legitimately keeps its value at 0
        new_type_covered = any(
            bool(comps_all[feas][:, t].max() > 0) for t in info["new_types"]
        )

        drift = _drift_bound(info, comps_all[feas])
        eps_grow = drift + S_n * drift + dropped_mass
        cache_ok = (
            support_ok
            and priced_out
            and not new_type_covered
            and (
                drift == 0.0
                or (
                    state.cert_drift + S_n * drift <= margin
                    and state.eps_bound + eps_grow <= CONTRACT_LINF
                )
            )
            and state.eps_bound + eps_grow <= CONTRACT_LINF
        )

        keep_idx = np.nonzero(feas)[0]
        comps_keep = comps_all[feas]
        pack_keep = pack.take(keep_idx)
        mm = np.maximum(sys_new.msize, 1).astype(np.float64)
        probe_tol = getattr(cfg, "probe_tol", 1e-7) if cfg else 1e-7

        if cache_ok:
            log.count("delta_cache_hit")
            probs_full = np.concatenate(
                [state.probabilities, np.zeros(len(new_rows))]
            )[feas]
            probs = probs_full / probs_full.sum()
            values = probs @ (comps_keep.astype(np.float64) / mm[None, :])
            new_state = DeltaState(
                system=sys_new,
                comps=comps_keep,
                probabilities=probs,
                type_values=values,
                eps_dev=state.eps_dev,
                certs=certs,
                pack=pack_keep,
                fingerprint=fingerprint,
                lp_solves=state.lp_solves,
                eps_bound=state.eps_bound + eps_grow,
                cert_drift=state.cert_drift + S_n * drift,
            )
            cert_block = {
                "mode": "cache_hit",
                "edit": edit.kind,
                "magnitude": int(edit.magnitude),
                "lp_solves": 0,
                "eps_bound": float(new_state.eps_bound),
                "drift": float(drift),
                "margin": float(margin),
                "screen": {
                    "cols": int(len(comps_all)),
                    "dropped": dropped,
                    "new": int(len(new_rows)),
                    "new_feasible": int(len(new_feas)),
                },
            }
            return DeltaOutcome(state=new_state, cert=cert_block)

        # warm resume is only sound when the stage prefix is EXACT: no pool
        # drift (values shift), no accumulated cert drift, support intact,
        # and the invalidation strictly below the first bad stage
        resume_from = None
        if (
            support_ok
            and drift == 0.0
            and state.cert_drift == 0.0
            and not new_type_covered
            and first_bad is not None
            and first_bad > 0
        ):
            resume_from = first_bad
        fixed_init = certs[resume_from - 1].fixed_after if resume_from else None
        ts = leximin_over_compositions(
            comps_keep,
            mm,
            probe_tol=probe_tol,
            log=log,
            cfg=cfg,
            fixed_init=fixed_init,
            capture_certs=True,
            device=dev,
        )
        if resume_from:
            log.count("delta_resume")
            log.count("delta_resume_stages", int(ts.stages))
            certs_new = certs[:resume_from] + ts.stage_certs
            mode = "resume"
        else:
            log.count("delta_full_ladder")
            certs_new = ts.stage_certs
            mode = "full_ladder"
        new_state = DeltaState(
            system=sys_new,
            comps=comps_keep,
            probabilities=ts.probabilities,
            type_values=ts.type_values,
            eps_dev=ts.eps_dev,
            certs=certs_new,
            pack=pack_keep,
            fingerprint=fingerprint,
            lp_solves=state.lp_solves + ts.lp_solves,
            eps_bound=ts.eps_dev,
            cert_drift=0.0,
        )
        cert_block = {
            "mode": mode,
            "edit": edit.kind,
            "magnitude": int(edit.magnitude),
            "lp_solves": int(ts.lp_solves),
            "eps_bound": float(ts.eps_dev),
            "drift": float(drift),
            "margin": float(margin),
            "resume_stage": int(resume_from) if resume_from else 0,
            "stages_rerun": int(ts.stages),
            "screen": {
                "cols": int(len(comps_all)),
                "dropped": dropped,
                "new": int(len(new_rows)),
                "new_feasible": int(len(new_feas)),
            },
        }
        return DeltaOutcome(state=new_state, cert=cert_block)


# --- bridge: delta certificate → a type reduction's ordering ------------------


@dataclasses.dataclass
class _TypespaceShim:
    """Stand-in for ``compositions.TypeLeximin`` over a reduction's type
    ordering: the fields a realization reads to decompose a certificate
    into concrete panels."""

    compositions: np.ndarray  # int32 [C, T_red]
    probabilities: np.ndarray  # float64 [C]
    type_values: np.ndarray  # float64 [T_red]
    eps_dev: float
    lp_solves: int
    stages: int
    coverable: np.ndarray  # bool [T_red]


def project_to_reduction(state: DeltaState, reduction) -> Optional[_TypespaceShim]:
    """Re-key the delta certificate onto a freshly-built ``TypeReduction``.

    The delta state's types are append-only registry-level types (emptied
    types kept at ``msize = 0``); a reduction enumerates the current pool's
    distinct rows in ``np.unique`` order. Both key types by the same
    ascending global-feature-id tuple, so the permutation is a dict match.
    Returns None on any inconsistency (an unmatched reduction type, a
    pool-size disagreement, or a live column on a type the reduction lost),
    which a caller treats as a delta fallback.
    """
    sysfe = state.system.type_feature
    index = {tuple(int(v) for v in row): t for t, row in enumerate(sysfe)}
    perm = np.empty(reduction.T, dtype=np.int64)
    for r, row in enumerate(np.asarray(reduction.type_feature, dtype=np.int64)):
        t = index.get(tuple(int(v) for v in row))
        if t is None:
            return None
        perm[r] = t
    if not np.array_equal(
        state.system.msize[perm], reduction.msize.astype(np.int64)
    ):
        return None
    # types the reduction does NOT carry must be empty pools with no mass in
    # the certified hull (the screen guarantees their columns died)
    missing = np.setdiff1d(np.arange(state.system.T), perm)
    if len(missing) and (
        state.system.msize[missing].any() or state.comps[:, missing].any()
    ):
        return None
    comps = np.ascontiguousarray(state.comps[:, perm])
    return _TypespaceShim(
        compositions=comps,
        probabilities=state.probabilities,
        type_values=state.type_values[perm].copy(),
        eps_dev=float(state.eps_bound),
        lp_solves=int(state.lp_solves),
        stages=len(state.certs),
        coverable=comps.max(axis=0) > 0,
    )


# --- registered cores (lint/registry.py) ----------------------------------------


@register_ir_core("delta.screen", span="delta.screen")
def _ir_delta_screen(device="cpu") -> IRCase:
    """The churn screen (a whole core: no host read) at the JAX
    registration's shape: 64 columns of 8 ELL slots, 32 types over 3
    categories, 12 quota cells, 4 stages, k = 8."""
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(81, device)
    C, P, T, ncat, per, S = 64, 8, 32, 3, 4, 4
    idx = np.sort(np.argsort(r.rng.random((C, T)), axis=1)[:, :P], axis=1)
    tfeat = np.stack([ci * per + r.rng.integers(0, per, T) for ci in range(ncat)], axis=1)
    F = ncat * per
    return IRCase(
        fn=_screen_core,
        args=(r.t(idx, torch.int32), r.t(r.counts((C, P), 2, 0.3)), r.t(tfeat, torch.int64),
              r.t(r.counts(T, 3)), r.t(np.ones(F, np.float32)), r.t(np.full(F, 4.0, np.float32)),
              r.f32((S, T)), r.f32(S)),
        static=dict(k=8), device=str(device),
    )
