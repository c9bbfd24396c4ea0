"""Batched, shape-bucketed LP engine: many small independent solves at once.

The face loop's end-game polish attempts and the enumerated path's
per-candidate probe LPs are many small independent LPs. This engine takes N
instances of ``min cᵀx s.t. Gx ≤ h, Ax = b, x ≥ 0``, pads them into
power-of-two shape buckets ``(rows_G, rows_A, cols)`` and solves each
padded instance with the serial dense chained PDHG (``lp_pdhg._pdhg_body``):

* **shape buckets** — dims round up to a power of two below
  ``Config.lp_batch_bucket_max`` and to a multiple of it above;
* **padding is inert** — padded rows and columns are all-zero with zero
  objective and offsets (0 ≤ 0 constraints, variables with zero gradient);
* **one solve per lane** — each lane runs alone until it converges, so it
  takes the iterations the serial ``lp_pdhg.solve_lp`` takes on the same
  padded instance, bit for bit, and a lane that has converged costs
  nothing while its bucket-mates run on (the JAX package vmaps the same
  core and freezes converged lanes);
* **warm-start slots keyed per caller** — ``warm_key`` stores each
  instance's (x, λ, μ) at its real size and re-pads it into whatever bucket
  the next call lands in, trailing structural variables (an ε slot) kept at
  the end. The slots live in a :class:`WarmSlotStore`: one default store
  for the offline path, and under a request context (``service/``) the
  request's own store with the key scoped by tenant and request, so two
  concurrent requests of one call site never share warm iterates;
* **cross-request batching** — under a request context whose service
  installed a batcher (``service/batcher.CrossRequestBatcher``), a call
  hands its fleet to the batcher, which merges it with same-schedule
  fleets of other requests on the same device into one engine call
  (``defer=False`` is that call).

The polish screen (:func:`solve_polish_screen_ell`) is the engine's sparse
variant: nested support prefixes of one ELL pack as lanes of one two-sided
solve (``kernels/pdhg_megakernel.dispatch_two_sided``, the hand-written
block kernel on the card), the lanes differing only in their column masks.
Only the real lanes launch (the JAX package pads the batch to a power of
two with inert lanes; lanes are independent, so the results are the same).

The engine is a wall-clock mechanism only: callers keep their own
acceptance checks (float64 residuals, host confirms), and with
``Config.lp_batch`` off every call site runs its serial path.

Under ``Config.mixed_precision`` a bucket's constraint matrices ``G`` and
``A`` go to the device as bf16 when the plan certifies them
(``batch_lp.vmapped_core`` args 1 and 3) and every lane's round trip is
exact; the polish screen's pack stays float32 (the plan demotes nothing
there). The fault sites ``warm_slot_corrupt`` (a loaded warm slot) and
``pdhg_nan`` (a cold lane) poison single lanes for the sentinel to
quarantine.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core, register_spmd_core
from citizensassemblies_tpu_torch.robust import inject
from citizensassemblies_tpu_torch.utils import device as _device
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.utils.guards import CompilationGuard, no_implicit_transfers
from citizensassemblies_tpu_torch.utils.precision import demote_operator, operand_tensor


@dataclasses.dataclass
class BatchLP:
    """One instance of ``min cᵀx s.t. Gx ≤ h, Ax = b, x ≥ 0``.

    ``tol`` overrides the engine-level tolerance per instance. ``tail_vars``
    marks how many trailing variables are structural (the ε slot of an
    ε-LP): a warm-slot re-pad keeps them at the end of the variable vector.
    ``warm`` supplies an explicit (x, λ_G, μ_A) warm start at the instance's
    real sizes; when absent and ``warm_key`` is given, the engine's slot for
    (key, position) is used.
    """

    c: np.ndarray
    G: np.ndarray
    h: np.ndarray
    A: np.ndarray
    b: np.ndarray
    tol: Optional[float] = None
    tail_vars: int = 0
    warm: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


#: smallest padded dimension
_BUCKET_FLOOR = 8


def _bucket_dim(size: int, cap: int) -> int:
    """Power-of-two bucket below ``cap``, multiple-of-``cap`` above it."""
    size = max(int(size), 1)
    if size >= cap:
        return -(-size // cap) * cap
    b = _BUCKET_FLOOR
    while b < size:
        b *= 2
    return min(b, cap)


def lp_batch_enabled(cfg: Optional[Config], device) -> bool:
    """Resolve ``Config.lp_batch``: forced on/off, or (``None``) on when
    ``device`` takes the accelerator routes (``utils.device.on_accelerator``)."""
    cfg = cfg or default_config()
    if cfg.lp_batch is not None:
        return bool(cfg.lp_batch)
    return _device.on_accelerator(device)


#: per-bucket dispatch, solve and capture counts since process start, under
#: their lock: requests dispatch buckets from their own threads
_BUCKET_STATS: Dict[str, Dict[str, int]] = {}
_STATS_LOCK = threading.Lock()


class WarmSlotStore:
    """Warm-start slots: (warm_key, position) → (x, λ, μ, tail_vars) at the
    instance's real sizes (host float64, so slots survive bucket changes).
    Mutations take the store's lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = {}

    def get(self, key: Tuple[str, int]):
        with self._lock:
            return self._slots.get(key)

    def put(self, key: Tuple[str, int], value: Tuple[np.ndarray, np.ndarray, np.ndarray, int]) -> None:
        with self._lock:
            self._slots[key] = value

    def clear(self, warm_key: Optional[str] = None) -> None:
        with self._lock:
            if warm_key is None:
                self._slots.clear()
                return
            for k in [k for k in self._slots if k[0] == warm_key]:
                del self._slots[k]

    def slots(self, warm_key: str) -> Dict[int, tuple]:
        """One caller's slots (position → slot), a copy."""
        with self._lock:
            return {k[1]: slot for k, slot in self._slots.items() if k[0] == warm_key}

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)


#: the offline path's slots; a request under a context never touches them
_DEFAULT_WARM_STORE = WarmSlotStore()


def _current_context():
    """The ambient request context (imported at the call: the service
    package imports the models, which import this module)."""
    from citizensassemblies_tpu_torch.service.context import current_context

    return current_context()


def _resolve_warm(warm_key: Optional[str]):
    """``(store, scoped_key)`` for a call: the ambient request's own store
    (when it has one) with the key scoped by tenant and request, else the
    default store and the key as given."""
    ctx = _current_context()
    store = ctx.warm_store if ctx is not None and ctx.warm_store is not None else _DEFAULT_WARM_STORE
    if ctx is None or warm_key is None:
        return store, warm_key
    return store, ctx.scoped_warm_key(warm_key)


def _bucket_key(insts: Sequence[BatchLP], cap: int) -> Tuple[int, int, int]:
    m1 = max(i.G.shape[0] for i in insts)
    m2 = max(i.A.shape[0] for i in insts)
    nv = max(i.c.shape[0] for i in insts)
    return (_bucket_dim(m1, cap), _bucket_dim(m2, cap), _bucket_dim(nv, cap))


def _repad_warm(
    warm: Tuple[np.ndarray, np.ndarray, np.ndarray],
    tail_vars: int,
    nv: int,
    m1: int,
    m2: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-pad a real-sized warm triple into (nv, m1, m2) slots, keeping the
    last ``tail_vars`` variables at the END of the variable vector (an ε
    slot must survive a column growth at its structural position)."""
    x_w, lam_w, mu_w = (np.asarray(a, dtype=np.float64).ravel() for a in warm)
    x = np.zeros(nv)
    tv = min(int(tail_vars), len(x_w), nv)
    head_old = len(x_w) - tv
    head = min(head_old, nv - tv)
    x[:head] = x_w[:head]
    if tv:
        x[nv - tv :] = x_w[head_old:]
    lam = np.zeros(m1)
    lam[: min(m1, len(lam_w))] = lam_w[:m1]
    mu = np.zeros(m2)
    mu[: min(m2, len(mu_w))] = mu_w[:m2]
    return x, lam, mu


def clear_warm_slots(warm_key: Optional[str] = None) -> None:
    """Drop the engine's warm-start slots (all of them, or one caller's) in
    the resolved store: under a request context, the request's own."""
    store, scoped = _resolve_warm(warm_key)
    store.clear(scoped)


def warm_slots(warm_key: str) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """One caller's warm-start slots (position → slot) in the resolved
    store, for a checkpoint."""
    store, scoped = _resolve_warm(warm_key)
    return store.slots(scoped)


def restore_warm_slots(warm_key: str, slots: Dict[int, tuple]) -> None:
    """Replace one caller's warm-start slots in the resolved store with
    checkpointed ones."""
    store, scoped = _resolve_warm(warm_key)
    store.clear(scoped)
    for pos, (x, lam, mu, tail) in slots.items():
        store.put((scoped, int(pos)), (x, lam, mu, int(tail)))


def bucket_stats() -> Dict[str, Dict[str, int]]:
    """Per-bucket dispatch, solve and capture counts since process start."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _BUCKET_STATS.items()}


def _book(lanes: int, log) -> None:
    if log is not None:
        log.count("lp_batch_dispatches")
        log.count("lp_batch_solves", lanes)


def _readback(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Device outputs to float64 host arrays of the same shapes, in one copy."""
    flat = [t.reshape(-1).to(torch.float32) for t in tensors]
    host = torch.cat(flat).cpu().numpy().astype(np.float64)
    out, o = [], 0
    for t, f in zip(tensors, flat):
        n = f.shape[0]
        out.append(host[o : o + n].reshape(tuple(t.shape)))
        o += n
    return out


def solve_lp_batch(
    problems: Sequence[BatchLP],
    cfg: Optional[Config] = None,
    log=None,
    warm_key: Optional[str] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    common_bucket: bool = False,
    device: DeviceLike = None,
    mesh=None,
    defer: bool = True,
    owners: Optional[Sequence] = None,
):
    """Solve N independent LPs, each padded into its shape bucket, on ``device``.

    Instances are grouped into shape buckets (one dispatch per bucket) and
    each padded instance is solved by the dense chained PDHG. Returns a list
    of :class:`~citizensassemblies_tpu_torch.solvers.lp_pdhg.LPSolution` in
    input order, each sliced back to its instance's real sizes. A lane the
    sentinel quarantined is re-solved on the float64 host path.
    ``warm_key`` engages the warm-start slots. ``common_bucket`` pads every
    instance into one shared bucket (the max of each dim).

    ``mesh`` (a ``torch.distributed`` DeviceMesh of more than one device)
    deals each bucket's lanes to the ranks in the declared ``bucket`` layout
    (contiguous blocks; counted as ``dist_placements`` under
    ``Config.dist_prepartition``): each rank solves its own lanes and the
    solutions are gathered back to every rank.

    Under a request context whose service installed a batcher, the fleet
    goes to ``ctx.batcher`` (``service/batcher.py``), which merges it with
    other requests' fleets of the same schedule and device and comes back
    here with ``defer=False``; mesh and shared-bucket calls keep their own
    layouts. A fault or sentinel count without a ``log`` lands on the
    ambient request's log. ``owners`` (the batcher's merged fleets) gives
    each instance's request context: a lane's fault sites consult its
    owner's injector and its fault and sentinel counts land on its owner's
    log.

    Counters on ``log``: ``lp_batch_dispatches`` (buckets),
    ``lp_batch_solves`` (instances), ``lp_batch_warm_hits``.
    """
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import sentinels_enabled

    cfg = cfg or default_config()
    if not problems:
        return []
    dev = resolve_device(device)
    ctx = _current_context()
    if defer and mesh is None and not common_bucket and ctx is not None and ctx.batcher is not None:
        return ctx.batcher.submit(
            problems, ctx=ctx, cfg=cfg, log=log, warm_key=warm_key, tol=tol,
            max_iters=max_iters, device=dev,
        )
    # fault and sentinel evidence of a call without a log (the batcher's
    # merged dispatch) lands on the ambient request's log
    fault_log = log if log is not None else (ctx.log if ctx is not None else None)

    def owner_of(i):
        owner = owners[i] if owners is not None else None
        if owner is None:
            return fault_log, None
        return owner.log, owner.injector
    warm_store, warm_key = _resolve_warm(warm_key)
    cap = max(int(cfg.lp_batch_bucket_max), _BUCKET_FLOOR)
    base_tol = float(tol if tol is not None else cfg.pdhg_tol)
    kw = dict(
        max_iters=int(max_iters if max_iters is not None else cfg.pdhg_max_iters),
        check_every=int(cfg.pdhg_check_every), sentinel=sentinels_enabled(cfg),
    )

    # group instance positions by bucket (insertion-ordered, deterministic)
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    if common_bucket:
        groups[_bucket_key(problems, cap)] = list(range(len(problems)))
    else:
        for i, inst in enumerate(problems):
            groups.setdefault(_bucket_key([inst], cap), []).append(i)

    out: List[Optional[LPSolution]] = [None] * len(problems)
    slots: Dict[int, tuple] = {}
    dealt = mesh is not None and int(mesh.size()) > 1
    for (m1, m2, nv), idxs in groups.items():
        _book(len(idxs), log)
        own = set(idxs)
        if dealt:
            own = {idxs[j] for j in _own_lanes(len(idxs), mesh, cfg, log)}
        lanes = []
        for i in idxs:
            inst = problems[i]
            nvi, m1i, m2i = inst.c.shape[0], inst.G.shape[0], inst.A.shape[0]
            c = np.zeros(nv, np.float32)
            G = np.zeros((m1, nv), np.float32)
            h = np.zeros(m1, np.float32)
            A = np.zeros((m2, nv), np.float32)
            b = np.zeros(m2, np.float32)
            c[:nvi], G[:m1i, :nvi], h[:m1i] = inst.c, inst.G, inst.h
            A[:m2i, :nvi], b[:m2i] = inst.A, inst.b
            x0, lam0, mu0 = np.zeros(nv, np.float32), np.zeros(m1, np.float32), np.zeros(m2, np.float32)
            warm = inst.warm
            lane_log, lane_inj = owner_of(i)
            if warm is None and warm_key is not None:
                slot = warm_store.get((warm_key, i))
                if slot is not None:
                    warm = slot[:3]
                    if log is not None:
                        log.count("lp_batch_warm_hits")
                    if inject.site("warm_slot_corrupt", lane_log, inj=lane_inj):
                        # a corrupt slot must be quarantined by the lane's
                        # sentinel, not poison the bucket
                        bad = np.array(warm[0], dtype=np.float64)
                        bad[:1] = np.nan
                        warm = (bad, warm[1], warm[2])
            if warm is None and inject.site("pdhg_nan", lane_log, inj=lane_inj):
                x0[0] = np.nan  # one cold lane poisoned
            if warm is not None:
                # re-pad at the instance's REAL sizes: the bucket padding
                # beyond them is all-zero columns the iterate never touches
                x0[:nvi], lam0[:m1i], mu0[:m2i] = _repad_warm(warm, inst.tail_vars, nvi, m1i, m2i)
            lanes.append([c, G, h, A, b, x0, lam0, mu0])
        # the bucket's constraint matrices demote together, as the JAX
        # package's stacked operands do: one count per bucket and operand
        for arg in (1, 3):
            stacked = demote_operator(
                np.stack([lane[arg] for lane in lanes]), cfg, core="batch_lp.vmapped_core",
                arg=arg, log=log, device=dev,
            )
            for lane, op in zip(lanes, stacked):
                lane[arg] = op
        bkey = f"{m1}x{m2}x{nv}x{len(idxs)}"
        with dispatch_span(
            "batch_lp.vmapped_core", cfg=cfg, log=log, bucket=bkey, lanes=len(own),
            check_every=kw["check_every"],
        ) as ds, CompilationGuard(name=f"lp_batch_{bkey}") as guard:
            ds.note(iters=_solve_lanes(
                problems, idxs, lanes, own, dev, base_tol, cfg, kw, owner_of, out, slots,
                warm_key,
            ))
        with _STATS_LOCK:
            stats = _BUCKET_STATS.setdefault(bkey, {"dispatches": 0, "solves": 0, "compiles": 0})
            stats["dispatches"] += 1
            stats["solves"] += len(own)
            stats["compiles"] += guard.count
    if dealt:
        import torch.distributed as dist

        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(
            gathered, ({i: out[i] for i in range(len(out)) if out[i] is not None}, slots)
        )
        for sols, rank_slots in gathered:
            for i, sol in sols.items():
                out[i] = sol
            slots.update(rank_slots)
    for i, slot in slots.items():
        warm_store.put((warm_key, i), slot)
    return out


def _solve_lanes(problems, idxs, lanes, own, dev, base_tol, cfg, kw, owner_of, out, slots,
                 warm_key):
    """Solve a bucket's own lanes one by one (the dense chained PDHG), into
    ``out`` and ``slots``; a quarantined lane is re-solved on the host and
    counted on its owner's log (``owner_of(i) -> (log, injector)``).
    Returns the iterations each solved lane took."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import (
        FLAG_POISONED,
        LPSolution,
        _host_resolve_lp,
        _pdhg_body,
    )

    t32 = dict(dtype=torch.float32, device=dev)
    # the JAX package's family of the batched core: the bucket shape rides
    # the graph store's signature
    family = f"batch_lp.vmapped[{kw['max_iters']},{kw['check_every']},{int(kw['sentinel'])}]"
    iters = []
    for i, (c, G, h, A, b, x0, lam0, mu0) in zip(idxs, lanes):
        if i not in own:
            continue
        inst = problems[i]
        nvi, m1i, m2i = inst.c.shape[0], inst.G.shape[0], inst.A.shape[0]
        tol_i = float(inst.tol if inst.tol is not None else base_tol)
        operands = (
            torch.as_tensor(c, **t32), operand_tensor(G, dev), torch.as_tensor(h, **t32),
            operand_tensor(A, dev), *(torch.as_tensor(a, **t32) for a in (b, x0, lam0, mu0)),
        )
        with no_implicit_transfers(cfg):
            x, lam, mu, it, res, flags = _pdhg_body(*operands, tol_i, family=family, **kw)
        iters.append(int(it))
        poisoned = bool(flags & FLAG_POISONED)
        log = owner_of(i)[0]
        if poisoned:
            # per-lane quarantine: re-solve THIS instance on the float64
            # host path and do not write its warm slot
            if log is not None:
                log.count("sentinel_quarantined")
            host = _host_resolve_lp(inst.c, inst.G, inst.h, inst.A, inst.b)
            if host is not None:
                if log is not None:
                    log.count("sentinel_host_resolve")
                out[i] = host
                continue
        x, lam, mu = _readback(x, lam, mu)
        xi, li, mi = x[:nvi], lam[:m1i], mu[:m2i]
        out[i] = LPSolution(
            ok=bool(res <= tol_i * 4.0) and not poisoned,
            x=xi,
            lam=li,
            mu=mi,
            objective=float(np.asarray(inst.c, dtype=np.float64) @ xi),
            iters=int(it),
            kkt=float(res),
        )
        if warm_key is not None and not poisoned:
            slots[i] = (xi, li, mi, int(inst.tail_vars))
    return iters


def _own_lanes(lanes: int, mesh, cfg: Config, log) -> List[int]:
    """This rank's lane positions of a bucket of ``lanes``: its shard of the
    lane axis (padded to a multiple of the mesh size) in the declared
    ``bucket`` layout."""
    from citizensassemblies_tpu_torch.dist import partition as dist_partition

    ndev = int(mesh.size())
    padded = -(-lanes // ndev) * ndev
    ids = dist_partition.prepartition(
        torch.arange(padded, dtype=torch.int64), dist_partition.bucket(mesh, 1), log=log,
        count=bool(cfg.dist_prepartition),
    ).to_local().cpu().numpy()
    return [int(j) for j in ids if j < lanes]


def solve_polish_screen_ell(
    ell,
    v: np.ndarray,
    caps: Sequence[int],
    warms: Sequence[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]],
    tol: float,
    max_iters: int,
    cfg: Optional[Config] = None,
    log=None,
    device: DeviceLike = None,
):
    """Solve nested polish-face prefixes as lanes of ONE two-sided solve.

    ``ell`` packs the support columns
    (:class:`~citizensassemblies_tpu_torch.solvers.sparse_ops.EllPack`,
    minor = the T types), padded to ``_bucket_dim`` columns; ``caps`` are the
    prefix column counts (one lane each, as per-lane column masks over the
    shared pack); ``warms`` gives each lane's (x, λ, μ) warm triple at its
    real size, or None. The route is ``Config.pdhg_megakernel``'s for
    ``len(caps)`` lanes: the block kernel on the card (its plain version on
    CPU tensors with the gate forced), else the chained ELL ops. Returns a
    list of :class:`~citizensassemblies_tpu_torch.solvers.lp_pdhg.LPSolution`
    in cap order, ``x = [p (Cp), ε]`` as the serial ELL master's.
    """
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import (
        FLAG_POISONED,
        LPSolution,
        _pdhg_two_sided_body_ell,
        sentinels_enabled,
    )

    cfg = cfg or default_config()
    dev = resolve_device(device)
    T = int(ell.minor)
    cap_dim = max(int(cfg.lp_batch_bucket_max), _BUCKET_FLOOR)
    Cp = _bucket_dim(len(ell), cap_dim)
    idx_p, val_p = ell.padded(Cp)
    B = len(caps)
    f32 = np.float32
    colmask = np.zeros((B, Cp), f32)
    x0 = np.zeros((B, Cp + 1), f32)
    lam0 = np.zeros((B, 2 * T), f32)
    mu0 = np.zeros(B, f32)
    for lane, c_ in enumerate(caps):
        colmask[lane, : int(c_)] = 1.0
        warm = warms[lane] if lane < len(warms) else None
        if warm is not None:
            x_w, l_w, m_w = warm
            m = min(int(c_), len(x_w) - 1)
            x0[lane, :m] = x_w[:m]
            x0[lane, Cp] = max(float(x_w[-1]), 0.0)
            lam0[lane, : min(2 * T, len(l_w))] = l_w[: 2 * T]
            mu0[lane] = float(m_w[0] if np.ndim(m_w) else m_w)
    sent = sentinels_enabled(cfg)
    kw = dict(max_iters=int(max_iters), check_every=int(cfg.pdhg_check_every), sentinel=sent)
    fused = mk.megakernel_mode(cfg, T, Cp, dev, log=log, lanes=B) != "off"
    if not fused:
        csr = mk.csr_to_device(idx_p, val_p, T, dev)
    t32 = dict(dtype=torch.float32, device=dev)
    lanes = (
        torch.as_tensor(np.asarray(v, f32), **t32), torch.as_tensor(colmask, **t32),
        torch.as_tensor(x0, **t32), torch.as_tensor(lam0, **t32),
        torch.as_tensor(mu0, **t32), torch.full((B,), float(tol), **t32),
    )
    with dispatch_span(
        "batch_lp.polish_screen_ell", cfg=cfg, log=log, bucket=f"{T}x{Cp}x{B}", lanes=B,
        kp=int(idx_p.shape[1]), nnz=int(np.count_nonzero(val_p)), check_every=kw["check_every"],
    ) as ds, no_implicit_transfers(cfg):
        if fused:
            core_out = mk.dispatch_two_sided(idx_p, val_p, *lanes, log=log, cfg=cfg, **kw)
        else:
            core_out = _pdhg_two_sided_body_ell(
                torch.as_tensor(idx_p, dtype=torch.int32, device=dev),
                torch.as_tensor(val_p, **t32), *lanes, csr, **kw,
                family=f"batch_lp.polish_ell[{kw['max_iters']},{kw['check_every']},{int(sent)}]",
            )
        ds.out = core_out
    x, lam, mu, it, res, flags = _readback(*core_out)
    ds.note(iters=[int(i) for i in it])
    _book(B, log)
    out = []
    for lane in range(B):
        res_l = float(res[lane])
        poisoned = bool(int(flags[lane]) & FLAG_POISONED)
        if poisoned and log is not None:
            # the screen is advisory: a quarantined prefix lane is not a
            # candidate (its frozen iterate fails the caller's own float64
            # accept check), and the deep polish covers the miss
            log.count("sentinel_quarantined")
        out.append(
            LPSolution(
                ok=bool(res_l <= float(tol) * 4.0) and not poisoned,
                x=x[lane],
                lam=lam[lane],
                mu=np.atleast_1d(mu[lane]),
                objective=float(x[lane][Cp]),
                iters=int(it[lane]),
                kkt=res_l,
            )
        )
    return out


def two_sided_master_batch_lp(
    MT: np.ndarray, v: np.ndarray, tol: Optional[float] = None
) -> BatchLP:
    """Pack one two-sided ε master ``min ε s.t. v − ε ≤ MT p ≤ v + ε,
    Σp = 1, p ≥ 0, ε ≥ 0`` into the engine's generic form (variables
    ``[p (C), ε]``, ``tail_vars=1`` so warm slots survive column growth).
    Row order matches ``solve_two_sided_master``: ``lam = [λ_lo (T),
    λ_up (T)]``, so pricing duals are ``lam[:T] − lam[T:]``."""
    T, C = MT.shape
    G = np.zeros((2 * T, C + 1))
    G[:T, :C] = -MT
    G[T:, :C] = MT
    G[:, C] = -1.0
    h = np.concatenate([-np.asarray(v, dtype=np.float64), np.asarray(v, dtype=np.float64)])
    A = np.zeros((1, C + 1))
    A[0, :C] = 1.0
    b = np.ones(1)
    c = np.zeros(C + 1)
    c[C] = 1.0
    return BatchLP(c=c, G=G, h=h, A=A, b=b, tol=tol, tail_vars=1)


def face_probe_batch_lp(
    objective: np.ndarray,
    A_face: np.ndarray,
    b_face: np.ndarray,
    tol: Optional[float] = None,
) -> BatchLP:
    """Pack one optimal-face probe ``max objective·x s.t. A_face x ≤ b_face,
    Σx = 1, x ≥ 0`` (the certification probe of ``compositions.py``) into
    the engine's MIN form (negated objective)."""
    C = objective.shape[0]
    return BatchLP(
        c=-np.asarray(objective, dtype=np.float64),
        G=np.asarray(A_face, dtype=np.float64),
        h=np.asarray(b_face, dtype=np.float64),
        A=np.ones((1, C)),
        b=np.ones(1),
        tol=tol,
    )


def final_primal_batch_lp(P: np.ndarray, target: np.ndarray, tol: Optional[float] = None) -> BatchLP:
    """One final ε-LP ``min ε s.t. Pᵀp ≥ target − ε, Σp = 1, p ≥ 0, ε ≥
    0`` (``leximin.py:453-464``) in the engine's generic form: the
    per-instance solve of a sweep's fleet (``parallel/sweep.py``)."""
    P = np.asarray(P, dtype=np.float64)
    C, n = P.shape
    c = np.zeros(C + 1)
    c[C] = 1.0
    G = np.hstack([-P.T, -np.ones((n, 1))])
    h = -np.asarray(target, dtype=np.float64)
    A = np.zeros((1, C + 1))
    A[0, :C] = 1.0
    return BatchLP(c=c, G=G, h=h, A=A, b=np.ones(1), tol=tol, tail_vars=1)


# --- registered cores (lint/registry.py) ----------------------------------------
# The engine solves a bucket's lanes one by one (:func:`_solve_lanes`), so the
# vmapped core is each lane's dense core to its first host read, stacked; the
# polish screen is the two-sided core over its lanes. Shapes are the JAX
# registrations'.

#: the JAX registrations' schedule (max_iters, check_every, sentinel)
_IR_KW = (1024, 128, 0)


def lanes_first_blocks(c, G, h, A, b, x0, lam0, mu0, tol, *, check_every: int,
                       graph: bool = False):
    """Each lane of a stacked bucket through the dense LP core to its first
    host read (:func:`_solve_lanes`). Returns the stacked ``(x, lam,
    mu)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import lp_first_block

    family = "batch_lp.vmapped[" + ",".join(str(v) for v in _IR_KW) + "]"
    outs = [
        lp_first_block(*(a[i] for a in (c, G, h, A, b, x0, lam0, mu0, tol)),
                       check_every=check_every, graph=graph, family=family)
        for i in range(c.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _ir_bucket(seed: int, device, B: int, nv: int, m1: int, m2: int, **extra) -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.lint.operands import dense_lp_operands

    return IRCase(
        fn=lanes_first_blocks, args=dense_lp_operands(Seeded(seed, device), nv, m1, m2, lanes=B),
        static=dict(check_every=_IR_KW[1], graph=False), device=str(device),
        graph="batch_lp.vmapped[" + ",".join(str(v) for v in _IR_KW) + "]", **extra,
    )


@register_ir_core("batch_lp.vmapped_core", span="batch_lp.vmapped_core")
def _ir_batch_core(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import LP_RANGES

    return _ir_bucket(61, device, 4, 65, 64, 1, arg_ranges=LP_RANGES,
                      prec_demote=(1, 3))  # stacked G, A


@register_ir_core(
    "batch_lp.polish_screen_dense",
    span_optout="IR comparator only: the dense polish screen dispatches through "
    "solve_lp_batch, whose batch_lp.vmapped_core span covers it",
)
def _ir_polish_screen_dense(device="cpu") -> IRCase:
    """The dense comparator of the ELL polish screen: the bucket core at the
    stacked two-sided master's shape (4 lanes of a 128-type, 256-column
    face: G is the dense ``[2T, C+1]`` block)."""
    T, C = 128, 256
    return _ir_bucket(62, device, 4, C + 1, 2 * T, 1)


@register_ir_core("batch_lp.polish_screen_ell", dense_ref="batch_lp.polish_screen_dense",
                  span="batch_lp.polish_screen_ell")
def _ir_polish_screen_ell(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.lint.operands import ell_operands, two_sided_lanes
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import two_sided_first_block

    r = Seeded(63, device)
    B, T, C, kp = 4, 128, 256, 16
    idx, val = ell_operands(r, C, T, kp)
    family = "batch_lp.polish_ell[" + ",".join(str(v) for v in _IR_KW) + "]"
    return IRCase(
        fn=two_sided_first_block, args=(r.t(idx), r.t(val)) + two_sided_lanes(r, T, C, B),
        static=dict(check_every=_IR_KW[1], graph=False, family=family,
                    csr=csr_to_device(idx, val, T, r.device)),
        device=str(device), graph=family,
    )


def mesh_bucket(c, G, h, A, b, *, mesh, max_iters: int, device):
    """A stacked bucket through the engine over ``mesh``: each rank solves
    its own lanes (``_own_lanes``) for a fixed ``max_iters`` (``tol=0``) and
    the solutions are gathered back to every rank."""
    from citizensassemblies_tpu_torch.utils.config import default_config

    problems = [BatchLP(c=c[i], G=G[i], h=h[i], A=A[i], b=b[i], tol=0.0) for i in range(len(c))]
    return solve_lp_batch(problems, cfg=default_config(), max_iters=max_iters, device=device,
                          mesh=mesh, defer=False)


@register_spmd_core("batch_lp.vmapped_core")
def _spmd_batch_core(mesh, device="cpu", scale: int = 1) -> IRCase:
    """Eight lanes over the swept world. The port deals the lanes by rank
    (their ids in the ``bucket`` layout) and hands each rank its own lanes'
    operands whole, so no operand is placed and none declares a role."""
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.lint.operands import dense_lp_operands

    ops = [a.cpu().numpy() for a in dense_lp_operands(Seeded(64, "cpu"), 65, 64, 1, lanes=8)[:5]]
    return IRCase(fn=mesh_bucket, args=tuple(ops),
                  static=dict(mesh=mesh, max_iters=_IR_KW[1] * int(scale), device=device),
                  device=str(device))
