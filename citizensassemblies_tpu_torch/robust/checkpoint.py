"""Crash-consistent checkpoints of the face-decomposition loop.

The face loop's certified state (the portfolio columns, the current mixture
and its arithmetic ε: the acceptance certificate is ``‖M p − v‖∞``, so the
snapshot is certified by construction, not by trusting a solver) is saved
every N rounds (``Config.robust_checkpoint_every``) with an atomic
tmp-then-rename write, and :func:`load_face_state` resumes only into the
same (reduction, profile, acceptance bar), checked by a content
fingerprint. The file layout is the JAX package's, so either package
reads the other's snapshots.

The port's snapshot is taken at the top of a round and also carries the
loop's whole state there (:class:`FaceLoopState`: the round's column set,
the master's warm iterate, the running best and history, the pricing
stream's generator and its in-flight anchor batch, the polish screen's warm
slots), so a resumed run replays the uninterrupted run's remaining rounds
and returns its result. A snapshot without that state (the JAX package's)
resumes the JAX package's way: its hull first, the first master warm from
its mixture, which lands in the same contract band but not on the same
mixture.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass
class FaceSubmit:
    """An anchor batch submitted at the end of a round and not yet
    harvested: the arguments of ``_AnchorPricer.submit`` and the pricing
    generator's state before it drew the batch's noise."""

    rnd: int
    r_norm: np.ndarray  # float64 [T]
    eps: float
    realized: Optional[np.ndarray]  # float64 [T] or None
    rng_state: dict


@dataclasses.dataclass
class FaceLoopState:
    """The face loop's state at the top of round ``next_round``: what the
    rounds from there on read."""

    next_round: int
    cols: np.ndarray  # int16 [N, T]: the round's master columns, in order
    p: np.ndarray  # float64: the last master's mixture
    eps: float  # and its residual
    eps_hist: np.ndarray  # float64: every round's residual
    warm: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # master warm (x, λ, μ)
    stall: Tuple[float, int]  # _WarmStall (best, streak)
    polish_after: int
    lp_solves: int
    rng_state: dict  # the pricing generator at the top of the round
    pending: Optional[FaceSubmit]
    device_degraded: bool  # device pricing dropped by an injected fault
    ell_kpad: int  # the incremental ELL pack's slot width (-1: no pack)
    slots: Dict[int, tuple]  # the polish screen's warm slots (position → slot)
    elapsed: float  # seconds of the loop before the snapshot


@dataclasses.dataclass
class FaceCGState:
    """The face loop's certified state at a round boundary."""

    compositions: np.ndarray  # int [C, T]
    probabilities: np.ndarray  # float64 [C]: the mixture p (certified)
    eps: float  # its arithmetic residual ‖M p − v‖∞ at save time
    round: int
    fingerprint: str = ""
    loop: Optional[FaceLoopState] = None  # the port's round-top loop state


def face_fingerprint(reduction, v: np.ndarray, accept: float) -> str:
    """Digest of what pins the face problem: the type reduction (features,
    quotas, sizes, k), the target profile and the acceptance bar."""
    h = hashlib.sha256()
    h.update(np.asarray(reduction.type_feature, dtype=np.int64).tobytes())
    h.update(np.asarray(reduction.qmin, dtype=np.int64).tobytes())
    h.update(np.asarray(reduction.qmax, dtype=np.int64).tobytes())
    h.update(np.asarray(reduction.msize, dtype=np.int64).tobytes())
    h.update(str(int(reduction.k)).encode())
    h.update(np.asarray(v, dtype=np.float64).tobytes())
    h.update(repr(float(accept)).encode())
    return h.hexdigest()


def save_face_state(path: Union[str, Path], state: FaceCGState) -> None:
    """Atomic write (tmp + rename): a crash mid-save never corrupts the
    previous checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    extra = _loop_arrays(state.loop) if state.loop is not None else {}
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            kind=np.asarray([2], dtype=np.int8),  # face-state marker
            compositions=state.compositions.astype(np.int32),
            probabilities=state.probabilities.astype(np.float64),
            eps=np.asarray([state.eps], dtype=np.float64),
            round=np.asarray([state.round], dtype=np.int64),
            fingerprint=np.frombuffer(state.fingerprint.encode(), dtype=np.uint8),
            **extra,
        )
    os.replace(tmp, path)


def _text(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _untext(arr: np.ndarray):
    return json.loads(bytes(arr).decode())


def _loop_arrays(loop: FaceLoopState) -> Dict[str, np.ndarray]:
    """The loop state as ``loop_*`` arrays beside the JAX package's keys
    (which ignores them); the scalars and generator states as one JSON
    record."""
    meta = dict(
        next_round=int(loop.next_round), eps=float(loop.eps),
        stall=[float(loop.stall[0]), int(loop.stall[1])],
        polish_after=int(loop.polish_after), lp_solves=int(loop.lp_solves),
        rng_state=loop.rng_state, device_degraded=bool(loop.device_degraded),
        ell_kpad=int(loop.ell_kpad), elapsed=float(loop.elapsed),
        warm=loop.warm is not None, slots=[],
        pending=None,
    )
    out = dict(
        loop_cols=np.asarray(loop.cols, dtype=np.int16),
        loop_p=np.asarray(loop.p, dtype=np.float64),
        loop_eps_hist=np.asarray(loop.eps_hist, dtype=np.float64),
    )
    if loop.warm is not None:
        for name, a in zip(("x", "lam", "mu"), loop.warm):
            out[f"loop_warm_{name}"] = np.asarray(a)
    for j, (pos, (x, lam, mu, tail)) in enumerate(sorted(loop.slots.items())):
        meta["slots"].append([int(pos), int(tail)])
        for name, a in zip(("x", "lam", "mu"), (x, lam, mu)):
            out[f"loop_slot{j}_{name}"] = np.asarray(a)
    if loop.pending is not None:
        q = loop.pending
        meta["pending"] = dict(rnd=int(q.rnd), eps=float(q.eps), rng_state=q.rng_state)
        out["loop_pending_r_norm"] = np.asarray(q.r_norm, dtype=np.float64)
        if q.realized is not None:
            out["loop_pending_realized"] = np.asarray(q.realized, dtype=np.float64)
    out["loop_meta"] = _text(meta)
    return out


def _loop_state(z) -> Optional[FaceLoopState]:
    if "loop_meta" not in z:
        return None
    meta = _untext(z["loop_meta"])
    pending = None
    if meta["pending"] is not None:
        q = meta["pending"]
        pending = FaceSubmit(
            rnd=q["rnd"], r_norm=z["loop_pending_r_norm"], eps=q["eps"],
            realized=z["loop_pending_realized"] if "loop_pending_realized" in z else None,
            rng_state=q["rng_state"],
        )
    warm = (
        tuple(z[f"loop_warm_{name}"] for name in ("x", "lam", "mu")) if meta["warm"] else None
    )
    slots = {
        pos: (*(z[f"loop_slot{j}_{name}"] for name in ("x", "lam", "mu")), tail)
        for j, (pos, tail) in enumerate(meta["slots"])
    }
    return FaceLoopState(
        next_round=meta["next_round"], cols=z["loop_cols"], p=z["loop_p"], eps=meta["eps"],
        eps_hist=z["loop_eps_hist"], warm=warm, stall=tuple(meta["stall"]),
        polish_after=meta["polish_after"], lp_solves=meta["lp_solves"],
        rng_state=meta["rng_state"], pending=pending,
        device_degraded=meta["device_degraded"], ell_kpad=meta["ell_kpad"], slots=slots,
        elapsed=meta["elapsed"],
    )


def load_face_state(path: Union[str, Path], T: int, fingerprint: str = "") -> Optional[FaceCGState]:
    """The face checkpoint at ``path`` when it exists and was written for
    the same problem; a mismatched or corrupt file is ignored (the caller
    starts fresh), never an error."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            if "kind" not in z or int(z["kind"][0]) != 2:
                return None
            comps = z["compositions"]
            if comps.ndim != 2 or comps.shape[1] != T:
                return None
            stored_fp = bytes(z["fingerprint"]).decode() if "fingerprint" in z else ""
            if fingerprint and stored_fp != fingerprint:
                return None
            probs = z["probabilities"]
            if probs.shape[0] != comps.shape[0]:
                return None
            return FaceCGState(
                compositions=comps.astype(np.int32),
                probabilities=probs.astype(np.float64),
                eps=float(z["eps"][0]),
                round=int(z["round"][0]),
                fingerprint=stored_fp,
                loop=_loop_state(z),
            )
    except Exception:
        return None


def clear_face_state(path: Union[str, Path]) -> None:
    Path(path).unlink(missing_ok=True)


class FaceCheckpointer:
    """The face loop's checkpoints: the path from the config
    (``robust_checkpoint_dir``/``face_<fp16>.npz``), a matching snapshot
    loaded on entry, the running best certified state (with the loop state
    of the next round's top) saved after every ``robust_checkpoint_every``
    rounds, and the file removed once the loop returns a certified result
    (a finished run leaves no stale resume point for the next run of the
    same problem)."""

    def __init__(self, cfg, reduction, v: np.ndarray, accept: float):
        self.every = int(getattr(cfg, "robust_checkpoint_every", 0) or 0)
        ckpt_dir = str(getattr(cfg, "robust_checkpoint_dir", "") or "")
        self.enabled = self.every > 0 and bool(ckpt_dir)
        self.path: Optional[Path] = None
        self.fingerprint = ""
        self._last_saved_round = -1
        if not self.enabled:
            return
        self.fingerprint = face_fingerprint(reduction, v, accept)
        self.path = Path(ckpt_dir) / f"face_{self.fingerprint[:16]}.npz"

    def load(self, T: int) -> Optional[FaceCGState]:
        if not self.enabled:
            return None
        state = load_face_state(self.path, T, self.fingerprint)
        if state is not None:
            # the loaded round is already on disk
            self._last_saved_round = state.round
        return state

    def due(self, rnd: int) -> bool:
        """Whether :meth:`maybe_save` of round ``rnd`` would write."""
        return self.enabled and rnd != self._last_saved_round and rnd % self.every == 0

    def maybe_save(
        self, rnd: int, comps: np.ndarray, p: np.ndarray, eps: float, log=None,
        loop: Optional[FaceLoopState] = None,
    ) -> bool:
        """Save after round ``rnd`` (every N rounds, once a round); the
        state handed in is the loop's running best, certified by its
        arithmetic residual, and the loop state to resume from."""
        if not self.due(rnd):
            return False
        self._last_saved_round = rnd
        save_face_state(
            self.path,
            FaceCGState(
                compositions=np.asarray(comps),
                probabilities=np.asarray(p, dtype=np.float64),
                eps=float(eps),
                round=int(rnd),
                fingerprint=self.fingerprint,
                loop=loop,
            ),
        )
        if log is not None:
            log.count("robust_checkpoint_saved")
        return True

    def clear(self) -> None:
        if self.enabled and self.path is not None:
            clear_face_state(self.path)
