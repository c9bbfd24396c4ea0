"""Mid-run checkpoints of LEXIMIN's column-generation state.

The agent-space CG state (portfolio, fixed probabilities, coverage mask,
the sampler's generator state and counters) is saved at each outer-round
boundary, and the type-space state (compositions, relaxation targets,
coverable types) before the face decomposition, each as one ``.npz`` with
an atomic write (tmp + rename, so a crash mid-save never corrupts the
previous checkpoint). A run given the same ``checkpoint_path`` resumes from
it; a finished run removes it. A checkpoint only resumes into the same
problem (:func:`problem_fingerprint`).

``key`` holds the pricing draws' ``torch.Generator`` state
(``Generator.get_state()`` bytes, uint8); a two-word integer key
``[0, s]``, the layout of a JAX ``PRNGKey(s)``, seeds the generator with
``s`` instead (:func:`restore_generator`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class CGState:
    """Agent-space column-generation state at an outer-round boundary."""

    portfolio: np.ndarray  # bool[|C|, n]
    fixed: np.ndarray  # float64[n]; < 0: not yet fixed
    covered: np.ndarray  # bool[n]
    key: np.ndarray  # generator state (see the module docstring)
    reduction_counter: int = 0
    dual_solves: int = 0
    exact_prices: int = 0
    #: hash of (instance, config, households): see problem_fingerprint
    fingerprint: str = ""


def problem_fingerprint(dense, cfg, households=None) -> str:
    """Digest of what determines the CG trajectory: incidence matrix,
    quotas, k, solver config, household groups. A checkpoint written under
    any other problem must not resume."""
    h = hashlib.sha256()
    h.update(dense.A_np.astype(np.uint8).tobytes())
    h.update(dense.qmin_np.tobytes())
    h.update(dense.qmax_np.tobytes())
    h.update(str(dense.k).encode())
    h.update(repr(cfg).encode())
    if households is not None:
        h.update(np.asarray(households, dtype=np.int64).tobytes())
    return h.hexdigest()


def generator_key(generator: torch.Generator) -> np.ndarray:
    """The generator's state as the uint8 ``key`` of a checkpoint."""
    return generator.get_state().numpy().copy()


def restore_generator(generator: torch.Generator, key) -> torch.Generator:
    """Put ``key`` (a checkpoint's) into ``generator``: a uint8 state of the
    generator's own size is set as it is; any other key seeds it with its
    last word."""
    key = np.asarray(key)
    state = generator.get_state()
    if key.dtype == np.uint8 and key.size == state.numel():
        generator.set_state(torch.from_numpy(key.copy()))
    else:
        generator.manual_seed(int(key.reshape(-1)[-1]))
    return generator


def _save(path: Union[str, Path], **arrays) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)


def save_cg_state(path: Union[str, Path], state: CGState) -> None:
    _save(
        path,
        portfolio=state.portfolio.astype(bool),
        fixed=state.fixed.astype(np.float64),
        covered=state.covered.astype(bool),
        key=np.asarray(state.key),
        counters=np.asarray(
            [state.reduction_counter, state.dual_solves, state.exact_prices], dtype=np.int64
        ),
        fingerprint=np.frombuffer(state.fingerprint.encode(), dtype=np.uint8),
    )


def load_cg_state(path: Union[str, Path], n: int, fingerprint: str = "") -> Optional[CGState]:
    """The checkpoint at ``path`` when it exists and was written for the
    same problem (pool size ``n`` and, when given, the same
    :func:`problem_fingerprint`). A checkpoint of another problem, or a
    corrupt file, is ignored: the caller starts fresh."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            portfolio = z["portfolio"]
            if portfolio.ndim != 2 or portfolio.shape[1] != n:
                return None
            stored_fp = bytes(z["fingerprint"]).decode() if "fingerprint" in z else ""
            if fingerprint and stored_fp != fingerprint:
                return None
            counters = z["counters"]
            return CGState(
                portfolio=portfolio.astype(bool),
                fixed=z["fixed"],
                covered=z["covered"],
                key=z["key"],
                reduction_counter=int(counters[0]),
                dual_solves=int(counters[1]),
                exact_prices=int(counters[2]),
                fingerprint=stored_fp,
            )
    except Exception:
        return None


def clear_cg_state(path: Union[str, Path]) -> None:
    Path(path).unlink(missing_ok=True)


@dataclasses.dataclass
class TypeCGState:
    """Type-space state before the face decomposition (the many-type
    LEXIMIN path, ``solvers/cg_typespace.py``)."""

    compositions: np.ndarray  # int32[C, T]
    v_relax: np.ndarray  # float64[T] relaxation-leximin targets
    coverable: np.ndarray  # bool[T]
    key: np.ndarray  # see the module docstring
    round: int = 0
    fingerprint: str = ""


def save_ts_state(path: Union[str, Path], state: TypeCGState) -> None:
    _save(
        path,
        kind=np.asarray([1], dtype=np.int8),  # tells it from a CGState file
        compositions=state.compositions.astype(np.int32),
        v_relax=state.v_relax.astype(np.float64),
        coverable=state.coverable.astype(bool),
        key=np.asarray(state.key),
        round=np.asarray([state.round], dtype=np.int64),
        fingerprint=np.frombuffer(state.fingerprint.encode(), dtype=np.uint8),
    )


def load_ts_state(path: Union[str, Path], T: int, fingerprint: str = "") -> Optional[TypeCGState]:
    """The type-space checkpoint at ``path`` for ``T`` types and, when
    given, the same fingerprint; else None."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            if "kind" not in z or "compositions" not in z:
                return None
            comps = z["compositions"]
            if comps.ndim != 2 or comps.shape[1] != T:
                return None
            stored_fp = bytes(z["fingerprint"]).decode() if "fingerprint" in z else ""
            if fingerprint and stored_fp != fingerprint:
                return None
            return TypeCGState(
                compositions=comps.astype(np.int32),
                v_relax=z["v_relax"],
                coverable=z["coverable"],
                key=z["key"],
                round=int(z["round"][0]),
                fingerprint=stored_fp,
            )
    except Exception:
        return None
