"""Structured-sparse (fixed-nnz ELL) operators for the PDHG cores.

The decomposition master's columns are panel *compositions*: at most ``k``
nonzeros out of ``T`` types, so dense matvecs are mostly multiply-by-zero.

* **ELL layout** — a ``[major, minor]`` matrix with at most ``k_pad``
  nonzeros per major row is stored as ``indices[major, k_pad]`` (int32
  minor positions) and ``values[major, k_pad]`` (float32 on the host; a
  demoted operand goes to the device as bf16, ``utils/precision.py``),
  padding slots pointing at minor 0 with value 0.0 — inert for both matvec
  directions.
* **matvecs** — the gather direction ``(M x)[j] = Σ_s values[j,s] ·
  x[indices[j,s]]`` (:func:`ell_gather_mv`, the hand-written CUDA kernel
  on CUDA tensors, ``kernels/ell_matvec.py``) and the scatter/transpose
  direction (:func:`ell_scatter_mv`, ``index_add_``).
* **Ruiz on the ELL rep** — row/column ∞-norms from per-row maxima and a
  ``scatter_reduce`` max over the packed values.
* **incremental append** — :class:`EllPack` keeps the packed arrays on the
  host as numpy and re-packs ONLY new major rows as a portfolio grows.

Routing: ``Config.sparse_ops`` is a tri-state — ``True`` forces the ELL
path, ``False`` forces dense, ``None`` engages ELL exactly when the
measured fill is ≤ ``Config.sparse_fill_cutoff``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.kernels.ell_matvec import ell_gather_mv
from citizensassemblies_tpu_torch.utils.config import Config
from citizensassemblies_tpu_torch.utils.precision import iterate_dtype

__all__ = [
    "EllPack", "ell_gather_mv", "ell_pack_rows", "ell_row_absmax",
    "ell_ruiz_equilibrate", "ell_scatter_mv", "ell_unpack_rows",
    "sparse_enabled",
]

#: packed-slot granularity: k_pad rounds up to a multiple of 8 so slot
#: growth across CG rounds re-buckets rarely
_SLOT_ROUND = 8


def _round_slots(k: int) -> int:
    return max(_SLOT_ROUND, -(-int(k) // _SLOT_ROUND) * _SLOT_ROUND)


def sparse_enabled(cfg: Optional[Config], fill: float) -> bool:
    """Resolve the ``Config.sparse_ops`` tri-state for a measured fill.

    ``True``/``False`` force; ``None`` (auto) turns the ELL path on exactly
    when the measured fill ratio is at or below
    ``Config.sparse_fill_cutoff`` — the regime where the gather/scatter
    matvecs beat the dense GEMV on both FLOPs and HBM bytes.
    """
    knob = getattr(cfg, "sparse_ops", None)
    if knob is not None:
        return bool(knob)
    cutoff = float(getattr(cfg, "sparse_fill_cutoff", 0.25))
    return float(fill) <= cutoff


def ell_pack_rows(
    rows: np.ndarray, k_pad: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack the rows of a dense ``[J, minor]`` array into ELL arrays.

    Returns ``(indices int32 [J, k_pad], values float32 [J, k_pad],
    nnz int64 [J])``. Nonzeros keep their original (ascending-minor) order —
    a stable argsort on the zero mask, so the pack/unpack round trip is
    exact. ``k_pad`` defaults to the max row nnz rounded up to a slot
    multiple; passing a larger one keeps bucket shapes stable across
    appends. Raises when a row has more nonzeros than ``k_pad``.
    """
    rows = np.asarray(rows)
    J, minor = rows.shape
    mask = rows != 0
    nnz = mask.sum(axis=1).astype(np.int64)
    need = int(nnz.max()) if J else 0
    kp = _round_slots(max(need, 1)) if k_pad is None else int(k_pad)
    if need > kp:
        raise ValueError(f"row nnz {need} exceeds the ELL slot count {kp}")
    take = min(kp, minor)
    # stable sort on the zero mask: nonzero positions first, original order
    order = np.argsort(~mask, axis=1, kind="stable")[:, :take]
    vals = np.take_along_axis(rows, order, axis=1)
    slot = np.arange(take)[None, :]
    keep = slot < nnz[:, None]
    idx = np.where(keep, order, 0).astype(np.int32)
    val = np.where(keep, vals, 0.0).astype(np.float32)
    if take < kp:  # minor smaller than the slot bucket: pad inert slots
        idx = np.pad(idx, ((0, 0), (0, kp - take)))
        val = np.pad(val, ((0, 0), (0, kp - take)))
    return idx, val, nnz


def ell_unpack_rows(idx: np.ndarray, val: np.ndarray, minor: int) -> np.ndarray:
    """Dense ``[J, minor]`` reconstruction of packed rows (tests/fuzz)."""
    J = idx.shape[0]
    out = np.zeros((J, minor), dtype=np.float64)
    rows = np.repeat(np.arange(J), idx.shape[1])
    np.add.at(out, (rows, idx.ravel()), val.ravel().astype(np.float64))
    return out


@dataclasses.dataclass
class EllPack:
    """Host-side ELL pack of a *growing* set of sparse major rows.

    The face-decomposition loop adds a few thousand columns per round and
    prunes back to the mass-bearing support; re-packing the whole portfolio
    every round would repeat O(C·T) host work that the incremental contract
    avoids: :meth:`append` packs only the NEW rows (growing the shared slot
    count when a new row needs it, which only zero-pads the existing
    arrays), and :meth:`take` subsets by fancy indexing. ``fill`` is the
    measured nnz ratio the auto gate routes on, and ``pack_rows`` counts
    how many rows were ever packed (the bench's pack-overhead counter
    rides the ``sparse_pack`` timer at the call sites).
    """

    minor: int
    idx: np.ndarray = None  # [J, k_pad] int32
    val: np.ndarray = None  # [J, k_pad] float32
    nnz_total: int = 0
    pack_rows: int = 0

    def __post_init__(self):
        if self.idx is None:
            self.idx = np.zeros((0, _SLOT_ROUND), dtype=np.int32)
        if self.val is None:
            self.val = np.zeros((0, _SLOT_ROUND), dtype=np.float32)

    def __len__(self) -> int:
        return self.idx.shape[0]

    @property
    def k_pad(self) -> int:
        return self.idx.shape[1]

    @property
    def fill(self) -> float:
        J = len(self)
        return (self.nnz_total / (J * self.minor)) if J else 0.0

    @classmethod
    def from_rows(cls, rows: np.ndarray, minor: Optional[int] = None) -> "EllPack":
        pack = cls(minor=int(minor if minor is not None else rows.shape[1]))
        pack.append(rows)
        return pack

    def append(self, rows: np.ndarray) -> None:
        """Pack and append new major rows (the incremental-column contract)."""
        rows = np.asarray(rows)
        if rows.size == 0:
            return
        need = int((rows != 0).sum(axis=1).max())
        kp = max(self.k_pad, _round_slots(max(need, 1)))
        if kp > self.k_pad:  # grow the shared slot bucket: zero slots are inert
            grow = kp - self.k_pad
            self.idx = np.pad(self.idx, ((0, 0), (0, grow)))
            self.val = np.pad(self.val, ((0, 0), (0, grow)))
        idx, val, nnz = ell_pack_rows(rows, k_pad=kp)
        self.idx = np.concatenate([self.idx, idx], axis=0)
        self.val = np.concatenate([self.val, val], axis=0)
        self.nnz_total += int(nnz.sum())
        self.pack_rows += rows.shape[0]

    def take(self, sel: np.ndarray) -> "EllPack":
        """Subset (and reorder) the packed rows — a portfolio prune."""
        sel = np.asarray(sel)
        idx = self.idx[sel]
        val = self.val[sel]
        out = EllPack(minor=self.minor, idx=idx, val=val)
        out.nnz_total = int((val != 0).sum())
        out.pack_rows = self.pack_rows
        return out

    def padded(self, rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """(idx, val) zero-padded to ``rows`` major rows (bucket padding:
        all-zero rows are inert for both matvec directions)."""
        J = len(self)
        if rows < J:
            raise ValueError(f"pad target {rows} below packed row count {J}")
        if rows == J:
            return self.idx, self.val
        idx = np.zeros((rows, self.k_pad), dtype=np.int32)
        val = np.zeros((rows, self.k_pad), dtype=np.float32)
        idx[:J] = self.idx
        val[:J] = self.val
        return idx, val


# --- torch matvec primitives -------------------------------------------------


def ell_scatter_mv(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, minor: int) -> torch.Tensor:
    """``(Mᵀ y)[i] = Σ_{j,s: idx[j,s]=i} val[j,s]·y[j]`` via ``index_add_``.
    ``y`` is ``[major]`` or ``[B, major]``; ``val`` shared or ``[B, ...]``,
    float32 or bf16 (the products are float32 either way)."""
    dt = iterate_dtype(val.dtype)
    contrib = val.to(dt) * y[..., None]
    if contrib.dim() == 2:
        out = torch.zeros(int(minor), dtype=dt, device=contrib.device)
        return out.index_add_(0, idx.reshape(-1), contrib.reshape(-1))
    B = contrib.shape[0]
    out = torch.zeros((B, int(minor)), dtype=dt, device=contrib.device)
    return out.scatter_add_(1, idx.reshape(1, -1).expand(B, -1), contrib.reshape(B, -1))


def ell_row_absmax(idx: torch.Tensor, val: torch.Tensor, minor: int) -> torch.Tensor:
    """Per-MINOR max of |values| (0 for minors no slot hits). ``val`` is
    ``[major, k_pad]`` or ``[B, major, k_pad]``; a bf16 ``val`` gives
    float32 maxima."""
    dt = iterate_dtype(val.dtype)
    a = val.abs().to(dt)
    if a.dim() == 2:
        out = torch.zeros(int(minor), dtype=dt, device=a.device)
        return out.scatter_reduce_(0, idx.reshape(-1), a.reshape(-1), reduce="amax")
    B = a.shape[0]
    out = torch.zeros((B, int(minor)), dtype=dt, device=a.device)
    return out.scatter_reduce_(
        1, idx.reshape(1, -1).expand(B, -1), a.reshape(B, -1), reduce="amax"
    )


def ell_ruiz_equilibrate(idx: torch.Tensor, val: torch.Tensor, minor: int, iters: int = 8):
    """Ruiz row/column scalings ``(d_major, d_minor)`` computed on the ELL
    rep: ``d_major[j]·M[j, i]·d_minor[i]`` of ≈ unit row/col ∞-norms, the
    8-sweep sqrt scheme; all-zero rows/columns keep scale 1."""
    major = idx.shape[0]
    d_j = torch.ones(major, dtype=iterate_dtype(val.dtype), device=val.device)
    d_i = torch.ones(int(minor), dtype=iterate_dtype(val.dtype), device=val.device)
    absv = val.abs()
    for _ in range(iters):
        S = absv * d_j[:, None] * d_i[idx]
        jmax = S.amax(dim=1)
        imax = ell_row_absmax(idx, S, minor)
        jn = torch.where(jmax > 0, torch.sqrt(torch.clamp_min(jmax, 1e-10)), 1.0)
        inn = torch.where(imax > 0, torch.sqrt(torch.clamp_min(imax, 1e-10)), 1.0)
        d_j, d_i = d_j / jn, d_i / inn
    return d_j, d_i
