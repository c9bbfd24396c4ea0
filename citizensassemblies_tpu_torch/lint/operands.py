"""Seeded operands of the registered cores' build functions (``lint/registry.py``).

Every build function makes its operands here, from a numpy generator of its own
seed, on the device it is asked for, so a core is built the same on the CPU
and on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: the JAX registrations' ``arg_ranges`` triples ``(lo, hi, exact)``
RANGE_WIDE = (-1e4, 1e4, False)
RANGE_COUNTS = (0.0, 256.0, True)
RANGE_UNIT = (0.0, 1.0, False)
RANGE_TOL = (1e-8, 1e-2, False)


class Seeded:
    """Operands from ``np.random.default_rng(seed)`` on ``device``."""

    def __init__(self, seed: int, device="cpu"):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def t(self, a, dtype=None) -> torch.Tensor:
        """A host array on the device (``dtype`` a torch dtype)."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    def f32(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """Uniform float32 in ``[lo, hi)``."""
        return self.t(self.rng.uniform(lo, hi, shape).astype(np.float32))

    def counts(self, shape, hi: int, p_zero: float = 0.0) -> np.ndarray:
        """Small non-negative integers as float32 (exact at bf16), a
        ``p_zero`` share of them zero; a host array."""
        a = self.rng.integers(1, hi + 1, shape).astype(np.float32)
        if p_zero:
            a[self.rng.random(shape) < p_zero] = 0.0
        return a

    def ints(self, shape, hi: int, lo: int = 0, dtype=torch.int32) -> torch.Tensor:
        """Uniform integers in ``[lo, hi)``."""
        return self.t(self.rng.integers(lo, hi, shape), dtype=dtype)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def full(self, shape, value: float, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def ell_operands(r, rows: int, minor: int, kp: int, p_zero: float = 0.5):
    """A seeded ELL pack (``r``: :class:`Seeded`):
    ``rows`` rows of ``kp`` distinct sorted minor indices with small-integer
    values, a ``p_zero`` share zero. Returns host ``(idx int32, val
    float32)``."""
    idx = np.sort(np.argsort(r.rng.random((rows, minor)), axis=1)[:, :kp], axis=1).astype(np.int32)
    return idx, r.counts((rows, kp), 3, p_zero)


def two_sided_lanes(r, T: int, C: int, B: int = 1):
    """``(v, colmask, x0, lam0, mu0, tol)`` of ``B`` cold lanes."""
    return (r.f32(T), r.ones((B, C)), r.zeros((B, C + 1)), r.zeros((B, 2 * T)), r.zeros(B),
            r.full((B,), 1e-6))


TWO_SIDED_RANGES = (None, RANGE_COUNTS, RANGE_UNIT, RANGE_UNIT, RANGE_WIDE, RANGE_WIDE,
                    RANGE_WIDE, RANGE_TOL)
LP_RANGES = (RANGE_WIDE, RANGE_COUNTS, RANGE_WIDE, RANGE_COUNTS, RANGE_WIDE, RANGE_WIDE,
             RANGE_WIDE, RANGE_WIDE, RANGE_TOL)


def dense_lp_operands(r, nv: int, m1: int, m2: int, lanes: Optional[int] = None):
    """``(c, G, h, A, b, x0, lam0, mu0, tol)`` of a seeded dense LP (stacked
    over ``lanes`` when given)."""
    lead = () if lanes is None else (int(lanes),)
    return (r.f32(lead + (nv,), -1.0, 1.0), r.t(r.counts(lead + (m1, nv), 3, 0.5)),
            r.f32(lead + (m1,), 0.5, 1.5), r.ones(lead + (m2, nv)), r.ones(lead + (m2,)),
            r.zeros(lead + (nv,)), r.zeros(lead + (m1,)), r.zeros(lead + (m2,)),
            r.full(lead, 1e-6))
