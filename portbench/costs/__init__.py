"""The yardstick of the kernels' roofline shares: frozen copies of the
port's cost formulas (``obs/roofline``: ``gather_cost``, ``two_sided_cost``,
``lp_cost``, ``_evals``, ``bound``) and the card's published peaks.

A cost counts each input byte read once and each output byte written once,
and the float32 operations the call's shapes and iterations need; the bound
is the larger of its bytes over the HBM rate and its operations over the
float32 peak. ``test_portbench_costs.py`` holds these equal to the port's
today; the port may change its own, the benchmark keeps these.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

#: NVIDIA H100 SXM5 80GB (HBM3) data sheet, at its 700 W limit: HBM bytes/s
#: and float32 FLOP/s outside the tensor cores; the bf16 tensor-core rate
#: (dense) for reference
PEAKS = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,
    "bf16_tensor_flops_per_s": 989e12,
}
HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
F32_FLOPS_PER_S = PEAKS["f32_flops_per_s"]


class Cost(NamedTuple):
    """One call's float32 operations and bytes, and (iterative solves) the
    bytes of re-reading the operator once per evaluation."""

    flops: float
    bytes: float
    stream_bytes: float = 0.0


def bound(cost: Cost) -> Tuple[float, str]:
    """``(bound_ms, "bytes" | "operations")``: the least time the card
    could take for ``cost`` and which of the two sets it."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S
    t_ops = cost.flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gather_cost(C: int, kp: int, T: int, lanes: int = 1, value_bytes: int = 4,
                lane_values: bool = False) -> Cost:
    """The packed gather ``z[b, c] = Σ_s val[c, s]·y[b, idx[c, s]]``: int32
    indices and the values read once (one set per lane with
    ``lane_values``), each lane's ``y`` read and ``z`` written once; a
    multiply and an add per slot and lane."""
    sets = lanes if lane_values else 1
    nbytes = C * kp * 4 + sets * C * kp * value_bytes + lanes * (T * 4 + C * 4)
    return Cost(flops=2.0 * C * kp * lanes, bytes=float(nbytes), stream_bytes=float(nbytes))


def _evals(iters, check_every: int) -> int:
    """Operator evaluations of solves of ``iters`` iterations: one an
    iteration and two KKT evaluations a block."""
    its = [int(i) for i in (iters if isinstance(iters, (list, tuple)) else [iters])]
    return sum(i + 2 * (i // int(check_every)) for i in its)


def two_sided_cost(C: int, kp: int, T: int, nnz: int, lanes: int, iters,
                   check_every: int) -> Cost:
    """A ``lanes``-lane two-sided solve whose lanes took ``iters``: inputs
    read once (the shared indices, every lane's scaled values, the lane
    vectors) and outputs written once, against per evaluation both matvec
    directions over the nonzeros (a multiply and an add each) and about ten
    operations per entry of the C- and T-length vectors."""
    nbytes = C * kp * 4 * (1 + lanes) + lanes * (4 * C + 6 * T) * 4
    evals = _evals(iters, check_every)
    flops = evals * (4 * nnz + 10 * (C + 2 * T))
    return Cost(float(flops), float(nbytes), float(evals * (C * kp * 8 + nnz * 8)))


def lp_cost(m1: int, kp: int, nv: int, nnz: int, iters, check_every: int = 128) -> Cost:
    """A generic-LP solve of ``iters`` iterations on an ELL pack of ``m1``
    rows: inputs read once and outputs written once, against per evaluation
    both matvec directions over the nonzeros and about ten operations per
    entry of the nv- and m1-length vectors."""
    nbytes = m1 * kp * 8 + (4 * nv + 3 * m1 + 2 * nv + 4) * 4
    evals = _evals(iters, check_every)
    flops = evals * (4 * nnz + 10 * (nv + m1))
    return Cost(float(flops), float(nbytes), float(evals * (m1 * kp * 8 + nnz * 8)))
