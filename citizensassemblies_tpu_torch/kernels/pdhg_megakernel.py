"""The PDHG block kernels: two hand-written CUDA kernels, one launch per solve.

**Two-sided master.**

The chained route (``solvers/lp_pdhg._two_sided_iterate``) runs each PDHG
iteration as a dozen small torch ops and reads every lane's residual on the
host after each block. The fused route here runs the whole block loop of a
solve — ``check_every`` iterations per block, the KKT of the current and the
averaged iterate, the restart, the ω rebalance, the sentinel freeze and the
per-lane active mask — inside ``csrc/two_sided_block.cu``, in one
cooperative launch that spreads each lane over a group of thread blocks
(at B=1 the one lane gets every block the card holds at once). It replaces
the JAX package's ``kernels/pdhg_megakernel.py:_two_sided_block_kernel``.

Around the kernel, in torch ops shared with the chained ELL route:

* :func:`two_sided_prelude` — Ruiz equilibration on the packed columns,
  the scaled data rows, per lane (the lanes of a batch share the pack and
  differ in their column masks);
* the power-iteration ‖K‖ estimate and the warm-start scaling
  (``solvers/lp_pdhg``) over :func:`ell_operators`: the adjoint by the ELL
  gather kernel, the forward product as a segment sum over the pack's
  type-major CSR transpose (:func:`csr_transpose`). Neither sums with
  atomics, so two preludes of the same inputs are bitwise equal.

The kernel takes the pack row-major (``[C, k_pad]``, for its adjoint
gather, one warp per column) and as the same CSR (for its forward product);
the CSR structure and the :class:`LaunchPlan` — blocks per lane, each
block's column and type tiles — are built on the host from the numpy pack,
so no step has a data-dependent shape and nothing synchronises before the
kernel.

**Generic-form LP** (``min cᵀx, Gx ≤ h, Ax = b, x ≥ 0``, G as packed ELL
rows): ``csrc/lp_block.cu`` runs the whole block loop of one solve in one
cooperative launch over a group of thread blocks, replacing the JAX
package's ``kernels/pdhg_megakernel.py:_lp_block_kernel``. Each block owns
a tile of rows and a tile of variables; the plan comes from the same
:func:`launch_plan` as the two-sided kernel's (rows in the place of its
columns, variables in the place of its types), and a small LP takes fewer
blocks (:func:`lp_block_count`). Around it, in torch ops shared with the
chained route ``solvers/lp_pdhg._pdhg_body_ell``: :func:`lp_setup` (Ruiz on
the stacked ``[G; A]``, the power-iteration ‖K‖, the scaled warm start).
The kernel takes the pack row-major (its ``G x``, one warp per row) and as
a variable-major CSR transpose built on the host (its ``Gᵀλ``, one or more
warps per variable). The torch ops take ``Gᵀλ`` over the same CSR
(:func:`lp_operators`), so no step of an LP solve sums with atomics and two
runs on the same inputs take the same iterations. x̄ takes one of two
routes (:func:`lp_stage_x`, the plan's ``stage_x``): every block stages
all of it in shared memory where it fits there beside λ; past that (the
nationwide dual LP's 100,001 variables) the rows read it where the
variable owners publish it in global memory, and a block reads its CSR
row pointer there too. The two routes give the same iterates
bit for bit, and a launch on the global route counts under
``lp_solve_launch.global_x``.

Gate (``Config.pdhg_megakernel``), for both kernels: ``None`` — the kernel
on CUDA when the solve fits (:func:`two_sided_fits`, :func:`lp_fits`);
``True`` — the kernel on CUDA tensors and its plain version
(:func:`two_sided_blocks_plain`, :func:`lp_blocks_plain`) on CPU tensors;
``False`` — the chained route. A shape that does not fit goes to the
chained route and is counted (``megakernel_fit_miss``).
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import functools
import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from citizensassemblies_tpu_torch.kernels.cuda_lib import CSRC, CudaLibrary, ptr, stream_of
from citizensassemblies_tpu_torch.kernels.ell_matvec import ell_gather_mv, ell_gather_mv_plain
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.obs.trace import DeviceValue
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers
from citizensassemblies_tpu_torch.utils import device as _device
from citizensassemblies_tpu_torch.utils.precision import host_float32, iterate_dtype, operand_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaLibrary(
    "two_sided_block",
    "two_sided_block.cu",
    ["ell_gather.cuh", "grid_sync.cuh", "two_sided_layout.cuh"],
    {
        "two_sided_solve_launch": (ctypes.c_int, [_P] * 20 + [_I] * 10 + [_P]),
        "two_sided_occupancy": (ctypes.c_int, [_I, _I, _P]),
        "two_sided_barrier_loop": (ctypes.c_int, [_P, _I, _I, _I, _P]),
    },
)


LP_KERNEL = CudaLibrary(
    "lp_block",
    "lp_block.cu",
    ["ell_gather.cuh", "grid_sync.cuh", "lp_layout.cuh"],
    {
        "lp_solve_launch": (ctypes.c_int, [_P] * 20 + [_I] * 10 + [_P]),
        "lp_occupancy": (ctypes.c_int, [_I, _I, _I, _P]),
    },
    units=["lp_block_global_x.cu"],
)


def _read_layout(header: str) -> Dict[str, int]:
    """A kernel's fit-rule constants and scalar-row slots, read from its
    layout header under ``csrc/`` (the one place they are defined)."""
    with open(os.path.join(CSRC, header)) as fh:
        text = fh.read()
    return {m[1]: int(m[2]) for m in re.finditer(r"^constexpr int (\w+) = (\d+);", text, re.M)}


LAYOUT = _read_layout("two_sided_layout.cuh")
LP_LAYOUT = _read_layout("lp_layout.cuh")

#: the counting suffix of an LP kernel launch on the global-x̄ route
#: (``LP_KERNEL.entry_launches`` key ``lp_solve_launch.global_x``)
GLOBAL_X_ROUTE = "global_x"

#: SM count of the H100 SXM: the card the gate assumes where it cannot ask
#: one (a CPU device), at one block per SM
H100_SMS = 132


def _round4(n: int) -> int:
    a = LAYOUT["kAlignFloats"]
    return (int(n) + a - 1) // a * a


def two_sided_smem_bytes(T: int, Cp: int, tile_floats: int = 0) -> int:
    """Shared memory one block of the kernel needs: the staged y and p-bar,
    the reduction scratch and ``tile_floats`` of resident pack (0 when the
    block streams its share from L2)."""
    L = LAYOUT
    return (
        L["kTVectors"] * _round4(T) + L["kCVectors"] * _round4(Cp) + L["kRedFloats"]
        + int(tile_floats)
    ) * 4


def two_sided_scratch_floats(T: int, Cp: int, blocks_per_lane: int) -> int:
    """Global float scratch of one lane: the kernel's C- and T-length
    vectors and its per-block partial sums."""
    L = LAYOUT
    return _round4(
        L["kScratchCVectors"] * _round4(Cp) + L["kScratchTVectors"] * _round4(T)
        + L["kSlots"] * int(blocks_per_lane)
    )


#: each kernel's occupancy query: its library and C entry point
_OCCUPANCY = {"two_sided": (KERNEL, "two_sided_occupancy"), "lp": (LP_KERNEL, "lp_occupancy")}


@functools.lru_cache(maxsize=None)
def _card_occupancy(kernel: str, device_index: int, smem: int, *flags: bool):
    """``(blocks per SM, SM count)`` of a solve kernel (``"two_sided"`` or
    ``"lp"``) with ``smem`` bytes of shared memory on a card; ``flags``
    pick its instance (resident or not and, for the LP kernel, x̄'s
    route)."""
    lib, entry = _OCCUPANCY[kernel]
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        lib.run(entry, int(smem), *(int(f) for f in flags), ctypes.cast(out, ctypes.c_void_p))
    return int(out[0]), int(out[1])


def _coresident(kernel: str, smem: int, device, *flags) -> int:
    """Blocks of a solve kernel resident at once with ``smem`` bytes each:
    the occupancy the C side reports times the SM count on a CUDA device;
    the H100's SM count at one block each elsewhere."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SMS
    per_sm, sms = _card_occupancy(
        kernel, dev.index if dev.index is not None else torch.cuda.current_device(),
        int(smem), *(bool(f) for f in flags),
    )
    return per_sm * sms


def coresident_blocks(T: int, Cp: int, device, tile_floats: int = 0) -> int:
    """Blocks of the two-sided solve kernel that are resident at once at
    (T, Cp) with ``tile_floats`` of resident pack (:func:`_coresident`)."""
    return _coresident("two_sided", two_sided_smem_bytes(T, Cp, tile_floats), device, tile_floats)


def two_sided_fits(T: int, Cp: int, lanes: int = 1, coresident: Optional[int] = None) -> bool:
    """The fit rule: a block's staged vectors fit its shared memory, and
    every lane gets at least one of the ``coresident`` blocks (the H100's
    SM count when not given)."""
    if two_sided_smem_bytes(T, Cp) > LAYOUT["kMaxSmem"]:
        return False
    return 1 <= int(lanes) <= (H100_SMS if coresident is None else int(coresident))


@dataclasses.dataclass
class LaunchPlan:
    """How a solve is spread over the card: ``lanes`` groups of
    ``blocks_per_lane`` blocks; block j of every group owns the columns
    ``col_bounds[j]:col_bounds[j+1]`` and the types
    ``type_bounds[j]:type_bounds[j+1]`` of its lane (for the LP kernel: its
    rows and its variables), and keeps its share of the pack resident in
    ``tile_floats`` of shared memory (0: it streams that share from L2)."""

    lanes: int
    blocks_per_lane: int
    col_bounds: np.ndarray
    type_bounds: np.ndarray
    tile_floats: int = 0
    #: the LP kernel's x̄ route: staged in every block's shared memory, or
    #: (False) read where it is published (:func:`lp_stage_x`)
    stage_x: bool = True
    #: the bounds as one int32 device vector, once :meth:`upload` ran
    bounds: Optional[torch.Tensor] = None

    @property
    def grid(self) -> int:
        return self.lanes * self.blocks_per_lane

    def upload(self, device) -> "LaunchPlan":
        self.bounds = torch.as_tensor(
            np.concatenate([self.col_bounds, self.type_bounds]).astype(np.int32), device=device
        )
        return self


@dataclasses.dataclass(frozen=True)
class TileRule:
    """What a block of a solve kernel keeps beside its share of the pack
    when it keeps that share resident: ``col_floats`` of state per owned
    column (LP: row), ``type_floats`` per owned type (LP: variable); the
    shared memory a block takes with ``tile`` resident floats
    (``smem_bytes``) against the most it may take (``max_smem``)."""

    col_floats: int
    type_floats: int
    smem_bytes: Callable[[int], int]
    max_smem: int


def two_sided_tile_rule(T: int, Cp: int) -> TileRule:
    """The two-sided kernel's :class:`TileRule` at (T, Cp)."""
    return TileRule(
        LAYOUT["kOwnCVectors"], LAYOUT["kOwnTVectors"],
        lambda tile: two_sided_smem_bytes(T, Cp, tile), LAYOUT["kMaxSmem"],
    )


def balanced_bounds(weight, tiles: int) -> np.ndarray:
    """Bounds of ``tiles`` contiguous tiles over items of integer
    ``weight`` whose heaviest tile is as light as it can be: the least cap
    under which filling the tiles in order, each as far as the cap allows,
    covers every item (a bisection between the even share and the even
    share plus the heaviest item). Tiles at the end may be empty. An item
    heavier than the even share so ends in a tile of its own, or beside
    light ones only."""
    w = np.asarray(weight, dtype=np.int64)
    n = len(w)
    if n == 0:
        return np.zeros(int(tiles) + 1, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(w)]).tolist()

    def fill(cap):
        bounds = [0]
        for _ in range(int(tiles)):
            b = bounds[-1]
            bounds.append(bisect.bisect_right(cum, cum[b] + cap) - 1)
        return bounds if bounds[-1] == n else None

    lo = max(int(w.max()), -(-int(cum[-1]) // int(tiles)))
    hi = lo + int(w.max())
    while lo < hi:
        mid = (lo + hi) // 2
        if fill(mid) is None:
            lo = mid + 1
        else:
            hi = mid
    return np.asarray(fill(lo), dtype=np.int64)


def launch_plan(lanes: int, T: int, Cp: int, coresident, rowptr=None, kp: Optional[int] = None,
                rule: Optional[TileRule] = None, blocks: Optional[int] = None) -> LaunchPlan:
    """The launch plan of a ``lanes``-lane solve over ``Cp`` columns and
    ``T`` types (the LP kernel: ``m1`` rows and ``nv`` variables) on a card
    that holds ``coresident`` blocks at once (a number, or a function of the
    resident tile's floats, as :func:`coresident_blocks`): the blocks split
    into equal lane groups of at most ``blocks`` each; each block gets an
    equal share of the columns and a contiguous run of types balanced by
    CSR entries (``rowptr``, the type-major transpose's row pointer; by
    count when absent), a type weighing its entries plus one warp's worth
    (:func:`balanced_bounds`). With ``rowptr`` and ``kp`` the blocks keep
    their shares of the pack and their own column and type state resident
    when the largest fits shared memory beside the staged vectors (``rule``:
    the two-sided kernel's by default); where the card holds fewer blocks
    with resident shares than streaming ones, the plan takes as many as
    hold theirs resident, when those still fit.
    Raises ``ValueError`` when the lanes outnumber the blocks (a fit miss)."""
    cores = coresident if callable(coresident) else (lambda tile: int(coresident))
    nb = int(cores(0)) // int(lanes)
    if blocks is not None:
        nb = min(nb, int(blocks))
    if nb < 1:
        raise ValueError(f"{lanes} lanes do not fit {cores(0)} co-resident blocks")
    rule = rule or two_sided_tile_rule(T, Cp)
    if rowptr is None:
        weight = np.ones(int(T), dtype=np.int64)
    else:
        weight = np.diff(np.asarray(rowptr, dtype=np.int64)) + 32

    def tiles(nb):
        col_bounds = (np.arange(nb + 1, dtype=np.int64) * int(Cp)) // nb
        type_bounds = balanced_bounds(weight, nb)
        tile = 0
        if rowptr is not None and kp is not None:
            rp = np.asarray(rowptr, dtype=np.int64)
            need = (
                2 * (np.diff(col_bounds) * int(kp) + np.diff(rp[type_bounds]))
                + rule.col_floats * np.diff(col_bounds) + rule.type_floats * np.diff(type_bounds)
            )
            tile = int(need.max())
        return col_bounds, type_bounds, tile

    def fits(tile):
        return bool(tile) and rule.smem_bytes(tile) <= rule.max_smem

    col_bounds, type_bounds, tile = tiles(nb)
    if fits(tile) and int(cores(tile)) < int(lanes) * nb:
        # the shares fit but the card holds fewer resident blocks than
        # streaming ones: as many blocks as hold their shares resident
        fewer = min(nb, int(cores(tile)) // int(lanes))
        if fewer >= 1:
            cb, tb, t = tiles(fewer)
            if fits(t) and int(cores(t)) >= int(lanes) * fewer:
                nb, col_bounds, type_bounds, tile = fewer, cb, tb, t
    if not (fits(tile) and int(cores(tile)) >= int(lanes) * nb):
        tile = 0
    return LaunchPlan(
        lanes=int(lanes), blocks_per_lane=nb, col_bounds=col_bounds.astype(np.int32),
        type_bounds=type_bounds.astype(np.int32), tile_floats=tile,
    )


def _gate(cfg: Optional[Config], fits, device, log) -> str:
    """``fits`` is called only when the gate would engage."""
    cfg = cfg or default_config()
    gate = cfg.pdhg_megakernel
    if gate is False or (gate is None and not _device.on_accelerator(device)):
        return "off"
    if not fits():
        if log is not None:
            log.count("megakernel_fit_miss")
        return "off"
    return "fused"


def megakernel_mode(cfg: Optional[Config], T: int, Cp: int, device, log=None, lanes: int = 1,
                    coresident: Optional[int] = None) -> str:
    """Resolve the tri-state gate for a ``lanes``-lane (T, Cp) master on
    ``device`` to ``"fused"`` or ``"off"``. ``coresident`` defaults to
    :func:`coresident_blocks` of the device. A gate that would engage but
    does not fit is counted as ``megakernel_fit_miss`` on ``log``."""

    def fits():
        if two_sided_smem_bytes(T, Cp) > LAYOUT["kMaxSmem"]:
            return False
        n = coresident if coresident is not None else coresident_blocks(T, Cp, device)
        return two_sided_fits(T, Cp, lanes, n)

    return _gate(cfg, fits, device, log)


#: The LP kernel's block count, from the pack entries an iteration reads
#: (both layouts). A solve of up to LP_ONE_BLOCK_ENTRIES runs on one block,
#: which exchanges nothing through global memory; a larger one takes a
#: block per LP_ENTRIES_PER_BLOCK, up to what the card holds. Set from the
#: card's µs an iteration across block counts (chip_lp_probe.py --sweep;
#: PERF.md §6): a 256-row n=120 dual (7.4k entries) is fastest on one
#: block, a 768-row one (22k) at 11-32 blocks, a sf_b dual (46k) at 20-32,
#: the flagship's (913k) at 132.
LP_ONE_BLOCK_ENTRIES = 16384
LP_ENTRIES_PER_BLOCK = 2048


def lp_smem_bytes(nv: int, m1: int, tile_floats: int = 0, stage_x: bool = True) -> int:
    """Shared memory one block of the LP kernel needs: the staged λ; with
    ``stage_x`` the staged x̄ and a CSR row pointer over all nv variables
    (without, the block reads both from global memory); the reduction
    scratch, μ and its companions, and ``tile_floats`` of resident pack and
    state (0 when the block streams them)."""
    L = LP_LAYOUT
    xv = L["kLpNvVectors"] * _round4(int(nv) + 1) if stage_x else 0
    return (
        L["kLpM1Vectors"] * _round4(m1) + xv + L["kLpRedFloats"]
        + L["kLpM2Vectors"] * L["kLpMaxM2"] + int(tile_floats)
    ) * 4


def lp_scratch_floats(nv: int, m1: int, blocks: int) -> int:
    """Global float scratch of one LP solve: the kernel's nv- and m1-length
    vectors and its per-block partial sums."""
    L = LP_LAYOUT
    return _round4(
        L["kLpScratchNvVectors"] * _round4(nv) + L["kLpScratchM1Vectors"] * _round4(m1)
        + L["kLpSlots"] * int(blocks)
    )


def lp_stage_x(nv: int, m1: int, stage_x: Optional[bool] = None) -> bool:
    """x̄'s route in the LP kernel at (nv, m1): ``stage_x`` None stages it
    in every block's shared memory where it fits there beside λ (True) and
    has the rows read it from global memory otherwise (False); True forces
    the staged route and raises ``ValueError`` where it does not fit, False
    forces the global one."""
    fits = lp_smem_bytes(nv, m1) <= LP_LAYOUT["kLpMaxSmem"]
    if stage_x and not fits:
        raise ValueError(
            f"the LP kernel cannot stage x-bar ({int(nv) + 1} floats) beside lambda ({m1}) "
            f"in {LP_LAYOUT['kLpMaxSmem']} bytes"
        )
    return fits if stage_x is None else bool(stage_x)


def lp_fits(nv: int, m1: int, m2: int) -> bool:
    """The LP kernel's fit rule: at most ``kLpMaxM2`` equality rows, and
    a block's staged λ fits its shared memory, beside the staged x̄ or, on
    the global-x̄ route, alone (one block, which the card always holds, is
    a legal plan on either route)."""
    return (
        0 <= int(m2) <= LP_LAYOUT["kLpMaxM2"]
        and lp_smem_bytes(nv, m1, stage_x=False) <= LP_LAYOUT["kLpMaxSmem"]
    )


def lp_coresident_blocks(nv: int, m1: int, device, tile_floats: int = 0,
                         stage_x: bool = True) -> int:
    """Blocks of the LP solve kernel that are resident at once at (nv, m1)
    with ``tile_floats`` of resident pack on x̄'s route (:func:`_coresident`)."""
    return _coresident(
        "lp", lp_smem_bytes(nv, m1, tile_floats, stage_x), device, tile_floats, stage_x
    )


def lp_block_count(m1: int, kp: int, nnz: int, coresident: int) -> int:
    """Blocks an LP solve takes, from the pack entries an iteration reads
    (``m1 · kp`` row slots and ``nnz`` CSR entries): one up to
    ``LP_ONE_BLOCK_ENTRIES``, else one per ``LP_ENTRIES_PER_BLOCK``, at
    most ``coresident``."""
    work = int(m1) * int(kp) + int(nnz)
    if work <= LP_ONE_BLOCK_ENTRIES:
        return 1
    return max(1, min(int(coresident), -(-work // LP_ENTRIES_PER_BLOCK)))


def lp_launch_plan(nv: int, m1: int, m2: int, kp: int, rowptr, coresident,
                   blocks: Optional[int] = None, stage_x: Optional[bool] = None) -> LaunchPlan:
    """:func:`launch_plan` for one LP solve on x̄'s route (:func:`lp_stage_x`;
    the plan's ``stage_x``): ``m1`` rows split evenly, the ``nv`` variables
    balanced by their CSR entries (``rowptr``), over ``blocks`` blocks
    (:func:`lp_block_count` when not given) of the ``coresident`` the card
    holds on that route (a number or a function of the resident tile's
    floats, as :func:`lp_coresident_blocks`). Raises ``ValueError`` where a
    forced staged x̄ does not fit."""
    sx = lp_stage_x(nv, m1, stage_x)
    cores = coresident if callable(coresident) else (lambda tile: int(coresident))
    if blocks is None:
        nnz = int(np.asarray(rowptr)[-1])
        blocks = lp_block_count(m1, kp, nnz, cores(0))
    rule = TileRule(
        LP_LAYOUT["kLpOwnRowVectors"], LP_LAYOUT["kLpOwnVarVectors"] + int(m2),
        lambda tile: lp_smem_bytes(nv, m1, tile, sx), LP_LAYOUT["kLpMaxSmem"],
    )
    return dataclasses.replace(
        launch_plan(1, nv, m1, cores, rowptr, kp, rule=rule, blocks=blocks), stage_x=sx
    )


def lp_megakernel_mode(cfg: Optional[Config], nv: int, m1: int, m2: int, device, log=None) -> str:
    """:func:`megakernel_mode` for a generic LP of nv variables, m1
    inequality and m2 equality rows (:func:`lp_fits`, on either x̄ route)."""
    return _gate(cfg, lambda: lp_fits(nv, m1, m2), device, log)


def two_sided_prelude(idx: torch.Tensor, val: torch.Tensor, v: torch.Tensor, colmask: torch.Tensor):
    """Ruiz equilibration of the two-sided master on the packed columns,
    per lane. ``idx``/``val`` ``[C, k_pad]`` (shared; ``val`` float32 or a
    demoted bf16 operand), ``v [T]``, ``colmask [B, C]``. Returns
    ``(scaled, vals_s [B, C, k_pad])``. A bf16 ``val`` is widened exactly in
    its first product with a float32 scaling, so the scalings and
    ``vals_s`` are float32 and bitwise those of the float32 operand: the
    block kernels never see a bf16 value."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _root, _TwoSidedScaled
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_row_absmax

    T = v.shape[0]
    B, C = colmask.shape
    f32 = dict(dtype=iterate_dtype(val.dtype), device=val.device)
    absV = val.abs()
    d_r = torch.ones((B, T), **f32)
    d_e = torch.ones(B, **f32)
    d_c = torch.ones((B, C), **f32)
    d_eps = torch.ones(B, **f32)
    for _ in range(8):
        S = absV * d_r[:, idx] * d_c[:, :, None]
        row_ineq = torch.maximum(ell_row_absmax(idx, S, T), d_r * d_eps[:, None])
        row_eq = (d_e[:, None] * d_c * colmask).amax(dim=1)
        col = torch.maximum(S.amax(dim=2), d_e[:, None] * d_c * colmask)
        col_eps = d_r.amax(dim=1) * d_eps
        d_r = d_r / _root(row_ineq)
        d_e = d_e / _root(row_eq)
        d_c = d_c / _root(col)
        d_eps = d_eps / _root(col_eps)
    vals_s = (val * d_r[:, idx] * d_c[:, :, None]).contiguous()
    pre = _TwoSidedScaled(
        d_r=d_r, d_e=d_e, d_c=d_c, d_eps=d_eps,
        e_col=d_r * d_eps[:, None], a_row=d_e[:, None] * d_c * colmask,
        hs_lo=-v[None, :] * d_r, hs_up=v[None, :] * d_r,
        bs=1.0 * d_e, cs_eps=1.0 * d_eps,
    )
    return pre, vals_s


def csr_forward_operands(csr, vals_s: torch.Tensor):
    """The tensors :func:`csr_forward` reads: ``(vals_t [B, nnz], colT,
    offsets [B·T + 1])``."""
    perm, rowptr, colT = csr
    B = vals_s.shape[0]
    nnz = perm.shape[0]
    vals_t = vals_s.reshape(B, -1)[:, perm].contiguous()  # [B, nnz]
    lane = torch.arange(B, dtype=torch.int64, device=rowptr.device)[:, None] * nnz
    offsets = torch.cat([
        (rowptr[None, :-1].to(torch.int64) + lane).reshape(-1),
        torch.full((1,), B * nnz, dtype=torch.int64, device=rowptr.device),
    ])
    return vals_t, colT, offsets


def csr_forward_from(vals_t: torch.Tensor, colT: torch.Tensor, offsets: torch.Tensor):
    """:func:`csr_forward` over its :func:`csr_forward_operands`."""
    B = vals_t.shape[0]
    T = (offsets.shape[0] - 1) // B

    def forward(p):
        return torch.segment_reduce(
            (vals_t * p[:, colT]).reshape(-1), "sum", offsets=offsets, axis=0, unsafe=True
        ).view(B, T)

    return forward


def csr_forward(csr, vals_s: torch.Tensor):
    """The forward product ``u[b, t] = Σ_{c,s: idx[c,s]=t} vals_s[b,c,s]·p[b,c]``
    as a function of ``p [B, C]``, summed per type in column order over the
    type-major CSR ``csr`` (:func:`csr_transpose` of the pack) by one 1-D
    ``torch.segment_reduce`` over the B·T segments of the lanes laid end to
    end: a fixed order with no atomics. (A 2-D reduction with the lanes on
    a trailing axis sums each segment in one thread: at the XMIN anchor's
    1.68M entries over 1,727 segments it took 844 µs against 60 µs this
    way on an NVIDIA H100 80GB HBM3 at 700 W, ``chip_qp_probe.py``. On the
    CPU both sum in the same order, bit for bit.) ``vals_s`` is
    ``[B, C, k_pad]``."""
    return csr_forward_from(*csr_forward_operands(csr, vals_s))


def ell_operator_tensors(idx, vals_s, pre, csr):
    """Every tensor the two-sided operator pair reads: ``(idx, vals_s,
    vals_t, colT, offsets, e_col, a_row)`` (:func:`csr_forward_operands`)."""
    return (idx, vals_s) + csr_forward_operands(csr, vals_s) + (pre.e_col, pre.a_row)


def ell_operators_from(idx, vals_s, vals_t, colT, offsets, e_col, a_row, gather=ell_gather_mv):
    """:func:`ell_operators` over its :func:`ell_operator_tensors`."""
    forward = csr_forward_from(vals_t, colT, offsets)

    def K_apply(p, eps):
        u = forward(p)
        ec = e_col * eps[:, None]
        return -u - ec, u - ec, (a_row * p).sum(1)

    def KT_apply(l_lo, l_up, mu):
        g_p = gather(idx, vals_s, l_up - l_lo) + mu[:, None] * a_row
        g_e = -(e_col * (l_lo + l_up)).sum(1)
        return g_p, g_e

    return K_apply, KT_apply


def ell_operators(idx, vals_s, pre, csr, gather=ell_gather_mv):
    """The scaled two-sided operator pair over the packed columns:
    ``K_apply(p, eps) -> (r_lo, r_up, r_eq)``, ``KT_apply(l_lo, l_up, mu)
    -> (g_p, g_e)``. ``gather`` is the kernel wrapper (CUDA) by default; the
    forward product is :func:`csr_forward` over ``csr`` (the pack's
    :func:`csr_transpose` on the device)."""
    return ell_operators_from(*ell_operator_tensors(idx, vals_s, pre, csr), gather=gather)


def two_sided_blocks_plain(csr, idx, vals_s, pre, state, tol, *, max_iters, check_every, sentinel):
    """The block kernel's plain version: the same block loop in torch ops
    (``lp_pdhg._two_sided_iterate`` over the plain packed matvecs), launched
    op by op on the card as well, so its times stay those of the plain
    loop that ``chip_smoke.py`` has always held the kernel against."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _two_sided_iterate

    K_apply, KT_apply = ell_operators(idx, vals_s, pre, csr, gather=ell_gather_mv_plain)
    p, eps, l_lo, l_up, mu, norm, scale = state
    return _two_sided_iterate(
        K_apply, KT_apply, pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs,
        p, eps, l_lo, l_up, mu, norm, scale, tol,
        max_iters, check_every, sentinel=sentinel, graph=False,
    )


def csr_transpose(idx_np: np.ndarray, val_np, T: int):
    """Type-major transpose of a column pack: ``(perm, rowptr, colT)`` with
    ``perm`` the flat pack positions of the nonzero slots ordered by type
    (stable, so each type's entries stay in column order). ``val_np`` is
    the host values, float32 or a demoted bf16 tensor. The transpose holds
    positions only: its consumers gather the values from the pack on the
    device, in the pack's dtype."""
    kp = idx_np.shape[1]
    nz = np.flatnonzero(host_float32(val_np).reshape(-1) != 0)
    keys = idx_np.reshape(-1)[nz]
    order = np.argsort(keys, kind="stable")
    perm = nz[order].astype(np.int64)
    rowptr = np.zeros(T + 1, dtype=np.int32)
    rowptr[1:] = np.cumsum(np.bincount(keys, minlength=T)).astype(np.int32)
    return perm, rowptr, (perm // kp).astype(np.int32)


def csr_to_device(idx_np: np.ndarray, val_np: np.ndarray, T: int, device):
    """:func:`csr_transpose` uploaded to ``device``. Callers upload it before
    they queue the solve's other device work: a copy from pageable host
    memory waits for the stream, so uploading it later would block the host
    until the prelude has run."""
    return tuple(torch.as_tensor(a, device=device) for a in csr_transpose(idx_np, val_np, T))


def two_sided_launch_inputs(idx_np: np.ndarray, val_np: np.ndarray, T: int, lanes: int, device):
    """``(csr, plan)``: the pack's :func:`csr_transpose` and, on a CUDA
    device, its :class:`LaunchPlan` for ``lanes`` lanes on that card, both
    uploaded (before the solve's other device work, as
    :func:`csr_to_device` says). ``plan`` is None off CUDA."""
    dev = torch.device(device)
    perm, rowptr, colT = csr_transpose(idx_np, val_np, T)
    plan = None
    if dev.type == "cuda":
        Cp, kp = idx_np.shape
        plan = launch_plan(
            lanes, T, Cp, lambda tile: coresident_blocks(T, Cp, dev, tile), rowptr, kp
        ).upload(dev)
    return tuple(torch.as_tensor(a, device=dev) for a in (perm, rowptr, colT)), plan


def two_sided_blocks_cuda(csr, plan: LaunchPlan, idx, vals_s, pre, state, tol, *,
                          max_iters, check_every, sentinel):
    """Launch the block kernel on the prelude's output; ``csr`` and ``plan``
    are :func:`two_sided_launch_inputs` of the same pack. Returns the scaled
    ``(p, eps, l_lo, l_up, mu, it, res, flags)`` like the plain version."""
    p, eps, l_lo, l_up, mu, norm, scale = state
    B, C = p.shape
    T = l_lo.shape[1]
    kp = idx.shape[1]
    dev = p.device
    if dev.type != "cuda" or idx.device != dev or vals_s.device != dev:
        raise ValueError("the block kernel takes CUDA tensors on one device")
    if (
        idx.dtype != torch.int32 or vals_s.dtype != torch.float32
        or tuple(vals_s.shape) != (B, C, kp)
    ):
        raise ValueError(
            "the block kernel takes int32 idx [C, k_pad] and float32 vals [B, C, k_pad]"
        )
    if two_sided_smem_bytes(T, C) > LAYOUT["kMaxSmem"]:
        raise ValueError(f"a block at T={T}, C={C} does not fit shared memory")
    if plan is None or plan.lanes != B or plan.bounds is None:
        raise ValueError("the launch plan does not match the lanes, or is not uploaded")
    perm, rowptr, colT = csr
    nnz = int(perm.shape[0])
    nb = plan.blocks_per_lane
    vals = vals_s.contiguous()
    vsT = vals.reshape(B, -1)[:, perm].contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    p_k = p.contiguous().clone()
    pav = p_k.clone()
    llo = l_lo.contiguous().clone()
    lup = l_up.contiguous().clone()
    llav, luav = llo.clone(), lup.clone()
    scal = torch.zeros((B, LAYOUT["S_N"]), **f32)
    for slot, val in (
        ("S_EPS", eps), ("S_MU", mu), ("S_EAV", eps), ("S_MAV", mu),
        ("S_RES", float("inf")), ("S_OMEGA", 1.0), ("S_BEST", float("inf")),
        ("S_BS", pre.bs), ("S_CEPS", pre.cs_eps), ("S_NORM", norm),
        ("S_TOL", tol), ("S_SCALE", scale),
    ):
        scal[:, LAYOUT[slot]] = val
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(B * two_sided_scratch_floats(T, C, nb), **f32)
    bar = torch.zeros(B, dtype=torch.int64, device=dev)
    ecol = pre.e_col.contiguous()
    hlo = pre.hs_lo.contiguous()
    hup = pre.hs_up.contiguous()
    arow = pre.a_row.contiguous()
    with guarded_launch(dev):
        KERNEL.call(
            "two_sided_solve_launch",
            ptr(idx.contiguous()), ptr(vals), ptr(rowptr), ptr(colT), ptr(vsT), ptr(ecol),
            ptr(hlo), ptr(hup), ptr(arow), ptr(p_k), ptr(pav), ptr(llo), ptr(lup),
            ptr(llav), ptr(luav), ptr(scal), ptr(iters), ptr(scratch), ptr(bar), ptr(plan.bounds),
            B, T, C, kp, nnz, nb, plan.tile_floats, int(check_every), int(max_iters),
            int(bool(sentinel)),
            stream_of(p_k),
        )
    out = {slot: scal[:, LAYOUT[slot]] for slot in ("S_EPS", "S_MU", "S_RES", "S_POIS", "S_STALL")}
    flags = (out["S_POIS"] > 0).to(torch.int32) + 2 * (out["S_STALL"] > 0).to(torch.int32)
    return (p_k, out["S_EPS"], llo, lup, out["S_MU"], iters, out["S_RES"], flags)


def barrier_loop(lanes: int, blocks_per_lane: int, rounds: int, device) -> None:
    """Run ``rounds`` of the kernel's group barrier over ``lanes`` groups of
    ``blocks_per_lane`` blocks in one cooperative launch (a measurement of
    the barrier alone; it is not a solve and counts no launch)."""
    bar = torch.zeros(lanes, dtype=torch.int64, device=device)
    KERNEL.run("two_sided_barrier_loop", ptr(bar), int(lanes), int(blocks_per_lane), int(rounds),
               stream_of(bar))


def two_sided_setup(idx_np: np.ndarray, val_np: np.ndarray, v, colmask, x0, lam0, mu0, csr):
    """Everything before the block loop: the pack on ``v``'s device (its
    values in their own dtype, float32 or demoted bf16), the Ruiz prelude, the power-iteration ‖K‖ and the scaled warm start
    (``csr`` the pack's :func:`csr_transpose` on that device). Returns
    ``(idx, vals_s, pre, state)`` for :func:`two_sided_blocks_cuda` and
    :func:`two_sided_blocks_plain`."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import kkt_scale, power_norm, warm_scaled

    dev = v.device
    idx = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32), device=dev)
    val = operand_tensor(val_np, dev)
    B, C = colmask.shape
    pre, vals_s = two_sided_prelude(idx, val, v, colmask)
    K_apply, KT_apply = ell_operators(idx, vals_s, pre, csr)
    norm = power_norm(K_apply, KT_apply, B, C, dev)
    state = warm_scaled(pre, x0, lam0, mu0) + (norm, kkt_scale(pre))
    return idx, vals_s, pre, state


def dispatch_two_sided(
    idx_np: np.ndarray, val_np: np.ndarray, v, colmask, x0, lam0, mu0, tol, *,
    max_iters: int, check_every: int, sentinel: bool, log=None, cfg=None,
):
    """The fused two-sided solve for a batch of lanes sharing one column
    pack (``[C, k_pad]``: numpy indices, numpy float32 values or a demoted
    bf16 tensor of them, moved to ``v``'s device here). Lane tensors:
    ``colmask [B, C]``, ``x0 [B, C+1]``, ``lam0 [B, 2T]``, ``mu0 [B]``,
    ``tol [B]``. Returns ``(x [B, C+1], lam [B, 2T], mu [B], it [B],
    res [B], flags [B])``; the block loop is the kernel on a CUDA device and
    its plain version on the CPU."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import unscale

    csr, plan = two_sided_launch_inputs(idx_np, val_np, v.shape[0], colmask.shape[0], v.device)
    idx, vals_s, pre, state = two_sided_setup(idx_np, val_np, v, colmask, x0, lam0, mu0, csr)
    kw = dict(max_iters=max_iters, check_every=check_every, sentinel=sentinel)
    with dispatch_span(
        "kernels.pdhg_megakernel_two_sided", cfg=cfg, log=log, lanes=int(colmask.shape[0]),
        cols=int(colmask.shape[1]), kp=int(idx.shape[1]), T=int(v.shape[0]),
        nnz=int(csr[0].shape[0]), check_every=int(check_every),
    ) as ds, no_implicit_transfers(cfg):
        if plan is not None:
            out = two_sided_blocks_cuda(csr, plan, idx, vals_s, pre, state, tol, **kw)
        else:
            out = two_sided_blocks_plain(csr, idx, vals_s, pre, state, tol, **kw)
        ds.out = out
        ds.note(iters=DeviceValue(out[5]))
    p, eps, l_lo, l_up, mu, it, res, flags = out
    if log is not None:
        log.count("megakernel_dispatches")
        log.count("megakernel_lanes", colmask.shape[0])
    return unscale(pre, p, eps, l_lo, l_up, mu) + (it, res, flags)


# --- the generic-form LP ------------------------------------------------------


def lp_prelude(c, idx, val, h, A, b):
    """Ruiz equilibration of the stacked ``[G; A]`` with G as packed rows
    ``idx``/``val`` ``[m1, k_pad]`` over the nv variables (8 sweeps; the
    column norms of G are a ``scatter_reduce`` max over the packed values).
    ``val`` and ``A`` are float32 or demoted bf16 operands, widened exactly
    in their products with the float32 scalings: ``vals_s`` and the scaled
    ``As`` are float32, bitwise those of float32 operands. Returns the
    :class:`~citizensassemblies_tpu_torch.solvers.lp_pdhg.LPScaled` data."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import LPScaled, _root
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_row_absmax

    m1 = idx.shape[0]
    nv = c.shape[0]
    f32 = dict(dtype=iterate_dtype(val.dtype), device=val.device)
    absV = val.abs()
    absA = A.abs()
    d_r = torch.ones(m1 + A.shape[0], **f32)
    d_c = torch.ones(nv, **f32)
    for _ in range(8):
        Sg = absV * d_r[:m1, None] * d_c[idx]
        Sa = d_r[m1:, None] * absA * d_c[None, :]
        rmax = torch.cat([Sg.amax(dim=1), Sa.amax(dim=1)])
        cmax = torch.maximum(ell_row_absmax(idx, Sg, nv), Sa.amax(dim=0))
        d_r, d_c = d_r / _root(rmax), d_c / _root(cmax)
    return LPScaled(
        d_r=d_r, d_c=d_c, vals_s=(val * d_r[:m1, None] * d_c[idx]).contiguous(),
        As=(d_r[m1:, None] * A * d_c[None, :]).contiguous(), cs=c * d_c,
        hs=h * d_r[:m1], bs=b * d_r[m1:],
    )


def lp_operators(idx, vals_s, csr, gather=ell_gather_mv):
    """``(G_mv, G_rmv)`` over the scaled packed rows: the row gather
    (``gather``, the kernel wrapper by default) and its transpose over the
    variable-major CSR ``csr`` (:func:`csr_to_device` of the pack), each
    variable's products summed in row order by ``torch.segment_reduce``: a
    fixed order with no atomics, so an iteration count depends on the
    inputs alone, on the card as on the host."""
    return lp_operators_from(*lp_operator_tensors(idx, vals_s, csr), gather=gather)


def lp_operator_tensors(idx, vals_s, csr):
    """Every tensor :func:`lp_operators` reads: ``(idx, vals_s, vals_t,
    rowT, rowptr)``."""
    perm, rowptr, rowT = csr
    return idx, vals_s, vals_s.reshape(-1)[perm], rowT, rowptr


def lp_operators_from(idx, vals_s, vals_t, rowT, rowptr, gather=ell_gather_mv):
    """:func:`lp_operators` over its :func:`lp_operator_tensors`."""

    def G_rmv(y):
        # unsafe: the CSR's offsets are valid by construction, and the
        # checks would read them back to the host at every product
        return torch.segment_reduce(vals_t * y[rowT], "sum", offsets=rowptr, unsafe=True)

    return (lambda x: gather(idx, vals_s, x)), G_rmv


def lp_setup(c, idx, val, h, A, b, x0, lam0, mu0, csr):
    """Everything before the block loop of a generic LP (tensors on one
    device; ``csr`` the pack's :func:`csr_to_device`): the Ruiz prelude,
    the power-iteration ‖K‖ and the scaled warm start. Returns ``(pre, (x,
    lam, mu, norm, scale))``."""
    pre = lp_prelude(c, idx, val, h, A, b)
    nv = c.shape[0]
    G_mv, G_rmv = lp_operators(idx, pre.vals_s, csr)
    As = pre.As

    def KtK(v):
        return G_rmv(G_mv(v)) + As.t() @ (As @ v)

    v = torch.ones(nv, dtype=torch.float32, device=c.device) / np.sqrt(np.float32(nv))
    for _ in range(40):
        w = KtK(v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    norm = torch.sqrt(torch.linalg.norm(KtK(v)) + 1e-12)
    return pre, pre.warm(x0, lam0, mu0) + (norm, pre.kkt_scale())


def lp_blocks_plain(csr, idx, pre, state, tol, *, max_iters, check_every, sentinel):
    """The LP block kernel's plain version: the same block loop in torch ops
    (``lp_pdhg._lp_iterate`` over the plain packed matvecs). Returns the
    scaled ``(x, lam, mu, it, res, flags)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _lp_iterate

    G_mv, G_rmv = lp_operators(idx, pre.vals_s, csr, gather=ell_gather_mv_plain)
    return _lp_iterate(
        G_mv, G_rmv, pre.As, pre.cs, pre.hs, pre.bs, *state, tol,
        max_iters, check_every, sentinel=sentinel,
    )


def lp_launch_inputs(idx_np: np.ndarray, val_np, nv: int, m2: int, device,
                     blocks: Optional[int] = None, stage_x: Optional[bool] = None):
    """``(csr, plan)``: the pack's variable-major :func:`csr_transpose` and,
    on a CUDA device, its :class:`LaunchPlan` (:func:`lp_launch_plan`;
    ``blocks`` overrides the block count and ``stage_x`` forces x̄'s
    route, for measurements), both uploaded (before the solve's other
    device work, as :func:`csr_to_device` says). ``plan`` is None off CUDA."""
    dev = torch.device(device)
    m1, kp = idx_np.shape
    sx = lp_stage_x(nv, m1, stage_x)
    perm, rowptr, rowT = csr_transpose(idx_np, val_np, nv)
    plan = None
    if dev.type == "cuda":
        plan = lp_launch_plan(
            nv, m1, m2, kp, rowptr, lambda tile: lp_coresident_blocks(nv, m1, dev, tile, sx),
            blocks, stage_x=sx,
        ).upload(dev)
    return tuple(torch.as_tensor(a, device=dev) for a in (perm, rowptr, rowT)), plan


def fill_slots(scal: torch.Tensor, layout: Dict[str, int], values) -> None:
    """Write ``(slot, value)`` pairs into the 1-D scalar block ``scal``
    without a host sync: a python number by a fill on the device (an element
    store ``scal[i] = x`` copies ``x`` from pageable host memory, which waits
    for the card), a 0-d tensor by a device copy."""
    for slot, val in values:
        cell = scal[layout[slot]]
        if isinstance(val, torch.Tensor):
            cell.copy_(val)
        else:
            cell.fill_(float(val))


def _require_cuda(dev, *tensors) -> None:
    """Raise unless ``dev`` is a CUDA device that holds every tensor."""
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the LP kernel takes CUDA tensors on one device")


def lp_blocks_cuda(csr, plan: LaunchPlan, idx, pre, state, tol, *, max_iters, check_every,
                   sentinel):
    """Launch the LP block kernel on the prelude's output; ``csr`` and
    ``plan`` are :func:`lp_launch_inputs` of the same pack over the nv
    variables. Launches on the plan's x̄ route, a launch on the global
    route counted under ``lp_solve_launch.global_x``. Returns the scaled
    ``(x, lam, mu, it, res, flags)`` like the plain version, with
    ``it``/``res``/``flags`` as 0-d device tensors."""
    x, lam, mu, norm, scale = state
    nv, m1, m2 = x.shape[0], lam.shape[0], mu.shape[0]
    kp = idx.shape[1]
    dev = x.device
    vals = pre.vals_s
    _require_cuda(dev, idx, vals)
    if idx.dtype != torch.int32 or vals.dtype != torch.float32 or tuple(vals.shape) != (m1, kp):
        raise ValueError("the LP kernel takes int32 idx and float32 vals, both [m1, k_pad]")
    if not lp_fits(nv, m1, m2):
        raise ValueError(f"an LP at nv={nv}, m1={m1}, m2={m2} does not fit the block kernel")
    if plan is None or plan.lanes != 1 or plan.bounds is None:
        raise ValueError("the launch plan is not one lane's, or is not uploaded")
    lp_stage_x(nv, m1, plan.stage_x)
    perm, rowptr, rowT = csr
    nb = plan.blocks_per_lane
    vals = vals.contiguous()
    vsT = vals.reshape(-1)[perm].contiguous()
    xk, lamk, muk = x.contiguous().clone(), lam.contiguous().clone(), mu.contiguous().clone()
    xav, lav, mav = xk.clone(), lamk.clone(), muk.clone()
    scal = torch.zeros(LP_LAYOUT["L_N"], dtype=torch.float32, device=dev)
    fill_slots(scal, LP_LAYOUT, (
        ("L_RES", float("inf")), ("L_OMEGA", 1.0), ("L_BEST", float("inf")),
        ("L_NORM", norm), ("L_SCALE", scale), ("L_TOL", tol),
    ))
    iters = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(lp_scratch_floats(nv, m1, nb), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    cs, hs, bs = pre.cs.contiguous(), pre.hs.contiguous(), pre.bs.contiguous()
    As = pre.As.contiguous()
    with guarded_launch(dev):
        LP_KERNEL.call(
            "lp_solve_launch",
            ptr(idx.contiguous()), ptr(vals), ptr(rowptr), ptr(rowT), ptr(vsT), ptr(As), ptr(cs),
            ptr(hs), ptr(bs), ptr(xk), ptr(xav), ptr(lamk), ptr(lav), ptr(muk), ptr(mav),
            ptr(scal), ptr(iters), ptr(scratch), ptr(bar), ptr(plan.bounds),
            nv, m1, m2, kp, nb, plan.tile_floats, int(check_every), int(max_iters),
            int(bool(sentinel)), int(plan.stage_x),
            stream_of(xk), variant=None if plan.stage_x else GLOBAL_X_ROUTE,
        )
    flags = (scal[LP_LAYOUT["L_POIS"]] > 0).to(torch.int32) + 2 * (
        scal[LP_LAYOUT["L_STALL"]] > 0
    ).to(torch.int32)
    return xk, lamk, muk, iters[0], scal[LP_LAYOUT["L_RES"]], flags


def dispatch_lp(
    c, idx_np: np.ndarray, val_np, h, A, b, x0, lam0, mu0, tol, *,
    device, max_iters: int, check_every: int, sentinel: bool, log=None, cfg=None,
):
    """The fused generic-LP solve on ``device``: numpy operands (the pack
    ``[m1, k_pad]`` over nv = ``len(c)`` variables, the dense ``A [m2, nv]``,
    the unscaled warm start); the pack's values and ``A`` may be demoted
    bf16 tensors, which go to the device as they are. Returns the unscaled ``(x, lam, mu)`` tensors
    and ``(it, res, flags)`` as Python numbers; the block loop is the kernel
    on a CUDA device and its plain version on the CPU."""
    dev = torch.device(device)
    nv = len(c)
    csr, plan = lp_launch_inputs(idx_np, val_np, nv, np.shape(A)[0], dev)
    f32 = dict(dtype=torch.float32, device=dev)
    c_, h_, b_, x0_, lam0_, mu0_ = (
        torch.as_tensor(np.asarray(a, np.float32), **f32) for a in (c, h, b, x0, lam0, mu0)
    )
    idx = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32), device=dev)
    pre, state = lp_setup(
        c_, idx, operand_tensor(val_np, dev), h_, operand_tensor(A, dev), b_, x0_, lam0_, mu0_,
        csr,
    )
    kw = dict(max_iters=max_iters, check_every=check_every, sentinel=sentinel)
    with dispatch_span(
        "kernels.pdhg_megakernel_lp", cfg=cfg, log=log, nv=int(nv), m1=int(idx.shape[0]),
        m2=int(np.shape(A)[0]), kp=int(idx.shape[1]), nnz=int(csr[0].shape[0]),
        check_every=int(check_every),
    ) as ds, no_implicit_transfers(cfg):
        if plan is not None:
            ds.note(stage_x=plan.stage_x)
            out = lp_blocks_cuda(csr, plan, idx, pre, state, tol, **kw)
        else:
            out = lp_blocks_plain(csr, idx, pre, state, tol, **kw)
        ds.out = out
    x, lam, mu, it, res, flags = out
    ds.note(iters=int(it))
    if log is not None:
        log.count("megakernel_dispatches")
        log.count("megakernel_lanes")
    return pre.unscale(x, lam, mu) + (int(it), float(res), int(flags))


# --- registered cores (lint/registry.py) ----------------------------------------
# A kernel core is the dispatch's device work: the prelude, then on a CUDA
# device the kernel's one launch (its loop runs on the card) and on CPU tensors
# one block of the plain version (what one launch window of the plain route
# runs). The launch part runs under a profiler range of the core's name, so
# ``chip_smoke.py`` can tell the kernel's launch from the prelude's work.
# Shapes and P1 ranges are the JAX registrations'.


def two_sided_kernel_core(idx, val, v, colmask, x0, lam0, mu0, tol, *, csr, plan, max_iters: int,
                          check_every: int):
    """:func:`dispatch_two_sided` on device tensors (``csr``/``plan``:
    :func:`two_sided_launch_inputs`). Returns the unscaled ``(x, lam,
    mu)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import (
        _two_sided_block,
        kkt_scale,
        power_norm,
        unscale,
        warm_scaled,
    )

    pre, vals_s = two_sided_prelude(idx, val, v, colmask)
    K_apply, KT_apply = ell_operators(idx, vals_s, pre, csr)
    B, C = colmask.shape
    norm = power_norm(K_apply, KT_apply, B, C, v.device)
    state = warm_scaled(pre, x0, lam0, mu0) + (norm, kkt_scale(pre))
    with torch.profiler.record_function("kernels.pdhg_megakernel_two_sided.launch"):
        if plan is not None:
            out = two_sided_blocks_cuda(csr, plan, idx, vals_s, pre, state, tol, max_iters=max_iters,
                                        check_every=check_every, sentinel=False)
        else:
            Kp, KTp = ell_operators(idx, vals_s, pre, csr, gather=ell_gather_mv_plain)
            block = _two_sided_block(Kp, KTp, pre.cs_eps, pre.hs_lo, pre.hs_up, pre.bs, int(check_every))
            omega = torch.ones(B, dtype=torch.float32, device=v.device)
            out = block(*state[:5], 0.9 * omega / norm, 0.9 / (omega * norm))
    return unscale(pre, *out[:5])


def lp_kernel_core(c, idx, val, h, A, b, x0, lam0, mu0, tol, *, csr, plan, max_iters: int,
                   check_every: int):
    """:func:`dispatch_lp` on device tensors (``csr``/``plan``:
    :func:`lp_launch_inputs`). Returns the unscaled ``(x, lam, mu)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _lp_block

    pre, state = lp_setup(c, idx, val, h, A, b, x0, lam0, mu0, csr)
    with torch.profiler.record_function("kernels.pdhg_megakernel_lp.launch"):
        if plan is not None:
            out = lp_blocks_cuda(csr, plan, idx, pre, state, tol, max_iters=max_iters,
                                 check_every=check_every, sentinel=False)
        else:
            G_mv, G_rmv = lp_operators(idx, pre.vals_s, csr, gather=ell_gather_mv_plain)
            block = _lp_block(G_mv, G_rmv, pre.As, pre.cs, pre.hs, pre.bs, int(check_every))
            x, lam, mu, norm, _scale = state
            omega = torch.ones((), dtype=torch.float32, device=x.device)
            out = block(x, lam, mu, 0.9 * omega / norm, 0.9 / (omega * norm))
    return pre.unscale(*out[:3])


@register_ir_core("kernels.pdhg_megakernel_two_sided", dense_ref="batch_lp.polish_screen_ell",
                  span="kernels.pdhg_megakernel_two_sided")
def _ir_megakernel_two_sided(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.lint.operands import TWO_SIDED_RANGES, ell_operands

    r = Seeded(5, device)
    B, T, C, kp = 4, 128, 256, 16
    idx, val = ell_operands(r, C, T, kp)
    csr, plan = two_sided_launch_inputs(idx, val, T, B, r.device)
    return IRCase(
        fn=two_sided_kernel_core,
        args=(r.t(idx), r.t(val), r.f32(T), r.ones((B, C)), r.f32((B, C + 1)), r.f32((B, 2 * T)),
              r.f32(B), r.full((B,), 1e-6)),
        static=dict(csr=csr, plan=plan, max_iters=1024, check_every=128),
        arg_ranges=TWO_SIDED_RANGES,
        prec_demote=(1,),  # packed ELL values
        device=str(device),
    )


@register_ir_core("kernels.pdhg_megakernel_lp", dense_ref="lp_pdhg.pdhg_core_ell",
                  span="kernels.pdhg_megakernel_lp")
def _ir_megakernel_lp(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.lint.operands import LP_RANGES, RANGE_WIDE, ell_operands

    r = Seeded(6, device)
    nv, m1, m2, kp = 65, 64, 1, 8
    idx, val = ell_operands(r, m1, nv, kp)
    csr, plan = lp_launch_inputs(idx, val, nv, m2, r.device)
    return IRCase(
        fn=lp_kernel_core,
        args=(r.f32(nv), r.t(idx), r.t(val), r.f32(m1), r.ones((m2, nv)), r.ones(m2), r.zeros(nv),
              r.zeros(m1), r.zeros(m2), r.full((), 1e-6)),
        static=dict(csr=csr, plan=plan, max_iters=1024, check_every=128),
        arg_ranges=(RANGE_WIDE, None) + LP_RANGES[1:],
        prec_demote=(2,),  # packed ELL values
        device=str(device),
    )
