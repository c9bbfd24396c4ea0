"""ELL gather matvec: the hand-written CUDA kernel and its plain version.

``z[..., c] = Σ_s val[..., c, s] · y[..., idx[c, s]]`` over a packed
``[C, k_pad]`` operator (``solvers/sparse_ops``), for one gather source
``y [minor]`` or a batch ``y [B, minor]`` (the two-sided prelude runs one
lane per row). ``idx`` is shared; ``val`` is shared ``[C, k_pad]`` or per
lane ``[B, C, k_pad]``. Padding slots carry value 0 and index 0.

``val`` is float32, or bf16 for a demoted operand (``utils/precision.py``;
the sum is float32 either way, and on lossless values bitwise the float32
path's). On a CUDA tensor :func:`ell_gather_mv` launches
``csrc/ell_gather.cu`` (replacing the JAX package's
``kernels/ell_matvec.py:_ell_gather_kernel``), its float32 or its
bf16-value entry point, or raises; on a CPU tensor it runs
:func:`ell_gather_mv_plain`. The kernel stages ``y``'s row in shared
memory where it fits beside one ring stage and reads it from the L2
otherwise (:func:`launch_plan`, ``stage_y``): the two routes give the same
output bit for bit, so a gather over a nationwide registry's 100,001
minors runs where the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from citizensassemblies_tpu_torch.kernels.cuda_lib import CudaLibrary, ptr, stream_of
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.utils.precision import demote_dtype

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaLibrary(
    "ell_gather",
    "ell_gather.cu",
    ["ell_gather.cuh"],
    dict(
        {
            name: (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P, _P] + [_I] * 9 + [_P])
            for name in ("ell_gather_launch", "ell_gather_bf16_launch")
        },
        ell_gather_setup=(ctypes.c_int, []),
    ),
)


#: threads a block of the kernel has at most (``kMaxThreads`` in the source)
MAX_THREADS = 256
#: bytes of its row a lane of a load warp loads before it waits on ``y``
#: (``kPrefetchBytes``): 6 float32 vectors or 4 bf16 ones
PREFETCH_BYTES = 192
#: shared memory one block may take (``kBlockSmem``), bytes
BLOCK_SMEM = 232448
#: shared memory of one SM (228 KB), of which the card keeps 1 KB a block
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
#: the counting suffix of a launch on the L2 route (``KERNEL.entry_launches``
#: keys ``ell_gather_launch.l2`` and ``ell_gather_bf16_launch.l2``)
L2_ROUTE = "l2"
#: blocks per SM the plan starts from
BLOCKS_PER_SM = 1
#: warps of a block that take their spans by TMA, or all of a smaller
#: block (``chip_gather_probe.py --sweep`` on an H100: with the pack in the
#: L2, three stages beside the load warps were as fast as any other count
#: at the path's shapes, and more were slower where blocks share an SM;
#: from HBM, more are faster)
TMA_WARPS = 3


@dataclass(frozen=True)
class GatherPlan:
    """The kernel's launch: ``blocks`` blocks for each of the ``B`` lanes
    (``blocks * B`` in all, ``blocks_per_sm`` on every SM), block ``i`` of
    a lane owning a contiguous range of columns (the first ``rem`` blocks
    ``per + 1``, the rest ``per``), ``threads`` threads a block, ``G``
    lanes a column and ``32 / G`` columns a warp. The last ``tma_warps``
    warps of a block are the ring's stages: each pulls its span of the
    pack (``stage_bytes`` at most) into shared memory by TMA bulk copies;
    each lane of the other warps loads the first :data:`PREFETCH_BYTES` of
    its row into registers (``prefetch_bytes`` a block). Then, with
    ``stage_y``, the block stages ``y``'s row in shared memory; without it
    every lane reads ``y`` from the L2 (global memory, the read-only path).
    ``smem_bytes`` is the block's shared memory: the mbarriers, the ring
    and, with ``stage_y``, ``y``."""

    C: int
    kp: int
    T: int
    B: int
    bf16: bool
    G: int
    threads: int
    blocks: int
    blocks_per_sm: int
    tma_warps: int
    stage_y: bool
    stage_bytes: int
    prefetch_bytes: int
    smem_bytes: int

    def range_of(self, block: int):
        """``(c0, n)``: the first column and the column count of a lane's
        block ``block``."""
        per, rem = divmod(self.C, self.blocks)
        return block * per + min(block, rem), per + (1 if block < rem else 0)


def lanes_per_column(kp: int, bf16: bool = False) -> int:
    """``G``: the largest of 8, 4, 2, 1 that divides ``kp / 4``, so each
    lane reads whole 16-byte vectors of 4 indices and 4 values and none
    idles; half that with bf16 values, whose lane reads 8 values in one
    16-byte load with two 16-byte index loads and keeps the two sums of the
    float32 path's lanes ``2g`` and ``2g + 1`` (the same order, the same
    output)."""
    kv = int(kp) // 4
    G = next(g for g in (8, 4, 2, 1) if kv % g == 0)
    return max(G // 2, 1) if bf16 else G


def smem_bytes(T: int, kp: int = 4, G: int = 1, bf16: bool = False, tma_warps: int = 0,
               stage_y: bool = True) -> int:
    """A block's shared memory (``Layout`` in the source): ``tma_warps``
    mbarriers of 8 bytes, padded to 16; as many ring stages, each a warp's
    ``32 / G`` index rows and value rows; with ``stage_y``, ``y``'s row,
    ``T`` rounded up to 4 floats and 4 more (the row sits at its own
    16-byte phase). Without it nothing depends on ``T``."""
    ring = (int(tma_warps) * 8 + 15) // 16 * 16
    stage = (32 // int(G)) * int(kp) * (4 + (2 if bf16 else 4))
    ys = ((int(T) + 3) // 4 * 4 + 4) * 4 if stage_y else 0
    return ring + int(tma_warps) * stage + ys


@functools.lru_cache(maxsize=4096)
def launch_plan(C: int, kp: int, T: int, B: int, sms: int, bf16: bool = False,
                blocks_per_sm: Optional[int] = None, tma_warps: Optional[int] = None,
                stage_y: Optional[bool] = None) -> GatherPlan:
    """The kernel's balanced plan for ``B`` lanes of ``C`` columns of ``kp``
    slots over a ``y`` of ``T`` on a card of ``sms`` SMs.

    Every lane has the same ``blocks`` column ranges, which differ by at
    most one column; ``blocks * B`` is a whole number of blocks for every SM
    (``blocks_per_sm``, the least from :data:`BLOCKS_PER_SM` up that keeps a
    block within :data:`MAX_THREADS` threads, or the given one), and no
    more than ``C`` a lane, so no block is empty. A block has the threads
    its longest range needs, ``G`` a column. ``y``'s route: ``stage_y``
    None stages ``y`` in shared memory where ``y`` and one ring stage fit a
    block's, and reads it from the L2 otherwise, so ``T`` alone never makes
    the plan raise; True forces the staged route, False the L2 route.
    :data:`TMA_WARPS` of its warps (or the given ``tma_warps``) take their
    spans by TMA, fewer where the ring (and a staged ``y``) would not fit a
    block's share of the SM's shared memory, and at least one. Raises
    ``ValueError`` where a forced staged ``y`` and one stage do not fit a
    block's shared memory, one stage alone does not, a given
    ``blocks_per_sm`` leaves a block too many columns or a given
    ``tma_warps`` is not a count of the block's warps."""
    C, kp, T, B, sms = int(C), int(kp), int(T), int(B), int(sms)
    G = lanes_per_column(kp, bf16)
    fits = smem_bytes(T, kp, G, bf16, 1) <= BLOCK_SMEM
    if stage_y and not fits:
        raise ValueError(f"the gather kernel cannot hold y ({T} floats) and one stage of "
                         f"{32 // G} columns of {kp} slots in {BLOCK_SMEM} bytes")
    sy = fits if stage_y is None else bool(stage_y)
    if smem_bytes(T, kp, G, bf16, 1, sy) > BLOCK_SMEM:
        raise ValueError(f"one stage of {32 // G} columns of {kp} slots exceeds {BLOCK_SMEM} bytes")
    need = -(-C * G // MAX_THREADS)  # blocks a lane needs at least
    if blocks_per_sm is None:
        bps = BLOCKS_PER_SM
        while -(-bps * sms // B) < need and -(-bps * sms // B) < C:
            bps += 1
    else:
        bps = int(blocks_per_sm)
    blocks = min(C, -(-bps * sms // B))
    if blocks < need:
        raise ValueError(f"{bps} blocks an SM leave a block more than {MAX_THREADS} threads")
    longest = -(-C // blocks)
    threads = -(-longest * G // 32) * 32
    warps = threads // 32
    # blocks that share an SM split its shared memory
    room = min(BLOCK_SMEM, SM_SMEM // -(-blocks * B // sms) - BLOCK_RESERVED_SMEM)
    if tma_warps is None:
        tw = min(warps, TMA_WARPS)
        while tw > 1 and smem_bytes(T, kp, G, bf16, tw, sy) > room:
            tw -= 1
    else:
        tw = int(tma_warps)
        if not 0 <= tw <= warps:
            raise ValueError(f"a block of {warps} warps cannot give {tw} warps to TMA")
    es = 2 if bf16 else 4
    vec_slots = 8 if bf16 else 4  # slots of a 16-byte vector
    vecs = PREFETCH_BYTES // (vec_slots * (4 + es))  # a lane's vectors in flight before y
    rows = min(vecs * G * vec_slots, kp)  # slots of a row in flight before y
    load_cols = max(0, min(longest, (warps - tw) * (32 // G)))
    return GatherPlan(
        C=C, kp=kp, T=T, B=B, bf16=bool(bf16), G=G, threads=threads, blocks=blocks,
        blocks_per_sm=bps, tma_warps=tw, stage_y=sy, stage_bytes=(32 // G) * kp * (4 + es),
        prefetch_bytes=load_cols * rows * (4 + es), smem_bytes=smem_bytes(T, kp, G, bf16, tw, sy),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: devices whose kernel instances may take the plan's dynamic shared memory
_READY: set = set()


def _setup(device_index: int) -> None:
    """Raise every kernel instance's dynamic shared-memory limit on the
    device, once, before its first launch there (never inside a launch that
    may be captured into a graph)."""
    with torch.cuda.device(device_index):
        KERNEL.run("ell_gather_setup")
    _READY.add(device_index)


def ell_gather_mv_plain(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The gather in plain torch ops (the CPU route and the kernel's check);
    a bf16 ``val`` is promoted to float32 in the product."""
    return (val * y[..., idx]).sum(dim=-1)


def ell_gather_mv(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Packed gather matvec; the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    with dispatch_span(
        "kernels.ell_gather", cols=int(idx.shape[0]), kp=int(idx.shape[1]), T=int(y.shape[-1]),
        lanes=int(y.shape[0]) if y.dim() == 2 else 1, value_bytes=int(val.element_size()),
        lane_values=val.dim() == 3,
    ) as ds:
        if y.device.type != "cuda":
            ds.out = out = ell_gather_mv_plain(idx, val, y)
        else:
            ds.out = out = ell_gather_mv_cuda(idx, val, y, scope=ds)
    return out


def ell_gather_mv_cuda(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor,
                       scope=None) -> torch.Tensor:
    """Launch the CUDA kernel on :func:`launch_plan`'s route; raises on
    inputs it does not take. ``scope``, a dispatch span's, records the
    route taken."""
    C, kp = idx.shape
    batched = y.dim() == 2
    Y = y if batched else y[None, :]
    B, T = Y.shape
    if val.shape[-2:] != (C, kp) or val.dim() not in (2, 3):
        raise ValueError(f"val shape {tuple(val.shape)} does not match idx {(C, kp)}")
    if val.dim() == 3 and (val.shape[0] != B or not batched):
        raise ValueError("a per-lane val needs a y with the same lane count")
    if val.dtype not in (torch.float32, demote_dtype()):
        raise ValueError(f"val must be float32 or bfloat16, not {val.dtype}")
    bf16 = val.dtype == demote_dtype()
    for name, t, dt in (("idx", idx, torch.int32), ("val", val, val.dtype), ("y", Y, torch.float32)):
        if t.device != Y.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {Y.device}")
    # the kernel reads idx and val as 16-byte vectors: 4 float32 values or
    # 8 bf16 values
    slots = 8 if bf16 else 4
    if kp % slots or idx.data_ptr() % 16 or val.data_ptr() % 16:
        raise ValueError(
            f"the gather kernel takes k_pad % {slots} == 0 (got {kp}) and 16-byte aligned packs"
        )
    out = torch.empty((B, C), dtype=torch.float32, device=Y.device)
    if B * C == 0:
        return out if batched else out[0]
    dev = Y.device.index if Y.device.index is not None else torch.cuda.current_device()
    plan = launch_plan(C, kp, T, B, _sm_count(dev), bf16=bf16)
    if scope is not None:
        scope.note(stage_y=plan.stage_y)
    if dev not in _READY:
        _setup(dev)
    KERNEL.call(
        "ell_gather_bf16_launch" if bf16 else "ell_gather_launch",
        ptr(idx), ptr(val), ctypes.c_longlong(C * kp if val.dim() == 3 else 0),
        ptr(Y), ptr(out), B, T, C, kp, plan.G, plan.threads, plan.blocks, plan.tma_warps,
        int(plan.stage_y), stream_of(Y), variant=None if plan.stage_y else L2_ROUTE,
    )
    return out if batched else out[0]


@register_ir_core("kernels.pallas_ell_matvec", span="kernels.ell_gather")
def _ir_ell_gather(device="cpu") -> IRCase:
    """The gather at the JAX registration's minimum-padded shape (256
    packed rows of 16 slots over 128 minors, one lane): the kernel on a
    CUDA device, its plain version on CPU tensors."""
    import numpy as np

    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(21, device)
    C, kp, T = 256, 16, 128
    idx = np.sort(np.argsort(r.rng.random((C, T)), axis=1)[:, :kp], axis=1).astype(np.int32)
    return IRCase(fn=ell_gather_mv, args=(r.t(idx), r.t(r.counts((C, kp), 3, 0.5)), r.f32((1, T))),
                  device=str(device))
