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
:func:`ell_gather_mv_plain`.
"""

from __future__ import annotations

import ctypes
import functools

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
    {
        name: (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I, _P])
        for name in ("ell_gather_launch", "ell_gather_bf16_launch")
    },
)


#: warps a block of the kernel has at most (``kMaxWarps`` in the source)
MAX_WARPS = 4


def launch_shape(C: int, kp: int, B: int, sms: int, bf16: bool = False):
    """``(G, threads, blocks)`` of the kernel for ``B`` lanes of ``C``
    columns of ``kp`` slots on a card of ``sms`` SMs: ``G`` lanes per column
    (the largest of 8, 4, 2, 1 that divides ``kp / 4``, so each lane reads
    whole 16-byte vectors and none idles), and the most warps a block may
    have, up to :data:`MAX_WARPS`, while the grid still covers every SM.
    With ``bf16`` values ``G`` is half the float32 path's: a lane reads 8
    values in one 16-byte load with two 16-byte index loads and keeps the
    two sums of the float32 path's lanes ``2g`` and ``2g + 1``, so the
    summation order, and the output, is the float32 path's."""
    kv = int(kp) // 4
    G = next(g for g in (8, 4, 2, 1) if kv % g == 0)
    if bf16:
        G = max(G // 2, 1)
    lanes = int(C) * G
    warps = MAX_WARPS
    while warps > 1 and int(B) * -(-lanes // (32 * warps)) < int(sms):
        warps -= 1
    threads = 32 * warps
    return G, threads, int(B) * -(-lanes // threads)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
            ds.out = out = ell_gather_mv_cuda(idx, val, y)
    return out


def ell_gather_mv_cuda(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises on inputs it does not take."""
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
    dev = Y.device.index if Y.device.index is not None else torch.cuda.current_device()
    G, threads, _ = launch_shape(C, kp, B, _sm_count(dev), bf16=bf16)
    out = torch.empty((B, C), dtype=torch.float32, device=Y.device)
    KERNEL.call(
        "ell_gather_bf16_launch" if bf16 else "ell_gather_launch",
        ptr(idx), ptr(val), ctypes.c_longlong(C * kp if val.dim() == 3 else 0),
        ptr(Y), ptr(out), B, T, C, kp, G, threads, stream_of(Y),
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
