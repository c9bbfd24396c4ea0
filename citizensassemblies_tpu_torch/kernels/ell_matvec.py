"""ELL gather matvec: the hand-written CUDA kernel and its plain version.

``z[..., c] = Σ_s val[..., c, s] · y[..., idx[c, s]]`` over a packed
``[C, k_pad]`` operator (``solvers/sparse_ops``), for one gather source
``y [minor]`` or a batch ``y [B, minor]`` (the two-sided prelude runs one
lane per row). ``idx`` is shared; ``val`` is shared ``[C, k_pad]`` or per
lane ``[B, C, k_pad]``. Padding slots carry value 0 and index 0.

On a CUDA tensor :func:`ell_gather_mv` launches ``csrc/ell_gather.cu``
(replacing the JAX package's ``kernels/ell_matvec.py:_ell_gather_kernel``)
or raises; on a CPU tensor it runs :func:`ell_gather_mv_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from citizensassemblies_tpu_torch.kernels.cuda_lib import CudaLibrary, ptr, stream_of

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaLibrary(
    "ell_gather",
    "ell_gather.cu",
    ["ell_gather.cuh"],
    {
        "ell_gather_launch": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _P],
        ),
    },
)


def ell_gather_mv_plain(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The gather in plain torch ops (the CPU route and the kernel's check)."""
    return (val * y[..., idx]).sum(dim=-1)


def ell_gather_mv(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Packed gather matvec; the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if y.device.type != "cuda":
        return ell_gather_mv_plain(idx, val, y)
    return ell_gather_mv_cuda(idx, val, y)


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
    for name, t, dt in (("idx", idx, torch.int32), ("val", val, torch.float32), ("y", Y, torch.float32)):
        if t.device != Y.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {Y.device}")
    out = torch.empty((B, C), dtype=torch.float32, device=Y.device)
    KERNEL.call(
        "ell_gather_launch",
        ptr(idx), ptr(val), ctypes.c_longlong(C * kp if val.dim() == 3 else 0),
        ptr(Y), ptr(out), B, T, C, kp, stream_of(Y),
    )
    return out if batched else out[0]
