"""Device selection and the package's one routing predicate.

Every place where the JAX package routes on ``jax.default_backend()``
routes here on the device the caller passed: :func:`on_accelerator` is the
only predicate, and callers reach it through this module
(``device.on_accelerator``), so a test forces the device routing on CPU
tensors by patching it here once.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    a run never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        # full float32 everywhere: the PDHG iterates and the KKT residuals
        # are compared against float32 tolerances, which TF32 (about three
        # decimal digits) cannot hold
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def on_accelerator(device: torch.device) -> bool:
    """True when ``device`` takes the accelerator routes (device masters,
    batched move screen, the block kernel)."""
    return torch.device(device).type == "cuda"


def upload(array, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array (numpy, or a CPU tensor such as a demoted bf16 operand)
    on ``device`` without blocking the host: to a CUDA device through
    pinned memory and a copy queued on the current stream (a copy from
    pageable memory waits for the stream to drain); elsewhere a plain
    conversion."""
    if isinstance(array, torch.Tensor):
        t = array.contiguous()
    else:
        t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
