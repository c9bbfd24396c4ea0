"""bf16 operand demotion: the gate, the committed plan, the iterate floor.

The lowering is OPERAND demotion, not compute demotion. The repo's committed
``PRECISION_PLAN.json`` (written by the JAX package's precision certifier,
read here as data and never written) names, per solver core, which
read-only operator arguments are certified ``bf16_safe``.
:func:`demote_operator` applies exactly that plan, gated by the tri-state
``Config.mixed_precision``, and only when the host array round-trips
bf16 → float32 bit for bit (composition and constraint matrices are often
small-integer valued, exact in bf16's 8-bit mantissa). A lossy operand stays
float32 and is counted ``mp_lossy_skip``. The round trip is checked on the
host array before its upload, so demotion adds no device synchronisation.

A lossless bf16 value promoted to float32 is the same float, and a bf16 ×
float32 product in torch is computed in float32, so a consumer that widens
the operand keeps every sum of the off path in the same order: engaged and
off runs agree bit for bit. The operand-derived dtypes of iterates, Ruiz
scalings and power-iteration vectors go through :func:`iterate_dtype`,
which floors a 16-bit dtype at float32.

16-bit dtype literals of the solver paths live here.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

#: the committed plan at the repo root (beside the package)
PLAN_PATH = Path(__file__).resolve().parent.parent.parent / "PRECISION_PLAN.json"

_HALF = (torch.bfloat16, torch.float16)


def demote_dtype() -> torch.dtype:
    """The storage dtype of demoted operands."""
    return torch.bfloat16


def is_half_dtype(dtype: Any) -> bool:
    """True for the 16-bit floating dtypes (bfloat16, float16)."""
    return dtype in _HALF


def iterate_dtype(dtype: torch.dtype) -> torch.dtype:
    """An operand-derived dtype floored at float32, for iterates, scalings
    and norms: a demoted operand must never make them bf16 (two orders of
    magnitude above the PDHG tolerance). 16-bit in, float32 out; float32
    and wider pass through."""
    return torch.float32 if is_half_dtype(dtype) else dtype


def mixed_precision_enabled(cfg: Optional[Any], device=None) -> bool:
    """Resolve the tri-state ``Config.mixed_precision`` gate for a run on
    ``device``: ``True``/``False`` force; ``None`` is on when ``device``
    takes the accelerator routes (``utils.device.on_accelerator``), off on
    the CPU and when no device is given. Whether the machine has a GPU
    plays no part."""
    mode = getattr(cfg, "mixed_precision", None) if cfg is not None else None
    if mode is not None:
        return bool(mode)
    if device is None:
        return False
    from citizensassemblies_tpu_torch.utils import device as _device

    return _device.on_accelerator(torch.device(device))


@functools.lru_cache(maxsize=1)
def _plan_demotable() -> dict:
    """``{core name: demoted arg indices}`` from the committed plan; empty
    when the plan is missing or unreadable (then nothing is demoted)."""
    try:
        data = json.loads(PLAN_PATH.read_text())
    except (OSError, ValueError):
        return {}
    out = {}
    for name, entry in data.get("cores", {}).items():
        args = tuple(int(i) for i in entry.get("demote_args", ()))
        if args:
            out[name] = args
    return out


def plan_demote_args(core: str) -> tuple:
    """The committed plan's certified demotable arg indices for ``core``."""
    return _plan_demotable().get(core, ())


def demote_operator(arr: Any, cfg: Optional[Any], *, core: str, arg: Optional[int] = None,
                    log=None, device=None):
    """Demote one read-only operator, a host float32 array (numpy or a CPU
    tensor), to bf16 under the committed plan.

    Returns ``arr`` itself unless all of these hold: the gate resolves on
    for ``device``, ``core`` has a certified entry in the plan (holding
    ``arg`` when given), the array is float32, and its bf16 round trip is
    exact. Then it returns a CPU ``torch.bfloat16`` tensor of the same
    values (counted ``mp_demoted_operands``); the caller uploads it. A
    lossy array stays as it is, counted ``mp_lossy_skip``."""
    if not mixed_precision_enabled(cfg, device):
        return arr
    certified = plan_demote_args(core)
    if not certified or (arg is not None and int(arg) not in certified):
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
    if t.dtype != torch.float32 or t.device.type != "cpu":
        return arr
    t16 = t.to(demote_dtype())
    if torch.equal(t16.to(torch.float32), t):
        if log is not None:
            log.count("mp_demoted_operands")
        return t16
    if log is not None:
        log.count("mp_lossy_skip")
    return arr


def host_float32(arr) -> np.ndarray:
    """The float32 numpy values of an operand that may have been demoted
    (a bf16 tensor widens exactly): for host work such as a pack's
    transpose, which reads the values' zero pattern."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float32).numpy()
    return np.asarray(arr, dtype=np.float32)


def operand_tensor(arr, device) -> torch.Tensor:
    """An operand on ``device`` in its own dtype: a demoted bf16 tensor
    stays bf16, anything else goes up as float32."""
    if isinstance(arr, torch.Tensor) and is_half_dtype(arr.dtype):
        return arr.to(device)
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32), device=device)
