"""The core registry: the port's counterparts of the JAX package's hot cores.

The IR, SPMD and precision passes (``lint/ir.py``, ``lint/spmd.py``,
``lint/prec.py``) and the graph store's manifest walk (``aot/build.py``)
check what they can run, so every hot core registers itself here, next to
the code it describes: each module defines a small build function decorated with
:func:`register_ir_core`, which records (name, source file, line, build function)
without running anything. The build function makes the :class:`IRCase` (the core's
callable and small operands made from a seed on the requested device)
lazily, only when a pass runs. The names are the JAX package's, so the keys
of its ``PRECISION_PLAN.json`` and ``SPMD_BUDGET.json`` join the port's.

What a port core is. The JAX cores are jitted programs whose loops run on
the device. The port's routes read the host between launch windows (a
PDHG solve reads its residual once per block, the L2 ascent its movement
once per chunk), so a registered core is the device work of one dispatch up
to its first such read: the prelude and one block (one chunk, one window
per stage of the fused L2 core) on the route's real pieces, with the block
through the graph store where the route replays it. The three kernel cores
are their kernel's launch on a CUDA device (the cooperative kernels hold
their whole solve in one launch) and, on CPU tensors, what one window of
the kernel's plain version runs. A core reads nothing to the host: the IR
pass holds that on the CPU trace, ``chip_smoke.py`` on the card's profiler
trace.

Shapes are the JAX build functions' (a few hundred elements): the checks are about
structure, not scale, and the traces run on the CPU in the tests. Build functions
import torch freely; this module imports the stdlib only.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class IRCase:
    """One built core.

    ``fn(*args, **static)`` runs the core and returns a tensor or a tuple
    of tensors. ``donate_expected`` is how many of ``args`` the core
    updates in place (the torch counterpart of a JAX donation; IR3 counts
    the inputs whose ``_version`` moved). ``allow_f64`` tags the float64
    certification cores. ``arg_roles`` is the SPMD contract: one
    ``dist/partition.ROLE_BUILDERS`` role per argument (``None`` for an
    undeclared one). ``arg_ranges``/``prec_demote`` are the P1 contract
    (``(lo, hi, exact)`` per argument; the argument indices nominated for
    bf16 demotion), the JAX registration's, mapped by role where the port
    orders its arguments otherwise. ``device`` is where the operands were
    made. ``graph`` names the graph-store family whose block the core
    replays when called with ``graph=True`` (``None``: the core has no
    graph site); such a core takes the ``graph`` keyword and its
    ``static`` says ``graph=False`` (the plain route). ``jax_args`` gives,
    per argument, the index of the JAX registration's argument it plays
    the role of (``None``: the same order), so certified demotions compare
    with ``PRECISION_PLAN.json``'s.
    """

    fn: Any
    args: Tuple[Any, ...]
    static: Dict[str, Any] = dataclasses.field(default_factory=dict)
    donate_expected: int = 0
    allow_f64: bool = False
    arg_roles: Optional[Tuple[Optional[str], ...]] = None
    arg_ranges: Optional[Tuple[Optional[Tuple[float, float, bool]], ...]] = None
    prec_demote: Tuple[int, ...] = ()
    device: str = "cpu"
    graph: Optional[str] = None
    jax_args: Optional[Tuple[Optional[int], ...]] = None

    def run(self, **overrides):
        """Call the core with its ``static`` keywords (``overrides`` on
        top)."""
        return self.fn(*self.args, **{**self.static, **overrides})


@dataclasses.dataclass(frozen=True)
class CoreEntry:
    """One registered core: identity, provenance and the lazy build function
    (``build(device) -> IRCase``). ``dense_ref`` names the dense core this
    ELL core is the twin of, at the same problem shape. ``span`` names the
    ``obs.hooks.dispatch_span`` around the core's entry point (R8), or
    ``span_optout`` gives the reason it has none."""

    name: str
    path: str
    line: int
    build: Callable[..., IRCase]
    dense_ref: Optional[str] = None
    span: Optional[str] = None
    span_optout: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SpmdEntry:
    """One distributed core's SPMD registration: ``build(mesh, device)``
    returns the :class:`IRCase` for that mesh (``arg_roles`` declared), run
    by every rank of the world. ``loop_collectives`` is the reasoned
    exemption from the collective-in-a-loop check."""

    name: str
    path: str
    line: int
    build: Callable[..., IRCase]
    loop_collectives: Optional[str] = None


_REGISTRY: Dict[str, CoreEntry] = {}
_SPMD_REGISTRY: Dict[str, SpmdEntry] = {}

#: every module that registers a core, sorted by package path
MANIFEST: Tuple[str, ...] = (
    "citizensassemblies_tpu_torch.kernels.ell_matvec",
    "citizensassemblies_tpu_torch.kernels.pdhg_megakernel",
    "citizensassemblies_tpu_torch.models.legacy",
    "citizensassemblies_tpu_torch.parallel.mc",
    "citizensassemblies_tpu_torch.parallel.solver",
    "citizensassemblies_tpu_torch.parallel.sweep",
    "citizensassemblies_tpu_torch.solvers.batch_lp",
    "citizensassemblies_tpu_torch.solvers.delta",
    "citizensassemblies_tpu_torch.solvers.device_pricing",
    "citizensassemblies_tpu_torch.solvers.face_decompose",
    "citizensassemblies_tpu_torch.solvers.lp_pdhg",
    "citizensassemblies_tpu_torch.solvers.qp",
)


def _rel_path(file: str) -> str:
    p = Path(file).resolve()
    root = Path(__file__).resolve().parent.parent.parent
    try:
        return str(p.relative_to(root))
    except ValueError:
        return str(p)


def register_ir_core(name: str, dense_ref: Optional[str] = None, span: Optional[str] = None,
                     span_optout: Optional[str] = None) -> Callable:
    """Decorator: register ``build(device="cpu") -> IRCase`` for ``name``."""

    def deco(build: Callable[..., IRCase]) -> Callable[..., IRCase]:
        _REGISTRY[name] = CoreEntry(
            name=name, path=_rel_path(inspect.getsourcefile(build) or "<unknown>"),
            line=build.__code__.co_firstlineno, build=build, dense_ref=dense_ref,
            span=span, span_optout=span_optout,
        )
        return build

    return deco


def register_spmd_core(name: str, loop_collectives: Optional[str] = None) -> Callable:
    """Decorator: register ``build(mesh, device="cpu") -> IRCase`` for
    ``name``."""

    def deco(build: Callable[..., IRCase]) -> Callable[..., IRCase]:
        _SPMD_REGISTRY[name] = SpmdEntry(
            name=name, path=_rel_path(inspect.getsourcefile(build) or "<unknown>"),
            line=build.__code__.co_firstlineno, build=build, loop_collectives=loop_collectives,
        )
        return build

    return deco


def _import_manifest() -> None:
    for mod in MANIFEST:
        importlib.import_module(mod)


def collect() -> List[CoreEntry]:
    """Import every MANIFEST module; the registered cores, sorted by name.
    An import error propagates."""
    _import_manifest()
    return [_REGISTRY[name] for name in sorted(_REGISTRY)]


def collect_spmd() -> List[SpmdEntry]:
    """The SPMD registrations, sorted by name."""
    _import_manifest()
    return [_SPMD_REGISTRY[name] for name in sorted(_SPMD_REGISTRY)]


def build_cases(device: str = "cpu") -> List[Tuple[str, IRCase]]:
    """``(name, built IRCase)`` for every registered core on ``device``."""
    return [(entry.name, entry.build(device=device)) for entry in collect()]


def sparse_pairs() -> Dict[str, str]:
    """``{ELL core: its dense twin}`` for every registered pair."""
    _import_manifest()
    return {name: e.dense_ref for name, e in _REGISTRY.items() if e.dense_ref}
