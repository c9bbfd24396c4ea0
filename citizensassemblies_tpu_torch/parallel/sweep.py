"""Batched-instance sweep: the panel sampler over many instances at once.

Parameter studies run Monte-Carlo estimates over many *different* pools
(synthetic sweeps, bootstrap resamples, quota sensitivity scans). Here the
instances are padded to a common ``(n_max, F_max)`` and the whole sweep is
one batched draw: the greedy step of ``models/legacy`` under
``torch.func.vmap`` over an instance axis in front of the chain axis, one
Gumbel tensor ``[I, B, n_max]`` a step from one generator.

Padding is inert by construction: padding agents have all-zero incidence
rows and start evicted, so they belong to no quota cell, are never picked
and never keep a pool alive; padding features have ``qmin = qmax = 0``, so
they are never eligible cells and never constrain a draw. Each instance
therefore draws bit for bit what ``models/legacy._sample_panels_kernel``
draws on it alone, fed its rows of the same noise.

The convex-solve fleets of a sweep (one final ε-LP per instance) go
through the batched LP engine with whole lanes dealt to the mesh's ranks
(:func:`sweep_lp_batch`, :func:`sweep_final_primal_eps`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance
from citizensassemblies_tpu_torch.models.legacy import _draw_panels, _sample_step, gumbel
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span


@dataclasses.dataclass(frozen=True)
class StackedInstances:
    """Instances padded to one shape on one device: ``A`` bool
    ``[I, n_max, F_max]``, ``qmin``/``qmax`` int32 ``[I, F_max]``, the real
    agent counts ``n_real`` int64 ``[I]`` and the common panel size."""

    A: torch.Tensor
    qmin: torch.Tensor
    qmax: torch.Tensor
    n_real: torch.Tensor
    k: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.A.shape)


def pad_and_stack(denses: Sequence[DenseInstance]) -> Tuple[StackedInstances, np.ndarray]:
    """Stack instances (all with one ``k``, on one device) into
    :class:`StackedInstances`; returns it with the real agent counts
    ``n_real int64 [I]``."""
    ks = {d.k for d in denses}
    if len(ks) != 1:
        raise ValueError(f"sweep requires a common panel size k, got {sorted(ks)}")
    devs = {d.device for d in denses}
    if len(devs) != 1:
        raise ValueError(f"sweep instances must share one device, got {sorted(map(str, devs))}")
    n_max = max(d.n for d in denses)
    f_max = max(d.n_features for d in denses)
    I = len(denses)
    A = np.zeros((I, n_max, f_max), dtype=bool)
    qmin = np.zeros((I, f_max), dtype=np.int32)
    qmax = np.zeros((I, f_max), dtype=np.int32)
    for i, d in enumerate(denses):
        A[i, : d.n, : d.n_features] = d.A_np
        qmin[i, : d.n_features] = d.qmin_np
        qmax[i, : d.n_features] = d.qmax_np
    n_real = np.asarray([d.n for d in denses], dtype=np.int64)
    dev = next(iter(devs))
    stacked = StackedInstances(
        A=torch.as_tensor(A, device=dev),
        qmin=torch.as_tensor(qmin, device=dev),
        qmax=torch.as_tensor(qmax, device=dev),
        n_real=torch.as_tensor(n_real, device=dev),
        k=denses[0].k,
    )
    return stacked, n_real


def sweep_panels(stacked: StackedInstances, B: int, generator: torch.Generator):
    """``B`` chains of every instance in one batched draw: the sampler's own
    step (``models/legacy._sample_step``) under ``torch.func.vmap`` over the
    instance axis, the noise of a step ``gumbel(generator, (I, B, n_max))``,
    padding agents out of the pool from the start. Returns ``(panels int64
    [I, B, k], ok bool [I, B])``."""
    I, n, _F = stacked.shape
    dev = stacked.A.device
    A_f = stacked.A.to(torch.float32)
    A_T = A_f.transpose(1, 2).contiguous()
    agents = torch.arange(n, device=dev)
    alive = (agents[None, :] < stacked.n_real[:, None])[:, None, :].expand(I, B, n).contiguous()
    step = torch.func.vmap(_sample_step, in_dims=(0, 0, 0, 0, None, (0, 0, 0), 0, None, None))
    return _draw_panels(
        step, A_f, A_T, stacked.qmin, stacked.qmax, alive, stacked.k,
        lambda _s: gumbel(generator, (I, B, n), dev),
        torch.zeros((1, n), dtype=torch.float32, device=dev), agents,
    )


def allocation_from_panels(panels: torch.Tensor, ok: torch.Tensor, n: int):
    """Per-agent selection frequencies over the accepted chains (float32
    counts over ``max(accepted, 1)``) and the acceptance rate, for one
    instance's ``panels [B, k]``/``ok [B]`` or a stack ``[I, B, k]``."""
    lead = panels.shape[:-2]
    P = panels.reshape(-1, *panels.shape[-2:])
    O = ok.reshape(-1, ok.shape[-1]).to(torch.float32)
    counts = torch.zeros((P.shape[0], n), dtype=torch.float32, device=panels.device)
    counts.scatter_add_(1, P.reshape(P.shape[0], -1), O[:, :, None].expand(P.shape).reshape(P.shape[0], -1))
    denom = torch.clamp_min(O.sum(dim=1), 1.0)
    alloc = counts / denom[:, None]
    return alloc.reshape(*lead, n), O.mean(dim=1).reshape(lead)


def sweep_legacy_allocations(
    denses: Sequence[DenseInstance],
    chains_per_instance: int = 1024,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """LEGACY Monte-Carlo allocations for every instance in one batched
    draw on the instances' device. Returns ``(allocations float64
    [I, n_max], accept_rate float64 [I])``; padding agents report 0."""
    stacked, _n_real = pad_and_stack(denses)
    if generator is None:
        generator = torch.Generator(device=stacked.A.device).manual_seed(int(seed))
    with dispatch_span(
        "sweep.alloc_core", instances=len(denses), chains=int(chains_per_instance),
        n=int(stacked.shape[1]),
    ) as ds:
        panels, ok = sweep_panels(stacked, int(chains_per_instance), generator)
        alloc, rate = allocation_from_panels(panels, ok, stacked.shape[1])
        ds.out = alloc
    return (
        alloc.cpu().numpy().astype(np.float64),
        rate.cpu().numpy().astype(np.float64),
    )


def sweep_lp_batch(
    problems,
    cfg=None,
    log=None,
    mesh=None,
    warm_key: Optional[str] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    device=None,
):
    """Solve a sweep's LP fleet (``solvers/batch_lp.BatchLP`` instances)
    with the batched engine, whole lanes dealt to the ranks of ``mesh``
    (default: ``dist.runtime.effective_mesh(cfg)``, ``None`` on one device)
    and the solutions gathered back to every rank."""
    from citizensassemblies_tpu_torch.dist.runtime import effective_mesh
    from citizensassemblies_tpu_torch.solvers.batch_lp import solve_lp_batch

    if mesh is None:
        mesh = effective_mesh(cfg, log)
    return solve_lp_batch(
        problems, cfg=cfg, log=log, warm_key=warm_key, tol=tol, max_iters=max_iters,
        device=device, mesh=mesh,
    )


def sweep_final_primal_eps(
    portfolios: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    cfg=None,
    log=None,
    mesh=None,
    tol: Optional[float] = None,
    device=None,
) -> List[Tuple[np.ndarray, float]]:
    """The final ε-LPs of a whole sweep: for every (portfolio ``P_i`` bool
    ``[C_i, n_i]``, target ``t_i``) pair, ``min ε s.t. P_iᵀp ≥ t_i − ε,
    Σp = 1, p ≥ 0`` (``leximin.py:453-464``). Returns ``[(p_i, ε_i), …]``
    with ``ε_i`` the float64 arithmetic downward deviation ``max(t_i −
    P_iᵀp, 0)`` of the returned normalized mixture, so a lane that did not
    converge shows in its ε."""
    from citizensassemblies_tpu_torch.solvers.batch_lp import final_primal_batch_lp

    problems = [final_primal_batch_lp(P, t, tol=tol) for P, t in zip(portfolios, targets)]
    sols = sweep_lp_batch(problems, cfg=cfg, log=log, mesh=mesh, tol=tol, device=device)
    out: List[Tuple[np.ndarray, float]] = []
    for P, t, sol in zip(portfolios, targets, sols):
        C = P.shape[0]
        p = np.maximum(np.asarray(sol.x[:C], dtype=np.float64), 0.0)
        total = p.sum()
        p = np.full(C, 1.0 / max(C, 1)) if not np.isfinite(total) or total <= 0.0 else p / total
        deficit = np.asarray(t, dtype=np.float64) - P.T.astype(np.float64) @ p
        out.append((p, float(np.maximum(deficit, 0.0).max())))
    return out


# --- registered cores (lint/registry.py) ----------------------------------------


def sweep_core(A, qmin, qmax, n_real, *, k: int, B: int, seed: int):
    """:func:`sweep_panels` over stacked operands, the noise from a fresh
    generator of ``seed``."""
    stacked = StackedInstances(A=A, qmin=qmin, qmax=qmax, n_real=n_real, k=int(k))
    return sweep_panels(stacked, int(B), torch.Generator(device=A.device).manual_seed(int(seed)))


@register_ir_core("sweep.alloc_core", span="sweep.alloc_core")
def _ir_sweep_alloc_core(device="cpu") -> IRCase:
    """Two padded instances at the sampler's small shape (40 agents, 12
    features, k = 6, 32 chains each): the whole fleet as one draw."""
    from citizensassemblies_tpu_torch.lint.operands import Seeded
    from citizensassemblies_tpu_torch.models.legacy import seeded_pool

    r = Seeded(101, device)
    pools = [seeded_pool(r, 40, 12, 6) for _ in range(2)]
    return IRCase(
        fn=sweep_core,
        args=(r.t(np.stack([p[0] for p in pools])), r.t(np.stack([p[1] for p in pools])),
              r.t(np.stack([p[2] for p in pools])), r.t(np.array([40, 36]), torch.int64)),
        static=dict(k=6, B=32, seed=3), device=str(device),
    )
