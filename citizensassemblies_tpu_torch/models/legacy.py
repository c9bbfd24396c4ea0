"""LEGACY: the Sortition Foundation's greedy stratified sampler, batched.

One panel draw is k greedy steps: pick the (category, feature) cell with the
highest urgency ratio ``(min − selected) / remaining`` (first maximum in
file order wins), select a uniformly random remaining member of that cell,
update the per-cell counts, evict every member of a cell that just reached
its upper quota, and fail the draw when a cell can no longer reach its lower
quota. Draws that fail the final lower-quota audit are rejected and redrawn.

Here a draw is k eager steps over ``[B, n]`` tensors for B chains at once
(the JAX package's ``lax.scan``, ``citizensassemblies_tpu/models/legacy.py``):
one ``[B, n] @ [n, F]`` product recomputes every chain's remaining counts, a
masked row-wise argmax picks each chain's urgent cell, a Gumbel-max argmax
picks the member, and a second ``[B, F] @ [F, n]`` product evicts the
members of cells that hit their upper quota. The matrix products are plain
``torch.matmul``: the JAX package computes them outside any Pallas kernel.

Randomness comes from an explicit ``torch.Generator`` on the instance's
device. Its streams differ from JAX's keys, so the two packages agree in
distribution, not draw by draw; :func:`_sample_step` takes its Gumbel noise
as an argument, so a test can feed both packages the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Set, Tuple

import numpy as np
import torch

from citizensassemblies_tpu_torch.core.instance import DenseInstance, SelectionError, on_device
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span
from citizensassemblies_tpu_torch.ops.pairs import pair_matrix_from_panels
from citizensassemblies_tpu_torch.service.context import resolve as resolve_context
from citizensassemblies_tpu_torch.service.context import use_context
from citizensassemblies_tpu_torch.utils.config import Config, default_config
from citizensassemblies_tpu_torch.utils.device import DeviceLike, resolve_device

NEG_INF = -1e30


@dataclasses.dataclass
class LegacyResult:
    """Monte-Carlo estimate bundle."""

    allocation: np.ndarray  # float64[n] selection frequencies
    unique_panels: Set[Tuple[int, ...]]
    pair_matrix: np.ndarray  # float32[n, n] pair co-selection probabilities
    panels: np.ndarray  # int32[iterations, k] all sampled panels (sorted rows)
    draws_attempted: int = 0


def _sample_step(A_f32, A_T_f32, qmin, qmax, n, state, noise, scores, households):
    """One greedy selection step for a batch of chains.

    ``state`` is ``(alive bool[B, n], selected int32[B, F], failed bool[B])``;
    ``noise`` is float32 Gumbel noise ``[B, n]``. The member picked is
    ``argmax(scores + noise)`` over the urgent cell's alive members: with
    ``scores ≡ 0`` a uniform pick (Gumbel-max), with ``scores = β·y`` a
    softmax(β·y)-weighted one (the pricing oracle's steering).
    ``households`` int[n] group ids: selecting an agent evicts its household.
    Returns the new state and the picked person per chain.
    """
    alive, selected, failed = state
    remaining = (alive.to(torch.float32) @ A_f32).to(torch.int32)  # [B, F]
    deficit = qmin[None, :] - selected
    # a cell that can no longer reach its lower quota kills the draw
    starved = (deficit > remaining).any(dim=1)
    # urgency over eligible cells; argmax returns the first maximum, which
    # is the file-order tie-break of the reference
    eligible = (remaining > 0) & (qmax[None, :] > 0)
    ratio = torch.where(
        eligible, deficit.to(torch.float32) / remaining.to(torch.float32), NEG_INF
    )
    cell = ratio.argmax(dim=1)  # [B]
    members = alive & (A_T_f32 > 0.5)[cell]  # [B, n]
    person = torch.where(members, scores + noise, NEG_INF).argmax(dim=1)  # [B]
    person_feats = A_f32[person].to(torch.int32)  # [B, F]
    selected = selected + person_feats
    # every cell of the selected person that just hit its upper quota
    # evicts all its members
    purged = (selected == qmax[None, :]) & (person_feats > 0)
    kill = (purged.to(torch.float32) @ A_T_f32) > 0.5
    alive = alive & ~kill
    alive = alive & (households[None, :] != households[person][:, None])
    return (alive, selected, failed | starved), person


def _draw_panels(step, A_f32, A_T_f32, qmin, qmax, alive, k: int, noise_at, scores, households):
    """The k greedy steps of a batch of chains from the pool ``alive``
    (bool ``[..., B, n]``): ``step`` is :func:`_sample_step`, or its
    ``torch.func.vmap`` over a leading instance axis (``parallel/sweep``),
    and ``noise_at(step)`` gives that step's Gumbel noise, shaped like
    ``alive``. Returns ``(panels int64 [..., B, k], ok bool [..., B])``."""
    dev = alive.device
    selected = torch.zeros((*alive.shape[:-1], qmin.shape[-1]), dtype=torch.int32, device=dev)
    failed = torch.zeros(alive.shape[:-1], dtype=torch.bool, device=dev)
    persons: List[torch.Tensor] = []
    for s in range(k):
        # running out of people before the last pick fails the draw
        out_of_people = ~alive.any(dim=-1)
        (alive, selected, failed_s), person = step(
            A_f32, A_T_f32, qmin, qmax, None, (alive, selected, failed),
            noise_at(s), scores, households,
        )
        failed = failed_s | out_of_people
        persons.append(person)
    panels = torch.stack(persons, dim=-1)
    # final lower-quota audit
    failed = failed | (selected < qmin.unsqueeze(-2)).any(dim=-1)
    return panels, ~failed


def _sample_panels_kernel(
    dense: DenseInstance,
    B: int,
    noise_at: Callable[[int], torch.Tensor],
    scores=None,
    households=None,
):
    """Draw B panels; ``noise_at(step)`` gives step ``step``'s ``[B, n]``
    Gumbel noise. Returns ``(panels int64[B, k], ok bool[B])`` on the
    instance's device."""
    n = dense.n
    dev = dense.device
    A_f32 = dense.A.to(torch.float32)
    A_T_f32 = A_f32.t().contiguous()
    if scores is None:
        scores = torch.zeros((1, n), dtype=torch.float32, device=dev)
    if households is None:
        households = torch.arange(n, device=dev)
    else:
        households = torch.as_tensor(np.asarray(households), dtype=torch.int64, device=dev)
    alive = torch.ones((B, n), dtype=torch.bool, device=dev)
    return _draw_panels(
        _sample_step, A_f32, A_T_f32, dense.qmin, dense.qmax, alive, dense.k, noise_at,
        scores, households,
    )


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``−log(E)``, ``E ~ Exp(1)``, from ``generator``."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log_()


def sample_panels_batch(
    dense: DenseInstance, generator: torch.Generator, batch: int, scores=None,
    households=None, distribute: Optional[bool] = None, cfg: Optional[Config] = None,
    log=None,
):
    """Public batch draw on the instance's device; returns ``(panels [B, k],
    ok [B])`` as tensors.

    ``distribute`` shards the chains over the world's mesh
    (``parallel/mc.distributed_sample_panels``): ``None`` turns it on when
    ``dist.runtime.effective_mesh(cfg)`` hands out a mesh (a world of more
    than one device, ``Config.dist_mesh`` on) and the batch covers it;
    ``True`` shards over the default mesh (a one-rank world when no process
    group runs). Every rank draws the global noise of each step and keeps
    its rows, so the result is bit for bit the undistributed draw."""
    from citizensassemblies_tpu_torch.dist.runtime import effective_mesh

    mesh = None
    if distribute is None:
        mesh = effective_mesh(cfg, log)
        if mesh is not None and batch < mesh.size():
            mesh = None
    elif distribute:
        from citizensassemblies_tpu_torch.parallel.mesh import default_mesh

        mesh = default_mesh(device=dense.device)
    if mesh is not None:
        from citizensassemblies_tpu_torch.parallel.mc import distributed_sample_panels

        return distributed_sample_panels(
            dense, generator, batch, mesh, scores=scores, households=households, log=log
        )
    n = dense.n

    def noise_at(_step):
        return gumbel(generator, (batch, n), dense.device)

    with dispatch_span(
        "legacy.scan_sampler", cfg=cfg, log=log, chains=int(batch), n=int(dense.n),
    ) as ds:
        ds.out = out = _sample_panels_kernel(dense, batch, noise_at, scores, households)
    return out


def sample_feasible_panels(
    dense: DenseInstance,
    num: int,
    seed: int = 0,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    distribute: Optional[bool] = None,
) -> Tuple[np.ndarray, int]:
    """Collect ``num`` accepted panels by batched rejection sampling; returns
    ``(panels int32[num, k] with sorted rows, draws attempted)``."""
    cfg = cfg or default_config()
    if num <= 0:
        return np.zeros((0, dense.k), dtype=np.int32), 0
    if distribute is None and not cfg.dist_mesh:
        # mesh_to_single_device rung: stay on the undistributed draw
        distribute = False
    generator = torch.Generator(device=dense.device).manual_seed(int(seed))
    B = min(cfg.mc_batch, max(256, num))
    collected: List[np.ndarray] = []
    total = attempts = draws = 0
    while total < num:
        panels, ok = sample_panels_batch(
            dense, generator, B, households=households, distribute=distribute, cfg=cfg
        )
        good = panels.cpu().numpy()[ok.cpu().numpy()]
        draws += B
        if good.size:
            collected.append(good)
            total += good.shape[0]
        attempts += 1
        if attempts > cfg.mc_max_resample_rounds and total == 0:
            raise SelectionError(
                f"no feasible panel found in {attempts * B} LEGACY draws — "
                f"quotas are likely infeasible for greedy selection"
            )
    panels = np.concatenate(collected, axis=0)[:num]
    panels.sort(axis=1)
    return panels.astype(np.int32), draws


def legacy_probabilities(
    dense: DenseInstance,
    iterations: int = 10_000,
    seed: int = 0,
    cfg: Optional[Config] = None,
    households: Optional[np.ndarray] = None,
    distribute: Optional[bool] = None,
    device: DeviceLike = None,
    ctx=None,
) -> LegacyResult:
    """Estimate the LEGACY allocation from ``iterations`` accepted draws.

    Runs on ``device`` (CUDA unless the caller passes another; raises when
    CUDA is absent and no device was passed). Returns per-agent selection
    frequencies, the set of unique panels, and the pair co-selection matrix
    normalized by the draw count. ``ctx`` (a ``service.RequestContext``,
    default the ambient one) supplies the ``cfg`` the call is not given and
    is ambient for the draws.
    """
    ctx, cfg, _log = resolve_context(ctx, cfg, None)
    dense = on_device(dense, resolve_device(device))
    with use_context(ctx):
        panels, draws = sample_feasible_panels(
            dense, iterations, seed=seed, cfg=cfg, households=households,
            distribute=distribute,
        )
    n = dense.n
    denom = max(iterations, 1)
    counts = np.bincount(panels.ravel(), minlength=n)
    allocation = counts.astype(np.float64) / denom
    pair_matrix = (
        pair_matrix_from_panels(panels, n=n, chunk=cfg.mc_batch, device=dense.device)
        .cpu().numpy() / denom
    )
    return LegacyResult(
        allocation=allocation,
        unique_panels=set(map(tuple, panels.tolist())),
        pair_matrix=pair_matrix,
        panels=panels,
        draws_attempted=draws,
    )


# --- registered cores (lint/registry.py) ----------------------------------------


def scan_sampler_core(dense: DenseInstance, *, B: int, seed: int):
    """:func:`_sample_panels_kernel` with the noise of a fresh generator of
    ``seed`` (:func:`sample_panels_batch`'s undistributed draw)."""
    generator = torch.Generator(device=dense.device).manual_seed(int(seed))
    return _sample_panels_kernel(dense, int(B), lambda _s: gumbel(generator, (int(B), dense.n),
                                                                  dense.device))


def seeded_pool(r, n: int, F: int, k: int, ncat: int = 3):
    """A seeded pool for a build function (``r``: ``lint/operands.Seeded``): each
    agent one feature per category, quotas around ``k``'s even split.
    Returns host ``(A bool [n, F], qmin, qmax int32 [F], cat_of [F])``."""
    per = F // ncat
    A = np.zeros((n, F), bool)
    for ci in range(ncat):
        A[np.arange(n), ci * per + r.rng.integers(0, per, n)] = True
    share = k / per
    return (A, np.full(F, int(np.floor(share * 0.5)), np.int32),
            np.full(F, int(np.ceil(share * 1.5)) + 1, np.int32), np.arange(F) // per)


@register_ir_core("legacy.scan_sampler", span="legacy.scan_sampler")
def _ir_scan_sampler(device="cpu") -> IRCase:
    """The batch draw at 40 agents, 12 features, k = 6, 32 chains."""
    from citizensassemblies_tpu_torch.interop import dense_from_arrays
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    A, qmin, qmax, cat = seeded_pool(Seeded(111, device), 40, 12, 6)
    return IRCase(fn=scan_sampler_core, args=(dense_from_arrays(A, qmin, qmax, cat, 6, 3, device=device),),
                  static=dict(B=32, seed=5), device=str(device))
