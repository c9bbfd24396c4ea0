"""Chain-parallel Monte-Carlo and portfolio reductions over the mesh.

The reference's sequential 10,000-draw LEGACY loop (``analysis.py:180-187``)
becomes chain-parallel sampling over the ranks of the world's mesh: every
rank draws its own block of chains with the batched greedy sampler
(``models/legacy._sample_panels_kernel``), the per-agent selection counts
and the n×n pair co-selection matrix are summed with ``all_reduce`` and the
panels are gathered to every rank.

Randomness follows one rule everywhere in this module: every rank draws the
**global** noise of a step (or of a chunk of draws) from the same seeded
``torch.Generator`` and keeps only its own rows. Any world size therefore
draws bit for bit what the undistributed call draws, and the draws of every
undistributed path are left as they were. The cost is noise for all chains
on every rank. (The JAX package keys each chain on its global chain id with
``fold_in`` instead, so there each device generates only its own chains'
noise.)

The pair product is a plain ``torch.matmul``, as the JAX package computes
it outside any Pallas kernel. Counts are float32 integers (below 2²⁴), so
every world size sums them exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from citizensassemblies_tpu_torch.core.instance import DenseInstance
from citizensassemblies_tpu_torch.dist import partition as dist_partition
from citizensassemblies_tpu_torch.dist.runtime import AXIS_AGENTS, AXIS_CHAINS
from citizensassemblies_tpu_torch.models.legacy import _sample_panels_kernel, gumbel
from citizensassemblies_tpu_torch.lint.registry import IRCase, register_ir_core, register_spmd_core
from citizensassemblies_tpu_torch.obs.hooks import dispatch_span

#: replacement policies of the dropout realization (``scenarios/dropout``):
#: "type" refills each no-show seat with a uniformly random off-panel agent of
#: the SAME base type (identical feature row, so quota-preserving by
#: construction), "naive" re-draws uniformly from ALL off-panel agents (the
#: baseline; may break quotas), "none" leaves no-show seats empty.
DROPOUT_POLICIES: Tuple[str, ...] = ("type", "naive", "none")

#: draws per chunk of the dropout realization: every [chunk, n] tensor of a
#: chunk stays near 56 MB at n = 1727
DROPOUT_CHUNK = 8192


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` from every rank of the world, concatenated along axis 0 in rank
    order (the flat mesh order)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=0)


def _local_chain_range(mesh: DeviceMesh, total: int, log=None) -> Tuple[int, int]:
    """``[lo, hi)`` of the global chain ids this rank owns: its shard of the
    chain-id vector in the declared ``chain_batch`` layout."""
    ids = dist_partition.prepartition(
        torch.arange(total, dtype=torch.int64), dist_partition.chain_batch(mesh, 1), log=log
    ).to_local().cpu()
    return int(ids[0]), int(ids[-1]) + 1


def distributed_sample_panels(
    dense: DenseInstance,
    generator: torch.Generator,
    batch: int,
    mesh: DeviceMesh,
    scores=None,
    households=None,
    log=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chain-parallel panel draw over the mesh, bit for bit
    ``sample_panels_batch(dense, generator, batch)`` on the same generator
    state: each step every rank draws the global ``[batch, n]`` Gumbel noise
    and runs its own block of ``ceil(batch / devices)`` chains on its rows.
    ``scores`` is ``[1, n]`` or per chain ``[batch, n]``. Returns ``(panels
    [batch, k], ok [batch])`` gathered to every rank."""
    ndev = int(mesh.size())
    B_local = -(-int(batch) // ndev)
    total = B_local * ndev
    lo, hi = _local_chain_range(mesh, total, log)
    n, dev = dense.n, dense.device
    real = max(min(hi, batch) - lo, 0)
    if scores is not None and scores.dim() == 2 and scores.shape[0] > 1:
        full = torch.zeros((total, n), dtype=torch.float32, device=dev)
        full[: scores.shape[0]] = scores
        scores = full[lo:hi]

    def noise_at(_step):
        glob = gumbel(generator, (batch, n), dev)
        own = glob[lo : lo + real]
        if real == B_local:
            return own
        pad = torch.zeros((B_local - real, n), dtype=torch.float32, device=dev)
        return torch.cat([own, pad], dim=0)

    panels, ok = _sample_panels_kernel(dense, B_local, noise_at, scores, households)
    return gather_rows(panels)[:batch], gather_rows(ok.to(torch.uint8))[:batch].bool()


def distributed_mc_round(
    dense: DenseInstance, generator: torch.Generator, mesh: DeviceMesh,
    per_device_batch: int, log=None,
):
    """One chain-parallel Monte-Carlo round: each rank draws
    ``per_device_batch`` chains of a ``devices × per_device_batch`` global
    draw (the rows :func:`distributed_sample_panels` gives it). Returns
    ``(panels [ndev·B, k], ok [ndev·B], counts [n], pair [n, n])``:
    ``counts`` and ``pair`` are the ``all_reduce``-summed selection and pair
    co-selection counts of the accepted panels (zero diagonal)."""
    ndev = int(mesh.size())
    B = int(per_device_batch)
    total = ndev * B
    lo, hi = _local_chain_range(mesh, total, log)
    n, dev = dense.n, dense.device

    def noise_at(_step):
        return gumbel(generator, (total, n), dev)[lo:hi]

    panels, ok = _sample_panels_kernel(dense, B, noise_at)
    S = torch.zeros((B, n), dtype=torch.float32, device=dev)
    S.scatter_(1, panels, 1.0)
    S = S * ok[:, None].to(torch.float32)
    counts = S.sum(dim=0)
    pair = S.t() @ S
    dist.all_reduce(counts)
    dist.all_reduce(pair)
    pair = pair * (1.0 - torch.eye(n, dtype=pair.dtype, device=dev))
    return gather_rows(panels), gather_rows(ok.to(torch.uint8)).bool(), counts, pair


def distributed_allocation(P_matrix, probs, mesh: DeviceMesh, log=None) -> torch.Tensor:
    """``π = Pᵀ p`` with the portfolio in the declared ``portfolio`` layout
    (rows over ``chains``, agents over ``agents``) and ``p`` in
    ``chain_rows``: each rank multiplies its block, the partial sums are
    ``all_reduce``d over ``chains`` and the agent shards gathered over
    ``agents``, so every rank gets the whole ``[n]`` float32 result. Rows
    and agents are zero-padded to the mesh's multiples."""
    P_np = np.asarray(P_matrix, dtype=np.float32)
    C, n = P_np.shape
    ch, ag = int(mesh.size(0)), int(mesh.size(1))
    Cp, n_p = -(-C // ch) * ch, -(-n // ag) * ag
    P_pad = np.zeros((Cp, n_p), dtype=np.float32)
    P_pad[:C, :n] = P_np
    p_pad = np.zeros(Cp, dtype=np.float32)
    p_pad[:C] = np.asarray(probs, dtype=np.float32)
    P_l = dist_partition.prepartition(P_pad, dist_partition.portfolio(mesh), log=log).to_local()
    p_l = dist_partition.prepartition(p_pad, dist_partition.chain_rows(mesh), log=log).to_local()
    part = P_l.t() @ p_l
    dist.all_reduce(part, group=mesh.get_group(AXIS_CHAINS))
    agents = mesh.get_group(AXIS_AGENTS)
    shards = [torch.empty_like(part) for _ in range(dist.get_world_size(agents))]
    dist.all_gather(shards, part, group=agents)
    return torch.cat(shards)[:n]


# --- dropout realization (scenarios/dropout) ---------------------------------
# One draw = sample a panel from the portfolio, flip per-member attendance
# coins, refill the no-show seats under a replacement policy, and check the
# realized panel against the quotas. The per-type uniform refill is a
# segment-rank trick: every agent gets a uniform priority (+2 if on the
# panel), one stable argsort per draw over ``type·4 + priority`` orders each
# type's eligible candidates first, and a candidate is seated iff its rank
# within its type segment is below that type's no-show count — a uniformly
# random need_t-subset of the eligible candidates, with no data-dependent
# shapes.


def _dropout_draws(Pm, cum, attend, type_id, starts, A_f, qmin, qmax, T: int,
                   u_pick, u_att, u_ref, policy: str):
    """The realization of ``B`` draws from their uniforms (``u_pick [B]``,
    ``u_att [B, n]``, ``u_ref [B, n]``). Returns ``(seated f32 [B, n], ok
    bool [B], filled f32 [B])``."""
    C, n = Pm.shape
    B = u_pick.shape[0]
    c = torch.clamp_max(torch.searchsorted(cum, u_pick, right=True), C - 1)
    members = Pm[c]
    shows = members & (u_att < attend[None, :])
    if policy == "none":
        final = shows
    else:
        noshow = members & ~shows
        score = u_ref + 2.0 * members.to(torch.float32)
        ar = torch.arange(n, dtype=torch.int64, device=Pm.device).expand(B, n)
        if policy == "type":
            tid = type_id.expand(B, n)
            need = torch.zeros((B, T), dtype=torch.int64, device=Pm.device)
            need.scatter_add_(1, tid, noshow.to(torch.int64))
            order = torch.argsort(type_id.to(torch.float32)[None, :] * 4.0 + score, dim=1,
                                  stable=True)
            pos = torch.empty_like(order).scatter_(1, order, ar)
            refill = ~members & (pos - starts[None, :] < need.gather(1, tid))
        else:  # naive: one global segment, re-draw from everyone off the panel
            order = torch.argsort(score, dim=1, stable=True)
            pos = torch.empty_like(order).scatter_(1, order, ar)
            refill = ~members & (pos < noshow.sum(dim=1, keepdim=True))
        final = shows | refill
    seated = final.to(torch.float32)
    fcnt = seated @ A_f
    ok = ((fcnt >= qmin[None, :]) & (fcnt <= qmax[None, :])).all(dim=1)
    return seated, ok, seated.sum(dim=1)


@dataclasses.dataclass
class DropoutRealization:
    """Monte-Carlo realized-outcome estimate of a panel distribution under
    agent dropout (``scenarios/dropout``)."""

    counts: np.ndarray  # float64[n] times each agent ended up seated
    counts_valid: np.ndarray  # float64[n] seats on quota-satisfying panels only
    draws: int
    policy: str
    quota_ok_rate: float  # fraction of realized panels satisfying all quotas
    fill_rate: float  # mean realized panel size / k

    @property
    def frequencies(self) -> np.ndarray:
        """Realized per-agent seating probability estimate."""
        return self.counts / float(self.draws)

    @property
    def frequencies_valid(self) -> np.ndarray:
        """Per-agent probability of being seated on a VALID realized panel
        (a quota-broken assembly counts as a failed realization)."""
        return self.counts_valid / float(self.draws)


def _type_segment_starts(type_id: np.ndarray) -> np.ndarray:
    """``starts[i]`` = index of the first agent of agent i's type in the
    type-sorted order the refill's argsort produces."""
    type_id = np.asarray(type_id, dtype=np.int64)
    T = int(type_id.max()) + 1 if type_id.size else 0
    counts = np.bincount(type_id, minlength=T)
    starts_t = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return starts_t[type_id]


def dropout_realization_round(
    P_matrix: np.ndarray,
    probs: np.ndarray,
    attendance: np.ndarray,
    type_id: np.ndarray,
    dense: DenseInstance,
    generator: torch.Generator,
    draws: int,
    policy: str = "type",
    mesh: Optional[DeviceMesh] = None,
    chunk: int = DROPOUT_CHUNK,
) -> DropoutRealization:
    """Estimate realized seating outcomes of a panel distribution under
    per-agent attendance probabilities and a replacement policy, on the
    instance's device.

    ``P_matrix`` is the bool ``[C, n]`` portfolio with probabilities
    ``probs``; ``attendance`` the per-agent show-up probability;
    ``type_id`` the base-type labels replacement candidates are matched on.
    The draws run in chunks of ``chunk``; for each chunk every rank draws
    the chunk's uniforms (``u_pick [B]``, ``u_att [B, n]``, then ``u_ref
    [B, n]`` unless the policy is ``"none"``) from ``generator`` and
    realizes the draws of its own ``ceil(draws / devices)`` block among
    them. The counts are ``all_reduce``d, so a mesh of any size (and
    ``mesh=None``) gives bit for bit the same result."""
    if policy not in DROPOUT_POLICIES:
        raise ValueError(f"unknown replacement policy {policy!r} {DROPOUT_POLICIES}")
    dev = dense.device
    n = dense.n
    draws = int(draws)
    f32 = dict(dtype=torch.float32, device=dev)
    Pm = torch.as_tensor(np.asarray(P_matrix, dtype=bool), device=dev)
    p = np.clip(np.asarray(probs, dtype=np.float64), 0.0, None)
    p = p / p.sum()
    cum = torch.as_tensor(np.cumsum(p).astype(np.float32), **f32)
    attend = torch.as_tensor(np.asarray(attendance, dtype=np.float32), **f32)
    tid_np = np.asarray(type_id, dtype=np.int64)
    T = int(tid_np.max()) + 1 if tid_np.size else 0
    tid = torch.as_tensor(tid_np, device=dev)
    starts = torch.as_tensor(_type_segment_starts(tid_np), device=dev)
    A_f = dense.A.to(torch.float32)
    qmin = dense.qmin.to(torch.float32)
    qmax = dense.qmax.to(torch.float32)
    if mesh is None:
        lo, hi = 0, draws
    else:
        per = -(-draws // int(mesh.size()))
        lo, hi = _local_chain_range(mesh, per * int(mesh.size()))
        hi = min(hi, draws)
    counts = torch.zeros(2, n, **f32)  # seated, seated on valid panels
    # ok, filled: integer counts, exact in int64 (the float64 sums they
    # replace were exact too, below 2**53)
    tallies = torch.zeros(2, dtype=torch.int64, device=dev)
    with dispatch_span(
        "mc.dropout_realization", draws=draws, policy=policy, k=int(dense.k),
    ) as ds:
        for c0 in range(0, draws, int(chunk)):
            c1 = min(c0 + int(chunk), draws)
            B = c1 - c0
            u_pick = torch.rand(B, generator=generator, **f32)
            u_att = torch.rand((B, n), generator=generator, **f32)
            u_ref = None if policy == "none" else torch.rand((B, n), generator=generator, **f32)
            a, b = max(c0, lo) - c0, min(c1, hi) - c0
            if a >= b:
                continue
            seated, ok, filled = _dropout_draws(
                Pm, cum, attend, tid, starts, A_f, qmin, qmax, T, u_pick[a:b], u_att[a:b],
                None if u_ref is None else u_ref[a:b], policy,
            )
            counts[0] += seated.sum(dim=0)
            counts[1] += (seated * ok[:, None].to(torch.float32)).sum(dim=0)
            tallies[0] += ok.to(torch.int64).sum()
            tallies[1] += filled.to(torch.int64).sum()
        ds.out = counts
    if mesh is not None:
        dist.all_reduce(counts)
        dist.all_reduce(tallies)
    counts_np = counts.cpu().numpy().astype(np.float64)
    ok_sum, filled_sum = (float(v) for v in tallies.cpu().numpy())
    return DropoutRealization(
        counts=counts_np[0],
        counts_valid=counts_np[1],
        draws=draws,
        policy=policy,
        quota_ok_rate=ok_sum / max(draws, 1),
        fill_rate=filled_sum / max(draws, 1) / float(dense.k),
    )


# --- registered cores (lint/registry.py) ----------------------------------------
# The IR core is one chunk's realization (:func:`_dropout_draws`, no host read);
# the SPMD core the whole round over the swept world, ``scale`` chunks of
# draws. The JAX registrations' shape: 64 draws over a 12-panel portfolio of
# 40 agents with 6 quota features, the "type" policy.


def dropout_core(Pm, cum, attend, type_id, starts, A_f, qmin, qmax, u_pick, u_att, u_ref, *, T: int,
                 policy: str):
    """:func:`_dropout_draws` with its integers as keywords."""
    return _dropout_draws(Pm, cum, attend, type_id, starts, A_f, qmin, qmax, T, u_pick, u_att,
                          u_ref, policy)


def _dropout_case(r, C: int = 12, n: int = 40, F: int = 6):
    """Seeded host operands: portfolio, probabilities, attendance, type ids
    (sorted, 8 types) and the quota instance's ``(A, qmin, qmax)``."""
    P = np.zeros((C, n), bool)
    np.put_along_axis(P, np.argsort(r.rng.random((C, n)), axis=1)[:, :6], True, axis=1)
    A = np.zeros((n, F), bool)
    A[np.arange(n), r.rng.integers(0, F, n)] = True
    type_id = np.sort(r.rng.integers(0, 8, n))
    return (P, r.rng.uniform(0.5, 1.5, C), r.rng.uniform(0.6, 1.0, n), type_id, A,
            np.zeros(F, np.int32), np.full(F, 6, np.int32))


@register_ir_core("mc.dropout_realization", span="mc.dropout_realization")
def _ir_dropout_realization(device="cpu") -> IRCase:
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(51, device)
    P, probs, attend, type_id, A, qmin, qmax = _dropout_case(r)
    B, n = 64, P.shape[1]
    T = int(type_id.max()) + 1
    p = probs / probs.sum()
    return IRCase(
        fn=dropout_core,
        args=(r.t(P), r.t(np.cumsum(p).astype(np.float32)), r.t(attend.astype(np.float32)),
              r.t(type_id.astype(np.int64)), r.t(_type_segment_starts(type_id)),
              r.t(A.astype(np.float32)), r.t(qmin.astype(np.float32)), r.t(qmax.astype(np.float32)),
              r.f32(B), r.f32((B, n)), r.f32((B, n))),
        static=dict(T=T, policy="type"), device=str(device),
    )


@register_spmd_core("mc.dropout_realization")
def _spmd_dropout_realization(mesh, device="cpu", scale: int = 1) -> IRCase:
    """Every rank draws each chunk's uniforms and realizes its own block of
    draws; the counts and tallies are all-reduced once, after the chunks.
    The operands are uploaded whole on every rank and the draws dealt by
    rank (``_local_chain_range``), so no operand declares a role."""
    from citizensassemblies_tpu_torch.interop import dense_from_arrays
    from citizensassemblies_tpu_torch.lint.operands import Seeded

    r = Seeded(51, device)
    P, probs, attend, type_id, A, qmin, qmax = _dropout_case(r)
    dense = dense_from_arrays(A, qmin, qmax, np.arange(A.shape[1]) // 3, 6, 2, device=device)
    chunk = 8 * int(mesh.size())
    return IRCase(
        fn=dropout_realization_round, args=(P, probs, attend, type_id, dense),
        static=dict(generator=torch.Generator(device=device).manual_seed(7),
                    draws=chunk * int(scale), policy="type", mesh=mesh, chunk=chunk),
        device=str(device),
    )
