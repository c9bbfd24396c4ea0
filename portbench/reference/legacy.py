"""The plain reference of LEGACY draws.

The Sortition Foundation's greedy sampler, draw for draw: a panel is k
steps; each step takes the cell of highest urgency ``(qmin − selected) /
remaining`` among the cells with members left and a positive upper quota
(the first maximum in file order), picks its remaining member of largest
Gumbel noise, evicts that member and every member of a cell the pick has
filled to its upper quota, and a draw fails when a cell can no longer reach
its lower quota, when the pool runs dry, or at the final lower-quota audit.

The noise rule is frozen here as the answer's own terms: one
``torch.Generator`` on the run's device seeded with the request's sampler
seed, batches of ``batch`` chains, each step one ``[batch, n]`` block of
``−log(E)``, ``E ~ Exp(1)`` drawn with ``Tensor.exponential_``; accepted
draws are kept in batch order until ``num`` are in hand, and each panel is
reported as its sorted member ids. The same seed on the same device draws
the same noise, so the panels must match bit for bit. Plain torch on the
pool's arrays; nothing of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log_()


def draw_batch(A: torch.Tensor, qmin: torch.Tensor, qmax: torch.Tensor, k: int, batch: int,
               generator: torch.Generator,
               ratio_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of ``batch`` greedy draws from the pool ``A`` (float32
    ``[n, F]`` on the generator's device). Returns ``(panels int64 [batch,
    k] in pick order, accepted bool [batch])``. ``ratio_dtype`` is the
    precision of the urgency ratio (the control passes a lower one)."""
    n = A.shape[0]
    dev = A.device
    A_T = A.t().contiguous()
    member_of = A_T > 0.5
    alive = torch.ones((batch, n), dtype=torch.bool, device=dev)
    selected = torch.zeros((batch, A.shape[1]), dtype=torch.int32, device=dev)
    failed = torch.zeros(batch, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    # uniform scores, added as the answer's terms add them (0 + noise)
    scores = torch.zeros((1, n), dtype=torch.float32, device=dev)
    picks = []
    for _ in range(k):
        dry = ~alive.any(dim=1)
        noise = _gumbel(generator, (batch, n), dev)
        remaining = (alive.to(torch.float32) @ A).to(torch.int32)
        deficit = qmin[None, :] - selected
        starved = (deficit > remaining).any(dim=1)
        eligible = (remaining > 0) & (qmax[None, :] > 0)
        ratio = torch.where(eligible, deficit.to(ratio_dtype) / remaining.to(ratio_dtype),
                            torch.tensor(NEG_INF, dtype=ratio_dtype, device=dev))
        cell = ratio.argmax(dim=1)
        members = alive & member_of[cell]
        person = torch.where(members, scores + noise, NEG_INF).argmax(dim=1)
        feats = A[person].to(torch.int32)
        selected = selected + feats
        full = (selected == qmax[None, :]) & (feats > 0)
        evicted = (full.to(torch.float32) @ A_T) > 0.5
        alive = alive & ~evicted & (rows[None, :] != person[:, None])
        failed = failed | starved | dry
        picks.append(person)
    failed = failed | (selected < qmin[None, :]).any(dim=1)
    return torch.stack(picks, dim=1), ~failed


def draw_feasible(A_np: np.ndarray, qmin_np: np.ndarray, qmax_np: np.ndarray, k: int, num: int,
                  seed: int, batch: int, device,
                  ratio_dtype: torch.dtype = torch.float32) -> Dict[str, np.ndarray]:
    """``num`` accepted panels from sampler seed ``seed``. Returns
    ``{"panels": int32 [num, k] sorted rows, "draws": int, "accepted": bool
    [draws]}``: every draw's acceptance, in order."""
    A = torch.as_tensor(np.asarray(A_np), device=device).to(torch.float32)
    qmin = torch.as_tensor(np.asarray(qmin_np), dtype=torch.int32, device=device)
    qmax = torch.as_tensor(np.asarray(qmax_np), dtype=torch.int32, device=device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    kept, flags, total = [], [], 0
    while total < num:
        panels, ok = draw_batch(A, qmin, qmax, k, batch, generator, ratio_dtype)
        ok_np = ok.cpu().numpy()
        flags.append(ok_np)
        good = panels.cpu().numpy()[ok_np]
        kept.append(good)
        total += good.shape[0]
        if len(flags) > 10_000:
            raise RuntimeError("no feasible panel in 10,000 batches")
    panels = np.sort(np.concatenate(kept, axis=0)[:num], axis=1).astype(np.int32)
    accepted = np.concatenate(flags)
    return {"panels": panels, "draws": int(accepted.size), "accepted": accepted}


def allocation(panels: np.ndarray, n: int, denom: int) -> np.ndarray:
    """Selection frequencies: each agent's count over ``denom``."""
    return np.bincount(panels.ravel(), minlength=n).astype(np.float64) / max(denom, 1)


def pair_matrix(panels: np.ndarray, n: int, denom: int, device) -> np.ndarray:
    """float32 ``[n, n]`` pair co-selection frequencies (zero diagonal):
    the exact counts, in float64 on ``device``, over ``denom``."""
    P = torch.zeros((panels.shape[0], n), dtype=torch.float64, device=device)
    P.scatter_(1, torch.as_tensor(panels, dtype=torch.int64, device=device), 1.0)
    counts = (P.t() @ P).fill_diagonal_(0.0).cpu().numpy()
    return counts.astype(np.float32) / np.float32(max(denom, 1))


def judge(panels: np.ndarray, draws: int, alloc: np.ndarray, ref: Dict[str, np.ndarray],
          n: int, num: int) -> Dict[str, float]:
    """The numbers compared for one LEGACY answer, all exact:
    ``panel_mismatch`` (panels that differ from the reference's, rows
    missing or extra counted), ``draws_gap`` (|draws − the reference's|,
    which counts acceptance decisions that differ) and ``alloc_gap`` (max
    |allocation − the reference's|)."""
    want = ref["panels"]
    rows = min(len(panels), len(want))
    same_shape = panels.shape[1:] == want.shape[1:]
    differ = int((panels[:rows] != want[:rows]).any(axis=1).sum()) if same_shape else rows
    return {
        "panel_mismatch": float(differ + abs(len(panels) - len(want))),
        "draws_gap": float(abs(int(draws) - ref["draws"])),
        "alloc_gap": float(np.max(np.abs(np.asarray(alloc) - allocation(want, n, num)))),
    }
