"""Typed configuration: the knobs the LEXIMIN, LEGACY and XMIN paths read.

Field names and defaults are those of the JAX package's ``Config``, so a
reference configuration maps onto this one field by field
(``interop.config_from_dict``). Only the knobs this package reads are
carried; the rest arrive with the modules that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # --- numerical tolerances -------------------------------------------------
    #: numerical deviation accepted as equality when dealing with solvers.
    eps: float = 5e-4
    #: amount by which all fixed probabilities are shaved when the agent-space
    #: dual LP becomes numerically infeasible.
    fixed_prob_relax_step: float = 1e-4
    #: probabilities below this count as zero in a distribution's support.
    support_eps: float = 1e-11

    # --- LEGACY Monte-Carlo ---------------------------------------------------
    #: number of Monte-Carlo panel draws (reference ``analysis.py:288``).
    mc_iterations: int = 10_000
    #: chains drawn per batch by the LEGACY sampler.
    mc_batch: int = 2_048
    #: resampling sweeps with no accepted panel before LEGACY gives up.
    mc_max_resample_rounds: int = 200

    # --- agent-space column generation ----------------------------------------
    #: portfolio-seeding draw as a multiple of n (capped by ``seed_batch``).
    mw_rounds_factor: int = 3
    #: panels sampled per stochastic pricing batch.
    pricing_batch: int = 4_096
    #: cap on the batched portfolio-seeding draw.
    seed_batch: int = 1_024
    #: violated columns added per dual LP solve.
    cg_columns_per_round: int = 16
    #: violated compositions added per stage-LP solve of the type-space
    #: stage CG (the fallback after a stalled face loop).
    cg_columns_typespace: int = 512
    #: once the portfolio holds this many panels, stochastic pricing stops
    #: adding columns and the exact oracle carries the tail.
    max_portfolio: int = 8_192
    #: wall-clock budget (seconds) of the agent-space CG after a type-space
    #: contract miss; past it the type-space result ships flagged. 0 = none.
    agent_space_budget_s: float = 0.0

    # --- type-space enumeration ----------------------------------------------
    #: enumerate every feasible composition when the instance has at most
    #: this many distinct agent types.
    enum_max_types: int = 16
    #: abandon enumeration beyond this many feasible compositions.
    enum_cap: int = 200_000
    #: abandon enumeration beyond this many search nodes.
    enum_node_budget: int = 3_000_000
    #: panel budget when expanding a composition distribution into concrete
    #: panels (``compositions.expand_compositions``, the ``final_stage="l2"``
    #: route of type space).
    expand_budget: int = 4_096
    #: panel cap for the greedy water-filling seed of the panel decomposition.
    decompose_budget: int = 16_384
    #: probe-LP tolerance certifying that a type cannot exceed the stage value.
    probe_tol: float = 1e-7
    #: panel-decomposition polish tolerance on the enumerated path.
    decomp_tol: float = 1e-6
    #: face-loop acceptance bar on ‖Mp − v‖∞.
    decomp_accept: float = 6.5e-4
    #: acceptance after the face loop stalls or exhausts its rounds.
    decomp_accept_stalled: float = 8e-4
    #: face rounds before the face loop gives up.
    decomp_max_rounds: int = 60
    #: masters stay on the host LP while both the type count and the column
    #: count are at most these.
    decomp_host_master_max_types: int = 384
    decomp_host_master_max_cols: int = 2_500
    #: wall-clock budget (seconds) of the face-round loop.
    decomp_time_budget_s: float = 45.0
    #: run the anchor MILPs on a worker thread, one round behind the master.
    decomp_oracle_overlap: bool = True
    #: carry the master's and polish's PDHG iterates across rounds.
    decomp_warm_start: bool = True
    #: warm rounds without ε improvement before one cold restart.
    decomp_warm_stall_rounds: int = 3
    #: screen the neighbour moves as one device batch per round.
    decomp_batched_expand: bool = True
    #: device anchor pricing (``solvers/device_pricing``) and the fused move
    #: screen. ``None``: on when the run's device is CUDA, off on the CPU;
    #: ``True``/``False`` force.
    decomp_device_pricing: Optional[bool] = None

    # --- XMIN -----------------------------------------------------------------
    #: portfolio-expansion budget as a multiple of n, counted in distinct
    #: panels added (may be fractional for a capped expansion).
    xmin_iterations_factor: float = 8
    #: dual-ascent iterations of the min-L2 final stage
    #: (``solvers/qp.solve_final_primal_l2``).
    xmin_qp_iters: int = 20_000
    #: attempts to sample a panel not already in the portfolio, as a multiple
    #: of n (the reference's ``xmin.py:466``).
    xmin_dedup_attempts_factor: int = 3
    #: L∞ budget of XMIN's support-maximizing blend: per-agent probabilities
    #: stay within this of their leximin values after the spread.
    xmin_linf_band: float = 8e-4

    # --- PDHG LP solver -------------------------------------------------------
    pdhg_max_iters: int = 100_000
    pdhg_tol: float = 1e-6
    #: iterations per convergence check (one PDHG block).
    pdhg_check_every: int = 128
    #: route the two-sided master through the hand-written block kernel
    #: (``kernels/pdhg_megakernel.py``). ``None``: the kernel on CUDA when
    #: the lane's T-vectors fit shared memory; ``True``: the kernel on CUDA
    #: tensors and its plain version on CPU tensors; ``False``: the chained
    #: torch route.
    pdhg_megakernel: Optional[bool] = None

    # --- batched LP engine ----------------------------------------------------
    #: the batched LP engine (``solvers/batch_lp``): the B-lane polish screen
    #: of the face loop and the probe prescreen of the enumerated path.
    #: ``None``: on when the run's device is CUDA, off on the CPU;
    #: ``True``/``False`` force.
    lp_batch: Optional[bool] = None
    #: cap on a padded bucket dimension: powers of two below it, multiples
    #: of it above.
    lp_batch_bucket_max: int = 4_096
    #: batched device prescreen of the enumerated path's probe LPs.
    lp_batch_screen: bool = True

    # --- structured-sparse operator layer -------------------------------------
    #: ELL routing tri-state: ``None`` engages the ELL path when the measured
    #: fill is at most ``sparse_fill_cutoff``.
    sparse_ops: Optional[bool] = None
    sparse_fill_cutoff: float = 0.25

    #: bf16 operand demotion under the committed ``PRECISION_PLAN.json``
    #: (``utils/precision.py``): only operands whose bf16 round trip is
    #: exact are demoted, lossy ones stay float32 (``mp_lossy_skip``), so an
    #: engaged run equals an off run bit for bit. ``None``: on when the
    #: run's device is CUDA, off on the CPU; ``True``/``False`` force.
    mixed_precision: Optional[bool] = None

    # --- fault tolerance ------------------------------------------------------
    #: fault-injection spec ``"site:rate,site:rate"`` over the sites of
    #: ``robust/inject.FAULT_SITES``; the model entry points install an
    #: injector from it. Empty (the default): no injection, each site
    #: consult is a None check. The schedule is seed-deterministic
    #: (``fault_seed``): the same spec and seed fire the same faults.
    fault_sites: str = ""
    #: seed of the fault schedule.
    fault_seed: int = 0
    #: freeze a PDHG lane whose KKT residual goes non-finite at its last
    #: finite block and flag it (the caller re-solves on the host).
    robust_sentinels: bool = True
    #: save the face loop's certified state (columns, mixture, its
    #: arithmetic ε) every N rounds, so a killed run resumes from its last
    #: saved round (``robust/checkpoint.py``, atomic tmp+rename writes).
    #: 0 (the default) disables face checkpointing.
    robust_checkpoint_every: int = 0
    #: directory of the face-loop checkpoints (``face_<fp16>.npz``, named by
    #: a fingerprint of the problem, so a snapshot only resumes into the
    #: same problem). Empty disables face checkpointing.
    robust_checkpoint_dir: str = ""

    # --- backends -------------------------------------------------------------
    #: LP engine of the agent-space CG: "jax" solves the dual LPs by PDHG on
    #: the device (the name is the JAX package's, so configurations map field
    #: by field), "highs" and "hybrid" on the host with HiGHS.
    backend: str = "hybrid"
    #: bypass the type-space solvers and run the agent-space CG.
    force_agent_space: bool = False
    #: random seed of solver-internal sampling.
    solver_seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()

