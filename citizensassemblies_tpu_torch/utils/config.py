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

    # --- scenario models (``scenarios/``) ---------------------------------------
    #: attendance buckets of the dropout model: no-show probabilities are
    #: quantized into this many equal-width buckets, each a vacuous-quota
    #: feature of an extra category, so the product type space multiplies
    #: the type count by the occupied buckets (past ``enum_max_types`` the
    #: model falls back to the attendance-unaware LEXIMIN).
    scenario_dropout_buckets: int = 4
    #: replacement policy of the realized-dropout evaluation: ``"type"``
    #: refills a no-show's seat from the off-panel agents of its base type,
    #: ``"naive"`` from all off-panel agents, ``"none"`` leaves it empty.
    scenario_replacement: str = "type"
    #: successive panels R of the multi-assembly model when the caller does
    #: not pass ``rounds``.
    scenario_rounds: int = 3
    #: Monte-Carlo draws of the dropout model's realization audit
    #: (``parallel/mc.dropout_realization_round``); 0 skips the audit.
    scenario_mc_draws: int = 4_096

    # --- churn re-certification (``solvers/delta.py``) ------------------------
    #: delta re-certification of a revised registry, tri-state: ``False``
    #: off (a revise runs the from-scratch solver), ``None`` on when a base
    #: certificate is held, ``True`` as ``None`` but counting every miss as
    #: ``delta_fallback``. Read by the serving layer.
    delta_solve: Optional[bool] = None
    #: largest edit the delta path takes, as a fraction of the pool size
    #: (``edit.magnitude / n``); past it a revise runs from scratch.
    delta_max_edit_frac: float = 0.05
    #: slack of the dual-sensitivity cache certificate: a cache hit (no LP
    #: solve) needs every newly admitted column priced at least this far
    #: below each stage's support price and the pool-size drift bound under
    #: it, inside the 1e-3 L∞ contract.
    delta_cert_margin: float = 2.0e-4

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

    # --- distribution (``dist/``, ``parallel/``) --------------------------------
    #: route the agent-space dual LP through the row-sharded PDHG
    #: (``parallel/solver.solve_dual_lp_pdhg_sharded``) when the world spans
    #: more than one device and the portfolio has at least this many rows.
    dual_shard_min_rows: int = 4_096
    #: route the face master through the row-sharded PDHG
    #: (``parallel/solver.solve_decomp_master_sharded``) when the world spans
    #: more than one device and the problem has at least this many types.
    master_shard_min_types: int = 4_096
    #: mesh gate: ``True`` lets the shardable stages run over the world's
    #: ``dist.runtime`` mesh whenever it spans more than one device;
    #: ``False`` keeps every stage on its undistributed path (the
    #: ``mesh_to_single_device`` rung of the degradation ladder).
    dist_mesh: bool = True
    #: coordinator address (``host:port`` or a ``tcp://`` / ``file://``
    #: init method). Empty: the ``CITIZENS_DIST_*`` environment decides, and
    #: without it ``dist.runtime.bootstrap`` initializes nothing.
    dist_coordinator: str = ""
    #: place operands into the declared layouts of ``dist/partition.py``
    #: with counted placements (``dist_placements``) and reshards
    #: (``dist_reshards``); ``False`` deals the same shards uncounted.
    dist_prepartition: bool = True
    #: serving-fleet size; 0 reads ``CITIZENS_FLEET_PROCESSES``, else the
    #: world size.
    fleet_processes: int = 0
    #: ``utils/guards.no_implicit_transfers`` mode around the launches and
    #: graph replays of the device hot paths: ``"disallow"`` makes a host
    #: synchronisation inside the scope an error, ``"log"`` a warning,
    #: ``"off"`` removes the scope.
    transfer_guard: str = "disallow"
    #: offered request rate (requests/second, whole fleet) of the open-loop
    #: fleet drive: seeded Poisson arrivals submitted on schedule whatever
    #: the completions (``service/fleet.py``).
    fleet_offered_rate_hz: float = 250.0
    #: distinct tenants of the fleet's synthetic workload, each routed to
    #: its owning process by rendezvous hashing.
    fleet_tenants: int = 8

    # --- selection service (``service/``) --------------------------------------
    #: in-flight (admitted, unfinished) requests a ``SelectionService``
    #: holds; ``submit`` raises ``AdmissionError`` past it.
    serve_queue_depth: int = 256
    #: worker threads of a service: the requests running at once.
    serve_admission_cap: int = 8
    #: milliseconds the cross-request batcher's group leader holds its
    #: window open for other requests' LP fleets; 0 dispatches every fleet
    #: alone.
    serve_batch_window_ms: float = 4.0
    #: entries in each of a tenant session's LRU stores (warm-slot stores,
    #: result memos, packs, delta certificates).
    serve_tenant_memo_cap: int = 8
    #: per-request wall-clock deadline (seconds); 0 disables it.
    serve_deadline_s: float = 0.0
    #: transient-fault retries per request, each after an exponential
    #: backoff from ``serve_retry_backoff_s`` and one rung down the
    #: degradation ladder.
    serve_retry_max: int = 2
    serve_retry_backoff_s: float = 0.05
    #: non-terminal events a ``ResultChannel`` retains (past it they are
    #: dropped and counted; the terminal event is always kept).
    serve_channel_cap: int = 1024
    #: arm the SLO load policy (``obs/slo.SloLoadPolicy``) on a service with
    #: an SLO spec: sustained fast-window burn sheds admissions and walks
    #: the service's degradation ladder; recovery re-arms.
    serve_shed: bool = False
    #: fast-window burn at or above which the policy sheds and descends.
    serve_shed_burn: float = 2.0
    #: fast-window burn at or below which every objective must sit for the
    #: policy to re-arm.
    serve_shed_recover: float = 0.5
    #: the policy's fast window (seconds).
    serve_shed_window_s: float = 60.0
    #: deepest ladder rung the load policy may walk.
    serve_shed_max_rungs: int = 3

    # --- observability (``obs/``) -----------------------------------------------
    #: span tracing, tri-state: ``False`` hard off (the dispatch spans are
    #: inert even under a tracer), ``None`` spans record whenever a tracer is
    #: installed (host-side dispatch windows), ``True`` the service gives
    #: each request a sampling tracer whose dispatch spans wait for the
    #: device.
    obs_trace: Optional[bool] = None
    #: seconds between the service's metrics snapshots streamed into every
    #: open channel; 0 disables the snapshot thread.
    obs_metrics_interval_s: float = 0.0
    #: label sets per metrics instrument before new ones fold into one
    #: overflow series.
    obs_max_label_sets: int = 64
    #: device-memory ledger, tri-state like ``obs_trace``: ``False`` hard
    #: off, ``None`` snapshots whenever a ledger is installed, ``True`` the
    #: service gives each request a ledger and stamps its ``memory`` block.
    obs_memory: Optional[bool] = None
    #: serving SLOs, e.g. ``"latency_p99:20s,error_rate:0.01"``
    #: (``tenant/objective:target`` overrides per tenant); empty disables
    #: the SLO engine.
    obs_slo_spec: str = ""
    #: trend-gate tolerance (``obs/trend.py``): a row fails when its latest
    #: value exceeds tol × the best earlier round.
    obs_trend_tol: float = 1.75
    #: machine-balance ridge (FLOPs per byte) of the roofline verdict
    #: (``obs/roofline.py``): below it a core is bytes-bound, above it
    #: compute-bound. The NVIDIA H100 80GB HBM3's float32 balance, 67e12
    #: FLOP/s over 3.35e12 B/s (the JAX package's 10.0 is a CPU-class
    #: balance, for its CI); ``interop.config_from_dict`` keeps this value.
    obs_roofline_ridge: float = 20.0

    # --- the CUDA-graph store (``aot/``) -----------------------------------------
    #: tri-state: ``None`` loads the artifact when one exists, ``True``
    #: requires it (a missing, unreadable or mismatched artifact raises at
    #: boot), ``False`` installs no store and keeps every request of this
    #: config store-blind (each solve captures its own graphs).
    aot_cache: Optional[bool] = None
    #: artifact path; "" resolves ``CITIZENS_AOT_CACHE``, then the per-user
    #: default file.
    aot_cache_path: str = ""
    #: prewarm of the ``batch_lp.`` families on a tenant's first admission:
    #: ``None`` whenever a store is installed, ``False`` never, ``True`` as
    #: ``None`` (kept for the JAX package's symmetry).
    aot_prewarm: Optional[bool] = None

    # --- the lint package's SPMD pass (``lint/spmd.py``) -------------------------
    #: implicit-replication threshold, bytes: a registered core argument with
    #: no declared ``dist/partition.py`` role larger than this is flagged at
    #: world sizes above 1 (an implicitly replicated operand costs its full
    #: footprint on every device). Declare the argument ``"replicated"`` when
    #: that is the intended layout; the default (1 MiB, the JAX package's)
    #: lets scalars, quota vectors and per-feature tables through.
    spmd_replicated_bytes_max: int = 1 << 20

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

