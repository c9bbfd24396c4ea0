"""Metric catalogue: the registry of metric series names.

The JAX package's catalogue, with the series only the port emits added
(the sharded and stage-LP routes, the fused L2 stage's gauges). A typo'd
counter
name silently starts a new series while dashboards read the old one;
:func:`is_registered` is the check a test or a linter runs against a
name (the JAX package's lint rule R11; the port's lint arrives with
ROADMAP queue A item 4).

The catalogue is data, not behavior: nothing imports it on the hot path and
registration carries no runtime cost. The help strings double as the
documentation of record for what each series means.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

#: every static metric series name → one-line meaning. Counters, gauges,
#: timers and histogram families share the namespace (the metrics registry
#: enforces type consistency per name at runtime; this catalogue only
#: enforces that the name was deliberate).
METRIC_SERIES: Dict[str, str] = {
    # --- distributed runtime (dist/) -----------------------------------
    "dist_reshards": "device-placement mismatches forcing a reshard (steady state must be 0)",
    "dist_placements": "operands placed into their declared sharding",
    "dist_mesh_hosts": "process count of the active mesh",
    "dist_mesh_devices": "device count of the active mesh",
    "dist_process_index": "this process's index in the pod",
    # --- oracle backends (native/, solvers/) ---------------------------
    "oracle_backend_highs": "anchor-oracle MILPs solved by the HiGHS backend",
    "oracle_backend_native": "anchor-oracle MILPs solved by the native branch-and-bound",
    "oracle_backend_device": "anchor-oracle pricing rounds served by the device DP kernel",
    # --- batched LP engine (solvers/batch_lp.py) -----------------------
    "lp_batch_probe_screened": "bucket members screened by the probe prescreen",
    "lp_batch_probe_pruned": "bucket members pruned before dispatch by the probe prescreen",
    "lp_batch_dispatches": "padded vmapped LP dispatches",
    "lp_batch_solves": "member LPs solved inside batched dispatches",
    "lp_batch_pad_lanes": "padding lanes wasted by shape bucketing",
    "lp_batch_warm_hits": "batched solves seeded from a warm slot",
    "lp_batch_l2_fused": "L2 polish stages fused into the batched dispatch",
    "lp_batch_polish_hit": "polish-screen lanes accepted on-device",
    "lp_batch_polish_miss": "polish-screen lanes sent back to the host path",
    "lp_batch_xreq_dispatches": "cross-request batched dispatches",
    "lp_batch_xreq_fused": "requests fused into cross-request dispatches",
    # --- numerical sentinels (robust/) ---------------------------------
    "sentinel_poisoned": "lanes quarantined by the NaN/Inf sentinel",
    "sentinel_host_resolve": "poisoned lanes re-solved on the host",
    "sentinel_stalled": "solver lanes flagged by the stall sentinel",
    "sentinel_quarantined": "quarantined lanes excluded from a batch",
    # --- robustness / fault handling (robust/) --------------------------
    "robust_degrade_device_pricing": "degradations from device pricing to the host MILP",
    "robust_resume": "checkpoint resumes after an injected/real failure",
    "robust_host_resolve": "host re-solves after device-path failures",
    "robust_checkpoint_saved": "CG checkpoints saved by the failure policy",
    "robust_retry": "whole-stage retries by the failure policy",
    "robust_oracle_skip": "oracle rounds skipped under the degradation ladder",
    "robust_oracle_retry": "oracle retries after a backend failure",
    "robust_degrade_steps": "total rungs walked down the degradation ladder",
    "fault_queue_stall": "injected queue-stall faults fired",
    # --- face-decomposition engine (solvers/face_decompose.py) ----------
    "decomp_oracle_device_hit": "pricing rounds where the device oracle's column was accepted",
    "decomp_oracle_device_miss": "pricing rounds where the device oracle found no column",
    "decomp_oracle_device_invalid": "device-oracle columns rejected by validation",
    "decomp_oracle_inline": "oracle calls run inline (overlap thread unavailable)",
    "decomp_oracle_overlap_hit": "overlapped oracle results ready when the master needed them",
    "decomp_oracle_overlap_wait": "master stalls waiting on the overlapped oracle",
    "decomp_host_syncs": "host↔device synchronizations in the decomposition loop",
    "decomp_polish_syncs": "host syncs attributable to the final polish",
    "decomp_polish_warm": "polish stages seeded from warm slots",
    "decomp_rounds": "column-generation rounds executed",
    "decomp_warm_cold_restart": "stall-triggered cold restarts of the warm PDHG state",
    "decomp_master_warm": "master solves entered warm",
    "decomp_master_cold": "master solves entered cold",
    # --- session / sparse substrate -------------------------------------
    "session_pack_hit": "tenant-session ELL pack reuses across requests",
    "sparse_fill_pct": "ELL pack fill ratio (percent, gauge)",
    "sparse_hit": "solves routed through the ELL sparse cores",
    "sparse_miss": "solves that fell back to the dense cores",
    # --- mixed precision (utils/precision.py) -----------------
    "mp_demoted_operands": "operator matrices demoted to bf16 under the certified plan",
    "mp_lossy_skip": "plan-certified demotions skipped by the lossless round-trip check",
    # --- megakernel (kernels/pdhg_megakernel.py) -------------------------
    "megakernel_dispatches": "fused PDHG megakernel dispatches",
    "megakernel_lanes": "polish-screen lanes carried by megakernel dispatches",
    # --- the port's own series (emitted by the port, not the JAX package) ---
    "device_pricing_dispatches": "device anchor-pricing dispatches (one per face round)",
    "megakernel_fit_miss": "solves the block kernel's shared-memory fit rule sent to the chained route",
    "agent_space_dual_solves": "dual LP solves of an agent-space column generation (gauge)",
    "agent_space_exact_prices": "exact-oracle pricing rounds of an agent-space column generation (gauge)",
    "dual_lp_sharded": "agent-space dual LPs routed through the row-sharded PDHG",
    "dual_lp_host_fallback": "sharded dual LPs that did not converge and went to HiGHS",
    "decomp_master_sharded": "face masters routed through the row-sharded PDHG",
    "delta_screen_dispatches": "delta re-certification screens dispatched to the device",
    "l2_anchor": "min-ε anchor of the fused L2 stage (timer)",
    "l2_ascent": "dual ascent of the fused L2 stage (timer)",
    "l2_anchor_iters": "PDHG iterations of the fused L2 stage's anchor (gauge)",
    "l2_ascent_iters": "dual-ascent iterations of the fused L2 stage (gauge)",
    "l2_ascent_replays": "graph replays of the fused L2 stage's ascent chunks (gauge)",
    "stage_cg_stages": "stages of the type-space stage column generation (gauge)",
    "stage_lp_pdhg": "stage LPs solved by the dense PDHG on the device",
    "stage_lp_host": "stage LPs solved on the host",
    # --- serving layer (service/) ----------------------------------------
    "deadline_exceeded": "requests that ran out of deadline budget",
    "batcher_leader_reclaim": "batcher follower watchdog reclaims of a dead leader",
    "batch_window": "time a request waited for the cross-request batch window (timer)",
    "graftserve_admission_rejected_total": "requests rejected at admission (queue full)",
    "graftserve_shutdown_rejected_total": "requests rejected during drain/shutdown",
    "graftserve_requests_total": "completed requests, by tenant and algorithm",
    "graftserve_request_seconds": "request latency histogram (worker pickup → result)",
    "graftserve_deadline_total": "deadline-exceeded requests, by tenant",
    "graftserve_failed_total": "failed requests, by tenant",
    "graftserve_in_flight": "requests admitted and not yet finished",
    "graftserve_queue_depth": "requests waiting for a worker",
    "graftserve_batcher_fusion_ratio": "fraction of batched dispatches that fused ≥2 requests",
    "graftserve_batcher_solves_per_dispatch": "member solves per cross-request dispatch",
    "graftserve_tenant_evictions": "session-LRU evictions, by owning tenant",
    "graftserve_slo_breach_total": "SLO objective breaches streamed to channels, by tenant and objective",
    # --- load management + fleet serving (service/fleet.py) ----
    "graftserve_shed_total": "submissions shed by the SLO load-management policy, by tenant",
    "graftserve_shed_active": "1 while the load policy is shedding admissions (gauge)",
    "graftserve_shed_rearm_total": "load-policy recovery re-arms (cumulative gauge)",
    "graftserve_degrade_rung": "current service-level degradation-ladder rung (gauge)",
    "graftserve_shed_burn_worst": "worst fast-window SLO burn at the last policy update (gauge)",
    # --- incremental re-certification (solvers/delta.py) ------
    "delta_cache_hit": "edits served by the sensitivity cache certificate (zero LP solves)",
    "delta_resume": "edits served by a warm ladder resume from a stored stage certificate",
    "delta_resume_stages": "ladder stages actually re-run across warm resumes",
    "delta_full_ladder": "edits that re-ran the full ladder over the screened hull",
    "delta_fallback": "revise requests served from-scratch (cold session, oversized or inconsistent edit)",
    "delta_new_columns": "columns admitted by incremental region enumeration",
    "delta_screen_drop": "columns pruned by the feasibility screen",
    "delta_screen_flag": "near-margin columns re-priced on host in float64",
    "delta_recertify": "whole delta re-certification step (timer)",
    "delta_screen": "batched dual screening dispatch (timer)",
    # --- memory ledger (obs/memory.py) ------------------------
    "mem_live_bytes": "bytes the CUDA caching allocator holds for tensors at the last ledger snapshot",
    "mem_hbm_peak_bytes": "device-memory high watermark over the ledger's window",
    # --- AOT executable cache (aot/) ---------------------------
    "aot_cache_hit": "core dispatches served by a boot-loaded AOT executable (zero compiles)",
    "aot_cache_miss": "core dispatches at signatures the cache artifact does not hold",
    "aot_cache_stale": "cache entries invalidated at load or at first use (fingerprint, payload, call surprise)",
    "aot_prewarmed": "cached executables touched by speculative pre-warming (boot fleet + tenant admission)",
    # --- solver phase timers ---------------------------------------------
    "relax_leximin": "leximin relaxation phase (timer)",
    "inject": "fault-injection bookkeeping phase (timer)",
    "decomp": "face-decomposition engine phase (timer)",
    "relaxation": "LP relaxation phase (timer)",
    "stage_lp": "per-stage LP solve (timer)",
    "stochastic_pricing": "stochastic pricing pass (timer)",
    "exact_oracle": "exact anchor-oracle MILP (timer)",
    "sparse_pack": "ELL operand packing (timer)",
    "l2_fused": "fused L2 polish stage (timer)",
    "l2_eps_pdhg": "L2 epsilon-polish via PDHG (timer)",
    "l2_eps_lp": "L2 epsilon-polish via LP (timer)",
    "l2_dual_ascent": "L2 dual-ascent QP solve (timer)",
    "decomp_polish_screen": "batched polish prescreen (timer)",
    "decomp_expand": "column expansion phase (timer)",
    "decomp_master": "restricted-master solve (timer)",
    "decomp_polish": "final polish phase (timer)",
    "decomp_oracle": "anchor-oracle pricing phase (timer)",
    "scenario_leximin": "scenario-model leximin phase (timer)",
    "scenario_decompose": "scenario-model decomposition phase (timer)",
    "scenario_fleet": "scenario R-fold LP fleet phase (timer)",
    "typespace_lp": "type-space LP solve (timer)",
    "typespace_cg": "type-space column generation (timer)",
    "final_stage": "final allocation stage (timer)",
    "dual_lp": "dual LP solve (timer)",
    "xmin_draws": "XMIN committee draws (timer)",
    "xmin_dedup": "XMIN committee dedup (timer)",
    "xmin_l2": "XMIN L2 projection (timer)",
}

#: dynamic name families: a metric name built in an f-string is registered when
#: its literal leading fragment is one of these prefixes. Each prefix is a
#: deliberate per-key family (fault sites, ladder rungs, schedule buckets),
#: bounded by the corresponding registry rather than by this catalogue.
METRIC_PREFIXES: FrozenSet[str] = frozenset(
    {
        "fault_",  # robust/inject.py: one counter per registered fault site
        "robust_degrade_",  # robust/policy.py: one counter per ladder rung
        "lp_batch_compiles_",  # solvers/batch_lp.py: per-schedule compile counts
        "xla_compiles_",  # utils/guards.py: per-guard one-time work counts
    }
)


def is_registered(name: str) -> bool:
    """True when ``name`` is a catalogued series or a registered-prefix
    family member."""
    return name in METRIC_SERIES or any(
        name.startswith(p) for p in METRIC_PREFIXES
    )
