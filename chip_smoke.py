#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU: kernels, then its paths end to end.

    python3 chip_smoke.py            # the whole check (one GPU)

Phases, each fatal on failure:

1. build: the three hand-written CUDA kernels from
   ``citizensassemblies_tpu_torch/csrc`` (one ``nvcc`` per source, the LP
   kernel's two, all started together), while this process starts CUDA,
   reads the card and builds the first phases' operands on the host;
2. the card: ``nvidia-smi`` name and power limit;
3. kernels, each held against its plain PyTorch version on the card:
   the ELL gather at the flagship master's shape (T=814 types of
   ``sf_e_skewed_instance(seed=1)``, a 6144-column pack) and at the
   flagship dual LP's (4096 panel rows over n+1 = 1728 variables), also
   timed with the L2 flushed before each call; the
   two-sided PDHG solve at B=1, at B=3 with prefix column masks
   1536/3072/6144, and at B=3 with one NaN-warmed lane (the B=1 solve a
   second time from a fresh prelude, both held bit for bit; then a bare
   loop of the kernels' grid barrier at the grid it launched); the
   generic-LP PDHG solve on the flagship dual LP to a tolerance (a second
   time from a fresh prelude, held bit for bit; forced onto its global-x̄
   route, held bit for bit), for a fixed 65,536
   iterations, and with a NaN warm start, then the barrier loop at its
   grid; and on a dual LP of ``sf_b_skewed_instance(seed=1)``'s shape
   (1024 panel rows over n+1 = 251 variables); the two-sided solve at the
   polish screen's shape (prefix lanes 512/1024/2048 of a 2048-column
   support, warm from a master solve); device anchor pricing on one round's
   task batch at the flagship reduction and the fused move screen on 512
   flagship compositions and a master's device duals, each dispatched under
   ``torch.cuda.set_sync_debug_mode("error")`` and held to its CPU run;
4. a small-input reference: LEXIMIN on ``skewed_instance(n=160, k=14,
   n_categories=4, seed=2)`` on the GPU with every master forced onto the
   device route, against the same solve on the CPU;
5. the paths, each with every launch counter zeroed just before it and read
   just after: LEXIMIN on ``sf_e_skewed_instance(seed=1)`` (type space, the
   two-sided kernel), run twice with every master's iterations recorded,
   which must agree launch for launch, in the slice configuration of the
   earlier slices and at the package's defaults (the main path: device
   pricing, the fused screen, the batched polish screen; one host sync per
   steady round; bf16 operand demotion on, the run held bit for bit
   against the same run with it off, the demotion counters printed); the
   defaults on ``mass_like_instance(seed=3)`` and
   ``example_small_like_instance()`` against the batched engine off; LEGACY's 10,000-draw estimator on
   the same pool; the agent-space LEXIMIN column generation with device
   dual LPs (the LP kernel) on ``skewed_instance(n=120, k=12,
   n_categories=3, seed=1)``, run twice (the same dual solves and
   allocation both times) and held against
   the type-space result on the same pool; and on the real-size
   ``sf_b_skewed_instance(seed=1)`` under a stated budget per stage, its
   dual solves held against the type-space leximin values, with each
   round's PDHG iterations and seconds and each HiGHS solve's seconds; the
   dense chained PDHG (the stage LP's core) replayed as a CUDA graph
   against its eager blocks on a stage LP of that pool, bit for bit; and
   the stage-CG fallback on the same pool with the face loop made to
   stall, under a budget, and on the pool of
   ``tests/test_torch_stage_cg.py``, where its stages price (stochastic
   draws on the card and the exact MILP), to its end and held to the same
   run on the CPU; the agent-space run on the n=120 pool once more with
   demotion on, bit for bit against it off;
6. XMIN (the main path's second algorithm) on ``sf_e_skewed_instance(seed=1)``
   from the defaults flagship's LEXIMIN distribution, its launch counters
   zeroed just before it and read just after, run twice and held bit for
   bit, and once with demotion off, bit for bit; the gather kernel held
   against its plain version at XMIN's shape (15,000-odd panels of 112
   slots over n = 1,727 agents), and its bf16-value path at that 0/1 pack
   bit for bit against its float32 path and against the plain version,
   both paths timed hot and with the L2 flushed; and the fused
   ELL min-L2 core on the card (its PDHG blocks and ascent chunks replayed
   as CUDA graphs, and again op by op, bit for bit) against the same core
   on the CPU on a 512-panel prefix of that portfolio, on a short schedule
   (an anchor cap of 4,096 iterations, 10 ascent chunks); the serial min-L2
   route (``Config.lp_batch`` off: the min-ε PDHG anchor, then the
   fixed-count ascent in graph-replayed chunks) on the card against the CPU
   on that prefix, its chunks held bit for bit against the op-by-op ascent
   with the gather's launch count equal in both, and on the card on the
   whole portfolio;
7. households (at most one member per household), each path with its
   launch counters zeroed just before it and read just after: LEXIMIN on
   the n=240 pairs' household quotient with every master forced onto the
   card, against the same call on the CPU, then device pricing and the
   fused screen on that quotient's reduction held to their CPU runs; the
   bench's two household pools (``bench.py:711-727``: 200 couples of
   n=400, twice and bit for bit, after the quota repair its household rows
   need, and 600 couples of n=1200) at the defaults, each panel
   household-disjoint and the least probability certified by
   ``audit_maximin`` on the quotient's instance; the agent-space route with
   households on the n=64 couples (dual LPs on the LP kernel); and XMIN
   with households from the n=400 distribution, twice and bit for bit;
8. checkpoints and faults at the flagship's defaults: the face loop with a
   snapshot every round, killed by the ``face_abort`` fault site on a
   pinned schedule and resumed to the contract, within 1e-3 of the
   uninterrupted run; ``checkpoint_path=`` end to end (the file gone after
   a bit-identical run) and a crafted agent-space state resumed on the
   n=120 pool; and seeded faults (``pdhg_nan`` on the first master,
   ``device_dispatch`` at the first pricing dispatch, ``qp_nan`` in XMIN),
   each recovered to the contract. Every clean phase holds zero
   quarantines and zero host re-solves;
9. the analysis layer through its CLI (``python -m
   citizensassemblies_tpu_torch``, run in this process), each call with its
   launch counters zeroed just before it and read just after: the flagship
   pool written as ``sf_e_skewed_110/`` in the two-CSV schema with an
   ``intersections.csv`` beside it, analysed at the defaults with the timing
   harness (LEGACY twice, LEXIMIN, XMIN, the statistics, figures and CSVs,
   three timed LEXIMIN runs), its LEXIMIN allocation bit for bit the
   defaults flagship's and its XMIN allocation that of
   ``xmin_sf_e_skewed``; the same call again, every pass from the cache
   with no launch and the same statistics; and the ``--generate``
   ``example_small_20`` pool on the card against the CPU. Where matplotlib
   is not installed the figure writers draw nothing (the phases say so) and
   still write their CSVs;
10. distribution (``dist/``, ``parallel/``): ``make_mesh(1)`` over a real
   one-rank NCCL world (an ``all_reduce``, the topology, the gauges,
   ``effective_mesh`` None on one device, the world torn down); over a
   second one-rank world, the chain-parallel sampler on the flagship pool
   at 10,000 chains bit for bit the undistributed draw and a 2,048-chain
   Monte-Carlo round equal to a recount; the dropout realization on the
   defaults flagship LEXIMIN portfolio, 65,536 draws a policy with and
   without the mesh bit for bit, the card against the CPU within 5σ at
   4,096 draws; the row-sharded dual LP at the flagship dual LP's shape on
   its ELL route (the gather kernel; its launches join the kernels line's)
   and dense, against HiGHS (solved in a worker process started after the
   build) and the LP kernel; the row-sharded face master on the flagship
   master against the two-sided kernel; and the instance sweep over
   ``sf_e_skewed_instance(seed=1..4)``, each instance bit for bit the
   per-instance sampler on its noise rows;
11. the scenario models, churn and the request context, each path with its
   launch counters zeroed just before it and read just after: the dropout
   model on ``bench.py --scenarios``'s pool (``random_instance(n=60, k=8,
   n_categories=2, seed=0)``, no-show U(0, 0.5)), audited by 65,536 draws,
   its realized minimum above the attendance-blind naive re-draw's; on
   ``example_small_like_instance()``; and on the flagship pool, where the
   product type space falls back to the attendance-unaware LEXIMIN (the
   main path: the two-sided kernel and the gather launch; its portfolio
   bit for bit the defaults flagship's), audited under all three policies;
   multi-assembly scheduling at R=3 on ``example_small_like_instance()``,
   its round fleet one bucketed dispatch on the card, 1,000 drawn schedules
   without a repeat, against the CPU; ``churn_bench``'s registry (n=100,000,
   k=316) over the first 30 edits of its trail, delta against at most 5
   from-scratch samples within 1e-3, the screen on the card against the
   CPU; and the flagship under a ``RequestContext``, bit for bit the run
   without one at a generous deadline, raising ``DeadlineExceeded`` from
   inside the face loop at a tight one;
12. serving, each sub-phase with its launch counters zeroed just before it
   and read just after: a ``SelectionService`` on the card at the defaults
   with the sampling tracer, the memory ledger and the serve bench's SLO
   spec running two flagship LEXIMIN requests side by side (the main path
   twice, under the transfer guard at ``"disallow"``), each bit for bit
   the defaults flagship, then LEGACY bit for bit ``legacy_flagship``,
   then a repeat from the memo with no launch, the exported trace
   schema-checked and the sync debug mode back at 0; revise requests over
   the first edits of ``churn_bench``'s trail (n=100,000), their modes and
   type values held against direct re-certification from the same base,
   and with ``delta_solve=False`` bit for bit the from-scratch answer; the
   first requests of the serve bench's mixed fleet through the
   cross-request batcher against their serial twins; and one process of
   the fleet bench's four driven open loop, bit for bit its serial
   references;
13. the graph store, the roofline join and profiling: ``python -m
   citizensassemblies_tpu_torch.aot build`` in a child process (the
   coldboot request class and the bucket lattice recorded through a real
   service), ``serve_flagship`` of phase 12 run under the store's recorder
   with its full-width signatures written into the same artifact; two
   fresh child processes of this script, one booted from that artifact and
   one with ``aot_cache=False``, each serving ``COLDBOOT_SPEC`` and then
   the flagship at the defaults (seconds from spawn to the first result,
   captures and builds in each serve window, the ``aot`` stamp, peak
   device bytes; the flagship bit for bit in both and the parent's; the
   cached child's captures equal to its store misses and at most the cold
   child's); stored graphs replayed for a second instance of their
   signature (``batch_lp.vmapped``, the fused L2 core) bit for bit that
   instance's fresh capture; ``obs/roofline.roofline_join`` over
   ``serve_flagship``'s sampled spans (no miss, no share of the card's
   peaks above 1, the kernel rows the kernels line's bound formulas); a
   ``torch.profiler`` trace (``utils/profiling``) of one B=1 two-sided
   solve naming the kernel and its ``annotate`` range, and the trace CLI
   on ``serve_flagship``'s exported trace; the build's walk of the lint
   registry records every core whose block the graph store replays
   (``manifest_cores_recorded``);
14. ``lint_card``: the lint package's AST rules over the port's own
   sources (no finding; the suppressions counted); then every registered
   core (``lint/registry.py``, the JAX package's 24 names) built on the
   card, run once op by op and, where its block goes through the graph
   store, captured there and replayed, and then once more inside an armed
   ``guards.guarded_launch`` window under ``torch.profiler``: no
   ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or device-to-host
   copy inside a core's call (the profiler's host trace, beyond what
   ``torch.cuda.set_sync_debug_mode`` sees), each replay bit for bit its op
   by op result, and each kernel core launching its own kernel, by the name
   the profiler prints, as many times as its library's
   ``entry_launches`` count, and no cuBLAS or cuSPARSE kernel in its launch;
15. the leximin profile certificate (``highs_backend.audit_leximin_profile``)
   of every finished LEXIMIN path: the defaults flagship, the mass_like and
   example_small_like pools, the agent-space run on the n=120 pool, the
   stage-CG run that prices on the n=80 pool, each on its pool's instance,
   and the n=400 and n=1200 household runs on their quotient's augmented
   instance, each on the run's certified profile. Each audit is host work:
   it starts in a worker process as soon as its path returns, while the
   card goes on, and is collected before the summary. Where the audit
   leaves a level above its bar (its witness comes from the marginal
   relaxation, which has an integrality gap on small pools: 0.01 at level 2
   of the n=80 pool), an exact bound by column generation in agent space
   with the exact MILP joins that level's two bounds. A path fails unless
   every level is then within ``PROFILE_GAP`` (the exact-MILP bounds alone
   within ``PROFILE_GAP_MILP``) and no level's bound lies under what it
   achieved; an audit that raises fails its path;
16. the nationwide dual LP (:func:`nationwide_dual_problem`: 2,048
   feasible panels of a nationwide registry of n = 100,000, k = 316, every
   agent unfixed, as the JAX package's ``dist`` bench family builds it; y
   of T = 100,001, more than a block's shared memory holds, so the gather
   reads it from the L2): ``gather_nationwide`` holds the gather kernel
   against its plain version on that LP's pack (k_pad 320; float32 and
   bf16 values, one lane, three with shared and with per-lane values, a
   NaN at ``y[0]``), holds the L2 route forced at the flagship and XMIN
   packs bit for bit the staged route, and times both routes hot and
   L2-flushed beside the bound and ``torch.sparse.mm``;
   ``dual_lp_nationwide`` solves the LP by the row-sharded PDHG on the
   one-rank mesh (ELL route), by ``solve_dual_lp_pdhg`` at the defaults
   (the LP kernel in one launch on its global-x̄ route: x̄'s 100,001 floats
   do not fit a block's shared memory) and by the same forced chained,
   each converged, within ``SHARDED_DUAL_TOL`` of HiGHS (in a worker
   process) and of the LP's feasible set, with its gathers on the L2 route
   only and no quarantine, the kernel's answer within the same of the
   chained one's; then holds two blocks of the LP kernel against its plain
   version on that LP and times the kernel's own solve.

Prints one JSON line per phase, the ``{"kernels": [...]}`` summary, the card
line, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero, with no result line, when CUDA is absent or the package cannot
be imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: the JAX package's Pallas kernel each CUDA kernel replaces
REPLACES = {
    "ell_gather": "citizensassemblies_tpu/kernels/ell_matvec.py:42",
    "two_sided_block": "citizensassemblies_tpu/kernels/pdhg_megakernel.py:161",
    "lp_block": "citizensassemblies_tpu/kernels/pdhg_megakernel.py:646",
}

GATHER_TOL = 1e-4
#: kernel vs plain two-sided solve on the same prelude output. Both sum in
#: float32 and differ only in the order of their sums (measured on the card:
#: a few 1e-9 on x, about 1e-8 on lambda, 0 on the objective). At C=6144 an
#: entry of x is about 1/C, near 1.6e-4, so 1e-6 is under 1 % of one.
SOLVE_X_TOL = 1e-6
SOLVE_LAM_TOL = 1e-6
SOLVE_OBJ_TOL = 1e-7
#: the face loop's master tolerance at the flagship, 0.02 * the 6.5e-4 bar
MASTER_TOL = 0.02 * 6.5e-4
SOLVE_MAX_ITERS = 8192

#: kernel vs plain generic-LP solve on the same prelude output: float32 sums
#: in another order only, so the same bars as the two-sided solve
LP_X_TOL = 1e-6
LP_LAM_TOL = 1e-6
LP_OBJ_TOL = 1e-7
#: the agent-space path's own PDHG tolerance and iteration cap (Config
#: defaults). The flagship dual LP does not meet 1e-6 before the cap (KKT
#: 2.7e-6 there), so kernel and plain version are compared for equal
#: iteration counts at LP_CHECK_TOL, which it meets in the first few
#: thousand iterations, while its residual falls fast from block to block.
#: Later the residual moves by about a per cent a block and wavers with the
#: restarts, and float32 sums taken in two orders stop blocks apart: on the
#: card, 65,920 against 64,128 iterations at 5.5e-6 and 11,904 against
#: 11,648 at 1e-4. That late regime is held at a fixed length instead:
#: tolerance 0 and LP_FIXED_ITERS iterations in both versions, with equal
#: flags. There the objective, which is unique, is held at LP_OBJ_TOL, and
#: x and λ at LP_FIXED_X_TOL: each block restarts from the averaged or the
#: current iterate, whichever has the smaller residual, and where the two
#: nearly tie, sums in another order pick the other; the runs then go on
#: from points a residual apart, on a degenerate LP whose optimal y is not
#: unique. On the card both reached KKT near 6e-6 there (6.5e-6 and 5.8e-6
#: on an NVIDIA H100 80GB HBM3 at 700 W), 8.1e-6 apart on x and 7.3e-6 on
#: λ, 4.5e-9 on the objective.
LP_TOL = 1e-6
LP_MAX_ITERS = 100_000
LP_CHECK_TOL = 1e-3
LP_FIXED_ITERS = 65_536
LP_FIXED_X_TOL = 1e-5
#: the one-block LP solves held route against route at the sf_b dual
LP_ONE_BLOCK_ITERS = 4096
#: blocks of the LP kernel held against its plain version at the
#: nationwide dual LP (check_every iterations each), and the bar there: x,
#: λ and μ each within NATIONWIDE_CHECK_REL_TOL of its own largest entry.
#: y sums to 1 over 100,000 agents, so its typical entry is about 1e-5 and
#: its largest 8e-4 after two blocks: LP_X_TOL would be an eighth of that.
#: Float32 sums in another order leave 2.5e-6 of it on ŷ (an NVIDIA H100
#: 80GB HBM3 at 700 W; the record's rel_err_by).
NATIONWIDE_CHECK_BLOCKS = 2
NATIONWIDE_CHECK_REL_TOL = 1e-5
#: agent-space vs type-space sorted allocation profile
#: (tests/test_certification.py's bar)
PROFILE_TOL = 1e-3
#: the agent-space path on sf_b_skewed_instance(seed=1) (n=250, k=20), the
#: smallest real-size pool whose dual LPs take the LP kernel (the sf_c and
#: mass pools' fill is above the ELL cutoff): its column generation does not
#: finish its first stage in six minutes on the card, as the JAX package's
#: PDHG does not meet 1e-6 within the cap on most of its dual LPs either
#: (tests/test_torch_sf_dual.py), so it runs under a budget per stage and in
#: all, short enough to keep the whole run well inside its time limit (the
#: first stage ends within none of 20, 30, 45 and 90 s; 20 s since the
#: checkpoint and fault phases came in, 12 since the nationwide phases did:
#: the whole script read 1,221.0 s with them on an NVIDIA H100 80GB HBM3 at
#: 700 W whose host was slow)
STAGE_BUDGET_S = 12.0
AGENT_BUDGET_S = 19.0
#: the polish screen's lanes at the flagship: nested prefixes of a
#: 2048-column support (face_decompose.polish_support), each to a quarter of
#: the master tolerance within 24,576 iterations, warm from a master solve;
#: held to the plain version at the bars of the other two-sided phases
#: (SOLVE_X_TOL, SOLVE_LAM_TOL, each lane's ε at SOLVE_OBJ_TOL), iterations
#: equal. The two narrower lanes run to the cap, so their x, λ and ε, not
#: their iteration counts, are what holds them.
SCREEN_CAPS = [512, 1024, 2048]
SCREEN_MAX_ITERS = 24_576
#: the stage-CG fallback on sf_b_skewed_instance(seed=1), forced by an
#: acceptance bar the face loop cannot meet: its budget in all. It finished
#: its 12 stages in 83-85 s under the 120 s budget of PRs 5-10; 40 s in
#: slice 11 and 25 s since slice 12, whose phases need the time, so the
#: run stops after its first stages (the fallback and at least one stage
#: are held)
STAGE_CG_BUDGET_S = 25.0
#: the face loop's bar there, and its rounds: the loop realizes the sf_b
#: profile exactly (at a bar of 1e-7 on the card in 9 rounds; ε = 0 from
#: the host LP on the CPU), so only a bar no residual meets makes it stall;
#: four rounds bound the loop before the fallback
STAGE_CG_ACCEPT = -1.0
STAGE_CG_ROUNDS = 4
#: the fallback's pricing half: on sf_b every stage meets its relaxation
#: bound from the carried-in support and injected columns, so no stage
#: prices. On skewed_instance(n=80, k=8, n_categories=3, seed=3), the pool
#: of tests/test_torch_stage_cg.py, a bar of 1e-7 stalls the face loop and
#: later stages price (stochastic draws and the exact MILP); its fixed
#: probabilities are held to the same run on the CPU at that test's bar
STAGE_CG_PRICING_ACCEPT = 1e-7
STAGE_CG_FIXED_TOL = 1e-6

#: the dense chained PDHG's graph replay against its eager blocks: a stage
#: LP of sf_b (its leximin relaxation sliced into 384 columns, nothing
#: fixed), which does not converge before this cap
DENSE_GRAPH_MAX_ITERS = 10_240

E2E_CONTRACT = 1e-3

#: what every clean phase must show: no sentinel quarantine, no host
#: re-solve (a kernel fault in a clean run must not hide behind either)
FAULT_KEYS = ("sentinel_poisoned", "sentinel_quarantined", "robust_host_resolve")
#: the demotion counters (utils/precision.py)
MP_KEYS = ("mp_demoted_operands", "mp_lossy_skip")
#: checkpoint_flagship's kill: face_abort at this rate and seed fires at the
#: third consultation (the start of round 2 of the first attempt, after its
#: round-0 and round-1 checkpoints) and at none of the next 15 (the
#: resumed attempt's rounds), by the injector's deterministic schedule
CKPT_ABORT = ("face_abort:0.3", 2012)
#: faults_flagship's pdhg_nan schedule: fires at the first master only
PDHG_NAN_FIRST = ("pdhg_nan:0.25", 270)
#: Monte-Carlo draws of the scenario phases (``bench.py --scenarios``'s)
SCENARIO_DRAWS = 65_536
#: churn_nationwide's depth cuts of ``churn_bench``'s 1,000 edits and 6
#: from-scratch samples per edit class (up to 30): the first 15 edits, at
#: most 3 samples (about 6 s each), at most 2 a class. Every quota or
#: new-type edit re-runs the composition ladder, 3-7 s an edit on an NVIDIA
#: H100 80GB HBM3 at 700 W: the first 200 edits took 220 s there; with the
#: serving phases the whole script took 1,159 s of its 1,200 s limit at 100
#: edits and 8 samples (26 full ladders, 190 s), 1,095 s at 50 (105 s) and
#: 994.5 s at 30 edits and 5 samples (60.9 s); 15 edits and 3 samples made
#: room for phase 13 (the graph store's child processes); 10 edits since the
#: whole script read 1,077.6 s at 15 (a slower host, no phase added); 2
#: samples since it read 1,221.0 s with phase 16 (the nationwide dual LP;
#: the same card and host)
CHURN_EDITS = 10
CHURN_SCRATCH = 2
CHURN_SCRATCH_PER_CLASS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fault_counts(counters) -> dict:
    """The quarantine and host re-solve counters of a run (``FAULT_KEYS``)."""
    return {k: int(counters.get(k, 0)) for k in FAULT_KEYS}


def clean(counters) -> bool:
    """No quarantine and no host re-solve in the run."""
    return not any(fault_counts(counters).values())


def mp_counts(counters) -> dict:
    return {k: int(counters.get(k, 0)) for k in MP_KEYS}


def face_profiles(store: list):
    """A stand-in for ``face_decompose.realize_profile`` that appends each
    face loop's realized type profile ``(C/m)ᵀ p`` and its distance to the
    target ``‖(C/m)ᵀ p − v‖∞`` to ``store`` (the quantity the loop
    certifies, which the JAX package's checkpoint test compares)."""
    from citizensassemblies_tpu_torch.solvers import face_decompose

    realize = face_decompose.realize_profile

    def recorded(reduction, v, *a, **kw):
        out = realize(reduction, v, *a, **kw)
        profile = (out[0].astype(np.float64) / reduction.msize[None, :]).T @ out[1]
        store.append((profile, float(np.abs(profile - v).max())))
        return out

    return recorded


def bf16_gathers() -> int:
    """The gather's bf16-value launches since its counters were zeroed,
    on both of ``y``'s routes."""
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    return sum(c for key, c in em.KERNEL.entry_launches.items()
               if key.startswith("ell_gather_bf16_launch"))


def global_x_lps() -> int:
    """The LP kernel's launches on the global-x̄ route since its counters
    were zeroed."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    return sum(c for key, c in mk.LP_KERNEL.entry_launches.items()
               if key.endswith("." + mk.GLOBAL_X_ROUTE))


def l2_gathers() -> int:
    """The gather's launches on the L2 route (``y`` not staged) since its
    counters were zeroed, float32 and bf16 values."""
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    return sum(c for key, c in em.KERNEL.entry_launches.items()
               if key.endswith("." + em.L2_ROUTE))


def cuda_ms(fn, reps: int = 1, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, name: str = None, flush_l2: bool = False) -> float:
    """Device milliseconds per ``fn()`` call: the summed self time of every
    GPU kernel the profiler saw over ``reps`` calls (only those whose name
    holds ``name``, when given), divided by ``reps``; NaN when the profiler
    recorded no device time. ``flush_l2``: before each call, write a 64 MiB
    buffer, more than the 50 MB L2, so the call finds its inputs in HBM."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda") if flush_l2 else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if name is not None and name not in evt.key:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        total_us += float(t or 0.0)
    return total_us / 1e3 / reps if total_us > 0 else float("nan")


def timed(fn, reps: int, warmup: int):
    """``(ms, call_ms)``: device time per call from the profiler (the event
    time where the profiler saw none) and the event time per call, which
    includes the host's launch overhead."""
    call_ms = cuda_ms(fn, reps=reps, warmup=warmup)
    dev = device_ms(fn, reps)
    return (dev if dev == dev else call_ms), call_ms


def flagship_pack(C: int = 6144, seed: int = 0):
    """A composition pack at the flagship shape: ``C`` random 110-member
    panels of the ``sf_e_skewed_instance(seed=1)`` pool as type counts over
    the T=814 types, scaled by 1/msize (the master's column scaling).
    Returns ``(EllPack, MT float64 [T, C], msize)``."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    dense, _ = featurize(sf_e_skewed_instance(seed=1), device="cpu")
    red = TypeReduction(dense)
    rng = np.random.default_rng(seed)
    comps = np.zeros((C, red.T), np.float64)
    for c in range(C):
        members = rng.choice(red.n, size=red.k, replace=False)
        np.add.at(comps[c], red.type_id[members], 1.0)
    rows = comps / red.msize[None, :]
    return EllPack.from_rows(rows.astype(np.float32), minor=red.T), rows.T, red.msize


def gather_plan_record(plan) -> dict:
    """The gather kernel's launch plan (``kernels/ell_matvec.launch_plan``)
    as a phase line records it."""
    return dict(blocks=plan.blocks * plan.B, blocks_per_sm=plan.blocks_per_sm, threads=plan.threads,
                lanes_per_column=plan.G, ring_stages=plan.tma_warps, stage_bytes=plan.stage_bytes,
                prefetch_bytes=plan.prefetch_bytes, smem_bytes=plan.smem_bytes)


def gather_phase(pack, rows=6144, label="gather"):
    """The ELL gather kernel against its plain version and against one
    ``torch.sparse.mm`` over a CSR of the same matrix (a yardstick only),
    over the pack padded to ``rows`` rows."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    dev = torch.device("cuda")
    launches0 = em.KERNEL.launches
    idx_np, val_np = pack.padded(rows)
    C, kp = idx_np.shape
    T = pack.minor
    idx = torch.as_tensor(idx_np, device=dev)
    val = torch.as_tensor(val_np, device=dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    y = torch.randn(T, generator=g).to(dev)
    yb = torch.randn((3, T), generator=g).to(dev)
    valb = (val[None] * torch.rand((3, 1, 1), generator=g).to(dev)).contiguous()

    z = em.ell_gather_mv(idx, val, y)
    zb = em.ell_gather_mv(idx, valb, yb)
    torch.cuda.synchronize()
    err = max(
        float((z - em.ell_gather_mv_plain(idx, val, y)).abs().max()),
        float((zb - em.ell_gather_mv_plain(idx, valb, yb)).abs().max()),
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = em.launch_plan(C, kp, T, 1, sms)
    plan_b3 = em.launch_plan(C, kp, T, 3, sms)
    ms, call_ms = timed(lambda: em.ell_gather_mv(idx, val, y), reps=200, warmup=10)
    # the pack as a caller finds it when the L2 holds other data (the
    # timing above reads it from L2, where it stays across the 200 calls)
    flushed_ms = device_ms(lambda: em.ell_gather_mv(idx, val, y), 50, "ell_gather", flush_l2=True)
    b3_ms = device_ms(lambda: em.ell_gather_mv(idx, valb, yb), 200, "ell_gather")
    plain_ms, plain_call_ms = timed(lambda: em.ell_gather_mv_plain(idx, val, y), reps=200, warmup=10)
    rows = torch.as_tensor(np.repeat(np.arange(C), kp), device=dev)
    keep = val.reshape(-1) != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], idx.reshape(-1)[keep].long()]), val.reshape(-1)[keep], (C, T)
    ).coalesce()
    csr = coo.to_sparse_csr()
    ycol = y[:, None].contiguous()
    lib_err = float((torch.sparse.mm(csr, ycol)[:, 0] - z).abs().max())
    library_ms, library_call_ms = timed(lambda: torch.sparse.mm(csr, ycol), reps=200, warmup=10)
    # each input read once (the padded pack, y), the output written once,
    # at the HBM rate (obs/roofline.gather_cost): the bound of the flushed
    # time. The hot time (ms) reads a pack that fits the 50 MB L2 from the
    # L2 and may fall below it
    from citizensassemblies_tpu_torch.obs import roofline

    bound_ms, _by = roofline.bound(roofline.gather_cost(C, kp, T))
    rec = dict(
        phase=label, name="ell_gather", replaces=REPLACES["ell_gather"],
        shape=dict(C=C, k_pad=kp, T=T, lanes=[1, 3]),
        plan=gather_plan_record(plan), plan_b3=gather_plan_record(plan_b3),
        ms=ms, l2_flushed_ms=flushed_ms, b3_ms=b3_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_err=lib_err,
        call_ms=call_ms, plain_call_ms=plain_call_ms, library_call_ms=library_call_ms,
        bound_ms=bound_ms, bound_by="bytes", bound_pairs_with="l2_flushed_ms",
        flushed_bound_share=bound_ms / flushed_ms, max_abs_err=err, tolerance=GATHER_TOL,
        launches=em.KERNEL.launches - launches0, ok=err <= GATHER_TOL,
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"gather kernel disagrees with its plain version: {err}")
    return rec


def gather_bf16_phase(pack, label="gather_xmin_bf16"):
    """The gather kernel's bf16-value path on a 0/1 pack (XMIN's portfolio,
    the operand mixed precision demotes): held bit for bit against the
    float32 path on the same values (one lane and three), and against the
    plain version at ``GATHER_TOL``. Both paths timed in this one call, hot
    (the pack in the L2) and with the L2 flushed before each call; the bound
    counts 2-byte values beside the 4-byte indices."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em

    dev = torch.device("cuda")
    idx_np, val_np = pack.padded(len(pack))
    C, kp = idx_np.shape
    T = pack.minor
    idx = torch.as_tensor(idx_np, device=dev)
    val = torch.as_tensor(val_np, device=dev)
    val16 = val.to(torch.bfloat16)
    lossless = bool(torch.equal(val16.float(), val))
    g = torch.Generator(device="cpu").manual_seed(1)
    y = torch.randn(T, generator=g).to(dev)
    yb = torch.randn((3, T), generator=g).to(dev)
    entry0 = bf16_gathers()
    z16, z32 = em.ell_gather_mv(idx, val16, y), em.ell_gather_mv(idx, val, y)
    zb16, zb32 = em.ell_gather_mv(idx, val16, yb), em.ell_gather_mv(idx, val, yb)
    torch.cuda.synchronize()
    bf16_launched = bf16_gathers() - entry0
    bitwise = bool(torch.equal(z16, z32) and torch.equal(zb16, zb32))
    err = max(
        float((z16 - em.ell_gather_mv_plain(idx, val16, y)).abs().max()),
        float((zb16 - em.ell_gather_mv_plain(idx, val16, yb)).abs().max()),
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = em.launch_plan(C, kp, T, 1, sms, bf16=True)
    ms, call_ms = timed(lambda: em.ell_gather_mv(idx, val16, y), reps=200, warmup=10)
    flushed_ms = device_ms(lambda: em.ell_gather_mv(idx, val16, y), 50, "ell_gather", flush_l2=True)
    f32_ms = device_ms(lambda: em.ell_gather_mv(idx, val, y), 200, "ell_gather")
    f32_flushed_ms = device_ms(lambda: em.ell_gather_mv(idx, val, y), 50, "ell_gather", flush_l2=True)
    plain_ms, plain_call_ms = timed(lambda: em.ell_gather_mv_plain(idx, val16, y), reps=200, warmup=10)
    # each input read once (int32 indices, bf16 values, y), the output
    # written once, at the HBM rate: the bound of the flushed time
    from citizensassemblies_tpu_torch.obs import roofline

    bound_ms, _by = roofline.bound(roofline.gather_cost(C, kp, T, value_bytes=2))
    f32_bound_ms, _by = roofline.bound(roofline.gather_cost(C, kp, T))
    rec = dict(
        phase=label, name="ell_gather", entry="ell_gather_bf16_launch",
        replaces=REPLACES["ell_gather"], shape=dict(C=C, k_pad=kp, T=T, lanes=[1, 3]),
        plan=gather_plan_record(plan), plan_b3=gather_plan_record(
            em.launch_plan(C, kp, T, 3, sms, bf16=True)),
        lanes_per_column_f32=em.lanes_per_column(kp), lossless=lossless,
        bitwise_vs_f32=bitwise, ms=ms, l2_flushed_ms=flushed_ms, f32_ms=f32_ms,
        f32_l2_flushed_ms=f32_flushed_ms, plain_ms=plain_ms, call_ms=call_ms,
        plain_call_ms=plain_call_ms, bound_ms=bound_ms, f32_bound_ms=f32_bound_ms,
        bound_by="bytes", bound_pairs_with="l2_flushed_ms",
        flushed_bound_share=bound_ms / flushed_ms, max_abs_err=err, tolerance=GATHER_TOL,
        bf16_launches=bf16_launched,
    )
    rec["ok"] = bool(lossless and bitwise and err <= GATHER_TOL and bf16_launched == 2)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"the gather's bf16 path disagrees: bitwise {bitwise}, err {err}")
    return rec


def bits_equal(a, b) -> bool:
    """Same float32 bits (NaNs included)."""
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def planned_gather(plan, idx, val, Y):
    """The gather kernel launched at ``plan`` (a :func:`~citizensassemblies_tpu_torch.
    kernels.ell_matvec.launch_plan`, its route forced or not) on ``Y [B,
    T]``: a launch the wrapper's counters do not see; ``[B, C]``."""
    import ctypes

    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels.cuda_lib import ptr, stream_of

    C, kp = idx.shape
    B, T = Y.shape
    dev = Y.device.index if Y.device.index is not None else torch.cuda.current_device()
    if dev not in em._READY:
        em._setup(dev)
    out = torch.empty((B, C), dtype=torch.float32, device=Y.device)
    em.KERNEL.run(
        "ell_gather_bf16_launch" if plan.bf16 else "ell_gather_launch",
        ptr(idx), ptr(val), ctypes.c_longlong(C * kp if val.dim() == 3 else 0), ptr(Y), ptr(out),
        B, T, C, kp, plan.G, plan.threads, plan.blocks, plan.tma_warps, int(plan.stage_y),
        stream_of(Y),
    )
    return out


def gather_cases(idx, val, T, seed):
    """``{case: (val, Y)}`` on the card for a pack ``idx``/``val`` over a
    ``y`` of ``T``: float32 and bf16 values (the pack's values rounded to
    bf16), one lane, three lanes with shared values and three with per-lane
    values, drawn from ``seed``."""
    import torch

    dev = idx.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    y1 = torch.randn((1, T), generator=g).to(dev)
    y3 = torch.randn((3, T), generator=g).to(dev)
    lane = (val[None] * torch.rand((3, 1, 1), generator=g).to(dev)).contiguous()
    out = {}
    for tag, v, vl in (("f32", val, lane), ("bf16", val.to(torch.bfloat16),
                                            lane.to(torch.bfloat16))):
        out[f"{tag}_b1"] = (v, y1)
        out[f"{tag}_b3"] = (v, y3)
        out[f"{tag}_b3_lane"] = (vl, y3)
    return out


def nationwide_pack(panels, n):
    """The nationwide dual LP's ``G = [P, −1]`` (``P`` the panels'
    incidence over ``n`` agents) packed as the sharded ELL route packs it
    (``sparse_ops.ell_pack_rows`` of the dense rows): each panel's sorted
    members at 1, then the ŷ column at −1, then empty slots. Built from the
    member lists; the first row is checked against ``ell_pack_rows``.
    Returns ``(idx, val)`` numpy arrays."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import ell_pack_rows

    m1, k = panels.shape
    row = np.zeros((1, n + 1), np.float32)
    row[0, panels[0]] = 1.0
    row[0, n] = -1.0
    idx0, val0, _nnz = ell_pack_rows(row)
    idx = np.zeros((m1, idx0.shape[1]), np.int32)
    val = np.zeros(idx.shape, np.float32)
    idx[:, :k], val[:, :k] = np.sort(panels, axis=1), 1.0
    idx[:, k], val[:, k] = n, -1.0
    assert np.array_equal(idx[:1], idx0) and np.array_equal(val[:1], val0)
    return idx, val


def gather_nationwide_phase(panels, n, flagship, xmin, label="gather_nationwide"):
    """The gather at the nationwide dual LP's pack (:func:`nationwide_pack`
    of :func:`nationwide_dual_problem`'s panels over ``n`` agents; y of
    n + 1 = 100,001, beyond a block's shared memory, so the plan takes the
    L2 route): every case of :func:`gather_cases` and a NaN at ``y[0]``
    against the plain version at ``GATHER_TOL``; the L2 route forced
    (``stage_y=False``, launched by :func:`planned_gather`) at the
    flagship's and XMIN's packs (EllPacks ``flagship`` and ``xmin``), bit
    for bit the staged route in every case there; device times hot and
    with the L2 flushed on both routes, the bytes bound
    (``obs/roofline.gather_cost``) and one ``torch.sparse.mm`` over a CSR
    of the same matrix (a yardstick only)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.obs import roofline

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    idx_np, val_np = nationwide_pack(panels, n)
    C, kp = idx_np.shape
    T = n + 1
    idx = torch.as_tensor(idx_np, device=dev)
    val = torch.as_tensor(val_np, device=dev)
    plans = {b: em.launch_plan(C, kp, T, b, sms) for b in (1, 3)}
    l2_0 = l2_gathers()
    errs, nan_ok = {}, True
    for case, (v, Y) in gather_cases(idx, val, T, seed=4).items():
        z = em.ell_gather_mv(idx, v, Y)
        torch.cuda.synchronize()
        errs[case] = float((z - em.ell_gather_mv_plain(idx, v, Y)).abs().max())
        ynan = Y.clone()
        ynan[:, 0] = float("nan")
        zn = em.ell_gather_mv(idx, v, ynan)
        nan_ok = nan_ok and bool(torch.equal(torch.isnan(zn),
                                             torch.isnan(em.ell_gather_mv_plain(idx, v, ynan))))
    torch.cuda.synchronize()
    l2_launched = l2_gathers() - l2_0
    err = max(errs.values())
    y = torch.randn(T, generator=torch.Generator(device="cpu").manual_seed(5)).to(dev)
    val16 = val.to(torch.bfloat16)
    # two turns of hot and flushed windows each (a single flushed window
    # now and then reads far below its neighbours); the means are reported
    times = {}
    for tag, v in (("f32", val), ("bf16", val16)):
        turns = [(device_ms(lambda: em.ell_gather_mv(idx, v, y), 200, "ell_gather"),
                  device_ms(lambda: em.ell_gather_mv(idx, v, y), 50, "ell_gather", flush_l2=True))
                 for _ in range(2)]
        times[tag] = dict(
            ms=float(np.mean([t[0] for t in turns])),
            l2_flushed_ms=float(np.mean([t[1] for t in turns])), turns_ms=turns,
            bound_ms=roofline.bound(roofline.gather_cost(C, kp, T, value_bytes=v.element_size()))[0],
        )
    plain_ms, _ = timed(lambda: em.ell_gather_mv_plain(idx, val, y), reps=50, warmup=5)
    keep = val.reshape(-1) != 0
    rows = torch.arange(C, device=dev).repeat_interleave(kp)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows[keep], idx.reshape(-1)[keep].long()]), val.reshape(-1)[keep], (C, T)
    ).coalesce().to_sparse_csr()
    ycol = y[:, None].contiguous()
    lib_err = float((torch.sparse.mm(csr, ycol)[:, 0] - em.ell_gather_mv(idx, val, y)).abs().max())
    library_ms, _ = timed(lambda: torch.sparse.mm(csr, ycol), reps=200, warmup=10)
    # the L2 route forced where y fits: bit for bit the staged route, and
    # what it costs there
    forced = {}
    bitwise = True
    for name, pack in (("flagship", flagship), ("xmin", xmin)):
        fi_np, fv_np = pack.padded(len(pack))
        fi = torch.as_tensor(fi_np, device=dev)
        fv = torch.as_tensor(fv_np, device=dev)
        Cf, kpf = fi.shape
        same = {}
        for case, (v, Y) in gather_cases(fi, fv, pack.minor, seed=6).items():
            route = {sy: em.launch_plan(Cf, kpf, pack.minor, Y.shape[0], sms,
                                        bf16=v.dtype == torch.bfloat16, stage_y=sy)
                     for sy in (True, False)}
            staged = planned_gather(route[True], fi, v, Y)
            l2 = planned_gather(route[False], fi, v, Y)
            torch.cuda.synchronize()
            same[case] = bits_equal(staged, l2)
        bitwise = bitwise and all(same.values())
        yf = torch.randn((1, pack.minor),
                         generator=torch.Generator(device="cpu").manual_seed(7)).to(dev)
        route = {sy: em.launch_plan(Cf, kpf, pack.minor, 1, sms, stage_y=sy) for sy in (True, False)}
        forced[name] = dict(
            C=int(Cf), k_pad=int(kpf), T=int(pack.minor), bitwise=same,
            plan_l2=gather_plan_record(route[False]),
            bound_ms=roofline.bound(roofline.gather_cost(Cf, kpf, pack.minor))[0],
        )
        for tag, sy in (("staged", True), ("l2", False), ("l2_again", False),
                        ("staged_again", True)):
            forced[name][f"{tag}_ms"] = device_ms(
                lambda: planned_gather(route[sy], fi, fv, yf), 200, "ell_gather")
            forced[name][f"{tag}_l2_flushed_ms"] = device_ms(
                lambda: planned_gather(route[sy], fi, fv, yf), 50, "ell_gather", flush_l2=True)
    rec = dict(
        phase=label, name="ell_gather", replaces=REPLACES["ell_gather"],
        shape=dict(C=int(C), k_pad=int(kp), T=int(T), lanes=[1, 3]),
        plan=gather_plan_record(plans[1]), plan_b3=gather_plan_record(plans[3]),
        stage_y=plans[1].stage_y, ms=times["f32"]["ms"],
        l2_flushed_ms=times["f32"]["l2_flushed_ms"], turns_ms=times["f32"]["turns_ms"],
        bound_ms=times["f32"]["bound_ms"],
        bound_by="bytes", bound_pairs_with="l2_flushed_ms", bf16=times["bf16"],
        plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=lib_err,
        max_abs_err=err, case_errors=errs, nan_at_y0=nan_ok, tolerance=GATHER_TOL,
        l2_launches=l2_launched, forced_l2=forced, forced_l2_bitwise=bitwise,
        seconds=time.perf_counter() - t0,
    )
    rec["ok"] = bool(err <= GATHER_TOL and nan_ok and bitwise and not plans[1].stage_y
                     and not plans[3].stage_y and l2_launched == 2 * len(errs))
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"the gather's L2 route disagrees: err {err}, NaN {nan_ok}, "
                         f"bitwise {bitwise}, L2 launches {l2_launched}")
    return rec


def flagship_target(MT):
    """The target the flagship master phases solve for: the profile of a
    random mixture of the first 1536 columns (so each LP has optimum 0)."""
    rng = np.random.default_rng(1)
    p_true = np.zeros(MT.shape[1])
    p_true[:1536] = rng.dirichlet(np.ones(1536))
    return MT @ p_true


def _solve_lanes(pack, MT, caps, nan_lane=None, max_iters=SOLVE_MAX_ITERS):
    """Inputs of a B-lane two-sided solve over the flagship pack: lane b
    sees the first ``caps[b]`` columns; ``v`` is realizable by the first
    1536 columns, so every lane's LP has optimum 0. Lane b's tolerance is
    the face loop's master tolerance scaled by ``C / caps[b]`` (a narrower
    lane converges more slowly), so every lane stops on its tolerance well
    before ``max_iters`` and its iteration count is a check of its own."""
    import torch

    dev = torch.device("cuda")
    T, C = MT.shape
    v = flagship_target(MT)
    B = len(caps)
    colmask = np.zeros((B, C), np.float32)
    for b, cap in enumerate(caps):
        colmask[b, :cap] = 1.0
    x0 = np.zeros((B, C + 1), np.float32)
    if nan_lane is not None:
        x0[nan_lane, 0] = np.nan
    f32 = dict(dtype=torch.float32, device=dev)
    idx_np, val_np = pack.padded(C)
    tol = np.array([MASTER_TOL * C / cap for cap in caps], np.float32)
    lanes = (
        torch.as_tensor(v.astype(np.float32), **f32), torch.as_tensor(colmask, **f32),
        torch.as_tensor(x0, **f32), torch.zeros((B, 2 * T), **f32),
        torch.zeros(B, **f32), torch.as_tensor(tol, **f32),
    )
    return idx_np, val_np, lanes, dict(max_iters=max_iters, check_every=128, sentinel=True)


def two_sided_bound(C, kp, T, nnz, B, iters, check_every):
    """``(bound_ms, bound_by, iter_bytes_ms)`` of a B-lane two-sided solve
    that took ``iters`` per lane (``obs/roofline.two_sided_cost``): the
    least the card could take, and the time to read the pack once per
    evaluation in both layouts."""
    from citizensassemblies_tpu_torch.obs import roofline

    cost = roofline.two_sided_cost(C, kp, T, nnz, B, [int(i) for i in iters], check_every)
    return roofline.bound(cost) + (roofline.stream_ms(cost),)


def solve_phase(pack, MT, caps, label, nan_lane=None, clean=None, repeat=False):
    """One two-sided solve through the block kernel and through its plain
    version, on the same prelude output on the card. With ``nan_lane`` the
    clean run's prelude is reused and that lane's warm start is poisoned,
    so the lane's mates must match the clean kernel run bit for bit. With
    ``repeat`` a second prelude is built from the same inputs, which must
    equal the first bit for bit, and the kernel solves again from it, which
    must give the same x, λ and iterations bit for bit."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import unscale

    launches0 = mk.KERNEL.launches
    idx_np, val_np, lanes, kw = _solve_lanes(pack, MT, caps)
    v, colmask, x0, lam0, mu0, tol = lanes
    T = v.shape[0]
    B = len(caps)

    def prepare():
        csr, plan = mk.two_sided_launch_inputs(idx_np, val_np, T, B, v.device)
        return (csr, plan) + mk.two_sided_setup(idx_np, val_np, v, colmask, x0, lam0, mu0, csr)

    if clean is None:
        box = {}
        # the prelude on the card (with the host's CSR transpose and plan)
        prelude_ms = cuda_ms(lambda: box.update(v=prepare()), reps=1, warmup=0)
        prepared = box["v"]
    else:
        prelude_ms, prepared = None, clean["prepared"]
    csr, plan, idx, vals_s, pre, state = prepared
    if nan_lane is not None:
        p_bad = state[0].clone()
        p_bad[nan_lane, 0] = float("nan")
        state = (p_bad,) + tuple(state[1:])
    out_k = {}

    def run_kernel():
        out_k["v"] = mk.two_sided_blocks_cuda(csr, plan, idx, vals_s, pre, state, tol, **kw)

    out_p = {}

    def run_plain():
        out_p["v"] = mk.two_sided_blocks_plain(csr, idx, vals_s, pre, state, tol, **kw)

    # one launch per solve: its CUDA-event time is its device time (with the
    # wrapper's few setup ops); the profiler's total is kept beside it
    profiler_ms, ms = timed(run_kernel, reps=1, warmup=1)
    plain_ms = cuda_ms(run_plain, reps=1, warmup=0)
    k_out, p_out = out_k["v"], out_p["v"]
    xk, lk, _ = unscale(pre, *k_out[:5])
    xp, lp, _ = unscale(pre, *p_out[:5])
    it_k = k_out[5].cpu().numpy()
    it_p = p_out[5].cpu().numpy()
    res_k = k_out[6].cpu().numpy()
    flags_k = k_out[7].cpu().numpy()
    live = [b for b in range(B) if b != nan_lane]
    xk_n, xp_n = xk.cpu().numpy(), xp.cpu().numpy()
    lk_n, lp_n = lk.cpu().numpy(), lp.cpu().numpy()
    err_x = float(np.abs(xk_n[live] - xp_n[live]).max())
    err_lam = float(np.abs(lk_n[live] - lp_n[live]).max())
    err_obj = float(np.abs(xk_n[live, -1] - xp_n[live, -1]).max())
    # every live lane must stop on its tolerance, before the iteration cap,
    # after the same number of iterations in both versions
    tol_n = tol.cpu().numpy()
    converged = bool(np.all(res_k[live] <= tol_n[live]) and np.all(it_k[live] < kw["max_iters"]))
    same_iters = bool(np.array_equal(it_k[live], it_p[live]))
    ok = (
        err_x <= SOLVE_X_TOL and err_lam <= SOLVE_LAM_TOL and err_obj <= SOLVE_OBJ_TOL
        and converged and same_iters
    )
    notes = dict(converged=converged, same_iters=same_iters)
    if nan_lane is not None:
        quarantined = (
            int(it_k[nan_lane]) == 0 and not np.isfinite(res_k[nan_lane])
            and bool(flags_k[nan_lane] & 1)
        )
        notes["nan_lane_quarantined"] = quarantined
        ok = ok and quarantined
        if clean is not None:
            same = all(
                np.array_equal(xk_n[b], clean["x"][b]) and int(it_k[b]) == int(clean["it"][b])
                for b in live
            )
            notes["mates_bit_identical"] = same
            ok = ok and same
    if repeat:
        csr2, plan2, idx2, vals2, pre2, state2 = prepare()
        same_prelude = bool(
            all(torch.equal(a, b) for a, b in zip(csr, csr2)) and torch.equal(vals_s, vals2)
            and all(torch.equal(getattr(pre, f), getattr(pre2, f))
                    for f in pre.__dataclass_fields__)
            and all(torch.equal(a, b) for a, b in zip(state, state2))
            and np.array_equal(plan.col_bounds, plan2.col_bounds)
            and np.array_equal(plan.type_bounds, plan2.type_bounds)
        )
        again = mk.two_sided_blocks_cuda(csr2, plan2, idx2, vals2, pre2, state2, tol, **kw)
        xa, la, _ = unscale(pre2, *again[:5])
        same_solve = bool(
            np.array_equal(xa.cpu().numpy(), xk_n) and np.array_equal(la.cpu().numpy(), lk_n)
            and np.array_equal(again[5].cpu().numpy(), it_k)
        )
        notes.update(prelude_bit_identical=same_prelude, repeat_bit_identical=same_solve)
        ok = ok and same_prelude and same_solve
    C = idx_np.shape[0]
    kp = idx_np.shape[1]
    nnz = int(csr[0].shape[0])
    bound_ms, bound_by, iter_bytes_ms = two_sided_bound(C, kp, T, nnz, B, it_k, kw["check_every"])
    iters_max = int(max(it_k[live]))
    rec = dict(
        phase=label, name="two_sided_block", replaces=REPLACES["two_sided_block"],
        shape=dict(C=C, k_pad=kp, T=T, nnz=nnz, caps=caps),
        grid=plan.grid, blocks_per_lane=plan.blocks_per_lane, resident_tile_floats=plan.tile_floats,
        prelude_ms=prelude_ms,
        us_per_iter=1e3 * ms / iters_max if iters_max else None,
        ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
        bound_by=bound_by, iter_bytes_ms=iter_bytes_ms, launches=mk.KERNEL.launches - launches0,
        iters_kernel=it_k.tolist(), iters_plain=it_p.tolist(), max_iters=kw["max_iters"],
        kkt_kernel=res_k.tolist(), lane_tol=tol_n.tolist(), max_abs_x=float(np.abs(xp_n[live]).max()),
        max_abs_err=max(err_x, err_lam), max_abs_err_x=err_x, max_abs_err_lam=err_lam,
        obj_err=err_obj,
        tolerance=dict(x=SOLVE_X_TOL, lam=SOLVE_LAM_TOL, obj=SOLVE_OBJ_TOL, iters=0),
        ok=bool(ok), **notes,
    )
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(f"two-sided kernel phase {label} failed")
    return rec, dict(x=xk_n, it=it_k, prepared=prepared)


def barrier_phase(solve, per_block, label="grid_barrier", rounds=20_000):
    """A bare loop of the kernels' group barrier (both have 512 threads a
    block) at the grid a one-lane solve launched, timed by CUDA events: the
    barrier's share of an iteration (two barriers an iteration, and
    ``per_block`` more per block of 128 iterations: five in the two-sided
    kernel, five in the LP kernel)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    nb = solve["blocks_per_lane"]
    dev = torch.device("cuda")
    ms = cuda_ms(lambda: mk.barrier_loop(1, nb, rounds, dev), reps=3, warmup=1)
    us = 1e3 * ms / rounds
    per_iter = (2 + per_block / 128) * us
    rec = dict(
        phase=label, grid=nb, rounds=rounds, ms=ms, us_per_barrier=us,
        barrier_us_per_iter=per_iter, iter_us=solve["us_per_iter"],
        data_us_per_iter=solve["us_per_iter"] - per_iter, ok=bool(np.isfinite(us) and us > 0),
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"{label} phase failed")
    return rec


def dual_lp_operands(m1: int = 4096, seed: int = 0, pool=None):
    """The dual leximin LP at the flagship's shape, built by
    ``solvers/lp_pdhg.dual_lp_operands`` as the path builds it: ``m1``
    random k-member panels of the ``sf_e_skewed_instance(seed=1)`` pool
    (``pool`` when given; drawn as :func:`flagship_pack` draws them), about
    10 % of the agents fixed at values in [0.02, 0.08]. Returns ``(c,
    EllPack of G, h, A, b)``."""
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import dual_lp_operands as build
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    c, G, h, A, b = build(*dual_lp_problem(m1, seed, pool))
    return c, EllPack.from_rows(G), h, A, b


def dual_lp_problem(m1: int = 4096, seed: int = 0, pool=None):
    """The portfolio ``P [m1, n]`` and the fixed probabilities of
    :func:`dual_lp_operands`' dual LP."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize

    dense, _ = featurize(pool if pool is not None else sf_e_skewed_instance(seed=1), device="cpu")
    n, k = dense.n, dense.k
    rng = np.random.default_rng(seed)
    P = np.zeros((m1, n))
    for r in range(m1):
        P[r, rng.choice(n, size=k, replace=False)] = 1.0
    fixed = np.full(n, -1.0)
    chosen = rng.choice(n, size=n // 10, replace=False)
    fixed[chosen] = rng.uniform(0.02, 0.08, size=chosen.size)
    return P, fixed


#: the nationwide dual LP (phases ``gather_nationwide`` and
#: ``dual_lp_nationwide``): panels of a nationwide registry of n agents (the
#: registry's default n; the JAX package's ``dist`` bench family runs the
#: same construction at n = 2,000 with 768 panels, ``bench.py:2716-2771``)
NATIONWIDE_N = 100_000
NATIONWIDE_PANELS = 2048


def nationwide_dual_problem(m1: int = NATIONWIDE_PANELS, n: int = NATIONWIDE_N,
                            device="cuda"):
    """The dual leximin LP over ``nationwide_registry(n, seed=0)`` (k = 316
    at n = 100,000) as the JAX package's ``dist`` bench family builds it:
    ``m1`` feasible panels from the LEGACY sampler
    (``models/legacy.sample_feasible_panels``, seed 2, on ``device``), every
    agent unfixed. Returns ``(panels int32 [m1, k], P bool [m1, n],
    fixed)``."""
    from citizensassemblies_tpu_torch.data.registry import nationwide_registry
    from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels

    reg = nationwide_registry(n=n, seed=0)
    dense, _space = reg.to_dense(device=device)
    panels, _draws = sample_feasible_panels(dense, m1, seed=2, distribute=False)
    P = np.zeros((m1, n), dtype=bool)
    P[np.repeat(np.arange(m1), reg.k), panels.ravel()] = True
    return panels, P, np.full(n, -1.0)


def nationwide_ops(panels, n):
    """The nationwide dual LP's ``(c, EllPack of G, h, A, b)`` as
    ``lp_pdhg.dual_lp_operands`` builds them with every agent unfixed (2,048
    panel rows need no bucket pad), ``G`` packed by :func:`nationwide_pack`
    from the member lists instead of a dense 2,048 × 100,001 matrix."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    m1 = len(panels)
    assert m1 % 256 == 0
    idx, val = nationwide_pack(panels, n)
    fixed = np.full(n, -1.0)
    unfixed = fixed < 0
    c = np.concatenate([-np.where(unfixed, 0.0, fixed), [1.0]])
    A = np.concatenate([unfixed.astype(np.float64), [0.0]])[None, :]
    return c, EllPack(minor=n + 1, idx=idx, val=val), np.zeros(m1), A, np.array([1.0])


def lp_inputs(ops, blocks=None, stage_x=None):
    """Everything an LP kernel solve of ``ops`` (:func:`dual_lp_operands`)
    takes on the card, from scratch: the CSR and the launch plan (``blocks``
    overrides the plan's block count, ``stage_x`` forces x̄'s route), the
    pack, the prelude and the scaled warm start (zeros). Returns ``(csr,
    plan, idx, pre, state)``."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    dev = torch.device("cuda")
    c, ell, h, A, b = ops
    nv, m1 = len(c), len(ell)
    f32 = dict(dtype=torch.float32, device=dev)
    csr, plan = mk.lp_launch_inputs(ell.idx, ell.val, nv, 1, dev, blocks, stage_x)
    t = [torch.as_tensor(np.asarray(a, np.float32), **f32) for a in (c, ell.val, h, A, b)]
    idx = torch.as_tensor(ell.idx, device=dev)
    zeros = (torch.zeros(nv, **f32), torch.zeros(m1, **f32), torch.zeros(1, **f32))
    pre, state = mk.lp_setup(t[0], idx, *t[1:], *zeros, csr)
    return csr, plan, idx, pre, state


def lp_compare(inputs, c64, tol, max_iters, profile=False):
    """The LP kernel and its plain version on the same prelude output: times,
    the errors of x, λ, μ and the objective, the plain version's largest
    entry of each vector, iteration counts, flags, and the kernel's raw
    output (``out_k``)."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    csr, plan, idx, pre, state = inputs
    kw = dict(max_iters=max_iters, check_every=128, sentinel=True)
    out_k, out_p = {}, {}
    # one launch per solve, so its CUDA-event time is its device time
    # (the profiler's total is kept beside it: in one run it held 0.025
    # ms for a 1436 ms launch)
    ms = cuda_ms(lambda: out_k.update(v=mk.lp_blocks_cuda(csr, plan, idx, pre, state, tol, **kw)),
                 reps=1, warmup=0)
    profiler_ms = device_ms(
        lambda: mk.lp_blocks_cuda(csr, plan, idx, pre, state, tol, **kw), reps=1
    ) if profile else None
    # the plain version is some twenty launches per iteration: one run,
    # timed by CUDA events (a profiler trace would hold millions of events)
    plain_ms = cuda_ms(lambda: out_p.update(v=mk.lp_blocks_plain(csr, idx, pre, state, tol, **kw)),
                       reps=1, warmup=0)
    k_out, p_out = out_k["v"], out_p["v"]
    xk, lk, mk_ = (a.cpu().numpy() for a in pre.unscale(*k_out[:3]))
    xp, lp, mp = (a.cpu().numpy() for a in pre.unscale(*p_out[:3]))
    return dict(
        ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms,
        it_k=int(k_out[3]), it_p=int(p_out[3]), res_k=float(k_out[4]), res_p=float(p_out[4]),
        flags_k=int(k_out[5]), flags_p=int(p_out[5]),
        err_x=float(np.abs(xk - xp).max()), err_lam=float(np.abs(lk - lp).max()),
        err_mu=float(np.abs(mk_ - mp).max()),
        err_obj=abs(float(c64 @ xk) - float(c64 @ xp)), max_abs_x=float(np.abs(xp).max()),
        max_abs_lam=float(np.abs(lp).max()), max_abs_mu=float(np.abs(mp).max()), out_k=k_out,
    )


def lp_close(r, x_tol=LP_X_TOL):
    return r["err_x"] <= x_tol and r["err_lam"] <= x_tol and r["err_obj"] <= LP_OBJ_TOL


def lp_bound(m1, kp, nv, nnz, iters):
    """``(bound_ms, bound_by, iter_bytes_ms)`` of an LP solve of ``iters``
    iterations, blocks of 128 (``obs/roofline.lp_cost``): the least the
    card could take, and the time to read the pack from HBM once an
    evaluation, both layouts."""
    from citizensassemblies_tpu_torch.obs import roofline

    cost = roofline.lp_cost(m1, kp, nv, nnz, int(iters), 128)
    return roofline.bound(cost) + (roofline.stream_ms(cost),)


def lp_path_solve(inputs, tol=LP_TOL, max_iters=LP_MAX_ITERS):
    """One kernel solve, at the path's own tolerance and cap by default,
    timed by CUDA events: ``(ms, iterations, kkt, raw output)``."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    csr, plan, idx, pre, state = inputs
    out = {}
    ms = cuda_ms(lambda: out.update(v=mk.lp_blocks_cuda(
        csr, plan, idx, pre, state, tol, max_iters=max_iters, check_every=128,
        sentinel=True,
    )), reps=1, warmup=0)
    return ms, int(out["v"][3]), float(out["v"][4]), out["v"]


def plan_record(plan) -> dict:
    """An LP kernel plan's blocks, x̄ route and residency."""
    return dict(grid=plan.grid, stage_x=plan.stage_x, resident=plan.tile_floats > 0,
                resident_tile_floats=plan.tile_floats,
                largest_var_tile=int(np.diff(plan.type_bounds).max()))


def lp_route_hold(ops, staged, tol, max_iters, blocks=None):
    """The LP kernel forced onto the global-x̄ route (``stage_x=False``)
    against ``staged``, :func:`lp_path_solve`'s ``(ms, iters, kkt, out)``
    on the staged route at the same ``tol``, ``max_iters`` and ``blocks``
    (a fresh prelude is bit for bit the same): the same iterations,
    residual, flags and x, λ, μ bit for bit, the same tiles, and both
    routes' times."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    c, ell = ops[0], ops[1]
    s_plan = mk.lp_launch_inputs(ell.idx, ell.val, len(c), 1, "cuda", blocks)[1]
    g_in = lp_inputs(ops, blocks, stage_x=False)
    g_plan = g_in[1]
    g1 = lp_path_solve(g_in, tol, max_iters)
    # x, λ, μ, iterations, residual, flags
    same = all(torch.equal(a, b) for a, b in zip(staged[3], g1[3]))
    tiles = bool(
        np.array_equal(s_plan.col_bounds, g_plan.col_bounds)
        and np.array_equal(s_plan.type_bounds, g_plan.type_bounds)
        and (s_plan.tile_floats > 0) == (g_plan.tile_floats > 0)
    )
    rec = dict(
        staged=plan_record(s_plan), global_x=plan_record(g_plan), tol=tol, max_iters=max_iters,
        iters=g1[1], kkt=g1[2], bit_identical=bool(same), same_tiles=tiles,
        staged_ms=staged[0], global_x_ms=g1[0],
    )
    rec["ok"] = bool(same and tiles and s_plan.stage_x and not g_plan.stage_x)
    return rec


def lp_phase(ops, host_ops):
    """The generic-LP block kernel at the flagship dual LP: first one solve
    at the path's own tolerance and cap, timed by CUDA events; then the
    kernel against its plain version on the same prelude output, at that
    tolerance when the solve met it before the cap, else at
    ``LP_CHECK_TOL`` (printed as ``tol``), with equal iteration counts; then
    the kernel again from a fresh prelude, which must give the same x, λ, μ
    and iterations bit for bit; then both for a fixed ``LP_FIXED_ITERS``
    iterations, with equal stall and poison flags; then a NaN warm start,
    which the kernel must quarantine and
    ``solve_lp_ell`` must re-solve on the host. That host re-solve runs on
    ``host_ops``, a smaller dual LP of the same pool: HiGHS took 525 s on
    the 4096-row one, and grows steeply with the rows (0.21 s at 256, 1.5 s
    at 512, 18 s at 1024 on one host)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_lp_ell
    from citizensassemblies_tpu_torch.utils.config import default_config

    dev = torch.device("cuda")
    launches0 = mk.LP_KERNEL.launches
    c, ell, h, A, b = ops
    nv, (m1, kp) = len(c), ell.idx.shape
    inputs = lp_inputs(ops)
    csr, plan, idx, pre, state = inputs
    c64 = np.asarray(c, np.float64)
    path = lp_path_solve(inputs)
    path_ms, path_iters, path_kkt = path[:3]
    met = path_iters < LP_MAX_ITERS and path_kkt <= LP_TOL
    tol = LP_TOL if met else LP_CHECK_TOL
    # the global-x̄ route forced at the same solve: bit for bit the staged one
    route = lp_route_hold(ops, path, LP_TOL, LP_MAX_ITERS)

    cmp = lp_compare(inputs, c64, tol, LP_MAX_ITERS, profile=True)
    ms, profiler_ms, plain_ms = cmp["ms"], cmp["profiler_ms"], cmp["plain_ms"]
    it_k, it_p, res_k = cmp["it_k"], cmp["it_p"], cmp["res_k"]
    err_x, err_lam, err_obj = cmp["err_x"], cmp["err_lam"], cmp["err_obj"]
    converged = bool(res_k <= tol and it_k < LP_MAX_ITERS)
    same_iters = it_k == it_p
    # a second kernel solve from a fresh prelude: the same bits
    kw = dict(max_iters=LP_MAX_ITERS, check_every=128, sentinel=True)
    csr2, plan2, idx2, pre2, state2 = lp_inputs(ops)
    again = mk.lp_blocks_cuda(csr2, plan2, idx2, pre2, state2, tol, **kw)
    first = cmp["out_k"]
    repeat_same = bool(
        all(torch.equal(a, b2) for a, b2 in zip(first[:3], again[:3])) and int(first[3]) == int(again[3])
    )
    # the late regime the path's solves run in (restarts, ω swings, the
    # stall flag): both versions for a fixed LP_FIXED_ITERS iterations, so
    # they run the same blocks by construction
    fixed = lp_compare(inputs, c64, 0.0, LP_FIXED_ITERS)
    fixed_ok = bool(
        lp_close(fixed, LP_FIXED_X_TOL) and fixed["it_k"] == fixed["it_p"] == LP_FIXED_ITERS
        and fixed["flags_k"] == fixed["flags_p"]
    )
    # a NaN warm start: quarantined in the kernel, re-solved on the host
    bad = state[0].clone()
    bad[0] = float("nan")
    nan_out = mk.lp_blocks_cuda(csr, plan, idx, pre, (bad,) + tuple(state[1:]), tol, **kw)
    hc, hell, hh, hA, hb = host_ops
    warm_nan = (np.full(nv, np.nan, np.float32), np.zeros(len(hell)), np.zeros(1))
    t0 = time.perf_counter()
    host = solve_lp_ell(hc, hell, hh, hA, hb, cfg=default_config().replace(pdhg_megakernel=True),
                        warm=warm_nan, device=dev)
    host_s = time.perf_counter() - t0
    quarantined = bool(int(nan_out[5]) & 1) and int(nan_out[3]) == 0
    host_ok = host.iters == -1 and host.ok and bool(np.isfinite(host.x).all())
    ok = (
        lp_close(cmp) and converged and same_iters and repeat_same and fixed_ok and quarantined
        and host_ok and plan.grid > 1 and route["ok"]
    )
    nnz = int(csr[0].shape[0])
    bound_ms, bound_by, iter_bytes_ms = lp_bound(m1, kp, nv, nnz, it_k)
    rec = dict(
        phase="lp_block_dual", name="lp_block", replaces=REPLACES["lp_block"],
        shape=dict(m1=m1, k_pad=kp, nv=nv, m2=1, nnz=nnz), tol=tol, tol_raised=tol != LP_TOL,
        grid=plan.grid, blocks_per_lane=plan.blocks_per_lane, resident=plan.tile_floats > 0,
        resident_tile_floats=plan.tile_floats,
        path_tol=LP_TOL, path_ms=path_ms, path_iters=path_iters, path_kkt=path_kkt,
        path_us_per_iter=1e3 * path_ms / path_iters if path_iters else None,
        ms=ms, us_per_iter=1e3 * ms / it_k if it_k else None,
        profiler_ms=profiler_ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, iter_bytes_ms=iter_bytes_ms,
        launches=mk.LP_KERNEL.launches - launches0, iters_kernel=it_k, iters_plain=it_p,
        max_iters=LP_MAX_ITERS, kkt_kernel=res_k,
        max_abs_err=max(err_x, err_lam, fixed["err_x"], fixed["err_lam"]),
        max_abs_err_x=err_x, max_abs_err_lam=err_lam, obj_err=err_obj,
        max_abs_x=cmp["max_abs_x"], converged=converged, same_iters=same_iters,
        repeat_bit_identical=repeat_same,
        fixed_length=dict(iters=LP_FIXED_ITERS, x_tol=LP_FIXED_X_TOL, ok=fixed_ok, **{
            k: fixed[k] for k in ("ms", "plain_ms", "it_k", "it_p", "res_k", "res_p", "flags_k",
                                  "flags_p", "err_x", "err_lam", "err_obj")
        }),
        nan_quarantined=quarantined, nan_host_resolve_ok=host_ok, nan_host_seconds=host_s,
        nan_host_m1=len(hell), global_x_route=route,
        tolerance=dict(x=LP_X_TOL, lam=LP_LAM_TOL, obj=LP_OBJ_TOL, iters=0), ok=bool(ok),
    )
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit("LP block kernel phase failed")
    return rec


def lp_sf_b_phase(ops):
    """The LP kernel at a dual LP of the sf_b pool's shape
    (:func:`dual_lp_operands` on ``sf_b_skewed_instance(seed=1)``, 1024
    panel rows): one solve at the path's tolerance and cap, timed by CUDA
    events (these duals mostly run to the cap, so this is the µs per
    iteration the sf_b path pays); then the kernel against its plain
    version at the path's tolerance when met, else at ``LP_CHECK_TOL``,
    with equal iterations."""
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    launches0 = mk.LP_KERNEL.launches
    c, ell, h, A, b = ops
    nv, (m1, kp) = len(c), ell.idx.shape
    inputs = lp_inputs(ops)
    plan = inputs[1]
    path = lp_path_solve(inputs)
    path_ms, path_iters, path_kkt = path[:3]
    met = path_iters < LP_MAX_ITERS and path_kkt <= LP_TOL
    tol = LP_TOL if met else LP_CHECK_TOL
    # the global-x̄ route forced at the same solve, and on one block for a
    # fixed LP_ONE_BLOCK_ITERS iterations (x̄ through global memory there
    # too): bit for bit the staged route
    route = lp_route_hold(ops, path, LP_TOL, LP_MAX_ITERS)
    one_staged = lp_path_solve(lp_inputs(ops, blocks=1), 0.0, LP_ONE_BLOCK_ITERS)
    route_one = lp_route_hold(ops, one_staged, 0.0, LP_ONE_BLOCK_ITERS, blocks=1)
    cmp = lp_compare(inputs, np.asarray(c, np.float64), tol, LP_MAX_ITERS)
    same_iters = cmp["it_k"] == cmp["it_p"]
    converged = bool(cmp["res_k"] <= tol and cmp["it_k"] < LP_MAX_ITERS)
    nnz = int(inputs[0][0].shape[0])
    bound_ms, bound_by, iter_bytes_ms = lp_bound(m1, kp, nv, nnz, path_iters)
    rec = dict(
        phase="lp_block_sf_b", name="lp_block", shape=dict(m1=m1, k_pad=kp, nv=nv, m2=1, nnz=nnz),
        grid=plan.grid, blocks_per_lane=plan.blocks_per_lane, resident=plan.tile_floats > 0,
        path_tol=LP_TOL, ms=path_ms, iters=path_iters, kkt=path_kkt,
        us_per_iter=1e3 * path_ms / path_iters if path_iters else None,
        bound_ms=bound_ms, bound_by=bound_by, iter_bytes_ms=iter_bytes_ms, tol=tol,
        check_ms=cmp["ms"], plain_ms=cmp["plain_ms"], iters_kernel=cmp["it_k"],
        iters_plain=cmp["it_p"], max_abs_err=max(cmp["err_x"], cmp["err_lam"]),
        max_abs_err_x=cmp["err_x"], max_abs_err_lam=cmp["err_lam"], obj_err=cmp["err_obj"],
        same_iters=same_iters, converged=converged, launches=mk.LP_KERNEL.launches - launches0,
        tolerance=dict(x=LP_X_TOL, lam=LP_LAM_TOL, obj=LP_OBJ_TOL, iters=0),
        global_x_route=route, global_x_one_block=route_one,
    )
    rec["ok"] = bool(
        lp_close(cmp) and same_iters and converged and route["ok"] and route_one["ok"]
        and route_one["staged"]["grid"] == 1 and route_one["iters"] == LP_ONE_BLOCK_ITERS
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("LP block kernel sf_b phase failed")
    return rec


def legacy_phase(inst):
    """LEGACY's 10,000-draw estimator on the flagship pool on the card:
    every accepted panel meets every quota, the allocation sums to k, the
    pair matrix is symmetric with a zero diagonal and rows summing to
    (k − 1)·allocation. Returns the record and the allocation."""
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities

    dense, _ = featurize(inst, device="cuda")
    t0 = time.perf_counter()
    res = legacy_probabilities(dense, iterations=10_000, seed=0)
    secs = time.perf_counter() - t0
    P = res.panels
    k = dense.k
    counts = np.stack([dense.A_np[row].sum(axis=0) for row in P])
    quotas_ok = bool(
        (counts >= dense.qmin_np).all() and (counts <= dense.qmax_np).all()
        and all(len(set(row.tolist())) == k for row in P)
    )
    M = res.pair_matrix.astype(np.float64)
    row_err = float(np.abs(M.sum(axis=1) - (k - 1) * res.allocation).max())
    alloc_err = abs(float(res.allocation.sum()) - k)
    rec = dict(
        phase="legacy_flagship", n=dense.n, k=k, iterations=10_000, seconds=secs,
        draws_attempted=res.draws_attempted, panels_per_s=len(P) / secs,
        unique_panels=len(res.unique_panels), min_prob=float(res.allocation.min()),
        quotas_ok=quotas_ok, alloc_sum_err=alloc_err,
        pair_symmetric=bool(np.array_equal(M, M.T)), pair_diag_zero=bool(np.all(np.diag(M) == 0)),
        pair_row_err=row_err,
    )
    rec["ok"] = bool(
        quotas_ok and len(P) == 10_000 and alloc_err <= 1e-9 and rec["pair_symmetric"]
        and rec["pair_diag_zero"] and row_err <= 1e-3
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("LEGACY phase failed")
    return rec, res.allocation


def leximin_run(inst, device, cfg, households=None, initial_panels=None):
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, space = featurize(inst, device=device)
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    dist = find_distribution_leximin(
        dense, space, cfg=cfg, log=log, device=device, households=households,
        initial_panels=initial_panels,
    )
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    linf = float(np.max(np.abs(dist.allocation - dist.fixed_probabilities)))
    return dist, log, secs, linf


#: the profile certificate's bars (tests/test_certification.py:277-310): the
#: certified gap (the smaller of the level's two upper bounds) within the
#: contract at every level; the exact-MILP bound alone, which carries an
#: integrality duality gap deep in the profile, within 5e-3
PROFILE_GAP = 1e-3
PROFILE_GAP_MILP = 5e-3
#: the exact level bound (:func:`exact_level_bound`), taken where the audit
#: leaves a level above its bar: at most this many pricing rounds, stopping
#: once the bound is within LEVEL_CG_TOL of the restricted master's value
LEVEL_CG_ROUNDS = 300
LEVEL_CG_TOL = 1e-7
#: how far that bound, rounded to 1e-6 as the audit rounds, may lie under
#: the level it bounds: one rounding unit (HiGHS solves the master and the
#: MILP to a feasibility tolerance of 1e-7)
LEVEL_CG_SLACK = 1e-6


def exact_level_bound(dense, fixed, floored, remaining):
    """An upper bound on ``min_{i ∈ remaining} a_i`` over every distribution
    of feasible committees whose marginals meet ``a_i ≥ fixed_i − 1e-9`` on
    ``floored`` (agent masks), by column generation in agent space with the
    exact HiGHS MILP as its oracle. For any ``w ≥ 0`` on ``remaining``
    summing to 1 and any ``λ ≥ 0`` on ``floored``, every such distribution
    has ``min_remaining a ≤ Σ w·a ≤ max_x (w + λ)·x − Σ λ_i·floor_i``: the
    audit's Lagrangian bound, with ``(w, λ)`` the restricted master's duals
    (its floors priced at 1e3 a unit of slack, so it is feasible from the
    first column) instead of the marginal relaxation's, re-optimized over
    the whole committee polytope. Returns ``(bound, master value, rounds)``:
    the least bound of the rounds, which meets the master's value once
    pricing finds no improving committee; the MILP's proven dual bound
    keeps it valid at any round."""
    from scipy.optimize import linprog

    from citizensassemblies_tpu_torch.solvers.highs_backend import HighsCommitteeOracle

    oracle = HighsCommitteeOracle(dense)
    n = dense.n
    R, Fx = np.nonzero(remaining)[0], np.nonzero(floored)[0]
    floor = np.maximum(np.asarray(fixed, dtype=np.float64)[Fx] - 1e-9, 0.0)
    w = np.zeros(n)
    w[R] = 1.0 / len(R)
    lam = np.zeros(n)
    cols, bound, master = [], np.inf, -np.inf
    for rounds in range(1, LEVEL_CG_ROUNDS + 1):
        panel, _value, raw = oracle._milp_maximize_with_bound(w + lam)
        bound = min(bound, float(raw) - float(lam[Fx] @ floor))
        if bound - master <= LEVEL_CG_TOL:
            break
        x = np.zeros(n)
        x[list(panel)] = 1.0
        cols.append(x)
        X = np.array(cols).T
        C = X.shape[1]
        # variables [p (C), z, slack (|Fx|)]: max z − 1e3·Σ slack
        res = linprog(
            np.concatenate([np.zeros(C), [-1.0], np.full(len(Fx), 1e3)]),
            A_ub=np.vstack([
                np.hstack([-X[R], np.ones((len(R), 1)), np.zeros((len(R), len(Fx)))]),
                np.hstack([-X[Fx], np.zeros((len(Fx), 1)), -np.eye(len(Fx))]),
            ]),
            b_ub=np.concatenate([np.zeros(len(R)), -floor]),
            A_eq=np.concatenate([np.ones(C), [0.0], np.zeros(len(Fx))])[None, :], b_eq=[1.0],
            bounds=[(0, None)] * C + [(None, None)] + [(0, None)] * len(Fx), method="highs",
        )
        if res.status != 0:
            raise RuntimeError(f"exact level bound: master LP failed ({res.message})")
        master = -float(res.fun)
        duals = np.maximum(-np.asarray(res.ineqlin.marginals), 0.0)
        w = np.zeros(n)
        w[R] = duals[: len(R)]
        w = w / w.sum() if w.sum() > 0 else np.where(remaining, 1.0 / len(R), 0.0)
        lam = np.zeros(n)
        lam[Fx] = duals[len(R):]
    return bound, master, rounds


def profile_audit(dense, fixed, covered) -> dict:
    """``audit_leximin_profile`` on a certified profile, folded into
    bench.py's fields (``bench.py:76-100``) with its host seconds, and held.
    Where a level's gap is above ``PROFILE_GAP`` or its MILP gap above
    ``PROFILE_GAP_MILP``, that level's :func:`exact_level_bound` (under the
    audit's own floors) joins its two bounds, as a third valid one, and is
    listed under ``tightened``; ``certified_worst_gap[_milp]`` are the
    worst gaps after that. ``ok`` unless every level is then within the
    bars and no bound lies under what its level achieved (the audit's by
    more than 1e-9, the exact bound's by more than ``LEVEL_CG_SLACK``)."""
    from citizensassemblies_tpu_torch.solvers.highs_backend import audit_leximin_profile
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    t = time.perf_counter()
    prof = audit_leximin_profile(dense, fixed, covered)
    secs = time.perf_counter() - t
    levels = prof["levels"]
    margin = min(min(lv["certified_upper"], lv["milp_upper"]) - lv["achieved"] for lv in levels)
    rec = dict(
        profile_levels=prof["n_levels"], profile_worst_gap=prof["worst_gap"],
        profile_worst_gap_milp=prof["worst_gap_milp"],
        profile_all_within_tol=prof["all_within_tol"],
        level2_gap=levels[1]["gap"] if len(levels) >= 2 else None, audit_s=secs,
        upper_margin=margin, audited_types=prof["audited_types"],
    )
    gaps = [(lv["gap"], lv["gap_milp"]) for lv in levels]
    tightened, exact_ok = [], True
    if any(g > PROFILE_GAP or gm > PROFILE_GAP_MILP for g, gm in gaps):
        # the audit's level sets and floors: types by their least covered
        # value, each level the remaining types within 1e-3 (the audit's
        # level_tol) of its least
        t_exact = time.perf_counter()
        red = TypeReduction(dense)
        covered = np.asarray(covered, dtype=bool)
        v_t = np.full(red.T, np.inf)
        np.minimum.at(v_t, red.type_id, np.where(covered, fixed, np.inf))
        remaining = np.zeros(red.T, dtype=bool)
        np.logical_or.at(remaining, red.type_id, covered)
        done = np.zeros(red.T, dtype=bool)
        for j, lv in enumerate(levels):
            S = remaining & (v_t <= v_t[remaining].min() + 1e-3)
            if gaps[j][0] > PROFILE_GAP or gaps[j][1] > PROFILE_GAP_MILP:
                bound, master, rounds = exact_level_bound(
                    dense, fixed, covered & done[red.type_id], covered & remaining[red.type_id]
                )
                exact = round(bound, 6)
                gaps[j] = (min(lv["certified_upper"], exact) - lv["achieved"],
                           min(lv["milp_upper"], exact) - lv["achieved"])
                exact_ok = exact_ok and exact >= lv["achieved"] - LEVEL_CG_SLACK
                tightened.append(dict(level=j + 1, achieved=lv["achieved"],
                                      certified_upper=lv["certified_upper"],
                                      milp_upper=lv["milp_upper"], exact_upper=exact,
                                      master=master, rounds=rounds))
            done |= S
            remaining &= ~S
        rec["tighten_s"] = time.perf_counter() - t_exact
    rec.update(
        tightened=tightened,
        certified_worst_gap=round(max(g for g, _ in gaps), 6),
        certified_worst_gap_milp=round(max(gm for _, gm in gaps), 6),
    )
    rec["ok"] = bool(
        rec["certified_worst_gap"] <= PROFILE_GAP
        and rec["certified_worst_gap_milp"] <= PROFILE_GAP_MILP
        and margin >= -1e-9 and exact_ok
    )
    return rec


def _profile_audit_cpu(A, qmin, qmax, cat_of_feature, k, n_categories, fixed, covered, conn):
    """:func:`profile_audit` in a worker process, on the instance rebuilt on
    the CPU from the host arrays the card's run read; an audit that raises
    sends its error as a failed record."""
    import torch

    from citizensassemblies_tpu_torch.core.instance import dense_instance

    torch.set_num_threads(1)
    try:
        dense = dense_instance(A, qmin, qmax, cat_of_feature, k, n_categories, device="cpu")
        conn.send(profile_audit(dense, fixed, covered))
    except Exception as exc:
        conn.send(dict(ok=False, error=f"{type(exc).__name__}: {exc}"))


def start_profile_audit(audits, label, dense, dist):
    """Start :func:`profile_audit` of ``dist``'s certified profile on
    ``dense`` (which may live on the card: only its host arrays go to the
    worker) under ``label`` in ``audits``, for :func:`profile_audit_phase`."""
    audits[label] = start_cpu_worker(
        _profile_audit_cpu, dense.A_np, dense.qmin_np, dense.qmax_np, dense.cat_of_feature_np,
        dense.k, dense.n_categories, dist.fixed_probabilities, dist.covered,
    )


def profile_audit_phase(audits, records):
    """Collect every started audit, print it on a line of its path and fold
    it into the path's record (``records[phase]``; a label
    ``phase:pool`` goes under that pool's key): a failed or lost audit
    fails its path."""
    for label, worker in audits.items():
        try:
            cert = cpu_worker_result(worker)
        except EOFError:
            cert = dict(ok=False, error="the audit's worker ended without a result")
        phase, _, pool = label.partition(":")
        print(json.dumps(dict(phase=phase, pool=pool or None, profile_certificate=cert)),
              flush=True)
        rec = records[phase]
        (rec[pool] if pool else rec)["profile_certificate"] = cert
        rec["ok"] = bool(rec["ok"] and cert["ok"])


def reference_phase(slice_cfg):
    """LEXIMIN on a small pool on the GPU, every master forced onto the
    device route, against the same solve on the CPU (host masters)."""
    from citizensassemblies_tpu_torch.core.generator import skewed_instance

    inst = skewed_instance(n=160, k=14, n_categories=4, seed=2)
    d_cpu, _, s_cpu, l_cpu = leximin_run(inst, "cpu", slice_cfg)
    d_gpu, log_gpu, s_gpu, l_gpu = leximin_run(
        inst, "cuda", slice_cfg.replace(decomp_host_master_max_types=0)
    )
    fixed_gap = float(np.max(np.abs(d_cpu.fixed_probabilities - d_gpu.fixed_probabilities)))
    alloc_gap = float(np.max(np.abs(d_cpu.allocation - d_gpu.allocation)))
    c = log_gpu.counters
    rec = dict(
        phase="reference_small", n=160, k=14, seconds_cpu=s_cpu, seconds_gpu=s_gpu,
        linf_cpu=l_cpu, linf_gpu=l_gpu, fixed_gap=fixed_gap, alloc_gap=alloc_gap,
        device_masters=int(c.get("megakernel_dispatches", 0)), faults=fault_counts(c),
        ok=bool(
            d_cpu.contract_ok and d_gpu.contract_ok and fixed_gap <= 1e-9
            and alloc_gap <= 2 * E2E_CONTRACT and c.get("megakernel_dispatches", 0) > 0
            and clean(c)
        ),
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("small-input reference phase failed")
    return rec


def agent_space_phase(inst, slice_cfg, label, audits):
    """The agent-space LEXIMIN column generation on the card with device
    dual LPs (``backend="jax"``: the LP block kernel), with every launch
    counter zeroed just before it and read just after; then the same run
    again, which must make the same dual solves and return the same
    allocation (no step of the path sums with atomics); then the type-space
    path on the same pool, whose sorted allocation profile it must match.
    Each device dual solve's rows, PDHG iterations and seconds (prelude,
    kernel and readback) are recorded by wrapping ``lp_pdhg.solve_lp_ell``.
    The first run's profile certificate starts in ``audits``."""
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers import lp_pdhg

    solve_ell = lp_pdhg.solve_lp_ell
    solves = []

    def recorded_ell(c, ell, *args, **kw):
        t = time.perf_counter()
        sol = solve_ell(c, ell, *args, **kw)
        solves.append([len(ell), int(sol.iters), time.perf_counter() - t])
        return sol

    for lib in (em.KERNEL, mk.KERNEL, mk.LP_KERNEL):
        lib.reset_counts()
    cfg = slice_cfg.replace(force_agent_space=True, backend="jax")
    with mock.patch.object(lp_pdhg, "solve_lp_ell", recorded_ell):
        dist, alog, secs, linf = leximin_run(inst, "cuda", cfg)
    launches = {"lp_block": mk.LP_KERNEL.launches, "ell_gather": em.KERNEL.launches,
                "two_sided_block": mk.KERNEL.launches}
    start_profile_audit(audits, label, featurize(inst, device="cpu")[0], dist)
    again, alog2, secs2, _ = leximin_run(inst, "cuda", cfg)
    # demotion on: the dual LPs' 0/1 operands go up as bf16, the LP
    # kernel's prelude widens them: bit for bit the run with it off
    mp, mlog, secs_mp, _ = leximin_run(inst, "cuda", cfg.replace(mixed_precision=True))
    mixed = dict(
        seconds=secs_mp, counters=mp_counts(mlog.counters),
        dual_solves=int(mlog.counters.get("agent_space_dual_solves", 0)),
        bit_identical=bool(
            np.array_equal(mp.allocation, dist.allocation)
            and np.array_equal(mp.probabilities, dist.probabilities)
            and np.array_equal(mp.committees, dist.committees)
        ),
    )
    repeat = dict(
        seconds=secs2, dual_lp=alog2.timers.get("dual_lp", 0.0),
        dual_solves=int(alog2.counters.get("agent_space_dual_solves", 0)),
        host_fallbacks=int(alog2.counters.get("dual_lp_host_fallback", 0)),
        same_allocation=bool(np.array_equal(again.allocation, dist.allocation)),
    )
    ts, _, ts_secs, ts_linf = leximin_run(inst, "cuda", slice_cfg)
    prof = float(np.abs(np.sort(dist.allocation) - np.sort(ts.allocation)).max())
    c, tm = alog.counters, alog.timers
    rec = dict(
        phase=label, n=len(inst.agents), k=inst.k, seconds=secs,
        contract_ok=bool(dist.contract_ok), linf=linf, typespace_seconds=ts_secs,
        typespace_contract_ok=bool(ts.contract_ok), profile_dev=prof,
        dual_solves=int(c.get("agent_space_dual_solves", 0)),
        host_fallbacks=int(c.get("dual_lp_host_fallback", 0)),
        exact_oracle_calls=int(c.get("agent_space_exact_prices", 0)),
        sentinel_poisoned=int(c.get("sentinel_poisoned", 0)),
        portfolio=int(dist.committees.shape[0]),
        panels=int((dist.probabilities > slice_cfg.support_eps).sum()),
        launches=launches, megakernel_fit_miss=int(c.get("megakernel_fit_miss", 0)),
        megakernel_dispatches=int(c.get("megakernel_dispatches", 0)),
        timers={k: tm.get(k, 0.0) for k in (
            "dual_lp", "stochastic_pricing", "exact_oracle", "final_stage",
        )},
        device_solves=solves, device_solve_s=sum(x[2] for x in solves),
        repeat=repeat, mixed_precision_on=mixed, faults=fault_counts(c),
    )
    rec["ok"] = bool(
        dist.contract_ok and ts.contract_ok and prof <= PROFILE_TOL
        and np.isfinite(dist.allocation).all() and launches["lp_block"] > 0
        and launches["ell_gather"] > 0 and rec["megakernel_fit_miss"] == 0
        and repeat["dual_solves"] == rec["dual_solves"]
        and repeat["host_fallbacks"] == rec["host_fallbacks"] and repeat["same_allocation"]
        and mixed["bit_identical"] and mixed["dual_solves"] == rec["dual_solves"]
        and mixed["counters"]["mp_demoted_operands"] > 0
        and clean(c) and clean(alog2.counters) and clean(mlog.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec, dist, cfg


class _StageBudgetSpent(Exception):
    pass


def agent_space_budget_phase(inst, slice_cfg, label):
    """The agent-space column generation on ``inst`` under a budget of
    ``STAGE_BUDGET_S`` seconds per stage and ``AGENT_BUDGET_S`` in all: the
    run stops at the first dual solve past either. Every dual solve goes
    through the LP kernel (``backend="jax"``) and is recorded. Checks: the
    kernel ran with no fit miss; every solve came back finite; no ``ok``
    solve's objective (the restricted master's maximin) exceeds the pool's
    leximin minimum from the type-space path by more than ``PROFILE_TOL``;
    each completed stage fixed its agents at that minimum's profile value
    within ``PROFILE_TOL``; and a run that finishes meets the contract and
    matches the type-space profile. Each round's rows, PDHG iterations and
    seconds are recorded (by wrapping ``lp_pdhg.solve_lp_ell``), and each
    HiGHS solve's seconds (by wrapping ``models.leximin.solve_dual_lp``):
    the fallbacks after a PDHG solve that missed its tolerance, which
    ``dual_lp`` times, and the authoritative re-solves before a stage
    fixes its agents, which it does not."""
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.models import leximin
    from citizensassemblies_tpu_torch.solvers import lp_pdhg
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    ts, _, ts_secs, _ = leximin_run(inst, "cuda", slice_cfg)
    profile = np.sort(ts.allocation)
    stages = []
    solve = lp_pdhg.solve_dual_lp_pdhg
    solve_ell = lp_pdhg.solve_lp_ell
    highs = leximin.solve_dual_lp
    last = {}
    t0 = time.perf_counter()

    def budgeted(P, fixed, **kw):
        nfixed = int((fixed >= 0).sum())
        now = time.perf_counter()
        if not stages or stages[-1]["fixed_before"] != nfixed:
            if stages:
                stages[-1]["value"] = float(fixed[fixed >= 0].max())
            stages.append(dict(fixed_before=nfixed, start=now, rounds=0, pdhg_ok=0,
                               max_ok_objective=0.0, finite=True, pdhg_s=0.0,
                               highs_fallback_s=0.0, highs_authoritative_s=0.0,
                               round_log=[], highs_log=[]))
        st = stages[-1]
        if now - st["start"] > STAGE_BUDGET_S or now - t0 > AGENT_BUDGET_S:
            raise _StageBudgetSpent
        last.clear()
        sol, warm = solve(P, fixed, **kw)
        secs = time.perf_counter() - now
        st["rounds"] += 1
        st["pdhg_s"] += secs
        # [rows, PDHG iterations (-1: re-solved on the host after a
        # poisoned solve), seconds] of each round
        st["round_log"].append([last.get("m1"), last.get("iters"), secs])
        last["fallback_due"] = not sol.ok
        st["finite"] = st["finite"] and bool(np.isfinite(sol.y).all() and np.isfinite(sol.yhat))
        if sol.ok:
            st["pdhg_ok"] += 1
            st["max_ok_objective"] = max(st["max_ok_objective"], float(sol.objective))
        st["seconds"] = time.perf_counter() - st["start"]
        return sol, warm

    def recorded_ell(c, ell, *args, **kw):
        sol = solve_ell(c, ell, *args, **kw)
        last.update(m1=len(ell), iters=int(sol.iters), kkt=float(sol.kkt))
        return sol

    def timed_highs(P, fixed):
        t = time.perf_counter()
        sol = highs(P, fixed)
        secs = time.perf_counter() - t
        kind = "fallback" if last.pop("fallback_due", False) else "authoritative"
        if stages:
            stages[-1][f"highs_{kind}_s"] += secs
            stages[-1]["highs_log"].append([kind[0], int(np.shape(P)[0]), secs])
        return sol

    for lib in (em.KERNEL, mk.KERNEL, mk.LP_KERNEL):
        lib.reset_counts()
    dense, space = featurize(inst, device="cuda")
    alog = RunLog(echo=False)
    cfg = slice_cfg.replace(force_agent_space=True, backend="jax")
    dist = None
    with mock.patch.object(lp_pdhg, "solve_dual_lp_pdhg", budgeted), \
            mock.patch.object(lp_pdhg, "solve_lp_ell", recorded_ell), \
            mock.patch.object(leximin, "solve_dual_lp", timed_highs):
        try:
            dist = leximin.find_distribution_leximin(dense, space, cfg=cfg, log=alog, device="cuda")
        except _StageBudgetSpent:
            pass
    secs = time.perf_counter() - t0
    launches = {"lp_block": mk.LP_KERNEL.launches, "ell_gather": em.KERNEL.launches}
    c, tm = alog.counters, alog.timers
    if dist is not None and stages:
        stages[-1]["value"] = float(dist.fixed_probabilities.max())
    done = [s for s in stages if "value" in s]
    # stage s fixes the agents at the (fixed_before + 1)-th smallest value
    # of the leximin profile
    stage_err = max((abs(s["value"] - profile[s["fixed_before"]]) for s in done), default=0.0)
    bound_excess = max(
        (s["max_ok_objective"] - profile[s["fixed_before"]] for s in stages), default=0.0
    )
    rec = dict(
        phase=label, n=dense.n, k=dense.k, stage_budget_s=STAGE_BUDGET_S, budget_s=AGENT_BUDGET_S,
        seconds=secs, finished=dist is not None, stages_completed=len(done),
        stages=[{k: v for k, v in s.items() if k != "start"} for s in stages],
        leximin_min=float(profile[0]), bound_excess=float(bound_excess), stage_value_err=stage_err,
        typespace_seconds=ts_secs, launches=launches,
        host_fallbacks=int(c.get("dual_lp_host_fallback", 0)),
        sentinel_stalled=int(c.get("sentinel_stalled", 0)),
        megakernel_fit_miss=int(c.get("megakernel_fit_miss", 0)),
        oracle_backend_native=int(c.get("oracle_backend_native", 0)),
        oracle_backend_highs=int(c.get("oracle_backend_highs", 0)),
        timers={k: tm.get(k, 0.0) for k in ("dual_lp", "stochastic_pricing", "exact_oracle")},
        dual_lp_split={k: sum(s[k] for s in stages) for k in (
            "pdhg_s", "highs_fallback_s", "highs_authoritative_s")},
        rounds=sum(s["rounds"] for s in stages),
    )
    ok = (
        launches["lp_block"] > 0 and rec["megakernel_fit_miss"] == 0 and stages
        and all(s["finite"] for s in stages) and bound_excess <= PROFILE_TOL
        and stage_err <= PROFILE_TOL
    )
    if dist is not None:
        rec["contract_ok"] = bool(dist.contract_ok)
        rec["profile_dev"] = float(np.abs(np.sort(dist.allocation) - profile).max())
        ok = ok and dist.contract_ok and rec["profile_dev"] <= PROFILE_TOL
    rec["ok"] = bool(ok)
    print(json.dumps(rec), flush=True)
    return rec


def flagship_phase(inst, slice_cfg, libs):
    """LEXIMIN on the flagship pool, with every launch counter zeroed just
    before it and read just after; each master solve's (Cp, iterations) is
    collected by wrapping ``lp_pdhg.finish_two_sided_master`` here (the
    package keeps no such counter). Then the same run again, whose masters
    must take the same iterations, launch for launch; whether its
    allocation is bit-identical is reported."""
    from unittest import mock

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers import lp_pdhg

    finish = lp_pdhg.finish_two_sided_master

    def run():
        masters = []

        def recorded(h):
            sol = finish(h)
            masters.append([int(h.Cp), int(sol.iters)])
            return sol

        with mock.patch.object(lp_pdhg, "finish_two_sided_master", recorded):
            return leximin_run(inst, "cuda", slice_cfg) + (masters,)

    for lib in libs:
        lib.reset_counts()
    dist, elog, secs, linf, masters = run()
    launches = {"ell_gather": em.KERNEL.launches, "two_sided_block": mk.KERNEL.launches}
    again, _, secs2, _, masters2 = run()
    c, tm = elog.counters, elog.timers
    alloc = dist.allocation
    mean = alloc.mean()
    gini = float(np.abs(alloc[:, None] - alloc[None, :]).mean() / (2 * mean)) if mean else 0.0
    e2e = dict(
        phase="leximin_sf_e_skewed_seed1", seconds=secs, contract_ok=bool(dist.contract_ok),
        linf=linf, min_prob=float(alloc.min()), gini=gini,
        panels=int(len(dist.probabilities)), launches=launches,
        megakernel_fit_miss=int(c.get("megakernel_fit_miss", 0)),
        decomp_rounds=int(c.get("decomp_rounds", 0)),
        decomp_host_syncs=int(c.get("decomp_host_syncs", 0)),
        megakernel_dispatches=int(c.get("megakernel_dispatches", 0)),
        timers={k: tm.get(k, 0.0) for k in (
            "relax_leximin", "inject", "decomp_master", "decomp_polish",
            "decomp_expand", "decomp_oracle", "final_stage", "decomp",
        )},
        masters=masters,
        repeat=dict(seconds=secs2, masters=masters2, same_master_iters=masters2 == masters,
                    same_allocation=bool(np.array_equal(again.allocation, alloc))),
        faults=fault_counts(c),
    )
    e2e["ok"] = bool(
        dist.contract_ok and linf <= E2E_CONTRACT and np.isfinite(alloc).all()
        and alloc.shape == (1727,) and launches["ell_gather"] > 0
        and launches["two_sided_block"] > 0 and e2e["megakernel_fit_miss"] == 0
        and masters2 == masters and again.contract_ok and clean(c)
    )
    print(json.dumps(e2e), flush=True)
    return e2e, launches


class _SyncDebugError:
    """``torch.cuda.set_sync_debug_mode("error")`` for the body: any
    operation that synchronises the host with the card raises."""

    def __enter__(self):
        import torch

        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        return False


def _event_ms(fn):
    """``(result, device_ms, host_ms)``: CUDA-event milliseconds from just
    before ``fn()`` is queued until the card has run everything it queued,
    and the host's milliseconds inside ``fn()``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop), host_ms


def flagship_reduction():
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    return TypeReduction(featurize(sf_e_skewed_instance(seed=1), device="cpu")[0])


def device_pricing_phase(red, label="device_pricing_sf_e"):
    """``DevicePricer`` on a reduction (the flagship's: T=814, k=110) with one
    round's task batch, as ``face_decompose._AnchorPricer.submit`` builds it
    (the dual direction, two noisy variants, three forced-inclusion tasks):
    the dispatch queued under sync-debug "error", timed by CUDA events from
    dispatch to ready; the lanes equal to the same code's CPU run; every
    lane's device feasibility flag equal to the exact host re-check
    (``_validate``)."""
    import torch

    from citizensassemblies_tpu_torch.solvers.device_pricing import DevicePricer

    rng = np.random.default_rng(5)
    T = red.T
    r_norm = rng.normal(0.0, 1.0, T) / red.msize
    scale = float(np.mean(np.abs(r_norm)))
    tasks = [(-r_norm, None)] + [
        (-r_norm + rng.normal(0.0, 0.5 * scale, T), None) for _ in range(2)
    ] + [(-r_norm, int(t)) for t in np.argsort(r_norm)[:3]]
    gpu = DevicePricer(red, device="cuda")
    cpu = DevicePricer(red, device="cpu")
    gpu.harvest(gpu.dispatch(tasks))  # warm-up: allocator and pinned pool

    def dispatch():
        with _SyncDebugError():
            return gpu.dispatch(tasks)

    handle, ms, host_ms = _event_ms(dispatch)
    hits, missed = gpu.harvest(handle)
    ref = cpu.dispatch(tasks)
    comps, ok = handle.comps.cpu().numpy(), handle.ok.cpu().numpy()
    equal = bool(np.array_equal(comps, ref.comps.numpy()) and np.array_equal(ok, ref.ok.numpy()))
    flags_exact = bool(np.array_equal(gpu._validate(comps, ok), ok))
    rec = dict(
        phase=label, T=T, k=red.k, tasks=len(tasks), lanes=int(comps.shape[0]),
        ms=ms, host_ms=host_ms, hits=len(hits), missed=len(missed),
        feasible_lanes=int(ok.sum()), equal_to_cpu=equal, flags_exact=flags_exact,
        no_sync_in_dispatch=True,
    )
    rec["ok"] = bool(equal and flags_exact and len(hits) > 0)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("device pricing phase failed")
    return rec


def fused_screen_phase(red, MT, label="fused_screen_sf_e"):
    """``_FusedScreen`` on 512 compositions (``MT``'s columns times the type
    sizes; at the flagship, flagship panels) and the device duals
    of a master solve over them (queued behind the solve): the dispatch
    under sync-debug "error", timed by CUDA events from dispatch to ready;
    its pairs, indices and new compositions equal to the same code's CPU
    run on the same duals."""
    import torch

    from citizensassemblies_tpu_torch.solvers import lp_pdhg
    from citizensassemblies_tpu_torch.solvers.face_decompose import _FusedScreen
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
    from citizensassemblies_tpu_torch.utils.config import default_config

    comps = np.rint(MT[:, :512].T * red.msize[None, :]).astype(np.int16)
    sub = EllPack.from_rows(MT[:, :512].T.astype(np.float32), minor=red.T)
    v = MT[:, :512] @ np.random.default_rng(3).dirichlet(np.ones(512))
    handle = lp_pdhg.solve_two_sided_master_ell_async(
        sub, v, cfg=default_config(), tol=MASTER_TOL, max_iters=4096, device="cuda"
    )
    gpu = _FusedScreen(red, per_round_cap=16_384, device="cuda")
    cpu = _FusedScreen(red, per_round_cap=16_384, device="cpu")
    gpu.dispatch(comps, handle.lam)
    gpu.harvest()  # warm-up

    def dispatch():
        with _SyncDebugError():
            return gpu.dispatch(comps, handle.lam)

    _, ms, host_ms = _event_ms(dispatch)
    idx, ti, tj, _ = gpu._pending
    got = [a.cpu().numpy() for a in (idx, ti, tj)]
    moved = gpu.harvest()
    cpu.dispatch(comps, handle.lam.cpu())
    want = [a.numpy() for a in cpu._pending[:3]]
    moved_cpu = cpu.harvest()
    equal = bool(all(np.array_equal(a, b) for a, b in zip(got, want)) and np.array_equal(moved, moved_cpu))
    rec = dict(
        phase=label, rows=512, T=red.T, pairs=int(len(got[1])),
        feasible_moves=int((got[0] >= 0).sum()), ms=ms, host_ms=host_ms,
        equal_to_cpu=equal, no_sync_in_dispatch=True,
    )
    rec["ok"] = bool(equal and len(moved) > 0)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("fused screen phase failed")
    return rec


def polish_screen_phase(MT):
    """The two-sided kernel at the polish screen's shape: a 2048-column
    support pack of flagship panels over T=814, lanes the prefixes
    ``SCREEN_CAPS``, tolerance a quarter of the master's, at most
    ``SCREEN_MAX_ITERS`` iterations, warm from a master solve on the support
    (as ``face_decompose.polish_support`` warms its lanes). Kernel against
    the plain version on the same prelude output: equal per-lane
    iterations, x within ``SOLVE_X_TOL``, λ within ``SOLVE_LAM_TOL`` and
    each lane's ε within ``SOLVE_OBJ_TOL``."""
    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers import lp_pdhg
    from citizensassemblies_tpu_torch.solvers.batch_lp import _bucket_dim
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import unscale
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
    from citizensassemblies_tpu_torch.utils.config import default_config

    dev = torch.device("cuda")
    launches0 = mk.KERNEL.launches
    T = MT.shape[0]
    C = SCREEN_CAPS[-1]
    sub = EllPack.from_rows(MT[:, :C].T.astype(np.float32), minor=T)
    rng = np.random.default_rng(2)
    p_true = np.zeros(C)
    p_true[:1536] = rng.dirichlet(np.ones(1536))
    v = MT[:, :C] @ p_true
    cfg = default_config().replace(mixed_precision=False)
    master = lp_pdhg.solve_two_sided_master_ell(
        sub, v, cfg=cfg, tol=MASTER_TOL, max_iters=4096, device="cuda"
    )
    Cp = _bucket_dim(C, cfg.lp_batch_bucket_max)
    mode = mk.megakernel_mode(cfg, T, Cp, dev, lanes=len(SCREEN_CAPS))
    idx_np, val_np = sub.padded(Cp)
    B = len(SCREEN_CAPS)
    colmask = np.zeros((B, Cp), np.float32)
    x0 = np.zeros((B, Cp + 1), np.float32)
    for b, cap in enumerate(SCREEN_CAPS):
        colmask[b, :cap] = 1.0
        x0[b, :cap] = master.x[:cap]
        x0[b, Cp] = max(float(master.x[-1]), 0.0)
    f32 = dict(dtype=torch.float32, device=dev)
    v_t = torch.as_tensor(v.astype(np.float32), **f32)
    cm = torch.as_tensor(colmask, **f32)
    x0_t = torch.as_tensor(x0, **f32)
    lam0 = torch.as_tensor(np.tile(master.lam, (B, 1)).astype(np.float32), **f32)
    mu0 = torch.full((B,), float(master.mu[0]), **f32)
    tol = torch.full((B,), 0.25 * MASTER_TOL, **f32)
    kw = dict(max_iters=SCREEN_MAX_ITERS, check_every=128, sentinel=True)
    csr, plan = mk.two_sided_launch_inputs(idx_np, val_np, T, B, dev)
    idx, vals_s, pre, state = mk.two_sided_setup(idx_np, val_np, v_t, cm, x0_t, lam0, mu0, csr)
    out = {}
    ms = cuda_ms(lambda: out.update(k=mk.two_sided_blocks_cuda(csr, plan, idx, vals_s, pre, state, tol, **kw)),
                 reps=1, warmup=1)
    plain_ms = cuda_ms(lambda: out.update(p=mk.two_sided_blocks_plain(csr, idx, vals_s, pre, state, tol, **kw)),
                       reps=1, warmup=0)
    xk, lk, _ = (a.cpu().numpy() for a in unscale(pre, *out["k"][:5]))
    xp, lp, _ = (a.cpu().numpy() for a in unscale(pre, *out["p"][:5]))
    it_k, it_p = out["k"][5].cpu().numpy(), out["p"][5].cpu().numpy()
    res_k = out["k"][6].cpu().numpy()
    err_x = float(np.abs(xk - xp).max())
    err_lam = float(np.abs(lk - lp).max())
    err_obj = float(np.abs(xk[:, -1] - xp[:, -1]).max())
    same_iters = bool(np.array_equal(it_k, it_p))
    # each lane's float64 residual ‖M p − v‖∞, as the screen judges it
    eps = []
    for b, cap in enumerate(SCREEN_CAPS):
        p_s = np.maximum(xk[b, :cap].astype(np.float64), 0.0)
        eps.append(float(np.abs(MT[:, :cap] @ (p_s / p_s.sum()) - v).max()) if p_s.sum() > 0 else None)
    nnz = int(csr[0].shape[0])
    bound_ms, bound_by, iter_bytes_ms = two_sided_bound(Cp, idx_np.shape[1], T, nnz, B, it_k, 128)
    iters_max = int(it_k.max())
    rec = dict(
        phase="polish_screen_sf_e", name="two_sided_block", replaces=REPLACES["two_sided_block"],
        shape=dict(C=Cp, k_pad=int(idx_np.shape[1]), T=T, nnz=nnz, caps=SCREEN_CAPS),
        gate=mode, grid=plan.grid, blocks_per_lane=plan.blocks_per_lane,
        resident=bool(plan.tile_floats), resident_tile_floats=plan.tile_floats,
        master_iters=int(master.iters), ms=ms, plain_ms=plain_ms,
        us_per_iter=1e3 * ms / iters_max if iters_max else None, library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, iter_bytes_ms=iter_bytes_ms,
        launches=mk.KERNEL.launches - launches0, iters_kernel=it_k.tolist(),
        iters_plain=it_p.tolist(), kkt_kernel=res_k.tolist(), lane_eps=eps,
        obj_kernel=xk[:, -1].tolist(), obj_plain=xp[:, -1].tolist(),
        max_abs_err=max(err_x, err_lam), max_abs_err_x=err_x, max_abs_err_lam=err_lam,
        obj_err=err_obj,
        tolerance=dict(x=SOLVE_X_TOL, lam=SOLVE_LAM_TOL, obj=SOLVE_OBJ_TOL, iters=0),
        same_iters=same_iters,
    )
    rec["ok"] = bool(
        mode == "fused" and same_iters and err_x <= SOLVE_X_TOL and err_lam <= SOLVE_LAM_TOL
        and err_obj <= SOLVE_OBJ_TOL and np.isfinite(xk).all()
    )
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit("polish screen phase failed")
    return rec


def defaults_flagship_phase(inst, cfg, libs, audits):
    """The flagship at the package's defaults (``default_config()``):
    device anchor pricing, the fused move screen, the batched polish screen
    and bf16 operand demotion engage. Every launch counter is zeroed just
    before the run and read just after. Each master's and each
    polish-screen lane's (Cp, iterations) is recorded by wrapping
    ``lp_pdhg.finish_two_sided_master`` and
    ``batch_lp.solve_polish_screen_ell``; the run is made twice and must
    take the same iterations solve for solve, and once more with
    ``mixed_precision=False``, which must give the same solves, iterations,
    panels and allocation bit for bit. Fails unless the contract holds, no
    solve missed the kernel's fit rule, device pricing served anchors, the
    steady rounds kept to one synchronisation each
    (``decomp_host_syncs − decomp_polish_syncs ≤ decomp_rounds``) and
    nothing was quarantined. The first run's profile certificate starts in
    ``audits``."""
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers import batch_lp, face_decompose, lp_pdhg

    finish = lp_pdhg.finish_two_sided_master
    screen = batch_lp.solve_polish_screen_ell
    profiles = []

    def run(cfg=cfg):
        solves = []

        def recorded(h):
            sol = finish(h)
            solves.append(["master", int(h.Cp), int(sol.iters)])
            return sol

        def recorded_screen(ell, *a, **kw):
            sols = screen(ell, *a, **kw)
            solves.append(["screen", len(ell), [int(s.iters) for s in sols]])
            return sols

        with mock.patch.object(lp_pdhg, "finish_two_sided_master", recorded), \
                mock.patch.object(batch_lp, "solve_polish_screen_ell", recorded_screen), \
                mock.patch.object(face_decompose, "realize_profile", face_profiles(profiles)):
            return leximin_run(inst, "cuda", cfg) + (solves,)

    for lib in libs:
        lib.reset_counts()
    dist, dlog, secs, linf, solves = run()
    launches = {"ell_gather": em.KERNEL.launches, "two_sided_block": mk.KERNEL.launches,
                "ell_gather_bf16": bf16_gathers()}
    start_profile_audit(audits, "leximin_sf_e_defaults", featurize(inst, device="cpu")[0], dist)
    again, alog, secs2, _, solves2 = run()
    off, olog, secs_off, _, solves_off = run(cfg.replace(mixed_precision=False))
    c, tm = dlog.counters, dlog.timers
    alloc = dist.allocation
    mean = alloc.mean()
    gini = float(np.abs(alloc[:, None] - alloc[None, :]).mean() / (2 * mean)) if mean else 0.0
    keys = (
        "decomp_rounds", "decomp_host_syncs", "decomp_polish_syncs", "decomp_oracle_device_hit",
        "decomp_oracle_device_miss", "device_pricing_dispatches", "lp_batch_dispatches",
        "lp_batch_polish_hit", "lp_batch_polish_miss", "megakernel_lanes",
        "megakernel_dispatches", "megakernel_fit_miss",
    )
    counters = {k: int(c.get(k, 0)) for k in keys}
    steady = counters["decomp_host_syncs"] - counters["decomp_polish_syncs"]
    rec = dict(
        phase="leximin_sf_e_defaults", seconds=secs, contract_ok=bool(dist.contract_ok),
        linf=linf, min_prob=float(alloc.min()), gini=gini,
        panels=int(len(dist.probabilities)), launches=launches, counters=counters,
        steady_syncs=steady, sync_rule=bool(steady <= counters["decomp_rounds"]),
        timers={k: tm.get(k, 0.0) for k in (
            "relax_leximin", "inject", "decomp_master", "decomp_polish", "decomp_polish_screen",
            "decomp_expand", "decomp_oracle", "final_stage", "decomp",
        )},
        solves=solves,
        repeat=dict(seconds=secs2, solves=solves2, same_iters=solves2 == solves,
                    counters={k: int(alog.counters.get(k, 0)) for k in keys},
                    same_allocation=bool(np.array_equal(again.allocation, alloc))),
        mixed_precision=mp_counts(c), faults=fault_counts(c),
        mixed_precision_off=dict(
            seconds=secs_off, counters=mp_counts(olog.counters), same_solves=solves_off == solves,
            bit_identical=bool(
                np.array_equal(off.committees, dist.committees)
                and np.array_equal(off.probabilities, dist.probabilities)
                and np.array_equal(off.allocation, alloc)
            ),
        ),
    )
    rec["ok"] = bool(
        dist.contract_ok and linf <= E2E_CONTRACT and np.isfinite(alloc).all()
        and alloc.shape == (1727,) and launches["ell_gather"] > 0
        and launches["two_sided_block"] > 0 and counters["megakernel_fit_miss"] == 0
        and counters["decomp_oracle_device_hit"] > 0 and rec["sync_rule"]
        and solves2 == solves and again.contract_ok
        and sum(rec["mixed_precision"].values()) > 0
        and rec["mixed_precision_off"]["same_solves"] and rec["mixed_precision_off"]["bit_identical"]
        and not any(rec["mixed_precision_off"]["counters"].values())
        and clean(c) and clean(alog.counters) and clean(olog.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec, launches, dist, profiles[0]


def mass_like_phase(cfg, audits):
    """LEXIMIN at the defaults on ``mass_like_instance(seed=3)`` against the
    same run with the batched engine off: both meet the contract and the
    fixed probabilities agree within 1e-6. The pool has T=28 types, over
    ``enum_max_types``, so it takes the column-generation path in both
    packages; the enumerated path, where the probe prescreen runs, is
    driven the same way on ``example_small_like_instance()`` (4 types),
    whose prescreen must run. Each pool's profile certificate (of the run
    with the engine on) starts in ``audits``."""
    from citizensassemblies_tpu_torch.core.generator import (
        example_small_like_instance,
        mass_like_instance,
    )
    from citizensassemblies_tpu_torch.core.instance import featurize

    rec = dict(phase="leximin_mass_like_defaults")
    ok = True
    for key, inst in (("mass_like", mass_like_instance(seed=3)),
                      ("example_small_like", example_small_like_instance())):
        on, log_on, s_on, l_on = leximin_run(inst, "cuda", cfg)
        start_profile_audit(audits, f"leximin_mass_like_defaults:{key}",
                            featurize(inst, device="cpu")[0], on)
        off, log_off, s_off, l_off = leximin_run(inst, "cuda", cfg.replace(lp_batch=False))
        gap = float(np.max(np.abs(on.fixed_probabilities - off.fixed_probabilities)))
        c = log_on.counters
        sub = dict(
            path="enumerated" if "typespace_lp" in log_on.timers else "column generation",
            seconds=s_on, seconds_engine_off=s_off, contract_ok=bool(on.contract_ok),
            contract_ok_engine_off=bool(off.contract_ok), linf=l_on, fixed_gap=gap,
            lp_batch_probe_screened=int(c.get("lp_batch_probe_screened", 0)),
            lp_batch_probe_pruned=int(c.get("lp_batch_probe_pruned", 0)),
            lp_batch_dispatches=int(c.get("lp_batch_dispatches", 0)),
            typespace_lp_s=log_on.timers.get("typespace_lp"),
            typespace_lp_s_engine_off=log_off.timers.get("typespace_lp"),
            mixed_precision=mp_counts(c), faults=fault_counts(c),
        )
        rec[key] = sub
        ok = (ok and on.contract_ok and off.contract_ok and gap <= 1e-6 and clean(c)
              and clean(log_off.counters))
    rec["ok"] = bool(ok and rec["example_small_like"]["lp_batch_probe_screened"] > 0)
    print(json.dumps(rec), flush=True)
    return rec


def dense_graph_phase(inst):
    """The dense chained PDHG (``lp_pdhg._pdhg_body``: the core of the
    stage LP, the final primal LP and the probe prescreen) with its blocks
    replayed as a CUDA graph, against the same solve launched op by op, on
    a stage LP of ``inst`` (``lp_pdhg.stage_lp_operands`` over its leximin
    relaxation sliced into 384 columns, nothing fixed) capped at
    ``DENSE_GRAPH_MAX_ITERS``: x, λ, μ, iterations and residual must be
    bit-identical, and the graph must have replaced the eager blocks. Both
    are timed on the host clock around a synchronised call."""
    import torch

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.solvers import cg_typespace as tcg
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import _pdhg_body, stage_lp_operands
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, _ = featurize(inst, device="cpu")
    red = TypeReduction(dense)
    v, _ = tcg._leximin_relaxation(red, RunLog(echo=False))
    comps = np.stack(tcg._slice_relaxation(v * red.msize.astype(np.float64), red, R=384))
    MT = np.ascontiguousarray((comps / red.msize[None, :].astype(np.float64)).T)
    cfg = default_config()
    f32 = dict(dtype=torch.float32, device="cuda")
    ops = [torch.as_tensor(np.asarray(a, np.float32), **f32)
           for a in stage_lp_operands(MT, np.full(red.T, -1.0))]
    m1, nv = ops[1].shape
    out, secs = {}, {}
    for graph in (False, True):
        warm = [torch.zeros(n, **f32) for n in (nv, m1, 1)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[graph] = _pdhg_body(
            *ops, *warm, float(cfg.pdhg_tol), max_iters=DENSE_GRAPH_MAX_ITERS,
            check_every=int(cfg.pdhg_check_every), graph=graph,
        )
        torch.cuda.synchronize()
        secs[graph] = time.perf_counter() - t
    eager, replay = out[False], out[True]
    iters = int(replay[3])
    same = bool(all(torch.equal(a, b) for a, b in zip(eager[:3], replay[:3]))
                and tuple(eager[3:]) == tuple(replay[3:]))
    rec = dict(
        phase="dense_pdhg_graph", shape=dict(T=int(red.T), C=int(MT.shape[1]), m1=int(m1), nv=int(nv)),
        iters=iters, eager_s=secs[False], graph_s=secs[True],
        eager_us_per_iter=1e6 * secs[False] / iters, graph_us_per_iter=1e6 * secs[True] / iters,
        bit_identical=same, ok=same and iters > int(cfg.pdhg_check_every),
    )
    print(json.dumps(rec), flush=True)
    return rec


class _StageCGBudgetSpent(Exception):
    pass


def stage_cg_phase(inst, cfg, label, accept, audits, rounds=None, reference=False):
    """The type-space path on ``inst`` with the face loop made to stall
    (``decomp_accept = decomp_accept_stalled = accept``, at most ``rounds``
    rounds when given), so the stage-CG fallback carries it, under
    ``STAGE_CG_BUDGET_S`` in all unless ``reference``: the run stops before
    the first stage LP that would end past it at the last one's pace. Each stage-LP PDHG
    solve's columns, types fixed before it, convergence and seconds are
    recorded (by wrapping ``lp_pdhg.solve_stage_lp_pdhg``); the host
    re-solves are the ``stage_lp_host`` counter, the pricing iterations the
    log's ``stage s iter i`` lines. A run that finishes must meet the
    contract. With ``reference`` the run has no budget (its stage LPs are
    host-bound, so a budget would tie the check to the host's speed) and
    must finish, price (stochastic
    draws on the card's generator and the exact MILP) at least once, and
    match the same run on the CPU (host stage LPs): the same stage count and
    the fixed probabilities within ``STAGE_CG_FIXED_TOL``. A finished run's
    profile certificate starts in ``audits``."""
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.solvers import lp_pdhg
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    solve = lp_pdhg.solve_stage_lp_pdhg
    pdhg_log = []
    t0 = time.perf_counter()

    def budgeted(MT, fixed, **kw):
        # stop before a stage LP that would end past the budget at the
        # last one's pace
        last = pdhg_log[-1][-1] if pdhg_log else 0.0
        if not reference and time.perf_counter() - t0 + last > STAGE_CG_BUDGET_S:
            raise _StageCGBudgetSpent
        t = time.perf_counter()
        out = solve(MT, fixed, **kw)
        pdhg_log.append([int(MT.shape[1]), int((fixed >= 0).sum()), bool(out[4]),
                         time.perf_counter() - t])
        return out

    def stages(log):
        return sum(1 for ln in log.lines if ln.startswith("Fixed ") or "meets relaxation bound" in ln)

    dense, space = featurize(inst, device="cuda")
    slog = RunLog(echo=False)
    cfg = cfg.replace(decomp_accept=accept, decomp_accept_stalled=accept)
    if rounds is not None:
        cfg = cfg.replace(decomp_max_rounds=rounds)
    dist = None
    with mock.patch.object(lp_pdhg, "solve_stage_lp_pdhg", budgeted):
        try:
            dist = find_distribution_leximin(dense, space, cfg=cfg, log=slog, device="cuda")
        except _StageCGBudgetSpent:
            pass
    secs = time.perf_counter() - t0
    if dist is not None:
        start_profile_audit(audits, label, dense, dist)
    c, tm = slog.counters, slog.timers
    stages_done = stages(slog)
    rec = dict(
        phase=label, n=dense.n, k=dense.k, accept=accept,
        budget_s=None if reference else STAGE_CG_BUDGET_S,
        seconds=secs, finished=dist is not None,
        fell_back=any("falling back to stage CG" in ln for ln in slog.lines),
        stages_completed=stages_done, decomp_rounds=int(c.get("decomp_rounds", 0)),
        stage_lp_pdhg=int(c.get("stage_lp_pdhg", 0)), stage_lp_host=int(c.get("stage_lp_host", 0)),
        pricing_iters=sum(1 for ln in slog.lines if ln.lstrip().startswith("stage ") and " iter " in ln),
        pdhg_solves=pdhg_log,
        timers={k: tm.get(k, 0.0) for k in (
            "decomp", "relaxation", "stage_lp", "stochastic_pricing", "exact_oracle", "typespace_cg",
        )},
    )
    ok = rec["fell_back"] and stages_done >= 1
    if dist is not None:
        rec["contract_ok"] = bool(dist.contract_ok)
        rec["linf"] = float(np.max(np.abs(dist.allocation - dist.fixed_probabilities)))
        ok = ok and dist.contract_ok
    if reference:
        cd, cs = featurize(inst, device="cpu")
        clog = RunLog(echo=False)
        ref = find_distribution_leximin(cd, cs, cfg=cfg, log=clog, device="cpu")
        gap = (float(np.max(np.abs(dist.fixed_probabilities - ref.fixed_probabilities)))
               if dist is not None else None)
        rec.update(cpu_stages=stages(clog), cpu_contract_ok=bool(ref.contract_ok), fixed_gap=gap,
                   fixed_tol=STAGE_CG_FIXED_TOL)
        ok = (
            ok and dist is not None and rec["pricing_iters"] >= 1
            and rec["timers"]["stochastic_pricing"] > 0 and rec["timers"]["exact_oracle"] > 0
            and stages_done == rec["cpu_stages"] and ref.contract_ok and gap <= STAGE_CG_FIXED_TOL
        )
    rec["ok"] = bool(ok)
    print(json.dumps(rec), flush=True)
    return rec


def xmin_run(dense, space, cfg, leximin):
    """XMIN on the card from a LEXIMIN result: ``(dist, log, seconds)``,
    the clock stopped after ``torch.cuda.synchronize()``."""
    import torch

    from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    log = RunLog(echo=False)
    t0 = time.perf_counter()
    dist = find_distribution_xmin(dense, space, cfg=cfg, log=log, leximin=leximin, device="cuda")
    torch.cuda.synchronize()
    return dist, log, time.perf_counter() - t0


def xmin_phase(inst, cfg, leximin, lex_seconds, libs):
    """XMIN on the flagship pool at the defaults, seeded with the defaults
    flagship's LEXIMIN distribution (no second LEXIMIN solve), every launch
    counter zeroed just before it and read just after: the expansion to
    ``8n`` distinct new panels, then the fused ELL min-L2 stage (anchor,
    floor pick, ascent in 512-iteration chunks). Run twice with the same
    seed: the second run must be bit-identical (portfolio, probabilities,
    anchor and ascent iterations); and once with ``mixed_precision=False``,
    which must be bit-identical to the engaged run (at the defaults the
    portfolio's 0/1 pack goes up as bf16 and the ascent's gathers take the
    kernel's bf16-value path). Held: no quarantine, the contract
    (``realization_dev ≤ 1e-3``), a support above LEXIMIN's, every panel of
    k members meeting every quota, probabilities summing to 1 within
    1e-9. Returns ``(rec, dist)``."""
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    dense, space = featurize(inst, device="cuda")
    for lib in libs:
        lib.reset_counts()
    dist, xlog, secs = xmin_run(dense, space, cfg, leximin)
    launches = {"ell_gather": em.KERNEL.launches, "two_sided_block": mk.KERNEL.launches,
                "lp_block": mk.LP_KERNEL.launches, "ell_gather_bf16": bf16_gathers()}
    again, alog, secs2 = xmin_run(dense, space, cfg, leximin)
    off, olog, secs_off = xmin_run(dense, space, cfg.replace(mixed_precision=False), leximin)
    c, tm = xlog.counters, xlog.timers
    P, probs = dist.committees, dist.probabilities
    counts = P.astype(np.int64) @ dense.A_np.astype(np.int64)
    quotas_ok = bool(
        (P.sum(axis=1) == dense.k).all()
        and (counts >= dense.qmin_np[None, :]).all() and (counts <= dense.qmax_np[None, :]).all()
    )
    support = int((probs > cfg.support_eps).sum())
    lex_support = int((leximin.probabilities > cfg.support_eps).sum())
    sorted_gap = float(np.abs(np.sort(dist.allocation) - np.sort(leximin.allocation)).max())
    iters = {k: int(c.get(k, 0)) for k in ("l2_anchor_iters", "l2_ascent_iters")}
    iters2 = {k: int(alog.counters.get(k, 0)) for k in iters}
    same = bool(
        np.array_equal(again.committees, P) and np.array_equal(again.probabilities, probs)
        and iters2 == iters
    )
    same_off = bool(
        np.array_equal(off.committees, P) and np.array_equal(off.probabilities, probs)
        and {k: int(olog.counters.get(k, 0)) for k in iters} == iters
    )
    rec = dict(
        phase="xmin_sf_e_skewed", n=dense.n, k=dense.k, seconds=secs,
        seconds_with_leximin=secs + lex_seconds, repeat_seconds=secs2,
        panels=int(P.shape[0]), new_panels=int(P.shape[0] - leximin.committees.shape[0]),
        support_panels=support, leximin_support_panels=lex_support,
        sorted_alloc_linf_vs_leximin=sorted_gap, realization_dev=float(dist.realization_dev),
        min_prob=float(dist.allocation.min()), contract_ok=bool(dist.contract_ok),
        prob_sum_err=abs(float(probs.sum()) - 1.0), quotas_ok=quotas_ok,
        timers={k: tm[k] for k in (
            "xmin_draws", "xmin_dedup", "sparse_pack", "xmin_l2", "l2_fused", "l2_anchor",
            "l2_ascent", "l2_eps_pdhg", "l2_dual_ascent",
        ) if k in tm},
        counters={k: int(c.get(k, 0)) for k in ("lp_batch_l2_fused", "sparse_hit", "sparse_miss",
                                                 "sparse_fill_pct", "sentinel_quarantined",
                                                 "l2_ascent_replays")},
        anchor_iters=iters["l2_anchor_iters"], ascent_iters=iters["l2_ascent_iters"],
        ascent_chunks=iters["l2_ascent_iters"] // 512, launches=launches,
        repeat=dict(iters=iters2, bit_identical=same),
        mixed_precision=mp_counts(c), faults=fault_counts(c),
        mixed_precision_off=dict(seconds=secs_off, counters=mp_counts(olog.counters),
                                 bit_identical=same_off),
    )
    rec["ok"] = bool(
        dist.contract_ok and dist.realization_dev <= E2E_CONTRACT and support > lex_support
        and quotas_ok and rec["prob_sum_err"] <= 1e-9 and np.isfinite(dist.allocation).all()
        and same and launches["ell_gather"] > 0
        and rec["mixed_precision"]["mp_demoted_operands"] >= 1 and same_off
        and not any(rec["mixed_precision_off"]["counters"].values())
        and clean(c) and clean(alog.counters) and clean(olog.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec, dist


#: the fused L2 core on the card against the same core on the CPU: a prefix
#: of the grown flagship portfolio small enough for the CPU side, the
#: schedule of solve_final_primal_l2 (anchor cap, 128-iteration checks,
#: 512-iteration chunks, at most 40), with the sentinel; held at the bars of
#: tests/test_torch_qp.py (the spread p within 1e-5, the floor within 1e-6).
#: 512 panels since the checkpoint and fault phases came in (1,024 before)
L2_HOLD_ROWS = 512
L2_HOLD_P_TOL = 1e-5
L2_HOLD_FLOOR_TOL = 1e-6


def l2_hold_inputs(dist, leximin):
    """``(P, idx, val, n, t, donor)`` of ``xmin_l2_hold``: the first
    ``L2_HOLD_ROWS`` panels of the XMIN portfolio packed, the leximin
    values, the LEXIMIN probabilities as the donor (float32)."""
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    P = dist.committees[:L2_HOLD_ROWS]
    ell = EllPack.from_rows(P.astype(np.float32))
    donor = np.zeros(len(P))
    m = min(len(P), len(leximin.probabilities))
    donor[:m] = leximin.probabilities[:m]
    donor /= donor.sum()
    t = np.asarray(leximin.fixed_probabilities, np.float32)
    return P, ell.idx, ell.val, P.shape[1], t, donor.astype(np.float32)


def l2_hold_run(idx, val, n, t, donor, dev, graph):
    """One run of ``xmin_l2_hold``'s fused core on ``dev`` (``graph``: the
    ascent's chunks replayed as a CUDA graph): ``(outputs, seconds,
    timers)``."""
    import torch

    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.solvers import qp
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    core = qp._get_l2_fused_core_ell(qp.ANCHOR_ITERS, 128, qp.L2_CHUNK, 40, sentinel=True, graph=graph)
    csr = csr_to_device(idx, val, n, dev)
    args = [torch.as_tensor(a, device=dev) for a in (idx, val, t, donor)]
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    out = core(*args, torch.tensor(1e-6, device=dev), qp.ANCHOR_TOL, qp.ASCENT_TOL, csr, log=log)
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (out[0].cpu().numpy(), out[1].cpu().numpy(), out[2], out[3], out[4]), secs, log.timers


def _l2_hold_cpu(idx, val, n, t, donor, conn):
    """``xmin_l2_hold``'s CPU run in a worker process."""
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)
    conn.send(l2_hold_run(idx, val, n, t, donor, "cpu", False))


def xmin_l2_hold_card(dist, leximin):
    """The card half of :func:`xmin_l2_hold_phase`: the core with the
    ascent's chunks replayed as a CUDA graph, and op by op. Returns ``(rows,
    k_pad, n, outputs, seconds, timers)``."""
    P, idx, val, n, t, donor = l2_hold_inputs(dist, leximin)
    outs, secs, timers = {}, {}, {}
    for label, graph in (("cuda", True), ("cuda_eager", False)):
        outs[label], secs[label], timers[label] = l2_hold_run(idx, val, n, t, donor, "cuda", graph)
    return len(P), idx.shape[1], n, outs, secs, timers


def xmin_l2_hold_phase(card, cpu_run):
    """``qp._get_l2_fused_core_ell`` on the first ``L2_HOLD_ROWS`` panels of
    the XMIN portfolio (targets: the leximin values; donor: the LEXIMIN
    probabilities) on the card, the gather kernel and the agent-major CSR
    transpose (``card``, :func:`xmin_l2_hold_card`), against the same core
    on the CPU (the plain gather and ``index_add_``; ``cpu_run``, the worker
    of :func:`start_l2_references`): equal anchor iterations and ascent
    chunks, p within ``L2_HOLD_P_TOL``, the floor vector within
    ``L2_HOLD_FLOOR_TOL``. On the card the ascent's chunks replay as a CUDA
    graph; the same core with every chunk launched op by op must give the
    same result bit for bit. ``main`` judges it some phases after the card
    half, when the CPU run (about a minute) has had its time."""
    rows, k_pad, n, outs, secs, timers = card
    outs["cpu"], secs["cpu"], timers["cpu"] = cpu_worker_result(cpu_run)
    g, e, c = outs["cuda"], outs["cuda_eager"], outs["cpu"]
    p_err = float(np.abs(g[0] - c[0]).max())
    floor_err = float(np.abs(g[1] - c[1]).max())
    graph_equal = bool(
        np.array_equal(g[0], e[0]) and np.array_equal(g[1], e[1]) and g[2:] == e[2:]
    )
    rec = dict(
        phase="xmin_l2_hold", rows=rows, n=n, k_pad=k_pad, seconds=secs, timers=timers,
        anchor_iters=[g[2], c[2]], ascent_iters=[g[3], c[3]], flags=[g[4], c[4]],
        p_max_abs_err=p_err, floor_max_abs_err=floor_err, graph_bit_identical=graph_equal,
        p_tolerance=L2_HOLD_P_TOL, floor_tolerance=L2_HOLD_FLOOR_TOL,
    )
    rec["ok"] = bool(
        g[2] == c[2] and g[3] == c[3] and g[4] == c[4] == 0 and graph_equal
        and p_err <= L2_HOLD_P_TOL and floor_err <= L2_HOLD_FLOOR_TOL
    )
    print(json.dumps(rec), flush=True)
    return rec


#: the serial min-L2 route on the card against the CPU, on the hold's
#: prefix, at the bars of tests/test_torch_qp.py's solve_final_primal_l2
#: cases: ε* within 1e-6, the realized deviation within 1e-5
L2_SERIAL_EPS_TOL = 1e-6
L2_SERIAL_DEV_TOL = 1e-5
#: iterations of the serial ascent's graph-vs-op-by-op check: two chunks
#: and a remainder
L2_SERIAL_GRAPH_ITERS = 2 * 512 + 76


def l2_serial_run(P, t, donor, cfg, dev):
    """``qp.solve_final_primal_l2`` on the serial route (``lp_batch`` off)
    on ``dev``, targets ``t`` (the leximin values) and the donor ``donor``
    (the LEXIMIN probabilities): ``(p, ε*, realized deviation, seconds,
    log)`` (``log``: the run's timers and counters)."""
    from types import SimpleNamespace

    import torch

    from citizensassemblies_tpu_torch.solvers import qp
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    log = RunLog(echo=False)
    t0 = time.perf_counter()
    p, eps = qp.solve_final_primal_l2(
        P, t, iters=cfg.xmin_qp_iters, floor_donor=donor[: len(P)],
        cfg=cfg.replace(lp_batch=False), log=log, device=dev,
    )
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    real = float(np.abs(P.T.astype(np.float64) @ p - t).max())
    return p, eps, real, secs, SimpleNamespace(timers=log.timers, counters=log.counters)


def l2_serial_inputs(dist, leximin):
    """``(P, t, donor)`` of ``l2_serial``: the hold's panels, the leximin
    values and the LEXIMIN probabilities (float64)."""
    return (dist.committees[:L2_HOLD_ROWS], np.asarray(leximin.fixed_probabilities, np.float64),
            np.asarray(leximin.probabilities, np.float64))


def _l2_serial_cpu(P, t, donor, cfg, conn):
    """``l2_serial``'s CPU run in a worker process."""
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)
    conn.send(l2_serial_run(P, t, donor, cfg, "cpu"))


def start_l2_references(dist, leximin, cfg):
    """The CPU runs of ``xmin_l2_hold`` and ``l2_serial``, each started in
    a worker process, so they run while the card runs the phases' card
    parts. Returns ``(hold_worker, serial_worker)``."""
    return (start_cpu_worker(_l2_hold_cpu, *l2_hold_inputs(dist, leximin)[1:]),
            start_cpu_worker(_l2_serial_cpu, *l2_serial_inputs(dist, leximin), cfg))


def l2_serial_phase(dist, leximin, cfg, cpu_run):
    """``qp.solve_final_primal_l2`` on the serial route (``lp_batch`` off:
    the min-ε PDHG anchor ``l2_eps_pdhg``, then ``xmin_qp_iters`` ascent
    iterations ``l2_dual_ascent`` in graph-replayed 512-iteration chunks)
    with the LEXIMIN donor: on the first ``L2_HOLD_ROWS`` panels of the
    XMIN portfolio on the card and on the CPU (``cpu_run``, the worker of
    :func:`start_l2_references`), held at
    ``L2_SERIAL_EPS_TOL``/``L2_SERIAL_DEV_TOL``; on the card, the serial
    ELL ascent through its chunks against the same ascent op by op
    (``L2_SERIAL_GRAPH_ITERS``), bit for bit and with the same count of
    gather launches, which the replays count; and on the card on the whole
    portfolio, timed, held to the contract."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels.pdhg_megakernel import csr_to_device
    from citizensassemblies_tpu_torch.solvers import qp
    from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack

    P, t, donor = l2_serial_inputs(dist, leximin)
    hold = {"cuda": l2_serial_run(P, t, donor, cfg, "cuda"), "cpu": cpu_worker_result(cpu_run)}
    (pg, eg, rg, sg, lg), (pc, ec, rc, sc, lc) = hold["cuda"], hold["cpu"]
    # the serial ascent's chunks against the same ascent op by op
    ell = EllPack.from_rows(P.astype(np.float32))
    n = P.shape[1]
    csr = csr_to_device(ell.idx, ell.val, n, "cuda")
    idx, val = (torch.as_tensor(a, device="cuda") for a in (ell.idx, ell.val))
    tt = torch.as_tensor(t, dtype=torch.float32, device="cuda")
    eps_t = torch.tensor(eg + 1e-6, dtype=torch.float32, device="cuda")
    sigma_sq = float(qp._ell_power_norm(idx, val, n, csr=csr)) ** 2
    lr = torch.tensor(1.0 / max(sigma_sq / 2.0, 1.0), dtype=torch.float32, device="cuda")
    outs, gathers = {}, {}
    for label, graph in (("warm", True), ("graph", True), ("eager", False)):
        lam0 = torch.zeros(2 * n, dtype=torch.float32, device="cuda")
        before = em.KERNEL.launches
        p, lam = qp._min_norm_dual_ascent_ell(
            idx, val, tt, eps_t, lr, lam0, L2_SERIAL_GRAPH_ITERS, csr=csr, graph=graph
        )
        torch.cuda.synchronize()
        gathers[label] = em.KERNEL.launches - before
        outs[label] = (p.cpu().numpy(), lam.cpu().numpy())
    graph_equal = bool(
        np.array_equal(outs["graph"][0], outs["eager"][0])
        and np.array_equal(outs["graph"][1], outs["eager"][1])
    )
    # the serial route at the whole portfolio, on the card only
    pf, ef, rf, sf, lf = l2_serial_run(dist.committees, t, donor, cfg, "cuda")

    def summary(log, secs, eps, real):
        return dict(
            seconds=secs, eps_star=eps, realized_dev=real,
            timers={k: log.timers[k] for k in ("sparse_pack", "l2_eps_pdhg", "l2_dual_ascent")
                    if k in log.timers},
            counters={k: int(log.counters.get(k, 0)) for k in ("sparse_hit", "lp_batch_l2_fused")},
        )

    rec = dict(
        phase="l2_serial", rows=len(P), n=n, iters=cfg.xmin_qp_iters,
        cuda=summary(lg, sg, eg, rg), cpu=summary(lc, sc, ec, rc),
        eps_err=abs(eg - ec), dev_err=abs(rg - rc), p_max_abs_err=float(np.abs(pg - pc).max()),
        eps_tolerance=L2_SERIAL_EPS_TOL, dev_tolerance=L2_SERIAL_DEV_TOL,
        graph_iters=L2_SERIAL_GRAPH_ITERS, graph_bit_identical=graph_equal,
        gather_launches=gathers,
        full=dict(rows=int(dist.committees.shape[0]), **summary(lf, sf, ef, rf),
                  support_panels=int((pf > cfg.support_eps).sum()), prob_sum_err=abs(float(pf.sum()) - 1.0)),
    )
    rec["ok"] = bool(
        rec["eps_err"] <= L2_SERIAL_EPS_TOL and rec["dev_err"] <= L2_SERIAL_DEV_TOL
        and graph_equal and gathers["graph"] == gathers["eager"] == L2_SERIAL_GRAPH_ITERS + 1
        and "l2_dual_ascent" in lg.timers and lg.counters.get("sparse_hit", 0) == 1
        and "lp_batch_l2_fused" not in lg.counters
        and rf <= E2E_CONTRACT and np.isfinite(pf).all() and rec["full"]["prob_sum_err"] <= 1e-9
    )
    print(json.dumps(rec), flush=True)
    return rec


#: the household phases (queue A item 2): the leximin values of the card's
#: run and the CPU's are host LP optima from identical inputs; the
#: certificate's gap bar is the contract's
HH_FIXED_TOL = 1e-6
HH_MAXIMIN_GAP = 1e-3


def households_pool(n):
    """The household pools of bench.py:711-727 (couples ``arange(n) // 2``)
    and the n=240 pairs of tests/test_device_pricing.py:221-226."""
    from citizensassemblies_tpu_torch.core.generator import skewed_instance

    if n == 240:
        inst = skewed_instance(n=240, k=16, n_categories=3, seed=7, features_per_category=[3, 3, 3])
    elif n == 400:
        inst = skewed_instance(n=400, k=40, n_categories=6, seed=2,
                               features_per_category=[2, 3, 4, 2, 3, 3])
    elif n == 1200:
        inst = skewed_instance(n=1200, k=110, n_categories=7, seed=2,
                               features_per_category=[2, 4, 5, 3, 2, 4, 6], skew=0.4)
    elif n == 64:  # the couples of tests/test_households.py:70
        inst = skewed_instance(n=64, k=10, n_categories=3, seed=5, features_per_category=[2, 3, 2])
    else:
        raise ValueError(f"no household pool of {n} agents")
    return inst, (np.arange(n) // 2).astype(np.int32)


def households_check(dense, P, households):
    """``(quotas_ok, disjoint)`` of a portfolio: every panel of k members
    meets every quota; no panel holds two members of one household."""
    h = np.unique(households, return_inverse=True)[1].reshape(-1)
    counts = P.astype(np.int64) @ dense.A_np.astype(np.int64)
    quotas_ok = bool(
        (P.sum(axis=1) == dense.k).all()
        and (counts >= dense.qmin_np[None, :]).all() and (counts <= dense.qmax_np[None, :]).all()
    )
    per_house = P.astype(np.int32) @ np.eye(int(h.max()) + 1, dtype=np.int32)[h]
    return quotas_ok, bool((per_house <= 1).all())


def households_hold_phase(cfg, libs):
    """LEXIMIN with households on the n=240 pairs' quotient (T > 64 orbits
    over F > 64 features), every master forced onto the card
    (``decomp_host_master_max_types=0``: the two-sided kernel), against the
    same call on the CPU: the fixed probabilities within ``HH_FIXED_TOL``,
    both within the contract, every panel household-disjoint; then device
    pricing and the fused screen on the quotient's reduction, each
    dispatched under sync-debug "error" and held to its CPU run."""
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.solvers.device_pricing import DevicePricer
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient

    inst, hh = households_pool(240)
    forced = cfg.replace(decomp_host_master_max_types=0)
    for lib in libs:
        lib.reset_counts()
    d_gpu, log_gpu, s_gpu, l_gpu = leximin_run(inst, "cuda", forced, hh)
    launches = {"two_sided_block": mk.KERNEL.launches, "ell_gather": em.KERNEL.launches}
    d_cpu, _, s_cpu, l_cpu = leximin_run(inst, "cpu", forced, hh)
    dense = featurize(inst, device="cpu")[0]
    red = TypeReduction(build_household_quotient(dense, hh).dense_aug)
    quotas_ok, disjoint = households_check(dense, d_gpu.committees, hh)
    fixed_gap = float(np.abs(d_gpu.fixed_probabilities - d_cpu.fixed_probabilities).max())
    c = log_gpu.counters
    rec = dict(
        phase="households_hold", n=dense.n, k=dense.k, T=red.T, F=red.F,
        seconds_gpu=s_gpu, seconds_cpu=s_cpu, linf_gpu=l_gpu, linf_cpu=l_cpu,
        fixed_gap=fixed_gap, fixed_tolerance=HH_FIXED_TOL,
        alloc_gap=float(np.abs(d_gpu.allocation - d_cpu.allocation).max()),
        quotas_ok=quotas_ok, disjoint=disjoint, launches=launches,
        counters={k: int(c.get(k, 0)) for k in (
            "decomp_rounds", "megakernel_dispatches", "megakernel_fit_miss",
            "decomp_oracle_device_hit", "decomp_oracle_device_miss", "lp_batch_polish_hit",
            "lp_batch_polish_miss")},
        mixed_precision=mp_counts(c), faults=fault_counts(c),
    )
    rec["ok"] = bool(
        d_gpu.contract_ok and d_cpu.contract_ok and fixed_gap <= HH_FIXED_TOL and quotas_ok
        and disjoint and launches["two_sided_block"] > 0 and rec["counters"]["megakernel_fit_miss"] == 0
        and red.F > 64 and clean(c)
    )
    print(json.dumps(rec), flush=True)
    # 512 feasible compositions of the quotient from device-pricing lanes
    # (CPU, seeded), as the columns the fused screen moves
    rng = np.random.default_rng(12)
    cpu_pricer = DevicePricer(red, device="cpu")
    comps = []
    while len(comps) < 512:
        handle = cpu_pricer.dispatch([(rng.normal(0, 1.0, red.T), None) for _ in range(16)])
        lanes, ok = handle.comps.numpy(), handle.ok.numpy()
        comps.extend(lanes.reshape(-1, red.T)[ok.reshape(-1)])
    MT = (np.stack(comps[:512]).astype(np.float64) / red.msize[None, :]).T
    pricing = device_pricing_phase(red, "households_device_pricing")
    screen = fused_screen_phase(red, MT, "households_fused_screen")
    rec["ok"] = bool(rec["ok"] and pricing["ok"] and screen["ok"])
    return rec


def households_leximin_phase(n, cfg, libs, audits, repeat=False):
    """LEXIMIN with households on the bench pool of ``n`` couples at the
    package's defaults, every launch counter zeroed just before it and read
    just after. A pool whose household rows make the quotas infeasible
    raises ``InfeasibleQuotasError``; its suggested quotas are applied and
    the run made again (bench.py:651-672), and the host seconds of the
    feasibility gate and the relaxation MILP are recorded (by wrapping
    them). Held: the contract, every panel household-disjoint and meeting
    the quotas, ``audit_maximin`` on the quotient's augmented instance
    within ``HH_MAXIMIN_GAP``; with ``repeat`` a second run, bit for bit.
    The profile certificate on the quotient's augmented instance starts in
    ``audits``. Returns ``(rec, dist, dense, space, households)``."""
    import dataclasses
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import InfeasibleQuotasError, featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.models import leximin
    from citizensassemblies_tpu_torch.solvers import highs_backend
    from citizensassemblies_tpu_torch.solvers.highs_backend import audit_maximin
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.solvers.quotient import build_household_quotient

    inst, hh = households_pool(n)
    host = {"feasibility_s": 0.0, "relaxation_s": 0.0}
    gate, relax = leximin.check_feasible_or_suggest, highs_backend.relax_infeasible_quotas

    def timed_gate(*a, **kw):
        t = time.perf_counter()
        try:
            return gate(*a, **kw)
        finally:
            host["feasibility_s"] += time.perf_counter() - t

    def timed_relax(*a, **kw):
        t = time.perf_counter()
        try:
            return relax(*a, **kw)
        finally:
            host["relaxation_s"] += time.perf_counter() - t

    for lib in libs:
        lib.reset_counts()
    repaired = False
    t0 = time.perf_counter()
    with mock.patch.object(leximin, "check_feasible_or_suggest", timed_gate), \
            mock.patch.object(highs_backend, "relax_infeasible_quotas", timed_relax):
        try:
            dist, hlog, secs, linf = leximin_run(inst, "cuda", cfg, hh)
        except InfeasibleQuotasError as exc:
            repaired = True
            inst = dataclasses.replace(inst, categories={
                cat: {f: exc.quotas[(cat, f)] for f in feats}
                for cat, feats in inst.categories.items()
            })
            dist, hlog, secs, linf = leximin_run(inst, "cuda", cfg, hh)
    total = time.perf_counter() - t0
    launches = {"two_sided_block": mk.KERNEL.launches, "ell_gather": em.KERNEL.launches,
                "lp_block": mk.LP_KERNEL.launches, "ell_gather_bf16": bf16_gathers()}
    dense, space = featurize(inst, device="cuda")
    quotient = build_household_quotient(dense, hh)
    red = TypeReduction(quotient.dense_aug)
    t = time.perf_counter()
    audit = audit_maximin(quotient.dense_aug, dist.allocation, dist.covered)
    audit_s = time.perf_counter() - t
    start_profile_audit(audits, f"households_n{n}", quotient.dense_aug, dist)
    quotas_ok, disjoint = households_check(dense, dist.committees, hh)
    c, tm = hlog.counters, hlog.timers
    keys = ("decomp_rounds", "decomp_host_syncs", "decomp_polish_syncs",
            "decomp_oracle_device_hit", "decomp_oracle_device_miss", "device_pricing_dispatches",
            "lp_batch_polish_hit", "lp_batch_polish_miss", "megakernel_dispatches",
            "megakernel_fit_miss", "oracle_backend_highs", "oracle_backend_native")
    rec = dict(
        phase=f"households_n{n}", n=dense.n, k=dense.k, seconds=secs, seconds_with_repair=total,
        repaired=repaired, host_gate=host, household_classes=int(quotient.n_classes),
        T=red.T, F=red.F, contract_ok=bool(dist.contract_ok), linf=linf,
        min_prob=float(dist.allocation[dist.covered].min()),
        panels=int(len(dist.probabilities)), quotas_ok=quotas_ok, disjoint=disjoint,
        audit=audit, audit_s=audit_s, launches=launches,
        counters={k: int(c.get(k, 0)) for k in keys},
        timers={k: tm.get(k, 0.0) for k in (
            "relax_leximin", "inject", "decomp_master", "decomp_polish", "decomp_polish_screen",
            "decomp_expand", "decomp_oracle", "final_stage", "typespace_cg",
        )},
        fell_back=any("falling back" in line for line in dist.output_lines),
        mixed_precision=mp_counts(c), faults=fault_counts(c),
    )
    ok = (
        dist.contract_ok and linf <= E2E_CONTRACT and np.isfinite(dist.allocation).all()
        and quotas_ok and disjoint and audit["maximin_gap"] <= HH_MAXIMIN_GAP
        and rec["counters"]["megakernel_fit_miss"] == 0 and not rec["fell_back"] and clean(c)
    )
    if n == 1200:
        ok = ok and launches["two_sided_block"] > 0 and launches["ell_gather"] > 0
    if repeat:
        again, alog, secs2, _ = leximin_run(inst, "cuda", cfg, hh)
        same = bool(
            np.array_equal(again.committees, dist.committees)
            and np.array_equal(again.probabilities, dist.probabilities)
        )
        rec["repeat"] = dict(seconds=secs2, bit_identical=same,
                             counters={k: int(alog.counters.get(k, 0)) for k in keys})
        ok = ok and same
    rec["ok"] = bool(ok)
    print(json.dumps(rec), flush=True)
    return rec, dist, dense, space, hh


def households_agent_space_phase(cfg, libs):
    """The agent-space CG with households on the n=64 couples, forced by
    four household-disjoint warm-start panels from the card's sampler
    (``initial_panels``), every dual LP on the card (``backend="jax"``: the
    LP kernel), every launch counter zeroed just before it and read just
    after. Held: one ``lp_block`` launch for every dual LP, the contract,
    every panel household-disjoint, the allocation within the contract of
    the quotient solve on the same pool."""
    import torch

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch

    inst, hh = households_pool(64)
    dense = featurize(inst, device="cuda")[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    panels, ok = sample_panels_batch(dense, gen, 32, households=hh)
    panels = np.sort(panels.cpu().numpy(), axis=1)
    seeds = [tuple(panels[b].tolist()) for b in np.nonzero(ok.cpu().numpy())[0][:4]]
    agent_cfg = cfg.replace(backend="jax")
    for lib in libs:
        lib.reset_counts()
    dist, alog, secs, linf = leximin_run(inst, "cuda", agent_cfg, hh, initial_panels=seeds)
    launches = {"lp_block": mk.LP_KERNEL.launches, "ell_gather": em.KERNEL.launches,
                "two_sided_block": mk.KERNEL.launches}
    quotient, _, q_secs, _ = leximin_run(inst, "cuda", cfg, hh)
    quotas_ok, disjoint = households_check(dense, dist.committees, hh)
    gap = float(np.abs(dist.allocation - quotient.allocation).max())
    c, tm = alog.counters, alog.timers
    rec = dict(
        phase="households_agent_space_64", n=dense.n, k=dense.k, seconds=secs,
        quotient_seconds=q_secs, warm_panels=len(seeds), contract_ok=bool(dist.contract_ok),
        linf=linf, alloc_gap_to_quotient=gap, quotas_ok=quotas_ok, disjoint=disjoint,
        launches=launches,
        dual_solves=int(c.get("agent_space_dual_solves", 0)),
        host_fallbacks=int(c.get("dual_lp_host_fallback", 0)),
        oracle_backend_highs=int(c.get("oracle_backend_highs", 0)),
        timers={k: tm.get(k, 0.0) for k in ("dual_lp", "stochastic_pricing", "exact_oracle",
                                            "final_stage")},
        mixed_precision=mp_counts(c), faults=fault_counts(c),
    )
    rec["ok"] = bool(
        len(seeds) == 4 and dist.contract_ok and quotient.contract_ok and gap <= E2E_CONTRACT
        and quotas_ok and disjoint and launches["lp_block"] > 0
        and launches["lp_block"] == rec["dual_solves"] and clean(c)
    )
    print(json.dumps(rec), flush=True)
    return rec


def households_xmin_phase(dense, space, cfg, households, leximin, lex_seconds, libs):
    """XMIN with households on the n=400 couples, seeded with
    ``households_n400``'s distribution, every launch counter zeroed just
    before it and read just after; run twice, bit for bit. Held: every
    panel household-disjoint and meeting the quotas, ``realization_dev``
    within the contract, the min-L2 stage's gather launched."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.models.xmin import find_distribution_xmin
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    def run():
        log = RunLog(echo=False)
        t0 = time.perf_counter()
        dist = find_distribution_xmin(dense, space, cfg=cfg, households=households, log=log,
                                      leximin=leximin, device="cuda")
        torch.cuda.synchronize()
        return dist, log, time.perf_counter() - t0

    for lib in libs:
        lib.reset_counts()
    dist, xlog, secs = run()
    launches = {"ell_gather": em.KERNEL.launches, "two_sided_block": mk.KERNEL.launches,
                "lp_block": mk.LP_KERNEL.launches, "ell_gather_bf16": bf16_gathers()}
    again, alog, secs2 = run()
    quotas_ok, disjoint = households_check(dense, dist.committees, households)
    c, tm = xlog.counters, xlog.timers
    support = int((dist.probabilities > cfg.support_eps).sum())
    same = bool(
        np.array_equal(again.committees, dist.committees)
        and np.array_equal(again.probabilities, dist.probabilities)
    )
    rec = dict(
        phase="xmin_households_n400", n=dense.n, k=dense.k, seconds=secs,
        seconds_with_leximin=secs + lex_seconds, repeat_seconds=secs2,
        panels=int(dist.committees.shape[0]),
        new_panels=int(dist.committees.shape[0] - leximin.committees.shape[0]),
        support_panels=support,
        leximin_support_panels=int((leximin.probabilities > cfg.support_eps).sum()),
        realization_dev=float(dist.realization_dev), contract_ok=bool(dist.contract_ok),
        quotas_ok=quotas_ok, disjoint=disjoint, launches=launches,
        prob_sum_err=abs(float(dist.probabilities.sum()) - 1.0),
        timers={k: tm[k] for k in ("xmin_draws", "xmin_dedup", "sparse_pack", "xmin_l2",
                                   "l2_fused", "l2_anchor", "l2_ascent") if k in tm},
        counters={k: int(c.get(k, 0)) for k in ("lp_batch_l2_fused", "l2_anchor_iters",
                                                 "l2_ascent_iters", "l2_ascent_replays")},
        repeat=dict(bit_identical=same),
        mixed_precision=mp_counts(c), faults=fault_counts(c),
    )
    rec["ok"] = bool(
        dist.contract_ok and dist.realization_dev <= E2E_CONTRACT and quotas_ok and disjoint
        and same and launches["ell_gather"] > 0 and rec["prob_sum_err"] <= 1e-9
        and np.isfinite(dist.allocation).all() and clean(c)
    )
    print(json.dumps(rec), flush=True)
    return rec


#: the bar of tests/test_checkpoint.py for a resumed agent-space run
#: against the uninterrupted one (a crafted state fixes half the agents at
#: their leximin values and the rest is solved again)
RESUME_TOL = 2e-2


def checkpoint_flagship_phase(inst, cfg, reference, reference_profile):
    """The flagship at the defaults with ``robust_checkpoint_every=1``: one
    injector (``CKPT_ABORT``, the process default, so its schedule runs on
    across attempts) kills the face loop by ``face_abort`` at the start of
    round 2 of the first attempt; the next attempt resumes from the
    snapshot of that round's top (the loop state with it) and runs to its
    end. Held: exactly one kill, ``robust_resume`` ≥ 1, the contract, the
    checkpoint directory empty after, no quarantine, and both the face
    loop's realized type profile and the per-agent allocation within
    ``E2E_CONTRACT`` (1e-3) of the uninterrupted defaults run's
    (``reference_profile``, ``(profile, distance)``, and ``reference``).
    Whether they are equal bit for bit (the resume replays the rounds) is
    reported. Each snapshot's write is timed (``save_face_state``)."""
    import tempfile
    from unittest import mock

    import torch

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.robust import checkpoint as rck
    from citizensassemblies_tpu_torch.robust import inject
    from citizensassemblies_tpu_torch.solvers import face_decompose
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, space = featurize(inst, device="cuda")
    save = rck.save_face_state
    saves = []

    def timed_save(*a, **kw):
        t = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - t)

    attempts, dist, profiles = [], None, []
    log = RunLog(echo=False)
    with tempfile.TemporaryDirectory() as ckdir, \
            mock.patch.object(rck, "save_face_state", timed_save), \
            mock.patch.object(face_decompose, "realize_profile", face_profiles(profiles)), \
            inject.use_injector(inject.FaultInjector(CKPT_ABORT[0], seed=CKPT_ABORT[1])):
        run_cfg = cfg.replace(robust_checkpoint_every=1, robust_checkpoint_dir=ckdir)
        for _ in range(4):
            t0 = time.perf_counter()
            try:
                dist = find_distribution_leximin(dense, space, cfg=run_cfg, log=log, device="cuda")
                torch.cuda.synchronize()
                attempts.append(["completed", time.perf_counter() - t0])
                break
            except inject.FaultInjected as exc:
                attempts.append([f"killed ({exc.site})", time.perf_counter() - t0])
        left = sorted(os.listdir(ckdir))
    c = log.counters
    gap = float(np.abs(dist.allocation - reference.allocation).max()) if dist is not None else None
    # the completed (resumed) attempt's face loop is the last one recorded
    profile_gap = (float(np.abs(profiles[-1][0] - reference_profile[0]).max())
                   if dist is not None and profiles else None)
    rec = dict(
        phase="checkpoint_flagship", schedule=list(CKPT_ABORT), attempts=attempts,
        robust_resume=int(c.get("robust_resume", 0)),
        robust_checkpoint_saved=int(c.get("robust_checkpoint_saved", 0)),
        fault_face_abort=int(c.get("fault_face_abort", 0)),
        save_s=saves, save_s_mean=float(np.mean(saves)) if saves else None,
        decomp_rounds=int(c.get("decomp_rounds", 0)),
        resumed_line=next((ln for ln in log.lines if "face checkpoint resumed" in ln), None),
        files_left=left, faults=fault_counts(c),
    )
    if dist is not None:
        rec.update(contract_ok=bool(dist.contract_ok), linf=float(dist.realization_dev),
                   face_dist_to_target=[reference_profile[1], profiles[-1][1]],
                   profile_gap_to_uninterrupted=profile_gap, alloc_gap_to_uninterrupted=gap,
                   tolerance=E2E_CONTRACT,
                   bit_identical=bool(
                       np.array_equal(profiles[-1][0], reference_profile[0])
                       and np.array_equal(dist.allocation, reference.allocation)))
    rec["ok"] = bool(
        dist is not None and dist.contract_ok and rec["fault_face_abort"] == 1
        and rec["robust_resume"] >= 1 and rec["robust_checkpoint_saved"] >= 1
        and profile_gap <= E2E_CONTRACT and gap <= E2E_CONTRACT and not left and clean(c)
    )
    print(json.dumps(rec), flush=True)
    return rec


def checkpoint_leximin_phase(inst, cfg, reference, agent_inst, agent_cfg, agent_ref):
    """``checkpoint_path=`` end to end. The flagship at the defaults: the
    type-space checkpoint is written once before the face decomposition
    (timed) and removed on success, and the run is bit for bit the
    uninterrupted defaults run (``reference``). A crafted agent-space state
    on the agent-space pool (its uninterrupted run's portfolio, half the
    agents fixed at their leximin values): the run logs the resume, meets
    the contract, lands within ``RESUME_TOL`` of the uninterrupted run and
    removes the file."""
    import tempfile
    from unittest import mock

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.utils import checkpoint as ck
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    save = ck.save_ts_state
    saves = []

    def timed_save(*a, **kw):
        t = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as ckdir:
        path = os.path.join(ckdir, "flagship.npz")
        dense, space = featurize(inst, device="cuda")
        log = RunLog(echo=False)
        t0 = time.perf_counter()
        with mock.patch.object(ck, "save_ts_state", timed_save):
            dist = find_distribution_leximin(dense, space, cfg=cfg, log=log, device="cuda",
                                             checkpoint_path=path)
        secs = time.perf_counter() - t0
        flagship = dict(
            seconds=secs, contract_ok=bool(dist.contract_ok), ts_saves=saves,
            file_left=os.path.exists(path), faults=fault_counts(log.counters),
            bit_identical=bool(
                np.array_equal(dist.allocation, reference.allocation)
                and np.array_equal(dist.probabilities, reference.probabilities)
            ),
        )
        path = os.path.join(ckdir, "agent.npz")
        adense, aspace = featurize(agent_inst, device="cuda")
        n = adense.n
        fixed = agent_ref.fixed_probabilities.copy()
        fixed[np.argsort(fixed)[n // 2:]] = -1.0
        ck.save_cg_state(path, ck.CGState(
            portfolio=agent_ref.committees, fixed=fixed, covered=agent_ref.covered,
            key=np.array([0, 123], dtype=np.uint32),
            fingerprint=ck.problem_fingerprint(adense, agent_cfg),
        ))
        alog = RunLog(echo=False)
        t0 = time.perf_counter()
        resumed = find_distribution_leximin(adense, aspace, cfg=agent_cfg, log=alog,
                                            device="cuda", checkpoint_path=path)
        agent = dict(
            seconds=time.perf_counter() - t0, contract_ok=bool(resumed.contract_ok),
            resumed_line=next((ln for ln in alog.lines if "Resumed checkpoint" in ln), None),
            alloc_gap_to_uninterrupted=float(np.abs(resumed.allocation - agent_ref.allocation).max()),
            tolerance=RESUME_TOL, file_left=os.path.exists(path),
            dual_solves=int(alog.counters.get("agent_space_dual_solves", 0)),
            faults=fault_counts(alog.counters),
        )
    rec = dict(phase="checkpoint_leximin", flagship=flagship, agent_space_resume=agent)
    rec["ok"] = bool(
        flagship["contract_ok"] and flagship["bit_identical"] and not flagship["file_left"]
        and len(saves) == 1 and clean(log.counters)
        and agent["contract_ok"] and agent["resumed_line"] is not None and not agent["file_left"]
        and agent["alloc_gap_to_uninterrupted"] <= RESUME_TOL and clean(alog.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec


def faults_flagship_phase(inst, cfg, reference):
    """Seeded faults through ``Config.fault_sites`` at the flagship's
    defaults, each a full run that must still meet the contract:
    ``pdhg_nan`` on the first master (``PDHG_NAN_FIRST``), which the CUDA
    sentinel quarantines and the round re-solves on the host
    (``robust_host_resolve``); ``device_dispatch`` at the first pricing
    dispatch, which walks the device-pricing rung (the anchors go through
    the host MILP from then on); ``qp_nan`` on XMIN (from ``reference``),
    whose fused stage is quarantined and the serial route realizes the
    targets (``realization_dev`` within the contract)."""
    from citizensassemblies_tpu_torch.core.instance import featurize

    out = {}
    for name, (spec, seed) in (("pdhg_nan", PDHG_NAN_FIRST), ("device_dispatch", ("device_dispatch:1.0", 0))):
        dist, log, secs, linf = leximin_run(inst, "cuda", cfg.replace(fault_sites=spec, fault_seed=seed))
        c = log.counters
        out[name] = dict(
            spec=spec, seed=seed, seconds=secs, contract_ok=bool(dist.contract_ok), linf=linf,
            counters={k: int(c.get(k, 0)) for k in (
                f"fault_{name}", "robust_degrade_device_pricing", "decomp_oracle_device_hit",
                "decomp_oracle_device_miss", "decomp_rounds", *FAULT_KEYS)},
        )
    dense, space = featurize(inst, device="cuda")
    dist, xlog, secs = xmin_run(dense, space, cfg.replace(fault_sites="qp_nan:1.0"), reference)
    c = xlog.counters
    out["qp_nan"] = dict(
        spec="qp_nan:1.0", seconds=secs, contract_ok=bool(dist.contract_ok),
        realization_dev=float(dist.realization_dev),
        counters={k: int(c.get(k, 0)) for k in (
            "fault_qp_nan", "lp_batch_l2_fused", *FAULT_KEYS)},
        timers={k: xlog.timers[k] for k in ("l2_fused", "l2_dual_ascent", "xmin_l2")
                if k in xlog.timers},
    )
    p, d, q = (out[k]["counters"] for k in ("pdhg_nan", "device_dispatch", "qp_nan"))
    rec = dict(phase="faults_flagship", **out)
    rec["ok"] = bool(
        all(out[k]["contract_ok"] for k in out)
        and p["fault_pdhg_nan"] == 1 and p["sentinel_quarantined"] >= 1 and p["robust_host_resolve"] >= 1
        and d["fault_device_dispatch"] == 1 and d["robust_degrade_device_pricing"] == 1
        and d["decomp_oracle_device_hit"] == 0 and not any(d[k] for k in FAULT_KEYS)
        and q["fault_qp_nan"] == 1 and q["lp_batch_l2_fused"] == 1 and q["sentinel_quarantined"] == 1
        and out["qp_nan"]["realization_dev"] <= E2E_CONTRACT
    )
    print(json.dumps(rec), flush=True)
    return rec


#: the statistics.txt lines of the JAX package's layout
#: (tests/test_analysis.py:126-139), the timing line aside
ANALYSIS_NEEDLES = (
    "instance:\tsf_e_skewed", "pool size n:\t1727", "panel size k:\t110",
    "# quota categories:\t7", "LEGACY minimum probability:",
    "LEXIMIN minimum probability (exact):", "XMIN minimum probability (exact):",
    "LEGACY number of unique panels seen:", "gini coefficient of XMIN:",
    "geometric mean of LEGACY:", "share selected by LEGACY with probability below LEXIMIN",
)
TIMING_LINE = "Out of 3 runs, LEXIMIN took a median running time of"
#: the upstream CSV headers (reference_output/example_small_20_*.csv:1)
CSV_HEADERS = {
    "prob_allocs_data.csv": ["algorithm", "percentile of pool members", "selection probability"],
    "ratio_product_data.csv": ["ratio product", "selection probability"],
}
FIGURES = ("prob_allocs.pdf", "pair_probability_graph.pdf", "number_of_unique_panels.pdf",
           "ratio_product.pdf", "intersections.pdf")
#: LEXIMIN's least probability on the ``--generate`` example_small_20 pool
#: (``example_small_like_instance()``, a stand-in for the withheld real one),
#: as both packages compute it on the CPU
EXAMPLE_SMALL_LEXIMIN_MIN = 0.08939309517559738
#: the card's example_small run against the CPU's: LEXIMIN within 1e-6;
#: XMIN draws its new panels from the run device's generator (CUDA's Philox
#: stream is not the CPU's), and each run holds its allocation within
#: ``xmin_linf_band`` (8e-4) of the same leximin values, so 2 × 8e-4; LEGACY's
#: draws differ for the same reason: each agent within 5 standard deviations
#: of the difference of two 10,000-draw estimates
EXAMPLE_SMALL_TOL = 1e-6
EXAMPLE_SMALL_XMIN_TOL = 2 * 8e-4


def analysis_data(root, inst):
    """``inst`` as ``<root>/sf_e_skewed_110/`` in the two-CSV schema, with an
    ``intersections.csv`` in the reference schema beside it: every pair of
    the pool's cells from two categories, each with its share of the pool,
    to four places, stated as the population share."""
    import csv

    from citizensassemblies_tpu_torch.core.generator import write_instance_csvs
    from citizensassemblies_tpu_torch.core.instance import featurize

    d = root / "sf_e_skewed_110"
    write_instance_csvs(inst, d)
    dense, space = featurize(inst, device="cpu")
    A = dense.A_np
    with open(d / "intersections.csv", "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(["category 1", "feature 1", "category 2", "feature 2", "population share"])
        for i, (c1, f1) in enumerate(space.cells):
            for j in range(i + 1, len(space.cells)):
                c2, f2 = space.cells[j]
                if c1 != c2:
                    w.writerow([c1, f1, c2, f2, f"{float((A[:, i] & A[:, j]).mean()):.4f}"])
    return d


def figures_context():
    """``(context, status)``: with matplotlib installed the figure writers
    draw as they are; without it the context stands a stub in for their
    pyplot, so the writers still write their CSVs and draw nothing."""
    import contextlib
    import importlib.util
    from unittest import mock

    from citizensassemblies_tpu_torch.analysis import plots

    if importlib.util.find_spec("matplotlib") is not None:
        return contextlib.nullcontext(), "rendered"
    plt = mock.MagicMock()
    plt.subplots.return_value = (mock.MagicMock(), mock.MagicMock())
    return mock.patch.object(plots, "_pyplot", return_value=plt), "not rendered: matplotlib absent"


def analysis_main(argv, libs, cached=False):
    """``python -m citizensassemblies_tpu_torch <argv>`` in this process,
    every launch counter zeroed just before and read just after; each
    cached pass (``run_*_or_retrieve``) and each figure writer timed, the
    clock stopped after ``torch.cuda.synchronize()`` (where this process
    has started CUDA). ``cached``: the
    passes' solvers raise, so every pass must come from the cache. Returns
    ``(rc, AnalysisResult, launches, seconds, pass_seconds, plot_seconds,
    figures)``."""
    import contextlib
    from unittest import mock

    import torch

    from citizensassemblies_tpu_torch.analysis import cache, cli, plots, report

    captured, passes, plot_s = {}, [], []
    analyze = report.analyze_instance
    # a worker process that runs the CLI on the CPU starts no CUDA context
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)

    def capture(*a, **kw):
        captured["result"] = analyze(*a, **kw)
        return captured["result"]

    def timed(fn, store, label=None):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            secs = time.perf_counter() - t
            store.append([label, secs] if label else secs)
            return out
        return run

    figures_ctx, figures = figures_context()
    with contextlib.ExitStack() as stack:
        stack.enter_context(figures_ctx)
        stack.enter_context(mock.patch.object(report, "analyze_instance", capture))
        for name in ("run_legacy_or_retrieve", "run_leximin_or_retrieve", "run_xmin_or_retrieve"):
            stack.enter_context(mock.patch.object(
                report, name, timed(getattr(report, name), passes, name[4:-12])))
        for name in ("plot_number_of_panels", "plot_pair_probability",
                     "plot_probability_allocations", "plot_ratio_products",
                     "plot_intersectional_representation"):
            stack.enter_context(mock.patch.object(plots, name, timed(getattr(plots, name), plot_s)))
        if cached:
            for name in ("legacy_probabilities", "find_distribution_leximin",
                         "find_distribution_xmin"):
                stack.enter_context(mock.patch.object(
                    cache, name, side_effect=AssertionError(f"{name} ran: cache missed")))
        for lib in libs:
            lib.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        sync()
        secs = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    launches["ell_gather_bf16"] = bf16_gathers()
    return rc, captured.get("result"), launches, secs, passes, float(sum(plot_s)), figures


def analysis_outputs(out, stem):
    """The statistics text, CSV headers and figures present in ``out``."""
    import csv

    text = (out / f"{stem}_statistics.txt").read_text(encoding="utf-8")
    headers = {}
    for name in CSV_HEADERS:
        with open(out / f"{stem}_{name}", encoding="utf-8") as fh:
            headers[name] = next(csv.reader(fh))
    return text, headers, [f for f in FIGURES if (out / f"{stem}_{f}").exists()]


def analysis_flagship_phase(root, libs, leximin, xmin):
    """The analysis CLI on the flagship pool through the two-CSV round trip
    (``analysis_data``), at the defaults, with the timing harness: LEGACY
    twice (10,000 draws), LEXIMIN, XMIN (its own LEXIMIN seed), the
    statistics, figures and CSVs, three timed LEXIMIN runs. Held: the
    LEXIMIN allocation bit for bit the defaults flagship's (``leximin``), the
    XMIN allocation that of ``xmin_sf_e_skewed`` (``xmin``; bit for bit
    expected, else within 1e-3), both contract lines "satisfied", every line
    of the JAX package's layout (``ANALYSIS_NEEDLES``, the seven ``MSE``
    lines, the timing line), the CSV headers, every figure where matplotlib
    is installed, and launches of the two-sided kernel and the gather.
    Returns ``(rec, statistics text, argv)``."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.ops.intersections import DIFF_PAIRS

    data = analysis_data(root / "data", sf_e_skewed_instance(seed=1))
    out = root / "analysis"
    argv = ["sf_e_skewed", "110", "--data-dir", str(data.parent), "--out-dir", str(out),
            "--cache-dir", str(root / "distributions")]
    rc, res, launches, secs, passes, plot_s, figures = analysis_main(argv, libs)
    text, headers, drawn = analysis_outputs(out, "sf_e_skewed_110")
    lex, xm = res.runs["leximin"].allocation, res.runs["xmin"].allocation
    xmin_gap = float(np.abs(xm - xmin.allocation).max())
    contract = [ln for ln in text.splitlines() if "realization contract" in ln]
    mse_lines = [f"MSE({a}, {b})\t" for a, b in DIFF_PAIRS]
    missing = [x for x in (*ANALYSIS_NEEDLES, *mse_lines, TIMING_LINE) if x not in text]
    rec = dict(
        phase="analysis_flagship", seconds=secs, passes=passes, plot_seconds=plot_s,
        timing_median_s=res.timing_median_s, launches=launches, figures=figures,
        figures_drawn=drawn, stats=res.stats, minimizer_ucb=res.minimizer_ucb,
        share_below_leximin_min=res.share_below_leximin_min,
        intersection_rows=sum(1 for _ in open(data / "intersections.csv")) - 1,
        mses={f"{a} | {b}": v for (a, b), v in res.intersection_mses.items()},
        unique_panels={t: len(r.unique_panels) for t, r in res.runs.items()},
        leximin_bit_identical=bool(np.array_equal(lex, leximin.allocation)),
        xmin_bit_identical=bool(np.array_equal(xm, xmin.allocation)), xmin_gap=xmin_gap,
        contract_lines=contract, missing_lines=missing, csv_headers=headers,
        cache_mb={p.name: p.stat().st_size / 2**20 for p in sorted((root / "distributions").iterdir())},
    )
    rec["ok"] = bool(
        rc == 0 and rec["leximin_bit_identical"] and xmin_gap <= E2E_CONTRACT
        and len(contract) == 2 and all("\tsatisfied (" in ln for ln in contract)
        and not missing and headers == CSV_HEADERS
        and (figures != "rendered" or len(drawn) == len(FIGURES))
        and launches["two_sided_block"] > 0 and launches["ell_gather"] > 0
        and all(np.isfinite(v) for st in res.stats.values() for v in st.values())
    )
    print(json.dumps(rec), flush=True)
    return rec, text, argv


def analysis_cached_phase(libs, argv, first_text):
    """The same CLI call again with ``--skiptiming``: every pass must load
    from the cache (the solvers raise if called) with no kernel launch, and
    ``statistics.txt`` must equal the first run's save for its last line,
    the timing line, which reads "Skip timing." here."""
    from pathlib import Path

    rc, res, launches, secs, passes, plot_s, figures = analysis_main(
        argv + ["--skiptiming"], libs, cached=True)
    out = Path(argv[argv.index("--out-dir") + 1])
    text = (out / "sf_e_skewed_110_statistics.txt").read_text(encoding="utf-8")
    first, again = first_text.splitlines(), text.splitlines()
    rec = dict(
        phase="analysis_cached", seconds=secs, passes=passes, plot_seconds=plot_s,
        launches=launches, figures=figures, last_line=again[-1],
        same_statistics=first[:-1] == again[:-1],
    )
    rec["ok"] = bool(
        rc == 0 and res is not None and not any(launches.values())
        and rec["same_statistics"] and again[-1] == "Skip timing."
        and first[-1].startswith(TIMING_LINE)
    )
    print(json.dumps(rec), flush=True)
    return rec


def _analysis_argv(root, dev):
    """The CLI's arguments for ``example_small_20 20`` under ``root`` on
    ``dev`` (``--skiptiming`` on the CPU: its LEXIMIN times are not what is
    compared)."""
    data = root / "data"
    return ["example_small", "20", "--data-dir", str(data), "--out-dir", str(root / dev),
            "--cache-dir", str(root / f"{dev}_distributions"), "--device", dev] + (
        ["--skiptiming"] if dev == "cpu" else [])


def _analysis_cpu(argv, conn):
    """The analysis CLI on the CPU in a worker process, its printout on
    stderr (stdout carries this script's records): sends
    ``analysis_main``'s ``(rc, result, launches, seconds, passes,
    figures)``."""
    import contextlib

    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)
    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk

    with contextlib.redirect_stdout(sys.stderr):
        rc, res, launches, secs, passes, _plot_s, figures = analysis_main(
            argv, [em.KERNEL, mk.KERNEL, mk.LP_KERNEL])
    conn.send((rc, res, launches, secs, passes, figures))


def start_analysis_example_small(root, libs):
    """``--generate`` into ``root``, then the CLI's CPU run of
    ``example_small_20 20`` started in a worker process, so it runs while
    the card runs the flagship's analysis. Returns ``(generate_rc,
    worker)`` for :func:`analysis_example_small_phase`."""
    rc = analysis_main(["--generate", "--data-dir", str(root / "data")], libs)[0]
    return rc, start_cpu_worker(_analysis_cpu, _analysis_argv(root, "cpu"))


def analysis_example_small_phase(root, libs, started):
    """``--generate``, then ``example_small_20 20`` through the CLI on the
    card with the timing harness, and the same CLI with ``--device cpu``
    (``--skiptiming``: the CPU's LEXIMIN times are not what is compared;
    ``started``: :func:`start_analysis_example_small`'s).
    Held: LEXIMIN's allocation and statistics within ``EXAMPLE_SMALL_TOL`` of
    the CPU's and its least probability of ``EXAMPLE_SMALL_LEXIMIN_MIN``;
    XMIN's within ``EXAMPLE_SMALL_XMIN_TOL``; LEGACY's allocation agent by
    agent within 5 standard deviations of the difference of two estimates;
    both contracts; the kernels launched on the card's run."""
    gen_rc, cpu_run = started
    rcs = [gen_rc]
    runs = {}
    rc, res, launches, secs, passes, _plot_s, _figures = analysis_main(
        _analysis_argv(root, "cuda"), libs)
    rcs.append(rc)
    runs["cuda"] = dict(res=res, launches=launches, seconds=secs, passes=passes)
    rc, res, launches, secs, passes, figures = cpu_worker_result(cpu_run)
    rcs.append(rc)
    runs["cpu"] = dict(res=res, launches=launches, seconds=secs, passes=passes)
    g, c = runs["cuda"]["res"], runs["cpu"]["res"]
    draws = g.runs["legacy"].num_draws

    def gap(tag):
        return float(np.abs(g.runs[tag].allocation - c.runs[tag].allocation).max())

    def stat_gap(tag):
        return max(abs(g.stats[tag][f] - c.stats[tag][f]) for f in g.stats[tag])

    pbar = (g.runs["legacy"].allocation + c.runs["legacy"].allocation) / 2
    legacy_z = float(np.max(
        np.abs(g.runs["legacy"].allocation - c.runs["legacy"].allocation)
        / np.sqrt(np.maximum(2 * pbar * (1 - pbar) / draws, 1e-12))))
    rec = dict(
        phase="analysis_example_small", card_seconds=runs["cuda"]["seconds"],
        cpu_seconds=runs["cpu"]["seconds"], card_passes=runs["cuda"]["passes"],
        cpu_passes=runs["cpu"]["passes"], timing_median_s=g.timing_median_s,
        launches=runs["cuda"]["launches"], cpu_launches=runs["cpu"]["launches"],
        figures=figures, leximin_min=g.stats["leximin"]["min"],
        leximin_min_cpu=c.stats["leximin"]["min"], leximin_gap=gap("leximin"),
        leximin_stat_gap=stat_gap("leximin"), xmin_gap=gap("xmin"),
        xmin_stat_gap=stat_gap("xmin"), legacy_max_z=legacy_z,
        contract_ok={d: [r.runs[t].contract_ok for t in ("leximin", "xmin")]
                     for d, r in (("cuda", g), ("cpu", c))},
    )
    rec["ok"] = bool(
        rcs == [0, 0, 0] and rec["leximin_gap"] <= EXAMPLE_SMALL_TOL
        and rec["leximin_stat_gap"] <= EXAMPLE_SMALL_TOL
        and abs(rec["leximin_min"] - EXAMPLE_SMALL_LEXIMIN_MIN) <= EXAMPLE_SMALL_TOL
        and rec["xmin_gap"] <= EXAMPLE_SMALL_XMIN_TOL
        and rec["xmin_stat_gap"] <= EXAMPLE_SMALL_XMIN_TOL and legacy_z <= 5.0
        and all(all(v) for v in rec["contract_ok"].values())
        and not any(rec["cpu_launches"].values())
    )
    print(json.dumps(rec), flush=True)
    return rec


def analysis_phases(libs, leximin, xmin):
    """Every analysis phase, in order, in one temporary directory; returns
    their records by name."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        started = start_analysis_example_small(root / "example_small", libs)
        flagship, text, argv = analysis_flagship_phase(root / "flagship", libs, leximin, xmin)
        cached = analysis_cached_phase(libs, argv, text)
        small = analysis_example_small_phase(root / "example_small", libs, started)
    return dict(flagship=flagship, cached=cached, example_small=small)


# --- distribution (ROADMAP queue A item 7) -----------------------------------------
#: the dropout realization's draws on the card, per policy, and its
#: card-against-CPU draws
DROPOUT_DRAWS = 65_536
DROPOUT_CPU_DRAWS = 4_096
#: the sharded dual LP's bars against HiGHS and the undistributed LP kernel
SHARDED_DUAL_TOL = 1e-4
#: the sharded master's bars: its arithmetic ε, Σp, and its ε against the
#: two-sided kernel's solve of the same LP
SHARDED_MASTER_EPS = 5e-4
SHARDED_MASTER_SUM = 1e-6
SHARDED_MASTER_VS_KERNEL = 1e-3
#: how far below the kernel's realized ε the optimum that the sharded
#: master's duals certify may read, and how far that certificate may
#: differ from the one of the kernel's duals
SHARDED_MASTER_DUAL = 1e-4
#: the sharded master's aiming duals against the kernel's, relative in L1
#: (a reversed or negated ``w`` reads near 2)
SHARDED_MASTER_W_REL = 0.1
#: blocks of the sharded dual LP's graph-replay-against-eager hold
GRAPH_HOLD_BLOCKS = 4
SWEEP_SEEDS = (1, 2, 3, 4)
SWEEP_CHAINS = 2048


def _highs_dual(P, fixed, conn):
    """HiGHS (interior point, then crossover) on the dual leximin LP of
    ``P`` (a sparse 0/1 panel matrix) and ``fixed``, sent down ``conn`` as
    ``(seconds, status, objective, ŷ)``. (The simplex takes minutes on the
    flagship-shaped LP.) Pinned to one CPU core, so the card's phases keep
    the others."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

    t0 = time.perf_counter()
    C, n = P.shape
    unfixed = fixed < 0
    res = linprog(
        np.concatenate([-np.where(unfixed, 0.0, fixed), [1.0]]),
        A_ub=sp.hstack([P.astype(np.float64), -np.ones((C, 1))], format="csr"),
        b_ub=np.zeros(C), A_eq=np.concatenate([unfixed.astype(np.float64), [0.0]])[None, :],
        b_eq=np.array([1.0]), bounds=(0, None), method="highs-ipm",
    )
    x = res.x if res.x is not None else np.zeros(n + 1)
    conn.send((time.perf_counter() - t0, int(res.status), float(res.fun), float(x[n])))
    conn.close()


def start_highs_reference(problem=None):
    """A HiGHS reference of a dual LP phase, started in a daemon worker
    process well before the phase reads it (the flagship dual's takes
    minutes on a CPU core; a run that stops early terminates it on exit):
    ``problem`` ``(P, fixed)``, by default :func:`dual_lp_problem`'s, the
    sharded dual phase's. Returns ``(process, connection, P, fixed)``."""
    import multiprocessing

    import scipy.sparse as sp

    P, fixed = dual_lp_problem() if problem is None else problem
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_highs_dual, args=(sp.csr_matrix(P.astype(bool)), fixed, send),
                       daemon=True)
    proc.start()
    send.close()
    return proc, recv, P, fixed


#: torch threads of a worker process that computes a CPU reference while
#: this process drives the card (this process and the HiGHS worker keep the
#: other cores)
CPU_WORKER_THREADS = 2


def start_cpu_worker(fn, *args):
    """``fn(*args, conn)`` in a spawned daemon worker process, which sends
    its result down ``conn``: a CPU reference computed while this process
    drives the card (a run that stops early terminates it on exit).
    Returns ``(process, connection)`` for :func:`cpu_worker_result`."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=fn, args=args + (send,), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def cpu_worker_result(worker):
    """What a :func:`start_cpu_worker` worker sent; raises ``EOFError``
    where the worker ended without sending."""
    proc, recv = worker
    out = recv.recv()
    proc.join()
    return out


def dist_world1_phase():
    """A real one-rank NCCL world on the card through ``make_mesh(1)``: one
    ``all_reduce`` checked, the topology, the ``dist_mesh_*`` gauges,
    ``effective_mesh`` is None on one device; the world torn down at the
    end."""
    import torch
    import torch.distributed as dist

    from citizensassemblies_tpu_torch.dist import runtime
    from citizensassemblies_tpu_torch.parallel.mesh import make_mesh
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    t0 = time.perf_counter()
    mesh = make_mesh(1)
    backend = dist.get_backend()
    x = torch.arange(4, dtype=torch.float32, device="cuda") + 1.0
    dist.all_reduce(x)
    reduced = x.cpu().tolist()
    topo = runtime.default_topology()
    log = RunLog(echo=False)
    runtime.stamp_mesh_gauges(log, mesh)
    gauges = {k: log.counters[k] for k in ("dist_mesh_hosts", "dist_mesh_devices",
                                           "dist_process_index")}
    effective_none = runtime.effective_mesh(default_config(), log=log) is None
    runtime.shutdown()
    rec = dict(
        phase="dist_world1", seconds=time.perf_counter() - t0, backend=backend,
        mesh_device=mesh.device_type, topology=topo.shape, hosts=topo.hosts,
        all_reduce=reduced, gauges=gauges, effective_mesh_none=effective_none,
        torn_down=not dist.is_initialized(),
    )
    rec["ok"] = bool(
        backend == "nccl" and reduced == [1.0, 2.0, 3.0, 4.0]
        and topo.shape == {"chains": 1, "agents": 1} and topo.hosts == 1
        and gauges == {"dist_mesh_hosts": 1, "dist_mesh_devices": 1, "dist_process_index": 0}
        and effective_none and rec["torn_down"]
    )
    print(json.dumps(rec), flush=True)
    return rec


def mc_flagship_phase(mesh):
    """The chain-parallel sampler on the flagship pool over the one-rank
    mesh: 10,000 chains bit for bit ``sample_panels_batch`` on the same
    seed, and a 2,048-chain Monte-Carlo round whose counts and pair matrix
    equal a recount of its panels."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.legacy import sample_panels_batch
    from citizensassemblies_tpu_torch.parallel import mc

    dense, _ = featurize(sf_e_skewed_instance(seed=1), device="cuda")

    def gen():
        return torch.Generator(device="cuda").manual_seed(5)

    def timed_draw(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (pw, okw), plain_s = timed_draw(lambda: sample_panels_batch(dense, gen(), 10_000,
                                                                distribute=False))
    (pd, okd), dist_s = timed_draw(lambda: mc.distributed_sample_panels(dense, gen(), 10_000, mesh))
    _, plain_s2 = timed_draw(lambda: sample_panels_batch(dense, gen(), 10_000, distribute=False))
    _, dist_s2 = timed_draw(lambda: mc.distributed_sample_panels(dense, gen(), 10_000, mesh))
    same = bool(torch.equal(pw, pd) and torch.equal(okw, okd))
    (p, ok, counts, pair), round_s = timed_draw(lambda: mc.distributed_mc_round(dense, gen(), mesh,
                                                                               2048))
    p, ok = p.cpu().numpy(), ok.cpu().numpy()
    S = np.zeros((len(p), dense.n), np.float32)
    for b in np.nonzero(ok)[0]:
        S[b, p[b]] = 1.0
    brute = S.T.astype(np.float64) @ S
    np.fill_diagonal(brute, 0.0)
    counts_exact = bool(np.array_equal(counts.cpu().numpy(), S.sum(axis=0)))
    pair_exact = bool(np.array_equal(pair.cpu().numpy().astype(np.float64), brute))
    rec = dict(
        phase="mc_flagship", n=dense.n, k=dense.k, chains=10_000, bitwise=same,
        accepted=int(okd.sum()), seconds=dist_s, panels_per_s=10_000 / dist_s,
        repeat_seconds=dist_s2, undistributed_seconds=plain_s,
        undistributed_repeat_seconds=plain_s2, round_chains=2048, round_accepted=int(ok.sum()),
        round_seconds=round_s, round_panels_per_s=2048 / round_s,
        counts_exact=counts_exact, pair_exact=pair_exact,
    )
    rec["ok"] = bool(same and okd.any() and counts_exact and pair_exact)
    print(json.dumps(rec), flush=True)
    return rec


def dropout_fixture():
    """The dropout fixture of the CPU tests (``tests/torch_worlds.py``): the
    48-agent parity pool, 600 of its LEGACY panels drawn on the host with
    Dirichlet weights, attendance 1 − U(0, 0.5) (``numpy`` seed 1) and the
    base types (agents with equal feature rows)."""
    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels

    inst = random_instance(n=48, k=6, n_categories=2, features_per_category=2, seed=0)
    host, _ = featurize(inst, device="cpu")
    panels, _ = sample_feasible_panels(host, 600, seed=2, distribute=False)
    P = np.zeros((len(panels), host.n), dtype=bool)
    P[np.arange(len(panels))[:, None], panels] = True
    _, type_id = np.unique(host.A_np, axis=0, return_inverse=True)
    return dict(
        instance=inst, P=P, probs=np.random.default_rng(0).dirichlet(np.ones(len(P))),
        attendance=1.0 - np.random.default_rng(1).uniform(0.0, 0.5, host.n),
        type_id=type_id.reshape(-1).astype(np.int64),
    )


def dropout_mc_phase(mesh, leximin):
    """The dropout realization on the defaults flagship LEXIMIN portfolio
    with attendance 1 − U(0, 0.5) (``numpy`` seed 0) and the T=814 type
    ids: 65,536 draws per policy with ``mesh=None`` and over the one-rank
    mesh, bit for bit; the card against the CPU at 4,096 draws, per-agent
    frequencies, ``quota_ok_rate`` and ``fill_rate`` within 5 binomial
    standard deviations; and the ``type`` policy on the CPU tests' fixture
    (:func:`dropout_fixture`), where it must fill every seat and keep every
    quota."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.parallel import mc
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    dense, _ = featurize(sf_e_skewed_instance(seed=1), device="cuda")
    host, _ = featurize(sf_e_skewed_instance(seed=1), device="cpu")
    type_id = TypeReduction(host).type_id
    att = 1.0 - np.random.default_rng(0).uniform(0.0, 0.5, size=dense.n)
    P, probs = leximin.committees, leximin.probabilities

    def within(a, b, N):
        p = np.clip((np.asarray(a) + np.asarray(b)) / 2, 1.0 / N, 1 - 1.0 / N)
        return bool(np.all(np.abs(np.asarray(a) - np.asarray(b)) <= 5 * np.sqrt(2 * p * (1 - p) / N)))

    policies = {}
    for policy in mc.DROPOUT_POLICIES:
        def run(m, d=dense, draws=DROPOUT_DRAWS, dev="cuda", policy=policy):
            g = torch.Generator(device=dev).manual_seed(11)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = mc.dropout_realization_round(P, probs, att, type_id, d, g, draws, policy, mesh=m)
            return r, time.perf_counter() - t0

        plain, plain_s = run(None)
        meshed, mesh_s = run(mesh)
        cpu, cpu_s = run(None, host, DROPOUT_CPU_DRAWS, "cpu")
        card, _ = run(None, dense, DROPOUT_CPU_DRAWS)
        bitwise = bool(
            np.array_equal(plain.counts, meshed.counts)
            and np.array_equal(plain.counts_valid, meshed.counts_valid)
            and plain.quota_ok_rate == meshed.quota_ok_rate and plain.fill_rate == meshed.fill_rate
        )
        N = DROPOUT_CPU_DRAWS
        agree = (
            within(card.frequencies, cpu.frequencies, N)
            and within(card.frequencies_valid, cpu.frequencies_valid, N)
            and within([card.quota_ok_rate], [cpu.quota_ok_rate], N)
            and within([card.fill_rate], [cpu.fill_rate], N * dense.k)
        )
        policies[policy] = dict(
            seconds=mesh_s, draws_per_s=DROPOUT_DRAWS / mesh_s, undistributed_seconds=plain_s,
            cpu_seconds_4096=cpu_s, bitwise_mesh_vs_none=bitwise, card_vs_cpu_5sigma=agree,
            quota_ok_rate=meshed.quota_ok_rate, fill_rate=meshed.fill_rate,
            cpu_quota_ok_rate=cpu.quota_ok_rate, cpu_fill_rate=cpu.fill_rate,
        )
    # the CPU tests' fixture, whose every type has several agents: there a
    # same-type refill fills every seat and keeps every quota
    fx = dropout_fixture()
    fx_dense, _ = featurize(fx["instance"], device="cuda")
    fx_runs = [
        mc.dropout_realization_round(fx["P"], fx["probs"], fx["attendance"], fx["type_id"],
                                     fx_dense, torch.Generator(device="cuda").manual_seed(4),
                                     DROPOUT_DRAWS, "type", mesh=m)
        for m in (None, mesh)
    ]
    fixture = dict(
        n=fx_dense.n, panels=int(len(fx["P"])), quota_ok_rate=fx_runs[1].quota_ok_rate,
        fill_rate=fx_runs[1].fill_rate,
        bitwise_mesh_vs_none=bool(np.array_equal(fx_runs[0].counts, fx_runs[1].counts)),
    )
    rec = dict(phase="dropout_mc_flagship", panels=int(len(P)), n=dense.n, T=int(type_id.max()) + 1,
               draws=DROPOUT_DRAWS, policies=policies, fixture_type=fixture)
    rec["ok"] = bool(all(r["bitwise_mesh_vs_none"] and r["card_vs_cpu_5sigma"]
                         for r in policies.values())
                     and fixture["quota_ok_rate"] == fixture["fill_rate"] == 1.0
                     and fixture["bitwise_mesh_vs_none"])
    print(json.dumps(rec), flush=True)
    return rec


def sharded_dual_phase(mesh, highs_ref, libs):
    """The row-sharded dual LP at the flagship dual LP's shape (4,096 panels
    of the flagship pool, :func:`dual_lp_problem`) over the one-rank mesh,
    on the ELL route (its local product the gather kernel) and forced
    dense: against HiGHS (``ok``, objective and ŷ within
    ``SHARDED_DUAL_TOL``) and against the undistributed
    ``solve_dual_lp_pdhg`` on the LP kernel (objective within the same)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.parallel.solver import solve_dual_lp_pdhg_sharded
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_dual_lp_pdhg
    from citizensassemblies_tpu_torch.utils.config import default_config

    proc, recv, P, fixed = highs_ref
    routes = {}
    launches = {}
    for route, knob in (("ell", None), ("dense", False)):
        st = {}
        for lib in libs:
            lib.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_dual_lp_pdhg_sharded(P, fixed, mesh, cfg=default_config().replace(
            sparse_ops=knob), stats=st)
        secs = time.perf_counter() - t0
        launches[route] = {"ell_gather": em.KERNEL.launches, "lp_block": mk.LP_KERNEL.launches}
        routes[route] = dict(route=st["route"], graph=st["graph"], ok=sol.ok, seconds=secs,
                             blocks=st["blocks"],
                             iterations=st["iters"], kkt=st["res"], objective=sol.objective,
                             yhat=sol.yhat, gather_launches=launches[route]["ell_gather"],
                             _y=sol.y)
    # a fixed four blocks with every block eager and with blocks 2-4
    # replayed as CUDA graphs (collectives included): the same kernels in
    # the same order, and no product sums by atomics (the ELL route's
    # transpose is a row-ordered CSR sum), so both routes' iterates bit for
    # bit
    for route, knob in (("ell", None), ("dense", False)):
        hold = {}
        for graph in (False, True):
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solve_dual_lp_pdhg_sharded(P, fixed, mesh, cfg=default_config().replace(
                sparse_ops=knob), tol=0.0, max_blocks=GRAPH_HOLD_BLOCKS, stats=st, graph=graph)
            hold[graph] = (sol.y, sol.yhat, (time.perf_counter() - t0) / st["iters"] * 1e6)
        gap = max(float(np.abs(hold[True][0] - hold[False][0]).max()),
                  abs(hold[True][1] - hold[False][1]))
        routes[route].update(eager_us_per_iter=hold[False][2], graph_us_per_iter=hold[True][2],
                             graph_vs_eager=gap)
    for lib in libs:
        lib.reset_counts()
    t0 = time.perf_counter()
    ref, _warm = solve_dual_lp_pdhg(P, fixed, cfg=default_config(), device="cuda")
    kernel_s = time.perf_counter() - t0
    kernel_launches = mk.LP_KERNEL.launches
    highs_s, status, h_obj, h_yhat = recv.recv()
    proc.join()
    for r in routes.values():
        r.pop("_y")
        r["highs_obj_err"] = abs(r["objective"] - h_obj)
        r["highs_yhat_err"] = abs(r["yhat"] - h_yhat)
        r["kernel_obj_err"] = abs(r["objective"] - ref.objective)
    rec = dict(
        phase="sharded_dual_flagship", rows=int(P.shape[0]), n=int(P.shape[1]), routes=routes,
        highs_seconds=highs_s, highs_status=status, highs_objective=h_obj,
        lp_kernel_seconds=kernel_s, lp_kernel_ok=ref.ok, lp_kernel_objective=ref.objective,
        lp_kernel_launches=kernel_launches, launches=launches["ell"],
    )
    rec["ok"] = bool(
        status == 0 and kernel_launches >= 1
        and all(r["ok"] and r["highs_obj_err"] <= SHARDED_DUAL_TOL
                and r["highs_yhat_err"] <= SHARDED_DUAL_TOL
                and r["kernel_obj_err"] <= SHARDED_DUAL_TOL for r in routes.values())
        and routes["ell"]["route"] == "ell" and routes["ell"]["gather_launches"] > 0
        and routes["dense"]["gather_launches"] == 0
        and routes["dense"]["graph_vs_eager"] == 0.0 and routes["ell"]["graph_vs_eager"] == 0.0
    )
    print(json.dumps(rec), flush=True)
    return rec


def dual_lp_checks(P, fixed, y, yhat):
    """How far ``(y, ŷ)`` lies outside the dual leximin LP's feasible set
    over the bool panel matrix ``P``: the worst panel row over ŷ, the
    unfixed agents' sum off 1, the most negative ``y``."""
    import scipy.sparse as sp

    rows = sp.csr_matrix(P, dtype=np.float64) @ y
    return dict(row_excess=float(max(rows.max() - yhat, 0.0)),
                sum_error=float(abs(y[fixed < 0].sum() - 1.0)),
                negative=float(max(0.0, -y.min(), -yhat)))


def dual_lp_kkt(P, fixed, x, lam, mu):
    """The KKT residual of the dual leximin LP (``lp_pdhg.dual_lp_operands``:
    ``G = [P, −1]`` with rows padded by ``[0, −1]``, ``h = 0``, one
    equality) at a PDHG triple ``(x, λ, μ)``, formed as the PDHG's own check
    forms it but in the LP's units: primal violation plus dual violation
    (2-norms) plus the relative gap."""
    import scipy.sparse as sp

    Ps = sp.csr_matrix(P, dtype=np.float64)
    C = Ps.shape[0]
    unfixed = fixed < 0
    c = np.append(-np.where(unfixed, 0.0, fixed), 1.0)
    a = np.append(unfixed.astype(np.float64), 0.0)
    y, yhat = x[:-1], x[-1]
    Gx = np.concatenate([Ps @ y - yhat, np.full(lam.size - C, -yhat)])
    Gt_lam = np.append(Ps.T @ lam[:C], -lam.sum())
    pri = np.sqrt(np.sum(np.maximum(Gx, 0.0) ** 2) + (a @ x - 1.0) ** 2)
    dua = np.linalg.norm(np.minimum(c + Gt_lam + a * mu[0], 0.0))
    pobj, dobj = c @ x, -mu[0]
    return float(pri + dua + abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj)))


def dual_lp_nationwide_phase(mesh, highs_ref, libs):
    """The nationwide dual LP (:func:`nationwide_dual_problem`, y of
    100,001) on the card three ways: by the row-sharded PDHG over the
    one-rank mesh (ELL route: its local product the gather), by
    ``solve_dual_lp_pdhg`` at the defaults (the LP kernel, on its global-x̄
    route: x̄'s 100,001 floats do not fit a block's shared memory) and by
    the same forced chained (``pdhg_megakernel=False``: the route the JAX
    package takes there, its products the gather). Each must converge
    (``ok``: the PDHG's own KKT residual within 4× its 1e-6 tolerance; the
    sharded solve's ``kkt`` recorded, and the others' recomputed from their
    ``(x, λ, μ)`` in the LP's units by :func:`dual_lp_kkt`), lie within
    ``SHARDED_DUAL_TOL`` of HiGHS (``highs_ref``, started in a worker
    process before the phase) in objective and ŷ and of the LP's feasible
    set (:func:`dual_lp_checks`), launch its gathers on the L2 route only
    (every kernel's launches counted from zero just before the solve), with
    no quarantine and no host re-solve. The kernel solve makes one LP
    kernel launch, on the global-x̄ route, with no fit miss, and lies within
    ``SHARDED_DUAL_TOL`` of the chained solve's objective and ŷ. Then, on
    the LP built from the same panels (:func:`nationwide_ops`) and outside
    the counted windows: the kernel's own solve at the path's tolerance,
    timed by CUDA events, and the kernel against its plain version on one
    prelude output for ``NATIONWIDE_CHECK_BLOCKS`` blocks (the same
    iterations; x, λ, μ each within ``NATIONWIDE_CHECK_REL_TOL`` of its
    largest entry, which the record gives)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import ell_matvec as em
    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.parallel.solver import solve_dual_lp_pdhg_sharded
    from citizensassemblies_tpu_torch.solvers.lp_pdhg import solve_dual_lp_pdhg
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    t_phase = time.perf_counter()
    proc, recv, P, fixed = highs_ref
    solves, ys = {}, {}
    for name in ("sharded_ell", "kernel", "chained"):
        for lib in libs:
            lib.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "sharded_ell":
            st = {}
            sol = solve_dual_lp_pdhg_sharded(P, fixed, mesh, cfg=default_config(), stats=st)
            extra = dict(route=st["route"], iterations=st["iters"], kkt=st["res"], graph=st["graph"])
            counters = {}
        else:
            rlog = RunLog(echo=False)
            cfg = default_config()
            if name == "chained":
                cfg = cfg.replace(pdhg_megakernel=False)
            sol, (x, lam, mu) = solve_dual_lp_pdhg(P, fixed, cfg=cfg, device="cuda", log=rlog)
            counters = dict(rlog.counters)
            extra = dict(megakernel_fit_miss=int(counters.get("megakernel_fit_miss", 0)),
                         megakernel_dispatches=int(counters.get("megakernel_dispatches", 0)),
                         kkt_lp_units=dual_lp_kkt(P, fixed, x, lam, mu),
                         faults=fault_counts(counters), mp=mp_counts(counters))
            ys[name] = sol.y
        torch.cuda.synchronize()
        solves[name] = dict(
            converged=sol.ok, seconds=time.perf_counter() - t0, objective=sol.objective,
            yhat=sol.yhat, feasibility=dual_lp_checks(P, fixed, sol.y, sol.yhat),
            launches=dict(_launches(libs), ell_gather_l2=l2_gathers(),
                          lp_block_global_x=global_x_lps()),
            entry_launches=dict(em.KERNEL.entry_launches, **mk.LP_KERNEL.entry_launches),
            clean=clean(counters), **extra,
        )
    k_sol, c_sol = solves["kernel"], solves["chained"]
    kernel_vs_chained = dict(objective=abs(k_sol["objective"] - c_sol["objective"]),
                             yhat=abs(k_sol["yhat"] - c_sol["yhat"]))

    # the kernel on its own, outside the counted windows
    m1, n = P.shape
    ops = nationwide_ops(np.nonzero(P)[1].reshape(m1, -1), n)
    c = ops[0]
    inputs = lp_inputs(ops)
    plan = inputs[1]
    nv, kp = len(c), ops[1].k_pad
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cores = mk.lp_coresident_blocks(nv, m1, dev, plan.tile_floats, plan.stage_x)
    path_ms, path_iters, path_kkt, _ = lp_path_solve(inputs)
    iters = NATIONWIDE_CHECK_BLOCKS * 128
    cmp = lp_compare(inputs, np.asarray(c, np.float64), 0.0, iters)
    nnz = int(inputs[0][0].shape[0])
    bound_ms, bound_by, iter_bytes_ms = lp_bound(m1, kp, nv, nnz, path_iters)
    errs = dict(x=cmp["err_x"], lam=cmp["err_lam"], mu=cmp["err_mu"])
    scales = dict(x=cmp["max_abs_x"], lam=cmp["max_abs_lam"], mu=cmp["max_abs_mu"])
    check = dict(
        shape=dict(m1=m1, k_pad=kp, nv=nv, m2=1, nnz=nnz), plan=plan_record(plan),
        blocks_per_sm=cores / sms, sms=sms,
        path_tol=LP_TOL, path_ms=path_ms, path_iters=path_iters, path_kkt=path_kkt,
        path_us_per_iter=1e3 * path_ms / path_iters if path_iters else None,
        bound_ms=bound_ms, bound_by=bound_by, iter_bytes_ms=iter_bytes_ms,
        check_iters=iters, ms=cmp["ms"], plain_ms=cmp["plain_ms"],
        check_bound_ms=lp_bound(m1, kp, nv, nnz, iters)[0],
        iters_kernel=cmp["it_k"], iters_plain=cmp["it_p"], max_abs_err=max(errs.values()),
        max_abs_err_by=errs, max_abs_by=scales,
        rel_err_by={k: errs[k] / scales[k] if scales[k] > 0 else None for k in errs},
        obj_err=cmp["err_obj"], library_ms=None,
        tolerance=dict(rel=NATIONWIDE_CHECK_REL_TOL, iters=0),
    )
    check["ok"] = bool(
        not plan.stage_x and cmp["it_k"] == cmp["it_p"] == iters
        and all(errs[k] <= NATIONWIDE_CHECK_REL_TOL * scales[k] for k in errs)
    )

    t0 = time.perf_counter()
    highs_s, status, h_obj, h_yhat = recv.recv()
    proc.join()
    highs_wait = time.perf_counter() - t0
    for r in solves.values():
        r["highs_obj_err"] = abs(r["objective"] - h_obj)
        r["highs_yhat_err"] = abs(r["yhat"] - h_yhat)
    launches = {k: sum(r["launches"][k] for r in solves.values())
                for k in ("ell_gather", "ell_gather_bf16", "ell_gather_l2", "two_sided_block",
                          "lp_block", "lp_block_global_x")}
    rec = dict(
        phase="dual_lp_nationwide", rows=int(m1), n=int(n),
        unfixed=int((fixed < 0).sum()), uncovered=int((P.sum(axis=0) == 0).sum()),
        solves=solves, kernel_vs_chained=dict(
            kernel_vs_chained, y=float(np.abs(ys["kernel"] - ys["chained"]).max())),
        kernel_check=check, highs_seconds=highs_s,
        highs_status=status, highs_objective=h_obj, highs_yhat=h_yhat,
        highs_wait_seconds=highs_wait, launches=launches,
        seconds=time.perf_counter() - t_phase,
    )
    rec["ok"] = bool(
        status == 0 and solves["sharded_ell"]["route"] == "ell"
        and k_sol["megakernel_fit_miss"] == 0 and k_sol["megakernel_dispatches"] == 1
        and k_sol["launches"]["lp_block"] == 1 and k_sol["launches"]["lp_block_global_x"] == 1
        and c_sol["megakernel_fit_miss"] == 0 and c_sol["launches"]["lp_block"] == 0
        and solves["sharded_ell"]["launches"]["lp_block"] == 0
        and max(kernel_vs_chained.values()) <= SHARDED_DUAL_TOL and check["ok"]
        and all(r["converged"] and r["clean"] and r["highs_obj_err"] <= SHARDED_DUAL_TOL
                and r["highs_yhat_err"] <= SHARDED_DUAL_TOL
                and max(r["feasibility"].values()) <= SHARDED_DUAL_TOL
                and r["launches"]["ell_gather_l2"] > 0
                and r["launches"]["ell_gather_l2"] == r["launches"]["ell_gather"]
                for r in solves.values())
    )
    print(json.dumps(rec), flush=True)
    return rec


def master_dual_bound(MT, v, w):
    """The lower bound on the two-sided ε-LP's optimum that aiming duals
    ``w = y_lo − y_up`` certify: ``(vᵀw − max_c (Mᵀw)_c) / max(1, ‖w‖₁)``
    (``w`` scaled into the dual's feasible set, ``μ`` at its best). A
    wrong ``w`` (rows out of order, a sign, a missing scale) reads well
    below the optimum."""
    w = np.asarray(w, dtype=np.float64)
    return float((v @ w - (MT.T @ w).max()) / max(1.0, np.abs(w).sum()))


def sharded_master_phase(mesh, pack, MT):
    """The row-sharded face master on the flagship master of the kernel
    phases (6,144 columns × T=814, :func:`flagship_target`) over the
    one-rank mesh: ``eps_real`` ≤ ``SHARDED_MASTER_EPS``, Σp = 1 within
    ``SHARDED_MASTER_SUM``, ``eps_real`` within ``SHARDED_MASTER_VS_KERNEL``
    of the two-sided kernel's solve of the same LP, and its aiming duals
    ``w`` against the kernel's: each certifies (:func:`master_dual_bound`)
    an optimum within ``SHARDED_MASTER_DUAL`` of what the kernel's mixture
    realizes, the two certificates agree within the same, and the two
    ``w`` within ``SHARDED_MASTER_W_REL`` of the kernel's in L1."""
    import torch

    from citizensassemblies_tpu_torch.parallel.solver import solve_decomp_master_sharded
    from citizensassemblies_tpu_torch.solvers import lp_pdhg
    from citizensassemblies_tpu_torch.utils.config import default_config

    v = flagship_target(MT)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eps_real, w, p, eps_obj, ok = solve_decomp_master_sharded(
        MT, v, mesh, cfg=default_config(), tol=MASTER_TOL, stats=st
    )
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = lp_pdhg.solve_two_sided_master_ell(pack, v, cfg=default_config(), tol=MASTER_TOL,
                                             device="cuda")
    kernel_s = time.perf_counter() - t0
    T, C = MT.shape
    pk = np.maximum(sol.x[:C], 0.0)
    pk = pk / pk.sum()
    eps_kernel = float(np.abs(MT @ pk - v).max())
    lam_k = np.maximum(np.asarray(sol.lam, dtype=np.float64), 0.0)
    w_k = lam_k[:T] - lam_k[T : 2 * T]
    bound, bound_k = master_dual_bound(MT, v, w), master_dual_bound(MT, v, w_k)
    rec = dict(
        phase="sharded_master_flagship", T=T, columns=C, seconds=secs,
        blocks=st["blocks"], iterations=st["iters"], kkt=st["res"], converged=ok,
        eps_real=eps_real, eps_obj=eps_obj, p_sum_err=abs(float(p.sum()) - 1.0),
        kernel_seconds=kernel_s, kernel_iterations=int(sol.iters), kernel_eps_real=eps_kernel,
        vs_kernel=abs(eps_real - eps_kernel),
        dual_bound=bound, kernel_dual_bound=bound_k,
        dual_bound_flipped=master_dual_bound(MT, v, -w),
        dual_bound_reversed=master_dual_bound(MT, v, w[::-1]),
        w_l1=float(np.abs(w).sum()), kernel_w_l1=float(np.abs(w_k).sum()),
        w_vs_kernel_inf=float(np.abs(w - w_k).max()),
        w_vs_kernel_l1=float(np.abs(w - w_k).sum()),
    )
    rec["ok"] = bool(
        eps_real <= SHARDED_MASTER_EPS and rec["p_sum_err"] <= SHARDED_MASTER_SUM
        and rec["vs_kernel"] <= SHARDED_MASTER_VS_KERNEL
        and bound <= eps_kernel + 1e-9 and eps_kernel - bound <= SHARDED_MASTER_DUAL
        and abs(bound - bound_k) <= SHARDED_MASTER_DUAL
        and rec["w_vs_kernel_l1"] <= SHARDED_MASTER_W_REL * rec["kernel_w_l1"]
    )
    print(json.dumps(rec), flush=True)
    return rec


def sweep_phase():
    """``sweep_legacy_allocations``' batched draw over
    ``sf_e_skewed_instance(seed=1..4)``, 2,048 chains each, in one batched
    call; each instance's panels and allocation bit for bit those of the
    per-instance sampler fed that instance's rows of the same noise;
    padding agents at 0."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.legacy import _sample_panels_kernel, gumbel
    from citizensassemblies_tpu_torch.parallel import sweep

    denses = [featurize(sf_e_skewed_instance(seed=s), device="cuda")[0] for s in SWEEP_SEEDS]
    stacked, n_real = sweep.pad_and_stack(denses)
    I, n_max, F_max = stacked.shape
    B = SWEEP_CHAINS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    panels, ok = sweep.sweep_panels(stacked, B, torch.Generator(device="cuda").manual_seed(7))
    alloc, rate = sweep.allocation_from_panels(panels, ok, n_max)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bitwise = []
    for i, d in enumerate(denses):
        gen = torch.Generator(device="cuda").manual_seed(7)

        def noise_at(_step, i=i, n=d.n, gen=gen):
            return gumbel(gen, (I, B, n_max), "cuda")[i, :, :n]

        p_i, ok_i = _sample_panels_kernel(d, B, noise_at)
        a_i, r_i = sweep.allocation_from_panels(p_i, ok_i, n_max)
        bitwise.append(bool(torch.equal(panels[i], p_i) and torch.equal(ok[i], ok_i)
                            and torch.equal(alloc[i], a_i) and float(rate[i]) == float(r_i)))
    alloc_np = alloc.cpu().numpy()
    padding_zero = bool(all(np.all(alloc_np[i, n_real[i]:] == 0.0) for i in range(I)))
    rec = dict(
        phase="sweep_sf_e", instances=I, n_real=[int(x) for x in n_real], n_max=n_max,
        F_max=F_max, chains=B, seconds=secs, panels_per_s=I * B / secs,
        accept_rate=[float(x) for x in rate.cpu().numpy()], bitwise=bitwise,
        padding_zero=padding_zero, padded_agents=int(sum(n_max - x for x in n_real)),
    )
    rec["ok"] = bool(all(bitwise) and padding_zero and float(rate.min()) > 0.0)
    print(json.dumps(rec), flush=True)
    return rec


def distribution_phases(libs, leximin, pack, MT, highs_ref, nationwide_ref):
    """The distribution layer on the card: the one-rank NCCL world, then
    the chain-parallel Monte-Carlo, the dropout realization, the sharded
    dual LP and face master and the nationwide dual LP (``nationwide_ref``,
    :func:`dual_lp_nationwide_phase`) over one more one-rank world (torn
    down after), and the instance sweep."""
    import torch
    import torch.distributed as dist

    from citizensassemblies_tpu_torch.dist import runtime
    from citizensassemblies_tpu_torch.parallel.mesh import make_mesh

    out = {"world": dist_world1_phase()}
    mesh = make_mesh(1)
    # NCCL creates its communicator at the first collective: one of each
    # kind here, so no phase's time holds it
    warm = torch.ones(8, device="cuda")
    dist.all_reduce(warm)
    dist.all_gather([torch.empty_like(warm)], warm)
    torch.cuda.synchronize()
    try:
        out["mc"] = mc_flagship_phase(mesh)
        out["dropout"] = dropout_mc_phase(mesh, leximin)
        out["dual"] = sharded_dual_phase(mesh, highs_ref, libs)
        out["master"] = sharded_master_phase(mesh, pack, MT)
        out["dual_nationwide"] = dual_lp_nationwide_phase(mesh, nationwide_ref, libs)
    finally:
        runtime.shutdown()
    out["sweep"] = sweep_phase()
    return out


def households_phases(cfg, libs, audits):
    """Every household phase, in order; returns their records by name."""
    hold = households_hold_phase(cfg, libs)
    n400, dist400, dense400, space400, hh400 = households_leximin_phase(
        400, cfg, libs, audits, repeat=True
    )
    n1200 = households_leximin_phase(1200, cfg, libs, audits)[0]
    agent = households_agent_space_phase(cfg, libs)
    xmin = households_xmin_phase(dense400, space400, cfg, hh400, dist400, n400["seconds"], libs)
    return dict(hold=hold, n400=n400, n1200=n1200, agent=agent, xmin=xmin)


# --- slice 11: the request context, the scenario models, churn ----------------------


def _launches(libs) -> dict:
    """Every kernel's launches since the counters were zeroed, the gather's
    bf16-value path among them and also apart."""
    return dict({lib.name: lib.launches for lib in libs}, ell_gather_bf16=bf16_gathers())


def _scenario_drop(n: int) -> np.ndarray:
    """``bench.py --scenarios``'s attendance law: no-show U(0, 0.5) drawn
    from ``numpy.random.default_rng(0)``."""
    return np.random.default_rng(0).uniform(0.0, 0.5, size=n)


def _blind_baseline(blind, aware, dense_host):
    """The naive re-draw baseline of ``bench.py:2107-2121``: the
    attendance-blind LEXIMIN portfolio with the aware run's attendance."""
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction

    class Blind:
        committees = blind.committees
        probabilities = blind.probabilities
        attendance = aware.attendance
        type_id = TypeReduction(dense_host).type_id
        covered = blind.covered

    return Blind()


def scenario_dropout_bench_phase(cfg, libs):
    """``bench.py --scenarios``'s dropout row (``bench.py:2055-2150``) on the
    card: ``random_instance(n=60, k=8, n_categories=2, seed=0)``, no-show
    U(0, 0.5), the dropout-aware LEXIMIN with the ``type`` policy against
    the attendance-blind LEXIMIN with the ``naive`` re-draw, both audited by
    65,536 Monte-Carlo draws on the card. Holds the contract and the aware
    realized minimum above the naive baseline's."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.scenarios import find_distribution_dropout
    from citizensassemblies_tpu_torch.scenarios.dropout import evaluate_realization
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    inst = random_instance(n=60, k=8, n_categories=2, seed=0)
    dense, space = featurize(inst, device="cuda")
    host, _ = featurize(inst, device="cpu")
    cfg = cfg.replace(scenario_mc_draws=SCENARIO_DRAWS)
    drop = _scenario_drop(dense.n)
    for lib in libs:
        lib.reset_counts()
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    aware = find_distribution_dropout(dense, space, dropout=drop, cfg=cfg, log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches(libs)
    blind = find_distribution_leximin(dense, space, cfg=cfg)
    t1 = time.perf_counter()
    ours = evaluate_realization(aware, dense, draws=SCENARIO_DRAWS, policy="type", seed=0)
    naive = evaluate_realization(_blind_baseline(blind, aware, host), dense,
                                 draws=SCENARIO_DRAWS, policy="naive", seed=0)
    mc_s = time.perf_counter() - t1
    audit = aware.scenario_audit
    rec = dict(
        phase="scenario_dropout_bench", n=dense.n, k=dense.k, seconds=secs, mc_seconds_two=mc_s,
        buckets=audit["buckets"], product_types=audit["types"], fallback=audit.get("fallback"),
        contract_ok=bool(aware.contract_ok), realization_dev=aware.realization_dev,
        certified_min_realized=audit["certified_min_realized"], mc_aware_type=ours,
        mc_blind_naive=naive, beats_naive_redraw=bool(ours["realized_min"] > naive["realized_min"]),
        launches=launches, timers={k: log.timers.get(k, 0.0) for k in (
            "scenario_leximin", "scenario_decompose")},
    )
    rec["ok"] = bool(aware.contract_ok and rec["beats_naive_redraw"] and clean(log.counters)
                     and audit["mc"]["draws"] == SCENARIO_DRAWS)
    print(json.dumps(rec), flush=True)
    return rec


def scenario_dropout_example_small_phase(cfg, libs):
    """The dropout model on ``example_small_like_instance()`` (n=200,
    k=20, the upstream ``example_small_20`` shape) at the bench's
    attendance law, its audit at 65,536 draws; reports whether the product
    type space stayed enumerable (the aware path) or fell back."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import example_small_like_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.scenarios import find_distribution_dropout
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, space = featurize(example_small_like_instance(), device="cuda")
    cfg = cfg.replace(scenario_mc_draws=SCENARIO_DRAWS)
    for lib in libs:
        lib.reset_counts()
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    d = find_distribution_dropout(dense, space, dropout=_scenario_drop(dense.n), cfg=cfg, log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    audit = d.scenario_audit
    rec = dict(
        phase="scenario_dropout_example_small", n=dense.n, k=dense.k, seconds=secs,
        path="fallback" if "fallback" in audit else "aware", fallback=audit.get("fallback"),
        buckets=audit["buckets"], product_types=audit["types"], contract_ok=bool(d.contract_ok),
        realization_dev=d.realization_dev, panels=int(len(d.probabilities)),
        certified_min_realized=audit["certified_min_realized"], mc=audit["mc"],
        launches=_launches(libs), timers={k: log.timers.get(k, 0.0) for k in (
            "scenario_leximin", "scenario_decompose")},
    )
    rec["ok"] = bool(d.contract_ok and clean(log.counters)
                     and audit["mc"]["draws"] == SCENARIO_DRAWS)
    print(json.dumps(rec), flush=True)
    return rec


def scenario_dropout_flagship_phase(cfg, libs, leximin):
    """The dropout model on ``sf_e_skewed_instance(seed=1)`` at the bench's
    attendance law: T=814 types times the occupied buckets exceed
    ``enum_max_types``, so it runs the attendance-unaware LEXIMIN (the main
    path: its face loop launches the two-sided kernel and the gather) and
    audits it with 65,536 draws; the other two policies are audited on the
    same portfolio. Holds the contract within 1e-3, the fallback's
    portfolio bit for bit the defaults flagship's, and both kernels
    launched."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.scenarios import find_distribution_dropout
    from citizensassemblies_tpu_torch.scenarios.dropout import evaluate_realization
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    dense, space = featurize(sf_e_skewed_instance(seed=1), device="cuda")
    cfg = cfg.replace(scenario_mc_draws=SCENARIO_DRAWS)
    for lib in libs:
        lib.reset_counts()
    log = RunLog(echo=False)
    t0 = time.perf_counter()
    d = find_distribution_dropout(dense, space, dropout=_scenario_drop(dense.n), cfg=cfg, log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches(libs)
    audit = d.scenario_audit
    policies = {cfg.scenario_replacement: audit["mc"]}
    for policy in ("type", "naive", "none"):
        if policy not in policies:
            t1 = time.perf_counter()
            policies[policy] = evaluate_realization(d, dense, draws=SCENARIO_DRAWS, policy=policy)
            policies[policy]["seconds"] = time.perf_counter() - t1
    linf = float(np.max(np.abs(d.allocation - d.fixed_probabilities)))
    same = bool(
        np.array_equal(d.committees, leximin.committees)
        and np.array_equal(d.probabilities, leximin.probabilities)
        and np.array_equal(d.allocation, leximin.allocation)
    )
    rec = dict(
        phase="scenario_dropout_flagship", n=dense.n, k=dense.k, seconds=secs,
        fallback=audit.get("fallback"), product_types=audit["types"], buckets=audit["buckets"],
        contract_ok=bool(d.contract_ok), linf=linf, panels=int(len(d.probabilities)),
        certified_min_realized=audit["certified_min_realized"],
        policies={p: {k: v for k, v in r.items() if k in (
            "realized_min", "realized_min_any", "quota_ok_rate", "fill_rate", "draws", "seconds")}
            for p, r in policies.items()},
        bit_identical_to_defaults=same, launches=launches,
        decomp_rounds=int(log.counters.get("decomp_rounds", 0)),
    )
    rec["ok"] = bool(
        d.contract_ok and linf <= E2E_CONTRACT and "fallback" in audit and same
        and launches["two_sided_block"] > 0 and launches["ell_gather"] > 0
        and all(r["draws"] == SCENARIO_DRAWS for r in policies.values()) and clean(log.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec


def scenario_multi_phase(cfg, libs):
    """Multi-assembly scheduling on ``example_small_like_instance()`` at
    R=3 on the card: its R-round fleet one bucketed ``solve_lp_batch``
    dispatch there (``Config.lp_batch`` resolves on for CUDA), 1,000 drawn
    schedules without a repeat, the pair gauge; the aggregate certificate
    within 1e-6 of the same model on the CPU (whose fleet is the host LP)
    and the allocation within the contract of it."""
    from unittest import mock

    import torch

    from citizensassemblies_tpu_torch.core.generator import example_small_like_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.scenarios import find_distribution_multi
    from citizensassemblies_tpu_torch.solvers import batch_lp
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    inst = example_small_like_instance()
    dense, space = featurize(inst, device="cuda")
    host, host_space = featurize(inst, device="cpu")
    solve = batch_lp.solve_lp_batch
    fleets = []

    def recorded(problems, cfg=None, log=None, warm_key=None, **kw):
        before = log.counters.get("lp_batch_dispatches", 0)
        sols = solve(problems, cfg, log, warm_key=warm_key, **kw)
        fleets.append([warm_key, len(problems), log.counters["lp_batch_dispatches"] - before,
                       str(kw.get("device"))])
        return sols

    for lib in libs:
        lib.reset_counts()
    log = RunLog(echo=False)
    with mock.patch.object(batch_lp, "solve_lp_batch", recorded):
        t0 = time.perf_counter()
        m = find_distribution_multi(dense, space, rounds=3, cfg=cfg, log=log)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launches(libs)
    repeats = 0
    for seed in range(1000):
        flat = m.realize(seed=seed).ravel()
        repeats += int(flat.size - len(np.unique(flat)))
    t1 = time.perf_counter()
    ref = find_distribution_multi(host, host_space, rounds=3, cfg=cfg, device="cpu")
    cpu_s = time.perf_counter() - t1
    audit = m.scenario_audit
    fleet = [f for f in fleets if f[0] == "scenario_multi"]
    rec = dict(
        phase="scenario_multi", n=dense.n, k=dense.k, rounds=3, seconds=secs, cpu_seconds=cpu_s,
        fleet_backend=audit["fleet_backend"], fleet_calls=fleet, round_eps_max=audit["round_eps_max"],
        contract_ok=bool(m.contract_ok), realization_dev=m.realization_dev,
        schedules=1000, repeats=repeats, pair_max=m.pair_max, pair_uniform=m.pair_uniform,
        pair_ratio=m.pair_ratio, panels_per_round=audit["panels_per_round"],
        compositions=audit["compositions"], types=audit["types"],
        certificate_vs_cpu=float(np.max(np.abs(m.fixed_probabilities - ref.fixed_probabilities))),
        allocation_vs_cpu=float(np.max(np.abs(m.allocation - ref.allocation))),
        cpu_round_eps_max=ref.scenario_audit["round_eps_max"], launches=launches,
        lp_batch_dispatches=int(log.counters.get("lp_batch_dispatches", 0)),
    )
    rec["ok"] = bool(
        m.contract_ok and repeats == 0 and audit["fleet_backend"] == "batch_lp"
        and len(fleet) == 1 and fleet[0][1:3] == [3, 1] and fleet[0][3].startswith("cuda")
        and rec["certificate_vs_cpu"] <= 1e-6 and rec["allocation_vs_cpu"] <= E2E_CONTRACT
        and m.pair_ratio >= 1.0 - 1e-9 and clean(log.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec


def _type_linf(state_a, state_b) -> float:
    """``churn_bench``'s type-value L∞ over the live types of ``state_b``
    matched by feature key (``bench.py:1466-1486``)."""
    ia = {tuple(int(v) for v in row): t for t, row in enumerate(state_a.system.type_feature)}
    worst = 0.0
    for t_b, row in enumerate(state_b.system.type_feature):
        if state_b.system.msize[t_b] == 0:
            continue
        t_a = ia.get(tuple(int(v) for v in row))
        if t_a is None:
            return float("inf")
        worst = max(worst, abs(float(state_a.type_values[t_a]) - float(state_b.type_values[t_b])))
    return worst


def churn_phase(cfg, libs):
    """``churn_bench`` (``bench.py:1383-1460``) at its full size on the
    card: ``nationwide_registry(n=100,000, k=316, seed=16)`` over one
    8-region category, its seeded 1,000-edit trail cut to the first
    ``CHURN_EDITS`` edits, the delta arm on every edit (the screen on the
    card) and the from-scratch arm sampled per edit class up to
    ``CHURN_SCRATCH`` samples in all. Holds the bench's bars: type-value
    L∞ against scratch ≤ 1e-3 on every sample, every ``eps_bound`` within
    the contract, at least one cache hit, the delta median ≥ 5× below the
    scratch median; and the last state's screen on the card against the
    CPU (mask equal, gaps within 1e-6)."""
    from unittest import mock

    from citizensassemblies_tpu_torch.data.registry import (
        apply_edit,
        churn_trail,
        nationwide_registry,
    )
    from citizensassemblies_tpu_torch.solvers import batch_lp, delta
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    # the batched LP engine's share (the ladder's probe prescreen): calls
    # and seconds, each ending in its readback
    solve = batch_lp.solve_lp_batch
    engine = {"calls": 0, "seconds": 0.0}

    def timed_engine(*a, **kw):
        t = time.perf_counter()
        out = solve(*a, **kw)
        engine["seconds"] += time.perf_counter() - t
        engine["calls"] += 1
        return out

    patch = mock.patch.object(batch_lp, "solve_lp_batch", timed_engine)
    patch.start()
    for lib in libs:
        lib.reset_counts()
    t_phase = time.perf_counter()
    reg = nationwide_registry(n=100_000, k=316, seed=16,
                              categories=(("region", [f"r{i}" for i in range(8)]),),
                              quota_slack=0.003)
    trail = churn_trail(reg, 1000, seed=16, max_edit_agents=8, max_new_types=2, weights={
        "agents_add": 0.36, "agents_drop": 0.34, "quota_relax": 0.10, "quota_tighten": 0.14,
        "new_type": 0.06,
    })[:CHURN_EDITS]
    trail_s = time.perf_counter() - t_phase
    log = RunLog(echo=False)

    def scratch(r):
        t0 = time.perf_counter()
        st = delta.certify_base(r, cfg=cfg, log=log)
        return time.perf_counter() - t0, st

    base_s, state = scratch(reg)
    modes = {"cache_hit": 0, "resume": 0, "full_ladder": 0, "fallback": 0}
    delta_s, scratch_s, per_class = [], [], {}
    worst_linf = worst_eps = 0.0
    failures = []
    cur = reg
    for i, edit in enumerate(trail):
        nxt = apply_edit(cur, edit)
        t0 = time.perf_counter()
        out = delta.recertify(state, edit, cur, cfg=cfg, log=log)
        if out is not None:
            dt = time.perf_counter() - t0
            state = out.state
            modes[out.cert["mode"]] += 1
            worst_eps = max(worst_eps, float(out.cert["eps_bound"]))
        else:
            _s, state = scratch(nxt)
            dt = time.perf_counter() - t0
            modes["fallback"] += 1
            if state is None:
                failures.append(f"edit {i} ({edit.kind}): both arms failed")
                break
        delta_s.append(dt)
        per_class.setdefault(edit.kind, []).append(dt)
        if len(scratch_s) < CHURN_SCRATCH and sum(
                1 for k, _ in scratch_s if k == edit.kind) < CHURN_SCRATCH_PER_CLASS:
            s_t, s_state = scratch(nxt)
            if s_state is None:
                failures.append(f"edit {i} ({edit.kind}): from-scratch failed")
            else:
                scratch_s.append((edit.kind, s_t))
                linf = _type_linf(state, s_state)
                worst_linf = max(worst_linf, linf)
                if linf > E2E_CONTRACT:
                    failures.append(f"edit {i} ({edit.kind}): L∞ {linf:.2e}")
        cur = nxt

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")

    patch.stop()
    delta_med, scratch_med = med(delta_s), med([t for _, t in scratch_s])
    # the last state's screen, the card against the CPU
    sys_ = state.system
    margin = cfg.delta_cert_margin
    feas_c, gap_c = delta.screen_columns(state.pack, state.comps, sys_, state.certs, margin,
                                         cfg=cfg, device="cuda")
    feas_h, gap_h = delta.screen_columns(state.pack, state.comps, sys_, state.certs, margin,
                                         cfg=cfg, device="cpu")
    screen_gap = float(np.max(np.abs(gap_c - gap_h))) if gap_c.size else 0.0
    rec = dict(
        phase="churn_nationwide", n=reg.n, k=reg.k, edits=len(delta_s), trail_seconds=trail_s,
        base_seconds=base_s, modes=modes, delta_median_s=delta_med, scratch_median_s=scratch_med,
        scratch_samples=len(scratch_s), speedup=scratch_med / max(delta_med, 1e-9),
        delta_total_s=sum(delta_s), lp_engine=engine,
        per_class={k: dict(edits=len(v), median_s=med(v)) for k, v in sorted(per_class.items())},
        worst_linf_vs_scratch=worst_linf, worst_eps_bound=worst_eps,
        screen_dispatches=int(log.counters.get("delta_screen_dispatches", 0)),
        screen_card_vs_cpu=dict(mask_equal=bool(np.array_equal(feas_c, feas_h)), gap=screen_gap,
                                columns=int(len(state.comps)), stages=len(state.certs)),
        final_types=int(sys_.T), final_columns=int(len(state.comps)),
        launches=_launches(libs), seconds=time.perf_counter() - t_phase, failures=failures,
    )
    rec["ok"] = bool(
        not failures and worst_linf <= E2E_CONTRACT and worst_eps <= E2E_CONTRACT
        and modes["cache_hit"] >= 1 and rec["speedup"] >= 5.0
        and rec["screen_card_vs_cpu"]["mask_equal"] and screen_gap <= 1e-6
    )
    print(json.dumps(rec), flush=True)
    return rec


def deadline_flagship_phase(inst, cfg, libs, leximin):
    """The flagship LEXIMIN at the defaults under a ``RequestContext``.
    A generous deadline that records the elapsed time at each of the face
    loop's per-round checks: bit for bit the defaults flagship run without
    a context. Then a deadline set halfway between the generous run's
    checks of rounds 1 and 2: it raises ``DeadlineExceeded`` from inside
    the loop, with ``partial`` holding the rounds run and the best ε, after
    the kernels launched."""
    import torch

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.robust.policy import Deadline, DeadlineExceeded
    from citizensassemblies_tpu_torch.service import RequestContext

    class Recording(Deadline):
        def __init__(self, seconds):
            super().__init__(seconds)
            self.at = []

        def check(self, where, log=None, partial=None):
            self.at.append(self.elapsed())
            return super().check(where, log=log, partial=partial)

    dense, space = featurize(inst, device="cuda")
    for lib in libs:
        lib.reset_counts()
    generous = Recording(1e9)
    ctx = RequestContext.create(cfg=cfg, deadline=generous)
    t0 = time.perf_counter()
    dist = find_distribution_leximin(dense, space, ctx=ctx)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches(libs)
    same = bool(
        np.array_equal(dist.committees, leximin.committees)
        and np.array_equal(dist.probabilities, leximin.probabilities)
        and np.array_equal(dist.allocation, leximin.allocation)
    )
    checks = list(generous.at)
    limit = (checks[1] + checks[2]) / 2 if len(checks) >= 3 else None
    tight = dict(limit_s=limit)
    if limit is not None:
        for lib in libs:
            lib.reset_counts()
        tctx = RequestContext.create(cfg=cfg, deadline=Deadline(limit))
        t1 = time.perf_counter()
        try:
            find_distribution_leximin(dense, space, ctx=tctx)
            tight["raised"] = False
        except DeadlineExceeded as exc:
            torch.cuda.synchronize()
            tight.update(raised=True, message=str(exc), partial=exc.partial)
        tight.update(seconds=time.perf_counter() - t1, launches=_launches(libs),
                     deadline_exceeded=int(tctx.log.counters.get("deadline_exceeded", 0)),
                     decomp_rounds=int(tctx.log.counters.get("decomp_rounds", 0)))
    partial = tight.get("partial") or {}
    rec = dict(
        phase="deadline_flagship", seconds=secs, rounds_checked=len(checks),
        check_seconds=checks, generous_bit_identical=same, launches=launches,
        contract_ok=bool(dist.contract_ok), tight=tight,
    )
    rec["ok"] = bool(
        same and dist.contract_ok and launches["two_sided_block"] > 0 and tight.get("raised")
        and set(partial) == {"decomp_rounds", "best_eps"}
        and 1 <= partial["decomp_rounds"] < len(checks)
        and partial["best_eps"] is not None and np.isfinite(partial["best_eps"])
        and tight["deadline_exceeded"] == 1 and tight["launches"]["two_sided_block"] > 0
        and clean(ctx.log.counters)
    )
    print(json.dumps(rec), flush=True)
    return rec


def scenario_phases(cfg, libs, leximin):
    """Slice 11's phases, in order; returns their records by name."""
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance

    return dict(
        dropout_bench=scenario_dropout_bench_phase(cfg, libs),
        dropout_example_small=scenario_dropout_example_small_phase(cfg, libs),
        dropout_flagship=scenario_dropout_flagship_phase(cfg, libs, leximin),
        multi=scenario_multi_phase(cfg, libs),
        churn=churn_phase(cfg, libs),
        deadline=deadline_flagship_phase(sf_e_skewed_instance(seed=1), cfg, libs, leximin),
    )


# --- slice 12: serving --------------------------------------------------------------

#: the serve bench's SLO spec (``bench.py:1743``)
SERVE_SLO_SPEC = "latency_p99:30s,error_rate:0.01"
#: ``serve_mixed_fleet`` runs the first SERVE_FLEET_N of the serve bench's
#: 60 requests (``bench.py:1785-1791``, shapes unchanged): the batched LP
#: engine takes about a second a call on these pools, and the sub-phase
#: must fit phase 12's budget
SERVE_FLEET_N = 8
SERVE_FLEET_ALL = 60
#: ``serve_fleet_drive`` drives process 0 of the fleet bench's 4
#: (``bench.py:3158-3240``: seed 20, 6 unique instances a tenant) over the
#: first FLEET_DRIVE_REQUESTS of its 10,000 planned arrivals (a prefix of
#: the same plan), to stay under 30 s (40 until the whole script read
#: 1,215.0 s on an NVIDIA H100 80GB HBM3 at 700 W, 31.6 s at 40; 16 to keep
#: xmin_l2_hold at the XMIN path's caps)
FLEET_DRIVE_PROCESSES = 4
FLEET_DRIVE_REQUESTS = 16
FLEET_DRIVE_ALL = 10_000
FLEET_DRIVE_SEED = 20
FLEET_DRIVE_UNIQUE = 6
#: revise requests over the first edits of ``churn_bench``'s trail (5
#: until phase 13 needed the room: 56.6 s at 5 on an NVIDIA H100 80GB HBM3
#: at 700 W; 3 until the whole script read 1,077.6 s, 40.3 s at 3; the
#: first is the base's fallback, so 2 is the least that holds a revise
#: against direct re-certification)
REVISE_EDITS = 2
REVISE_TOL = 1e-6
#: the sojourn parts must explain the total within this share
SOJOURN_GAP = 0.05


def _sojourn_gap(audit) -> float:
    soj = audit["sojourn"]
    parts = soj["queue_wait_s"] + soj["prepare_s"] + soj["solve_s"] + soj["audit_s"]
    return abs(soj["total_s"] - parts) / max(soj["total_s"], 1e-9)


def _same_distribution(a, b) -> bool:
    return bool(
        np.array_equal(a.committees, b.committees)
        and np.array_equal(a.probabilities, b.probabilities)
        and np.array_equal(a.allocation, b.allocation)
    )


def _sync_mode() -> int:
    import torch

    return int(torch.cuda.get_sync_debug_mode()) if torch.cuda.is_available() else 0


def serve_flagship_phase(cfg, libs, leximin, legacy_alloc, inst=None, device="cuda",
                         legacy_iterations=10_000, keep=None):
    """The selection service on the flagship pool: a ``SelectionService`` at
    the defaults with the sampling tracer, the memory ledger and the serve
    bench's SLO spec, two workers. Two LEXIMIN requests of tenants ``a``
    and ``b`` submitted together run side by side (the transfer guard at
    ``"disallow"`` under concurrent launch windows); then LEGACY on the
    same pool (10,000 draws, seed 0); then the first request once more.
    Holds each LEXIMIN allocation bit for bit the defaults flagship's
    (``leximin_sf_e_defaults``), LEGACY bit for bit ``legacy_flagship``'s,
    the repeat served from the memo with no launch, every audit's contract
    and sojourn decomposition, the exported trace's schema, and the sync
    debug mode back at 0 with no window open. ``keep`` (a dict) receives
    the requests' tracers and the exported trace document."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.obs import validate_chrome_trace
    from citizensassemblies_tpu_torch.service.server import SelectionRequest, SelectionService
    from citizensassemblies_tpu_torch.utils import guards

    inst = inst if inst is not None else sf_e_skewed_instance(seed=1)
    scfg = cfg.replace(obs_trace=True, obs_memory=True, obs_slo_spec=SERVE_SLO_SPEC,
                       serve_admission_cap=2)
    t_phase = time.perf_counter()
    with SelectionService(scfg, device=device) as svc:
        for lib in libs:
            lib.reset_counts()
        t0 = time.perf_counter()
        chans = [svc.submit(SelectionRequest(instance=inst, tenant=t, request_id=f"flagship-{t}"))
                 for t in ("a", "b")]
        pair = [ch.result(timeout=600) for ch in chans]
        pair_wall = time.perf_counter() - t0
        pair_launches = _launches(libs)
        for lib in libs:
            lib.reset_counts()
        legacy = svc.run(SelectionRequest(instance=inst, tenant="a", algorithm="legacy",
                                          iterations=legacy_iterations, seed=0), timeout=600)
        legacy_launches = _launches(libs)
        for lib in libs:
            lib.reset_counts()
        repeat = svc.run(SelectionRequest(instance=inst, tenant="a"), timeout=600)
        repeat_launches = _launches(libs)
        doc = svc.export_traces()
        slo = svc.slo.evaluate()
        stats = svc.stats()
        if keep is not None:
            keep.update(tracers=svc.tracers(), trace_doc=doc)
    mode_after = _sync_mode()
    gate = guards.GATE.state()
    problems = validate_chrome_trace(doc)
    requests = []
    for res in pair + [legacy, repeat]:
        a = res.audit
        requests.append(dict(
            request_id=res.request_id, tenant=res.tenant, algorithm=res.algorithm,
            seconds=res.seconds, from_memo=res.from_memo, sojourn=a.get("sojourn"),
            sojourn_gap=_sojourn_gap(a), contract_ok=a.get("contract_ok"),
            spans=(a.get("obs") or {}).get("span_count"),
            peak_bytes=(a.get("memory") or {}).get("high_watermark_bytes"),
            memory_measured=(a.get("memory") or {}).get("measured"),
            captures=a.get("xla_compiles"),
            decomp_rounds=int(a["counters"].get("decomp_rounds", 0)),
        ))
    same = [_same_distribution(r.result, leximin) for r in pair]
    legacy_same = bool(np.array_equal(legacy.allocation, legacy_alloc))
    expected = {"two_sided_block": 2 * 8, "ell_gather": 2 * 328}
    rec = dict(
        phase="serve_flagship", n=int(len(leximin.allocation)), seconds=time.perf_counter() - t_phase,
        pair_wall_s=pair_wall, pair_sum_s=sum(r.seconds for r in pair), requests=requests,
        bit_identical_to_defaults=same, legacy_bit_identical=legacy_same,
        launches=pair_launches, legacy_launches=legacy_launches, repeat_launches=repeat_launches,
        expected_launches=expected, trace_events=len(doc["traceEvents"]),
        trace_problems=problems[:5], slo_ok=slo["slo_ok"], sync_debug_mode_after=mode_after,
        gate_after=gate, batcher=stats["batcher"],
    )
    rec["ok"] = bool(
        all(same) and legacy_same and repeat.from_memo
        and _same_distribution(repeat.result, leximin)
        and not any(repeat_launches.values())
        and all(pair_launches.get(k, 0) == v for k, v in expected.items())
        and all(r.audit["contract_ok"] for r in pair)
        and all(r["sojourn_gap"] <= SOJOURN_GAP for r in requests)
        and all((r["spans"] or 0) > 0 for r in requests[:3])
        and not problems and mode_after == 0 and gate["open"] == 0 and gate["syncs"] == 0
        and all(clean(r.audit["counters"]) for r in pair)
    )
    print(json.dumps(rec, default=str), flush=True)
    return rec


def _churn_registry(n=100_000, k=316):
    """``churn_bench``'s registry and trail (``bench.py:1383-1460``), as
    ``churn_phase`` builds them."""
    from citizensassemblies_tpu_torch.data.registry import churn_trail, nationwide_registry

    reg = nationwide_registry(n=n, k=k, seed=16,
                              categories=(("region", [f"r{i}" for i in range(8)]),),
                              quota_slack=0.003)
    trail = churn_trail(reg, 1000, seed=16, max_edit_agents=8, max_new_types=2, weights={
        "agents_add": 0.36, "agents_drop": 0.34, "quota_relax": 0.10, "quota_tighten": 0.14,
        "new_type": 0.06,
    })
    return reg, trail


def serve_revise_churn_phase(cfg, libs, device="cuda", reg=None, trail=None):
    """Revise requests through the service on ``churn_bench``'s registry
    (n=100,000, k=316): a base LEXIMIN request, then one ``ReviseSpec``
    request per edit for the first ``REVISE_EDITS`` edits of its trail. The
    first revise finds a cold session: it is served from scratch and primes
    the session with ``certify_base`` of the edited registry; each later
    one is re-certified. Holds each re-certified answer's mode against the
    direct ``recertify`` from the same primed base on the same edits
    (``churn_nationwide``'s calls), and its per-agent type values within
    1e-6; then, on a service with ``delta_solve=False``, the first edit's
    revise bit for bit the cold service's from-scratch answer."""
    from citizensassemblies_tpu_torch.data.registry import apply_edit
    from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService
    from citizensassemblies_tpu_torch.solvers import delta
    from citizensassemblies_tpu_torch.solvers.native_oracle import TypeReduction
    from citizensassemblies_tpu_torch.utils.checkpoint import problem_fingerprint
    from citizensassemblies_tpu_torch.utils.logging import RunLog

    if reg is None:
        reg, trail = _churn_registry()
    edits = trail[:REVISE_EDITS]
    t_phase = time.perf_counter()
    for lib in libs:
        lib.reset_counts()
    regs = [reg]
    for edit in edits:
        regs.append(apply_edit(regs[-1], edit))
    denses = [r.to_dense(device=device) for r in regs]
    served = []
    with SelectionService(cfg, device=device) as svc:
        t0 = time.perf_counter()
        base = svc.run(SelectionRequest(dense=denses[0][0], space=denses[0][1], tenant="registry"),
                       timeout=900)
        base_s = time.perf_counter() - t0
        for i, edit in enumerate(edits):
            t0 = time.perf_counter()
            res = svc.run(SelectionRequest(
                dense=denses[i + 1][0], space=denses[i + 1][1], tenant="registry",
                revise=delta.ReviseSpec(edit=edit, reg_before=regs[i]),
            ), timeout=900)
            served.append((res, time.perf_counter() - t0))
    launches = _launches(libs)
    # the direct calls from the base the first revise primed
    log = RunLog(echo=False)
    fp1 = problem_fingerprint(denses[1][0], cfg, None)
    state = delta.certify_base(regs[1], cfg=cfg, log=log, fingerprint=fp1, device=device)
    checks = []
    for i in range(1, len(edits)):
        fp = problem_fingerprint(denses[i + 1][0], cfg, None)
        out = delta.recertify(state, edits[i], regs[i], cfg=cfg, log=log, fingerprint=fp,
                              device=device)
        res = served[i][0]
        cert = res.audit.get("delta_cert")
        row = dict(edit=i, kind=edits[i].kind, served_mode=(cert or {}).get("mode"),
                   seconds=served[i][1])
        if out is None:
            row.update(direct_mode=None, linf=None)
        else:
            state = out.state
            red = TypeReduction(denses[i + 1][0])
            ts = delta.project_to_reduction(out.state, red)
            direct = ts.type_values[red.type_id]
            row.update(direct_mode=out.cert["mode"],
                       linf=float(np.max(np.abs(res.result.fixed_probabilities - direct))))
        checks.append(row)
    first, first_s = served[0]
    with SelectionService(cfg.replace(delta_solve=False), device=device) as off_svc:
        off = off_svc.run(SelectionRequest(
            dense=denses[1][0], space=denses[1][1], tenant="registry",
            revise=delta.ReviseSpec(edit=edits[0], reg_before=regs[0]),
        ), timeout=900)
    rec = dict(
        phase="serve_revise_churn", n=reg.n, k=reg.k, edits=len(edits), base_seconds=base_s,
        first=dict(seconds=first_s, fallback=int(first.audit["counters"].get("delta_fallback", 0)),
                   delta_entries=first.audit["session"]["delta_entries"]),
        revised=checks, delta_off_bit_identical=_same_distribution(off.result, first.result),
        delta_off_touched_store=off.audit["session"]["delta_entries"], launches=launches,
        seconds=time.perf_counter() - t_phase,
    )
    rec["ok"] = bool(
        base.audit["contract_ok"] and rec["first"]["fallback"] == 1
        and rec["first"]["delta_entries"] >= 1
        and all(c["served_mode"] is not None and c["served_mode"] == c["direct_mode"]
                and c["linf"] <= REVISE_TOL for c in checks)
        and all(r.audit["contract_ok"] for r, _s in served)
        and rec["delta_off_bit_identical"] and rec["delta_off_touched_store"] == 0
    )
    print(json.dumps(rec), flush=True)
    return rec


def _serve_fleet_specs(count):
    """The serve bench's fleet (``bench.py:1785-1791``): request i is
    ``random_instance(n=24+8·(i%8), k=4+(i%4), n_categories=2, seed=i%7)``
    from tenant ``i%3``."""
    from citizensassemblies_tpu_torch.core.generator import random_instance

    return [
        (random_instance(n=24 + 8 * (i % 8), k=4 + (i % 4), n_categories=2, seed=i % 7),
         f"tenant{i % 3}")
        for i in range(count)
    ]


def serve_mixed_fleet_phase(cfg, libs, device="cuda", count=SERVE_FLEET_N):
    """The serve bench's mixed fleet (``bench.py:1776-1900``) through the
    service at its configuration (the batched engine on, an 8 ms batching
    window, 8 workers, obs on): serial references first, then every
    request submitted at once, then the last 4 again. Holds every served
    allocation within 1e-3 of its serial twin, at least one fused dispatch,
    more than one solve a dispatch, every sojourn explained within 5 %, and
    the repeats served from the memo with no capture. Records the graph
    captures of the process during the serial references and during the
    served pass (the graph store reuses one per signature)."""
    import torch

    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService
    from citizensassemblies_tpu_torch.utils.guards import CompilationGuard, one_time_work

    def captures():
        return one_time_work().get("cuda_graph_captures", 0)

    scfg = cfg.replace(lp_batch=True, serve_batch_window_ms=8.0, serve_admission_cap=8,
                       obs_trace=True, obs_memory=True, obs_slo_spec=SERVE_SLO_SPEC)
    specs = _serve_fleet_specs(count)
    t_phase = time.perf_counter()
    for lib in libs:
        lib.reset_counts()
    refs = []
    t0 = time.perf_counter()
    c0 = captures()
    for inst, _tenant in specs:
        d, s = featurize(inst, device=device)
        refs.append(find_distribution_leximin(d, s, cfg=scfg, device=device).allocation)
    serial_s = time.perf_counter() - t0
    serial_captures = captures() - c0
    with SelectionService(scfg, device=device) as svc:
        t0 = time.perf_counter()
        c0 = captures()
        subs = [(time.perf_counter(), svc.submit(SelectionRequest(instance=i, tenant=t)))
                for i, t in specs]
        results, lat = [], []
        for t_sub, ch in subs:
            results.append(ch.result(timeout=900))
            lat.append(time.perf_counter() - t_sub)
        serve_s = time.perf_counter() - t0
        serve_captures = captures() - c0
        bstats = svc.batcher.stats()
        with CompilationGuard(name="serve_warm") as warm_guard:
            warm = [svc.run(SelectionRequest(instance=i, tenant=t), timeout=900)
                    for i, t in specs[-4:]]
        slo = svc.slo.evaluate()
    if device != "cpu":
        torch.cuda.synchronize()
    worst = max(float(np.max(np.abs(r.allocation - ref))) for r, ref in zip(results, refs))
    lat_sorted = sorted(lat)

    def pct(q):
        return lat_sorted[min(len(lat_sorted) - 1, int(round(q * (len(lat_sorted) - 1))))]

    rec = dict(
        phase="serve_mixed_fleet", requests=count, of_bench_requests=SERVE_FLEET_ALL,
        serial_seconds=serial_s, serve_seconds=serve_s, p50_latency_s=pct(0.5),
        p99_latency_s=pct(0.99), instances_per_min=60.0 * count / max(serve_s, 1e-9),
        solves_per_dispatch=bstats["solves"] / max(bstats["dispatches"], 1),
        fused_dispatches=bstats["fused_dispatches"], batcher=bstats,
        worst_linf_vs_serial=worst, bit_identical=sum(
            1 for r, ref in zip(results, refs) if np.array_equal(r.allocation, ref)),
        sojourn_gap_max=max(_sojourn_gap(r.audit) for r in results),
        warm_from_memo=sum(1 for r in warm if r.from_memo),
        # one-time work (captures, builds) of the repeats: on this thread and
        # on the workers that served them (their audits' count)
        warm_captures=warm_guard.count + sum(int(r.audit["xla_compiles"]) for r in warm),
        serial_captures=serial_captures, serve_captures=serve_captures,
        slo_ok=slo["slo_ok"], launches=_launches(libs), seconds=time.perf_counter() - t_phase,
    )
    rec["ok"] = bool(
        worst <= E2E_CONTRACT and bstats["fused_dispatches"] >= 1
        and rec["solves_per_dispatch"] > 1.0 and rec["sojourn_gap_max"] <= SOJOURN_GAP
        and rec["warm_from_memo"] == 4 and rec["warm_captures"] == 0
        and all("memory" in r.audit for r in results)
    )
    print(json.dumps(rec), flush=True)
    return rec


def serve_fleet_drive_phase(cfg, libs, device="cuda", n_requests=FLEET_DRIVE_REQUESTS):
    """One ``FleetProcess`` in this process: process 0 of the fleet bench's
    4 (``bench.py:3158-3240``) drives its share of ``plan_from_config`` at
    ``fleet_offered_rate_hz`` open loop, on the card, after its serial
    references; every served allocation bit for bit its reference."""
    import torch

    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.core.instance import featurize
    from citizensassemblies_tpu_torch.models.leximin import find_distribution_leximin
    from citizensassemblies_tpu_torch.service import (
        FleetProcess,
        SelectionRequest,
        plan_from_config,
    )

    fcfg = cfg.replace(lp_batch=True, serve_batch_window_ms=8.0, serve_admission_cap=8,
                       serve_queue_depth=max(n_requests, 64),
                       obs_slo_spec="latency_p99:600s,error_rate:0.01")
    tenants, plan = plan_from_config(fcfg, n_requests, seed=FLEET_DRIVE_SEED,
                                     n_processes=FLEET_DRIVE_PROCESSES,
                                     rate_hz=fcfg.fleet_offered_rate_hz)
    mine = [a for a in plan if a.owner == 0]
    tenant_ix = {t: i for i, t in enumerate(tenants)}

    def spec_for(a):
        ti, j = tenant_ix[a.tenant], a.index % FLEET_DRIVE_UNIQUE
        return (a.tenant, j), random_instance(n=24 + 8 * ((ti + j) % 3), k=4 + ((ti + j) % 4),
                                              n_categories=2, seed=(ti * 31 + j) % 97)

    t_phase = time.perf_counter()
    for lib in libs:
        lib.reset_counts()
    needed, items, key_of = {}, [], {}
    for a in mine:
        key, inst = spec_for(a)
        needed.setdefault(key, inst)
        key_of[a.index] = key
        items.append((a, SelectionRequest(instance=inst, tenant=a.tenant)))
    refs = {}
    t0 = time.perf_counter()
    for key in sorted(needed):
        d, s = featurize(needed[key], device=device)
        refs[key] = find_distribution_leximin(d, s, cfg=fcfg, device=device).allocation
    serial_s = time.perf_counter() - t0
    worst = {"linf": 0.0, "bit_identical": True, "checked": 0}

    def check(a, res):
        ref = refs[key_of[a.index]]
        worst["checked"] += 1
        worst["linf"] = max(worst["linf"], float(np.max(np.abs(res.allocation - ref))))
        worst["bit_identical"] &= bool(np.array_equal(res.allocation, ref))

    with FleetProcess(0, FLEET_DRIVE_PROCESSES, fcfg, device=device) as fp:
        t0 = time.perf_counter()
        rollup = fp.drive(items, timeout_s=900.0, on_result=check)
        drive_s = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.synchronize()
    rec = dict(
        phase="serve_fleet_drive", processes=FLEET_DRIVE_PROCESSES, process=0,
        planned=n_requests, of_bench_requests=FLEET_DRIVE_ALL, offered=len(mine),
        unique=len(needed), rate_hz=fcfg.fleet_offered_rate_hz, serial_seconds=serial_s,
        drive_seconds=drive_s, rollup={k: v for k, v in rollup.items() if k != "sojourns_s"},
        checked=worst["checked"], worst_linf=worst["linf"], bit_identical=worst["bit_identical"],
        launches=_launches(libs), seconds=time.perf_counter() - t_phase,
    )
    rec["ok"] = bool(
        worst["bit_identical"] and worst["checked"] == len(mine) == rollup["completed"]
        and rollup["failed"] == 0 and rollup["shed"] == 0 and rollup["admission_rejected"] == 0
        and rollup["batcher"]["dist_reshards"] == 0
    )
    print(json.dumps(rec), flush=True)
    return rec


def serving_phases(cfg, libs, leximin, legacy_alloc, store_path=None, keep=None):
    """Slice 12's phases, in order; returns their records by name. With
    ``store_path``, ``serve_flagship`` runs under a graph-store recorder
    and its full-width signatures join the artifact there (phase 13's
    ``aot_build``); ``keep`` receives its tracers and trace."""
    from citizensassemblies_tpu_torch import aot

    rec = aot.Recorder() if store_path else None
    aot.install_recorder(rec)
    try:
        flagship = serve_flagship_phase(cfg, libs, leximin, legacy_alloc, keep=keep)
    finally:
        aot.install_recorder(None)
    if store_path:
        from citizensassemblies_tpu_torch.aot.build import write_recorded

        with open(store_path) as fh:
            built = json.load(fh)
        report = write_recorded(
            store_path, rec, device="cuda",
            entries={(e["family"], e["sig"]): e for e in built["entries"]},
            workload=dict(built.get("workload", {}), serve_flagship=True),
        )
        flagship["store_entries_added"] = len(rec.entries)
        flagship["store_report"] = {k: report[k] for k in ("entries", "families", "sha")}
        print(json.dumps(dict(phase="aot_build_flagship", recorded=len(rec.entries),
                              entries=report["entries"], skipped=len(report["skipped"]),
                              families=report["families"])), flush=True)
    return dict(
        flagship=flagship,
        revise=serve_revise_churn_phase(cfg, libs),
        mixed=serve_mixed_fleet_phase(cfg, libs),
        drive=serve_fleet_drive_phase(cfg, libs),
    )


# --- slice 13: the graph store, the roofline join, profiling ----------------------

#: the repository root (the working directory of the phase's child processes)
REPO = os.path.dirname(os.path.abspath(__file__))
#: the coldboot children's wall-clock limit
COLDBOOT_CHILD_TIMEOUT_S = 300


def _json_tail(text: str):
    """The JSON document that starts at the first line opening with ``{``."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("{"):
            return json.loads("\n".join(lines[i:]))
    raise ValueError("no JSON document in the output")


def aot_build_phase(tmp):
    """``python -m citizensassemblies_tpu_torch.aot build`` in a child
    process into ``tmp``: every kernel library built (here: loaded, the
    parent built them), the coldboot request served through a real service
    and the bucket lattice swept under the recorder, each recorded graph
    captured once on zero operands, the artifact written. Returns the
    record and the artifact's path."""
    path = os.path.join(tmp, "graph_store.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "citizensassemblies_tpu_torch.aot", "build", "--out", path],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    try:
        report = _json_tail(proc.stdout)
    except ValueError:
        report = {}
    rec = dict(
        phase="aot_build", seconds=seconds, rc=proc.returncode, entries=report.get("entries"),
        families=report.get("families"), skipped=report.get("skipped"),
        libraries=report.get("libraries"), lattice_buckets=report.get("lattice_buckets"),
        requests_served=report.get("requests_served"), record_s=report.get("record_s"),
        capture_check_s=report.get("compile_serialize_s"),
        manifest_cores_recorded=report.get("manifest_cores_recorded"),
        manifest_unwrapped=report.get("manifest_unwrapped"), sha=report.get("sha"),
    )
    rec["ok"] = bool(
        proc.returncode == 0 and (report.get("entries") or 0) > 0 and not report.get("skipped")
        and (report.get("manifest_cores_recorded") or 0) > 0
        and len(report.get("libraries") or {}) == 3
        and any(f.startswith("batch_lp.vmapped[") for f in report.get("families") or [])
    )
    if not rec["ok"]:
        log(proc.stderr[-4000:])
    print(json.dumps(rec), flush=True)
    return rec, path


def coldboot_child(mode: str, path: str, t_spawn: str) -> int:
    """One coldboot child (``chip_smoke.py --coldboot-child MODE PATH T``):
    a ``SelectionService`` booted with the graph store (``cached``) or with
    ``aot_cache=False`` (``cold``) serves ``COLDBOOT_SPEC``, then the
    flagship at the defaults. Prints one JSON line: the seconds from the
    parent's spawn to the first result, each serve window's captures,
    library builds and store misses, the ``aot`` stamp, the peak device
    bytes and both allocations."""
    import torch

    if not torch.cuda.is_available():
        return 2
    t0 = float(t_spawn)
    from citizensassemblies_tpu_torch.aot.build import coldboot_config, flagship_instance
    from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
    from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.guards import one_time_work

    t_import = time.time() - t0
    cfg = default_config().replace(aot_cache=(mode == "cached") or False, aot_cache_path=path)
    windows = []
    with SelectionService(cfg, device="cuda") as svc:
        t_boot = time.time() - t0
        stamp0 = svc.aot_store.stamp() if svc.aot_store is not None else {}
        results = []
        for name, req in (
            ("coldboot", SelectionRequest(instance=flagship_instance(), tenant="coldboot",
                                          cfg=coldboot_config(cfg))),
            ("flagship", SelectionRequest(instance=sf_e_skewed_instance(seed=1), tenant="flagship")),
        ):
            work0 = one_time_work()
            miss0 = svc.aot_store.stamp()["misses"] if svc.aot_store is not None else 0
            w0 = time.time()
            res = svc.run(req, timeout=COLDBOOT_CHILD_TIMEOUT_S)
            work1 = one_time_work()
            windows.append(dict(
                window=name, seconds=time.time() - w0, since_spawn_s=time.time() - t0,
                captures=work1.get("cuda_graph_captures", 0) - work0.get("cuda_graph_captures", 0),
                builds=work1.get("cuda_library_builds", 0) - work0.get("cuda_library_builds", 0),
                misses=(svc.aot_store.stamp()["misses"] - miss0) if svc.aot_store is not None else None,
                contract_ok=res.audit.get("contract_ok"),
            ))
            results.append(res)
        stamp = svc.aot_store.stamp() if svc.aot_store is not None else None
    print(json.dumps(dict(
        mode=mode, import_s=t_import, boot_s=t_boot, first_result_s=windows[0]["since_spawn_s"],
        windows=windows, aot_at_boot=stamp0, aot=stamp,
        peak_bytes=int(torch.cuda.max_memory_allocated()),
        alloc_coldboot=np.asarray(results[0].allocation, np.float64).tolist(),
        alloc_flagship=np.asarray(results[1].allocation, np.float64).tolist(),
    )), flush=True)
    return 0


def coldboot_phase(path, leximin):
    """Two fresh child processes of this script, the store's (``cached``)
    and one with ``aot_cache=False`` (``cold``), each serving
    ``COLDBOOT_SPEC`` and then the flagship at the defaults. Holds both
    flagship allocations bit for bit each other's and the defaults
    flagship's, the coldboot allocations each other's, and the cached
    child's serve-window captures equal to its store misses and at most
    the cold child's."""
    children = {}
    for mode in ("cold", "cached"):
        t_spawn = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--coldboot-child", mode, path,
             repr(t_spawn)],
            cwd=REPO, capture_output=True, text=True, timeout=2 * COLDBOOT_CHILD_TIMEOUT_S,
        )
        try:
            out = json.loads(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            out = {}
            log(proc.stderr[-4000:])
        out["rc"] = proc.returncode
        out["wall_s"] = time.time() - t_spawn
        children[mode] = out
    cold, cached = children["cold"], children["cached"]
    have = all(c.get("rc") == 0 and "alloc_flagship" in c for c in (cold, cached))
    flag_same = have and all(
        np.array_equal(np.asarray(c["alloc_flagship"]), leximin.allocation) for c in (cold, cached)
    )
    coldboot_same = have and np.array_equal(np.asarray(cold["alloc_coldboot"]),
                                            np.asarray(cached["alloc_coldboot"]))
    summary = {}
    for mode, c in children.items():
        summary[mode] = dict(
            rc=c.get("rc"), wall_s=c.get("wall_s"), import_s=c.get("import_s"),
            boot_s=c.get("boot_s"), first_result_s=c.get("first_result_s"),
            windows=c.get("windows"), aot=c.get("aot"), aot_at_boot=c.get("aot_at_boot"),
            peak_bytes=c.get("peak_bytes"),
        )
    rec = dict(phase="coldboot_flagship", children=summary, flagship_bit_identical=flag_same,
               coldboot_bit_identical=coldboot_same)
    rec["ok"] = bool(
        have and flag_same and coldboot_same
        and cached["aot"] and cached["aot"]["status"] == "ok" and cached["aot"]["prewarmed"] > 0
        and cold["aot"] is None
        and all(w["captures"] == w["misses"] for w in cached["windows"])
        and all(a["captures"] <= b["captures"] for a, b in zip(cached["windows"], cold["windows"]))
        and all(w["contract_ok"] for c in (cold, cached) for w in c["windows"])
    )
    print(json.dumps(rec), flush=True)
    return rec


def graph_store_reuse_phase():
    """Stored graphs replayed for a second instance of their signature, on
    the card: for ``batch_lp.vmapped`` (two different small-pool LPs in one
    bucket) and for the fused L2 core (two portfolios of one shape), solve
    A (a capture), then B (a replay of A's graph with B's operands copied
    in, counted a hit), then clear the store and solve B fresh (a capture):
    B must equal B fresh bit for bit."""
    from citizensassemblies_tpu_torch.aot import store as gstore
    from citizensassemblies_tpu_torch.solvers.batch_lp import BatchLP, solve_lp_batch
    from citizensassemblies_tpu_torch.solvers.qp import solve_final_primal_l2
    from citizensassemblies_tpu_torch.utils.config import default_config
    from citizensassemblies_tpu_torch.utils.memo import live_caches

    cfg = default_config().replace(lp_batch=True)

    def clear():
        for cache in live_caches():
            if cache.name == "aot_graphs":
                cache.clear()

    def lp(seed):
        rng = np.random.default_rng(seed)
        return BatchLP(c=rng.uniform(-1, 1, 60), G=rng.uniform(-1, 1, (40, 60)),
                       h=rng.uniform(0.5, 1.5, 40), A=np.ones((1, 60)), b=np.ones(1))

    def l2(seed):
        rng = np.random.default_rng(100 + seed)
        P = np.zeros((1024, 256))
        for row in range(1024):
            P[row, rng.choice(256, 16, replace=False)] = 1.0
        target = P.T @ rng.dirichlet(np.ones(1024))
        return solve_final_primal_l2(P, target, iters=4096, floor_donor=np.full(1024, 1 / 1024),
                                     cfg=cfg, device="cuda")

    def lp_solve(seed):
        sol = solve_lp_batch([lp(seed)], cfg=cfg, defer=False, device="cuda")[0]
        return (sol.x, sol.lam, sol.mu, np.array([sol.iters, sol.kkt]))

    def l2_solve(seed):
        p, eps = l2(seed)
        return (p, np.array([eps]))

    cases = []
    for name, solve in (("batch_lp.vmapped", lp_solve), ("qp.l2_fused", l2_solve)):
        clear()
        store = gstore.ExecStore(sha="graph_store_reuse")
        gstore.install_store(store)
        try:
            a = solve(0)
            after_a = store.stamp()
            b = solve(1)
            after_b = store.stamp()
            clear()
            b_fresh = solve(1)
        finally:
            gstore.install_store(None)
        same = all(np.array_equal(x, y) for x, y in zip(b, b_fresh))
        differs = not all(np.array_equal(x, y) for x, y in zip(a, b))
        cases.append(dict(
            family=name, misses_a=after_a["misses"], hits_b=after_b["hits"] - after_a["hits"],
            misses_b=after_b["misses"] - after_a["misses"], bit_identical=same,
            instances_differ=differs,
        ))
    clear()
    rec = dict(phase="graph_store_reuse", cases=cases)
    rec["ok"] = all(c["bit_identical"] and c["instances_differ"] and c["misses_a"] >= 1
                    and c["hits_b"] >= 1 and c["misses_b"] == 0 for c in cases)
    print(json.dumps(rec), flush=True)
    return rec


def roofline_phase(tracers):
    """``obs/roofline.roofline_join`` over ``serve_flagship``'s sampling
    tracers: no join miss, every achieved share of the card's HBM and
    float32 peaks at most 1, and the kernels' rows the bound formulas of
    the kernels line (``obs/roofline.gather_cost``, ``two_sided_cost``,
    ``lp_cost``) summed over their spans' own shapes."""
    from citizensassemblies_tpu_torch.obs import roofline

    report = roofline.roofline_join(tracers)
    formulas = {
        "kernels.ell_gather": lambda a: roofline.gather_cost(
            a["cols"], a["kp"], a["T"], a["lanes"], a["value_bytes"], a["lane_values"]),
        "kernels.pdhg_megakernel_two_sided": lambda a: roofline.two_sided_cost(
            a["cols"], a["kp"], a["T"], a["nnz"], a["lanes"], a["iters"].resolve(),
            a["check_every"]),  # the iterations the solve took, read back now
        "kernels.pdhg_megakernel_lp": lambda a: roofline.lp_cost(
            a["m1"], a["kp"], a["nv"], a["nnz"], a["iters"], a["check_every"]),
    }
    kernel_rows = {}
    for tracer in tracers:
        for sp in tracer.spans():
            if sp.name in formulas and sp.attrs.get("kind") == "dispatch" and sp.t1 is not None:
                cost = formulas[sp.name](sp.attrs)
                agg = kernel_rows.setdefault(sp.name, [0, 0.0, 0.0])
                agg[0] += 1
                agg[1] += cost.flops
                agg[2] += cost.bytes
    rows = {r.core: r for r in report.rows}
    kernels = {}
    for name, (calls, flops, nbytes) in kernel_rows.items():
        row = rows.get(name)
        kernels[name] = dict(
            calls=calls, row_calls=getattr(row, "calls", None),
            flops_per_call=flops / calls, bytes_per_call=nbytes / calls,
            equal=bool(row is not None and row.calls == calls and row.flops == flops / calls
                       and row.bytes == nbytes / calls),
            bound_ms_per_call=roofline.bound(roofline.Cost(flops / calls, nbytes / calls))[0],
        )
    shares = {r.core: r.peak_shares() for r in report.rows}
    rec = dict(
        phase="roofline_flagship", misses=report.misses, unexecuted=report.unexecuted,
        rows={r.core: dict(calls=r.calls, seconds=r.seconds, gflops_s=r.achieved_gflops_s,
                           gbytes_s=r.achieved_gbytes_s, bound=r.bound, sampled=r.sampled,
                           hbm_share=shares[r.core]["hbm"], f32_share=shares[r.core]["f32"])
              for r in report.rows},
        kernels=kernels, ridge=report.ridge_flops_per_byte,
    )
    rec["ok"] = bool(
        report.ok and not report.misses
        and all(s["hbm"] <= 1.0 and s["f32"] <= 1.0 for s in shares.values())
        and {"kernels.ell_gather", "kernels.pdhg_megakernel_two_sided"} <= set(kernels)
        and all(k["equal"] for k in kernels.values())
    )
    print(json.dumps(rec, default=str), flush=True)
    return rec


def profile_trace_phase(pack, MT, trace_doc):
    """``utils/profiling.profiler_trace`` around one B=1 two-sided solve on
    the flagship pack inside an ``annotate`` range: the exported Chrome
    trace must name the kernel and the range. Then the trace CLI's
    ``main`` on ``serve_flagship``'s exported trace (``--json``)."""
    import contextlib
    import io
    import tempfile

    import torch

    from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
    from citizensassemblies_tpu_torch.obs import __main__ as trace_cli
    from citizensassemblies_tpu_torch.utils.profiling import annotate, profiler_trace

    idx_np, val_np, lanes, kw = _solve_lanes(pack, MT, [6144])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiler_trace(tmp) as prof:
            with annotate("chip_smoke.two_sided_b1"):
                out = mk.dispatch_two_sided(idx_np, val_np, *lanes, **kw)
            torch.cuda.synchronize()
        profile_s = time.perf_counter() - t0
        with open(prof.trace_path) as fh:
            doc = json.load(fh)
        names = [str(e.get("name", "")) for e in doc.get("traceEvents", [])]
        kernel_events = [n for n in names if "two_sided_solve_kernel" in n]
        annotated = "chip_smoke.two_sided_b1" in names
        path = os.path.join(tmp, "serve_flagship.json")
        with open(path, "w") as fh:
            json.dump(trace_doc, fh)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = trace_cli.main([path, "--json"])
        report = json.loads(buf.getvalue())
    rec = dict(
        phase="profile_trace", profile_s=profile_s, trace_events=len(names),
        kernel_events=len(kernel_events), annotated=annotated, iters=int(out[3][0]),
        cli_rc=rc, cli_spans=report.get("spans"), cli_lanes=report.get("lanes"),
        critical_path=[h["name"] for h in report.get("critical_path", [])][:6],
        top_self_ms=sorted(((v["self_ms"], k) for k, v in report.get("self_times", {}).items()),
                           reverse=True)[:5],
    )
    rec["ok"] = bool(kernel_events and annotated and rc == 0 and (report.get("spans") or 0) > 0)
    print(json.dumps(rec), flush=True)
    return rec


# --- slice 14: the lint package on the card ----------------------------------------

#: each kernel library's ``__global__`` functions, as the profiler names them
KERNEL_FUNCTIONS = {
    "ell_gather": ("ell_gather_kernel",),
    "two_sided_block": ("two_sided_solve_kernel",),
    "lp_block": ("lp_solve_kernel",),
}
#: the registry's kernel cores and their libraries
KERNEL_CORES = {
    "kernels.pallas_ell_matvec": "ell_gather",
    "kernels.pdhg_megakernel_two_sided": "two_sided_block",
    "kernels.pdhg_megakernel_lp": "lp_block",
}
#: kernel-name marks of cuBLAS, cuSPARSE and CUTLASS kernels
LIBRARY_KERNEL_MARKS = ("gemm", "gemv", "cublas", "cusparse", "cutlass", "xmma", "splitk")
#: host calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize")
#: phase 14's time limit (seconds)
LINT_CARD_BUDGET_S = 60.0


def _range_events(events, name):
    """``(start, end)`` of the host range ``name`` in a Chrome trace."""
    for e in events:
        if e.get("name") == name and e.get("ph") == "X" and e.get("cat") in (
                "user_annotation", "cpu_op", "python_function"):
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    return None


def _window_profile(events, span):
    """What a host range launched: the CUDA API calls inside it, the
    syncs among them, the device-to-host copies and the kernels their
    correlation ids name."""
    if span is None:
        return None
    lo, hi = span
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("ph") == "X"
             and lo <= float(e["ts"]) <= hi]
    corr = {e.get("args", {}).get("correlation") for e in calls} - {None}
    on_device = [e for e in events if e.get("args", {}).get("correlation") in corr]
    return dict(
        calls=len(calls),
        syncs=sorted({e["name"] for e in calls if e["name"] in SYNC_CALLS}),
        d2h=sorted({e["name"] for e in on_device if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
                   | {e["name"] for e in calls if e["name"] in ("cudaMemcpy", "cuMemcpyDtoH_v2")}),
        kernels=[e["name"] for e in on_device if e.get("cat") == "kernel"],
    )


def _where(exc) -> str:
    """An exception and the port's innermost frames that raised it."""
    import traceback

    frames = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno}" for f in traceback.extract_tb(exc.__traceback__)
              if "citizensassemblies_tpu_torch" in f.filename]
    return f"{exc!r} at {frames[-3:]}"


def _outputs(out):
    import torch

    from citizensassemblies_tpu_torch.lint.ir import tensor_leaves

    return [t for t in tensor_leaves(out) if isinstance(t, torch.Tensor)]


def lint_card_phase(libs):
    """Phase 14: the AST lint of the port's package, then every registered
    core on the card (see the module docstring). One line with the cores,
    the captures, the failures, the kernel names and the seconds."""
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    from citizensassemblies_tpu_torch.aot import store as gstore
    from citizensassemblies_tpu_torch.lint import lint_paths
    from citizensassemblies_tpu_torch.lint.registry import collect
    from citizensassemblies_tpu_torch.utils.guards import guarded_launch, no_implicit_transfers, one_time_work

    t0 = time.perf_counter()
    report = lint_paths([Path(REPO) / "citizensassemblies_tpu_torch"], root=Path(REPO))
    lint_s = time.perf_counter() - t0
    had_world = dist.is_initialized()
    failures, cases, warm_s = [], [], {}
    captures0 = one_time_work().get("cuda_graph_captures", 0)
    for entry in collect():
        tc = time.perf_counter()
        try:
            case = entry.build(device="cuda")
            # the op-by-op result (and, for a core without a graph site, its
            # warm-up); a graph core is captured by a second call, outside
            # every window
            eager = _outputs(case.run())
            if case.graph is not None:
                case.run(graph=True)
            torch.cuda.synchronize()
            cases.append((entry.name, case, eager))
        except Exception as exc:  # noqa: BLE001 - reported below
            failures.append(f"{entry.name}: build or run: {_where(exc)}")
        warm_s[entry.name] = round(time.perf_counter() - tc, 3)
    captures = one_time_work().get("cuda_graph_captures", 0) - captures0
    rows = {}
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for name, case, eager in cases:
                before = {lib.name: lib.launches for lib in libs}
                try:
                    with no_implicit_transfers(mode="disallow"), guarded_launch("cuda"):
                        with record_function(f"lint_card:{name}"):
                            got = _outputs(case.run(graph=True) if case.graph else case.run())
                except Exception as exc:  # noqa: BLE001 - a sync raises in the window
                    failures.append(f"{name}: in the armed window: {_where(exc)}")
                    continue
                rows[name] = dict(
                    launches={lib.name: lib.launches - before[lib.name] for lib in libs},
                    replay_bitwise=(all(torch.equal(a, b) for a, b in zip(got, eager))
                                    and len(got) == len(eager)) if case.graph else None,
                    results=got,
                )
            torch.cuda.synchronize()
        path = os.path.join(tmp, "lint_card.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    profile_s = time.perf_counter() - t1
    if not had_world and dist.is_initialized():
        from citizensassemblies_tpu_torch.dist import runtime

        runtime.shutdown()
    runtime_events = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    kernel_names = {}
    for name, row in rows.items():
        seen = _window_profile(events, _range_events(events, f"lint_card:{name}"))
        if seen is None:
            failures.append(f"{name}: its range is not in the profiler trace")
            continue
        if seen["syncs"] or seen["d2h"]:
            failures.append(f"{name}: host syncs {seen['syncs']} / device-to-host copies {seen['d2h']}")
        if row["replay_bitwise"] is False:
            failures.append(f"{name}: the replay is not bit for bit the op-by-op result")
        lib = KERNEL_CORES.get(name)
        if lib is not None:
            for other, fns in KERNEL_FUNCTIONS.items():
                traced = sum(1 for k in seen["kernels"] if any(f in k for f in fns))
                if traced != row["launches"][other]:
                    failures.append(f"{name}: {traced} {other} kernels in the trace, "
                                    f"{row['launches'][other]} counted")
            launch = _window_profile(events, _range_events(events, f"{name}.launch")) or seen
            own = [k for k in launch["kernels"] if any(f in k for f in KERNEL_FUNCTIONS[lib])]
            library = [k for k in launch["kernels"] if any(m in k.lower() for m in LIBRARY_KERNEL_MARKS)]
            kernel_names[name] = sorted(set(own))
            if not own or row["launches"][lib] < 1:
                failures.append(f"{name}: its kernel did not launch")
            if library:
                failures.append(f"{name}: library kernels in its launch: {sorted(set(library))[:4]}")
    seconds = time.perf_counter() - t0
    rec = dict(
        phase="lint_card", seconds=seconds, lint_s=lint_s, profile_s=profile_s,
        lint_violations=len(report.violations), lint_suppressed=report.suppressed,
        lint_files=report.files, cores=len(rows), graph_cores=sum(1 for _n, c, _e in cases if c.graph),
        captures=captures, runtime_events=runtime_events, kernel_names=kernel_names,
        kernel_launches={n: rows[n]["launches"] for n in KERNEL_CORES if n in rows},
        slowest_warm_s=sorted(warm_s.items(), key=lambda kv: -kv[1])[:5], failures=failures,
    )
    if not report.ok:
        log("\n".join(v.render() for v in report.violations[:20]))
    rec["ok"] = bool(report.ok and len(rows) == 24 and not failures and runtime_events > 0
                     and seconds <= LINT_CARD_BUDGET_S)
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 2
    try:
        from citizensassemblies_tpu_torch.core.generator import (
            sf_b_skewed_instance,
            sf_e_skewed_instance,
            skewed_instance,
        )
        from citizensassemblies_tpu_torch.kernels import cuda_lib
        from citizensassemblies_tpu_torch.kernels import ell_matvec as em
        from citizensassemblies_tpu_torch.kernels import pdhg_megakernel as mk
        from citizensassemblies_tpu_torch.solvers.sparse_ops import EllPack
        from citizensassemblies_tpu_torch.utils.config import default_config
        from citizensassemblies_tpu_torch.utils.device import resolve_device
    except ImportError as exc:
        log(f"chip_smoke: the port is not importable here ({exc})")
        return 2
    t0 = time.perf_counter()
    libs = [em.KERNEL, mk.KERNEL, mk.LP_KERNEL]
    # every nvcc starts now and compiles while this process starts CUDA and
    # builds the first phases' operands on the host
    building = cuda_lib.start_builds(libs)
    resolve_device("cuda")  # full float32: TF32 off for matmul and cuDNN
    card = card_line()
    log(f"card: {card}")
    # the sharded dual phase's HiGHS reference takes minutes on one CPU
    # core: it runs in a worker process while the card works
    highs_ref = start_highs_reference()
    pack, MT, _ = flagship_pack()
    dual_ops = dual_lp_operands()
    host_s = time.perf_counter() - t0
    cuda_lib.finish_builds(building)
    build_s = time.perf_counter() - t0
    print(json.dumps(dict(phase="build", seconds=build_s, host_work_meanwhile_s=host_s,
                          kernels=[lib.name for lib in libs])), flush=True)
    for lib in libs:
        log(f"--- ptxas report, {lib.name} ---\n{lib.build_log.strip()}")

    gather = gather_phase(pack)
    gather_dual = gather_phase(dual_ops[1], rows=len(dual_ops[1]), label="gather_dual_lp")
    b1, _ = solve_phase(pack, MT, [6144], "two_sided_b1", repeat=True)
    barrier_phase(b1, 5)
    b3, clean = solve_phase(pack, MT, [1536, 3072, 6144], "two_sided_b3_prefix")
    bnan, _ = solve_phase(pack, MT, [1536, 3072, 6144], "two_sided_b3_nan", nan_lane=1, clean=clean)
    screen = polish_screen_phase(MT)
    lp = lp_phase(dual_ops, dual_lp_operands(m1=512))
    barrier_phase(lp, 5, "grid_barrier_lp")
    lp_sf_b = lp_sf_b_phase(dual_lp_operands(m1=1024, pool=sf_b_skewed_instance(seed=1)))

    red = flagship_reduction()
    device_pricing_phase(red)
    fused_screen_phase(red, MT)

    slice_cfg = default_config().replace(
        decomp_device_pricing=False, lp_batch=False, mixed_precision=False
    )
    reference_phase(slice_cfg)

    e2e, _ = flagship_phase(sf_e_skewed_instance(seed=1), slice_cfg, libs)
    # the main path: the flagship at the package's defaults (bf16 operand
    # demotion on, as on any CUDA run)
    defaults_cfg = default_config()
    # every finished LEXIMIN path's profile certificate: host work in
    # worker processes, each started as its path returns
    audits = {}
    e2e_defaults, launches, lex_defaults, face_defaults = defaults_flagship_phase(
        sf_e_skewed_instance(seed=1), defaults_cfg, libs, audits
    )
    # XMIN on the same pool, seeded with that LEXIMIN distribution; its
    # gather launches count with the main path's
    xmin, xmin_dist = xmin_phase(
        sf_e_skewed_instance(seed=1), defaults_cfg, lex_defaults, e2e_defaults["seconds"], libs
    )
    launches["ell_gather"] += xmin["launches"]["ell_gather"]
    launches["ell_gather_bf16"] += xmin["launches"]["ell_gather_bf16"]
    xmin_pack = EllPack.from_rows(xmin_dist.committees.astype(np.float32))
    gather_xmin = gather_phase(xmin_pack, rows=len(xmin_pack), label="gather_xmin")
    gather_bf16 = gather_bf16_phase(xmin_pack)
    hold_cpu, serial_cpu = start_l2_references(xmin_dist, lex_defaults, defaults_cfg)
    hold_card = xmin_l2_hold_card(xmin_dist, lex_defaults)
    # the min-L2 phases' CPU runs take about a minute in their workers: the
    # next phases run meanwhile, and the two L2 phases read them after
    mass = mass_like_phase(defaults_cfg, audits)

    legacy, legacy_alloc = legacy_phase(sf_e_skewed_instance(seed=1))
    agent, agent_dist, agent_cfg = agent_space_phase(
        skewed_instance(n=120, k=12, n_categories=3, seed=1), slice_cfg, "agent_space_skewed_120",
        audits,
    )
    launches["lp_block"] = agent["launches"]["lp_block"]
    l2_serial = l2_serial_phase(xmin_dist, lex_defaults, defaults_cfg, serial_cpu)
    xmin_hold = xmin_l2_hold_phase(hold_card, hold_cpu)
    agent_sf_b = agent_space_budget_phase(sf_b_skewed_instance(seed=1), slice_cfg, "agent_space_sf_b")
    dense_graph = dense_graph_phase(sf_b_skewed_instance(seed=1))
    stage_cg = stage_cg_phase(sf_b_skewed_instance(seed=1), defaults_cfg, "stage_cg_sf_b",
                              STAGE_CG_ACCEPT, audits, rounds=STAGE_CG_ROUNDS)
    stage_cg_pricing = stage_cg_phase(
        skewed_instance(n=80, k=8, n_categories=3, seed=3), defaults_cfg, "stage_cg_pricing_skewed_80",
        STAGE_CG_PRICING_ACCEPT, audits, reference=True,
    )
    # households (queue A item 2): the quotient's masters on the two-sided
    # kernel and the gather, the agent-space route's dual LPs on the LP
    # kernel, XMIN's min-L2 stage on the gather; their launches count with
    # the main path's
    households = households_phases(defaults_cfg, libs, audits)
    for rec in households.values():
        for name, count in rec.get("launches", {}).items():
            launches[name] += count
    # checkpoints and seeded faults (queue A items 4 and 6) at the flagship
    ckpt_face = checkpoint_flagship_phase(
        sf_e_skewed_instance(seed=1), defaults_cfg, lex_defaults, face_defaults
    )
    ckpt_lex = checkpoint_leximin_phase(
        sf_e_skewed_instance(seed=1), defaults_cfg, lex_defaults,
        skewed_instance(n=120, k=12, n_categories=3, seed=1), agent_cfg, agent_dist,
    )
    faults = faults_flagship_phase(sf_e_skewed_instance(seed=1), defaults_cfg, lex_defaults)
    # the analysis layer (queue A item 5) through its CLI: the flagship's
    # LEXIMIN and XMIN passes and the timing harness on the two-sided kernel
    # and the gather; their launches count with the main path's
    analysis = analysis_phases(libs, lex_defaults, xmin_dist)
    for rec in (analysis["flagship"], analysis["example_small"]):
        for name, count in rec["launches"].items():
            launches[name] += count
    # phase 16, the nationwide dual LP: its HiGHS reference in a worker
    # process while the card works; the gather at its pack (the L2 route)
    panels, P_nat, fixed_nat = nationwide_dual_problem()
    nationwide_ref = start_highs_reference((P_nat, fixed_nat))
    gather_nationwide = gather_nationwide_phase(panels, NATIONWIDE_N, pack, xmin_pack)
    # distribution (queue A item 7): the sharded ELL dual LP's local
    # products are gather launches of the main path's, the nationwide dual
    # LPs' (both solves) too, and theirs are the L2 route's launches
    distribution = distribution_phases(libs, lex_defaults, pack, MT, highs_ref, nationwide_ref)
    launches["ell_gather"] += distribution["dual"]["launches"]["ell_gather"]
    launches["ell_gather"] += distribution["dual_nationwide"]["launches"]["ell_gather"]
    launches["ell_gather_l2"] = distribution["dual_nationwide"]["launches"]["ell_gather_l2"]
    # the nationwide kernel solve: one LP kernel launch on the global-x̄ route
    launches["lp_block"] += distribution["dual_nationwide"]["launches"]["lp_block"]
    launches["lp_block_global_x"] = distribution["dual_nationwide"]["launches"]["lp_block_global_x"]
    # the request context, the scenario models and churn (queue A items 1-2):
    # the dropout model's flagship fallback and the deadline run are the
    # main path's LEXIMIN; every phase's launches count with the main path's
    scenarios = scenario_phases(defaults_cfg, libs, lex_defaults)
    for rec in scenarios.values():
        for name, count in rec["launches"].items():
            launches[name] += count
    # the graph store (queue A item 4): its artifact built by the CLI in a
    # child process; serve_flagship then records its full-width signatures
    # into it
    import tempfile

    store_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    store_build, store_path = aot_build_phase(store_dir.name)
    # serving (queue A item 3): the service's two concurrent flagship
    # requests are the main path's LEXIMIN twice; every serving phase's
    # launches count with the main path's
    keep = {}
    serving = serving_phases(defaults_cfg, libs, lex_defaults, legacy_alloc,
                             store_path=store_path if store_build["ok"] else None, keep=keep)
    for rec in serving.values():
        for name, count in rec["launches"].items():
            launches[name] += count
    # phase 13: cold and cached boots in child processes, stored graphs
    # reused across instances, the roofline join of serve_flagship's spans,
    # a profiler trace and the trace CLI
    store_phases = dict(
        build=store_build,
        coldboot=coldboot_phase(store_path, lex_defaults),
        reuse=graph_store_reuse_phase(),
        roofline=roofline_phase(keep.get("tracers", [])),
        profile=profile_trace_phase(pack, MT, keep.get("trace_doc", {"traceEvents": []})),
    )
    store_dir.cleanup()
    # phase 14: the lint package on the port's sources, every registered
    # core on the card under the profiler
    store_phases["lint_card"] = lint_card_phase(libs)
    # phase 15: the profile certificates, collected
    profile_audit_phase(audits, {rec["phase"]: rec for rec in (
        e2e_defaults, mass, agent, stage_cg, stage_cg_pricing, households["n400"],
        households["n1200"])})

    def summary(name, rec, phase_recs, holds):
        return dict(
            name=name, route="cuda", source=f"citizensassemblies_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in phase_recs), ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            passed=all(r["ok"] for r in phase_recs) and all(r["ok"] for r in holds),
        )

    gather_row = summary("ell_gather", gather,
                         [gather, gather_dual, gather_xmin, gather_bf16, gather_nationwide],
                         [households["n1200"], households["xmin"], analysis["flagship"],
                          distribution["dual"], distribution["dual_nationwide"],
                          scenarios["dropout_flagship"], serving["flagship"]])
    # the bf16-value path of the same kernel, at XMIN's demoted pack
    gather_row.update(
        bf16_launches=launches["ell_gather_bf16"], bf16_ms=gather_bf16["ms"],
        bf16_l2_flushed_ms=gather_bf16["l2_flushed_ms"], bf16_plain_ms=gather_bf16["plain_ms"],
        bf16_bound_ms=gather_bf16["bound_ms"], bf16_bitwise_vs_f32=gather_bf16["bitwise_vs_f32"],
    )
    # the L2 route (y beyond a block's shared memory), at the nationwide
    # dual LP's pack
    gather_row.update(
        l2_launches=launches["ell_gather_l2"], l2_ms=gather_nationwide["ms"],
        l2_l2_flushed_ms=gather_nationwide["l2_flushed_ms"],
        l2_bound_ms=gather_nationwide["bound_ms"], l2_plain_ms=gather_nationwide["plain_ms"],
        l2_library_ms=gather_nationwide["library_ms"],
        l2_max_abs_err=gather_nationwide["max_abs_err"],
        l2_shape=gather_nationwide["shape"],
    )
    # the LP kernel, its global-x̄ route at the nationwide dual LP
    nat = distribution["dual_nationwide"]["kernel_check"]
    lp_row = summary("lp_block", lp, [lp, lp_sf_b, nat],
                     [households["agent"], distribution["dual_nationwide"]])
    lp_row.update(
        global_x_launches=launches["lp_block_global_x"], global_x_ms=nat["path_ms"],
        global_x_iters=nat["path_iters"], global_x_bound_ms=nat["bound_ms"],
        global_x_bound_by=nat["bound_by"], global_x_check_iters=nat["check_iters"],
        global_x_check_ms=nat["ms"], global_x_plain_ms=nat["plain_ms"],
        global_x_check_bound_ms=nat["check_bound_ms"], global_x_library_ms=None,
        global_x_max_abs_err=nat["max_abs_err"], global_x_rel_err_by=nat["rel_err_by"],
        global_x_shape=nat["shape"],
        global_x_plan=nat["plan"],
    )
    kernels = [
        gather_row,
        summary("two_sided_block", b1, [b1, b3, bnan, screen],
                [households["hold"], households["n1200"], analysis["flagship"],
                 scenarios["dropout_flagship"], scenarios["deadline"], serving["flagship"]]),
        lp_row,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total seconds: {time.perf_counter() - t0:.1f}")
    print(card, flush=True)
    failed = [
        r for r in (e2e, e2e_defaults, xmin, xmin_hold, l2_serial, mass, legacy, agent, agent_sf_b,
                    dense_graph, stage_cg, stage_cg_pricing, *households.values(), ckpt_face,
                    ckpt_lex, faults, *analysis.values(), *distribution.values(),
                    *scenarios.values(), *serving.values(), *store_phases.values())
        if not r["ok"]
    ]
    if failed:
        # the records again on stderr, whose end is what a caller sees
        for r in failed:
            log(json.dumps(r))
        log(f"chip_smoke: these paths failed their checks: {[r['phase'] for r in failed]}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--coldboot-child":
        sys.exit(coldboot_child(*sys.argv[2:]))
    sys.exit(main())
