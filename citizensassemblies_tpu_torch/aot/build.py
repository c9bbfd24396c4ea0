"""Build the store's artifact: record the service's shapes, write it.

``build_cache`` produces the artifact :func:`~.store.load_store` boots from.
Coverage comes from the live call sites, recorded through the graph store
(``aot/store.SeededGraph``, ``note_eager``), so the
recorded keys are the signatures the serving path looks up:

1. **Coldboot serve recording** — the coldboot request class
   (:func:`flagship_instance`, :data:`COLDBOOT_SPEC`) driven through a real
   ``SelectionService``, which records the service's shapes: the
   power-of-two LP buckets ``solvers/batch_lp.py`` dispatches for this
   instance family. The ``service`` profile widens the sweep across more
   pool sizes.
2. **Bucket-lattice sweep** — :func:`bucket_lattice_workload` pushes one
   inert all-zero batch through every predicted LP bucket
   (:data:`COLDBOOT_LATTICE`). The same function is the boot prewarm's
   shape list, so the shapes the artifact was built at and the shapes boot
   warms cannot drift.

3. **Manifest walk** — every core of the lint registry
   (``lint/registry.collect``, the JAX package's 24 names) built on the
   device and run once with ``graph=True``: a core whose block goes through
   the graph store (``IRCase.graph``) records that block's signature, as
   the JAX build records every ``aot_seeded`` core; the others (eager
   cores, the kernel cores) are listed in ``manifest_unwrapped``. These
   entries are saved tagged ``manifest``: a boot does not prewarm them.

Every kernel library is built first (``kernels/cuda_lib.build_all``) and
its hashed file name recorded. Each recorded graph entry is captured once
on zero operands before it is written, as the boot will (a failure is
listed under ``skipped``, never a build abort); the collective blocks of
the distributed cores are recorded but never prewarmed.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from citizensassemblies_tpu_torch.aot.store import (
    GRAPHS,
    LIBRARY_FAMILIES,
    ExecStore,
    Recorder,
    install_recorder,
    install_store,
    library_names,
    resolve_cache_path,
    save_artifact,
)

#: the coldboot request class — ``build_cache`` records it and the coldboot
#: phase of ``chip_smoke.py`` serves it (the JAX package's constant)
COLDBOOT_SPEC: Dict[str, int] = {"n": 24, "k": 4, "n_categories": 2, "seed": 0}

#: extra pool sizes the ``service`` profile sweeps (more lattice buckets)
_SERVICE_SWEEP: Tuple[Tuple[int, int], ...] = ((32, 4), (40, 5), (48, 6))

#: the predicted serving lattice: ``(batch, m1, m2, nv)`` power-of-two LP
#: bucket shapes the coldboot request family dispatches at, widened to the
#: neighbouring buckets cross-request batching and quota churn reach (the
#: JAX package's constant). The port solves a bucket's lanes one by one, so
#: the batch dimension sets how many lanes run, not the graph's shape.
COLDBOOT_LATTICE: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 8, 8, 128),
    (2, 8, 8, 128),
    (4, 8, 8, 128),
    (8, 8, 8, 128),
    (8, 8, 8, 256),
    (4, 8, 8, 256),
    (8, 16, 8, 128),
    (4, 16, 8, 128),
    (8, 16, 16, 256),
    (2, 16, 16, 256),
    (8, 8, 8, 64),
    (4, 32, 16, 256),
)

#: wider buckets only the ``service`` profile warms
_LATTICE_SERVICE_EXTRA: Tuple[Tuple[int, int, int, int], ...] = (
    (8, 8, 8, 512),
    (16, 16, 16, 256),
    (8, 32, 16, 512),
    (16, 8, 8, 128),
)

def lattice_points(profile: str = "smoke") -> Tuple[Tuple[int, int, int, int], ...]:
    if profile == "service":
        return COLDBOOT_LATTICE + _LATTICE_SERVICE_EXTRA
    return COLDBOOT_LATTICE


def coldboot_config(base=None):
    """The config the build and the coldboot children run under:
    ``lp_batch=True`` forces the batched LP engine on (its CPU auto-route
    would otherwise take the serial solver, and the store would warm the
    wrong cores)."""
    from citizensassemblies_tpu_torch.utils.config import default_config

    cfg = base if base is not None else default_config()
    return cfg.replace(lp_batch=True)


def bucket_lattice_workload(cfg=None, profile: str = "smoke", device=None) -> Dict[str, Any]:
    """Drive one inert all-zero batch through every predicted LP bucket on
    ``device``. An all-zero instance's KKT residual is zero at the first
    check, so each lane costs one block, which records the bucket's graph
    signature (``batch_lp.vmapped[…]``). ``max_iters`` pins the family to
    the one the LEXIMIN master's pricing batches dispatch."""
    import numpy as np

    from citizensassemblies_tpu_torch.solvers.batch_lp import BatchLP, solve_lp_batch

    cfg = coldboot_config(cfg)
    points = lattice_points(profile)
    t0 = time.time()
    for bsz, m1, m2, nv in points:
        probs = [
            BatchLP(
                c=np.zeros(nv, np.float32),
                G=np.zeros((m1, nv), np.float32),
                h=np.zeros(m1, np.float32),
                A=np.zeros((m2, nv), np.float32),
                b=np.zeros(m2, np.float32),
                tol=1.0,
            )
            for _ in range(bsz)
        ]
        solve_lp_batch(probs, cfg=cfg, defer=False, max_iters=8_192, device=device)
    return {"buckets": len(points), "seconds": round(time.time() - t0, 3)}


def flagship_instance(seed: Optional[int] = None):
    from citizensassemblies_tpu_torch.core.generator import random_instance

    spec = dict(COLDBOOT_SPEC)
    if seed is not None:
        spec["seed"] = seed
    return random_instance(**spec)


def _record_flagship(cfg, profile: str, device) -> int:
    """Serve the coldboot request class through a real service (workers,
    batcher and all) so the recorder sees the serving path's signatures.
    Returns the requests served."""
    from citizensassemblies_tpu_torch.core.generator import random_instance
    from citizensassemblies_tpu_torch.service import SelectionRequest, SelectionService

    specs = [(flagship_instance(), "build0")]
    if profile == "service":
        specs += [
            (random_instance(n=n, k=k, n_categories=2, seed=i), f"build{i % 3}")
            for i, (n, k) in enumerate(_SERVICE_SWEEP, start=1)
        ]
    with SelectionService(cfg.replace(aot_cache=False), device=device) as svc:
        chans = [svc.submit(SelectionRequest(instance=inst, tenant=tenant)) for inst, tenant in specs]
        for ch in chans:
            ch.result(timeout=1200)
    return len(specs)


def record_manifest(rec: Recorder, device) -> Tuple[int, List[str]]:
    """Run every registered core once on ``device`` with ``graph=True``
    under ``rec``: the cores whose block the graph store replays record its
    signature. Returns ``(recorded, unwrapped names)``. A one-rank world a
    distributed core's build function starts is ended here."""
    import torch.distributed as dist

    from citizensassemblies_tpu_torch.lint.registry import build_cases

    had_world = dist.is_initialized()
    recorded, unwrapped = 0, []
    try:
        for name, case in build_cases(device=str(device)):
            before = len(rec.entries)
            if case.graph is not None:
                case.run(graph=True)
            if len(rec.entries) > before:
                recorded += 1
            else:
                unwrapped.append(name)
    finally:
        if not had_world and dist.is_initialized():
            from citizensassemblies_tpu_torch.dist import runtime

            runtime.shutdown()
    return recorded, unwrapped


def build_cache(path: Optional[str] = None, profile: str = "smoke", cfg=None,
                device=None) -> Dict[str, Any]:
    """Build the libraries, record, check each entry captures, save.
    Returns the build report (the JAX package's keys)."""
    import torch

    from citizensassemblies_tpu_torch.kernels import cuda_lib, ell_matvec, pdhg_megakernel
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    cfg = coldboot_config(cfg)
    dev = resolve_device(device)
    path = resolve_cache_path(cfg, path)
    if dev.type == "cuda":
        cuda_lib.build_all([ell_matvec.KERNEL, pdhg_megakernel.KERNEL, pdhg_megakernel.LP_KERNEL])
    # a store installed by an earlier boot in this process would serve
    # graphs during recording: the build records from a clean slate
    install_store(None)
    rec = Recorder()
    install_recorder(rec)
    t0 = time.time()
    try:
        served = _record_flagship(cfg, profile, dev)
        lattice = bucket_lattice_workload(cfg, profile, dev)
        # the manifest walk records under a recorder of its own: its entries
        # are the lint registry's small shapes, which no request dispatches,
        # so they are saved tagged ``manifest`` and a boot does not capture
        # them (a request that meets one captures it then, as a miss)
        manifest = Recorder()
        install_recorder(manifest)
        manifest_recorded, manifest_unwrapped = record_manifest(manifest, dev)
    finally:
        install_recorder(None)
    record_s = time.time() - t0
    report = write_recorded(path, rec, device=dev, workload={"profile": profile},
                            entries={k: dict(e, manifest=True) for k, e in manifest.entries.items()})
    report.update(
        profile=profile,
        requests_served=served,
        manifest_cores_recorded=manifest_recorded,
        manifest_unwrapped=manifest_unwrapped,
        lattice_buckets=lattice["buckets"],
        record_s=round(record_s, 3),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return report


def write_recorded(path: str, rec: Recorder, device=None, workload=None,
                   entries=None) -> Dict[str, Any]:
    """Capture each of the recorder's graph entries once on zero operands
    (a failure is skipped; the manifest walk's entries are kept
    unchecked, as a boot does not capture them), then save them, the eager
    entries and every
    kernel library's hashed name (``entries``: extra recorded entries to
    merge, e.g. an earlier artifact's). Returns the report's
    artifact-side keys."""
    recorded = dict(entries or {})
    recorded.update(rec.entries)
    check = ExecStore(sha="build")
    for e in recorded.values():
        check.add_spec(e)
    before = set(GRAPHS)
    t1 = time.time()
    check.prewarm(device=device)
    # the manifest walk's entries are not prewarmed, so not checked here
    failed = {key for key, e in check._specs.items()
              if e.get("kind") == "graph" and not e.get("manifest") and key not in GRAPHS}
    compile_s = time.time() - t1
    for key in set(GRAPHS) - before:
        # the check's captures are not this process's serving graphs
        GRAPHS.pop(key)
    keep = [e for key, e in sorted(recorded.items()) if key not in failed]
    skipped = [{"family": fam, "sig": sig, "error": "capture failed"} for fam, sig in sorted(failed)]
    libraries = library_names(set(LIBRARY_FAMILIES))
    report = {
        "entries": len(keep),
        "skipped": skipped,
        "families": sorted({e["family"] for e in keep}),
        "compile_serialize_s": round(compile_s, 3),
        "path": os.path.abspath(path),
        "libraries": libraries,
    }
    report["sha"] = save_artifact(path, keep, libraries=libraries,
                                  workload=dict(workload or {}), device=device)
    return report
