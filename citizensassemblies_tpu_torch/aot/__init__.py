"""The graph store: the port's counterpart of the JAX package's AOT cache.

Build (``python -m citizensassemblies_tpu_torch.aot build``) records every
graph-replayed core at its service shapes and writes a versioned JSON
artifact; :func:`boot` loads it at process start, loads the kernel
libraries it names and captures its graphs, so the first request pays for
no capture. See ``store.py`` for the serving contract (tri-state
``Config.aot_cache``, counted fallbacks, never a crash) and ``build.py``
for coverage.
"""

from citizensassemblies_tpu_torch.aot.store import (  # noqa: F401
    ExecStore,
    GraphEntry,
    Recorder,
    SeededGraph,
    active_store,
    call_signature,
    install_recorder,
    install_store,
    load_store,
    note_eager,
    platform_fingerprint,
    register_block,
    resolve_cache_path,
    save_artifact,
)


def boot(cfg=None, path=None, device=None):
    """Load the artifact per ``Config.aot_cache`` and install it.

    * ``None`` (default) — load if an artifact exists, else boot cold;
    * ``True`` — required: a missing, unreadable or mismatched artifact
      raises;
    * ``False`` — nothing is loaded or installed.

    A loaded store's kernel libraries are loaded and, unless
    ``Config.aot_prewarm`` is ``False``, every recorded graph entry is
    captured on zero operands on ``device``. Returns the installed
    :class:`~.store.ExecStore` (or ``None``).
    """
    from citizensassemblies_tpu_torch.utils.device import resolve_device

    mode = getattr(cfg, "aot_cache", None) if cfg is not None else None
    if mode is False:
        return None
    dev = resolve_device(device)
    store = load_store(path=path, cfg=cfg, require=(mode is True), device=dev)
    if store is None:
        return None
    install_store(store)
    if store.status == "ok":
        if dev.type == "cuda":
            store.load_libraries()
        if getattr(cfg, "aot_prewarm", None) is not False:
            store.prewarm(device=dev)
    return store
