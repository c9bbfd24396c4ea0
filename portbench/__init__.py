"""The benchmark of ``citizensassemblies_tpu_torch`` on one NVIDIA H100.

Run one cell from the root of a checkout::

    python3 -m portbench.run --workload nationwide_100k.legacy_draws --seed 7 --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``request``
names a request kind in ``requests/``) and ``metrics/<metric>.py``. The yardstick
(pool generators, cost formulas and peaks, the plain references) lives here
too, and none of it imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
