"""Plain references that decide ``correct``: NumPy and plain torch only.
Nothing here imports the port, JAX or the JAX package; each
reference works out again, from the pool and the seeds the benchmark hands
both sides, whatever it judges."""
