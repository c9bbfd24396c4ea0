"""``sampler.step_ms.<cells>``: milliseconds per greedy step of a batch of
chains: the host-clock seconds of the sampler's batches (the traced run
times ``models/legacy.sample_feasible_panels``, whose every batch ends in
its readback, and nothing after it, such as the estimator's pair matrix)
over the steps they drew (batches times k)."""


def read(run):
    timed = [r for r in run.records if "sampler_s" in r]
    steps = sum(r["steps"] for r in timed)
    if not steps:
        return None
    return 1e3 * sum(r["sampler_s"] for r in timed) / steps
