"""``device_idle_pct.<cells>``: the card's idle share of the traced window,
in percent: 100 less the union of the intervals in which an operation ran
on the device, from the profiler's trace."""


def read(run):
    tr = run.device_trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
