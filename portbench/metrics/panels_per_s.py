"""``panels_per_s`` and ``panels_per_s.<cells>``: accepted LEGACY panels
handed back over the window's seconds, on the host clock (a registry's
lottery draws; the paper's estimator, whose requests also return the
panels' frequencies and pair matrix)."""


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    return sum(r["kept"] for r in run.records) / run.window_s
