"""``sampler.accept_pct.<cells>``: panels kept over draws attempted, in
percent, from the port's count of draws (``draws_attempted``)."""


def read(run):
    draws = sum(r["draws"] for r in run.records)
    if not draws:
        return None
    return 100.0 * sum(r["kept"] for r in run.records) / draws
