"""``sweep_ms`` (ms), layer "sweep": (last stamp − first stamp) summed
over the window's fits, over their sweeps after the first. It holds what
the estimator's preset evaluates each sweep (the objective and the
held-out score of the recommender). Host clock, through the driver's
stamps, which follow a synchronization."""


def sweep_s(run):
    span = sum(f.stamps[-1] - f.stamps[0] for f in run.fits if f.stamps)
    count = sum(len(f.stamps) - 1 for f in run.fits if f.stamps)
    return span / count if count > 0 else None


def read(run):
    s = sweep_s(run)
    return None if s is None else s * 1e3
