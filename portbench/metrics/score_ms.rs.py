"""``score_ms.rs`` (ms), layer "sweep": the traced fit's ``rri.nmf.score``
spans summed (the objective after each sweep and the held-out RMSE at
the top of each iteration) over its ``rri.nmf.sweep`` spans: the
recommender's scoring, a sweep's share. Program spans. Read in the
recommender's cell, where it moves ``fit_s.rs``."""

from portbench.core.spans import intervals, seconds


def read(run):
    score = seconds(run.trace, 'rri.nmf.score')
    if score is None:
        return None
    sweeps = len(intervals(run.trace, 'rri.nmf.sweep'))
    return 1e3 * score / sweeps if sweeps else None
