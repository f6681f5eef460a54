"""``sweep_idle_pct.rs``: ``metrics/sweep_idle_pct.py`` read in the
recommender's cell, where it moves ``fit_s.rs``. The recommender's fit
is paced by the host and spreads across processes several times wider
than a topic-model fit, so its end-to-end metric and bound are its own
and the topic-model cells keep theirs; these readers go once one bound
holds every cell."""

from portbench.core.spec import load_module


def read(run):
    return load_module('metrics', 'sweep_idle_pct', run.cell.base).read(run)
