"""``init_s`` (s), layer "init": the traced fit's ``rri.nmf.init`` span,
the initialization alone (NNDSVD on the randomized SVD, or the given
factors' checks), closed once the card's work is done. Program span."""

from portbench.core.spans import seconds


def read(run):
    return seconds(run.trace, 'rri.nmf.init')
