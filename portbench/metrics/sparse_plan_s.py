"""``sparse_plan_s`` (s), layer "estimator and input handling": the
traced fit's ``rri.sparse.plan`` spans summed: a sparse X's two
output-column layouts for the gather kernel, from its COO copied to the
card to the sorted layouts there (inside ``rri.nmf.input``). Program
spans, each closed once the card's work is done; ``None`` without them."""

from portbench.core.spans import seconds


def read(run):
    return seconds(run.trace, 'rri.sparse.plan')
