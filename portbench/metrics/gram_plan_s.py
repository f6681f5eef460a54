"""``gram_plan_s`` (s), layer "estimator and input handling": the traced
fit's ``rri.gram.plan`` spans summed: the Gram-phase route's plan of the
observed set, from the host COO arrays to the plans, their output-column
layouts and M⊙X on the card (inside ``rri.nmf.plan``). Program spans,
each closed once the card's work is done; ``None`` without them."""

from portbench.core.spans import seconds


def read(run):
    return seconds(run.trace, 'rri.gram.plan')
