"""``input_s`` (s), layer "estimator and input handling": the traced
fit's ``rri.fit.prepare``, ``rri.nmf.input`` and ``rri.nmf.plan`` spans
summed: the estimator's checks, split and mask, the input densified or
planned and copied to the card, and the sweep's set-up. Program spans,
on the device trace's clock; each closes once the card's work is done."""

from portbench.core.spans import seconds


def read(run):
    return seconds(run.trace, 'rri.fit.prepare', 'rri.nmf.input',
                   'rri.nmf.plan')
