"""``gram_topics_ms`` (ms a sweep), layer "sweep": the traced fit's
``rri.gram.topics`` spans (each phase's per-topic Gauss-Seidel loop, or
its part over one Γ/Θ panel) summed, over its ``rri.nmf.sweep`` spans:
the host-issued topic loop of the Gram-phase sweep. Program spans, each
closed once the card's work is done; ``None`` without them."""

from portbench.core.spans import intervals, seconds


def read(run):
    topics = seconds(run.trace, 'rri.gram.topics')
    if topics is None:
        return None
    sweeps = len(intervals(run.trace, 'rri.nmf.sweep'))
    return 1e3 * topics / sweeps if sweeps else None
