"""``gram_contract_idle_pct`` (%), layer "sweep": the share of the traced
fit's ``rri.gram.contract`` spans (each contraction of the Gram-phase
sweep and its objective: A, C, and every Γ and Θ panel) in which no
device operation runs. Program spans on the device trace's clock;
``None`` without them or without device operations."""

from portbench.core.spans import idle_share


def read(run):
    return idle_share(run.trace, 'rri.gram.contract')
