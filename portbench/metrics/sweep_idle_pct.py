"""``sweep_idle_pct`` (%), layer "sweep": the share of the traced fit's
``rri.nmf.sweep`` spans (each sweep run, kept or rolled back, through
its synchronized stamp) in which no device operation runs: what the
host's launches, graph capture and reads cost the card inside a sweep.
Program spans against the device trace."""

from portbench.core.spans import idle_share


def read(run):
    return idle_share(run.trace, 'rri.nmf.sweep')
