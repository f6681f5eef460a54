"""``sweep_mfu_pct`` (%), layer "sweep": the whole sweep's share of the
card's roofline, the least time a sweep could take over ``sweep_ms``.

The least time is the larger of the sweep's operations at the published
peak for the configuration's dtype and its bytes at the memory rate,
counted as the inputs need them whatever implements it (the cell's
reference path's ``sweep_counts``: nonzeros and observed ratings, not a
dense form; the factors read and written once a pass; a pass over the
inputs per topic in the interleaved and masked orders, two a sweep in
phase order)."""

from portbench.core.roofline import bound


def read(run):
    from portbench.core.spec import load_module
    sweep_ms = load_module('metrics', 'sweep_ms', run.cell.base)
    s = sweep_ms.sweep_s(run)
    if not s:
        return None
    preset = run.cell.workload['reference']
    ops, nbytes = run.cell.module('reference', preset['path']).sweep_counts(
        run.cell.config, preset, run.inputs)
    least, _ = bound(ops, nbytes, run.cell.config['dtype'])
    return 100.0 * least / s
