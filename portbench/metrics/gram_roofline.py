"""``gram_roofline`` (%), layer "kernels": the Gram kernel
(``csrc/gram.cu``, ``gram_kernel``) in the traced fit: the least time of
its launches over their device time by kernel name.

Launch i of a contraction round takes the rows of the program's Γ/Θ
split at the cell's shape (``reference/rs_sparse_phase.gram_panels``),
in order: a round is one Γ or Θ contraction, its panels one after
another. Its least time is the larger of ``2·rows·nnz`` operations at
the dtype's peak and the bytes of the lighter direction (Γ: W's n rows
into d columns; Θ: Tᵀ's d rows into n columns) at the memory rate
(``gram_counts``), so no launch is given more than its own bound. A
trace whose launches are not whole rounds reads ``None``."""

from portbench.core.roofline import bound


def read(run):
    tr = run.trace
    if tr is None:
        return None
    c, s = tr.matching(('gram_kernel',))
    if c == 0 or s <= 0:
        return None
    cfg = run.cell.config
    ref = run.cell.module('reference', 'rs_sparse_phase')
    n, d, k = run.cell.shape
    item = 8 if cfg['dtype'] == 'float64' else 4
    panels = ref.gram_panels(k, n, d, item)
    if c % len(panels):
        return None
    nnz = len(run.inputs[1])
    least = 0.0
    for rows in panels:
        ops, gamma = ref.gram_counts(rows, n, d, nnz, k, item)
        theta = ref.gram_counts(rows, d, n, nnz, k, item)[1]
        least += bound(ops, min(gamma, theta), cfg['dtype'])[0]
    return 100.0 * least * (c // len(panels)) / s
