"""``gather_roofline`` (%), layer "kernels": the gather kernel
(``csrc/sparse.cu``, ``gather_kernel``) in the traced fit of a sparse X's
phase sweep: the least time of its launches over their device time by
kernel name.

A sweep launches it twice, ``WᵀX`` (X's CSC: the d word columns gather
W's n rows) and then ``TXᵀ`` (X's CSR: the n document columns gather
Tᵀ's d rows). Each launch's least time is the larger of its operations
at the dtype's peak and its bytes at the memory rate
(``reference/tm_sparse_phase.gather_counts``: the nonzeros, the factor's
rows and the output, each once). A trace whose launches are not whole
sweeps reads ``None``."""

from portbench.core.roofline import bound


def read(run):
    tr = run.trace
    if tr is None:
        return None
    # the template's name; PyTorch's ``vectorized_gather_kernel`` is not it
    c, s = tr.matching(('void gather_kernel<',))
    if c == 0 or s <= 0 or c % 2:
        return None
    cfg = run.cell.config
    ref = run.cell.module('reference', 'tm_sparse_phase')
    n, d, k = run.cell.shape
    item = 8 if cfg['dtype'] == 'float64' else 4
    nnz = int(run.inputs[0].nnz)
    least = (bound(*ref.gather_counts(nnz, n, d, k, item), cfg['dtype'])[0]
             + bound(*ref.gather_counts(nnz, d, n, k, item),
                     cfg['dtype'])[0])
    return 100.0 * least * (c // 2) / s
