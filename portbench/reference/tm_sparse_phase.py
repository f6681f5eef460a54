"""Plain reference of the topic-model estimator's fast recipe on a corpus
whose dense form does not fit the card: ``tm_phase``'s sweeps from a
start computed on the sparse X.

- The start: NNDSVD of the sparse X from scikit-learn's randomized SVD
  (``rs_sparse_phase.nndsvd``: every product with X through
  ``torch.sparse.mm``), reached through :class:`Corpus`, a view of the
  scipy CSR with what it reads; then T's rows scaled to sum 1, clamped
  and projected onto the simplex, W's rows scaled to sum 1 and clamped,
  as ``tm_interleaved.init`` does on the dense X.
- The sweeps: ``tm_phase.sweep`` (T phase from ``G = WᵀW`` and
  ``N = WᵀX``, W phase from ``G = TTᵀ`` and ``N = TXᵀ``, Gauss-Seidel over
  the topics), the two products with X on its CSR and on that of Xᵀ;
  at the end W's rows projected onto the simplex.

The program reads X through the gather kernel's two output-column
layouts; this reference through ``torch.sparse.mm``. No (n, d) array is
formed. ``Precision('tf32')`` rounds the operands of every product, in
the SVD as in the sweeps (the cell's control); ``'float64'`` is the
reference.
"""

import torch

from portbench.reference.plain import (Precision, normalize_rows,
                                       proj_simplex_rows)
from portbench.reference.rs_sparse_phase import nndsvd
from portbench.reference.tm_phase import sweep


class Corpus(object):
    """The scipy CSR X as ``rs_sparse_phase.randomized_svd`` reads an
    observed set: its ``shape``, a tensor ``x`` on the device it computes
    on, and ``csr(transpose)``, X or Xᵀ as scipy CSR."""

    def __init__(self, X, device):
        self.X = X.tocsr()
        self.shape = self.X.shape
        self.x = torch.zeros(0, device=device)

    def csr(self, transpose=False):
        return self.X.T.tocsr() if transpose else self.X


def init(X, k, random_state, p, device):
    """The estimator's start from the sparse ``X`` (scipy CSR), in p's
    dtype."""
    W, H = nndsvd(Corpus(X, device), k, random_state, p)
    T = proj_simplex_rows(normalize_rows(H).clamp_min(0), 1.0)
    return normalize_rows(W).clamp_min(0), T


def fit(inputs, config, preset, random_state, device, precision='float64'):
    """The fit of ``inputs = (X,)`` (scipy CSR): ``dict(W, T, sweeps)``."""
    p = Precision(precision)
    k = int(config['k'])
    W, T = init(inputs[0], k, random_state, p, device)
    X = (p.sparse(inputs[0], device), p.sparse(inputs[0].T, device))
    sweeps = int(preset['max_iter'])
    for _ in range(sweeps):
        W, T = sweep(X, W, T, p)
    return dict(W=proj_simplex_rows(W, 1.0), T=T, sweeps=sweeps)


def gather_counts(nnz, rows, ncols, k, itemsize=4):
    """``(ops, bytes)`` of one gather-kernel contraction (``csrc/sparse.cu``
    ``gather_kernel``): ``k`` output rows over ``ncols`` columns from
    ``nnz`` nonzeros, each gathering one of the factor's ``rows`` rows.
    Operations: ``2·nnz·k`` (a product and a sum per nonzero and output
    row). Bytes, each once: the nonzeros' values and 4-byte gather
    indices, the column pointers, the factor's rows and the output."""
    return (2 * nnz * k,
            nnz * (itemsize + 4) + (ncols + 1) * 4
            + (rows + ncols) * k * itemsize)


def sweep_counts(config, preset, inputs):
    """``(ops, bytes)`` a sweep needs on the sparse ``inputs = (X,)``:
    the two contractions ``WᵀX`` and ``TXᵀ`` (:func:`gather_counts`,
    2·nnz·k operations each), the two Grams (2·k²·(n + d)) and the
    Gauss-Seidel passes over both panels with their simplex projection
    (B2) and clamps (B1) (2·k²·(n + d)); the panel a phase updates read
    and written once (T in the T phase, W in the W phase)."""
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    nnz = int(inputs[0].nnz)
    wtx = gather_counts(nnz, n, d, k)
    xtt = gather_counts(nnz, d, n, k)
    ops = wtx[0] + xtt[0] + 4 * k * k * (n + d)
    nbytes = wtx[1] + xtt[1] + 2 * (n * k + k * d) * 4
    return ops, nbytes
