"""The sparse-X phase sweep and its objective.

Counterpart of :mod:`rri_nmf_tpu.ops.sweep_sparse`. In phase order the
sweep touches X through exactly two products, ``WᵀX`` before the T-phase
and ``T Xᵀ`` before the W-phase; everything else works on the small dense
factors. So the sparse sweep is the dense phase sweep
(:func:`rri_nmf_tpu_torch.ops.dense_kernels.make_dense_phase_sweep`,
kernels B1 and B2) with those two products swapped for one of two
backends:

- ``'torch'``: ``torch.sparse.mm`` on a coalesced COO form of X and of
  Xᵀ (:class:`TorchSparseX`); the counterpart of the JAX package's BCOO
  contractions, which are XLA's and no Pallas kernel;
- ``'mxu'``: the gather kernel on the output-column layouts of a
  :class:`~rri_nmf_tpu_torch.ops.sparse_plan.SparsePlan`, built from X's
  COO on the card; the counterpart of JAX's B5 and B6, which
  ``nmf(sparse='mxu')`` and ``'dma'`` both reach.

:func:`to_torch_sparse` (defined in :mod:`rri_nmf_tpu_torch.matrixops`,
whose leaf math needs it too) is the counterpart of ``to_bcoo``. The
objective never forms ``W T``:
``||X - WT||² = ||X||² - 2·Σ_nnz X_ij (W_i · T_j) + tr((WᵀW)(TTᵀ))``.
"""

import torch

from rri_nmf_tpu_torch.matrixops import to_torch_sparse  # noqa: F401
from rri_nmf_tpu_torch.ops import sparse_kernels
from rri_nmf_tpu_torch.ops.dense_kernels import (_supports_base,
                                                 make_dense_phase_sweep)
from rri_nmf_tpu_torch.ops.sparse_plan import SparsePlan


class TorchSparseX(object):
    """X for the ``'torch'`` backend: ``coo``, the coalesced (n, d) COO
    tensor (also the objective's coordinate list), and ``coo_t``, the
    coalesced COO of Xᵀ, so neither product re-sorts X."""

    def __init__(self, coo):
        self.coo = coo
        self.coo_t = coo.t().coalesce()
        self._wide = None

    @property
    def dtype(self):
        return self.coo.dtype

    @property
    def shape(self):
        return self.coo.shape

    def wide(self, acc):
        """``(coo, coo_t)`` with values in ``acc`` (the 16-bit values
        widened once, for the products' float32 sums)."""
        if self.coo.dtype == acc:
            return self.coo, self.coo_t
        if self._wide is None or self._wide[0].dtype != acc:
            self._wide = (self.coo.to(acc), self.coo_t.to(acc))
        return self._wide


def supports_sparse(cfg):
    """Whether the sparse sweep covers ``cfg``: unmasked, phase order, no
    resets, no gradient stores, no DP noise (the JAX gate)."""
    return _supports_base(cfg)


def _torch_wtx(X, W, acc, x_narrow=False):
    return torch.sparse.mm(X.wide(acc)[1], W.to(acc)).T.contiguous()


def _torch_xtt(X, T, acc, x_narrow=False):
    return torch.sparse.mm(X.wide(acc)[0], T.T.to(acc)).T.contiguous()


def _check_plan(X):
    if not isinstance(X, SparsePlan):
        raise TypeError('this sweep takes a SparsePlan, got %s'
                        % type(X).__name__)


def _plan_wtx(X, W, acc, x_narrow=False):
    _check_plan(X)
    return sparse_kernels.contract_wtx(X, W)


def _plan_xtt(X, T, acc, x_narrow=False):
    _check_plan(X)
    return sparse_kernels.contract_xtt(X, T)


def make_sparse_sweep(cfg, backend='torch'):
    """Build ``sweep(X, W, T, w_row_sum_vec=None) -> (W, T)``, one phase
    sweep over a sparse X (:func:`rri_nmf_tpu.ops.sweep_sparse.
    make_sparse_sweep`). ``backend`` picks X's form and the two products:
    ``'torch'`` (a :class:`TorchSparseX`, ``torch.sparse.mm``) or
    ``'mxu'`` (a :class:`~rri_nmf_tpu_torch.ops.sparse_plan.SparsePlan`,
    the gather kernel). The T-phase runs B2 when every T row is projected
    onto the simplex and B1 otherwise; the W-phase runs B1."""
    if not supports_sparse(cfg):
        raise ValueError('config not supported by the sparse sweep')
    if backend == 'torch':
        wtx, xtt = _torch_wtx, _torch_xtt
    elif backend == 'mxu':
        wtx, xtt = _plan_wtx, _plan_xtt
    else:
        raise ValueError("backend must be 'torch' or 'mxu', got %r"
                         % (backend,))
    return make_dense_phase_sweep(cfg, wtx=wtx, xtt=xtt)


def sparse_cross_term(X, W, T, chunk=1 << 18, gather_budget=2 << 30):
    """``Σ_nnz X_ij (W_i · T_j)`` for a coalesced sparse COO ``X`` (n, d),
    W (n, k) and T (k, d), as a 0-d tensor in W's dtype. It gathers one
    factor row per nonzero: past ``gather_budget`` bytes of gather
    temporaries the sum runs over slices of ``chunk`` nonzeros."""
    data = X.values().to(W.dtype)
    rows, cols = X.indices()
    Tt = T.T.contiguous()

    def part(a, b):
        return (data[a:b] * (W[rows[a:b]] * Tt[cols[a:b]]).sum(1)).sum()

    nnz = data.numel()
    if nnz * W.shape[1] * W.element_size() <= gather_budget:
        return part(0, nnz)
    cross = torch.zeros((), dtype=W.dtype, device=W.device)
    for a in range(0, nnz, chunk):
        cross = cross + part(a, a + chunk)
    return cross


def make_sparse_objective(reg_w_l2=0.0, reg_t_l2=0.0, reg_w_l1=0.0,
                          reg_t_l1=0.0, chunk=1 << 18, gather_budget=2 << 30):
    """Build ``objective(X, W, T) -> 0-d tensor``: ``0.5||X - WT||²`` plus
    the four regularizers for a coalesced sparse COO ``X`` (or a
    :class:`TorchSparseX`), without forming ``W T``
    (:func:`rri_nmf_tpu.ops.sweep_sparse.make_sparse_objective`); the
    cross term is :func:`sparse_cross_term`."""

    def objective(X, W, T):
        if isinstance(X, TorchSparseX):
            X = X.coo
        acc = torch.float32 if W.dtype in (torch.bfloat16, torch.float16) \
            else W.dtype
        W = W.to(acc)
        T = T.to(acc)
        x2 = (X.values().to(acc) ** 2).sum()
        cross = sparse_cross_term(X, W, T, chunk, gather_budget)
        wt2 = ((W.T @ W) * (T @ T.T)).sum()    # tr((WᵀW)(TTᵀ)) = ||WT||²
        obj = 0.5 * (x2 - 2.0 * cross + wt2)
        obj = obj + 0.5 * reg_w_l2 * (W ** 2).sum()
        obj = obj + 0.5 * reg_t_l2 * (T ** 2).sum()
        obj = obj + reg_t_l1 * T.abs().sum()
        obj = obj + reg_w_l1 * W.abs().sum()
        return obj

    return objective
