"""The sparse-X phase sweep on a mesh: each rank's block of nonzeros
through ``torch.sparse.mm`` or the gather kernel, then B1 and B2.

Counterpart of :mod:`rri_nmf_tpu.parallel.sparse_mesh`. In phase order
the sweep touches X through two products, ``WᵀX`` (summed over ``dp``)
and ``T Xᵀ`` (summed over ``tp``), and the dense phase sweep on a mesh
(:func:`rri_nmf_tpu_torch.ops.dense_kernels.make_dense_phase_sweep` with
``cfg.mesh``) already all-reduces them and the two Grams. So the sparse
mesh sweep is that sweep on this rank's block:

- ``sparse=True``: the block as a :class:`~rri_nmf_tpu_torch.ops.
  sweep_sparse.TorchSparseX` (:func:`partition_coo`), its products by
  ``torch.sparse.mm``;
- ``sparse='mxu'``: the block planned by :func:`~rri_nmf_tpu_torch.ops.
  sparse_plan.plan_sparse_matrix` (:func:`partition_mxu`), its products
  by the gather kernel (``sparse_kernels.contract_wtx``/
  ``contract_xtt``), two launches a sweep on each rank.

B1 (and B2 for the TM preset on a ``(dp, 1)`` mesh) runs on the rank's
tile as on one device. A rank whose block holds no nonzero contributes
zero products. A T-row sum constraint with ``tp > 1`` raises JAX's
``ValueError`` (:func:`supports_sharded_sparse`).

Blocks follow :mod:`rri_nmf_tpu_torch.parallel.mesh` (uneven by
``torch.tensor_split``'s rule), so JAX's zero-padded (dp, tp, m) grid of
equal blocks (``ShardedCOO``), its per-device plan stacking
(``ShardedMXUPlan``, ``_pad_stack_mxu``, ``_mxu_put``) and its ghost
columns have no counterpart: each rank holds one unpadded block in local
indices. A rank that holds only its row slab plans the same block through
:func:`~rri_nmf_tpu_torch.parallel.multihost.distribute_sparse_coo`
(:func:`block_coo`, then the same plan of the block as here).
"""

import dataclasses

import torch

from rri_nmf_tpu_torch.matrixops import (fit_device, is_scipy_sparse,
                                         to_torch_sparse)
from rri_nmf_tpu_torch.ops.sparse_plan import plan_sparse_matrix
from rri_nmf_tpu_torch.ops.sweep import mesh_sums
from rri_nmf_tpu_torch.ops.sweep_sparse import (TorchSparseX,
                                                make_sparse_sweep,
                                                sparse_cross_term,
                                                supports_sparse)


def block_coo(X, r0, r1, c0, c1, dtype=None, device=None):
    """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of X (scipy sparse, a
    torch COO/CSR tensor, or dense) as a coalesced COO tensor of the
    block's shape in local indices, duplicates summed, on ``device``
    (default: X's own, the CPU for host data), values in ``dtype``
    (default: X's float dtype). The slicing half of the partitioners: a
    rank that holds the whole X cuts its block out of it, a rank that
    holds its row slab (:func:`~rri_nmf_tpu_torch.parallel.multihost.
    distribute_sparse_coo`) cuts its columns, and both plan the block
    the same way (a :class:`~rri_nmf_tpu_torch.ops.sweep_sparse.
    TorchSparseX`, or :func:`~rri_nmf_tpu_torch.ops.sparse_plan.
    plan_sparse_matrix`)."""
    if is_scipy_sparse(X):
        return to_torch_sparse(X.tocsr()[r0:r1, c0:c1], dtype, device)
    coo = to_torch_sparse(X, dtype)
    rows, cols = coo.indices()
    keep = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    idx = torch.stack([rows[keep] - r0, cols[keep] - c0])
    block = torch.sparse_coo_tensor(idx, coo.values()[keep],
                                    (r1 - r0, c1 - c0))
    return (block if device is None else block.to(device)).coalesce()


def partition_coo(X, mesh, dtype=None, device=None):
    """This rank's block of the sparse (n, d) ``X`` as a
    :class:`~rri_nmf_tpu_torch.ops.sweep_sparse.TorchSparseX` in local
    indices (duplicate coordinates summed, scipy's COO semantics), on
    ``device`` (default: X's device, the card for host data), values in
    ``dtype`` (default: X's). The counterpart of JAX's ``partition_coo``
    for the rank that calls it."""
    device = fit_device(X, device)
    s = mesh.split(*X.shape)
    return TorchSparseX(block_coo(X, s.r0, s.r1, s.c0, s.c1, dtype, device))


def partition_mxu(X, mesh, dtype=None, device=None):
    """This rank's block of ``X`` planned for the gather kernel: its
    :class:`~rri_nmf_tpu_torch.ops.sparse_plan.SparsePlan`, built by
    :func:`~rri_nmf_tpu_torch.ops.sparse_plan.plan_sparse_matrix` on
    ``device`` (default: X's device, the card for host data). The
    counterpart of JAX's ``partition_mxu`` for the rank that calls it."""
    device = fit_device(X, device)
    s = mesh.split(*X.shape)
    return plan_sparse_matrix(block_coo(X, s.r0, s.r1, s.c0, s.c1), dtype,
                              device=device)


def supports_sharded_sparse(cfg, mesh):
    """Whether the sparse mesh sweep covers ``cfg`` on ``mesh``: the
    single-device sparse gate, and no T-row sum constraint when the
    columns are split (``tp > 1``), JAX's rule (a T row's simplex
    projection sorts the whole row)."""
    return supports_sparse(cfg) and (
        mesh.shape[1] == 1 or not (cfg.project_T_each_iter
                                   and cfg.t_row_sum))


def _sweep(cfg, mesh, backend):
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument')
    if not supports_sharded_sparse(cfg, mesh):
        raise ValueError('config not supported by the sharded sparse sweep')
    return make_sparse_sweep(dataclasses.replace(cfg, mesh=mesh), backend)


def make_sharded_sparse_sweep(cfg, mesh):
    """``sweep(X, W, T, w_row_sum_vec=None) -> (W, T)`` on this rank's
    :func:`partition_coo` block and blocks of W and T (and of the
    ``w_row_sum`` vector): the products by ``torch.sparse.mm``. Every rank
    of ``mesh`` calls it."""
    return _sweep(cfg, mesh, 'torch')


def make_sharded_mxu_sweep(cfg, mesh):
    """The same sweep on this rank's :func:`partition_mxu` plan: the
    products by the gather kernel."""
    return _sweep(cfg, mesh, 'mxu')


def make_sharded_sparse_objective(mesh, reg_w_l2=0.0, reg_t_l2=0.0,
                                  reg_w_l1=0.0, reg_t_l1=0.0):
    """``objective(X, W, T) -> 0-d tensor``: ``0.5||X - WT||²`` plus the
    four regularizers on this rank's block ``X`` (a coalesced COO tensor
    or a :class:`~rri_nmf_tpu_torch.ops.sweep_sparse.TorchSparseX`) and
    blocks of W and T, the same value on every rank, without forming
    ``WT``: ``||X||² − 2·Σ X_ij (W_i·T_j) + tr((WᵀW)(TTᵀ))`` (JAX's
    identity). ``||X||²`` and the cross term are taken on the block and
    summed over the mesh, ``WᵀW`` over ``dp`` and ``TTᵀ`` over ``tp``."""

    def objective(X, W, T):
        if isinstance(X, TorchSparseX):
            X = X.coo
        acc = torch.float32 if W.dtype in (torch.bfloat16, torch.float16) \
            else W.dtype
        W = W.to(acc)
        T = T.to(acc)
        local = ((X.values().to(acc) ** 2).sum()
                 - 2.0 * sparse_cross_term(X, W, T))
        G = mesh.sum_dp(W.T @ W)
        G2 = mesh.sum_tp(T @ T.T)
        total, (w2, w1), (t2, t1) = mesh_sums(
            mesh, local, ((W ** 2).sum(), W.abs().sum()),
            ((T ** 2).sum(), T.abs().sum()))
        obj = 0.5 * (total + (G * G2).sum())
        obj = obj + 0.5 * reg_w_l2 * w2
        obj = obj + 0.5 * reg_t_l2 * t2
        obj = obj + reg_t_l1 * t1
        obj = obj + reg_w_l1 * w1
        return obj

    return objective
