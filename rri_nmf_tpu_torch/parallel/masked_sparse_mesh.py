"""The sparse-mask O(nnz) sweep on a mesh: each rank's row block of
observations, one all-reduce of a (2, d) buffer a topic.

Counterpart of :mod:`rri_nmf_tpu.parallel.masked_sparse_mesh`. The mesh
is ``(dp, 1)``: the observed set is split by rows, W's rows with it, and
T is whole on every rank (every T-phase quantity is a d-vector). The
sweep is :func:`rri_nmf_tpu_torch.ops.sweep_masked_sparse.
make_masked_sparse_sweep` with ``cfg.mesh`` set, on this rank's plan
(:func:`partition_masked_coo`):

- T-phase: the two column-keyed segment sums ``(w²)ᵀM`` and ``wᵀ(M⊙R)``
  are summed over ``dp`` in one all-reduce of their (2, d) stack; the T
  row is then solved the same on every rank (the DP noise drawn from the
  one seed every rank shares);
- W-phase: row-keyed, local; the carried residual stays with its
  observations.

A sweep moves ``2·k·d`` numbers per rank, whatever nnz is. A (1, 1) mesh
makes no call and is the single-device sweep, bit for bit; the sweep
replays as one CUDA graph where the mesh allows it
(:attr:`~rri_nmf_tpu_torch.parallel.mesh.Mesh.graphable`: NCCL, or one
rank), and runs launch by launch under gloo.

JAX pads every device's block to one length and W to ``n_loc·dp`` ghost
rows (``ShardedMaskedCOO``, ``_host_row_blocks``). Here the row blocks
follow :mod:`rri_nmf_tpu_torch.parallel.mesh` (uneven by
``torch.tensor_split``'s rule) and each rank's plan is the single-device
plan of its own rows, so there is no ghost row and no block padded to
another's length. A rank whose block holds no observation adds zeros.
Resets and a per-row ``w_row_sum`` vector are refused
(:func:`supports_sharded_masked_sparse`), as in JAX. A rank that holds
only its row slabs plans the same rows through
:func:`~rri_nmf_tpu_torch.parallel.multihost.distribute_masked_coo`
(:func:`host_rows`, then the same plan builder).
"""

import dataclasses

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import fit_device
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import (
    host_sparse, make_masked_sparse_objective, make_masked_sparse_sweep,
    plan_masked_coo, supports_masked_sparse)


def host_rows(X, W_mat, r0, r1):
    """Rows ``[r0, r1)`` of ``X`` and of the mask ``W_mat`` as host data
    in the forms :func:`~rri_nmf_tpu_torch.ops.sweep_masked_sparse.
    masked_coo_host_arrays` reads: the mask as scipy CSR; X as scipy CSR
    when sparse, else a numpy array (a dense tensor is sliced where it
    lies before it crosses to the host). The slicing half of the
    partitioners: a rank that holds the whole X and mask cuts its row
    block out of them, a rank that holds only its row slabs
    (:func:`~rri_nmf_tpu_torch.parallel.multihost.distribute_masked_coo`)
    takes them whole, and both plan the rows the same way."""
    rows = slice(r0, r1)
    M = host_sparse(W_mat).tocsr()[rows]
    if isinstance(X, torch.Tensor) and X.layout == torch.strided:
        return X[rows].detach().cpu().numpy(), M
    X = host_sparse(X)
    return (X.tocsr()[rows] if hasattr(X, 'tocsr')
            else np.asarray(X)[rows]), M


def row_block(X, W_mat, mesh):
    """This rank's rows of ``X`` and of the mask ``W_mat`` on a
    ``(dp, 1)`` mesh (:func:`host_rows`). Raises ``ValueError`` for a mesh
    whose ``tp`` is not 1."""
    if mesh.shape[1] != 1:
        raise ValueError('sparse-mask mesh sweeps split the observations '
                         'by row blocks; use a (dp, 1) mesh')
    split = mesh.split(*X.shape)
    return host_rows(X, W_mat, split.r0, split.r1)


def partition_masked_coo(X, W_mat, mesh, dtype, device=None):
    """This rank's observations on a ``(dp, 1)`` ``mesh`` as a
    :class:`~rri_nmf_tpu_torch.ops.sweep_masked_sparse.MaskedCOOPlan`
    of shape ``(n_loc, d)``: local row indices, global column indices,
    rows sorted; the plan
    :func:`~rri_nmf_tpu_torch.ops.sweep_masked_sparse.plan_masked_coo`
    (the planning half) makes of the rank's rows (:func:`row_block`), on
    ``device`` (default: X's device, the card for host data). The
    counterpart of JAX's ``partition_masked_coo`` for the rank that calls
    it."""
    device = fit_device(X, device)
    return plan_masked_coo(*row_block(X, W_mat, mesh), dtype, device=device)


def supports_sharded_masked_sparse(cfg, mesh):
    """Whether the O(nnz) mesh sweep covers ``cfg`` on ``mesh`` (JAX's
    gate): the single-device gate, no resets, no per-row ``w_row_sum``
    vector, and ``tp == 1``."""
    return (supports_masked_sparse(cfg)
            and cfg.reset_topic_method is None
            and not cfg.w_row_sum_is_vector
            and mesh.shape[1] == 1)


def make_sharded_masked_sparse_sweep(cfg, mesh):
    """``sweep(plan, W, T, draws, resets_left) -> (W, T, resets_left)`` on
    this rank's :func:`partition_masked_coo` plan, its rows of W and the
    whole T; every rank of ``mesh`` calls it with the same ``draws``. A
    cfg that holds another mesh, or one the gate refuses, raises
    ``ValueError``."""
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument')
    if not supports_sharded_masked_sparse(cfg, mesh):
        raise ValueError('config not supported by the sparse-mask mesh '
                         'sweep')
    return make_masked_sparse_sweep(dataclasses.replace(cfg, mesh=mesh))


def make_sharded_masked_sparse_objective(mesh, reg_w_l2=0.0, reg_t_l2=0.0,
                                         reg_w_l1=0.0, reg_t_l1=0.0):
    """``objective(plan, W, T) -> 0-d tensor``: ``0.5 Σ_obs m·(x −
    (WT))²`` plus the regularizers, the same on every rank: the rank's
    observed-entry partial and its W terms summed over ``dp``, the T
    terms taken once, in one all-reduce."""
    return make_masked_sparse_objective(reg_w_l2, reg_t_l2, reg_w_l1,
                                        reg_t_l1, mesh=mesh)
