"""The Gram-phase sparse-mask sweep on a mesh: each rank's row block
through the gather kernel, one all-reduce a T-phase, none a W-phase.

Counterpart of :mod:`rri_nmf_tpu.parallel.masked_gram_mesh`. The layout
is the O(nnz) mesh sweep's (:mod:`rri_nmf_tpu_torch.parallel.
masked_sparse_mesh`): a ``(dp, 1)`` mesh, the observations split by
rows, W's rows with them, T whole on every rank. The sweep is
:class:`rri_nmf_tpu_torch.ops.sweep_masked_gram.MaskedGramSweep` with
``cfg.mesh`` set, on this rank's plan (:func:`partition_masked_gram`):

- T-phase: ``A = Wᵀ(M⊙X)`` (k, d) and Γ's k(k+1)/2 unique rows
  ``(w_t ⊙ w_s)ᵀM`` (d each) are column-keyed sums: each rank contracts
  its block (2 gather launches) and one all-reduce over ``dp`` of the
  stacked (k + k(k+1)/2, d) partial makes them whole; the Gauss-Seidel T
  loop then runs the same on every rank. In k-panels: one all-reduce of
  A, then one of each (p·k, d) Γ panel;
- W-phase: ``C = (M⊙X)Tᵀ`` and Θ are row-keyed, so each rank's are its
  own (2 launches) and the phase makes no collective.

A sweep moves ``(k + k(k+1)/2)·d`` numbers per rank (``k·d + k²·d`` in
panels), whatever nnz and n are. DP noise, ``inner_reps``, the
projections, ``fix_T`` and ``fix_W`` run as on one device; a (1, 1) mesh
makes no call and is the single-device sweep, bit for bit.

Each rank holds one unpadded plan of its own rows
(:func:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.plan_masked_gram` of
:func:`~rri_nmf_tpu_torch.parallel.masked_sparse_mesh.row_block`): the
mask's output-column layout of each direction, built from the block's
COO, and M⊙X as the second value set. JAX pads each device's chunk plan
to a common group count and splits it at SMEM segment boundaries
(``_pad_plan_np``, ``_stack_segments``) so one ``pallas_call`` shape
serves every device; here every rank launches the gather kernel on its
own layouts, so neither has a counterpart. A rank that holds only its
row slabs builds the same plan through :func:`~rri_nmf_tpu_torch.
parallel.multihost.distribute_masked_coo` (``backend='segsum'`` or
``'mxu'``): the rows of
:func:`~rri_nmf_tpu_torch.parallel.masked_sparse_mesh.host_rows`, then
:func:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.plan_masked_gram`, the
planning half here too.
"""

import dataclasses

from rri_nmf_tpu_torch.matrixops import fit_device
from rri_nmf_tpu_torch.ops.sweep_masked_gram import (
    make_masked_gram_objective, make_masked_gram_sweep, plan_masked_gram,
    supports_masked_gram)
from rri_nmf_tpu_torch.parallel.masked_sparse_mesh import row_block


def partition_masked_gram(X, W_mat, mesh, dtype, backend=None, device=None):
    """This rank's :class:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.
    MaskedGramPlan` on a ``(dp, 1)`` ``mesh``, built on the host from its
    own row block (shape ``(n_loc, d)``, local rows) and placed on
    ``device`` (default: X's device, the card for host data).
    ``backend=None`` picks ``'mxu'`` on a card and ``'segsum'`` on the
    CPU, as the single-device plan does. Its ``sum_mx2`` is the block's
    own. The counterpart of JAX's ``partition_masked_gram`` for the rank
    that calls it."""
    device = fit_device(X, device)
    return plan_masked_gram(*row_block(X, W_mat, mesh), dtype,
                            backend=backend, device=device)


def supports_sharded_masked_gram(cfg, mesh):
    """Whether the Gram mesh sweep covers ``cfg`` on ``mesh`` (JAX's
    gate): the single-device gate, no per-row ``w_row_sum`` vector, and
    ``tp == 1``."""
    return (supports_masked_gram(cfg) and not cfg.w_row_sum_is_vector
            and mesh.shape[1] == 1)


def make_sharded_masked_gram_sweep(cfg, mesh, backend='segsum', panel=None):
    """``sweep(plan, W, T, draws, resets_left) -> (W, T, resets_left)`` on
    this rank's :func:`partition_masked_gram` plan (of ``backend``), its
    rows of W and the whole T, Γ/Θ in (panel, k, ·) tiles with ``panel``;
    every rank of ``mesh`` calls it with the same ``draws``. A cfg that
    holds another mesh, or one the gate refuses, raises ``ValueError``."""
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument')
    if not supports_sharded_masked_gram(cfg, mesh):
        raise ValueError('config not supported by the masked Gram mesh '
                         'sweep')
    return make_masked_gram_sweep(dataclasses.replace(cfg, mesh=mesh),
                                  backend, panel)


def make_sharded_masked_gram_objective(mesh, backend='segsum', reg_w_l2=0.0,
                                       reg_t_l2=0.0, reg_w_l1=0.0,
                                       reg_t_l1=0.0, panel=None):
    """``objective(plan, W, T) -> 0-d tensor`` through the Gram identity
    on this rank's plan: ``Σ m x²``, the cross term and the quadratic
    term (Θ in (panel, k, n_loc) tiles with ``panel``) are the block's
    own, and one scalar all-reduce over ``dp`` sums them with the W
    terms; the T terms are taken once."""
    return make_masked_gram_objective(backend, reg_w_l2, reg_t_l2, reg_w_l1,
                                      reg_t_l1, panel=panel, mesh=mesh)
