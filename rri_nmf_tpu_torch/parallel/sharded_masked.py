"""The masked WRRI sweep on a mesh: kernels B3 and B4 on each rank's
block, two all-reduces of small vectors a topic.

Counterpart of :mod:`rri_nmf_tpu.parallel.sharded_pallas`. The sweep is
:func:`rri_nmf_tpu_torch.ops.masked_kernels.make_masked_sweep` with
``cfg.mesh`` set, on this rank's (n_loc, d_loc) blocks of X and the mask
M (split like X) and the residual R it rebuilds from them each sweep:

- T-phase: B3 (``phase_a``) on the local block; its two (d_loc,) sums
  ``wᵀ(M⊙R)`` and ``(w²)ᵀM`` are summed over ``dp`` in one all-reduce,
  and the T solve's l1 norm over ``tp`` when the scale transfer reads it
  (unregularized fits)
  (:func:`~rri_nmf_tpu_torch.optimization.qf_min_vector_c_sharded`);
- W-phase: B4 (``phase_b``) on the local block; its two (n_loc,) sums
  ``(M⊙R)·t`` and ``M·t²`` are summed over ``tp`` in one all-reduce;
- fixed T: B4 alone, with ``w_eff = 0``, as on one device.

The rank-one residual updates are local: the pending ``dw`` lives on
``dp`` and the new T row on ``tp``, so their outer product touches only
this rank's block. A sweep moves at most ``k·(2·d_loc + 2·n_loc + 1)``
numbers per rank and nothing proportional to X. An axis of one rank
makes no collective, so a (1, 1) mesh is the single-device sweep, bit for
bit.

JAX pads X and M to (BN·dp, BD·tp) and masks the padded coordinates
(``row_ok``/``col_ok``) so a negative L1 regularizer gives them no
phantom mass. Here blocks are uneven by ``torch.tensor_split``'s rule
(:mod:`rri_nmf_tpu_torch.parallel.mesh`) and nothing is padded, so no
such coordinate exists and there is nothing to mask.
"""

import dataclasses

from rri_nmf_tpu_torch.ops.masked_kernels import (make_masked_sweep,
                                                  supports_masked_kernels)


def supports_sharded_masked(cfg):
    """Whether the sharded masked sweep covers ``cfg`` (JAX's
    ``supports_sharded_pallas``): the single-device kernels' gate, and
    no per-row W bound vector, no resets in a fixed-T sweep (a mesh reset
    draws a whole column; the plain mesh sweep runs those) and no T-row
    re-projection under ``t_row_sum`` (it needs the whole row)."""
    return (supports_masked_kernels(cfg) and not cfg.w_row_sum_is_vector
            and (not cfg.fix_T or cfg.reset_topic_method is None)
            and not (cfg.project_T_each_iter and cfg.t_row_sum))


def make_sharded_masked_sweep(cfg, mesh):
    """``sweep(X, W, T, M, draws, resets_left) -> (W, T, resets_left)`` on
    this rank's blocks (:func:`~rri_nmf_tpu_torch.parallel.mesh.
    shard_problem`), the signature of :func:`~rri_nmf_tpu_torch.ops.
    masked_kernels.make_masked_sweep`; every rank of ``mesh`` calls it.
    A cfg that holds another mesh, or one the gate refuses, raises
    ``ValueError``."""
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument')
    if not supports_sharded_masked(cfg):
        raise ValueError('config not supported by the sharded masked '
                         'kernels')
    return make_masked_sweep(dataclasses.replace(cfg, mesh=mesh))
