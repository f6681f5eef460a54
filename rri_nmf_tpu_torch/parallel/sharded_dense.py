"""The dense phase sweep on a mesh: kernels B1 and B2 on each rank's
block, four all-reduces of small operands a sweep.

Counterpart of :mod:`rri_nmf_tpu.parallel.sharded_dense`. The sweep is
:func:`rri_nmf_tpu_torch.ops.dense_kernels.make_dense_phase_sweep` with
``cfg.mesh`` set:

- T-phase: ``G = WᵀW`` (k×k) and ``WᵀX`` (k × this rank's columns) are
  summed over ``dp``; B1 (``csrc/gs.cu``) runs on the rank's (k, d_loc)
  T tile. T's columns are independent within the phase, so this is the
  global Gauss-Seidel update restricted to the tile. The TM preset's
  per-topic simplex projection couples a whole row: the numerator and
  factor panels are gathered over ``tp``, B2 (``csrc/tm_proj.cu``) runs
  on the whole (k, d) panel on every ``tp`` rank, and each keeps its
  columns (JAX's semantics).
- W-phase: ``TTᵀ`` (k×k) and ``TXᵀ`` (k × this rank's rows) are summed
  over ``tp``; B1 runs on the rank's W rows.

Nothing proportional to X moves: ``k·d_loc + k·n_loc + 2k²`` numbers a
sweep per rank (``2k·d`` more for the TM preset's gathers). JAX pads X,
W and T to its TPU tiles (BN·dp, BD·tp); the CUDA kernels mask their
ragged edge and a rank's block may be uneven, so nothing is padded here.
The storage modes ride along: an int16-coded X
(:class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX`, its code split
like X and each rank keeping its columns' scales), a bfloat16 X and
16-bit factors run the same sweep.
"""

import dataclasses

import torch

from rri_nmf_tpu_torch.ops.dense_kernels import (_supports_base,
                                                 make_dense_phase_sweep,
                                                 supports_dense_kernels)


def supports_sharded_dense(cfg, d=None, dtype=torch.float32, device=None):
    """Whether the sharded dense sweep covers ``cfg`` (the single-device
    kernels' restrictions: phase order, unmasked, no resets, gradient
    stores or DP noise) for ``dtype`` factors on ``device`` (default: the
    CPU, whose twins have no limit). B2 runs on the panel gathered over
    ``tp``, whose width is the global ``d`` (nothing is padded), so the
    TM preset is budgeted at ``d`` through
    :func:`~rri_nmf_tpu_torch.ops.dense_kernels.tm_proj_fits`; without
    ``d`` it declines, as JAX's does for shape-blind callers."""
    if not _supports_base(cfg):
        return False
    device = torch.device('cpu') if device is None else torch.device(device)
    if cfg.project_T_each_iter and cfg.t_row_sum and not cfg.fix_T \
            and d is None:
        return False
    return supports_dense_kernels(cfg, 1 if d is None else int(d), dtype,
                                  device)


def make_sharded_dense_sweep(cfg, mesh):
    """``sweep(X, W, T, w_row_sum_vec=None) -> (W, T)`` on this rank's
    blocks (:func:`~rri_nmf_tpu_torch.parallel.mesh.shard_problem`), the
    signature of :func:`~rri_nmf_tpu_torch.ops.dense_kernels.
    make_dense_phase_sweep`; every rank of ``mesh`` calls it. A cfg that
    holds another mesh raises ``ValueError``."""
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument')
    if not _supports_base(cfg):
        raise ValueError('config not supported by the sharded dense kernels')
    return make_dense_phase_sweep(dataclasses.replace(cfg, mesh=mesh))
