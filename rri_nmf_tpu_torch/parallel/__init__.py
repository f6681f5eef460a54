"""Distribution of the sweeps over a ``torch.distributed`` mesh
(counterpart of :mod:`rri_nmf_tpu.parallel`).

- :mod:`rri_nmf_tpu_torch.parallel.mesh` — ``make_mesh``, the layouts,
  ``shard_problem`` and ``make_sharded_training_step`` (the plain sweep
  on a mesh);
- :mod:`rri_nmf_tpu_torch.parallel.sharded_dense` — the dense phase
  sweep (kernels B1 and B2) on each rank's block;
- :mod:`rri_nmf_tpu_torch.parallel.sharded_masked` — the dense-mask
  sweep (kernels B3 and B4) on each rank's block;
- :mod:`rri_nmf_tpu_torch.parallel.sparse_mesh` — the sparse-X sweeps
  (``torch.sparse.mm`` or the gather kernel, then B1/B2) on each rank's
  block of nonzeros;
- :mod:`rri_nmf_tpu_torch.parallel.masked_sparse_mesh` — the sparse-mask
  O(nnz) sweep on each rank's row block of observations;
- :mod:`rri_nmf_tpu_torch.parallel.masked_gram_mesh` — the sparse-mask
  Gram-phase sweep (the gather kernel) on each rank's row block;
- :mod:`rri_nmf_tpu_torch.parallel.multihost` — the multi-host wiring:
  ``initialize_distributed``, ``make_global_mesh`` (``tp`` within a
  host), ``process_row_block`` and the slab entry points
  (``distribute_dense``, ``distribute_factors``,
  ``distribute_sparse_coo``, ``distribute_masked_coo``), whose blocks and
  pre-built plans ``nmf()`` takes as X, so no rank holds X whole.
"""

from rri_nmf_tpu_torch.parallel.masked_gram_mesh import (
    make_sharded_masked_gram_objective, make_sharded_masked_gram_sweep,
    partition_masked_gram, supports_sharded_masked_gram)
from rri_nmf_tpu_torch.parallel.masked_sparse_mesh import (
    make_sharded_masked_sparse_objective, make_sharded_masked_sparse_sweep,
    partition_masked_coo, supports_sharded_masked_sparse)
from rri_nmf_tpu_torch.parallel.multihost import (
    RankBlock, distribute_dense, distribute_factors, distribute_masked_coo,
    distribute_sparse_coo, initialize_distributed, make_global_mesh,
    process_row_block)
from rri_nmf_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                             make_sharded_training_step,
                                             problem_shardings,
                                             shard_problem)
from rri_nmf_tpu_torch.parallel.sharded_dense import (
    make_sharded_dense_sweep, supports_sharded_dense)
from rri_nmf_tpu_torch.parallel.sharded_masked import (
    make_sharded_masked_sweep, supports_sharded_masked)
from rri_nmf_tpu_torch.parallel.sparse_mesh import (
    make_sharded_mxu_sweep, make_sharded_sparse_objective,
    make_sharded_sparse_sweep, partition_coo, partition_mxu,
    supports_sharded_sparse)

__all__ = ['Mesh', 'make_mesh', 'problem_shardings', 'shard_problem',
           'make_sharded_training_step', 'make_sharded_dense_sweep',
           'supports_sharded_dense', 'make_sharded_masked_sweep',
           'supports_sharded_masked', 'partition_coo', 'partition_mxu',
           'supports_sharded_sparse', 'make_sharded_sparse_sweep',
           'make_sharded_mxu_sweep', 'make_sharded_sparse_objective',
           'partition_masked_coo', 'supports_sharded_masked_sparse',
           'make_sharded_masked_sparse_sweep',
           'make_sharded_masked_sparse_objective', 'partition_masked_gram',
           'supports_sharded_masked_gram', 'make_sharded_masked_gram_sweep',
           'make_sharded_masked_gram_objective', 'RankBlock',
           'initialize_distributed', 'make_global_mesh', 'process_row_block',
           'distribute_dense', 'distribute_factors', 'distribute_sparse_coo',
           'distribute_masked_coo']
