"""Distribution of the sweeps over a ``torch.distributed`` mesh
(counterpart of :mod:`rri_nmf_tpu.parallel`).

- :mod:`rri_nmf_tpu_torch.parallel.mesh` — ``make_mesh``, the layouts,
  ``shard_problem`` and ``make_sharded_training_step`` (the plain sweep
  on a mesh);
- :mod:`rri_nmf_tpu_torch.parallel.sharded_dense` — the dense phase
  sweep (kernels B1 and B2) on each rank's block.

The masked, sparse and multi-host mesh forms arrive with ROADMAP
A.12c-f.
"""

from rri_nmf_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                             make_sharded_training_step,
                                             problem_shardings,
                                             shard_problem)
from rri_nmf_tpu_torch.parallel.sharded_dense import (
    make_sharded_dense_sweep, supports_sharded_dense)

__all__ = ['Mesh', 'make_mesh', 'problem_shardings', 'shard_problem',
           'make_sharded_training_step', 'make_sharded_dense_sweep',
           'supports_sharded_dense']
