"""Non-negative Matrix Factorization by Rank-one Residue Iterations, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch counterpart of the JAX package :mod:`rri_nmf_tpu`, which stays
the reference it is tested against. Module names mirror the JAX package
so a reader finds each counterpart:

- :mod:`rri_nmf_tpu_torch.matrixops`      — projections / normalization / tfidf
- :mod:`rri_nmf_tpu_torch.optimization`   — qf_min subproblem + stopping rules
- :mod:`rri_nmf_tpu_torch.initialization` — NNDSVD family, random inits,
  ``masked_svd_init``
- :mod:`rri_nmf_tpu_torch.nmf`            — the ``nmf()`` entry point (its
  defaults; dense or sparse X in phase order; masked WRRI with a dense
  or a sparse ``W_mat``; row weights, HER extrapolation, checkpoints)
- :mod:`rri_nmf_tpu_torch.checkpoint`     — checkpoint/resume of a fit
- :mod:`rri_nmf_tpu_torch.sklearn_interface` — ``NMF_TM_Estimator``,
  ``NMF_RS_Estimator``
- :mod:`rri_nmf_tpu_torch.ops`            — the sweeps and their kernels
- :mod:`rri_nmf_tpu_torch.parallel`       — the sweeps on a
  ``torch.distributed`` mesh (``make_mesh``, ``nmf(mesh=...)``) and
  across hosts (``initialize_distributed``, ``make_global_mesh``, the
  ``distribute_*`` slab entry points)
- :mod:`rri_nmf_tpu_torch.convert`        — carry fitted numpy state over
- :mod:`rri_nmf_tpu_torch.utils`          — runtime checks, profiling hooks

Device policy (:func:`rri_nmf_tpu_torch.matrixops.fit_device`): the
entry points (``nmf()``, ``initialize_nmf``, the plan builders, both
estimators) run on the card unless asked otherwise. Given ``device=``,
they run there; a tensor keeps its own device; numpy and scipy data go
to the card, and without a card they raise, naming ``device='cpu'``.
The leaf functions of :mod:`rri_nmf_tpu_torch.matrixops` still put numpy
input on the CPU.

Dtype policy (the JAX package's ``nmf._default_float``): the default
float is float64 on the CPU (the parity tests hold the port against JAX
with x64 there) and float32 on CUDA; every entry point's ``dtype=``
overrides it.

float32 matrix products run in full float32 on the card: TF32 is
switched off here, and ``nmf(matmul_precision=...)`` is the one place
that may allow it for a fit
(:func:`rri_nmf_tpu_torch.ops.sweep.precision_scope`).

Importing the package needs neither CUDA, nor ``nvcc``, nor ``triton``:
the kernels are compiled and loaded at their first launch
(:mod:`rri_nmf_tpu_torch.ops._build`).
"""

import torch

from rri_nmf_tpu_torch import matrixops
from rri_nmf_tpu_torch import optimization
from rri_nmf_tpu_torch import initialization
from rri_nmf_tpu_torch import nmf
from rri_nmf_tpu_torch import sklearn_interface
from rri_nmf_tpu_torch.matrixops import default_float

# exact float32 products unless a fit asks otherwise (a TPU's default f32
# dot is one bf16 pass; the port holds the reference's f32 semantics)
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = [
    'nmf', 'initialization', 'optimization', 'matrixops', 'sklearn_interface',
    'default_float',
]

__version__ = '0.1.0'
