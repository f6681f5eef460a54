"""The sweeps and their kernels (counterpart of :mod:`rri_nmf_tpu.ops`).

- :mod:`rri_nmf_tpu_torch.ops.sweep` — ``SweepConfig``, dtype rules, the
  full objective (plain or masked), the ``'random'`` topic reset;
- :mod:`rri_nmf_tpu_torch.ops.dense_kernels` — the dense phase sweep, the
  wrappers of kernels B1 and B2 and their plain twins;
- :mod:`rri_nmf_tpu_torch.ops.masked_kernels` — the masked WRRI sweep,
  the wrappers of kernels B3 and B4 and their plain twins;
- :mod:`rri_nmf_tpu_torch.ops._build` — builds ``csrc/*.cu`` at first use
  and launches its C functions.
"""

from rri_nmf_tpu_torch.ops.sweep import (  # noqa: F401
    SweepConfig, make_objective, resolve_mixed_dtypes)
