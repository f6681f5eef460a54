"""The phase sweep and its kernels (counterpart of :mod:`rri_nmf_tpu.ops`).

- :mod:`rri_nmf_tpu_torch.ops.sweep` — ``SweepConfig``, dtype rules, the
  full objective;
- :mod:`rri_nmf_tpu_torch.ops.dense_kernels` — the dense phase sweep, the
  two CUDA kernel wrappers and their plain twins;
- :mod:`rri_nmf_tpu_torch.ops._build` — builds ``csrc/*.cu`` at first use.
"""

from rri_nmf_tpu_torch.ops.sweep import (  # noqa: F401
    SweepConfig, make_objective, resolve_mixed_dtypes)
