"""The sweeps and their kernels (counterpart of :mod:`rri_nmf_tpu.ops`).

- :mod:`rri_nmf_tpu_torch.ops.sweep` — ``SweepConfig``, dtype rules, the
  full objective (plain, masked or row-weighted), the topic resets and
  the plain sweep
  (``make_sweep``: the interleaved order, the Gram-blocked phase form,
  DP noise, gradient stores);
- :mod:`rri_nmf_tpu_torch.ops.spmv` — a dense X's nonzeros in CSR, the
  wrapper of the SpMV kernel the interleaved W side reads them through
  and its plain twin;
- :mod:`rri_nmf_tpu_torch.ops.dense_kernels` — the dense phase sweep
  (with resets: ``DenseResetSweep``), the wrappers of kernels B1 and B2
  and their plain twins;
- :mod:`rri_nmf_tpu_torch.ops.masked_kernels` — the masked WRRI sweep,
  the wrappers of kernels B3 and B4 and their plain twins;
- :mod:`rri_nmf_tpu_torch.ops.sweep_sparse` — the sparse-X phase sweep
  (the dense phase sweep with sparse numerator products) and its
  objective;
- :mod:`rri_nmf_tpu_torch.ops.sparse_plan` — a sparse X (or a sparse
  mask) as the gather kernel's output-column layouts, built from its COO
  on the device;
- :mod:`rri_nmf_tpu_torch.ops.sparse_kernels` — the wrappers of the
  gather kernel (JAX's B5 and B6) and the Gram kernel, and their plain
  twins;
- :mod:`rri_nmf_tpu_torch.ops.sweep_masked_sparse` — the sparse-mask
  (O(nnz)) interleaved sweep, its plan and objective;
- :mod:`rri_nmf_tpu_torch.ops.sweep_masked_gram` — the sparse-mask
  Gram-phase sweep (its contractions on the B5 gather kernel), its plan
  and objective;
- :mod:`rri_nmf_tpu_torch.ops.accel` — HER extrapolation around any of
  the sweeps above, and its blockwise residual objective;
- :mod:`rri_nmf_tpu_torch.ops._build` — builds ``csrc/*.cu`` at first use
  and launches its C functions.
"""

from rri_nmf_tpu_torch.ops.sweep import (  # noqa: F401
    SweepConfig, make_objective, resolve_mixed_dtypes)
