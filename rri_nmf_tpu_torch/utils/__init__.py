"""Runtime checks and profiling hooks (counterpart of
:mod:`rri_nmf_tpu.utils`)."""
