"""Runtime checks (counterpart of :mod:`rri_nmf_tpu.utils`)."""
