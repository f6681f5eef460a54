"""Runtime checks and tracing hooks (counterpart of
:mod:`rri_nmf_tpu.utils`): ``profiling.trace`` writes a Chrome trace of a
region, and ``profiling.span`` names the ``rri.*`` stages of a fit on
the profiler's timeline at the cost of a flag check when none records."""
