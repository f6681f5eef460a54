"""Tracing and timing hooks (counterpart of
:mod:`rri_nmf_tpu.utils.profiling`).

- :func:`trace` — a context manager around ``torch.profiler`` that
  records host and device activity of a region and exports it as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- :class:`TraceAnnotation` — a named region inside a trace
  (``torch.profiler.record_function``);
- :class:`SweepTimer` — a host-side per-iteration timer shaped like the
  reference's ``iter_cputime``, which synchronizes the device of the
  tensors it is given before it reads the clock (kernel launches return
  before the kernels finish).
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir):
    """Profile a region: ``with trace('prof'): run_sweeps()`` writes
    ``prof/trace.json`` (a Chrome trace) and yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` tabulate
    the region. The card's activity is recorded when CUDA is available."""
    os.makedirs(str(logdir), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(logdir), 'trace.json'))


class TraceAnnotation(record_function):
    """Named region on the profiler timeline:
    ``with TraceAnnotation('sweep3'):``"""


class SweepTimer(object):
    """Per-iteration wall-clock timer.

    Produces a list shaped like the reference's ``iter_cputime``
    (cumulative seconds since construction, ``nmf.py:349,492,516``).
    :meth:`mark` synchronizes the device of the tensors it receives before
    it reads the clock; a bare ``mark()`` records the host clock as it is,
    which after asynchronous launches measures dispatch, not execution."""

    def __init__(self):
        self.start = time.perf_counter()
        self.marks = []

    def mark(self, *sync_tensors):
        """Record an iteration boundary, after waiting for the devices of
        ``sync_tensors`` (CUDA tensors; CPU tensors need no wait)."""
        for dev in {t.device for t in sync_tensors}:
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
        self.marks.append(time.perf_counter() - self.start)
        return self.marks[-1]

    def deltas(self):
        prev = [0.0] + self.marks[:-1]
        return [m - p for m, p in zip(self.marks, prev)]
