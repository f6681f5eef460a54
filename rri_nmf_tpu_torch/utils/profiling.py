"""Tracing hooks (counterpart of :mod:`rri_nmf_tpu.utils.profiling`).

- :func:`trace` — a context manager around ``torch.profiler`` that
  records host and device activity of a region and exports it as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``); its
  docstring lists the ``rri.*`` spans a fit records;
- :func:`span` — a named region on the profiler's timeline
  (``torch.profiler.record_function``) while a profiler records, and a
  shared null context otherwise, so the spans a fit opens cost a flag
  check when no profiler runs;
- :func:`spanned` and :func:`stage` — a function call as a span, and the
  consecutive stage spans inside it, each opening where the last closed.
"""

import contextlib
import functools
import os
import threading

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# what span() returns while no profiler records: one object for every call
_OFF = contextlib.nullcontext()
# the stage span open in this thread's innermost spanned() call
_stages = threading.local()


@contextlib.contextmanager
def trace(logdir):
    """Profile a region: ``with trace('prof'): run_sweeps()`` writes
    ``prof/trace.json`` (a Chrome trace) and yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` tabulate
    the region. The card's activity is recorded when CUDA is available.

    A fit inside the region records its stages as spans, on the same
    clock as the card's kernels:

    - ``rri.fit`` — ``NMF_TM_Estimator.fit_transform`` (and ``fit``),
      ``NMF_RS_Estimator.fit``: the whole estimator fit; inside it
    - ``rri.fit.prepare`` — the estimator's work before ``nmf()``: input
      checks, the recommender's held-out split and its mask, TF-IDF and
      normalization;
    - ``rri.nmf`` — one :func:`rri_nmf_tpu_torch.nmf.nmf` call, whose
      stages follow one another: ``rri.nmf.input`` (the arguments, X
      densified or planned and copied to the device; inside it
      ``rri.sparse.plan``, a sparse X's gather-kernel layouts built from
      its COO on the device), ``rri.nmf.init`` (the initialization),
      ``rri.nmf.plan`` (the sparse-mask plan, the sweep and the objective
      set up), one ``rri.nmf.sweep`` a sweep run
      (kept, or rolled back by the early stop) with ``rri.nmf.score``
      around the objective inside it, an ``rri.nmf.score`` at the top of
      an iteration for the early-stop score, and ``rri.nmf.finish`` (the
      final W projection; the row weights' W refit, whose ``nmf`` call
      nests its own stages);
    - ``rri.sweep.capture`` — inside a sweep, the CUDA graph capture of
      the plain sweep (a fit's second sweep on the card);
    - on the sparse-mask Gram-phase route
      (:mod:`rri_nmf_tpu_torch.ops.sweep_masked_gram`): ``rri.gram.plan``
      inside ``rri.nmf.plan`` (the observed set from the host COO arrays
      to the plans, layouts and values on the device), and inside a
      sweep or its objective ``rri.gram.contract`` (each contraction: A,
      C, Γ and Θ, whole or one panel) and ``rri.gram.topics`` (a phase's
      per-topic Gauss-Seidel loop, or its part over one panel).

    ``rri.fit.prepare``, ``nmf()``'s stages outside its loop and the
    ``rri.gram.*`` spans wait for the device's work before they close, so
    each ends when its device work ended; a sweep span ends at the
    sweep's synchronized stamp."""
    os.makedirs(str(logdir), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(logdir), 'trace.json'))


def _recording():
    """Whether a profiler records on this thread."""
    return torch.autograd._profiler_enabled()


class _Span(object):
    """A ``record_function`` that, on a clean exit, waits for the work of
    its CUDA ``device`` before it closes."""

    __slots__ = ('region', 'device')

    def __init__(self, name, device=None):
        self.region = record_function(name)
        self.device = device

    def __enter__(self):
        self.region.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is None and self.device is not None and \
                    torch.device(self.device).type == 'cuda':
                torch.cuda.synchronize(self.device)
        finally:
            self.region.__exit__(*exc)


def span(name, device=None):
    """``with span('rri.nmf.score'):`` — a region named ``name`` on the
    profiler's timeline while a profiler records; otherwise one shared
    null context, and nothing is built, dispatched or synchronized. With
    a CUDA ``device`` the recorded span closes once that device's work is
    done; give none inside a sweep or a CUDA graph capture, where a
    synchronization is not allowed."""
    if not _recording():
        return _OFF
    return _Span(name, device)


def stage(name=None, device=None):
    """Close the stage span open in the innermost :func:`spanned` call,
    once the work of ``device`` is done, and open ``name`` in its place
    (``None``: open none). Costs a flag check when no profiler records."""
    if not _recording():
        return
    top = getattr(_stages, 'open', None)
    _stages.open = None
    if top is not None:
        top.device = device
        top.__exit__(None, None, None)
    if name is not None:
        _stages.open = _Span(name).__enter__()


def spanned(name):
    """Decorator: each call of the function runs inside ``span(name)``,
    and a :func:`stage` it leaves open closes with it (without waiting on
    a device). Stages of an outer call stay open around a nested one."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            outer = getattr(_stages, 'open', None)
            _stages.open = None
            try:
                with _Span(name):
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        stage()
            finally:
                _stages.open = outer
        return call
    return wrap
