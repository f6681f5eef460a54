"""One run of one cell: set-up, the measured window of back-to-back
fits, the traced fit (``--trace 1``), the comparison with the plain
reference, and the result line.

Set-up makes the cell's inputs from the seed on the device, then warms
up with one short fit at the cell's shapes (which builds or loads the
kernel library). The window runs whole ``fit`` calls back to back, each
on a fresh estimator with the same inputs and ``random_state``, and
starts no fit after ``seconds``. A fit is timed from the call to ``fit``
until its factors are on the device and synchronized. One of the
window's fits, drawn from the seed, is compared with the reference once
the window has closed, the peak memory has been read and the program's
state has been freed.
"""

import gc
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.core import check
from portbench.core.trace import Trace, from_profiler

# top-level module names no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'rri_nmf_tpu')


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: this
    process's), compared whole: ``rri_nmf_tpu_torch`` is not
    ``rri_nmf_tpu``."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclass
class Fit:
    """One timed fit: its wall time (s), the driver's stamps (s from the
    driver's start after each kept sweep)."""
    wall_s: float
    stamps: List[float]

    @property
    def sweeps(self):
        return len(self.stamps)


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``'s
    ``read(run)``)."""
    cell: object
    setup_s: float
    fits: List[Fit]
    inputs: tuple
    trace: Optional[Trace] = None


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def fit_random_state(config, seed):
    """The estimators' ``random_state``: the configuration's where it
    fixes one, else one drawn from the seed."""
    return int(config.get('random_state', int(seed) % (2 ** 31)))


class Program(object):
    """The system under test: the estimator of the cell's configuration
    from ``rri_nmf_tpu_torch.sklearn_interface``, issued as the cell's
    traffic file says."""

    def __init__(self, cell, random_state, device):
        from rri_nmf_tpu_torch import sklearn_interface
        self.cls = getattr(sklearn_interface, cell.config['estimator'])
        self.cell = cell
        self.random_state = random_state
        self.device = device

    def estimator(self, **over):
        n, d, k = self.cell.shape
        kw = dict(self.cell.traffic.get('params', {}))
        kw.update(over)
        return self.cls(n, d, k, random_state=self.random_state,
                        device=self.device,
                        nmf_kwargs=dict(self.cell.traffic.get('nmf_kwargs',
                                                              {})),
                        **kw)

    def fit(self, inputs, span='portbench.fit', **over):
        """``(estimator, Fit)`` of one fit of ``inputs``."""
        est = self.estimator(**over)
        sync(self.device)
        t0 = time.perf_counter()
        with record_function(span):
            est.fit(*inputs)
            sync(self.device)
        wall = time.perf_counter() - t0
        return est, Fit(wall, [float(s) for s in
                               est.nmf_outputs['iter_cputime']])


def card():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ''
    except (OSError, subprocess.SubprocessError):
        return ''


def run_cell(cell, seed, seconds, trace, device, t_start, log=print):
    """Run ``cell`` once; returns the result dict (keys in print order,
    ``checks`` last) and the compared rows ``[(name, value, limit)]``."""
    cfg = cell.config
    random_state = fit_random_state(cfg, seed)
    program = Program(cell, random_state, device)
    gen = cell.module('gen', cfg['generator'])
    with record_function('portbench.make_inputs'):
        inputs = gen.make(cfg, seed, device)
    sync(device)
    warm = int(cell.traffic.get('warmup_max_iter', 2))
    est, _ = program.fit(inputs, span='portbench.warmup', max_iter=warm)
    del est
    sync(device)
    setup_s = time.perf_counter() - t_start
    log('set-up %.3f s' % setup_s)

    # ---- the measured window
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    pick = random.Random(seed)
    fits, sample = [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        est, rec = program.fit(inputs)
        fits.append(rec)
        if pick.random() * len(fits) < 1.0:
            sample = (est.W, est.T, rec.sweeps,
                      est.nmf_outputs.get('n_resets_remaining'))
        del est
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    walls = sorted(f.wall_s for f in fits)
    log('window %.3f s, %d fits; fit wall min %.4f median %.4f max %.4f s'
        % (window_s, len(fits), walls[0], walls[len(walls) // 2],
           walls[-1]))

    run = Run(cell=cell, setup_s=setup_s, fits=fits, inputs=inputs)
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
        with profile(activities=acts) as prof:
            est, rec = program.fit(inputs, span='portbench.traced_fit')
        del est
        t1 = time.perf_counter()
        run.trace = from_profiler(prof)
        run.trace.sweeps = rec.sweeps
        del prof
        log('trace read in %.3f s' % (time.perf_counter() - t1))

    # ---- the comparison, after the program's state is freed
    W, T, sweeps, resets_left = (sample[0].cpu(), sample[1].cpu(),
                                 sample[2], sample[3])
    del sample
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    preset = cell.workload['reference']
    ref_mod = cell.module('reference', preset['path'])
    t1 = time.perf_counter()
    ref = ref_mod.fit(inputs, cfg, preset, random_state, device)
    log('reference %.3f s' % (time.perf_counter() - t1))
    if resets_left is not None:
        log('compared fit: %d sweeps, resets left %d (reference: %s)'
            % (sweeps, int(resets_left), ref.get('resets_left', '-')))
    found = check.numbers(W, T, sweeps, ref)
    correct, rows = check.judge(found, cell.workload['limits'])

    # ---- the metrics this run reports
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.module('metrics', m['name']).read(run)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': len(fits), 'failed': 0,
              'metrics': metrics, 'device': dev}
    if trace:
        dev['busy_s'] = run.trace.busy_s
        dev['window_s'] = run.trace.window_s
        result['breakdown'] = run.trace.breakdown()
    if device.type == 'cuda':
        result['card'] = card()
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in rows}
    return result, rows
