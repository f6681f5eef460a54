#!/usr/bin/env python3
"""Find the density at which the SpMV kernel (``csrc/spmv.cu``) and the
dense GEMV it replaces in the interleaved sweep cross, on one card: the
crossover behind ``ops/spmv.MAX_DENSITY``.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_spmv.py [--shape 11314,26214]
        [--densities 0.0067,0.1,0.3,0.4,0.45,0.5] [--runs 7]

For each density, a uniformly random float32 X of ``--shape`` (the 20
Newsgroups train split's by default) times one ``X @ t`` as the GEMV on
the dense X (``X @ t[:, None]``, as the sweep formed it) and as the
kernel on X's nonzeros, each replayed 50 times as one CUDA graph, as the
sweep's graph launches them, in turns: one JSON line a density with the
median ms of a call, the largest difference of each from the float64
product relative to its largest entry, and the kernel's byte bound.
The kernel's accuracy, its plain twin and ``torch.sparse``'s CSR ``mv``
at the fit's own X are ``chip_smoke.py``'s (phase 15).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rri_nmf_tpu_torch.ops import _build  # noqa: E402
from rri_nmf_tpu_torch.ops import spmv as sp  # noqa: E402

HBM = 3.35e12
REPS = 50


def log(what, **fields):
    print(json.dumps({'what': what, **fields}), flush=True)


def graphed(fn):
    """:data:`REPS` calls of ``fn`` captured as one CUDA graph (warmed up
    on a side stream first): its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    return graph.replay


def time_calls(calls, runs):
    """{name: median ms of one call}, the graphs replayed in turns."""
    replays = {name: graphed(fn) for name, fn in calls.items()}
    torch.cuda.synchronize()
    ms = {name: [] for name in calls}
    for r in range(runs):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replays[name]()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b) / REPS)
    return {name: float(np.median(v)) for name, v in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shape', default='11314,26214')
    ap.add_argument('--densities', default='0.0067,0.1,0.3,0.4,0.45,0.5')
    ap.add_argument('--runs', type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_spmv.py: no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    log('card', smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    _build.load()
    dev = torch.device('cuda', 0)
    n, d = (int(x) for x in args.shape.split(','))
    for dens in (float(x) for x in args.densities.split(',')):
        g = torch.Generator(device=dev).manual_seed(1)
        X = torch.rand(n, d, device=dev, generator=g)
        X *= torch.rand(n, d, device=dev, generator=g) < dens
        t = torch.rand(d, device=dev, generator=g)
        rows = sp.rows_of(X)
        nnz = rows.cols.shape[0]
        want = X.double() @ t.double()
        calls = {'gemv': lambda: X @ t[:, None],
                 'spmv': lambda: sp.spmv(rows, t)}
        gap = {name: float((fn().reshape(-1) - want).abs().max()
                           / want.abs().max().clamp_min(1e-30))
               for name, fn in calls.items()}
        nbytes = 8 * nnz + 4 * (n + 1) + 4 * (d + n)
        log('crossover', shape=[n, d], density=nnz / (n * d), nnz=nnz,
            graph_ms=time_calls(calls, args.runs), gap=gap,
            bound_ms=nbytes / HBM * 1e3)
        del X, rows, want
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
