#!/usr/bin/env python3
"""Time builds of the sparse gather kernel (``csrc/sparse.cu``) against
each other and against ``torch.sparse.mm`` on one card, in turns.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_sparse_kernel.py [--dtype float32] [--baseline DIR]
        [--variants default,u8] [--ks 128] [--runs 7] [--tm]

Each build compiles ``sparse.cu`` with ``nvcc`` into its own library under
``build/bench_sparse/``, all at once, and calls its
``rri_sparse_gather_<dtype>`` (``--dtype``: float32, bfloat16 or
float16): ``current/<variant>`` from the package's source with the
variant's ``-D`` flags (:data:`VARIANTS`: the 16-byte loads in flight a
lane of the 16-bit builds, ``SG_U16``), and
``baseline`` from ``DIR/sparse.cu`` with ``DIR/storage.cuh`` (e.g. an
earlier commit's ``rri_nmf_tpu_torch/csrc``, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), which must have
the gather kernel's interface.

Cases: ``chip_smoke.py``'s sparse configuration, 50,000×30,000 at 0.5%,
at each k of ``--ks``, both directions; with ``--tm`` also the TM corpus
as CSR (11,314×26,214, Zipf word columns, k=50). The factor, the plan's
values and the CSR X are in ``--dtype``. Per case and direction it
prints one JSON line for each of: every build's kernel alone (layout and
factor rows ready); the sweep's call through the package
(``contract_wtx``/``contract_xtt``: the factor-row copy, the checks and
the launch); that copy alone (``sparse_kernels._rows``, nothing when W's
rows are 16-byte multiples); and ``torch.sparse.mm`` of the CSR X (or
Xᵀ) by the factor in ``--dtype`` (or the error by which it refuses that
dtype). Each line has the median and all CUDA-event ms of one call (in
turns, forward then backward), and, but for the copy, the max abs
difference from the twin (``sparse_kernels.gather_contract_ref`` on the
card) relative to the output's largest entry and the L2 gather rate
(nnz·k·itemsize bytes over the time); a build's line also says whether
two launches gave the same bits and whether its output equals the first
build's (``baseline`` where given) bit for bit. Per case it prints the
plan's build seconds (its two layouts, from X's COO on the card) and
the layouts' megabytes, then one summary line. Each build's
``-Xptxas -v`` lines are printed first.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from rri_nmf_tpu_torch.ops import _build  # noqa: E402
from rri_nmf_tpu_torch.ops import sparse_kernels as sk  # noqa: E402
from rri_nmf_tpu_torch.ops import sparse_plan as spl  # noqa: E402

OUT_DIR = REPO / 'build' / 'bench_sparse'
# -D builds of the package's source: the 16-bit builds at float32's
# depth of pieces in flight a lane
VARIANTS = {
    'default': [],
    'u8': ['-DSG_U16=8'],
}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float16': torch.float16}


def build(builds, dtype):
    """Each ``{name: (source dir, extra nvcc flags)}`` into
    ``lib<name>.so``, every nvcc process at once; {name: its
    ``rri_sparse_gather_<dtype>`` launcher}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    entry = 'rri_sparse_gather_' + _build.SUFFIX[dtype]
    jobs = {}
    for name, (src_dir, flags) in builds.items():
        lib = OUT_DIR / ('lib%s.so' % name.replace('/', '_'))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, '-Xptxas=-v',
               '-shared', '-o', str(lib), str(Path(src_dir) / 'sparse.cu')]
        jobs[name] = (cmd, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (cmd, lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd), err))
        ptxas = [ln for ln in err.splitlines() if 'registers' in ln
                 or 'spill' in ln or 'Compiling entry' in ln]
        print(json.dumps({'build': name, 'flags': cmd[len(
            _build.NVCC_FLAGS) + 1:-5], 'ptxas': ptxas}), flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def gather(fn, lay, rows, out):
    """One launch of a build's kernel on a layout and factor rows."""
    k, ncols = out.shape
    err = fn(rows.data_ptr(), lay.colptr.data_ptr(), lay.gidx.data_ptr(),
             lay.vals.data_ptr(), out.data_ptr(), k, rows.shape[1], ncols,
             ncols, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('gather launch failed: CUDA error %d' % err)


def time_turns(calls, runs):
    """ms of each ``calls[name]()``, ``runs`` rounds in turns."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in calls}
    order = list(calls)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            calls[name]()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b))
    return ms


def cases(dev, ks, tm):
    """(label, X as CUDA CSR float32, k)."""
    n, d, dens, _ = chip_smoke.SPARSE_SHAPE
    X = chip_smoke.sparse_csr(n, d, dens, dev, seed=0)
    out = [('%dx%d %.1f%% k=%d' % (n, d, 100 * dens, k), X, k) for k in ks]
    if tm:
        n_train, _, n_words, k_tm = chip_smoke.TM_SHAPE
        counts = chip_smoke.zipf_corpus(n_train, n_words, k_tm, seed=0)
        out.append(('TM corpus %dx%d k=%d' % (n_train, n_words, k_tm),
                    torch.as_tensor(counts, device=dev).to_sparse_csr(),
                    k_tm))
    return out


def library(fn):
    """``fn`` and None, or None and the error by which the library
    refuses the dtype."""
    try:
        fn()
        torch.cuda.synchronize()
        return fn, None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, '%s: %s' % (type(e).__name__, str(e).split('\n')[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--dtype', default='float32', choices=list(DTYPES))
    ap.add_argument('--baseline', help='directory with a sparse.cu')
    ap.add_argument('--variants', default='default',
                    help='comma-separated names of VARIANTS')
    ap.add_argument('--ks', default=str(chip_smoke.SPARSE_SHAPE[3]),
                    help='comma-separated k of the 50,000x30,000 case')
    ap.add_argument('--runs', type=int, default=7)
    ap.add_argument('--tm', action='store_true',
                    help='also the TM corpus (k=50)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_sparse_kernel.py: no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device('cuda', 0)
    dt = DTYPES[args.dtype]
    size = torch.empty(0, dtype=dt).element_size()
    srcs = {'current/' + v: (_build.CSRC_DIR, VARIANTS[v])
            for v in args.variants.split(',')}
    if args.baseline:
        srcs = dict({'baseline': (args.baseline, [])}, **srcs)
    builds = build(srcs, dt)
    first = next(iter(builds))
    ks = [int(k) for k in args.ks.split(',')]
    summary = {}
    for label, X, k in cases(dev, ks, args.tm):
        nn, dd = X.shape
        nnz = int(X.values().numel())
        rng = np.random.RandomState(2)
        W = torch.as_tensor(rng.rand(nn, k), dtype=torch.float32,
                            device=dev).to(dt)
        T = torch.as_tensor(rng.rand(k, dd), dtype=torch.float32,
                            device=dev).to(dt)
        t0 = time.perf_counter()
        plan = spl.plan_sparse_matrix(X, dt, device=dev)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        X16 = X.to(dt)
        Xtc = X16.t().to_sparse_csr()
        Tt = T.T.contiguous()
        for dirn, Ft, direction, wrapper, lib_call in (
                ('WtX', W, plan.t_phase, lambda: sk.contract_wtx(plan, W),
                 lambda: torch.sparse.mm(Xtc, W)),
                ('TXt', T.T, plan.w_phase, lambda: sk.contract_xtt(plan, T),
                 lambda: torch.sparse.mm(X16, Tt))):
            lay = direction
            rows = sk._rows(Ft, k)
            ncols = dd if dirn == 'WtX' else nn
            outs = {name: torch.empty(k, ncols, device=dev)
                    for name in builds}
            calls = {name: (lambda fn=fn, out=outs[name]:
                            gather(fn, lay, rows, out))
                     for name, fn in builds.items()}
            calls['contract (package)'] = wrapper
            calls['rows copy'] = lambda: sk._rows(Ft, k)
            lib_call, refused = library(lib_call)
            if lib_call is not None:
                calls['torch.sparse.mm'] = lib_call
            ms = time_turns(calls, args.runs)
            twin = sk.gather_contract_ref(lay, Ft, k, ncols)
            scale = float(twin.abs().max())
            for name in calls:
                line = {'case': label, 'direction': dirn, 'call': name,
                        'dtype': args.dtype, 'nnz': nnz, 'k': k, 'card': smi,
                        'ms': float(np.median(ms[name])), 'all_ms': ms[name]}
                if name in builds:
                    again = torch.empty_like(outs[name])
                    gather(builds[name], lay, rows, again)
                    torch.cuda.synchronize()
                    got = outs[name]
                    line['bitwise_repeat'] = bool(torch.equal(got, again))
                    line['equal_to_' + first] = bool(
                        torch.equal(got, outs[first]))
                elif name == 'torch.sparse.mm':
                    got = lib_call().T.float()
                elif name == 'contract (package)':
                    got = wrapper()
                else:
                    got = None
                if got is not None:
                    line['rel_err_vs_twin'] = float(
                        (got - twin).abs().max()) / scale
                    line['gather_TB_per_s'] = (nnz * k * size / line['ms']
                                               / 1e9)
                summary['%s %s %s' % (label, dirn, name)] = line['ms']
                print(json.dumps(line), flush=True)
            if refused:
                print(json.dumps({'case': label, 'direction': dirn,
                                  'call': 'torch.sparse.mm',
                                  'dtype': args.dtype, 'refused': refused}),
                      flush=True)
            del calls, outs, twin
        print(json.dumps({
            'case': label, 'plan_build_s': plan_s,
            'layout_MB': {dirn: d.nbytes / 1e6
                          for dirn, d in (('WtX', plan.t_phase),
                                          ('TXt', plan.w_phase))}}),
            flush=True)
        del plan, X16, Xtc
    print(json.dumps({'card': smi, 'dtype': args.dtype,
                      'median_ms': summary}), flush=True)


if __name__ == '__main__':
    os.chdir(REPO)
    main()
