#!/usr/bin/env python3
"""Time kernel B3 (``csrc/masked.cu``, the masked sweep's T-side pass)
against another build of it, with B4 beside it, on one card, in turns;
and the RS sweep of whole checkouts against each other.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_masked_kernels.py [--baseline DIR] [--runs 9]
                                          [--rs-tree ROOT ...]

Each build compiles ``masked.cu`` with ``nvcc`` into its own library under
``build/bench_masked/``: ``current`` from the package's source, and
``baseline`` from ``DIR/masked.cu`` (e.g. an earlier commit's
``rri_nmf_tpu_torch/csrc``, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists). A baseline with the earlier
two-kernel B3 (a ``(2, chunks, d)`` scratch and a second kernel that adds
the chunks, ``chunk_sum_kernel``) is called through that interface.

The case is float32 at ``chip_smoke.py``'s RS shape, 6040×3952: R a
random residual, M the mask of 1M synthetic ratings, numpy seeds. Every
build is first checked against the twin (``masked_kernels.phase_a_ref``
on the card; each sum's error over its sum of absolute terms, R's over
its largest entry) and for the same bits from two launches. Then, over
``--runs`` rounds, in turns (forward, then backward), CUDA-event times
of:

- ``B3 alone <build>``: 10 launches of the build's C entry straight after
  each other (outputs and scratch allocated once, no checks), over 10;
- ``B3 call <build>``: one call as the sweep makes it. For ``current``,
  ``masked_kernels.phase_a`` with ``out=`` (outputs allocated once per
  sweep) and, as ``B3 call current, allocating``, without; for a
  two-kernel baseline, the steps of its wrapper (``check_operands``, the
  scratch and both outputs from ``torch.empty``, one ctypes call);
- ``B4 alone`` and ``B4 call``: the package's B4 the same two ways;
- ``same bytes, R.add_(M)``: one PyTorch elementwise kernel that moves
  B3's bytes (reads R and M, writes R), 10 calls over 10: what a tuned
  streaming kernel reaches with this traffic on this card.

Before the timed rounds it prints the host microseconds per call of each
(200 calls on the host clock, the card's queue never full), of
``check_operands`` on B3's seven operands, of
``torch.cuda.current_stream(...).cuda_stream`` and of the wrappers'
``_build._raw_stream``: the host work the
sweep, which waits on the host, pays per call. It prints the card's name
and power limit, each build's ``-Xptxas -v`` lines, one JSON line per
build check and per timed call (median and all ms, and the share of B3's
byte bound: 12 n d bytes over 3.35 TB/s), and a summary line.

With ``--rs-tree ROOT`` (repeatable; ``.`` is this checkout) it then
times the RS sweep of the package in each ROOT, each in a process of its
own, in the order given (e.g. parent, ., ., parent): ``NMF_RS_Estimator``
at the RS shape, k=40, a 3-sweep warm-up fit, then 10 sweeps from its
factors without the objective, as ``chip_smoke.py`` phase 8 times them:
the median of the fit's per-sweep ``iter_cputime`` stamps, in ms; then
3 more sweeps under ``torch.profiler``, whose device time per sweep it
splits into B3 (its kernels), B4 and everything else (the whole fit, its
host-side set-up's kernels included).
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

OUT_DIR = REPO / 'build' / 'bench_masked'
ALONE_REPS = 10
RS_SWEEPS = 10
PROFILED_SWEEPS = 3
P, I = ctypes.c_void_p, ctypes.c_int


def build(name, src_dir, nvcc_flags, find_nvcc):
    """``src_dir/masked.cu`` into ``lib<name>.so``: ``(B3's float32
    entry, whether it is the two-kernel form)``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = Path(src_dir) / 'masked.cu'
    lib = OUT_DIR / ('lib%s.so' % name)
    cmd = [find_nvcc(), *nvcc_flags, '-Xptxas=-v', '-shared', '-o',
           str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd),
                                                    res.stderr))
    ptxas = [ln for ln in res.stderr.splitlines() if 'registers' in ln
             or 'Compiling entry' in ln]
    print(json.dumps({'build': name, 'ptxas': ptxas}), flush=True)
    chunked = 'chunk_sum_kernel' in src.read_text()
    fn = ctypes.CDLL(str(lib)).rri_masked_phase_a_f32
    fn.argtypes = [P] * (8 if chunked else 7) + [I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn, chunked


def b3_launcher(fn, chunked, mk, R, M, dw, tp, w):
    """``(launch, call)``: one raw launch of a build's B3 into outputs made
    once, and one call as the sweep makes it (both return the sums)."""
    n, d = R.shape
    dev = R.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    vecs = (dw.data_ptr(), tp.data_ptr(), w.data_ptr())
    outs = (torch.empty(d, device=dev), torch.empty(d, device=dev))
    if chunked:
        chunks = max(1, min(-(-n // 32), 65535))
        part = torch.empty(2, chunks, d, device=dev)
        args = (R.data_ptr(), M.data_ptr(), *vecs, part.data_ptr(),
                *(o.data_ptr() for o in outs), n, d, chunks, dev.index,
                stream)
    else:
        args = (R.data_ptr(), M.data_ptr(), *vecs,
                *(o.data_ptr() for o in outs), n, d,
                mk.phase_a_layout(n, d, 4)[1], dev.index, stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError('B3 launch failed: CUDA error %d' % err)
        return outs

    if not chunked:
        pre = (torch.empty(d, device=dev), torch.empty(d, device=dev))
        return launch, lambda: mk.phase_a(R, M, dw, tp, w, out=pre)

    from rri_nmf_tpu_torch.ops._build import check_operands

    def call():
        # the two-kernel form's wrapper, step by step
        check_operands(R, {'R': (R, (n, d)), 'M': (M, (n, d)),
                           'dw': (dw, (n,)), 't_prev': (tp, (d,)),
                           'w': (w, (n,))})
        nch = max(1, min(-(-n // 32), 65535))
        scratch = torch.empty(2, nch, d, dtype=R.dtype, device=dev)
        wR0 = torch.empty(d, dtype=R.dtype, device=dev)
        nw = torch.empty_like(wR0)
        err = fn(R.data_ptr(), M.data_ptr(), *vecs, scratch.data_ptr(),
                 wR0.data_ptr(), nw.data_ptr(), n, d, nch, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError('B3 launch failed: CUDA error %d' % err)
        return wR0, nw
    return launch, call


def check(name, make_launch, mk, R0, M, dw, tp, w):
    """A build against the twin, and two launches for the same bits:
    ``make_launch(R)`` is the build's raw launch on the residual R."""
    Ra, Rb, Rt = R0.clone(), R0.clone(), R0.clone()
    got = [o.clone() for o in make_launch(Ra)()]
    again = [o.clone() for o in make_launch(Rb)()]
    want = mk.phase_a_ref(Rt, M, dw, tp, w)
    torch.cuda.synchronize()
    scales = ((M * Rt.abs()).T @ w.abs(), (w * w) @ M)
    errs = [chip_smoke.rel_err(Ra, Rt)] + [
        chip_smoke.scaled_err(g, h, s) for g, h, s in zip(got, want, scales)]
    line = {'check': name, 'rel_err_R': errs[0], 'rel_err_sums': errs[1:],
            'bitwise_repeat': bool(torch.equal(Ra, Rb) and all(
                torch.equal(g, h) for g, h in zip(got, again)))}
    print(json.dumps(line), flush=True)
    if max(errs) > chip_smoke.TOL_F32 or not line['bitwise_repeat']:
        raise AssertionError('%s disagrees with the twin: %r' % (name, line))


def time_turns(calls, runs):
    """ms of each ``calls[name] = (fn, reps)``, ``runs`` rounds in turns:
    the events span ``reps`` calls, and the time is over ``reps``."""
    for fn, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in calls}
    order = list(calls)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            fn, reps = calls[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b) / reps)
    return ms


def host_us(fn, calls=200):
    """Host microseconds per ``fn()`` (the card's queue does not fill:
    each call enqueues at most a few kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernels(args, smi):
    from rri_nmf_tpu_torch.ops import _build
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops._build import check_operands
    dev = torch.device('cuda', 0)
    builds = {'current': build('current', _build.CSRC_DIR, _build.NVCC_FLAGS,
                               _build.find_nvcc)}
    if args.baseline:
        builds['baseline'] = build('baseline', args.baseline,
                                   _build.NVCC_FLAGS, _build.find_nvcc)
    n, d, q, _ = chip_smoke.RS_SHAPE
    rng = np.random.RandomState(3)
    M = torch.as_tensor(chip_smoke.synth_ratings(n, d, q, 8) != 0,
                        device=dev).float()
    R = torch.as_tensor(rng.randn(n, d), dtype=torch.float32, device=dev)
    dw, tp, w = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for v in (rng.rand(n) - 0.5, rng.rand(d), rng.rand(n)))
    for name, (fn, chunked) in builds.items():
        check(name, lambda Rx, fn=fn, chunked=chunked: b3_launcher(
            fn, chunked, mk, Rx, M, dw, tp, w)[0], mk, R, M, dw, tp, w)
    # B4's C entry and wrapper on the same arrays
    b4 = _build.load().rri_masked_phase_b_f32
    weff = 1.3 * w
    b4_out = (torch.empty(n, device=dev), torch.empty(n, device=dev))
    b4_args = (R.data_ptr(), M.data_ptr(), w.data_ptr(), weff.data_ptr(),
               tp.data_ptr(), tp.data_ptr(),
               *(o.data_ptr() for o in b4_out), n, d, dev.index,
               torch.cuda.current_stream(dev).cuda_stream)

    def b4_alone():
        if b4(*b4_args):
            raise RuntimeError('B4 launch failed')

    calls = {}
    for name, (fn, chunked) in builds.items():
        launch, call = b3_launcher(fn, chunked, mk, R, M, dw, tp, w)
        calls['B3 alone ' + name] = (launch, ALONE_REPS)
        calls['B3 call ' + name] = (call, 1)
    calls['B3 call current, allocating'] = (
        lambda: mk.phase_a(R, M, dw, tp, w), 1)
    calls['B4 alone'] = (b4_alone, ALONE_REPS)
    calls['B4 call'] = (lambda: mk.phase_b(R, M, w, weff, tp, tp,
                                           out=b4_out), 1)
    # the same bytes through one PyTorch elementwise kernel (read R and M,
    # write R): what a tuned streaming kernel reaches on this card
    calls['same bytes, R.add_(M)'] = (lambda: R.add_(M), ALONE_REPS)
    host = {name: host_us(fn) for name, (fn, _) in calls.items()
            if not name.startswith('same bytes')}
    sums = (torch.empty(d, device=dev), torch.empty(d, device=dev))
    host['check_operands, 7 operands'] = host_us(lambda: check_operands(
        R, {'R': (R, (n, d)), 'M': (M, (n, d)), 'dw': (dw, (n,)),
            't_prev': (tp, (d,)), 'w': (w, (n,)), 'wR0': (sums[0], (d,)),
            'nw': (sums[1], (d,))}))
    host['torch.cuda.current_stream().cuda_stream'] = host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)
    host['_build._raw_stream'] = host_us(lambda: _build._raw_stream(0))
    print(json.dumps({'host_us_per_call': host, 'card': smi}), flush=True)
    ms = time_turns(calls, args.runs)
    bound_ms = 12 * n * d / chip_smoke.PEAK_BYTES_PER_S * 1e3
    summary = {}
    for name in calls:
        med = float(np.median(ms[name]))
        line = {'call': name, 'shape': [n, d], 'card': smi, 'ms': med,
                'all_ms': ms[name], 'bound_ms': bound_ms,
                'bound_share': bound_ms / med}
        summary[name] = med
        print(json.dumps(line), flush=True)
    stripes, cluster, ranges = mk.phase_a_layout(n, d, 4)
    return {'card': smi, 'median_ms': summary,
            'b3_geometry': {'stripes': stripes, 'cluster': cluster,
                            'rank_rows': [b - a for a, b in ranges]}}


def rs_sweep(root):
    """The RS sweep of the package under ``root``, in this process."""
    sys.path.insert(0, str(Path(root).resolve()))
    import rri_nmf_tpu_torch
    from rri_nmf_tpu_torch.ops import _build
    from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator
    where = Path(rri_nmf_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError('imported %s, not the package under %s'
                           % (where, root))
    dev = torch.device('cuda', 0)
    _build.load()
    n, d, q, k = chip_smoke.RS_SHAPE
    p_tr, r_tr, _, _ = (torch.as_tensor(a, device=dev) for a in
                        chip_smoke.rs_split(chip_smoke.synth_ratings(
                            n, d, q, 8)))
    r_tr = r_tr.float()
    kw = dict(random_state=0, use_validation_early_stopping=False)
    est = NMF_RS_Estimator(n, d, k, max_iter=3, **kw).fit(p_tr, r_tr)
    est = NMF_RS_Estimator(n, d, k, max_iter=RS_SWEEPS, W=est.W, T=est.T,
                           nmf_kwargs=dict(compute_obj_each_iter=False),
                           **kw).fit(p_tr, r_tr)
    torch.cuda.synchronize()
    ms = list(np.diff(est.nmf_outputs['iter_cputime']) * 1e3)
    # device time per sweep by kernel, from the profiler over a few more
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        NMF_RS_Estimator(n, d, k, max_iter=PROFILED_SWEEPS, W=est.W, T=est.T,
                         nmf_kwargs=dict(compute_obj_each_iter=False),
                         **kw).fit(p_tr, r_tr)
        torch.cuda.synchronize()
    device = {}
    for ev in prof.key_averages():
        key = ('B3' if 'phase_a_kernel' in ev.key
               or 'chunk_sum_kernel' in ev.key else
               'B4' if 'phase_b_kernel' in ev.key else 'other')
        device[key] = device.get(key, 0.0) + ev.self_device_time_total
    device = {key: us / 1e3 / PROFILED_SWEEPS for key, us in device.items()}
    print(json.dumps({'rs_tree': str(root), 'package': str(where.parent),
                      'ms_per_sweep': float(np.median(ms)),
                      'all_ms': [float(x) for x in ms],
                      'device_ms_per_sweep': device}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='directory with a masked.cu')
    ap.add_argument('--runs', type=int, default=9)
    ap.add_argument('--rs-tree', action='append', default=[],
                    help='a checkout root whose RS sweep to time')
    ap.add_argument('--rs-child', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_masked_kernels.py: no CUDA device')
    if args.rs_child:
        rs_sweep(args.rs_child)
        return
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    summary = kernels(args, smi)
    for root in args.rs_tree:
        subprocess.run([sys.executable, __file__, '--rs-child', root],
                       check=True)
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    os.chdir(REPO)
    main()
